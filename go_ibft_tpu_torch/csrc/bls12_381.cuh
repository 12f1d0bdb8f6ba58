// BLS12-381 lane arithmetic of the pairing kernels (bls12_381.cu): the base
// field in registers, the interpreter of the Miller loop's and the final
// exponentiation's schedules (bls12_381_schedule.cuh), and the Jacobian
// points of the merge.
//
// Field elements mod p are 12 little-endian 32-bit words in the Montgomery
// domain with R = 2^384, canonical (< p) wherever they are stored: p < 2^381,
// so a sum of two elements never leaves 382 bits.  The product is a CIOS
// Montgomery pass fully unrolled on registers, each row two PTX carry chains
// for a_i b and two for m p (mad.lo.cc / madc.hi.cc), then one conditional
// subtraction.  Every PTX instruction sits in its own asm statement with a
// C++ twin on an explicit carry (Carry), so a host build runs the same
// chains.  The one inversion is Kaliski's binary Montgomery inverse: no
// product, about 2 x 381 steps of word adds and shifts.
//
// The pairing kernels run one lane on a block of threads and keep its values
// in shared memory as elements (12 words each).  A schedule is a sequence of
// rounds; in each, every thread forms the two operands of its slot as small
// integer combinations of elements and multiplies them in registers (phase
// 1), a barrier, then every thread forms one of the round's stores as a
// combination of products and elements (phase 3), and a barrier.  A
// combination sums its terms on a 13-word accumulator with no reduction,
// starting at a multiple of p above its negative terms, and ends with a few
// conditional subtractions of 2^k p.  The schedules and the rules that keep
// the phases free of races are ops/bls_schedule.py's.
//
// Everything here also compiles with a host C++ compiler (lane.cuh): the
// CPU tests build bls12_381.cu with g++ and run each phase's threads one
// after another over a host array that stands for shared memory.

#pragma once

#include "bls12_381_schedule.cuh"
#include "lane.cuh"

#if defined(__CUDACC__)
#define BLS_CALL __device__ __noinline__
#define BLS_CONST __host__ __device__ constexpr
#else
#define BLS_CALL inline
#define BLS_CONST constexpr
#endif

namespace bls {

constexpr int kWords = 12;  // 32-bit words of a field element

struct Fp {
  uint32_t w[kWords];
};
struct Fp2 {
  Fp c0, c1;
};
// A Jacobian point (x / z^2, y / z^3); z == 0 is the point at infinity.
template <class F>
struct Jac {
  F x, y, z;
};

// Word i of p (0 beyond its 12 words), and of R mod p: one in the Montgomery
// domain.  Folded into immediates where i is a constant.
BLS_CONST uint32_t p_word(int i) {
  constexpr uint32_t w[kWords] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                                  0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return i < 0 || i >= kWords ? 0u : w[i];
}
BLS_CONST uint32_t one_word(int i) {
  constexpr uint32_t w[kWords] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
                                  0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
  return w[i];
}
// Word i (0 .. 12) of 2^k p, 0 <= k < 32.
BLS_CONST uint32_t pmul_word(int k, int i) {
  return static_cast<uint32_t>(((static_cast<uint64_t>(p_word(i)) << 32 | p_word(i - 1)) << k) >> 32);
}
constexpr uint32_t kPInv = 0xfffcfffdu;  // -p^-1 mod 2^32

// -- PTX carry chains ------------------------------------------------------
//
// One instruction per asm statement, the carry flag running from one to the
// next: volatile keeps their order, and no PTX that the compiler emits
// touches the flag.  One instruction per statement also means every input is
// read before the output is written, so the register sharing that inline
// asm allows between an output and an input of the same value is harmless.

// The carry flag: PTX keeps it in CC.CF; the host twin in cf.
struct Carry {
#if !defined(__CUDA_ARCH__)
  uint32_t cf = 0;
#endif
};

#if defined(__CUDA_ARCH__)
#define BLS_PTX3(op)                                                                   \
  uint32_t d;                                                                          \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));              \
  return d
#define BLS_PTX2(op)                                                                   \
  uint32_t d;                                                                          \
  asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));                          \
  return d
#endif

// lo(a b) + c, carry out.
LANE_FN uint32_t mad_lo_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  BLS_PTX3("mad.lo.cc.u32");
#else
  const uint64_t s = static_cast<uint64_t>(a * b) + c;
  k.cf = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
#endif
}

// lo(a b) + c + carry, carry out.
LANE_FN uint32_t madc_lo_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  BLS_PTX3("madc.lo.cc.u32");
#else
  const uint64_t s = static_cast<uint64_t>(a * b) + c + k.cf;
  k.cf = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
#endif
}

// hi(a b) + c, carry out.
LANE_FN uint32_t mad_hi_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  BLS_PTX3("mad.hi.cc.u32");
#else
  const uint64_t s = ((static_cast<uint64_t>(a) * b) >> 32) + c;
  k.cf = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
#endif
}

// hi(a b) + c + carry, carry out.
LANE_FN uint32_t madc_hi_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  BLS_PTX3("madc.hi.cc.u32");
#else
  const uint64_t s = ((static_cast<uint64_t>(a) * b) >> 32) + c + k.cf;
  k.cf = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
#endif
}

// hi(a b) + c + carry; the carry out is dropped (the caller knows it is 0).
LANE_FN uint32_t madc_hi(Carry& k, uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  BLS_PTX3("madc.hi.u32");
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(a) * b) >> 32) + c + k.cf);
#endif
}

// a + b, carry out.
LANE_FN uint32_t add_cc(Carry& k, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  BLS_PTX2("add.cc.u32");
#else
  const uint64_t s = static_cast<uint64_t>(a) + b;
  k.cf = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
#endif
}

// a + b + carry, carry out.
LANE_FN uint32_t addc_cc(Carry& k, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  BLS_PTX2("addc.cc.u32");
#else
  const uint64_t s = static_cast<uint64_t>(a) + b + k.cf;
  k.cf = static_cast<uint32_t>(s >> 32);
  return static_cast<uint32_t>(s);
#endif
}

// a + b + carry.
LANE_FN uint32_t addc(Carry& k, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  BLS_PTX2("addc.u32");
#else
  return a + b + k.cf;
#endif
}

// a - b, borrow out.
LANE_FN uint32_t sub_cc(Carry& k, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  BLS_PTX2("sub.cc.u32");
#else
  k.cf = a < b;
  return a - b;
#endif
}

// a - b - borrow, borrow out.
LANE_FN uint32_t subc_cc(Carry& k, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  BLS_PTX2("subc.cc.u32");
#else
  const uint64_t d = static_cast<uint64_t>(a) - b - k.cf;
  k.cf = static_cast<uint32_t>(d >> 63);
  return static_cast<uint32_t>(d);
#endif
}

// a - b - borrow.
LANE_FN uint32_t subc(Carry& k, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  BLS_PTX2("subc.u32");
#else
  return a - b - k.cf;
#endif
}

// -- the base field ----------------------------------------------------------

LANE_FN Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = 0;
  }
  return r;
}

LANE_FN Fp fp_one() {
  Fp r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = one_word(i);
  }
  return r;
}

LANE_FN bool is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    acc |= a.w[i];
  }
  return acc == 0;
}

// s - p where s (< 2p) is at least p, else s.
LANE_FN Fp reduce_once(const Fp& s) {
  Carry k;
  Fp d;
  d.w[0] = sub_cc(k, s.w[0], p_word(0));
#pragma unroll
  for (int i = 1; i < kWords; ++i) {
    d.w[i] = subc_cc(k, s.w[i], p_word(i));
  }
  const uint32_t borrow = subc(k, 0, 0);  // all ones where s < p
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    d.w[i] = borrow ? s.w[i] : d.w[i];
  }
  return d;
}

LANE_FN Fp add(const Fp& a, const Fp& b) {
  Carry k;
  Fp s;
  s.w[0] = add_cc(k, a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < kWords - 1; ++i) {
    s.w[i] = addc_cc(k, a.w[i], b.w[i]);
  }
  s.w[kWords - 1] = addc(k, a.w[kWords - 1], b.w[kWords - 1]);  // < 2^382: no carry out
  return reduce_once(s);
}

LANE_FN Fp sub(const Fp& a, const Fp& b) {
  Carry k;
  Fp d;
  d.w[0] = sub_cc(k, a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < kWords; ++i) {
    d.w[i] = subc_cc(k, a.w[i], b.w[i]);
  }
  const uint32_t borrow = subc(k, 0, 0);  // all ones where a < b: add p back
  d.w[0] = add_cc(k, d.w[0], p_word(0) & borrow);
#pragma unroll
  for (int i = 1; i < kWords - 1; ++i) {
    d.w[i] = addc_cc(k, d.w[i], p_word(i) & borrow);
  }
  d.w[kWords - 1] = addc(k, d.w[kWords - 1], p_word(kWords - 1) & borrow);
  return d;
}

LANE_FN Fp neg(const Fp& a) { return sub(fp_zero(), a); }

// a b 2^-384 mod p, canonical for canonical inputs: 12 CIOS rows on a 13-word
// accumulator t < 2p, each t += a_i b (low halves, then high halves a word
// up) and t += m p with m = -t_0 p^-1 mod 2^32 (the low word becomes 0), then
// a shift by one word.  The sums stay below 2^416, so no chain carries out
// of t_12.
LANE_FN Fp mul(const Fp& a, const Fp& b) {
  uint32_t t[kWords + 1];
#pragma unroll
  for (int j = 0; j <= kWords; ++j) {
    t[j] = 0;
  }
  Carry k;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t ai = a.w[i];
    t[0] = mad_lo_cc(k, ai, b.w[0], t[0]);
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      t[j] = madc_lo_cc(k, ai, b.w[j], t[j]);
    }
    t[kWords] = addc(k, t[kWords], 0);
    t[1] = mad_hi_cc(k, ai, b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < kWords - 1; ++j) {
      t[j + 1] = madc_hi_cc(k, ai, b.w[j], t[j + 1]);
    }
    t[kWords] = madc_hi(k, ai, b.w[kWords - 1], t[kWords]);
    const uint32_t m = t[0] * kPInv;
    t[0] = mad_lo_cc(k, m, p_word(0), t[0]);
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      t[j] = madc_lo_cc(k, m, p_word(j), t[j]);
    }
    t[kWords] = addc(k, t[kWords], 0);
    t[1] = mad_hi_cc(k, m, p_word(0), t[1]);
#pragma unroll
    for (int j = 1; j < kWords - 1; ++j) {
      t[j + 1] = madc_hi_cc(k, m, p_word(j), t[j + 1]);
    }
    t[kWords] = madc_hi(k, m, p_word(kWords - 1), t[kWords]);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      t[j] = t[j + 1];
    }
    t[kWords] = 0;
  }
  Fp r;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    r.w[j] = t[j];
  }
  return reduce_once(r);
}

LANE_FN Fp sqr(const Fp& a) { return mul(a, a); }

// -- Kaliski's inverse ----------------------------------------------------------

LANE_FN void shr1(uint32_t* x) {
#pragma unroll
  for (int i = 0; i < kWords - 1; ++i) {
    x[i] = (x[i] >> 1) | (x[i + 1] << 31);
  }
  x[kWords - 1] >>= 1;
}

LANE_FN void shl1(uint32_t* x) {
#pragma unroll
  for (int i = kWords - 1; i > 0; --i) {
    x[i] = (x[i] << 1) | (x[i - 1] >> 31);
  }
  x[0] <<= 1;
}

// x += y (no carry out: both stay below 2^383).
LANE_FN void add_to(uint32_t* x, const uint32_t* y) {
  Carry k;
  x[0] = add_cc(k, x[0], y[0]);
#pragma unroll
  for (int i = 1; i < kWords - 1; ++i) {
    x[i] = addc_cc(k, x[i], y[i]);
  }
  x[kWords - 1] = addc(k, x[kWords - 1], y[kWords - 1]);
}

// x -= y where x >= y.
LANE_FN void sub_from(uint32_t* x, const uint32_t* y) {
  Carry k;
  x[0] = sub_cc(k, x[0], y[0]);
#pragma unroll
  for (int i = 1; i < kWords - 1; ++i) {
    x[i] = subc_cc(k, x[i], y[i]);
  }
  x[kWords - 1] = subc(k, x[kWords - 1], y[kWords - 1]);
}

LANE_FN bool greater(const uint32_t* x, const uint32_t* y) {
  Carry k;
  (void)sub_cc(k, y[0], x[0]);
#pragma unroll
  for (int i = 1; i < kWords; ++i) {
    (void)subc_cc(k, y[i], x[i]);
  }
  return subc(k, 0, 0) != 0;  // y - x borrows
}

// a^-1 in the Montgomery domain (a = A R: returns A^-1 R), and 0 for 0.
// Kaliski's almost inverse on (u, v) = (p, a) with p = u s + v r gives
// x = a^-1 2^k mod p for 381 <= k <= 762 (r and s stay below 2p); then
// 768 - k modular doublings make it a^-1 2^768 = A^-1 R.
LANE_FN Fp inv(const Fp& a) {
  if (is_zero(a)) {
    return a;
  }
  uint32_t u[kWords], v[kWords], r[kWords], s[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    u[i] = p_word(i);
    v[i] = a.w[i];
    r[i] = 0;
    s[i] = i == 0;
  }
  int k = 0;
  for (;;) {
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      any |= v[i];
    }
    if (any == 0) {
      break;
    }
    if ((u[0] & 1u) == 0) {
      shr1(u);
      shl1(s);
    } else if ((v[0] & 1u) == 0) {
      shr1(v);
      shl1(r);
    } else if (greater(u, v)) {
      sub_from(u, v);
      shr1(u);
      add_to(r, s);
      shl1(s);
    } else {
      sub_from(v, u);
      shr1(v);
      add_to(s, r);
      shl1(r);
    }
    ++k;
  }
  Fp x;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    x.w[i] = r[i];
  }
  x = reduce_once(x);  // r < 2p
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    u[i] = p_word(i);
  }
  sub_from(u, x.w);  // p - r = a^-1 2^k
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    x.w[i] = u[i];
  }
  for (; k < 2 * 384; ++k) {
    x = add(x, x);
  }
  return x;
}

// -- elements in shared memory and the schedules' interpreter -----------------

LANE_FN Fp load(const uint32_t* src) {
  Fp r;
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(src);  // elements are 16-byte aligned
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    const uint4 x = q[i];
    r.w[4 * i] = x.x;
    r.w[4 * i + 1] = x.y;
    r.w[4 * i + 2] = x.z;
    r.w[4 * i + 3] = x.w;
  }
#else
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = src[i];
  }
#endif
  return r;
}

LANE_FN void store(uint32_t* dst, const Fp& a) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    q[i] = make_uint4(a.w[4 * i], a.w[4 * i + 1], a.w[4 * i + 2], a.w[4 * i + 3]);
  }
#else
  for (int i = 0; i < kWords; ++i) {
    dst[i] = a.w[i];
  }
#endif
}

constexpr int kAccWords = kWords + 1;

// acc = acc - 2^k p where acc >= 2^k p.
LANE_FN void acc_reduce(uint32_t* acc, int k) {
  Carry c;
  uint32_t d[kAccWords];
  d[0] = sub_cc(c, acc[0], pmul_word(k, 0));
#pragma unroll
  for (int i = 1; i < kAccWords; ++i) {
    d[i] = subc_cc(c, acc[i], pmul_word(k, i));
  }
  const uint32_t borrow = subc(c, 0, 0);
#pragma unroll
  for (int i = 0; i < kAccWords; ++i) {
    acc[i] = borrow ? acc[i] : d[i];
  }
}

// acc += x, or acc -= x where mask is all ones: acc + ~x + 1 on 13 words
// (one path for both signs, so a warp's threads do not diverge on them).
LANE_FN void acc_add(uint32_t* acc, const Fp& x, uint32_t mask) {
  Carry k;
  (void)add_cc(k, mask & 1u, 0xffffffffu);  // carry := 1 for a subtraction
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    acc[i] = addc_cc(k, acc[i], x.w[i] ^ mask);
  }
  acc[kWords] = addc(k, acc[kWords], mask);
}

constexpr int kBatch = 4;  // terms whose loads are issued together

// The canonical value of a form (a descriptor of sched::kTerms, see the
// schedule header) over a lane's elements: its terms' loads a batch at a
// time, then their sums on the accumulator.
LANE_FN Fp eval(uint32_t form, const uint32_t* elems) {
  const uint32_t first = form >> 14, terms = (form >> 6) & 0xffu, offset = (form >> 3) & 7u, steps = form & 7u;
  uint32_t acc[kAccWords];
  const int shift = offset ? static_cast<int>(offset) - 1 : 0;
  const uint32_t mask = offset ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < kAccWords; ++i) {
    acc[i] = static_cast<uint32_t>(((static_cast<uint64_t>(p_word(i)) << 32 | p_word(i - 1)) << shift) >> 32) & mask;
  }
#pragma unroll 1
  for (uint32_t n = 0; n < terms; n += kBatch) {
    uint32_t term[kBatch];
    Fp x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      term[j] = n + j < terms ? sched::kTerms[first + n + j] : 8u;  // element 0, coefficient 0
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      x[j] = load(elems + (term[j] >> 4) * kWords);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = static_cast<int>(term[j] & 15u) - 8;
      const uint32_t sign = c < 0 ? 0xffffffffu : 0u;
#pragma unroll 1
      for (int r = c < 0 ? -c : c; r > 0; --r) {
        acc_add(acc, x[j], sign);
      }
    }
  }
#pragma unroll
  for (int s = sched::kMaxSteps - 1; s >= 0; --s) {
    if (s < static_cast<int>(steps)) {
      acc_reduce(acc, s);
    }
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = acc[i];
  }
  return r;
}

// Round `rid`'s counts: slots, first-phase stores, second-phase stores, and
// whether it inverts.
LANE_FN uint32_t round_slots(uint32_t rid) { return sched::kRounds[3 * rid + 2] & 0xffu; }
LANE_FN uint32_t round_stores(uint32_t rid, int phase) {
  return (sched::kRounds[3 * rid + 2] >> (8 + 8 * phase)) & 0xffu;
}

// Phase 1 of round `rid` for thread t of `threads`: its slots' products into
// the product region.
LANE_FN void slot_phase(uint32_t rid, uint32_t* elems, int t, int threads) {
  const uint32_t first = sched::kRounds[3 * rid], n = round_slots(rid);
#pragma unroll 1
  for (uint32_t s = t; s < n; s += threads) {
    const Fp a = eval(sched::kSlotForms[2 * (first + s)], elems);
    const Fp b = eval(sched::kSlotForms[2 * (first + s) + 1], elems);
    store(elems + s * kWords, mul(a, b));
  }
}

// Store phase 0 or 1 of round `rid`: its stores (phase 0: the short stores
// and the parts of the long ones; phase 1: the sums of the parts).  An
// inverting round's one store is inverted.
LANE_FN void store_phase(uint32_t rid, int phase, uint32_t* elems, int t, int threads) {
  const uint32_t first = sched::kRounds[3 * rid + 1] + (phase ? round_stores(rid, 0) : 0u);
  const uint32_t n = round_stores(rid, phase);
  const bool invert = (sched::kRounds[3 * rid + 2] >> 24) == static_cast<uint32_t>(sched::kInvert);
#pragma unroll 1
  for (uint32_t s = t; s < n; s += threads) {
    const Fp v = eval(sched::kStoreForms[2 * (first + s) + 1], elems);
    store(elems + sched::kStoreForms[2 * (first + s)] * kWords, invert ? inv(v) : v);
  }
}

// Whether the Fp12 at these 12 elements is one.
LANE_FN bool is_one(const uint32_t* elems, const uint16_t* at) {
  uint32_t diff = 0;
  for (int k = 0; k < 12; ++k) {
    for (int i = 0; i < kWords; ++i) {
      diff |= elems[at[k] * kWords + i] ^ (k == 0 ? one_word(i) : 0u);
    }
  }
  return diff == 0;
}

// -- Fp2 and Jacobian points: the merge's arithmetic ---------------------------

LANE_FN Fp2 f2_zero() { return Fp2{fp_zero(), fp_zero()}; }
LANE_FN Fp2 f2_one() { return Fp2{fp_one(), fp_zero()}; }
LANE_FN bool is_zero(const Fp2& a) { return is_zero(a.c0) && is_zero(a.c1); }
LANE_FN Fp2 add(const Fp2& a, const Fp2& b) { return Fp2{add(a.c0, b.c0), add(a.c1, b.c1)}; }
LANE_FN Fp2 sub(const Fp2& a, const Fp2& b) { return Fp2{sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
LANE_FN Fp2 neg(const Fp2& a) { return Fp2{neg(a.c0), neg(a.c1)}; }

BLS_CALL Fp2 mul(const Fp2& a, const Fp2& b) {
  const Fp t0 = mul(a.c0, b.c0);
  const Fp t1 = mul(a.c1, b.c1);
  const Fp t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return Fp2{sub(t0, t1), sub(sub(t2, t0), t1)};
}

BLS_CALL Fp2 sqr(const Fp2& a) {
  const Fp t = mul(a.c0, a.c1);
  return Fp2{mul(add(a.c0, a.c1), sub(a.c0, a.c1)), add(t, t)};
}

BLS_CALL Fp2 inv(const Fp2& a) {
  const Fp n = inv(add(sqr(a.c0), sqr(a.c1)));
  return Fp2{mul(a.c0, n), neg(mul(a.c1, n))};
}

// k * a for a small k >= 1.
template <class F>
LANE_FN F muli(const F& a, int k) {
  F r = a;
  for (int i = 1; i < k; ++i) {
    r = add(r, a);
  }
  return r;
}

// 2P, the JAX package's _jac_ops double (no special case: 2 * infinity has
// z = 0 again).
template <class F>
BLS_CALL Jac<F> jac_double(const Jac<F>& p) {
  const F a = sqr(p.x);
  const F b = sqr(p.y);
  const F c = sqr(b);
  const F t = sqr(add(p.x, b));
  const F d = muli(sub(sub(t, a), c), 2);
  const F e = muli(a, 3);
  const F x3 = sub(sqr(e), muli(d, 2));
  const F y3 = sub(mul(e, sub(d, x3)), muli(c, 8));
  const F z3 = muli(mul(p.y, p.z), 2);
  return Jac<F>{x3, y3, z3};
}

// P + Q, _jac_ops' add_complete: the generic sum, 2P where P == Q, and the
// other point where one is at infinity; P + (-P) has z == 0.
template <class F>
BLS_CALL Jac<F> jac_add(const Jac<F>& p, const Jac<F>& q) {
  if (is_zero(p.z)) {
    return q;
  }
  if (is_zero(q.z)) {
    return p;
  }
  const F z1s = sqr(p.z);
  const F z2s = sqr(q.z);
  const F u1 = mul(p.x, z2s);
  const F u2 = mul(q.x, z1s);
  const F s1 = mul(p.y, mul(z2s, q.z));
  const F s2 = mul(q.y, mul(z1s, p.z));
  const F h = sub(u2, u1);
  const F r = sub(s2, s1);
  if (is_zero(h) && is_zero(r)) {
    return jac_double(p);
  }
  const F hs = sqr(h);
  const F hc = mul(hs, h);
  const F u1hs = mul(u1, hs);
  const F x3 = sub(sub(sqr(r), hc), muli(u1hs, 2));
  const F y3 = sub(mul(r, sub(u1hs, x3)), mul(s1, hc));
  const F z3 = mul(mul(p.z, q.z), h);
  return Jac<F>{x3, y3, z3};
}

// The affine point (x, y) of p, (0, 0) for infinity; returns whether p is
// the point at infinity.
template <class F>
BLS_CALL bool to_affine(const Jac<F>& p, F& x, F& y) {
  const F zi = inv(p.z);
  const F zi2 = sqr(zi);
  x = mul(p.x, zi2);
  y = mul(p.y, mul(zi2, zi));
  return is_zero(p.z);
}

LANE_FN Fp2 load2(const uint32_t* src) { return Fp2{load(src), load(src + kWords)}; }

// The affine point of `coords` field elements (2: G1 x, y; 4: G2 x0, x1,
// y0, y1) at src as a Jacobian point with z = 1.
LANE_FN Jac<Fp> load_g1(const uint32_t* src) { return Jac<Fp>{load(src), load(src + kWords), fp_one()}; }
LANE_FN Jac<Fp2> load_g2(const uint32_t* src) {
  return Jac<Fp2>{load2(src), load2(src + 2 * kWords), f2_one()};
}
LANE_FN Jac<Fp> infinity(const Jac<Fp>*) { return Jac<Fp>{fp_zero(), fp_zero(), fp_zero()}; }
LANE_FN Jac<Fp2> infinity(const Jac<Fp2>*) { return Jac<Fp2>{f2_zero(), f2_zero(), f2_zero()}; }
LANE_FN void load_point(const uint32_t* src, Jac<Fp>& p) { p = load_g1(src); }
LANE_FN void load_point(const uint32_t* src, Jac<Fp2>& p) { p = load_g2(src); }

// The canonical affine coordinates of p at dst (y negated where neg_y),
// zeros for infinity; returns whether p is the point at infinity.
LANE_FN bool store_affine(uint32_t* dst, const Jac<Fp>& p, bool neg_y) {
  Fp x, y;
  const bool inf = to_affine(p, x, y);
  store(dst, x);
  store(dst + kWords, neg_y ? neg(y) : y);
  return inf;
}

LANE_FN bool store_affine(uint32_t* dst, const Jac<Fp2>& p, bool neg_y) {
  Fp2 x, y;
  const bool inf = to_affine(p, x, y);
  if (neg_y) {
    y = neg(y);
  }
  store(dst, x.c0);
  store(dst + kWords, x.c1);
  store(dst + 2 * kWords, y.c0);
  store(dst + 3 * kWords, y.c1);
  return inf;
}

}  // namespace bls
