// BLS12-381 arithmetic of the kernels in bls12_381.cu: the base field in
// registers, the interpreter of the Miller loop's and the final
// exponentiation's schedules (bls12_381_schedule.cuh), and the sums of the
// merge's addition forms.
//
// Field elements mod p are 12 little-endian 32-bit words in the Montgomery
// domain with R = 2^384, canonical (< p) wherever they are stored: p < 2^381,
// so a sum of two elements never leaves 382 bits.  The product is a CIOS
// Montgomery pass fully unrolled on registers, each row two PTX carry chains
// for a_i b and two for m p (mad.lo.cc / madc.hi.cc), then one conditional
// subtraction.  Every PTX instruction sits in its own asm statement with a
// C++ twin on an explicit carry (Carry), so a host build runs the same
// chains.  The inversion is a Bernstein-Yang safegcd on 30-bit limbs: at
// most 1,110 divsteps, then one product to the Montgomery domain.
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
#define BLS_CONST __host__ __device__ constexpr
#else
#define BLS_CONST constexpr
#endif

namespace bls {

constexpr int kWords = 12;  // 32-bit words of a field element

struct Fp {
  uint32_t w[kWords];
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

// -- the inverse: Bernstein-Yang safegcd ------------------------------------
//
// x^-1 mod p by divsteps (Bernstein and Yang, "Fast constant-time gcd
// computation and modular inversion", 2019) on 13 signed limbs of 30 bits,
// branch-free, as secp256k1_recover.cu's modinv but with the paper's
// original divstep (delta starts at 1), whose count its Theorem 11.2 bounds:
// for f = p and 0 <= g < p, f^2 + 4 g^2 <= 5 * 2^(2 * 381), so
// floor((49 * 381 + 57) / 17) = 1,101 divsteps reach g = 0, so kInvBatches
// batches of 30 (1,110) always do.  The loop stops at the first batch that
// starts with g = 0 (then f = +-1 and d = +-x^-1): random inputs take about
// 790 divsteps, 27 batches.  The inputs are public, so the early stop leaks
// nothing.  The transition matrix of a batch and the bounds that keep d and
// e in (-2p, p) are libsecp256k1's (modinv32).

constexpr int kS30 = 13;  // limbs: 390 bits
constexpr int kInvBatches = 37;
constexpr int32_t kM30 = 0x3FFFFFFF;
constexpr uint32_t kPInv30 = 0x30003u;  // p^-1 mod 2^30

struct S30 {
  int32_t v[kS30];  // value = sum v[i] 2^(30 i)
};

BLS_CONST int32_t p_limb(int i) {
  constexpr int32_t l[kS30] = {0x3fffaaab, 0x27fbffff, 0x153ffffb, 0x2affffac, 0x30f6241e, 0x034a83da, 0x112bf673,
                               0x12e13ce1, 0x2cd76477, 0x1ed90d2e, 0x29a4b1ba, 0x3a8e5ff9, 0x001a0111};
  return l[i];
}

// Word i of R^3 mod p: a Montgomery product by it takes x^-1 to the
// Montgomery form of the inverse.
BLS_CONST uint32_t r3_word(int i) {
  constexpr uint32_t w[kWords] = {0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu, 0x9a53352au,
                                  0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u, 0x91755d4du, 0x0aa63460u};
  return w[i];
}

LANE_FN S30 to_s30(const Fp& a) {
  S30 r;
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    const int bit = 30 * i, word = bit >> 5, sh = bit & 31;
    uint32_t v = a.w[word] >> sh;
    if (sh > 2 && word + 1 < kWords) {
      v |= a.w[word + 1] << (32 - sh);
    }
    r.v[i] = static_cast<int32_t>(v & kM30);
  }
  return r;
}

// Limbs in [0, 2^30), value below 2^384.
LANE_FN Fp from_s30(const S30& a) {
  Fp r = fp_zero();
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    const int bit = 30 * i, word = bit >> 5, sh = bit & 31;
    const uint32_t v = static_cast<uint32_t>(a.v[i]);
    r.w[word] |= v << sh;
    if (sh > 2 && word + 1 < kWords) {
      r.w[word + 1] |= v >> (32 - sh);
    }
  }
  return r;
}

// 30 divsteps on the low bits of f (odd) and g, branch-free; eta = -delta.
// Returns the new eta and the transition matrix t = (u, v, q, r), scaled by
// 2^30.
LANE_FN int32_t divsteps_30(int32_t eta, uint32_t f, uint32_t g, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll 5
  for (int i = 0; i < 30; ++i) {
    uint32_t c1 = static_cast<uint32_t>(eta >> 31);  // delta > 0
    const uint32_t c2 = 0u - (g & 1u);               // g odd
    const uint32_t x = (f ^ c1) - c1;
    const uint32_t y = (u ^ c1) - c1;
    const uint32_t z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;  // the swap: delta -> 1 - delta, else delta -> 1 + delta
    eta = (eta ^ static_cast<int32_t>(c1)) - static_cast<int32_t>(~c1 & 1u);
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = static_cast<int32_t>(u);
  t[1] = static_cast<int32_t>(v);
  t[2] = static_cast<int32_t>(q);
  t[3] = static_cast<int32_t>(r);
  return eta;
}

// (d, e) = t (d, e) / 2^30 mod p, keeping both in (-2p, p).
LANE_FN void update_de_30(S30& d, S30& e, const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[kS30 - 1] >> 31, se = e.v[kS30 - 1] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = static_cast<int64_t>(u) * d.v[0] + static_cast<int64_t>(v) * e.v[0];
  int64_t ce = static_cast<int64_t>(q) * d.v[0] + static_cast<int64_t>(r) * e.v[0];
  md -= static_cast<int32_t>((kPInv30 * static_cast<uint32_t>(cd) + static_cast<uint32_t>(md)) & kM30);
  me -= static_cast<int32_t>((kPInv30 * static_cast<uint32_t>(ce) + static_cast<uint32_t>(me)) & kM30);
  cd += static_cast<int64_t>(p_limb(0)) * md;
  ce += static_cast<int64_t>(p_limb(0)) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < kS30; ++i) {
    cd += static_cast<int64_t>(u) * d.v[i] + static_cast<int64_t>(v) * e.v[i];
    ce += static_cast<int64_t>(q) * d.v[i] + static_cast<int64_t>(r) * e.v[i];
    cd += static_cast<int64_t>(p_limb(i)) * md;
    ce += static_cast<int64_t>(p_limb(i)) * me;
    d.v[i - 1] = static_cast<int32_t>(cd) & kM30;
    cd >>= 30;
    e.v[i - 1] = static_cast<int32_t>(ce) & kM30;
    ce >>= 30;
  }
  d.v[kS30 - 1] = static_cast<int32_t>(cd);
  e.v[kS30 - 1] = static_cast<int32_t>(ce);
}

// (f, g) = t (f, g) / 2^30, exactly.
LANE_FN void update_fg_30(S30& f, S30& g, const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = static_cast<int64_t>(u) * f.v[0] + static_cast<int64_t>(v) * g.v[0];
  int64_t cg = static_cast<int64_t>(q) * f.v[0] + static_cast<int64_t>(r) * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < kS30; ++i) {
    cf += static_cast<int64_t>(u) * f.v[i] + static_cast<int64_t>(v) * g.v[i];
    cg += static_cast<int64_t>(q) * f.v[i] + static_cast<int64_t>(r) * g.v[i];
    f.v[i - 1] = static_cast<int32_t>(cf) & kM30;
    cf >>= 30;
    g.v[i - 1] = static_cast<int32_t>(cg) & kM30;
    cg >>= 30;
  }
  f.v[kS30 - 1] = static_cast<int32_t>(cf);
  g.v[kS30 - 1] = static_cast<int32_t>(cg);
}

LANE_FN void carry_30(S30& r) {
#pragma unroll
  for (int i = 0; i < kS30 - 1; ++i) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= kM30;
  }
}

// r in (-2p, p) to [0, p), negated first where sign < 0.
LANE_FN void normalize_30(S30& r, int32_t sign) {
  int32_t add = r.v[kS30 - 1] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    r.v[i] += p_limb(i) & add;
    r.v[i] = (r.v[i] ^ neg) - neg;
  }
  carry_30(r);
  add = r.v[kS30 - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    r.v[i] += p_limb(i) & add;
  }
  carry_30(r);
}

// a^-1 in the Montgomery domain (a = A R: returns A^-1 R), and 0 for 0: the
// safegcd inverse of the word value, times R^3 in a Montgomery product.
LANE_FN Fp inv(const Fp& a) {
  S30 d, e, f, g = to_s30(a);
#pragma unroll
  for (int i = 0; i < kS30; ++i) {
    d.v[i] = 0;
    e.v[i] = 0;
    f.v[i] = p_limb(i);
  }
  e.v[0] = 1;
  int32_t eta = -1;
#pragma unroll 1
  for (int i = 0; i < kInvBatches; ++i) {
    int32_t any = 0;
#pragma unroll
    for (int k = 0; k < kS30; ++k) {
      any |= g.v[k];
    }
    if (any == 0) {
      break;
    }
    int32_t t[4];
    eta = divsteps_30(eta, static_cast<uint32_t>(f.v[0]), static_cast<uint32_t>(g.v[0]), t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f.v[kS30 - 1]);
  Fp r3;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    r3.w[i] = r3_word(i);
  }
  return mul(from_s30(d), r3);
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
// inverting round's one store is inverted; a schedule with no inverting
// round (the Miller loop's) leaves the inverse out of its code.
template <bool kInverts = true>
LANE_FN void store_phase(uint32_t rid, int phase, uint32_t* elems, int t, int threads) {
  const uint32_t first = sched::kRounds[3 * rid + 1] + (phase ? round_stores(rid, 0) : 0u);
  const uint32_t n = round_stores(rid, phase);
  const bool invert = kInverts && (sched::kRounds[3 * rid + 2] >> 24) == static_cast<uint32_t>(sched::kInvert);
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

// -- the merge's sums -----------------------------------------------------------

// acc += c x for a small c (13 words, no carry out of acc[12]): one row of
// the product's chains.
LANE_FN void acc_mad(uint32_t* acc, const Fp& x, uint32_t c) {
  Carry k;
  acc[0] = mad_lo_cc(k, c, x.w[0], acc[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    acc[j] = madc_lo_cc(k, c, x.w[j], acc[j]);
  }
  acc[kWords] = addc(k, acc[kWords], 0);
  acc[1] = mad_hi_cc(k, c, x.w[0], acc[1]);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j) {
    acc[j + 1] = madc_hi_cc(k, c, x.w[j], acc[j + 1]);
  }
  acc[kWords] = madc_hi(k, c, x.w[kWords - 1], acc[kWords]);
}

// x, or p - x where mask is all ones (x <= p): ~x + p + 1 on one chain, so
// both signs take one path.
LANE_FN Fp neg_if(const Fp& x, uint32_t mask) {
  Carry k;
  Fp r;
  (void)add_cc(k, mask & 1u, 0xffffffffu);  // carry := 1 for a negation
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = addc_cc(k, x.w[i] ^ mask, p_word(i) & mask);
  }
  return r;
}

// The value of a 13-word sum below 2^390, below 2p: less q p, where q =
// floor(top / (p_top + 1)) of its top 64 bits and p's top word is
// floor(acc / p) or one less (the two differ by less than 2^-19).  Canonical
// after one conditional subtraction; a product's operand need not be (mul
// takes operands below 3p: 9p^2 < p R).
LANE_FN Fp acc_reduce_wide(const uint32_t* acc) {
  const uint64_t top = static_cast<uint64_t>(acc[kWords]) << 32 | acc[kWords - 1];
  const uint32_t q = static_cast<uint32_t>(top / (static_cast<uint64_t>(p_word(kWords - 1)) + 1));
  uint32_t qp[kWords + 1];
  Carry k;
  qp[0] = mad_lo_cc(k, q, p_word(0), 0);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    qp[j] = madc_lo_cc(k, q, p_word(j), 0);
  }
  qp[kWords] = addc(k, 0, 0);
  qp[1] = mad_hi_cc(k, q, p_word(0), qp[1]);
#pragma unroll
  for (int j = 1; j < kWords - 1; ++j) {
    qp[j + 1] = madc_hi_cc(k, q, p_word(j), qp[j + 1]);
  }
  qp[kWords] = madc_hi(k, q, p_word(kWords - 1), qp[kWords]);
  Fp r;
  r.w[0] = sub_cc(k, acc[0], qp[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    r.w[j] = subc_cc(k, acc[j], qp[j]);  // the 13th word of the difference is 0
  }
  return r;
}

// The value of a merge form (sched::kMergeForms) whose terms read the pair's
// products at prod (index < kMergeIn) and its input elements at in, all
// canonical: each term's element, negated where its coefficient is, times
// the coefficient's magnitude on the accumulator (one path for every term:
// a path for the terms of coefficient +-1, seven in ten, measured no
// faster).  Below 2p (an operand), or canonical where `canonical` (a stored
// element).
LANE_FN Fp merge_eval(uint32_t form, const uint32_t* prod, const uint32_t* in, bool canonical) {
  const uint32_t first = form >> 8, n = form & 0xffu;
  uint32_t acc[kAccWords];
#pragma unroll
  for (int i = 0; i < kAccWords; ++i) {
    acc[i] = 0;
  }
#pragma unroll 1
  for (uint32_t i = 0; i < n; ++i) {
    const uint32_t term = sched::kMergeTerms[first + i];
    const uint32_t e = term >> 8;
    const int c = static_cast<int>(term & 0xffu) - 128;
    const uint32_t* src = e < static_cast<uint32_t>(sched::kMergeIn) ? prod + e * kWords
                                                                      : in + (e - sched::kMergeIn) * kWords;
    acc_mad(acc, neg_if(load(src), c < 0 ? 0xffffffffu : 0u), static_cast<uint32_t>(c < 0 ? -c : c));
  }
  const Fp r = acc_reduce_wide(acc);
  return canonical ? reduce_once(r) : r;
}

}  // namespace bls
