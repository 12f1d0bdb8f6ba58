// k1 G + k2 Q and ECDSA verification on secp256k1, four threads a lane in
// each of four warps.
//
// Two entry points on one kernel: secp256k1_ecmul2 (k1 G + k2 Q) replaces
// the JAX package's XLA program go_ibft_tpu/ops/secp256k1.py::ecmul2_base,
// and secp256k1_verify replaces ::ecdsa_verify (the range checks,
// w = s^-1, u1 = z w, u2 = r w, u1 G + u2 Q, not infinity, x == r or
// x == r + N where r < P - N).  Same function at the outputs: k1 G + k2 Q
// as canonical Jacobian limbs, equal to the plain version's as a
// projective point, infinity as (1, 1, 0); or the mask.
//
// What bounds it on an H100: about 3e3 field products a lane (two half
// ladders of 125 doublings, the comb, d Q) against 320 B in and 240 B out
// (verify: 400 B in, 1 B out, and a safegcd inversion): operations, not
// bytes.  The boot calls it at 8 lanes and a verification batch at a few
// hundred, where a few blocks run on 132 SMs: the time is one lane's chain
// of dependent products, each a few hundred integer instructions that one
// warp issues alone.  The design shortens that chain:
//
// * A lane's products run four at a time.  Each lane has a group of four
//   threads in a warp (lane.cuh's Group), each holding a copy of the
//   lane's values; the independent products of a point operation are one
//   step, thread t computing the t-th, and a shuffle gives every thread
//   all of them.  A doubling (dbl-2009-l, a = 0) is three steps in place
//   of seven products: X^2, Y^2, Z^2, (Y + Z)^2 (so 2 Y Z = (Y + Z)^2 -
//   Y^2 - Z^2); B^2, (X + B)^2, (3 A)^2; E (D - X3), a lone product spread
//   over the group instead (each thread a quarter of its partial
//   products).  An addition is five steps in place of sixteen products.
//   The warp issues a step once for all its threads.  The point operations
//   are calls, as the products are.
// * Four warps a block of 8 lanes, one role each.  Warp 3 makes the
//   scalars (verify: s^-1 by safegcd, u1, u2) and k2's GLV halves (b1,
//   b2) and hands them over in shared memory, while warps 0-2 build the
//   table of d Q, d = 1..16, each entry with beta X for phi(d Q) = (beta
//   X, Y, Z), in shared memory (one column a lane; the group's four
//   threads read one address): about 5 doublings and 2 additions each.
//   The half ladders b1 Q and b2 phi(Q) run in 26 signed 5-bit windows
//   (Booth digits in [-16, 16]), each cut at window 17: warps 0 and 1 run
//   the windows above it and then 85 doublings, warps 2 and 3 the
//   windows below it and half the comb each (k1 G from the recovery's
//   table of d 2^(8w) G, one mixed addition a nonzero byte), so the
//   longest chain is the doublings and a third of the additions.  Then
//   three additions put the halves together and the merge ends.
// * Q is never checked to be on the curve, as in the JAX package.  An
//   off-curve Q lies on another curve y^2 = x^3 + b', where phi is not
//   multiplication by lambda and where a sum with a point of the true
//   curve is not associative; the multiples of Q and phi(Q) stay on that
//   curve, where any digits and order of their sum give one point.  So the
//   split is the JAX package's exact (b1, b2), and the merge is the plain
//   version's order, k1 G + (b1 Q + b2 phi(Q)).  The additions are complete
//   (P == Q, P == -Q and infinity, which crafted lanes reach).
// * verify compares x(Q) = X / Z^2 with r and r + N as X == r Z^2 and
//   X == (r + N) Z^2: no second inversion.
//
// The host build (g++ with lane.cuh's host Group, which runs a group's four
// threads as a loop) runs the same steps: the CPU tests hold
// secp256k1_ecmul2_host and secp256k1_verify_host against the plain
// versions and the host oracle, and secp256k1_fp_mul_host's grouped and
// spread products against Python's integers.

#include "secp256k1.cuh"

namespace secp {

using Quad = Group<4>;


constexpr int kQWords = 32;        // words a d Q entry: X, Y, Z, beta X
constexpr int kQEntries = 16;      // d Q for d = 1..16
constexpr int kBooth = 5;          // bits a window of a half ladder
constexpr int kBoothWindows = 26;  // 26 x 5 bits: a half below 2^129 and its top digit's sign bit, 0

// t-th of the operands (t beyond them: the last), as selects.
LANE_FN U256 pick(int t, const U256& a, const U256& b) { return select(t == 0, a, b); }

LANE_FN U256 pick(int t, const U256& a, const U256& b, const U256& c) {
  return select(t == 0, a, select(t == 1, b, c));
}

LANE_FN U256 pick(int t, const U256& a, const U256& b, const U256& c, const U256& d) {
  return select(t == 0, a, select(t == 1, b, select(t == 2, c, d)));
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

LANE_FN uint32_t mul_lo32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return a * b;
#endif
}

LANE_FN uint32_t mul_hi32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}

// Thread t's share of a b when one product is spread over a group: words
// 2t and 2t + 1 of a times b, a 320-bit partial sum at word 2t of the
// product.
struct Rows {
  uint32_t w[10];
};

LANE_FN Rows split_rows(int t, const U256& a, const U256& b) {
  const uint32_t a0 = t == 0 ? a.w[0] : t == 1 ? a.w[2] : t == 2 ? a.w[4] : a.w[6];
  const uint32_t a1 = t == 0 ? a.w[1] : t == 1 ? a.w[3] : t == 2 ? a.w[5] : a.w[7];
  uint64_t col[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    col[k] = 0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] += mul_lo32(a0, b.w[j]);
    col[j + 1] += static_cast<uint64_t>(mul_hi32(a0, b.w[j])) + mul_lo32(a1, b.w[j]);
    col[j + 2] += mul_hi32(a1, b.w[j]);
  }
  Rows r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    c += col[k];
    r.w[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return r;
}

// a b mod P as one step of the group: each thread a quarter of the partial
// products, every thread the sum of the four and its reduction; for a
// lone product, shorter than one thread's whole product
// (bench/ecmul2_variants.py: split_mul against fp_mul).
LANE_FN U256 quad_mul1(const Quad& g, const U256& a, const U256& b) {
  Rows part[4];
  g.step(part, [&](int t) { return split_rows(t, a, b); });
  uint32_t t[16] = {0};
#pragma unroll
  for (int src = 0; src < 4; ++src) {
    uint64_t carry = 0;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      carry += static_cast<uint64_t>(t[2 * src + k]) + part[src].w[k];
      t[2 * src + k] = static_cast<uint32_t>(carry);
      carry >>= 32;
    }
#pragma unroll
    for (int k = 2 * src + 10; k < 16; ++k) {
      carry += t[k];
      t[k] = static_cast<uint32_t>(carry);
      carry >>= 32;
    }
  }
  return fp_reduce(t);
}

// ---------------------------------------------------------------------------
// Point operations, a lane's independent products one step of its group
// ---------------------------------------------------------------------------
//
// They are calls on the card, as the products are: inlined where they are
// used, the kernel took about 9 % longer and four times as long to build
// (PERF.md).

// 2p ("dbl-2009-l", a = 0); infinity stays infinity (Z3 = 2 Y Z).
LANE_CALL Jac quad_double(const Quad g, const Jac p) {
  const U256 yz = fp_add(p.y, p.z);
  U256 s[4];  // A = X^2, B = Y^2, Z^2, (Y + Z)^2
  g.step(s, [&](int t) { return fp_sqr(pick(t, p.x, p.y, p.z, yz)); });
  Jac r;
  r.z = fp_sub(fp_sub(s[3], s[1]), s[2]);  // Z3 = 2 Y Z
  const U256 e = fp_add(fp_add(s[0], s[0]), s[0]);  // E = 3A
  const U256 xb = fp_add(p.x, s[1]);
  U256 u[3];  // C = B^2, (X + B)^2, F = E^2
  g.step(u, [&](int t) { return fp_sqr(pick(t, s[1], xb, e)); });
  const U256 t = fp_sub(fp_sub(u[1], s[0]), u[0]);
  const U256 d = fp_add(t, t);                 // D = 2((X + B)^2 - A - C)
  r.x = fp_sub(u[2], fp_add(d, d));           // X3 = F - 2D
  U256 c8 = fp_add(u[0], u[0]);
  c8 = fp_add(c8, c8);
  c8 = fp_add(c8, c8);
  r.y = fp_sub(quad_mul1(g, e, fp_sub(d, r.x)), c8);  // Y3 = E (D - X3) - 8C
  return r;
}

// The tail of both additions: given H = U2 - U1 != 0, R = S2 - S1, U1, S1,
// finish X3, Y3 and Z3 = Z1 Z2 H.  kAffine: Z2 = 1, so Z3 = Z1 H.
template <bool kAffine>
LANE_FN Jac quad_add_tail(const Quad& g, const U256& h, const U256& rr, const U256& u1,
                          const U256& s1, const U256& z1, const U256& z2) {
  U256 a[3];  // H^2, R^2, Z1 Z2 (kAffine: Z3 = Z1 H)
  g.step(a, [&](int t) { return fp_mul(pick(t, h, rr, z1), pick(t, h, rr, kAffine ? h : z2)); });
  Jac p;
  U256 v;
  U256 hhh;
  if (kAffine) {
    U256 b[2];  // H^3, V = U1 H^2
    g.step(b, [&](int t) { return fp_mul(pick(t, a[0], u1), pick(t, h, a[0])); });
    hhh = b[0];
    v = b[1];
    p.z = a[2];
  } else {
    U256 b[3];  // H^3, V = U1 H^2, Z3 = Z1 Z2 H
    g.step(b, [&](int t) { return fp_mul(pick(t, a[0], u1, a[2]), pick(t, h, a[0], h)); });
    hhh = b[0];
    v = b[1];
    p.z = b[2];
  }
  p.x = fp_sub(fp_sub(fp_sub(a[1], hhh), v), v);  // X3 = R^2 - H^3 - 2 U1 H^2
  const U256 vx = fp_sub(v, p.x);
  U256 c[2];  // S1 H^3, R (V - X3)
  g.step(c, [&](int t) { return fp_mul(pick(t, s1, rr), pick(t, hhh, vx)); });
  p.y = fp_sub(c[1], c[0]);  // Y3 = R (U1 H^2 - X3) - S1 H^3
  return p;
}

// p + (qx, qy), an affine point.  Complete: infinity, P == Q, P == -Q.
LANE_CALL Jac quad_add_affine(const Quad g, const Jac p, const U256 qx, const U256 qy) {
  if (is_zero(p.z)) {
    return Jac{qx, qy, small(1)};
  }
  U256 a[2];  // Z1^2, qy Z1
  g.step(a, [&](int t) { return fp_mul(pick(t, p.z, qy), p.z); });
  U256 b[2];  // U2 = qx Z1^2, S2 = qy Z1^3
  g.step(b, [&](int t) { return fp_mul(pick(t, qx, a[1]), a[0]); });
  const U256 h = fp_sub(b[0], p.x);
  const U256 rr = fp_sub(b[1], p.y);
  if (is_zero(h)) {
    return is_zero(rr) ? quad_double(g, p) : infinity();
  }
  return quad_add_tail<true>(g, h, rr, p.x, p.y, p.z, p.z);
}

// p + q, both Jacobian.  Complete: infinity, P == Q, P == -Q.
LANE_CALL Jac quad_add(const Quad g, const Jac p, const Jac q) {
  if (is_zero(q.z)) {
    return p;
  }
  if (is_zero(p.z)) {
    return q;
  }
  U256 a[4];  // Z1^2, Z2^2, Y1 Z2, Y2 Z1
  g.step(a, [&](int t) { return fp_mul(pick(t, p.z, q.z, p.y, q.y), pick(t, p.z, q.z, q.z, p.z)); });
  U256 b[4];  // U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2^3, S2 = Y2 Z1^3
  g.step(b, [&](int t) { return fp_mul(pick(t, p.x, q.x, a[2], a[3]), pick(t, a[1], a[0], a[1], a[0])); });
  const U256 h = fp_sub(b[1], b[0]);
  const U256 rr = fp_sub(b[3], b[2]);
  if (is_zero(h)) {
    return is_zero(rr) ? quad_double(g, p) : infinity();
  }
  return quad_add_tail<false>(g, h, rr, b[0], b[2], p.z, q.z);
}

// ---------------------------------------------------------------------------
// The table of d Q, the half ladders and the comb
// ---------------------------------------------------------------------------

// d Q for d = 1..16 (Jacobian) and beta X, in a per-lane column: on the
// card shared memory with one column a lane of the block, on the host an
// array.  The group's leader writes; every thread of the group reads.  The
// kernel hands its partial points over in the same layout.
struct QTable {
  uint32_t* base;
  int stride;

  LANE_FN uint32_t* at(int d, int word) const {
    return base + ((d - 1) * kQWords + word) * stride;
  }

  LANE_FN void put(int d, const Jac& p) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *at(d, i) = p.x.w[i];
      *at(d, 8 + i) = p.y.w[i];
      *at(d, 16 + i) = p.z.w[i];
    }
  }

  LANE_FN U256 get_word8(int d, int first) const {
    U256 r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r.w[i] = *at(d, first + i);
    }
    return r;
  }

  // d Q, or phi(d Q) = (beta X, Y, Z).
  LANE_FN Jac get(uint32_t d, bool phi) const {
    const int e = static_cast<int>(d);
    return Jac{get_word8(e, phi ? 24 : 0), get_word8(e, 8), get_word8(e, 16)};
  }
};

// One entry into the table, by the group's leader.
LANE_FN void put_entry(const Quad& g, const QTable& tab, int d, const Jac& p) {
  if (g.leader()) {
    tab.put(d, p);
  }
}

// beta X for the `count` entries of the table listed 5 bits each in
// `list`, which the group has written: four a step.
LANE_FN void put_beta(const Quad& g, const QTable& tab, uint64_t list, int count) {
  g.sync();
  const U256 beta = from_table(kBeta);
#pragma unroll 1
  for (int first = 0; first < count; first += 4) {
    const int n = count - first < 4 ? count - first : 4;
    U256 bx[4];
    g.step(bx, [&](int t) {
      const int e = static_cast<int>(list >> (5 * (first + (t < n ? t : n - 1)))) & 31;
      return fp_mul(tab.get_word8(e, 0), beta);
    });
    if (g.leader()) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < n) {
          const int e = static_cast<int>(list >> (5 * (first + k))) & 31;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            *tab.at(e, 24 + i) = bx[k].w[i];
          }
        }
      }
    }
  }
}

// The role's part of the table of d Q, Q = (qx, qy), d = 1..16, each
// entry with beta X; about 5 doublings and 2 additions a role: role 0 the
// entries 1, 2, 3, 6, 12, 4, 5, 10; role 1 8 = 2 2 2 Q, 7 = 8 - 1, 14, 16,
// 15 = 16 - 1; role 2 9 = 8 + 1, 11 = 9 + 2, 13 = 11 + 2.
LANE_FN void build_q_part(const Quad& g, int role, const U256& qx, const U256& qy,
                          const QTable& tab) {
  const Jac q{qx, qy, small(1)};
  const U256 nqy = fp_neg(qy);
  const Jac q2 = quad_double(g, q);
  uint64_t list = 0;
  int count = 0;
  auto put = [&](int d, const Jac& p) {
    put_entry(g, tab, d, p);
    list |= static_cast<uint64_t>(d) << (5 * count);
    ++count;
  };
  if (role == 0) {
    put(1, q);
    put(2, q2);
    const Jac q3 = quad_add_affine(g, q2, qx, qy);
    put(3, q3);
    const Jac q6 = quad_double(g, q3);
    put(6, q6);
    put(12, quad_double(g, q6));
    const Jac q4 = quad_double(g, q2);
    put(4, q4);
    const Jac q5 = quad_add_affine(g, q4, qx, qy);
    put(5, q5);
    put(10, quad_double(g, q5));
  } else {
    const Jac q8 = quad_double(g, quad_double(g, q2));
    if (role == 1) {
      put(8, q8);
      const Jac q7 = quad_add_affine(g, q8, qx, nqy);
      put(7, q7);
      put(14, quad_double(g, q7));
      const Jac q16 = quad_double(g, q8);
      put(16, q16);
      put(15, quad_add_affine(g, q16, qx, nqy));
    } else {
      const Jac q9 = quad_add_affine(g, q8, qx, qy);
      put(9, q9);
      const Jac q11 = quad_add(g, q9, q2);
      put(11, q11);
      put(13, quad_add(g, q11, q2));
    }
  }
  put_beta(g, tab, list, count);
}

// k <<= s over the five low words, 0 < s < 32.
LANE_FN void shl5(U256& k, int s) {
#pragma unroll
  for (int i = 4; i > 0; --i) {
    k.w[i] = (k.w[i] << s) | (k.w[i - 1] >> (32 - s));
  }
  k.w[0] <<= s;
}

// The next Booth digit of a GLV half from the top, the half kept shifted so
// that the window's bits 5i - 1 .. 5i + 4 are the top six bits of word 4:
// b(5i-1) + b(5i) + 2 b(5i+1) + 4 b(5i+2) + 8 b(5i+3) - 16 b(5i+4), in
// [-16, 16]; the sum over i of digit_i 32^i is the half.
LANE_FN int booth_digit(U256& k) {
  const uint32_t x = k.w[4] >> 26;
  shl5(k, kBooth);
  return static_cast<int>(x & 1u) + static_cast<int>((x >> 1) & 15u) - 16 * static_cast<int>(x >> 5);
}

// The windows from..to (from >= to) of +-k Q (neg: -) or +-k phi(Q) (phi)
// for a GLV half k < 2^129 in 26 signed 5-bit windows (Booth): 5 doublings
// and at most one addition a window, then `tail` more doublings.  The
// whole ladder is windows 25..0; a ladder cut at window m is windows
// 25..m with 5 m doublings after them, plus windows m-1..0, each on a warp
// of its own.  On Q's own curve the sum of multiples of Q is one point
// whatever digits and order make it, so the recoding and the cut leave the
// result as the JAX package's ladder gives it.
LANE_FN Jac quad_half_mul(const Quad& g, U256 k, bool neg, bool phi, const QTable& tab, int from, int to,
                          int tail) {
  shl5(k, 30);  // bit 124, the top window's lowest, to bit 154
#pragma unroll 1
  for (int win = kBoothWindows - 1; win > from; --win) {
    shl5(k, kBooth);
  }
  Jac acc = infinity();
#pragma unroll 1
  for (int win = from; win >= to; --win) {
    if (win != from) {
#pragma unroll 1
      for (int i = 0; i < kBooth; ++i) {
        acc = quad_double(g, acc);
      }
    }
    const int d = booth_digit(k);
    if (d) {
      Jac e = tab.get(static_cast<uint32_t>(d < 0 ? -d : d), phi);
      if (neg != (d < 0)) {
        e.y = fp_neg(e.y);
      }
      acc = quad_add(g, acc, e);
    }
  }
#pragma unroll 1
  for (int i = 0; i < tail; ++i) {
    acc = quad_double(g, acc);
  }
  return acc;
}

// The comb's windows [from, from + 16) of k G: the sum of the entries of
// k's bytes there, least significant first; the next entry's load is
// issued before the current addition.
LANE_FN Jac quad_comb_mul(const Quad& g, U256 k, const uint32_t* gtab, int from) {
  if (from) {  // k >>= 128
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k.w[i] = k.w[i + 4];
      k.w[i + 4] = 0;
    }
  }
  Jac acc = infinity();
  uint32_t d = k.w[0] & 255u;
  U256 nx, ny;
  load_comb(nx, ny, gtab, from, d);
#pragma unroll 1
  for (int w = from; w < from + kCombWindows / 2; ++w) {
    const U256 x = nx, y = ny;
    const uint32_t dw = d;
#pragma unroll
    for (int i = 0; i < 7; ++i) {  // k >>= 8
      k.w[i] = (k.w[i] >> 8) | (k.w[i + 1] << 24);
    }
    k.w[7] >>= 8;
    if (w + 1 < from + kCombWindows / 2) {
      d = k.w[0] & 255u;
      load_comb(nx, ny, gtab, w + 1, d);
    }
    if (dw) {
      acc = quad_add_affine(g, acc, x, y);
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The lane
// ---------------------------------------------------------------------------

// 20 limbs (the value as fields.exact_carry reads it, below 2^260) mod P.
LANE_FN U256 field_from_limbs(const int32_t* limbs) {
  uint32_t c[kLimbs];
  exact_carry(c, limbs);
  U256 lo;
  uint32_t t[16] = {0};
  t[8] = limbs_to_words(lo, c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = lo.w[i];
  }
  return fp_reduce(t);
}

// A lane's two scalars mod N: (k1, k2) as given, or the verification's
// u1 = z s^-1 and u2 = r s^-1 from (z, r, s), each taken mod N.
LANE_FN void ecmul2_scalars(bool verify, const int32_t* a, const int32_t* b, const int32_t* s,
                            U256& k1, U256& k2) {
  if (verify) {
    const U256 w = mont_mul(modinv(scalar_mod_n(s, true), kN30, kN30Inv), from_table(kMontR2N));
    k1 = mont_mul(scalar_mod_n(a, true), w);  // s^-1 R in Montgomery form: plain products
    k2 = mont_mul(scalar_mod_n(b, true), w);
  } else {
    k1 = scalar_mod_n(a, true);
    k2 = scalar_mod_n(b, true);
  }
}

// The ladders' cut: windows 25..17 on warps 0 and 1 (then 85 doublings),
// windows 16..0 and half the comb on warps 2 and 3, which takes about as
// long; cuts at 15, 16 and 18 were no faster on the H100 (PERF.md).
constexpr int kCut = 17;

// The roles after the table: role 0 b1 Q's windows above the cut, role 1
// b2 phi(Q)'s, (b1, b2) the JAX package's GLV halves of k2 (half, neg);
// roles 2 and 3 the windows below the cut of b1 Q and b2 phi(Q), and the
// comb's low and high halves of k1 G (comb).
LANE_FN Jac ecmul2_part(const Quad& g, int role, const U256& k1, const U256& half, bool neg,
                        const uint32_t* gtab, const QTable& tab, Jac& comb) {
  if (role < 2) {
    return quad_half_mul(g, half, neg, role == 1, tab, kBoothWindows - 1, kCut, kBooth * kCut);
  }
  comb = quad_comb_mul(g, k1, gtab, role == 2 ? 0 : kCombWindows / 2);
  return quad_half_mul(g, half, neg, role == 3, tab, kCut - 1, 0, 0);
}

// k1 G + (b1 Q + b2 phi(Q)), the plain version's order.
LANE_FN Jac ecmul2_merge(const Quad& g, const Jac& kg, const Jac& bq, const Jac& bphi) {
  return quad_add(g, kg, quad_add(g, bq, bphi));
}

// The verification's end: 0 < r < N, 0 < s < N, Q != infinity, and
// x(Q) == r, or x(Q) == r + N where r < P - N; x(Q) = X / Z^2, so the
// comparisons are X == r Z^2 and X == (r + N) Z^2.
LANE_FN bool verify_result(const Quad& g, const int32_t* r_limbs, const int32_t* s_limbs,
                           const Jac& q) {
  U256 r, s;
  const bool in_range = scalar_in_range(r, r_limbs) && scalar_in_range(s, s_limbs);
  if (!in_range || is_zero(q.z)) {
    return false;
  }
  const U256 zz = fp_sqr(q.z);
  U256 r_plus_n = r;
  add8(r_plus_n.w, kN, 0);  // below P where it is compared
  U256 x[2];  // r Z^2, (r + N) Z^2
  g.step(x, [&](int t) { return fp_mul(pick(t, r, r_plus_n), zz); });
  U256 p_minus_n = from_table(kP);
  sub8(p_minus_n.w, kN);
  return equal(q.x, x[0]) || (!geq(r, p_minus_n.w) && equal(q.x, x[1]));
}

// X, Y, Z as canonical limbs; infinity as (1, 1, 0).
LANE_FN void write_point(int32_t* x_out, int32_t* y_out, int32_t* z_out, const Jac& q) {
  const Jac p = is_zero(q.z) ? infinity() : q;
  words_to_limbs(x_out, p.x);
  words_to_limbs(y_out, p.y);
  words_to_limbs(z_out, p.z);
}

}  // namespace secp

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;                      // threads a lane in each role
constexpr int kLanes = 32 / kGroup;            // lanes a block: one warp a role
constexpr int kThreads = 4 * 32;               // four roles
constexpr int kTableWords = secp::kQEntries * secp::kQWords * kLanes;  // 16,384 B
constexpr int kScalarWords = 20;               // b1, n1, b2, n2 (5 + 1 words each), k1 (8)
constexpr int kHandoffWords = 5 * secp::kQWords * kLanes;            // five points a lane: 5,120 B

// k1 G + k2 Q (kVerify false: a = k1, b = k2; X, Y, Z out) or the
// verification (kVerify true: a = z, b = r, s; the mask out), 8 lanes a
// block of four warps: warp w has role w for each lane (see the top of
// the file).  The warps meet at three barriers: after the table and the
// scalars; after the ladders (then b1 Q, b2 phi(Q) and k1 G are each one
// addition away); and before the merge.
template <bool kVerify>
__device__ __forceinline__ void ecmul2_block(const int32_t* __restrict__ a,
                                             const int32_t* __restrict__ b,
                                             const int32_t* __restrict__ s,
                                             const int32_t* __restrict__ qx,
                                             const int32_t* __restrict__ qy,
                                             const uint32_t* __restrict__ gtab,
                                             int32_t* __restrict__ x_out, int32_t* __restrict__ y_out,
                                             int32_t* __restrict__ z_out,
                                             uint8_t* __restrict__ ok_out, long long n) {
  __shared__ uint32_t table[kTableWords];
  __shared__ uint32_t scalars[kScalarWords * kLanes];
  __shared__ uint32_t handoff[kHandoffWords];
  const int role = threadIdx.x / 32;
  const int lane = (threadIdx.x % 32) / kGroup;
  const secp::Quad g = secp::Quad::of_thread(threadIdx.x);
  const long long i = static_cast<long long>(blockIdx.x) * kLanes + lane;
  const bool live = i < n;
  const long long at = i * secp::kLimbs;
  const secp::QTable tab{table + lane, kLanes};
  const secp::QTable points{handoff + lane, kLanes};  // 1: b1 Q low, 2: b2 phi(Q) low, 3: comb high,
                                                     // 4: b1 Q, 5: b2 phi(Q)
  uint32_t* const my_scalars = scalars + lane;
  if (live) {
    if (role == 3) {
      secp::U256 k1, k2, h[2];
      bool neg[2];
      secp::ecmul2_scalars(kVerify, a + at, b + at, kVerify ? s + at : nullptr, k1, k2);
      secp::glv_split(k2, h[0], neg[0], h[1], neg[1]);
      if (g.leader()) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int w = 0; w < 5; ++w) {  // below 2^129
            my_scalars[(6 * k + w) * kLanes] = h[k].w[w];
          }
          my_scalars[(6 * k + 5) * kLanes] = neg[k];
        }
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          my_scalars[(12 + w) * kLanes] = k1.w[w];
        }
      }
    } else {
      secp::build_q_part(g, role, secp::field_from_limbs(qx + at), secp::field_from_limbs(qy + at), tab);
    }
  }
  __syncthreads();
  secp::Jac part, comb;
  if (live) {
    const int side = role % 2;  // b1 Q or b2 phi(Q)
    secp::U256 half = secp::small(0), k1;
#pragma unroll
    for (int w = 0; w < 5; ++w) {
      half.w[w] = my_scalars[(6 * side + w) * kLanes];
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      k1.w[w] = my_scalars[(12 + w) * kLanes];
    }
    part = secp::ecmul2_part(g, role, k1, half, my_scalars[(6 * side + 5) * kLanes] != 0, gtab, tab, comb);
    if (role >= 2 && g.leader()) {
      points.put(role - 1, part);
      if (role == 3) {
        points.put(3, comb);
      }
    }
  }
  __syncthreads();
  if (live && role < 3) {
    const secp::Jac sum = secp::quad_add(g, role < 2 ? part : comb, points.get(role + 1, false));
    if (role < 2 && g.leader()) {
      points.put(role + 4, sum);
    }
    comb = sum;  // role 2: k1 G
  }
  __syncthreads();
  if (live && role == 2) {
    const secp::Jac q = secp::ecmul2_merge(g, comb, points.get(4, false), points.get(5, false));
    if (kVerify) {
      const bool ok = secp::verify_result(g, b + at, s + at, q);
      if (g.leader()) {
        ok_out[i] = ok;
      }
    } else if (g.leader()) {
      secp::write_point(x_out + at, y_out + at, z_out + at, q);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
secp256k1_ecmul2_kernel(const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
                        const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                        const uint32_t* __restrict__ gtab, int32_t* __restrict__ x_out,
                        int32_t* __restrict__ y_out, int32_t* __restrict__ z_out, long long n) {
  ecmul2_block<false>(k1, k2, nullptr, qx, qy, gtab, x_out, y_out, z_out, nullptr, n);
}

__global__ void __launch_bounds__(kThreads)
secp256k1_verify_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                        const int32_t* __restrict__ z, const int32_t* __restrict__ r,
                        const int32_t* __restrict__ s, const uint32_t* __restrict__ gtab,
                        uint8_t* __restrict__ ok_out, long long n) {
  ecmul2_block<true>(z, r, s, qx, qy, gtab, nullptr, nullptr, nullptr, ok_out, n);
}

}  // namespace

// C entry point, bound with ctypes: k1 G + k2 Q for n lanes.  k1 and k2
// are 20 limbs below 2N, Q = (qx, qy) 20 canonical limbs each; gtab is the
// recovery's comb table, (32, 256, 16) words on the card (see
// ops/ecrecover.py); x_out, y_out, z_out get the Jacobian result as
// canonical limbs (infinity: (1, 1, 0)).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int secp256k1_ecmul2(const void* k1, const void* k2, const void* qx, const void* qy,
                                const void* gtab, void* x_out, void* y_out, void* z_out, long long n,
                                void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kLanes - 1) / kLanes;
  secp256k1_ecmul2_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(qx), static_cast<const int32_t*>(qy),
      static_cast<const uint32_t*>(gtab), static_cast<int32_t*>(x_out),
      static_cast<int32_t*>(y_out), static_cast<int32_t*>(z_out), n);
  return static_cast<int>(cudaGetLastError());
}

// C entry point, bound with ctypes: the ECDSA verification of n lanes.
// qx, qy, z, r, s are 20 limbs each (z taken mod N); ok_out gets one byte
// a lane (a torch.bool).  Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int secp256k1_verify(const void* qx, const void* qy, const void* z, const void* r,
                                const void* s, const void* gtab, void* ok_out, long long n,
                                void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kLanes - 1) / kLanes;
  secp256k1_verify_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qx), static_cast<const int32_t*>(qy),
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(s), static_cast<const uint32_t*>(gtab),
      static_cast<uint8_t*>(ok_out), n);
  return static_cast<int>(cudaGetLastError());
}

#else

namespace {

// One lane on the host, its four roles one after the other in the order
// of the card's barriers, each role's group of four threads a loop.
secp::Jac ecmul2_lane_host(bool verify, const int32_t* a, const int32_t* b, const int32_t* s,
                           const int32_t* qx, const int32_t* qy, const uint32_t* gtab) {
  uint32_t table[secp::kQEntries * secp::kQWords];
  const secp::QTable tab{table, 1};
  const secp::Quad g{};
  secp::U256 k1, k2, h[2];
  bool neg[2];
  secp::ecmul2_scalars(verify, a, b, s, k1, k2);
  secp::glv_split(k2, h[0], neg[0], h[1], neg[1]);
  const secp::U256 x = secp::field_from_limbs(qx), y = secp::field_from_limbs(qy);
  for (int role = 0; role < 3; ++role) {
    secp::build_q_part(g, role, x, y, tab);
  }
  secp::Jac part[4], comb[4];
  for (int role = 0; role < 4; ++role) {
    part[role] = secp::ecmul2_part(g, role, k1, h[role % 2], neg[role % 2], gtab, tab, comb[role]);
  }
  const secp::Jac bq = secp::quad_add(g, part[0], part[2]);
  const secp::Jac bphi = secp::quad_add(g, part[1], part[3]);
  return secp::ecmul2_merge(g, secp::quad_add(g, comb[2], comb[3]), bq, bphi);
}

}  // namespace

// secp256k1_ecmul2 and secp256k1_verify on the host, lane after lane.  Not
// used by the port's wrappers.
extern "C" int secp256k1_ecmul2_host(const int32_t* k1, const int32_t* k2, const int32_t* qx,
                                     const int32_t* qy, const uint32_t* gtab, int32_t* x_out,
                                     int32_t* y_out, int32_t* z_out, long long n) {
  for (long long i = 0; i < n; ++i) {
    const long long at = i * secp::kLimbs;
    const secp::Jac q = ecmul2_lane_host(false, k1 + at, k2 + at, nullptr, qx + at, qy + at, gtab);
    secp::write_point(x_out + at, y_out + at, z_out + at, q);
  }
  return 0;
}

extern "C" int secp256k1_verify_host(const int32_t* qx, const int32_t* qy, const int32_t* z,
                                     const int32_t* r, const int32_t* s, const uint32_t* gtab,
                                     uint8_t* ok_out, long long n) {
  for (long long i = 0; i < n; ++i) {
    const long long at = i * secp::kLimbs;
    const secp::Jac q = ecmul2_lane_host(true, z + at, r + at, s + at, qx + at, qy + at, gtab);
    ok_out[i] = secp::verify_result(secp::Quad{}, r + at, s + at, q);
  }
  return 0;
}

// The kernel's products on the host, n values of 8 little-endian words
// below 2^256: out[i] = a[i] b[i] mod P, four a step of a group (form 0:
// fp_mul, form 1: fp_sqr of a[i]), or one product spread over a group's
// four threads (form 2: quad_mul1).
extern "C" int secp256k1_fp_mul_host(const uint32_t* a, const uint32_t* b, int form, uint32_t* out,
                                     long long n) {
  const secp::Quad g{};
  for (long long i = 0; i < n; i += 4) {
    const long long count = n - i < 4 ? n - i : 4;
    secp::U256 r[4];
    if (form == 2) {
      for (long long k = 0; k < count; ++k) {
        r[k] = secp::quad_mul1(g, secp::from_table(a + 8 * (i + k)), secp::from_table(b + 8 * (i + k)));
      }
    } else {
      g.step(r, [&](int t) {
        const long long at = 8 * (i + (t < count ? t : count - 1));
        return form == 1 ? secp::fp_sqr(secp::from_table(a + at))
                         : secp::fp_mul(secp::from_table(a + at), secp::from_table(b + at));
      });
    }
    for (long long k = 0; k < count; ++k) {
      for (int w = 0; w < 8; ++w) {
        out[8 * (i + k) + w] = r[k].w[w];
      }
    }
  }
  return 0;
}

#endif
