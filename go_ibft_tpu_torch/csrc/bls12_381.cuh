// BLS12-381 lane arithmetic shared by the pairing kernels (bls12_381.cu):
// the base field, the tower Fp2 / Fp6 / Fp12, Jacobian points on G1 and G2,
// the ate Miller loop and the final exponentiation, each for one lane.
//
// Field elements mod p are 12 little-endian 32-bit words in the Montgomery
// domain with R = 2^384, canonical (< p) after every operation: p < 2^381,
// so a sum of two elements never leaves 382 bits, and the product is one
// CIOS Montgomery pass with 64-bit column arithmetic and one conditional
// subtraction.  The tower and every formula above it are the JAX package's
// (go_ibft_tpu/ops/bls12_381.py): Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 -
// xi), Fp12 = Fp6[w]/(w^2 - v), xi = 1 + u; the Jacobian doubling and the
// complete addition of _jac_ops; the Miller loop's doubling and addition
// lines of _dbl_step and _add_step (the same Jacobian representatives, so
// the Miller values are the same field elements as the JAX package's and as
// the port's plain version, ops/bls12_381.py); the final exponentiation's
// easy part and the 2020/875 hard-part chain, which computes the pairing
// cubed.
//
// Everything here also compiles with a host C++ compiler (lane.cuh): the
// CPU tests build bls12_381.cu with g++ and hold the _host entry points
// against the host oracle (crypto/bls.py).

#pragma once

#include "lane.cuh"

#if defined(__CUDACC__)
#define BLS_CALL __device__ __noinline__
#else
#define BLS_CALL inline
#endif

namespace bls {

constexpr int kWords = 12;  // 32-bit words of a field element

struct Fp {
  uint32_t w[kWords];
};
struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 c0, c1, c2;
};
struct Fp12 {
  Fp6 c0, c1;
};
// A Jacobian point (x / z^2, y / z^3); z == 0 is the point at infinity.
template <class F>
struct Jac {
  F x, y, z;
};

LANE_TABLE uint32_t kP[kWords] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                                  0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod p: one in the Montgomery domain.
LANE_TABLE uint32_t kOne[kWords] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
                                    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
// p - 2: the exponent of the Fermat inverse.
LANE_TABLE uint32_t kPMinus2[kWords] = {0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                                        0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// gamma[n-1][k] = xi^(k (p^n - 1) / 6), n = 1, 2, k < 6, in the Montgomery domain:
// the Frobenius coefficients of the w-basis.
LANE_TABLE uint32_t kGamma[2][6][2][kWords] = {
    {
        {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
          0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu,
          0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu},
         {0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u,
          0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}},
        {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},
         {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
          0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}},
        {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
          0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu},
         {0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
          0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
        {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
          0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u,
          0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu},
         {0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu,
          0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu}},
    },
    {
        {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
          0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u, 0x232bda8eu, 0x0ec08ff1u,
          0xf1ca4721u, 0xd5c13cc6u, 0xbf7b5c04u, 0x47222a47u, 0xe51c5f59u, 0x0110f184u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
          0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u,
          0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
          0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
        {{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
          0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu},
         {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
          0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
    },
};
constexpr uint32_t kPInv = 0xfffcfffdu;  // -p^-1 mod 2^32
// |x|, the curve parameter's magnitude (the parameter is -x).
constexpr uint64_t kX = 0xd201000000010000ull;

// -- the base field ----------------------------------------------------------

LANE_FN Fp fp_zero() {
  Fp r;
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = 0;
  }
  return r;
}

LANE_FN Fp fp_one() {
  Fp r;
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = kOne[i];
  }
  return r;
}

LANE_FN bool is_zero(const Fp& a) {
  uint32_t acc = 0;
  for (int i = 0; i < kWords; ++i) {
    acc |= a.w[i];
  }
  return acc == 0;
}

LANE_FN bool equal(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
  for (int i = 0; i < kWords; ++i) {
    acc |= a.w[i] ^ b.w[i];
  }
  return acc == 0;
}

// a - p where a (with a carry word hi above it) is at least p, else a; a < 2p.
LANE_FN Fp reduce_once(const Fp& a, uint32_t hi) {
  Fp t;
  uint64_t borrow = 0;
  for (int i = 0; i < kWords; ++i) {
    const uint64_t d = static_cast<uint64_t>(a.w[i]) - kP[i] - borrow;
    t.w[i] = static_cast<uint32_t>(d);
    borrow = d >> 63;
  }
  return (hi != 0 || borrow == 0) ? t : a;
}

LANE_FN Fp add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
  for (int i = 0; i < kWords; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b.w[i];
    s.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return reduce_once(s, static_cast<uint32_t>(c));
}

LANE_FN Fp sub(const Fp& a, const Fp& b) {
  Fp d;
  uint64_t borrow = 0;
  for (int i = 0; i < kWords; ++i) {
    const uint64_t t = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d.w[i] = static_cast<uint32_t>(t);
    borrow = t >> 63;
  }
  if (borrow) {
    uint64_t c = 0;
    for (int i = 0; i < kWords; ++i) {
      c += static_cast<uint64_t>(d.w[i]) + kP[i];
      d.w[i] = static_cast<uint32_t>(c);
      c >>= 32;
    }
  }
  return d;
}

LANE_FN Fp neg(const Fp& a) { return sub(fp_zero(), a); }

// a * b * 2^-384 mod p (CIOS: one word of a per pass, then one Montgomery
// step); inputs and output canonical.
BLS_CALL Fp mul(const Fp& a, const Fp& b) {
  uint32_t t[kWords + 2];
  for (int i = 0; i < kWords + 2; ++i) {
    t[i] = 0;
  }
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < kWords; ++j) {
      c += static_cast<uint64_t>(a.w[i]) * b.w[j] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[kWords];
    t[kWords] = static_cast<uint32_t>(c);
    t[kWords + 1] = static_cast<uint32_t>(c >> 32);
    const uint32_t m = t[0] * kPInv;
    c = (static_cast<uint64_t>(m) * kP[0] + t[0]) >> 32;
    for (int j = 1; j < kWords; ++j) {
      c += static_cast<uint64_t>(m) * kP[j] + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[kWords];
    t[kWords - 1] = static_cast<uint32_t>(c);
    t[kWords] = t[kWords + 1] + static_cast<uint32_t>(c >> 32);
  }
  Fp r;
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = t[i];
  }
  return reduce_once(r, t[kWords]);
}

LANE_FN Fp sqr(const Fp& a) { return mul(a, a); }

// a^(p-2) (Fermat): the inverse of a nonzero a, and 0 for 0.
BLS_CALL Fp inv(const Fp& a) {
  Fp acc = fp_one();
  for (int i = kWords - 1; i >= 0; --i) {
    for (int b = 31; b >= 0; --b) {
      acc = sqr(acc);
      if ((kPMinus2[i] >> b) & 1u) {
        acc = mul(acc, a);
      }
    }
  }
  return acc;
}

// -- Fp2 = Fp[u] / (u^2 + 1) -----------------------------------------------

LANE_FN Fp2 f2_zero() { return Fp2{fp_zero(), fp_zero()}; }
LANE_FN Fp2 f2_one() { return Fp2{fp_one(), fp_zero()}; }
LANE_FN bool is_zero(const Fp2& a) { return is_zero(a.c0) && is_zero(a.c1); }
LANE_FN bool equal(const Fp2& a, const Fp2& b) { return equal(a.c0, b.c0) && equal(a.c1, b.c1); }
LANE_FN Fp2 add(const Fp2& a, const Fp2& b) { return Fp2{add(a.c0, b.c0), add(a.c1, b.c1)}; }
LANE_FN Fp2 sub(const Fp2& a, const Fp2& b) { return Fp2{sub(a.c0, b.c0), sub(a.c1, b.c1)}; }
LANE_FN Fp2 neg(const Fp2& a) { return Fp2{neg(a.c0), neg(a.c1)}; }
LANE_FN Fp2 conj(const Fp2& a) { return Fp2{a.c0, neg(a.c1)}; }
// Times xi = 1 + u.
LANE_FN Fp2 mul_xi(const Fp2& a) { return Fp2{sub(a.c0, a.c1), add(a.c0, a.c1)}; }
LANE_FN Fp2 mul_fp(const Fp2& a, const Fp& s) { return Fp2{mul(a.c0, s), mul(a.c1, s)}; }

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

// -- Fp6 = Fp2[v] / (v^3 - xi), Fp12 = Fp6[w] / (w^2 - v) -----------------

LANE_FN Fp6 f6_zero() { return Fp6{f2_zero(), f2_zero(), f2_zero()}; }
LANE_FN Fp6 add(const Fp6& a, const Fp6& b) { return Fp6{add(a.c0, b.c0), add(a.c1, b.c1), add(a.c2, b.c2)}; }
LANE_FN Fp6 sub(const Fp6& a, const Fp6& b) { return Fp6{sub(a.c0, b.c0), sub(a.c1, b.c1), sub(a.c2, b.c2)}; }
LANE_FN Fp6 neg(const Fp6& a) { return Fp6{neg(a.c0), neg(a.c1), neg(a.c2)}; }
// Times v: (a0, a1, a2) -> (xi a2, a0, a1).
LANE_FN Fp6 mul_v(const Fp6& a) { return Fp6{mul_xi(a.c2), a.c0, a.c1}; }

BLS_CALL Fp6 mul(const Fp6& a, const Fp6& b) {
  const Fp2 t0 = mul(a.c0, b.c0);
  const Fp2 t1 = mul(a.c1, b.c1);
  const Fp2 t2 = mul(a.c2, b.c2);
  const Fp2 c0 = add(t0, mul_xi(sub(mul(add(a.c1, a.c2), add(b.c1, b.c2)), add(t1, t2))));
  const Fp2 c1 = add(sub(mul(add(a.c0, a.c1), add(b.c0, b.c1)), add(t0, t1)), mul_xi(t2));
  const Fp2 c2 = add(sub(mul(add(a.c0, a.c2), add(b.c0, b.c2)), add(t0, t2)), t1);
  return Fp6{c0, c1, c2};
}

BLS_CALL Fp6 inv(const Fp6& a) {
  const Fp2 c0 = sub(sqr(a.c0), mul_xi(mul(a.c1, a.c2)));
  const Fp2 c1 = sub(mul_xi(sqr(a.c2)), mul(a.c0, a.c1));
  const Fp2 c2 = sub(sqr(a.c1), mul(a.c0, a.c2));
  const Fp2 t = inv(add(mul(a.c0, c0), mul_xi(add(mul(a.c1, c2), mul(a.c2, c1)))));
  return Fp6{mul(c0, t), mul(c1, t), mul(c2, t)};
}

LANE_FN Fp12 f12_one() { return Fp12{Fp6{f2_one(), f2_zero(), f2_zero()}, f6_zero()}; }

BLS_CALL Fp12 mul(const Fp12& a, const Fp12& b) {
  const Fp6 t0 = mul(a.c0, b.c0);
  const Fp6 t1 = mul(a.c1, b.c1);
  return Fp12{add(t0, mul_v(t1)), sub(mul(add(a.c0, a.c1), add(b.c0, b.c1)), add(t0, t1))};
}

LANE_FN Fp12 sqr(const Fp12& a) { return mul(a, a); }

BLS_CALL Fp12 inv(const Fp12& a) {
  const Fp6 t = inv(sub(mul(a.c0, a.c0), mul_v(mul(a.c1, a.c1))));
  return Fp12{mul(a.c0, t), neg(mul(a.c1, t))};
}

// f^(p^6): negates the odd powers of w.
LANE_FN Fp12 conj(const Fp12& a) { return Fp12{a.c0, neg(a.c1)}; }

// f^(p^n) for n = 1, 2: the w-basis coefficient e_k (e0 = c0.c0, e1 = c1.c0,
// e2 = c0.c1, e3 = c1.c1, e4 = c0.c2, e5 = c1.c2), conjugated for odd n,
// times gamma[n-1][k].
BLS_CALL Fp12 frob(const Fp12& a, int n) {
  Fp2 e[6] = {a.c0.c0, a.c1.c0, a.c0.c1, a.c1.c1, a.c0.c2, a.c1.c2};
  for (int k = 0; k < 6; ++k) {
    Fp2 g;
    for (int i = 0; i < kWords; ++i) {
      g.c0.w[i] = kGamma[n - 1][k][0][i];
      g.c1.w[i] = kGamma[n - 1][k][1][i];
    }
    e[k] = mul(n & 1 ? conj(e[k]) : e[k], g);
  }
  return Fp12{Fp6{e[0], e[2], e[4]}, Fp6{e[1], e[3], e[5]}};
}

// The twelve field elements of an Fp12 in the tower's order: c0.c0.c0,
// c0.c0.c1, c0.c1.c0, ..., c1.c2.c1.
LANE_FN const Fp& part(const Fp12& a, int k) {
  const Fp6& h = k < 6 ? a.c0 : a.c1;
  const Fp2& q = (k % 6) < 2 ? h.c0 : ((k % 6) < 4 ? h.c1 : h.c2);
  return k % 2 ? q.c1 : q.c0;
}

LANE_FN Fp& part(Fp12& a, int k) {
  Fp6& h = k < 6 ? a.c0 : a.c1;
  Fp2& q = (k % 6) < 2 ? h.c0 : ((k % 6) < 4 ? h.c1 : h.c2);
  return k % 2 ? q.c1 : q.c0;
}

LANE_FN bool is_one(const Fp12& a) {
  const Fp12 one = f12_one();
  bool ok = true;
  for (int k = 0; k < 12; ++k) {
    ok = ok && equal(part(a, k), part(one, k));
  }
  return ok;
}

// -- G1 and G2 in Jacobian coordinates (a = 0 curves) ---------------------

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

// -- the ate Miller loop --------------------------------------------------

// The line's w-basis slots 0, 3 and 5.
LANE_FN Fp12 sparse_line(const Fp2& e0, const Fp2& e3, const Fp2& e5) {
  const Fp2 z = f2_zero();
  return Fp12{Fp6{e0, z, z}, Fp6{z, e3, e5}};
}

// f_{|x|, Q}(P) conjugated (the parameter is negative), with the JAX
// package's lines: the tangent at T scaled by 2 Y Z^3 xi and the chord
// through T and Q scaled by -Z H (both in Fp2, killed by the final
// exponentiation).  The doubling steps run on every bit of |x| after the
// first, the addition steps on its five other set bits.
BLS_CALL Fp12 miller_loop(const Fp2& qx, const Fp2& qy, const Fp& px, const Fp& py) {
  Jac<Fp2> t{qx, qy, f2_one()};
  Fp12 f = f12_one();
  for (int bit = 62; bit >= 0; --bit) {
    {
      const Fp2 z2 = sqr(t.z);
      const Fp2 yz3 = mul(t.y, mul(z2, t.z));
      const Fp2 e0 = neg(muli(mul_xi(mul_fp(yz3, py)), 2));
      const Fp2 x2 = sqr(t.x);
      const Fp2 e3 = sub(muli(sqr(t.y), 2), muli(mul(x2, t.x), 3));
      const Fp2 e5 = muli(mul_fp(mul(x2, z2), px), 3);
      f = mul(sqr(f), sparse_line(e0, e3, e5));
      t = jac_double(t);
    }
    if ((kX >> bit) & 1u) {
      const Fp2 z2 = sqr(t.z);
      const Fp2 z3 = mul(z2, t.z);
      const Fp2 h = sub(mul(qx, z2), t.x);
      const Fp2 r = sub(mul(qy, z3), t.y);
      const Fp2 zh = mul(t.z, h);
      const Fp2 e0 = neg(mul_xi(mul_fp(zh, py)));
      const Fp2 e3 = sub(mul(qy, zh), mul(r, qx));
      const Fp2 e5 = mul_fp(r, px);
      f = mul(f, sparse_line(e0, e3, e5));
      const Fp2 hs = sqr(h);
      const Fp2 hc = mul(hs, h);
      const Fp2 v = mul(t.x, hs);
      const Fp2 x3 = sub(sub(sqr(r), hc), muli(v, 2));
      const Fp2 y3 = sub(mul(r, sub(v, x3)), mul(t.y, hc));
      t = Jac<Fp2>{x3, y3, zh};
    }
  }
  return conj(f);
}

// -- the final exponentiation, cubed ---------------------------------------

// g^x for the (negative) parameter x: conj(g^|x|), valid in the cyclotomic
// subgroup.
BLS_CALL Fp12 exp_by_x(const Fp12& g) {
  Fp12 acc = g;
  for (int bit = 62; bit >= 0; --bit) {
    acc = sqr(acc);
    if ((kX >> bit) & 1u) {
      acc = mul(acc, g);
    }
  }
  return conj(acc);
}

// f^(3 (p^12 - 1) / r): the easy part f^((p^6 - 1)(p^2 + 1)), then the
// 2020/875 hard part (x - 1)^2 (x + p)(x^2 + p^2 - 1) + 3.
BLS_CALL Fp12 final_exp(const Fp12& f_in) {
  Fp12 f = mul(conj(f_in), inv(f_in));
  f = mul(frob(f, 2), f);
  Fp12 t = mul(exp_by_x(f), conj(f));
  t = mul(exp_by_x(t), conj(t));
  t = mul(exp_by_x(t), frob(t, 1));
  const Fp12 t2 = exp_by_x(exp_by_x(t));
  t = mul(mul(t2, frob(t, 2)), conj(t));
  return mul(t, mul(sqr(f), f));
}

// -- words in and out -------------------------------------------------------

LANE_FN Fp load(const uint32_t* src) {
  Fp r;
  for (int i = 0; i < kWords; ++i) {
    r.w[i] = src[i];
  }
  return r;
}

LANE_FN void store(uint32_t* dst, const Fp& a) {
  for (int i = 0; i < kWords; ++i) {
    dst[i] = a.w[i];
  }
}

LANE_FN Fp2 load2(const uint32_t* src) { return Fp2{load(src), load(src + kWords)}; }

// An Fp12 as 12 field elements in the tower's order (part).
LANE_FN Fp12 load12(const uint32_t* src) {
  Fp12 r;
  for (int k = 0; k < 12; ++k) {
    part(r, k) = load(src + k * kWords);
  }
  return r;
}

LANE_FN void store12(uint32_t* dst, const Fp12& a) {
  for (int k = 0; k < 12; ++k) {
    store(dst + k * kWords, part(a, k));
  }
}

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
