// secp256k1 public-key recovery plus the address hash, one thread per lane.
//
// Replaces the JAX package's XLA programs go_ibft_tpu/ops/secp256k1.py::
// ecdsa_recover (with ecmul2_base, glv_split, to_affine, and
// ops/fields.py::pow_fixed2 / batch_inv) and, in its epilogue,
// go_ibft_tpu/ops/keccak.py::pubkey_to_address_words.  Same function at the
// outputs: for each lane (z, r, s, v)
//
//   ok = 0 < r < N, 0 < s < N (over the full 20-limb, 260-bit value),
//        v in {0, 1}, r is the x-coordinate of a curve point, Q != infinity;
//   R  = (r, y) with y = (r^3 + 7)^((P+1)/4) of parity v;
//   Q  = (-z * r^-1 mod N) * G + (s * r^-1 mod N) * R,   z taken mod N;
//   x, y = Q in affine coordinates, as canonical 13-bit limbs;
//   addr = keccak256(x || y big-endian)[12:32] as 5 stream words.
//
// Where ok is false, x, y and addr are unspecified, as in the JAX package.
//
// What bounds it on an H100: about 2.6e3 field products per lane, each a
// few hundred 32-bit integer instructions, against 260 B read and 225 B
// written per lane: operations, not bytes.  At the main path's 256..1024
// lanes only 8..32 blocks run on 132 SMs, so the time is the lane's
// dependency chain, and the design shortens that chain:
//
// * Two warps per block of 32 lanes: warp 0 runs each lane's R side (the
//   square root, the table of d R, k1 R and the end), warp 1 its G side
//   (r^-1, the GLV split of u2, u1 G and k2 phi(R)); they meet in shared
//   memory at three barriers.  Q = k1 R + (k2 phi(R) + u1 G).
// * Field elements mod P are 8 x 32-bit words in registers, canonical (< P)
//   after every operation.  Products and squares are summed by column in
//   64-bit halves (no carry flag, so the columns overlap; squares take the
//   28 cross products once); the fold through 2^256 = 2^32 + 977 (mod P)
//   and the word additions run as PTX carry chains (add.cc / mad.lo.cc /
//   madc.hi.cc).  The product and the square are calls on the card (their
//   code stays in the instruction cache; operands and result pass in
//   registers); everything else is inline.
// * Both inversions, r^-1 mod N and Z^-1 mod P, are Bernstein-Yang safegcd
//   (20 x 30 branch-free divsteps on signed 30-bit limbs, as libsecp256k1's
//   modinv32) instead of Fermat powers.  0 maps to 0, as the power did.
//   The square root is an addition chain of 253 squarings and 13 products.
// * u1 G is a fixed-base comb: the wrapper uploads d 2^(8w) G for w < 32,
//   d < 256 (affine, 512 KiB, resident in L2) once per card, and the lane
//   adds one entry per nonzero byte of u1: at most 32 mixed additions and
//   no doublings.
// * u2 is split by the GLV endomorphism phi(x, y) = (beta x, y) =
//   lambda (x, y) into signed halves k1, k2 of at most 129 bits, as in the
//   JAX package; each half runs a 33-window ladder (4 doublings and at most
//   one addition per window) over d R, d = 1..15 (Jacobian, in shared
//   memory, one column per lane, so reads indexed by a per-lane digit
//   neither serialise nor touch local memory), the G side's with X times
//   beta.
// * The two merges are complete additions (P == Q and P == -Q happen for
//   crafted inputs, and bench/lanes.py holds such lanes); one inversion
//   gives the affine point, whose coordinates are unique, so no cross-lane
//   batch inversion is needed.  The address hash runs keccak::permute
//   (keccak_f1600.cuh) on registers.
//
// The same file holds a second kernel on the same lane arithmetic, with two
// entry points: secp256k1_ecmul2 (k1 G + k2 Q) replaces the JAX package's
// XLA program go_ibft_tpu/ops/secp256k1.py::ecmul2_base, and
// secp256k1_verify replaces ::ecdsa_verify (the range checks, w = s^-1,
// u1 = z w, u2 = r w, u1 G + u2 Q, not infinity, x == r or x == r + N where
// r < P - N).  Same function at the outputs: the infinity flag and the
// affine point of k1 G + k2 Q (the kernel writes canonical X, Y, Z, equal
// to the plain version's as a projective point), or the mask.  It is
// bound the same way, by operations: about 3e3 field products a lane (two
// half ladders of 128 doublings, the comb, d Q) against 320 B in and 240 B
// out (verify: 400 B in, 1 B out, and two safegcd inversions more); its
// design keeps the recovery kernel's layout:
//
// * Two warps per block of 32 lanes.  Warp 0 builds d Q for d = 1..15 in
//   the shared table and runs b1 Q over it; warp 1 makes the scalars
//   (verify: s^-1 by safegcd, then u1, u2), splits k2 by GLV into (b1, b2),
//   hands b1 to warp 0, sums k1 G by the comb and runs b2 phi(Q) over the
//   same table with X times beta.  After both ladders warp 1 passes k1 G
//   and b2 phi(Q) through the table's first two entries (no further shared
//   memory: the static 48 KB would not hold a third point a lane).
// * Q is never checked to be on the curve, as in the JAX package.  An
//   off-curve Q lies on another curve y^2 = x^3 + b', where phi is not
//   multiplication by lambda and where a sum with a point of the true
//   curve is not associative.  So the split is the JAX package's exact
//   (b1, b2), and the merge is the plain version's order,
//   k1 G + (b1 Q + b2 phi(Q)), not the recovery's; on the curve any order
//   gives the same point.
//
// The lane arithmetic also compiles with a host C++ compiler (lane.cuh; the
// PTX has a portable C++ twin that runs the same algorithm, and the host
// runs a lane's two sides one after the other): the CPU tests build this
// file with g++ and hold secp256k1_recover_host against the host oracle,
// secp256k1_ecmul2_host and secp256k1_verify_host against the plain
// versions and the host oracle, and secp256k1_modinv_host against Python's
// pow(x, -1, m).

#include "keccak_f1600.cuh"
#include "lane.cuh"

#if defined(__CUDACC__)
#define LANE_MUL __device__ __noinline__
#else
#define LANE_MUL inline
#endif

namespace secp {

constexpr int kLimbs = 20;  // 13-bit limbs of the port's tensors
constexpr int kLimbBits = 13;
constexpr uint32_t kLimbMask = (1u << kLimbBits) - 1;
constexpr int kWindows = 33;       // 4-bit windows over the 132 bits of a half-scalar
constexpr int kCombWindows = 32;   // 8-bit comb windows over u1
constexpr int kCombWords = 16;     // words per comb entry: x, y
constexpr int kRWords = 24;        // words per d*R entry: X, Y, Z
constexpr int kRTable = 15;        // d = 1..15

struct U256 {
  uint32_t w[8];  // little-endian words
};

struct Jac {
  U256 x, y, z;  // z == 0: the point at infinity
};

LANE_TABLE uint32_t kP[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                             0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
LANE_TABLE uint32_t kN[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                             0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
// 2^256 mod N and 2^512 mod N; -N^-1 mod 2^32.
LANE_TABLE uint32_t kMontOneN[8] = {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u,
                                    0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u};
LANE_TABLE uint32_t kMontR2N[8] = {0x67D7D140u, 0x896CF214u, 0x0E7CF878u, 0x741496C2u,
                                   0x5BCD07C6u, 0xE697F5E4u, 0x81C69BC5u, 0x9D671CD5u};
constexpr uint32_t kN0Inv = 0x5588B13Fu;
// The moduli as signed 30-bit limbs (safegcd), and their inverses mod 2^30.
LANE_TABLE int32_t kP30[9] = {-0x3D1, -4, 0, 0, 0, 0, 0, 0, 65536};
constexpr uint32_t kP30Inv = 0x2DDACACFu;
LANE_TABLE int32_t kN30[9] = {0x10364141, 0x3F497A33, 0x348A03BB, 0x2BB739AB, -0x146,
                              0, 0, 0, 65536};
constexpr uint32_t kN30Inv = 0x2A774EC1u;
// beta: a cube root of unity mod P, phi(x, y) = (beta x, y).
LANE_TABLE uint32_t kBeta[8] = {0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u,
                                0xAC3434E9u, 0x6E64479Eu, 0x657C0710u, 0x7AE96A2Bu};
// GLV split (the JAX package's constants): g1 = round(b2 2^384 / N),
// g2 = round(-b1 2^384 / N); k1 = k - c1 a1 - c2 a2, k2 = c1 (-b1) - c2 b2.
LANE_TABLE uint32_t kGlvG1[8] = {0x45DBB031u, 0xE893209Au, 0x71E8CA7Fu, 0x3DAA8A14u,
                                 0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u};
LANE_TABLE uint32_t kGlvG2[8] = {0x8AC47F71u, 0x1571B4AEu, 0x9DF506C6u, 0x221208ACu,
                                 0x0ABFE4C4u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u};
LANE_TABLE uint32_t kGlvA1[8] = {0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u,
                                 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
LANE_TABLE uint32_t kGlvA2[8] = {0x9D44CFD8u, 0x57C1108Du, 0xA8E2F3F6u, 0x14CA50F7u,
                                 0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u};
LANE_TABLE uint32_t kGlvNegB1[8] = {0x0ABFE4C3u, 0x6F547FA9u, 0x010E8828u, 0xE4437ED6u,
                                    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
LANE_TABLE uint32_t kGlvB2[8] = {0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu, 0x3086D221u,
                                 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};

// ---------------------------------------------------------------------------
// 256-bit words
// ---------------------------------------------------------------------------

LANE_FN U256 from_table(const uint32_t* t) {
  U256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = t[i];
  }
  return r;
}

LANE_FN U256 small(uint32_t v) {
  U256 r;
  r.w[0] = v;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    r.w[i] = 0;
  }
  return r;
}

LANE_FN bool is_zero(const U256& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc |= a.w[i];
  }
  return acc == 0;
}

LANE_FN bool equal(const U256& a, const U256& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc |= a.w[i] ^ b.w[i];
  }
  return acc == 0;
}

// a >= t, t a table of 8 words.
LANE_FN bool geq(const U256& a, const uint32_t* t) {
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    if (a.w[i] != t[i]) {
      return a.w[i] > t[i];
    }
  }
  return true;
}

LANE_FN U256 select(bool c, const U256& a, const U256& b) {
  U256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = c ? a.w[i] : b.w[i];
  }
  return r;
}

// The PTX below is one instruction per asm statement, the carry flag
// running from one to the next: volatile keeps their order, and no PTX that
// the compiler emits touches the flag.  One instruction per statement also
// means every input is read before the output is written, so the register
// sharing that inline asm allows between an output and an input of the
// same value is harmless.
#if defined(__CUDA_ARCH__)
#define PTX_ACC(op, acc, b) asm volatile(op " %0, %0, %1;" : "+r"(acc) : "r"(b))
#define PTX_MAD(op, acc, x, b) asm volatile(op " %0, %1, %2, %0;" : "+r"(acc) : "r"(x), "r"(b))
#endif

// r[0..7] += b[0..7] + cin (cin 0 or 1); returns the carry out.
LANE_FN uint32_t add8(uint32_t* r, const uint32_t* b, uint32_t cin) {
#if defined(__CUDA_ARCH__)
  uint32_t flag, cout;
  asm volatile("add.cc.u32 %0, %1, 0xFFFFFFFF;" : "=r"(flag) : "r"(cin));  // carry := cin
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    PTX_ACC("addc.cc.u32", r[i], b[i]);
  }
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(cout));
  return cout;
#else
  uint64_t c = cin;
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(r[i]) + b[i];
    r[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
#endif
}

// r[0..7] -= b[0..7]; returns the borrow out (0 or 1).
LANE_FN uint32_t sub8(uint32_t* r, const uint32_t* b) {
#if defined(__CUDA_ARCH__)
  uint32_t borrow;
  PTX_ACC("sub.cc.u32", r[0], b[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    PTX_ACC("subc.cc.u32", r[i], b[i]);
  }
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
  return borrow & 1u;
#else
  uint64_t borrow = 0;
  for (int i = 0; i < 8; ++i) {
    const uint64_t d = static_cast<uint64_t>(r[i]) - b[i] - borrow;
    r[i] = static_cast<uint32_t>(d);
    borrow = d >> 63;
  }
  return static_cast<uint32_t>(borrow);
#endif
}

// acc[0..8] += x0 b + x1 b 2^64 + x2 b 2^128 + x3 b 2^192: the products of
// every other word of a multiplicand, whose low and high halves tile
// acc[0..7] exactly; the carry goes into acc[8].  One carry chain.
LANE_FN void mac_alternate(uint32_t* acc, uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                           uint32_t b) {
#if defined(__CUDA_ARCH__)
  PTX_MAD("mad.lo.cc.u32", acc[0], x0, b);
  PTX_MAD("madc.hi.cc.u32", acc[1], x0, b);
  PTX_MAD("madc.lo.cc.u32", acc[2], x1, b);
  PTX_MAD("madc.hi.cc.u32", acc[3], x1, b);
  PTX_MAD("madc.lo.cc.u32", acc[4], x2, b);
  PTX_MAD("madc.hi.cc.u32", acc[5], x2, b);
  PTX_MAD("madc.lo.cc.u32", acc[6], x3, b);
  PTX_MAD("madc.hi.cc.u32", acc[7], x3, b);
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(acc[8]));
#else
  const uint32_t x[4] = {x0, x1, x2, x3};
  uint64_t c = 0;
  for (int k = 0; k < 4; ++k) {
    const uint64_t p = static_cast<uint64_t>(x[k]) * b;
    c += static_cast<uint64_t>(acc[2 * k]) + static_cast<uint32_t>(p);
    acc[2 * k] = static_cast<uint32_t>(c);
    c >>= 32;
    c += static_cast<uint64_t>(acc[2 * k + 1]) + static_cast<uint32_t>(p >> 32);
    acc[2 * k + 1] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  acc[8] += static_cast<uint32_t>(c);
#endif
}

// The 512-bit product a * b into t[0..15] (t[16] is 0): the 64 partial
// products summed by column, their low and high halves into 64-bit column
// sums (each below 2^36), then one carry pass.  No carry flag: the 16
// column sums are independent, so the compiler overlaps them, which beat
// PTX carry-chain rows on the H100 (PERF.md).
LANE_FN void mul_wide(uint32_t t[17], const U256& a, const U256& b) {
  uint64_t col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    col[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t p = static_cast<uint64_t>(a.w[i]) * b.w[j];
      col[i + j] += static_cast<uint32_t>(p);
      col[i + j + 1] += p >> 32;
    }
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    c += col[k];
    t[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  t[16] = static_cast<uint32_t>(c);
}

// a^2 the same way: the 28 products a_i a_j (i < j) once, the column sums
// doubled, then the 8 squares.
LANE_FN void sqr_wide(uint32_t t[17], const U256& a) {
  uint64_t col[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    col[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      const uint64_t p = static_cast<uint64_t>(a.w[i]) * a.w[j];
      col[i + j] += static_cast<uint32_t>(p);
      col[i + j + 1] += p >> 32;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t p = static_cast<uint64_t>(a.w[i]) * a.w[i];
    col[2 * i] = (col[2 * i] << 1) + static_cast<uint32_t>(p);
    col[2 * i + 1] = (col[2 * i + 1] << 1) + (p >> 32);
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    c += col[k];
    t[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  t[16] = static_cast<uint32_t>(c);
}

// ---------------------------------------------------------------------------
// The field mod P; every value canonical, in [0, P)
// ---------------------------------------------------------------------------

// t mod P for a 512-bit t = H 2^256 + L, folding H by 2^256 = 2^32 + 977:
// L + 977 H + 2^32 H < 2^290, then its top words once more, then at most
// one wrap and one subtraction of P.
LANE_FN U256 fp_reduce(const uint32_t t[16]) {
  uint32_t acc[10];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = t[i];
  }
  acc[8] = 0;
  acc[9] = 0;
  mac_alternate(&acc[0], t[8], t[10], t[12], t[14], 977u);
  mac_alternate(&acc[1], t[9], t[11], t[13], t[15], 977u);
  acc[9] += add8(&acc[1], &t[8], 0);
  // + top (2^32 + 977), top = acc[8] + 2^32 acc[9] < 2^34.
  const uint64_t top = acc[8] | (static_cast<uint64_t>(acc[9]) << 32);
  const uint64_t lo = top * 977u;
  const uint64_t mid = (lo >> 32) + static_cast<uint32_t>(top);
  uint32_t f[8] = {static_cast<uint32_t>(lo), static_cast<uint32_t>(mid),
                   static_cast<uint32_t>(top >> 32) + static_cast<uint32_t>(mid >> 32),
                   0, 0, 0, 0, 0};
  U256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = acc[i];
  }
  const uint32_t m = 0u - add8(r.w, f, 0);  // wrapped past 2^256: r is small now
  uint32_t g[8] = {977u & m, 1u & m, 0, 0, 0, 0, 0, 0};
  add8(r.w, g, 0);
  U256 d = r;
  const uint32_t borrow = sub8(d.w, kP);
  return select(borrow != 0, r, d);
}

LANE_MUL U256 fp_mul(U256 a, U256 b) {
  uint32_t t[17];
  mul_wide(t, a, b);
  return fp_reduce(t);
}

LANE_MUL U256 fp_sqr(U256 a) {
  uint32_t t[17];
  sqr_wide(t, a);
  return fp_reduce(t);
}

LANE_FN U256 fp_add(U256 a, const U256& b) {
  const uint32_t carry = add8(a.w, b.w, 0);
  U256 d = a;
  const uint32_t borrow = sub8(d.w, kP);
  return select((carry | (borrow ^ 1u)) != 0, d, a);
}

LANE_FN U256 fp_sub(U256 a, const U256& b) {
  const uint32_t m = 0u - sub8(a.w, b.w);
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[i] = kP[i] & m;
  }
  add8(a.w, p, 0);
  return a;
}

LANE_FN U256 fp_neg(const U256& a) { return fp_sub(small(0), a); }

LANE_FN U256 fp_sqr_n(U256 a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    a = fp_sqr(a);
  }
  return a;
}

// a^((P+1)/4): the square root of a where one exists.  libsecp256k1's
// addition chain: x_k = a^(2^k - 1).
LANE_FN U256 fp_sqrt(const U256& a) {
  const U256 x2 = fp_mul(fp_sqr(a), a);
  const U256 x3 = fp_mul(fp_sqr(x2), a);
  const U256 x6 = fp_mul(fp_sqr_n(x3, 3), x3);
  const U256 x9 = fp_mul(fp_sqr_n(x6, 3), x3);
  const U256 x11 = fp_mul(fp_sqr_n(x9, 2), x2);
  const U256 x22 = fp_mul(fp_sqr_n(x11, 11), x11);
  const U256 x44 = fp_mul(fp_sqr_n(x22, 22), x22);
  const U256 x88 = fp_mul(fp_sqr_n(x44, 44), x44);
  const U256 x176 = fp_mul(fp_sqr_n(x88, 88), x88);
  const U256 x220 = fp_mul(fp_sqr_n(x176, 44), x44);
  const U256 x223 = fp_mul(fp_sqr_n(x220, 3), x3);
  U256 t = fp_mul(fp_sqr_n(x223, 23), x22);
  t = fp_mul(fp_sqr_n(t, 6), x2);
  return fp_sqr_n(t, 2);
}

// ---------------------------------------------------------------------------
// Inversion: Bernstein-Yang safegcd with 30-bit signed limbs
// ---------------------------------------------------------------------------

struct S30 {
  int32_t v[9];  // value = sum v[i] 2^(30 i)
};

constexpr int32_t kM30 = 0x3FFFFFFF;

LANE_FN S30 to_s30(const U256& a) {
  S30 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bit = 30 * i;
    const int word = bit >> 5;
    const int sh = bit & 31;
    uint32_t v = a.w[word] >> sh;
    if (sh > 2 && word + 1 < 8) {
      v |= a.w[word + 1] << (32 - sh);
    }
    r.v[i] = static_cast<int32_t>(v & kM30);
  }
  return r;
}

// Limbs in [0, 2^30), value below 2^256.
LANE_FN U256 from_s30(const S30& a) {
  U256 r = small(0);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bit = 30 * i;
    const int word = bit >> 5;
    const int sh = bit & 31;
    const uint32_t v = static_cast<uint32_t>(a.v[i]);
    r.w[word] |= v << sh;
    if (sh > 2 && word + 1 < 8) {
      r.w[word + 1] |= v >> (32 - sh);
    }
  }
  return r;
}

// 30 divsteps on the low bits of f (odd) and g, branch-free; returns the
// new zeta = -(delta + 1/2) and the transition matrix t = (u, v, q, r),
// scaled by 2^30.
LANE_FN int32_t divsteps_30(int32_t zeta, uint32_t f, uint32_t g, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll 5
  for (int i = 0; i < 30; ++i) {
    uint32_t c1 = static_cast<uint32_t>(zeta >> 31);  // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);                // g odd
    const uint32_t x = (f ^ c1) - c1;
    const uint32_t y = (u ^ c1) - c1;
    const uint32_t z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;
    zeta = (zeta ^ static_cast<int32_t>(c1)) - 1;
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
  return zeta;
}

// (d, e) = t (d, e) / 2^30 mod M, keeping both in (-2M, M).
LANE_FN void update_de_30(S30& d, S30& e, const int32_t t[4], const int32_t* mod, uint32_t inv) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = static_cast<int64_t>(u) * d.v[0] + static_cast<int64_t>(v) * e.v[0];
  int64_t ce = static_cast<int64_t>(q) * d.v[0] + static_cast<int64_t>(r) * e.v[0];
  md -= static_cast<int32_t>((inv * static_cast<uint32_t>(cd) + static_cast<uint32_t>(md)) &
                             kM30);
  me -= static_cast<int32_t>((inv * static_cast<uint32_t>(ce) + static_cast<uint32_t>(me)) &
                             kM30);
  cd += static_cast<int64_t>(mod[0]) * md;
  ce += static_cast<int64_t>(mod[0]) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += static_cast<int64_t>(u) * d.v[i] + static_cast<int64_t>(v) * e.v[i];
    ce += static_cast<int64_t>(q) * d.v[i] + static_cast<int64_t>(r) * e.v[i];
    cd += static_cast<int64_t>(mod[i]) * md;
    ce += static_cast<int64_t>(mod[i]) * me;
    d.v[i - 1] = static_cast<int32_t>(cd) & kM30;
    cd >>= 30;
    e.v[i - 1] = static_cast<int32_t>(ce) & kM30;
    ce >>= 30;
  }
  d.v[8] = static_cast<int32_t>(cd);
  e.v[8] = static_cast<int32_t>(ce);
}

// (f, g) = t (f, g) / 2^30, exactly.
LANE_FN void update_fg_30(S30& f, S30& g, const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = static_cast<int64_t>(u) * f.v[0] + static_cast<int64_t>(v) * g.v[0];
  int64_t cg = static_cast<int64_t>(q) * f.v[0] + static_cast<int64_t>(r) * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += static_cast<int64_t>(u) * f.v[i] + static_cast<int64_t>(v) * g.v[i];
    cg += static_cast<int64_t>(q) * f.v[i] + static_cast<int64_t>(r) * g.v[i];
    f.v[i - 1] = static_cast<int32_t>(cf) & kM30;
    cf >>= 30;
    g.v[i - 1] = static_cast<int32_t>(cg) & kM30;
    cg >>= 30;
  }
  f.v[8] = static_cast<int32_t>(cf);
  g.v[8] = static_cast<int32_t>(cg);
}

LANE_FN void carry_30(S30& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= kM30;
  }
}

// r in (-2M, M) to [0, M), negated first where sign < 0.
LANE_FN void normalize_30(S30& r, int32_t sign, const int32_t* mod) {
  int32_t add = r.v[8] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    r.v[i] += mod[i] & add;
    r.v[i] = (r.v[i] ^ neg) - neg;
  }
  carry_30(r);
  add = r.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    r.v[i] += mod[i] & add;
  }
  carry_30(r);
}

// x^-1 mod M for 0 <= x < M (0 maps to 0): 20 x 30 = 600 divsteps, enough
// for 256-bit inputs.
LANE_FN U256 modinv(const U256& x, const int32_t* mod, uint32_t inv) {
  S30 d, e, f, g = to_s30(x);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    d.v[i] = 0;
    e.v[i] = 0;
    f.v[i] = mod[i];
  }
  e.v[0] = 1;
  int32_t zeta = -1;
#pragma unroll 1
  for (int i = 0; i < 20; ++i) {
    int32_t t[4];
    zeta = divsteps_30(zeta, static_cast<uint32_t>(f.v[0]), static_cast<uint32_t>(g.v[0]), t);
    update_de_30(d, e, t, mod, inv);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f.v[8], mod);
  return from_s30(d);
}

// ---------------------------------------------------------------------------
// Scalars mod N: Montgomery multiplication with R = 2^256 (three per lane)
// ---------------------------------------------------------------------------

// a b R^-1 mod N for a, b < N (CIOS).
LANE_FN U256 mont_mul(const U256& a, const U256& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    t[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // unrolled: b.w[i] stays in registers
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[8];
    t[8] = static_cast<uint32_t>(c);
    t[9] = static_cast<uint32_t>(c >> 32);
    const uint32_t m = t[0] * kN0Inv;
    c = (static_cast<uint64_t>(m) * kN[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += static_cast<uint64_t>(m) * kN[j] + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[8];
    t[7] = static_cast<uint32_t>(c);
    t[8] = t[9] + static_cast<uint32_t>(c >> 32);
  }
  U256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = t[i];
  }
  U256 d = r;
  sub8(d.w, kN);
  return select(t[8] != 0 || geq(r, kN), d, r);
}

// ---------------------------------------------------------------------------
// The GLV split
// ---------------------------------------------------------------------------

// round(k g / 2^384), a 128-bit value.
LANE_FN U256 mul_shift_384(const U256& k, const uint32_t* g) {
  uint32_t t[17];
  mul_wide(t, k, from_table(g));
  U256 c = small(0);
  uint64_t carry = static_cast<uint64_t>(t[11]) + 0x80000000u;  // + 2^383
#pragma unroll
  for (int i = 12; i < 16; ++i) {
    carry = (carry >> 32) + t[i];
    c.w[i - 12] = static_cast<uint32_t>(carry);
  }
  return c;
}

// a b mod 2^256.
LANE_FN U256 mul_low(const U256& a, const uint32_t* b) {
  uint32_t t[17];
  mul_wide(t, a, from_table(b));
  U256 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = t[i];
  }
  return r;
}

// |v| for a two's-complement v mod 2^256; returns true where v < 0.
LANE_FN bool abs_signed(U256& v) {
  const bool neg = (v.w[7] >> 31) != 0;
  U256 m = small(0);
  sub8(m.w, v.w);
  v = select(neg, m, v);
  return neg;
}

// k == s1 |k1| + s2 |k2| lambda (mod N) with |k1|, |k2| < 2^129.
LANE_FN void glv_split(const U256& k, U256& k1, bool& neg1, U256& k2, bool& neg2) {
  const U256 c1 = mul_shift_384(k, kGlvG1);
  const U256 c2 = mul_shift_384(k, kGlvG2);
  k1 = k;
  sub8(k1.w, mul_low(c1, kGlvA1).w);
  sub8(k1.w, mul_low(c2, kGlvA2).w);
  k2 = mul_low(c1, kGlvNegB1);
  sub8(k2.w, mul_low(c2, kGlvB2).w);
  neg1 = abs_signed(k1);
  neg2 = abs_signed(k2);
}

// ---------------------------------------------------------------------------
// Jacobian points, y^2 = x^3 + 7
// ---------------------------------------------------------------------------

LANE_FN Jac infinity() { return Jac{small(1), small(1), small(0)}; }

// 2p ("dbl-2009-l", a = 0); infinity stays infinity (Z3 = 2 Y Z).
LANE_FN Jac point_double(const Jac& p) {
  const U256 a = fp_sqr(p.x);
  const U256 b = fp_sqr(p.y);
  const U256 c = fp_sqr(b);
  U256 t = fp_sqr(fp_add(p.x, b));
  t = fp_sub(fp_sub(t, a), c);
  const U256 d = fp_add(t, t);                // D = 2((X + B)^2 - A - C)
  const U256 e = fp_add(fp_add(a, a), a);     // E = 3A
  const U256 f = fp_sqr(e);
  Jac r;
  r.z = fp_mul(p.y, p.z);
  r.z = fp_add(r.z, r.z);                     // Z3 = 2 Y Z
  r.x = fp_sub(f, fp_add(d, d));              // X3 = F - 2D
  U256 c8 = fp_add(c, c);
  c8 = fp_add(c8, c8);
  c8 = fp_add(c8, c8);
  r.y = fp_sub(fp_mul(e, fp_sub(d, r.x)), c8);  // Y3 = E (D - X3) - 8C
  return r;
}

// The tail shared by both additions: given H = U2 - U1 != 0, R = S2 - S1,
// U1, S1 and Z3 / H, finish X3, Y3, Z3.
LANE_FN Jac add_tail(const U256& h, const U256& rr, const U256& u1, const U256& s1,
                     const U256& zh) {
  const U256 hh = fp_sqr(h);
  const U256 hhh = fp_mul(hh, h);
  const U256 v = fp_mul(u1, hh);
  Jac p;
  p.x = fp_sub(fp_sub(fp_sub(fp_sqr(rr), hhh), v), v);  // X3 = R^2 - H^3 - 2 U1 H^2
  p.y = fp_sub(fp_mul(rr, fp_sub(v, p.x)), fp_mul(s1, hhh));  // Y3 = R (U1 H^2 - X3) - S1 H^3
  p.z = fp_mul(zh, h);
  return p;
}

// p + (qx, qy), an affine point.  Complete: infinity, P == Q, P == -Q.
LANE_FN Jac add_affine(const Jac& p, const U256& qx, const U256& qy) {
  if (is_zero(p.z)) {
    return Jac{qx, qy, small(1)};
  }
  const U256 z1z1 = fp_sqr(p.z);
  const U256 h = fp_sub(fp_mul(qx, z1z1), p.x);
  const U256 rr = fp_sub(fp_mul(fp_mul(qy, p.z), z1z1), p.y);
  if (is_zero(h)) {
    return is_zero(rr) ? point_double(p) : infinity();
  }
  return add_tail(h, rr, p.x, p.y, p.z);
}

// p + q, both Jacobian.  Complete: infinity, P == Q, P == -Q.
LANE_FN Jac point_add(const Jac& p, const Jac& q) {
  if (is_zero(q.z)) {
    return p;
  }
  if (is_zero(p.z)) {
    return q;
  }
  const U256 z1z1 = fp_sqr(p.z);
  const U256 z2z2 = fp_sqr(q.z);
  const U256 u1 = fp_mul(p.x, z2z2);
  const U256 s1 = fp_mul(fp_mul(p.y, q.z), z2z2);
  const U256 h = fp_sub(fp_mul(q.x, z1z1), u1);
  const U256 rr = fp_sub(fp_mul(fp_mul(q.y, p.z), z1z1), s1);
  if (is_zero(h)) {
    return is_zero(rr) ? point_double(p) : infinity();
  }
  return add_tail(h, rr, u1, s1, fp_mul(p.z, q.z));
}

// ---------------------------------------------------------------------------
// u1 G by the comb; u2 R by the GLV ladder
// ---------------------------------------------------------------------------

// Entry (w, d) of the comb table: d 2^(8w) G as x, y words (row d = 0 unused).
LANE_FN void load_comb(U256& x, U256& y, const uint32_t* gtab, int w, uint32_t d) {
  const uint32_t* row = gtab + (static_cast<long long>(w) * 256 + d) * kCombWords;
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(row);
  const uint4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), e = __ldg(q + 3);
  x = U256{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  y = U256{{c.x, c.y, c.z, c.w, e.x, e.y, e.z, e.w}};
#else
  for (int i = 0; i < 8; ++i) {
    x.w[i] = row[i];
    y.w[i] = row[8 + i];
  }
#endif
}

// k G as the sum of the table entries of k's bytes, least significant first;
// the next entry's load is issued before the current addition.  The partial
// sum is (k mod 2^(8w)) G, never +-(d 2^(8w)) G, so after the first entry
// the additions meet no exceptional case.
LANE_FN Jac comb_mul(U256 k, const uint32_t* gtab) {
  Jac acc = infinity();
  uint32_t d = k.w[0] & 255u;
  U256 nx, ny;
  load_comb(nx, ny, gtab, 0, d);
#pragma unroll 1
  for (int w = 0; w < kCombWindows; ++w) {
    const U256 x = nx, y = ny;
    const uint32_t dw = d;
#pragma unroll
    for (int i = 0; i < 7; ++i) {  // k >>= 8
      k.w[i] = (k.w[i] >> 8) | (k.w[i + 1] << 24);
    }
    k.w[7] >>= 8;
    if (w + 1 < kCombWindows) {
      d = k.w[0] & 255u;
      load_comb(nx, ny, gtab, w + 1, d);
    }
    if (dw) {
      acc = add_affine(acc, x, y);
    }
  }
  return acc;
}

// d R for d = 1..15 (Jacobian) in a per-lane column: on the card, shared
// memory with one column per thread of the block; on the host, an array.
struct RTable {
  uint32_t* base;
  int stride;

  LANE_FN void put(int d, const Jac& p) const {
    uint32_t* at = base + (d - 1) * kRWords * stride;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      at[i * stride] = p.x.w[i];
      at[(8 + i) * stride] = p.y.w[i];
      at[(16 + i) * stride] = p.z.w[i];
    }
  }

  LANE_FN Jac get(uint32_t d) const {
    const uint32_t* at = base + (static_cast<int>(d) - 1) * kRWords * stride;
    Jac p;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p.x.w[i] = at[i * stride];
      p.y.w[i] = at[(8 + i) * stride];
      p.z.w[i] = at[(16 + i) * stride];
    }
    return p;
  }
};

// The top 4-bit window of a half-scalar below 2^132 (bits 128..131), then
// k <<= 4 over its five low words.
LANE_FN uint32_t pop_nibble(U256& k) {
  const uint32_t d = k.w[4] & 15u;
#pragma unroll
  for (int i = 4; i > 0; --i) {
    k.w[i] = (k.w[i] << 4) | (k.w[i - 1] >> 28);
  }
  k.w[0] <<= 4;
  return d;
}

// d R for d = 1..15 into the table, R = (rx, ry) on the curve.
LANE_FN void build_r_table(const U256& rx, const U256& ry, const RTable& tab) {
  Jac p{rx, ry, small(1)};
  tab.put(1, p);
  p = point_double(p);
  tab.put(2, p);
#pragma unroll 1
  for (int d = 3; d <= kRTable; ++d) {
    p = add_affine(p, rx, ry);
    tab.put(d, p);
  }
}

// +-k R (neg: -) or +-k phi(R) (phi: the table's X times beta) for a GLV
// half k < 2^132: a 33-window ladder, 4 doublings and at most one addition
// per window.  The partial sums are small multiples of R, never +-d R or
// +-d lambda R, so only the first addition (to infinity) is exceptional.
LANE_FN Jac half_mul(U256 k, bool neg, bool phi, const RTable& tab) {
  const U256 beta = from_table(kBeta);
  Jac acc = infinity();
#pragma unroll 1
  for (int win = kWindows - 1; win >= 0; --win) {
    if (win != kWindows - 1) {
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        acc = point_double(acc);
      }
    }
    const uint32_t d = pop_nibble(k);
    if (d) {
      Jac q = tab.get(d);
      if (phi) {
        q.x = fp_mul(q.x, beta);
      }
      if (neg) {
        q.y = fp_neg(q.y);
      }
      acc = point_add(acc, q);
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Limbs, words and the lane
// ---------------------------------------------------------------------------

// The exact carry of 20 int32 limbs (int32 wrap-around and arithmetic shifts,
// as go_ibft_tpu_torch/ops/fields.py::exact_carry), the carry out of limb 19
// dropped: 20 canonical 13-bit limbs of the value mod 2^260.
LANE_FN void exact_carry(uint32_t c[kLimbs], const int32_t* limbs) {
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int32_t t = static_cast<int32_t>(static_cast<uint32_t>(limbs[i]) +
                                           static_cast<uint32_t>(carry));
    carry = t >> kLimbBits;
    c[i] = static_cast<uint32_t>(t) & kLimbMask;
  }
}

// Canonical limbs -> the low 256 bits as words; returns bits 256..259.
LANE_FN uint32_t limbs_to_words(U256& r, const uint32_t c[kLimbs]) {
  r = small(0);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int bit = kLimbBits * i;
    const int word = bit >> 5;
    const int sh = bit & 31;
    r.w[word] |= c[i] << sh;
    if (sh + kLimbBits > 32 && word + 1 < 8) {
      r.w[word + 1] |= c[i] >> (32 - sh);
    }
  }
  return c[kLimbs - 1] >> (256 - kLimbBits * (kLimbs - 1));
}

LANE_FN void words_to_limbs(int32_t* out, const U256& a) {
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const int bit = kLimbBits * k;
    const int word = bit >> 5;
    const int sh = bit & 31;
    uint32_t v = a.w[word] >> sh;
    if (sh + kLimbBits > 32 && word + 1 < 8) {
      v |= a.w[word + 1] << (32 - sh);
    }
    out[k] = static_cast<int32_t>(v & kLimbMask);
  }
}

// 0 < value < N for 20 limbs, the value taken as fields.exact_carry does;
// the low 256 bits go to r.
LANE_FN bool scalar_in_range(U256& r, const int32_t* limbs) {
  uint32_t c[kLimbs];
  exact_carry(c, limbs);
  const uint32_t hi = limbs_to_words(r, c);
  return hi == 0 && !is_zero(r) && !geq(r, kN);
}

// z mod N from 8 little-endian value words, or from 20 limbs (< 2^260).
LANE_FN U256 scalar_mod_n(const int32_t* in, bool as_limbs) {
  U256 z;
  uint32_t top = 0;
  if (as_limbs) {
    uint32_t c[kLimbs];
    exact_carry(c, in);
    const uint32_t hi = limbs_to_words(z, c);
    // + hi * (2^256 mod N): hi < 16 and 2^256 mod N < 2^129.
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      carry += static_cast<uint64_t>(z.w[i]) + static_cast<uint64_t>(hi) * kMontOneN[i];
      z.w[i] = static_cast<uint32_t>(carry);
      carry >>= 32;
    }
    top = static_cast<uint32_t>(carry);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      z.w[i] = static_cast<uint32_t>(in[i]);
    }
  }
  // The value is below 2^256 + 2^133 < 2N, so one subtraction reduces it.
  U256 d = z;
  sub8(d.w, kN);
  return select(top != 0 || geq(z, kN), d, z);
}

LANE_FN uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// keccak256(x || y), both 32 bytes big-endian; digest bytes 12..31 as 5
// little-endian stream words.
LANE_FN void address_words(int32_t* out, const U256& x, const U256& y) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    a[i] = 0;
  }
  // Stream lane t holds value words 7-2t (low half) and 6-2t, byte-swapped.
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t] = (static_cast<uint64_t>(bswap32(x.w[6 - 2 * t])) << 32) | bswap32(x.w[7 - 2 * t]);
    a[4 + t] = (static_cast<uint64_t>(bswap32(y.w[6 - 2 * t])) << 32) | bswap32(y.w[7 - 2 * t]);
  }
  a[8] = 0x01;                    // padding: byte 64
  a[16] = 0x8000000000000000ULL;  // padding: byte 135
  keccak::permute(a);
  out[0] = static_cast<int32_t>(static_cast<uint32_t>(a[1] >> 32));
  out[1] = static_cast<int32_t>(static_cast<uint32_t>(a[2]));
  out[2] = static_cast<int32_t>(static_cast<uint32_t>(a[2] >> 32));
  out[3] = static_cast<int32_t>(static_cast<uint32_t>(a[3]));
  out[4] = static_cast<int32_t>(static_cast<uint32_t>(a[3] >> 32));
}

// A lane's parsed inputs; ok: 0 < r < N, 0 < s < N, v in {0, 1}.
struct LaneIn {
  U256 r, s, z;
  bool ok;
};

LANE_FN LaneIn read_lane(const int32_t* z_in, bool z_limbs, const int32_t* r_limbs,
                         const int32_t* s_limbs, int32_t v) {
  LaneIn in;
  in.ok = scalar_in_range(in.r, r_limbs);
  in.ok = scalar_in_range(in.s, s_limbs) && in.ok;
  in.ok = in.ok && (v == 0 || v == 1);
  in.z = scalar_mod_n(z_in, z_limbs);
  return in;
}

// The R side's first phase: R = (r, y), y^2 = r^3 + 7 with the parity of v
// (returns false where r is no x-coordinate), and its table of d R.
LANE_FN bool r_side(const LaneIn& in, int32_t v, const RTable& tab) {
  const U256 y2 = fp_add(fp_mul(fp_sqr(in.r), in.r), small(7));
  U256 y = fp_sqrt(y2);
  const bool on_curve = equal(fp_sqr(y), y2);
  if ((y.w[0] & 1u) != static_cast<uint32_t>(v)) {
    y = fp_neg(y);
  }
  build_r_table(in.r, y, tab);
  return on_curve;
}

// The G side's first phase: u1 = -z r^-1 and u2 = s r^-1 (mod N), u2's
// GLV halves, and u1 G by the comb.  r^-1 R is in Montgomery form, so a
// Montgomery product with a plain value gives a plain value.
LANE_FN Jac g_side(const LaneIn& in, const uint32_t* gtab, U256& k1, bool& n1, U256& k2,
                   bool& n2) {
  const U256 rinv = mont_mul(modinv(in.r, kN30, kN30Inv), from_table(kMontR2N));
  U256 negz = from_table(kN);
  sub8(negz.w, in.z.w);
  negz = select(is_zero(in.z), in.z, negz);
  glv_split(mont_mul(in.s, rinv), k1, n1, k2, n2);
  return comb_mul(mont_mul(negz, rinv), gtab);
}

// Q in affine coordinates: x, y (20 limbs each) and the address (5 words);
// returns false where Q is infinity.
LANE_FN bool finish(const Jac& q, int32_t* x_out, int32_t* y_out, int32_t* addr_out) {
  const U256 zinv = modinv(q.z, kP30, kP30Inv);
  const U256 zi2 = fp_sqr(zinv);
  const U256 qx = fp_mul(q.x, zi2);
  const U256 qy = fp_mul(q.y, fp_mul(zi2, zinv));
  words_to_limbs(x_out, qx);
  words_to_limbs(y_out, qy);
  address_words(addr_out, qx, qy);
  return !is_zero(q.z);
}

// One lane, its two sides one after the other (the card runs them on two
// warps): Q = k1 R + (k2 phi(R) + u1 G).  Returns ok.
LANE_FN bool recover_lane(const int32_t* z_in, bool z_limbs, const int32_t* r_limbs,
                          const int32_t* s_limbs, int32_t v, const uint32_t* gtab,
                          const RTable& tab, int32_t* x_out, int32_t* y_out, int32_t* addr_out) {
  const LaneIn in = read_lane(z_in, z_limbs, r_limbs, s_limbs, v);
  const bool on_curve = r_side(in, v, tab);
  U256 k1, k2;
  bool n1, n2;
  const Jac g = g_side(in, gtab, k1, n1, k2, n2);
  const Jac b = point_add(half_mul(k2, n2, true, tab), g);
  const Jac q = point_add(half_mul(k1, n1, false, tab), b);
  return finish(q, x_out, y_out, addr_out) && in.ok && on_curve;
}

// ---------------------------------------------------------------------------
// k1 G + k2 Q, and the verification built on it
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

// The verification's scalars: u1 = z s^-1 and u2 = r s^-1 (mod N), with z,
// r and s taken mod N.  A lane with r or s out of range fails whatever
// they are.
LANE_FN void verify_scalars(const int32_t* z_limbs, const int32_t* r_limbs, const int32_t* s_limbs,
                            U256& u1, U256& u2) {
  const U256 s = scalar_mod_n(s_limbs, true);
  const U256 winv = mont_mul(modinv(s, kN30, kN30Inv), from_table(kMontR2N));  // s^-1 R
  u1 = mont_mul(scalar_mod_n(z_limbs, true), winv);
  u2 = mont_mul(scalar_mod_n(r_limbs, true), winv);
}

// A lane's two scalars mod N: (k1, k2) as given, or the verification's
// (u1, u2) from (z, r, s).
LANE_FN void ecmul2_scalars(bool verify, const int32_t* a, const int32_t* b, const int32_t* s,
                            U256& k1, U256& k2) {
  if (verify) {
    verify_scalars(a, b, s, k1, k2);
  } else {
    k1 = scalar_mod_n(a, true);
    k2 = scalar_mod_n(b, true);
  }
}

// The scalar side before the ladders: k2's GLV halves (b1 for the Q
// ladder, b2 for the phi(Q) one; the JAX package's split, which an
// off-curve Q makes part of the function) and k1 G by the comb.
LANE_FN Jac ecmul2_g_side(const U256& k1, const U256& k2, const uint32_t* gtab, U256& b1, bool& n1,
                          U256& b2, bool& n2) {
  glv_split(k2, b1, n1, b2, n2);
  return comb_mul(k1, gtab);
}

// k1 G + (b1 Q + b2 phi(Q)), the plain version's order.  Q is never
// checked to be on the curve: an off-curve Q lies on y^2 = x^3 + b', which
// the doubling and addition formulas never read, so each part is exact on
// its own curve, but a sum of points of two curves is not associative and
// this order is part of the result.
LANE_FN Jac ecmul2_merge(const Jac& g, const Jac& bq, const Jac& bphi) {
  return point_add(g, point_add(bq, bphi));
}

// The verification's end: 0 < r < N, 0 < s < N, Q != infinity, and
// x(Q) == r, or x(Q) == r + N where r < P - N.
LANE_FN bool verify_result(const int32_t* r_limbs, const int32_t* s_limbs, const Jac& q) {
  U256 r, s;
  const bool in_range = scalar_in_range(r, r_limbs) && scalar_in_range(s, s_limbs);
  if (!in_range || is_zero(q.z)) {
    return false;
  }
  const U256 zinv = modinv(q.z, kP30, kP30Inv);
  const U256 x = fp_mul(q.x, fp_sqr(zinv));
  U256 p_minus_n = from_table(kP);
  sub8(p_minus_n.w, kN);
  U256 r_plus_n = r;
  add8(r_plus_n.w, kN, 0);  // below P where it is compared
  return equal(x, r) || (!geq(r, p_minus_n.w) && equal(x, r_plus_n));
}

// X, Y, Z as canonical limbs; infinity as (1, 1, 0).
LANE_FN void write_point(int32_t* x_out, int32_t* y_out, int32_t* z_out, const Jac& q) {
  const Jac p = is_zero(q.z) ? infinity() : q;
  words_to_limbs(x_out, p.x);
  words_to_limbs(y_out, p.y);
  words_to_limbs(z_out, p.z);
}

// One lane, its two warps' parts one after the other (the card runs them
// on two warps): the scalars, k1 G and the split; the table of d Q; the
// two half ladders; the merge.
LANE_FN Jac ecmul2_lane(bool verify, const int32_t* a, const int32_t* b, const int32_t* s,
                        const int32_t* qx, const int32_t* qy, const uint32_t* gtab,
                        const RTable& tab) {
  U256 k1, k2, b1, b2;
  bool n1, n2;
  ecmul2_scalars(verify, a, b, s, k1, k2);
  const Jac g = ecmul2_g_side(k1, k2, gtab, b1, n1, b2, n2);
  build_r_table(field_from_limbs(qx), field_from_limbs(qy), tab);
  const Jac bq = half_mul(b1, n1, false, tab);
  const Jac bphi = half_mul(b2, n2, true, tab);
  return ecmul2_merge(g, bq, bphi);
}

}  // namespace secp

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lanes per block; each lane has a thread in each of two warps

// Warp 0 runs each lane's R side (square root, table, k1 R, the end), warp 1
// its G side (r^-1, the GLV split, the comb, k2 phi(R) + u1 G); they meet
// in shared memory at three barriers.
__global__ void __launch_bounds__(2 * kLanes)
secp256k1_recover_kernel(const int32_t* __restrict__ z, int z_width, const int32_t* __restrict__ r,
                         const int32_t* __restrict__ s, const int32_t* __restrict__ v,
                         const uint32_t* __restrict__ gtab, int32_t* __restrict__ x_out,
                         int32_t* __restrict__ y_out, int32_t* __restrict__ addr_out,
                         uint8_t* __restrict__ ok_out, long long n) {
  __shared__ uint32_t rtab[secp::kRTable * secp::kRWords * kLanes];  // 46,080 B
  __shared__ uint32_t half1[6 * kLanes];                               // k1 (5 words), n1
  const int lane = threadIdx.x % kLanes;
  const bool g_warp = threadIdx.x >= kLanes;
  const long long i = static_cast<long long>(blockIdx.x) * kLanes + lane;
  const bool live = i < n;
  const secp::RTable tab{rtab + lane, kLanes};
  secp::LaneIn in;
  secp::U256 k2;
  secp::Jac g, acc;
  bool n2 = false, on_curve = false;
  if (live) {
    in = secp::read_lane(z + i * z_width, z_width == secp::kLimbs, r + i * secp::kLimbs,
                         s + i * secp::kLimbs, v[i]);
    if (g_warp) {
      secp::U256 k1;
      bool n1;
      g = secp::g_side(in, gtab, k1, n1, k2, n2);
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        half1[w * kLanes + lane] = k1.w[w];  // below 2^132
      }
      half1[5 * kLanes + lane] = n1;
    } else {
      on_curve = secp::r_side(in, v[i], tab);
    }
  }
  __syncthreads();
  if (live) {
    if (g_warp) {
      acc = secp::point_add(secp::half_mul(k2, n2, true, tab), g);
    } else {
      secp::U256 k1 = secp::small(0);
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        k1.w[w] = half1[w * kLanes + lane];
      }
      acc = secp::half_mul(k1, half1[5 * kLanes + lane] != 0, false, tab);
    }
  }
  __syncthreads();  // the table is free: the G side's sum goes into its first entry
  if (live && g_warp) {
    tab.put(1, acc);
  }
  __syncthreads();
  if (live && !g_warp) {
    const bool finite = secp::finish(secp::point_add(acc, tab.get(1)), x_out + i * secp::kLimbs,
                                     y_out + i * secp::kLimbs, addr_out + i * 5);
    ok_out[i] = finite && in.ok && on_curve;
  }
}

// k1 G + k2 Q (kVerify false: a = k1, b = k2; X, Y, Z out) or the
// verification (kVerify true: a = z, b = r, s; the mask out), 32 lanes a
// block.  Warp 0 builds d Q for d = 1..15 in the table and runs b1 Q over
// it; warp 1 makes the scalars (in verify mode s^-1, u1 and u2 first),
// splits k2, hands b1 to warp 0, sums k1 G by the comb and runs b2 phi(Q)
// over the same table; after the ladders it passes k1 G and b2 phi(Q) to
// warp 0 in the table's first two entries, and warp 0 merges and ends.
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
  __shared__ uint32_t rtab[secp::kRTable * secp::kRWords * kLanes];  // 46,080 B
  __shared__ uint32_t half1[6 * kLanes];                               // b1 (5 words), n1
  const int lane = threadIdx.x % kLanes;
  const bool g_warp = threadIdx.x >= kLanes;
  const long long i = static_cast<long long>(blockIdx.x) * kLanes + lane;
  const bool live = i < n;
  const long long at = i * secp::kLimbs;
  const secp::RTable tab{rtab + lane, kLanes};
  secp::U256 b2;
  secp::Jac g, acc;
  bool n2 = false;
  if (live) {
    if (g_warp) {
      secp::U256 k1, k2, b1;
      bool n1;
      secp::ecmul2_scalars(kVerify, a + at, b + at, kVerify ? s + at : nullptr, k1, k2);
      g = secp::ecmul2_g_side(k1, k2, gtab, b1, n1, b2, n2);
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        half1[w * kLanes + lane] = b1.w[w];  // below 2^132
      }
      half1[5 * kLanes + lane] = n1;
    } else {
      secp::build_r_table(secp::field_from_limbs(qx + at), secp::field_from_limbs(qy + at), tab);
    }
  }
  __syncthreads();
  if (live) {
    if (g_warp) {
      acc = secp::half_mul(b2, n2, true, tab);
    } else {
      secp::U256 b1 = secp::small(0);
#pragma unroll
      for (int w = 0; w < 5; ++w) {
        b1.w[w] = half1[w * kLanes + lane];
      }
      acc = secp::half_mul(b1, half1[5 * kLanes + lane] != 0, false, tab);
    }
  }
  __syncthreads();  // the table is free: k1 G and b2 phi(Q) go into its first two entries
  if (live && g_warp) {
    tab.put(1, g);
    tab.put(2, acc);
  }
  __syncthreads();
  if (live && !g_warp) {
    const secp::Jac q = secp::ecmul2_merge(tab.get(1), acc, tab.get(2));
    if (kVerify) {
      ok_out[i] = secp::verify_result(b + at, s + at, q);
    } else {
      secp::write_point(x_out + at, y_out + at, z_out + at, q);
    }
  }
}

__global__ void __launch_bounds__(2 * kLanes)
secp256k1_ecmul2_kernel(const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
                        const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                        const uint32_t* __restrict__ gtab, int32_t* __restrict__ x_out,
                        int32_t* __restrict__ y_out, int32_t* __restrict__ z_out, long long n) {
  ecmul2_block<false>(k1, k2, nullptr, qx, qy, gtab, x_out, y_out, z_out, nullptr, n);
}

__global__ void __launch_bounds__(2 * kLanes)
secp256k1_verify_kernel(const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
                        const int32_t* __restrict__ z, const int32_t* __restrict__ r,
                        const int32_t* __restrict__ s, const uint32_t* __restrict__ gtab,
                        uint8_t* __restrict__ ok_out, long long n) {
  ecmul2_block<true>(z, r, s, qx, qy, gtab, nullptr, nullptr, nullptr, ok_out, n);
}

}  // namespace

// C entry point, bound with ctypes.  n lanes: z holds z_width (8 value
// words or 20 limbs) int32 per lane, r and s 20 limbs, v one int32; gtab is
// the comb table, (32, 256, 16) words on the card (see ops/ecrecover.py);
// x_out and y_out get 20 limbs, addr_out 5 stream words, ok_out one byte (a
// torch.bool).  Launches on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch.
extern "C" int secp256k1_recover(const void* z, int z_width, const void* r, const void* s,
                                 const void* v, const void* gtab, void* x_out, void* y_out,
                                 void* addr_out, void* ok_out, long long n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kLanes - 1) / kLanes;
  secp256k1_recover_kernel<<<static_cast<unsigned int>(blocks), 2 * kLanes, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), z_width, static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(v),
      static_cast<const uint32_t*>(gtab), static_cast<int32_t*>(x_out),
      static_cast<int32_t*>(y_out), static_cast<int32_t*>(addr_out),
      static_cast<uint8_t*>(ok_out), n);
  return static_cast<int>(cudaGetLastError());
}

// C entry point, bound with ctypes: k1 G + k2 Q for n lanes.  k1 and k2
// are 20 limbs below 2N, Q = (qx, qy) 20 canonical limbs each; x_out,
// y_out, z_out get the Jacobian result as canonical limbs (infinity: Z =
// 0).  Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int secp256k1_ecmul2(const void* k1, const void* k2, const void* qx, const void* qy,
                                const void* gtab, void* x_out, void* y_out, void* z_out, long long n,
                                void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kLanes - 1) / kLanes;
  secp256k1_ecmul2_kernel<<<static_cast<unsigned int>(blocks), 2 * kLanes, 0,
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
  secp256k1_verify_kernel<<<static_cast<unsigned int>(blocks), 2 * kLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qx), static_cast<const int32_t*>(qy),
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(s), static_cast<const uint32_t*>(gtab),
      static_cast<uint8_t*>(ok_out), n);
  return static_cast<int>(cudaGetLastError());
}

#else

// The same lanes on the host, one after another: the CPU tests' view of the
// kernel's arithmetic.  Not used by the port's wrappers.
extern "C" int secp256k1_recover_host(const int32_t* z, int z_width, const int32_t* r,
                                      const int32_t* s, const int32_t* v, const uint32_t* gtab,
                                      int32_t* x_out, int32_t* y_out, int32_t* addr_out,
                                      uint8_t* ok_out, long long n) {
  uint32_t rtab[secp::kRTable * secp::kRWords];
  const secp::RTable tab{rtab, 1};
  for (long long i = 0; i < n; ++i) {
    ok_out[i] = secp::recover_lane(z + i * z_width, z_width == secp::kLimbs, r + i * secp::kLimbs,
                                   s + i * secp::kLimbs, v[i], gtab, tab,
                                   x_out + i * secp::kLimbs, y_out + i * secp::kLimbs,
                                   addr_out + i * 5);
  }
  return 0;
}

// secp256k1_ecmul2 and secp256k1_verify on the host, a lane's two warps'
// parts one after the other.  Not used by the port's wrappers.
extern "C" int secp256k1_ecmul2_host(const int32_t* k1, const int32_t* k2, const int32_t* qx,
                                     const int32_t* qy, const uint32_t* gtab, int32_t* x_out,
                                     int32_t* y_out, int32_t* z_out, long long n) {
  uint32_t rtab[secp::kRTable * secp::kRWords];
  const secp::RTable tab{rtab, 1};
  for (long long i = 0; i < n; ++i) {
    const long long at = i * secp::kLimbs;
    const secp::Jac q = secp::ecmul2_lane(false, k1 + at, k2 + at, nullptr, qx + at, qy + at, gtab, tab);
    secp::write_point(x_out + at, y_out + at, z_out + at, q);
  }
  return 0;
}

extern "C" int secp256k1_verify_host(const int32_t* qx, const int32_t* qy, const int32_t* z,
                                     const int32_t* r, const int32_t* s, const uint32_t* gtab,
                                     uint8_t* ok_out, long long n) {
  uint32_t rtab[secp::kRTable * secp::kRWords];
  const secp::RTable tab{rtab, 1};
  for (long long i = 0; i < n; ++i) {
    const long long at = i * secp::kLimbs;
    const secp::Jac q = secp::ecmul2_lane(true, z + at, r + at, s + at, qx + at, qy + at, gtab, tab);
    ok_out[i] = secp::verify_result(r + at, s + at, q);
  }
  return 0;
}

// The kernel's safegcd inversion on the host: n values of 8 little-endian
// words, below the modulus (N where modulus_is_n, else P).
extern "C" int secp256k1_modinv_host(const uint32_t* x, int modulus_is_n, uint32_t* out,
                                     long long n) {
  for (long long i = 0; i < n; ++i) {
    const secp::U256 a = secp::from_table(x + 8 * i);
    const secp::U256 r = modulus_is_n ? secp::modinv(a, secp::kN30, secp::kN30Inv)
                                      : secp::modinv(a, secp::kP30, secp::kP30Inv);
    for (int k = 0; k < 8; ++k) {
      out[8 * i + k] = r.w[k];
    }
  }
  return 0;
}

#endif
