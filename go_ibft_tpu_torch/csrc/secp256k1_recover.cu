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
// The lane arithmetic (secp256k1.cuh) also compiles with a host C++ compiler
// (lane.cuh; the PTX has a portable C++ twin that runs the same algorithm,
// and the host runs a lane's two sides one after the other): the CPU tests
// build this file with g++ and hold secp256k1_recover_host against the host
// oracle and secp256k1_modinv_host against Python's pow(x, -1, m).

#include "keccak_f1600.cuh"
#include "secp256k1.cuh"

namespace secp {

constexpr int kWindows = 33;       // 4-bit windows over the 132 bits of a half-scalar
constexpr int kRWords = 24;        // words per d*R entry: X, Y, Z
constexpr int kRTable = 15;        // d = 1..15

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
// Jacobian points, y^2 = x^3 + 7
// ---------------------------------------------------------------------------


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
