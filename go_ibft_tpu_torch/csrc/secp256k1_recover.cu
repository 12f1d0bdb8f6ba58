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
// Design.  A lane's state never leaves the thread: field elements mod P are
// 8 x 32-bit words, always canonical (< P), reduced through
// 2^256 = 2^32 + 977 (mod P); arithmetic mod N is Montgomery (CIOS).  The
// square root, r^-1 (mod N) and the final Z^-1 are fixed-exponent powers
// with 4-bit windows.  Both scalars are split by the GLV endomorphism
// phi(x, y) = (beta x, y) = lambda (x, y) into signed half-scalars of at most
// 129 bits, as in the JAX package; one accumulator then runs a 33-window
// Straus ladder (4 doublings and up to 4 additions per window) over the
// tables d*G and d*phi(G) (affine, in __constant__ memory below) and d*R,
// d*phi(R) (Jacobian, built per lane).  Additions meet P == Q and P == -Q,
// and both are handled explicitly.  One inversion gives the affine point,
// whose coordinates are unique, so no cross-lane batch inversion is needed.
// The address hash runs keccak::permute (keccak_f1600.cuh) on registers.
//
// What bounds it on an H100: about 3.5e3 field multiplications per lane,
// each some 200 32-bit integer instructions, against 260 B read and 225 B
// written per lane: operations, not bytes.  At the main path's 256..1024
// lanes only 8..32 warps run on the 132 SMs, so the kernel is bound by one
// thread's dependency chain.  Blocks of 32 threads spread those warps over as
// many SMs as possible; several threads per lane, or wide products on the
// tensor cores, are later work.
//
// The lane arithmetic also compiles with a host C++ compiler (lane.cuh): the
// CPU tests build this file with g++ and hold secp256k1_recover_host against
// the host oracle.

#include "keccak_f1600.cuh"
#include "lane.cuh"

#if defined(__CUDACC__)
#define LANE_BIG __device__ __noinline__
#else
#define LANE_BIG static
#endif

namespace secp {

constexpr int kLimbs = 20;  // 13-bit limbs of the port's tensors
constexpr int kLimbBits = 13;
constexpr uint32_t kLimbMask = (1u << kLimbBits) - 1;
constexpr int kWindows = 33;  // 4-bit windows over the 132 bits of a half-scalar

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
// 2^256 mod N (Montgomery one) and 2^512 mod N; -N^-1 mod 2^32.
LANE_TABLE uint32_t kMontOneN[8] = {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u,
                                    0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u};
LANE_TABLE uint32_t kMontR2N[8] = {0x67D7D140u, 0x896CF214u, 0x0E7CF878u, 0x741496C2u,
                                   0x5BCD07C6u, 0xE697F5E4u, 0x81C69BC5u, 0x9D671CD5u};
constexpr uint32_t kN0Inv = 0x5588B13Fu;
// Exponents: P - 2 (inverse mod P), (P + 1) / 4 (square root), N - 2.
LANE_TABLE uint32_t kExpInvP[8] = {0xFFFFFC2Du, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
LANE_TABLE uint32_t kExpSqrt[8] = {0xBFFFFF0Cu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x3FFFFFFFu};
LANE_TABLE uint32_t kExpInvN[8] = {0xD036413Fu, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                                   0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
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

// d*G, affine, and the x-coordinates of d*phi(G) = (beta x, y), d = 1..15
// (row 0 is unused): the tables of go_ibft_tpu_torch/ops/secp256k1.py::
// _precompute_g_table and _precompute_glv_g_table as 32-bit words.
LANE_TABLE uint32_t kGx[16][8] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // 0
    {0x16F81798u, 0x59F2815Bu, 0x2DCE28D9u, 0x029BFCDBu, 0xCE870B07u, 0x55A06295u, 0xF9DCBBACu, 0x79BE667Eu},  // 1
    {0x5C709EE5u, 0xABAC09B9u, 0x8CEF3CA7u, 0x5C778E4Bu, 0x95C07CD8u, 0x3045406Eu, 0x41ED7D6Du, 0xC6047F94u},  // 2
    {0xBCE036F9u, 0x8601F113u, 0x836F99B0u, 0xB531C845u, 0xF89D5229u, 0x49344F85u, 0x9258C310u, 0xF9308A01u},  // 3
    {0xE8C4CD13u, 0x74FA94ABu, 0x0EE07584u, 0xCC6C1390u, 0x930B1404u, 0x581E4904u, 0xC10D80F3u, 0xE493DBF1u},  // 4
    {0xB240EFE4u, 0xCBA8D569u, 0xDC619AB7u, 0xE88B84BDu, 0x0A5C5128u, 0x55B4A725u, 0x1A072093u, 0x2F8BDE4Du},  // 5
    {0x60297556u, 0x2F057A14u, 0x8568A18Bu, 0x82F6472Fu, 0x355235D3u, 0x20453A14u, 0x755EEEA4u, 0xFFF97BD5u},  // 6
    {0xCAC4F9BCu, 0xE92BDDEDu, 0x0330E39Cu, 0x3D419B7Eu, 0xF2EA7A0Eu, 0xA398F365u, 0x6E5DB4EAu, 0x5CBDF064u},  // 7
    {0xE10A2A01u, 0x67784EF3u, 0xE5AF888Au, 0x0A1BDD05u, 0xB70F3C2Fu, 0xAFF3843Fu, 0x5CCA351Du, 0x2F01E5E1u},  // 8
    {0xFC27CCBEu, 0xC35F110Du, 0x4C57E714u, 0xE0979697u, 0x9F559ABDu, 0x09AD178Au, 0xF0C7F653u, 0xACD484E2u},  // 9
    {0x47E247C7u, 0x52A68E2Au, 0x1943C2B7u, 0x3442D49Bu, 0x1AE6AE5Du, 0x35477C7Bu, 0x47F3C862u, 0xA0434D9Eu},  // 10
    {0x5DA008CBu, 0xBBEC1789u, 0xE5C17891u, 0x5649980Bu, 0x70C65AACu, 0x5EF4246Bu, 0x58A9411Eu, 0x774AE7F8u},  // 11
    {0x70AFE85Au, 0xC5B0F470u, 0x9620095Bu, 0x687CF441u, 0x4D734633u, 0x15C38F00u, 0x48E7561Bu, 0xD01115D5u},  // 12
    {0x19405AA8u, 0xDEEDDF8Fu, 0x610E58CDu, 0xB075FBC6u, 0xC3748651u, 0xC7D1D205u, 0xD975288Bu, 0xF28773C2u},  // 13
    {0x60E823E4u, 0xE49B241Au, 0x678949E6u, 0x26AA7B63u, 0x07D38E32u, 0xFD64E67Fu, 0x895E719Cu, 0x499FDF9Eu},  // 14
    {0xE27E080Eu, 0x44ADBCF8u, 0x3C85F79Eu, 0x31E5946Fu, 0x095FF411u, 0x5A465AE3u, 0x7D43EA96u, 0xD7924D4Fu},  // 15
};
LANE_TABLE uint32_t kGy[16][8] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // 0
    {0xFB10D4B8u, 0x9C47D08Fu, 0xA6855419u, 0xFD17B448u, 0x0E1108A8u, 0x5DA4FBFCu, 0x26A3C465u, 0x483ADA77u},  // 1
    {0x50CFE52Au, 0x236431A9u, 0x3266D0E1u, 0xF7F63265u, 0x466CEAEEu, 0xA3C58419u, 0xA63DC339u, 0x1AE168FEu},  // 2
    {0x84B8E672u, 0x6CB9FD75u, 0x34C2231Bu, 0x6500A999u, 0x2A37F356u, 0x0FE337E6u, 0x632DE814u, 0x388F7B0Fu},  // 3
    {0x47739922u, 0xCFE97BDCu, 0xBFBDFE40u, 0xD967AE33u, 0x8EA51448u, 0x5642E209u, 0xA0D455B7u, 0x51ED993Eu},  // 4
    {0xA6AC62D6u, 0xDCA87D3Au, 0xAB0D6840u, 0xF788271Bu, 0xA6C9C426u, 0xD4DBA9DDu, 0x36E5E3D6u, 0xD8AC2226u},  // 5
    {0xB075F297u, 0x3C870C36u, 0x518FE4A0u, 0xDE80F0F6u, 0x7F45C560u, 0xF3BE9601u, 0xACFBB620u, 0xAE12777Au},  // 6
    {0x087264DAu, 0xA5082628u, 0x13FDE7B5u, 0xA813D0B8u, 0x861A54DBu, 0xA3178D6Du, 0xBA255960u, 0x6AEBCA40u},  // 7
    {0x6CBDE904u, 0xB5DA2CB7u, 0xBA5B7617u, 0xC2E213D6u, 0x132D13B4u, 0x293D082Au, 0x41539949u, 0x5C4DA8A7u},  // 8
    {0xC64F9C37u, 0x05CC262Au, 0x375F8E0Fu, 0xADD888A4u, 0x763B61E9u, 0x64380971u, 0xB0A7D9FDu, 0xCC338921u},  // 9
    {0x037368D7u, 0x3CBEE53Bu, 0xD877A159u, 0x6F794C2Eu, 0x93A24C69u, 0xA3B6C7E6u, 0x5419BC27u, 0x893ABA42u},  // 10
    {0xC953C61Bu, 0x301D74C9u, 0xDFF9D6A8u, 0x372DB1E2u, 0xD7B7B365u, 0x0243DD56u, 0xEB6B5E19u, 0xD984A032u},  // 11
    {0xF4062327u, 0x6B051B13u, 0xD9A86D52u, 0x79238C5Du, 0xE17BD815u, 0xA8B64537u, 0xC815E0D7u, 0xA9F34FFDu},  // 12
    {0xDB03ED81u, 0x29B5CB52u, 0x521FA91Fu, 0x3A1A06DAu, 0x65CDAF47u, 0x758212EBu, 0x8D880A89u, 0x0AB0902Eu},  // 13
    {0x03A13F5Bu, 0xC65F40D4u, 0x7A3F95BCu, 0x464279C2u, 0xA7B3D464u, 0x90F044E4u, 0xB54E8551u, 0xCAC2F6C4u},  // 14
    {0xF6A26B58u, 0xC504DC9Fu, 0xD896D3A5u, 0xEA40AF2Bu, 0x28CC6DEFu, 0x83842EC2u, 0xA86C72A6u, 0x581E2872u},  // 15
};
LANE_TABLE uint32_t kGBetaX[16][8] = {
    {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u},  // 0
    {0x00B88FCBu, 0xA7BBA044u, 0x7F15E98Du, 0x87284406u, 0x96902325u, 0xAB0102B6u, 0x9DA01887u, 0xBCACE2E9u},  // 1
    {0xD89250E1u, 0x3E995B6Eu, 0xE43837EFu, 0xD2FAD8CCu, 0x59F87B33u, 0x4135EE7Du, 0xB34CE6DFu, 0xC360A6D0u},  // 2
    {0x77206B2Fu, 0xF7F0728Cu, 0xC6DC8E1Cu, 0x8AF1E022u, 0x2A28FA2Fu, 0x8DCD8DCFu, 0x731F9B4Bu, 0xDF6EDF03u},  // 3
    {0x3B306100u, 0x5BDE5B33u, 0xAB487127u, 0x714C30B5u, 0xB90E324Bu, 0x5C45FAF8u, 0x0D382907u, 0x1B77921Fu},  // 4
    {0x95A83668u, 0x138C6946u, 0xE0D097CCu, 0xA045693Eu, 0xCCB94671u, 0xF79F54FBu, 0xACDA49DFu, 0x337B52E3u},  // 5
    {0x78F38045u, 0x47AAF280u, 0x56A15A68u, 0x86649D3Eu, 0xE3E8BED7u, 0x5E3AA731u, 0xAA535FC6u, 0xE63BCDD9u},  // 6
    {0x4E53BC94u, 0x3BC4686Eu, 0x0FAF7AAAu, 0x0D3B20E2u, 0xC095C06Eu, 0xA4FEC4D1u, 0x4BEA0B77u, 0x13F26E75u},  // 7
    {0x2446CC73u, 0x03E94774u, 0x24257657u, 0xB4FF7715u, 0x29E24892u, 0xAA77840Fu, 0x42D401A7u, 0x47AB6503u},  // 8
    {0x65953A52u, 0x20CD912Eu, 0xEF6D44E1u, 0xB565CDF5u, 0xEC58AB20u, 0x7B6558AFu, 0x7E44E819u, 0x87B40403u},  // 9
    {0x741AFE29u, 0xBDB3E957u, 0x083762E4u, 0xC1938D8Eu, 0x46813990u, 0xA136EBB2u, 0xF7A397B1u, 0x26CE269Bu},  // 10
    {0xBB209CE7u, 0xC5FF4334u, 0x0B5FF620u, 0x79859BB7u, 0xBEBF1A26u, 0x8D897C41u, 0x171DAC1Du, 0x51F4D3D1u},  // 11
    {0x042295E5u, 0x4A3EB52Cu, 0xC9535355u, 0xF9482837u, 0x2EAC82ADu, 0xAC154842u, 0x953AAC41u, 0x88591BFDu},  // 12
    {0x475FB678u, 0x60AAEE6Au, 0x4A3D0562u, 0x32907ED7u, 0x78FC783Bu, 0x07046C45u, 0x4BB890A2u, 0xF14D5837u},  // 13
    {0x20A0B458u, 0x0E6AB7EEu, 0x27C529F6u, 0x580656A6u, 0x87C37384u, 0x1548F0DCu, 0x7810048Au, 0x7B125217u},  // 14
    {0x71B1B3B4u, 0x3AC0A40Cu, 0xC1C0A639u, 0x05CC3BC9u, 0x512B6948u, 0x0E1B4825u, 0xF5F9454Au, 0x805F1105u},  // 15
};

// ---------------------------------------------------------------------------
// 256-bit words
// ---------------------------------------------------------------------------

LANE_FN void load(U256& r, const uint32_t* t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = t[i];
  }
}

LANE_FN void set_small(U256& r, uint32_t v) {
  r.w[0] = v;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    r.w[i] = 0;
  }
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

// r = a + b mod 2^256; returns the carry out.
LANE_FN uint32_t add_words(U256& r, const U256& a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b[i];
    r.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
}

// r = a - b mod 2^256; returns the borrow out.
LANE_FN uint32_t sub_words(U256& r, const U256& a, const uint32_t* b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t d = static_cast<uint64_t>(a.w[i]) - b[i] - borrow;
    r.w[i] = static_cast<uint32_t>(d);
    borrow = d >> 63;
  }
  return static_cast<uint32_t>(borrow);
}

// The 512-bit product a * b into t[16].
LANE_FN void mul_wide(uint32_t t[16], const U256& a, const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    t[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += static_cast<uint64_t>(a.w[i]) * b[j] + t[i + j];
      t[i + j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    t[i + 8] = static_cast<uint32_t>(c);
  }
}

// ---------------------------------------------------------------------------
// The field mod P; every value canonical, in [0, P)
// ---------------------------------------------------------------------------

// r = t mod P for a 512-bit t, folding the high half by 2^256 = 2^32 + 977.
LANE_FN void fp_reduce(U256& r, const uint32_t t[16]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += static_cast<uint64_t>(t[i]) + static_cast<uint64_t>(t[8 + i]) * 977u;
    if (i > 0) {
      c += t[7 + i];
    }
    r.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  c += t[15];  // < 2^33: the value is r + c 2^256
  uint64_t d = static_cast<uint64_t>(r.w[0]) + c * 977u;
  r.w[0] = static_cast<uint32_t>(d);
  d >>= 32;
  d += static_cast<uint64_t>(r.w[1]) + c;
  r.w[1] = static_cast<uint32_t>(d);
  d >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    d += r.w[i];
    r.w[i] = static_cast<uint32_t>(d);
    d >>= 32;
  }
  if (d) {  // wrapped past 2^256; r is small now, so this cannot wrap again
    d = static_cast<uint64_t>(r.w[0]) + 977u;
    r.w[0] = static_cast<uint32_t>(d);
    d >>= 32;
    d += static_cast<uint64_t>(r.w[1]) + 1u;
    r.w[1] = static_cast<uint32_t>(d);
    d >>= 32;
#pragma unroll
    for (int i = 2; i < 8; ++i) {
      d += r.w[i];
      r.w[i] = static_cast<uint32_t>(d);
      d >>= 32;
    }
  }
  if (geq(r, kP)) {
    sub_words(r, r, kP);
  }
}

LANE_FN void fp_mul(U256& r, const U256& a, const U256& b) {
  uint32_t t[16];
  mul_wide(t, a, b.w);
  fp_reduce(r, t);
}

LANE_FN void fp_sqr(U256& r, const U256& a) { fp_mul(r, a, a); }

LANE_FN void fp_add(U256& r, const U256& a, const U256& b) {
  const uint32_t carry = add_words(r, a, b.w);
  if (carry || geq(r, kP)) {
    sub_words(r, r, kP);
  }
}

LANE_FN void fp_sub(U256& r, const U256& a, const U256& b) {
  if (sub_words(r, a, b.w)) {
    add_words(r, r, kP);
  }
}

LANE_FN void fp_neg(U256& r, const U256& a) {
  if (is_zero(a)) {
    r = a;
  } else {
    U256 p;
    load(p, kP);
    sub_words(r, p, a.w);
  }
}

// r = a^e mod P for a fixed exponent e (8 words), 4-bit windows MSB first.
LANE_BIG void fp_pow(U256& r, const U256& a, const uint32_t* e) {
  U256 tab[16];
  set_small(tab[0], 1);
  tab[1] = a;
  for (int k = 2; k < 16; ++k) {
    fp_mul(tab[k], tab[k - 1], a);
  }
  set_small(r, 1);
  for (int win = 63; win >= 0; --win) {
    if (win != 63) {
      fp_sqr(r, r);
      fp_sqr(r, r);
      fp_sqr(r, r);
      fp_sqr(r, r);
    }
    const uint32_t nib = (e[win >> 3] >> ((win & 7) * 4)) & 15u;
    if (nib) {
      fp_mul(r, r, tab[nib]);
    }
  }
}

// ---------------------------------------------------------------------------
// Scalars mod N: Montgomery multiplication with R = 2^256
// ---------------------------------------------------------------------------

// r = a b R^-1 mod N for a, b < N (CIOS).
LANE_BIG void mont_mul(U256& r, const U256& a, const U256& b) {
  uint32_t t[10];
  for (int i = 0; i < 10; ++i) {
    t[i] = 0;
  }
  for (int i = 0; i < 8; ++i) {
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
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = t[i];
  }
  if (t[8] || geq(r, kN)) {
    sub_words(r, r, kN);
  }
}

// r = a^e in the Montgomery domain (a and r in Montgomery form).
LANE_BIG void mont_pow(U256& r, const U256& a, const uint32_t* e) {
  U256 tab[16];
  load(tab[0], kMontOneN);
  tab[1] = a;
  for (int k = 2; k < 16; ++k) {
    mont_mul(tab[k], tab[k - 1], a);
  }
  load(r, kMontOneN);
  for (int win = 63; win >= 0; --win) {
    if (win != 63) {
      mont_mul(r, r, r);
      mont_mul(r, r, r);
      mont_mul(r, r, r);
      mont_mul(r, r, r);
    }
    const uint32_t nib = (e[win >> 3] >> ((win & 7) * 4)) & 15u;
    if (nib) {
      mont_mul(r, r, tab[nib]);
    }
  }
}

// ---------------------------------------------------------------------------
// The GLV split
// ---------------------------------------------------------------------------

// c = round(k g / 2^384), a 128-bit value.
LANE_FN void mul_shift_384(U256& c, const U256& k, const uint32_t* g) {
  uint32_t t[16];
  mul_wide(t, k, g);
  uint64_t carry = static_cast<uint64_t>(t[11]) + 0x80000000u;  // + 2^383
#pragma unroll
  for (int i = 12; i < 16; ++i) {
    carry = (carry >> 32) + t[i];
    c.w[i - 12] = static_cast<uint32_t>(carry);
  }
#pragma unroll
  for (int i = 4; i < 8; ++i) {
    c.w[i] = 0;
  }
}

// r = a b mod 2^256.
LANE_FN void mul_low(U256& r, const U256& a, const uint32_t* b) {
  uint32_t t[16];
  mul_wide(t, a, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.w[i] = t[i];
  }
}

// |v| for a two's-complement v mod 2^256; returns true where v < 0.
LANE_FN bool abs_signed(U256& v) {
  const bool neg = (v.w[7] >> 31) != 0;
  if (neg) {
    U256 zero;
    set_small(zero, 0);
    sub_words(v, zero, v.w);
  }
  return neg;
}

// k == s1 |k1| + s2 |k2| lambda (mod N) with |k1|, |k2| < 2^129.
LANE_BIG void glv_split(const U256& k, U256& k1, bool& neg1, U256& k2, bool& neg2) {
  U256 c1, c2, t;
  mul_shift_384(c1, k, kGlvG1);
  mul_shift_384(c2, k, kGlvG2);
  mul_low(t, c1, kGlvA1);
  sub_words(k1, k, t.w);
  mul_low(t, c2, kGlvA2);
  sub_words(k1, k1, t.w);
  mul_low(k2, c1, kGlvNegB1);
  mul_low(t, c2, kGlvB2);
  sub_words(k2, k2, t.w);
  neg1 = abs_signed(k1);
  neg2 = abs_signed(k2);
}

LANE_FN uint32_t nibble(const U256& k, int win) {
  return (k.w[win >> 3] >> ((win & 7) * 4)) & 15u;
}

// ---------------------------------------------------------------------------
// Jacobian points, y^2 = x^3 + 7
// ---------------------------------------------------------------------------

LANE_FN void set_infinity(Jac& p) {
  set_small(p.x, 1);
  set_small(p.y, 1);
  set_small(p.z, 0);
}

// p = 2p ("dbl-2009-l", a = 0); infinity stays infinity (Z3 = 2 Y Z).
LANE_BIG void point_double(Jac& p) {
  U256 a, b, c, d, e, f, t;
  fp_sqr(a, p.x);
  fp_sqr(b, p.y);
  fp_sqr(c, b);
  fp_add(t, p.x, b);
  fp_sqr(t, t);
  fp_sub(t, t, a);
  fp_sub(t, t, c);
  fp_add(d, t, t);  // D = 2((X + B)^2 - A - C)
  fp_add(e, a, a);
  fp_add(e, e, a);  // E = 3A
  fp_sqr(f, e);
  fp_mul(p.z, p.y, p.z);
  fp_add(p.z, p.z, p.z);  // Z3 = 2 Y Z
  fp_add(t, d, d);
  fp_sub(p.x, f, t);  // X3 = F - 2D
  fp_sub(t, d, p.x);
  fp_mul(t, e, t);
  fp_add(c, c, c);
  fp_add(c, c, c);
  fp_add(c, c, c);  // 8C
  fp_sub(p.y, t, c);  // Y3 = E (D - X3) - 8C
}

// The tail shared by both additions: given H = U2 - U1 != 0, R = S2 - S1,
// U1, S1 and Z3 / H, finish X3, Y3, Z3.
LANE_FN void add_tail(Jac& p, const U256& h, const U256& rr, const U256& u1,
                      const U256& s1, const U256& zh) {
  U256 hh, hhh, v, t;
  fp_sqr(hh, h);
  fp_mul(hhh, hh, h);
  fp_mul(v, u1, hh);
  fp_sqr(t, rr);
  fp_sub(t, t, hhh);
  fp_sub(t, t, v);
  fp_sub(p.x, t, v);  // X3 = R^2 - H^3 - 2 U1 H^2
  fp_sub(t, v, p.x);
  fp_mul(t, rr, t);
  fp_mul(v, s1, hhh);
  fp_sub(p.y, t, v);  // Y3 = R (U1 H^2 - X3) - S1 H^3
  fp_mul(p.z, zh, h);
}

// p += (qx, qy), an affine point.  Complete: infinity, P == Q, P == -Q.
LANE_BIG void point_add_affine(Jac& p, const U256& qx, const U256& qy) {
  if (is_zero(p.z)) {
    p.x = qx;
    p.y = qy;
    set_small(p.z, 1);
    return;
  }
  U256 z1z1, u2, s2, h, rr;
  fp_sqr(z1z1, p.z);
  fp_mul(u2, qx, z1z1);
  fp_mul(s2, qy, p.z);
  fp_mul(s2, s2, z1z1);
  fp_sub(h, u2, p.x);
  fp_sub(rr, s2, p.y);
  if (is_zero(h)) {
    if (is_zero(rr)) {
      point_double(p);
    } else {
      set_infinity(p);
    }
    return;
  }
  const U256 u1 = p.x, s1 = p.y, z1 = p.z;
  add_tail(p, h, rr, u1, s1, z1);
}

// p += q, both Jacobian.  Complete: infinity, P == Q, P == -Q.
LANE_BIG void point_add(Jac& p, const Jac& q) {
  if (is_zero(q.z)) {
    return;
  }
  if (is_zero(p.z)) {
    p = q;
    return;
  }
  U256 z1z1, z2z2, u1, u2, s1, s2, h, rr, zz;
  fp_sqr(z1z1, p.z);
  fp_sqr(z2z2, q.z);
  fp_mul(u1, p.x, z2z2);
  fp_mul(u2, q.x, z1z1);
  fp_mul(s1, p.y, q.z);
  fp_mul(s1, s1, z2z2);
  fp_mul(s2, q.y, p.z);
  fp_mul(s2, s2, z1z1);
  fp_sub(h, u2, u1);
  fp_sub(rr, s2, s1);
  if (is_zero(h)) {
    if (is_zero(rr)) {
      point_double(p);
    } else {
      set_infinity(p);
    }
    return;
  }
  fp_mul(zz, p.z, q.z);
  add_tail(p, h, rr, u1, s1, zz);
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
  set_small(r, 0);
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
LANE_FN void scalar_mod_n(U256& z, const int32_t* in, bool as_limbs) {
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
  if (top || geq(z, kN)) {
    sub_words(z, z, kN);
  }
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

// One lane: returns ok; writes x, y (20 limbs each) and addr (5 words).
LANE_BIG bool recover_lane(const int32_t* z_in, bool z_limbs, const int32_t* r_limbs,
                           const int32_t* s_limbs, int32_t v, int32_t* x_out, int32_t* y_out,
                           int32_t* addr_out) {
  U256 r, s, z;
  bool ok = scalar_in_range(r, r_limbs);
  ok = scalar_in_range(s, s_limbs) && ok;
  ok = ok && (v == 0 || v == 1);
  scalar_mod_n(z, z_in, z_limbs);

  // R = (r, y): y^2 = r^3 + 7 with the parity of v.
  U256 y2, y, t;
  fp_sqr(t, r);
  fp_mul(t, t, r);
  U256 seven;
  set_small(seven, 7);
  fp_add(y2, t, seven);
  fp_pow(y, y2, kExpSqrt);
  fp_sqr(t, y);
  ok = ok && equal(t, y2);
  if ((y.w[0] & 1u) != static_cast<uint32_t>(v)) {
    fp_neg(y, y);
  }

  // u1 = -z r^-1, u2 = s r^-1 (mod N).  rinv is in Montgomery form, so a
  // Montgomery product with a plain value gives a plain value.
  U256 rinv, u1, u2;
  load(rinv, kMontR2N);
  mont_mul(t, r, rinv);
  mont_pow(rinv, t, kExpInvN);
  if (!is_zero(z)) {
    U256 n;
    load(n, kN);
    sub_words(z, n, z.w);
  }
  mont_mul(u1, z, rinv);
  mont_mul(u2, s, rinv);

  U256 a1, a2, b1, b2;
  bool na1, na2, nb1, nb2;
  glv_split(u1, a1, na1, a2, na2);
  glv_split(u2, b1, nb1, b2, nb2);

  // d*R for d = 1..15, Jacobian; row 0 unused.
  Jac qtab[16];
  qtab[1].x = r;
  qtab[1].y = y;
  set_small(qtab[1].z, 1);
  qtab[2] = qtab[1];
  point_double(qtab[2]);
  for (int d = 3; d < 16; ++d) {
    qtab[d] = qtab[d - 1];
    point_add_affine(qtab[d], r, y);
  }
  U256 beta;
  load(beta, kBeta);

  Jac acc;
  set_infinity(acc);
  for (int win = kWindows - 1; win >= 0; --win) {
    if (win != kWindows - 1) {
      point_double(acc);
      point_double(acc);
      point_double(acc);
      point_double(acc);
    }
    uint32_t d = nibble(a1, win);
    if (d) {
      U256 gx, gy;
      load(gx, kGx[d]);
      load(gy, kGy[d]);
      if (na1) fp_neg(gy, gy);
      point_add_affine(acc, gx, gy);
    }
    d = nibble(a2, win);
    if (d) {
      U256 gx, gy;
      load(gx, kGBetaX[d]);
      load(gy, kGy[d]);
      if (na2) fp_neg(gy, gy);
      point_add_affine(acc, gx, gy);
    }
    d = nibble(b1, win);
    if (d) {
      Jac q = qtab[d];
      if (nb1) fp_neg(q.y, q.y);
      point_add(acc, q);
    }
    d = nibble(b2, win);
    if (d) {
      Jac q = qtab[d];
      fp_mul(q.x, q.x, beta);
      if (nb2) fp_neg(q.y, q.y);
      point_add(acc, q);
    }
  }
  ok = ok && !is_zero(acc.z);

  U256 zinv, zi2, qx, qy;
  fp_pow(zinv, acc.z, kExpInvP);
  fp_sqr(zi2, zinv);
  fp_mul(qx, acc.x, zi2);
  fp_mul(zi2, zi2, zinv);
  fp_mul(qy, acc.y, zi2);
  words_to_limbs(x_out, qx);
  words_to_limbs(y_out, qy);
  address_words(addr_out, qx, qy);
  return ok;
}

}  // namespace secp

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
secp256k1_recover_kernel(const int32_t* __restrict__ z, int z_width, const int32_t* __restrict__ r,
                         const int32_t* __restrict__ s, const int32_t* __restrict__ v,
                         int32_t* __restrict__ x_out, int32_t* __restrict__ y_out,
                         int32_t* __restrict__ addr_out, uint8_t* __restrict__ ok_out,
                         long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) {
    return;
  }
  ok_out[i] = secp::recover_lane(z + i * z_width, z_width == secp::kLimbs, r + i * secp::kLimbs,
                                 s + i * secp::kLimbs, v[i], x_out + i * secp::kLimbs,
                                 y_out + i * secp::kLimbs, addr_out + i * 5);
}

}  // namespace

// C entry point, bound with ctypes.  n lanes: z holds z_width (8 value
// words or 20 limbs) int32 per lane, r and s 20 limbs, v one int32; x_out and
// y_out get 20 limbs, addr_out 5 stream words, ok_out one byte (a torch.bool).
// Launches on `stream` (a cudaStream_t); returns the cudaError_t of the launch.
extern "C" int secp256k1_recover(const void* z, int z_width, const void* r, const void* s,
                                 const void* v, void* x_out, void* y_out, void* addr_out,
                                 void* ok_out, long long n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  secp256k1_recover_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), z_width, static_cast<const int32_t*>(r),
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(v),
      static_cast<int32_t*>(x_out), static_cast<int32_t*>(y_out),
      static_cast<int32_t*>(addr_out), static_cast<uint8_t*>(ok_out), n);
  return static_cast<int>(cudaGetLastError());
}

#else

// The same lanes on the host, one after another: the CPU tests' view of the
// kernel's arithmetic.  Not used by the port's wrappers.
extern "C" int secp256k1_recover_host(const int32_t* z, int z_width, const int32_t* r,
                                      const int32_t* s, const int32_t* v, int32_t* x_out,
                                      int32_t* y_out, int32_t* addr_out, uint8_t* ok_out,
                                      long long n) {
  for (long long i = 0; i < n; ++i) {
    ok_out[i] = secp::recover_lane(z + i * z_width, z_width == secp::kLimbs, r + i * secp::kLimbs,
                                   s + i * secp::kLimbs, v[i], x_out + i * secp::kLimbs,
                                   y_out + i * secp::kLimbs, addr_out + i * 5);
  }
  return 0;
}

#endif
