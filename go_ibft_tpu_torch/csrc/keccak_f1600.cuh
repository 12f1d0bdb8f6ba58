// Keccak-f[1600] on one state held in registers, shared by the kernels of
// keccak_f1600.cu (the bare permutation and the keccak-256 sponge) and by
// secp256k1_recover.cu (the address hash in the recovery's epilogue).
//
// The function the JAX package's Pallas kernel computes
// (go_ibft_tpu/ops/pallas_keccak.py::_keccak_f_kernel): 24 rounds on a
// 1600-bit state.  25 uint64_t lanes, lane index x + 5*y; all 24 rounds
// unrolled so that every array index is a compile-time constant and the
// state stays in registers; rho offsets as template arguments so that each
// rotate compiles to funnel shifts; round constants in __constant__ memory.
#pragma once

#include "lane.cuh"

namespace keccak {

LANE_TABLE uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

template <int N>
LANE_FN uint64_t rotl(uint64_t x) {
  if constexpr (N == 0) {
    return x;
  } else {
    return (x << N) | (x >> (64 - N));
  }
}

LANE_FN void permute(uint64_t a[25]) {
  uint64_t b[25];
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    // theta
    const uint64_t c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
    const uint64_t c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
    const uint64_t c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
    const uint64_t c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
    const uint64_t c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
    const uint64_t d0 = c4 ^ rotl<1>(c1);
    const uint64_t d1 = c0 ^ rotl<1>(c2);
    const uint64_t d2 = c1 ^ rotl<1>(c3);
    const uint64_t d3 = c2 ^ rotl<1>(c4);
    const uint64_t d4 = c3 ^ rotl<1>(c0);
    a[0] ^= d0; a[1] ^= d1; a[2] ^= d2; a[3] ^= d3; a[4] ^= d4;
    a[5] ^= d0; a[6] ^= d1; a[7] ^= d2; a[8] ^= d3; a[9] ^= d4;
    a[10] ^= d0; a[11] ^= d1; a[12] ^= d2; a[13] ^= d3; a[14] ^= d4;
    a[15] ^= d0; a[16] ^= d1; a[17] ^= d2; a[18] ^= d3; a[19] ^= d4;
    a[20] ^= d0; a[21] ^= d1; a[22] ^= d2; a[23] ^= d3; a[24] ^= d4;
    // rho + pi: B[y, 2x+3y] = rotl(A[x, y], r[x][y])
    b[0] = rotl<0>(a[0]);
    b[16] = rotl<36>(a[5]);
    b[7] = rotl<3>(a[10]);
    b[23] = rotl<41>(a[15]);
    b[14] = rotl<18>(a[20]);
    b[10] = rotl<1>(a[1]);
    b[1] = rotl<44>(a[6]);
    b[17] = rotl<10>(a[11]);
    b[8] = rotl<45>(a[16]);
    b[24] = rotl<2>(a[21]);
    b[20] = rotl<62>(a[2]);
    b[11] = rotl<6>(a[7]);
    b[2] = rotl<43>(a[12]);
    b[18] = rotl<15>(a[17]);
    b[9] = rotl<61>(a[22]);
    b[5] = rotl<28>(a[3]);
    b[21] = rotl<55>(a[8]);
    b[12] = rotl<25>(a[13]);
    b[3] = rotl<21>(a[18]);
    b[19] = rotl<56>(a[23]);
    b[15] = rotl<27>(a[4]);
    b[6] = rotl<20>(a[9]);
    b[22] = rotl<39>(a[14]);
    b[13] = rotl<8>(a[19]);
    b[4] = rotl<14>(a[24]);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      a[y + 0] = b[y + 0] ^ (~b[y + 1] & b[y + 2]);
      a[y + 1] = b[y + 1] ^ (~b[y + 2] & b[y + 3]);
      a[y + 2] = b[y + 2] ^ (~b[y + 3] & b[y + 4]);
      a[y + 3] = b[y + 3] ^ (~b[y + 4] & b[y + 0]);
      a[y + 4] = b[y + 4] ^ (~b[y + 0] & b[y + 1]);
    }
    // iota
    a[0] ^= kRoundConstants[r];
  }
}

}  // namespace keccak
