// Keccak-f[1600] on a batch of states, one thread per state.
//
// Replaces the JAX package's one Pallas kernel,
// go_ibft_tpu/ops/pallas_keccak.py::_keccak_f_kernel (launched through
// _keccak_f_rows' pl.pallas_call).  It computes the same function: 24 rounds
// of Keccak-f[1600] on each 1600-bit state.  It does not carry over the TPU
// kernel's (50, B) row layout, which existed to put the batch on the TPU's
// 128-wide lane axis; here each thread holds its own state.
//
// Layout: the port keeps a state as a contiguous (B, 25, 2) int32 tensor of
// uint32 halves, low half first.  On a little-endian card that is byte for
// byte the (B, 25) uint64 array this kernel reads, so the wrapper passes the
// tensor's storage with no transpose or copy.
//
// Design: 25 uint64_t lanes per thread in registers (array indices are all
// compile-time constants after unrolling), all 24 rounds unrolled, round
// constants in __constant__ memory, rho offsets as template arguments so that
// each rotate compiles to funnel shifts.  128 threads per block, a grid of
// ceil(B / 128), the ragged tail masked by idx < n.
//
// What bounds it on an H100: about 10^4 32-bit integer operations and 400 B in
// plus 400 B out per state.  At the main path's B = 128..256 that is far below
// a microsecond of either resource, so the kernel is launch-latency-bound.
// Loads and stores are strided by 200 B between neighbouring threads; a later
// change can coalesce them through shared memory for large batches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

constexpr int kThreads = 128;

template <int N>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  if constexpr (N == 0) {
    return x;
  } else {
    return (x << N) | (x >> (64 - N));
  }
}

__global__ void __launch_bounds__(kThreads)
keccak_f1600_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                    long long n) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) {
    return;
  }
  const uint64_t* src = in + idx * 25;
  uint64_t a[25];
  uint64_t b[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    a[i] = src[i];
  }
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
    a[0] = b[0] ^ (~b[1] & b[2]);
    a[1] = b[1] ^ (~b[2] & b[3]);
    a[2] = b[2] ^ (~b[3] & b[4]);
    a[3] = b[3] ^ (~b[4] & b[0]);
    a[4] = b[4] ^ (~b[0] & b[1]);
    a[5] = b[5] ^ (~b[6] & b[7]);
    a[6] = b[6] ^ (~b[7] & b[8]);
    a[7] = b[7] ^ (~b[8] & b[9]);
    a[8] = b[8] ^ (~b[9] & b[5]);
    a[9] = b[9] ^ (~b[5] & b[6]);
    a[10] = b[10] ^ (~b[11] & b[12]);
    a[11] = b[11] ^ (~b[12] & b[13]);
    a[12] = b[12] ^ (~b[13] & b[14]);
    a[13] = b[13] ^ (~b[14] & b[10]);
    a[14] = b[14] ^ (~b[10] & b[11]);
    a[15] = b[15] ^ (~b[16] & b[17]);
    a[16] = b[16] ^ (~b[17] & b[18]);
    a[17] = b[17] ^ (~b[18] & b[19]);
    a[18] = b[18] ^ (~b[19] & b[15]);
    a[19] = b[19] ^ (~b[15] & b[16]);
    a[20] = b[20] ^ (~b[21] & b[22]);
    a[21] = b[21] ^ (~b[22] & b[23]);
    a[22] = b[22] ^ (~b[23] & b[24]);
    a[23] = b[23] ^ (~b[24] & b[20]);
    a[24] = b[24] ^ (~b[20] & b[21]);
    // iota
    a[0] ^= kRoundConstants[r];
  }
  uint64_t* dst = out + idx * 25;
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    dst[i] = a[i];
  }
}

}  // namespace

// C entry point, bound with ctypes.  `in` and `out` hold n states of 25
// uint64_t each; the launch goes on `stream` (a cudaStream_t).  Returns the
// cudaError_t of the launch, 0 on success.
extern "C" int keccak_f1600(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  keccak_f1600_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
