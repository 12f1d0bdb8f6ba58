// Keccak on the card: the bare permutation and the keccak-256 sponge.
//
// keccak_f1600 replaces the JAX package's one Pallas kernel,
// go_ibft_tpu/ops/pallas_keccak.py::_keccak_f_kernel (launched through
// _keccak_f_rows' pl.pallas_call): 24 rounds of Keccak-f[1600] on each state
// of a batch.  keccak256_sponge replaces the XLA absorb loop around it,
// go_ibft_tpu/ops/keccak.py::keccak256_blocks: a multi-block absorb of
// pre-padded 136-byte rate blocks with a per-message block count, ending in
// the 32-byte digest.  Neither carries over the TPU kernel's (50, B) row
// layout, which put the batch on the TPU's 128-wide lane axis: here one
// thread owns one state, 25 uint64_t lanes in registers (keccak_f1600.cuh).
//
// Layout: the port keeps 64-bit lanes as int32 pairs, low half first.  On a
// little-endian card a (B, 25, 2) int32 state is byte for byte a (B, 25)
// uint64 array, a (B, nb, 17, 2) block tensor a (B, nb, 17) array of rate
// lanes, and the (B, 8) int32 digest of stream words the first 4 lanes of
// each final state; the wrappers pass the tensors' storage as they are.
//
// What bounds them on an H100: per state about 1.5e4 32-bit integer
// operations per permutation against 400 B moved (bare permutation) or
// 136 B read per absorbed block (sponge).  At the main path's batches of
// 128..1024 messages only 1..8 blocks of 128 threads run, so both kernels are
// bound by one thread's 24-round dependency chain and the launch, not by
// memory.  Loads and stores are coalesced: each block stages its states (or
// the current rate block of its messages) through shared memory, so that
// neighbouring threads touch neighbouring words of device memory.  The
// sponge keeps the state in registers across all blocks of a message, one
// launch per batch; a message stops absorbing after its own block count,
// which gives the JAX package's per-block select with no select.

#include <cuda_runtime.h>

#include "keccak_f1600.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStateLanes = 25;
constexpr int kRateLanes = 17;
constexpr int kDigestLanes = 4;

__global__ void __launch_bounds__(kThreads)
keccak_f1600_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                    long long n) {
  __shared__ uint64_t tile[kThreads * kStateLanes];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads), n - base));
  const int tid = threadIdx.x;
  const uint64_t* src = in + base * kStateLanes;
  for (int k = tid; k < rows * kStateLanes; k += kThreads) {
    tile[k] = src[k];
  }
  __syncthreads();
  if (tid < rows) {
    uint64_t a[kStateLanes];
#pragma unroll
    for (int i = 0; i < kStateLanes; ++i) {
      a[i] = tile[tid * kStateLanes + i];
    }
    keccak::permute(a);
#pragma unroll
    for (int i = 0; i < kStateLanes; ++i) {
      tile[tid * kStateLanes + i] = a[i];
    }
  }
  __syncthreads();
  uint64_t* dst = out + base * kStateLanes;
  for (int k = tid; k < rows * kStateLanes; k += kThreads) {
    dst[k] = tile[k];
  }
}

__global__ void __launch_bounds__(kThreads)
keccak256_sponge_kernel(const uint64_t* __restrict__ blocks,
                        const int32_t* __restrict__ num_blocks,
                        uint64_t* __restrict__ out, long long n, int nb) {
  __shared__ uint64_t tile[kThreads * kRateLanes];
  const long long base = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads), n - base));
  const int tid = threadIdx.x;
  const int mine = tid < rows ? num_blocks[base + tid] : 0;
  uint64_t a[kStateLanes];
#pragma unroll
  for (int i = 0; i < kStateLanes; ++i) {
    a[i] = 0;
  }
  for (int j = 0; j < nb; ++j) {
    // Stop when no message of this block absorbs block j or any later one.
    if (!__syncthreads_or(j < mine)) {
      break;
    }
    // Stage rate block j of this block's messages: 136 contiguous bytes each.
    for (int k = tid; k < rows * kRateLanes; k += kThreads) {
      const int m = k / kRateLanes;
      const int lane = k - m * kRateLanes;
      tile[k] = blocks[((base + m) * nb + j) * kRateLanes + lane];
    }
    __syncthreads();
    if (j < mine) {
#pragma unroll
      for (int i = 0; i < kRateLanes; ++i) {
        a[i] ^= tile[tid * kRateLanes + i];
      }
      keccak::permute(a);
    }
  }
  __syncthreads();
  if (tid < rows) {
#pragma unroll
    for (int i = 0; i < kDigestLanes; ++i) {
      tile[tid * kDigestLanes + i] = a[i];
    }
  }
  __syncthreads();
  uint64_t* dst = out + base * kDigestLanes;
  for (int k = tid; k < rows * kDigestLanes; k += kThreads) {
    dst[k] = tile[k];
  }
}

int grid_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// C entry points, bound with ctypes.  Each launches on `stream` (a
// cudaStream_t) and returns the cudaError_t of the launch, 0 on success.

// `in` and `out` hold n states of 25 uint64_t each.
extern "C" int keccak_f1600(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  keccak_f1600_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// `blocks` holds n messages of nb rate blocks of 17 uint64_t lanes each,
// `num_blocks` n int32 counts (a message absorbs its first
// clamp(count, 0, nb) blocks), `out` n digests of 4 uint64_t lanes.
extern "C" int keccak256_sponge(const void* blocks, const void* num_blocks, void* out,
                                long long n, int nb, void* stream) {
  if (n <= 0) {
    return 0;
  }
  keccak256_sponge_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(blocks), static_cast<const int32_t*>(num_blocks),
      static_cast<uint64_t*>(out), n, nb);
  return static_cast<int>(cudaGetLastError());
}
