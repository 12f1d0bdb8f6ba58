// Keccak on the card: the bare permutation and the keccak-256 payload digest.
//
// keccak_f1600 replaces the JAX package's one Pallas kernel,
// go_ibft_tpu/ops/pallas_keccak.py::_keccak_f_kernel (launched through
// _keccak_f_rows' pl.pallas_call): 24 rounds of Keccak-f[1600] on each state
// of a batch, one thread per state, 25 uint64_t lanes in registers
// (keccak_f1600.cuh).
//
// keccak256_digest replaces the XLA program of the payload digests,
// go_ibft_tpu/ops/quorum.py::digest_words (go_ibft_tpu/ops/keccak.py::
// keccak256_blocks plus the byte-order epilogue): a multi-block absorb of
// pre-padded 136-byte rate blocks with a per-message block count, ending in
// the 32-byte digest, as stream words (keccak256_blocks) or as the
// little-endian value words digest_words returns, in one launch.
//
// Layout: the port keeps 64-bit lanes as int32 pairs, low half first.  On a
// little-endian card a (B, 25, 2) int32 state is byte for byte a (B, 25)
// uint64 array, a (B, nb, 17, 2) block tensor a (B, nb, 17) array of rate
// lanes, and the (B, 8) int32 digest of stream words the first 4 lanes of
// each final state; the wrappers pass the tensors' storage as they are.
//
// What bounds the digest on an H100: per absorbed block one permutation,
// about 4.7e3 SASS integer instructions in one thread, against 136 B read.
// At the main path's 128..1024 messages a few warps run, each alone on its
// scheduler, and one warp issues about one integer instruction every two
// cycles (16 integer lanes per scheduler), so the time is one message's
// chain of permutations, not memory and not the card's operation rate.
// The design cuts that chain (PERF.md §6 has every variant's time):
//
// * Each message's state is split over five threads of a warp, one column
//   each (keccak::group below): theta's parity is a thread's own, two
//   shuffles bring the neighbour columns' parities; pi turns the columns
//   into rows by ten shuffles, rho rotates each lane as it arrives, chi and
//   iota run on the row, and the rows go back to columns through shared
//   memory.  A thread issues about a fifth of the permutation's logic, and
//   the round is bound by the exchanges' latency.
// * The round loop is unrolled by 4 only, so the loop body stays in the
//   instruction cache.
// * Each thread loads its own words of the rate block straight from device
//   memory, with block j+1 in flight during block j's permutation: no
//   staging and no block-wide barrier.  Blocks of one warp spread the
//   messages over many SMs.
// * The epilogue writes the digest in either byte order from registers.
//
// A message absorbs its first clamp(count, 0, nb) blocks, which gives the
// JAX package's per-block select with no select.
//
// The digest's lane code also compiles with a host C++ compiler (lane.cuh):
// keccak256_digest_host runs the same step functions, a message's five
// threads one after the other, each shuffle a read of another thread's
// registers.  The CPU tests build this file with g++ and hold it against
// the JAX package.

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#include "keccak_f1600.cuh"

namespace keccak {
namespace group {

// Five threads of a warp hold one message's state.  Between rounds thread
// x of the group holds column x, lanes (x, y) for y = 0..4, as s[2y] (low
// half) and s[2y + 1] (high half); during chi thread y holds row y, lanes
// (x, y) for x = 0..4, in the same order.  Columns become rows by
// shuffles (pi: row y's lane x comes from column (3y + x) mod 5, slot x,
// the same register in every source thread), rows become columns through
// shared memory.

constexpr int kLanes = 5;
constexpr int kWords = 2 * kLanes;  // one column or row
constexpr int kStateWords = 5 * kWords;

// rho's offsets, [x][y] (keccak_f1600.cuh's rotl<> arguments).
LANE_TABLE int kRho[5][5] = {
    {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14},
};

// The column that row t's slot x comes from.
LANE_FN int pi_source(int t, int x) { return (3 * t + x) % 5; }

// The upper 32 bits of (hi:lo) << (s mod 32).
LANE_FN uint32_t funnel(uint32_t lo, uint32_t hi, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, s);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32 | lo) << (s & 31)) >> 32);
#endif
}

// Theta's parity of this thread's column, both halves.
LANE_FN void parity(const uint32_t s[kWords], uint32_t c[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c[h] = s[h] ^ s[2 + h] ^ s[4 + h] ^ s[6 + h] ^ s[8 + h];
  }
}

// Theta's update, given the parities of columns x - 1 (cm) and x + 1 (cp).
LANE_FN void theta(uint32_t s[kWords], const uint32_t cm[2], const uint32_t cp[2]) {
  const uint32_t d_lo = cm[0] ^ funnel(cp[1], cp[0], 1);
  const uint32_t d_hi = cm[1] ^ funnel(cp[0], cp[1], 1);
#pragma unroll
  for (int y = 0; y < kLanes; ++y) {
    s[2 * y] ^= d_lo;
    s[2 * y + 1] ^= d_hi;
  }
}

// rho on one lane as it arrives in its row: rotl64((hi:lo), offset).  An
// offset of 32 or more swaps the halves first, then both take the offset
// mod 32.
LANE_FN void rho(uint32_t lo, uint32_t hi, int offset, uint32_t& out_lo, uint32_t& out_hi) {
  const bool swap = offset >= 32;
  const uint32_t l = swap ? hi : lo;
  const uint32_t h = swap ? lo : hi;
  out_lo = funnel(h, l, offset);
  out_hi = funnel(l, h, offset);
}

// chi on a row, then iota (rc is zero except in row 0).
LANE_FN void chi_iota(const uint32_t b[kWords], uint32_t s[kWords], uint32_t rc_lo,
                      uint32_t rc_hi) {
#pragma unroll
  for (int x = 0; x < kLanes; ++x) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[2 * x + h] = b[2 * x + h] ^ (~b[2 * ((x + 1) % 5) + h] & b[2 * ((x + 2) % 5) + h]);
    }
  }
  s[0] ^= rc_lo;
  s[1] ^= rc_hi;
}

// One lane's halves to and from shared memory, as one 8-byte access on
// the card.
LANE_FN void load2(const uint32_t* p, uint32_t& lo, uint32_t& hi) {
#if defined(__CUDA_ARCH__)
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  lo = v.x;
  hi = v.y;
#else
  lo = p[0];
  hi = p[1];
#endif
}

LANE_FN void store2(uint32_t* p, uint32_t lo, uint32_t hi) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
#else
  p[0] = lo;
  p[1] = hi;
#endif
}

// Row t into the column buffer, and column t back out of it.
LANE_FN void to_columns(const uint32_t s[kWords], int t, uint32_t* cols) {
#pragma unroll
  for (int x = 0; x < kLanes; ++x) {
    store2(cols + x * kWords + 2 * t, s[2 * x], s[2 * x + 1]);
  }
}

LANE_FN void from_columns(const uint32_t* cols, int t, uint32_t s[kWords]) {
#pragma unroll
  for (int y = 0; y < kLanes; ++y) {
    load2(cols + t * kWords + 2 * y, s[2 * y], s[2 * y + 1]);
  }
}

LANE_FN uint32_t round_constant(int r, int half) {
  const uint64_t rc = kRoundConstants[r];
  return half ? static_cast<uint32_t>(rc >> 32) : static_cast<uint32_t>(rc);
}

#if defined(__CUDACC__)
// Keccak-f[1600] on the group's state.  Every thread of the warp runs it
// (full-warp shuffles and __syncwarp).  `base` is the group's first lane,
// `cols` its column buffer, `iota` all ones in the thread of row 0, else
// zero.  The round loop is unrolled by kRoundUnroll, the fastest factor
// measured at both 2 and 32 blocks.
constexpr int kRoundUnroll = 4;

__device__ __forceinline__ void permute(uint32_t s[kWords], int t, int base, uint32_t iota,
                                        uint32_t* cols) {
  int from[kLanes], offset[kLanes];
#pragma unroll
  for (int x = 0; x < kLanes; ++x) {
    from[x] = base + pi_source(t, x);
    offset[x] = kRho[pi_source(t, x)][x];
  }
  const int down = base + (t + 4) % 5;
  const int up = base + (t + 1) % 5;
#pragma unroll kRoundUnroll
  for (int r = 0; r < 24; ++r) {
    uint32_t c[2], cm[2], cp[2], b[kWords];
    parity(s, c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cm[h] = __shfl_sync(0xffffffffu, c[h], down);
      cp[h] = __shfl_sync(0xffffffffu, c[h], up);
    }
    theta(s, cm, cp);
#pragma unroll
    for (int x = 0; x < kLanes; ++x) {
      const uint32_t lo = __shfl_sync(0xffffffffu, s[2 * x], from[x]);
      const uint32_t hi = __shfl_sync(0xffffffffu, s[2 * x + 1], from[x]);
      rho(lo, hi, offset[x], b[2 * x], b[2 * x + 1]);
    }
    chi_iota(b, s, round_constant(r, 0) & iota, round_constant(r, 1) & iota);
    __syncwarp();
    to_columns(s, t, cols);
    __syncwarp();
    from_columns(cols, t, s);
  }
}

#else
// The same permutation on the host: the group's five threads in turn
// between exchanges, each shuffle a read of the other threads' registers.
inline void permute_host(uint32_t s[5][kWords]) {
  uint32_t cols[kStateWords], c[5][2], after_theta[5][kWords], b[kWords];
  for (int r = 0; r < 24; ++r) {
    for (int t = 0; t < 5; ++t) {
      parity(s[t], c[t]);
    }
    for (int t = 0; t < 5; ++t) {
      theta(s[t], c[(t + 4) % 5], c[(t + 1) % 5]);
      for (int i = 0; i < kWords; ++i) {
        after_theta[t][i] = s[t][i];
      }
    }
    for (int t = 0; t < 5; ++t) {
      for (int x = 0; x < kLanes; ++x) {
        const uint32_t* src = after_theta[pi_source(t, x)];
        rho(src[2 * x], src[2 * x + 1], kRho[pi_source(t, x)][x], b[2 * x], b[2 * x + 1]);
      }
      const uint32_t iota = t == 0 ? ~0u : 0u;
      chi_iota(b, s[t], round_constant(r, 0) & iota, round_constant(r, 1) & iota);
    }
    for (int t = 0; t < 5; ++t) {
      to_columns(s[t], t, cols);
    }
    for (int t = 0; t < 5; ++t) {
      from_columns(cols, t, s[t]);
    }
  }
}
#endif

}  // namespace group

// The digest's byte orders.  Stream word 2i + h is half h of lane i.  The
// value words are the digest read as a big-endian integer, least
// significant word first: value word 7 - 2i - h is stream word 2i + h with
// its bytes reversed.
LANE_FN int digest_word(int lane, int half, bool value_words) {
  return value_words ? 7 - 2 * lane - half : 2 * lane + half;
}

LANE_FN uint32_t digest_bytes(uint32_t w, bool value_words) {
  if (!value_words) {
    return w;
  }
#if defined(__CUDA_ARCH__)
  return __byte_perm(w, 0, 0x0123);
#else
  return __builtin_bswap32(w);
#endif
}

}  // namespace keccak

namespace {

constexpr int kStateLanes = 25;
constexpr int kRateLanes = 17;
constexpr int kRateWords = 2 * kRateLanes;
constexpr int kDigestLanes = 4;
constexpr int kDigestWords = 2 * kDigestLanes;

LANE_FN int clamp_blocks(int32_t count, int nb) {
  return count < 0 ? 0 : (count > nb ? nb : count);
}

#if defined(__CUDACC__)

constexpr int kThreads = 128;    // keccak_f1600: one state per thread
constexpr int kDigestThreads = 32;  // keccak256_digest: one warp
constexpr int kGroupsPerWarp = 6;   // messages per warp, five threads each
constexpr int kGroupSlots = 7;      // with lanes 30 and 31

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

// One warp of 32 threads runs six messages, five threads each; lanes 30
// and 31 run as a seventh group with no message, so that every shuffle and
// __syncwarp names the full warp.
template <bool kValueWords>
__global__ void __launch_bounds__(kDigestThreads)
keccak256_digest_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ counts,
                        uint32_t* __restrict__ out, long long n, int nb) {
  using namespace keccak::group;
  __shared__ __align__(8) uint32_t cols[kGroupSlots * kStateWords];
  const int lane = threadIdx.x;
  const int g = lane / 5;
  const int t = lane - 5 * g;  // this thread's column
  const long long m = static_cast<long long>(blockIdx.x) * kGroupsPerWarp + g;
  const bool live = g < kGroupsPerWarp && m < n;
  const int mine = live ? clamp_blocks(counts[m], nb) : 0;
  const uint32_t iota = t == 0 ? ~0u : 0u;
  // Column t's rate lanes are t + 5y < 17: y = 0, 1, 2, and 3 for t < 2.
  const uint32_t* src = blocks + (live ? m : 0) * nb * kRateWords + 2 * t;
  const bool fourth = t < 2;
  uint32_t s[kWords], next[8], digest[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    s[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    next[i] = 0;
  }
  if (mine > 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (y < 3 || fourth) {
        next[2 * y] = __ldg(src + 10 * y);
        next[2 * y + 1] = __ldg(src + 10 * y + 1);
      }
    }
  }
  // The warp runs as many permutations as its longest message absorbs; a
  // message that absorbs fewer keeps its digest lanes from its last one.
  const int warp_blocks = __reduce_max_sync(0xffffffffu, mine);
  for (int j = 0; j < warp_blocks; ++j) {
    if (j < mine) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] ^= next[i];
      }
    }
    if (j + 1 < mine) {
      const uint32_t* blk = src + (j + 1) * kRateWords;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        if (y < 3 || fourth) {
          next[2 * y] = __ldg(blk + 10 * y);
          next[2 * y + 1] = __ldg(blk + 10 * y + 1);
        }
      }
    }
    permute(s, t, 5 * g, iota, cols + g * kStateWords);
    if (j + 1 == mine) {
      digest[0] = s[0];
      digest[1] = s[1];
    }
  }
  // Threads 0..3 of a group hold digest lanes (t, 0).
  if (live && t < kDigestLanes) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      out[m * kDigestWords + keccak::digest_word(t, h, kValueWords)] =
          keccak::digest_bytes(digest[h], kValueWords);
    }
  }
}

int grid_for(long long n, long long per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

#endif  // __CUDACC__

}  // namespace

#if defined(__CUDACC__)

// C entry points, bound with ctypes.  Each launches on `stream` (a
// cudaStream_t) and returns the cudaError_t of the launch, 0 on success.

// `in` and `out` hold n states of 25 uint64_t each.
extern "C" int keccak_f1600(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) {
    return 0;
  }
  keccak_f1600_kernel<<<grid_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// `blocks` holds n messages of nb rate blocks of 34 uint32 words each
// (17 lanes, low half first), `num_blocks` n int32 counts (a message absorbs
// its first clamp(count, 0, nb) blocks), `out` n digests of 8 uint32 words:
// value words if `value_words` is nonzero, else stream words.
extern "C" int keccak256_digest(const void* blocks, const void* num_blocks, void* out,
                                long long n, int nb, int value_words, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const auto* b = static_cast<const uint32_t*>(blocks);
  const auto* c = static_cast<const int32_t*>(num_blocks);
  auto* o = static_cast<uint32_t*>(out);
  const int grid = grid_for(n, kGroupsPerWarp);
  const auto s = static_cast<cudaStream_t>(stream);
  if (value_words) {
    keccak256_digest_kernel<true><<<grid, kDigestThreads, 0, s>>>(b, c, o, n, nb);
  } else {
    keccak256_digest_kernel<false><<<grid, kDigestThreads, 0, s>>>(b, c, o, n, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // a host compiler: the digest's lane code, for the CPU tests

// The same contract as keccak256_digest, on host memory.
extern "C" int keccak256_digest_host(const uint32_t* blocks, const int32_t* num_blocks,
                                     uint32_t* out, long long n, int nb, int value_words) {
  for (long long m = 0; m < n; ++m) {
    uint32_t s[5][keccak::group::kWords] = {};
    const int mine = clamp_blocks(num_blocks[m], nb);
    for (int j = 0; j < mine; ++j) {
      const uint32_t* blk = blocks + (m * nb + j) * kRateWords;
      for (int i = 0; i < kRateLanes; ++i) {  // lane i is (i mod 5, i / 5)
        s[i % 5][2 * (i / 5)] ^= blk[2 * i];
        s[i % 5][2 * (i / 5) + 1] ^= blk[2 * i + 1];
      }
      keccak::group::permute_host(s);
    }
    for (int i = 0; i < kDigestLanes; ++i) {
      for (int h = 0; h < 2; ++h) {
        out[m * kDigestWords + keccak::digest_word(i, h, value_words != 0)] =
            keccak::digest_bytes(s[i][h], value_words != 0);
      }
    }
  }
  return 0;
}

#endif
