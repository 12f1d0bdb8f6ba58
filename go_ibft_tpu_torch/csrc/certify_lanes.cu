// The certification after the recovery: each lane's validity mask, and per
// phase the validator set's counted voting power against its threshold.
//
// Replaces what the JAX package's programs go_ibft_tpu/verify/batch.py::
// _certify_fn, _recover_fn and _round_fn compute after the recovery ladder,
// the parts go_ibft_tpu/ops/quorum.py::sig_checks_zw (its tail),
// membership_eq and power_reduce (and ops/quorum.py::round_certify's
// reductions).  For n lanes, the first `split` of them phase 0 and the rest
// phase 1 (phases in {0, 1, 2}; 0 is the mask alone, 1 one phase of all n):
//
//   mask[i]   = ok[i] & live[i] & addr[i] == claimed[i]
//               & any_v(table[v] == claimed[i])            (5 words each)
//   counted[v] = any_{i in phase}(mask[i] & table[v] == claimed[i])
//   lo, hi    = sum of counted plo, phi, each wrapping in 32 bits
//   hi += lo >> 16 (arithmetic, as jnp and torch shift an int32);
//   lo &= 0xFFFF
//   reached   = hi > thr_hi | (hi == thr_hi & lo >= thr_lo)
//
// Every equal row counts, not the first: a table may repeat an address with
// a nonzero power, and the JAX package sums every such row.  Since a row
// equal to claimed[i] makes lane i a member, mask[i] & table[v] ==
// claimed[i] is the signature check & table[v] == claimed[i], so a lane
// whose signature check fails is never compared with the table.
//
// What bounds it on an H100: per checked lane one comparison with each table
// row (a word, four more where the first word is equal), against 42 B read
// a lane and 28 B a row: at the main path's buckets (up to 2 x 2,048 lanes
// and 2,048 rows, 8.4e6 row comparisons) operations, though the card's
// integer rate makes even that a few microseconds; at 100 validators (256
// lanes, 128 rows) the launch itself.  The design is the simple one:
//
// * One block of 1,024 threads a phase (the counted set and the sums stay in
//   the block: no second pass, no atomics, no scratch in device memory); a
//   thread takes lanes i = begin + t, t + 1,024, ...  The mask alone
//   (phases = 0) runs blocks of 256 lanes, a lane a thread, and stops at the
//   first equal row.
// * The table goes through shared memory in tiles of 2,048 rows, word-major
//   (word k of row r at k * 2,048 + r), so a thread reads the first words of
//   four rows in one 16-byte load, all threads of a warp the same four.
//   Equal rows set a byte of the tile's counted set (every writer writes 1);
//   after the tile the threads sum the counted rows' powers, and one block
//   reduction (shuffles, then a word a warp) ends the phase.
//
// The lane code also compiles with a host C++ compiler (lane.cuh):
// certify_lanes_host runs the same functions, a phase's lanes one after the
// other, and the CPU tests hold it against the plain version and the JAX
// package.

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#include <cstdint>

#include "lane.cuh"

namespace certify {

constexpr int kWords = 5;      // an address: 5 stream words
constexpr int kTile = 2048;    // table rows in shared memory at once
constexpr int kPhaseThreads = 1024;
constexpr int kMaskThreads = 256;
constexpr int kMaxPhases = 2;

// A phase: lanes [begin, end) and its threshold, by value or, where `*_at`
// is not null, read from that int32 on the card.
struct Phase {
  long long begin, end;
  long long thr_lo, thr_hi;
  const int32_t* thr_lo_at;
  const int32_t* thr_hi_at;
};

struct Phases {
  Phase p[kMaxPhases];
};

struct Lanes {
  const int32_t* addr;     // (n, 5) recovered addresses, unspecified where !ok
  const uint8_t* ok;       // (n,) recovery succeeded (torch.bool)
  const int32_t* claimed;  // (n, 5) claimed addresses
  const uint8_t* live;     // (n,)
  const int32_t* table;    // (rows, 5) validator addresses
  const int32_t* plo;      // (rows,) power halves, low 16 bits
  const int32_t* phi;      // (rows,) and high
  long long rows;
  uint8_t* mask;           // (n,) out
};

// The recovery succeeded, the lane is live and the recovered address is
// the claimed one (the tail of sig_checks_zw).  addr is only read where ok.
LANE_FN bool signed_by_claimed(const Lanes& l, long long i) {
  if (!l.ok[i] || !l.live[i]) {
    return false;
  }
  bool same = true;
  for (int k = 0; k < kWords; ++k) {
    same &= l.addr[i * kWords + k] == l.claimed[i * kWords + k];
  }
  return same;
}

// Row r of the table into a word-major tile.
LANE_FN void stage_row(const Lanes& l, long long first_row, int r, int32_t* tile) {
  for (int k = 0; k < kWords; ++k) {
    tile[k * kTile + r] = l.table[(first_row + r) * kWords + k];
  }
}

LANE_FN void load4(const int32_t* p, int32_t out[4]) {
#if defined(__CUDA_ARCH__)
  const int4 v = *reinterpret_cast<const int4*>(p);  // p is 16-byte aligned
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
#else
  for (int j = 0; j < 4; ++j) {
    out[j] = p[j];
  }
#endif
}

LANE_FN bool rest_equal(const int32_t* tile, int r, const int32_t c[kWords]) {
  bool same = true;
  for (int k = 1; k < kWords; ++k) {
    same &= tile[k * kTile + r] == c[k];
  }
  return same;
}

// Compare the address c with the tile's rows [0, rows): whether one is
// equal.  With `counted`, every equal row sets its byte; without, the scan
// stops at the first equal row.
LANE_FN bool scan_tile(const int32_t* tile, int rows, const int32_t c[kWords], uint8_t* counted) {
  bool member = false;
  int r = 0;
  for (; r + 4 <= rows; r += 4) {
    int32_t w0[4];
    load4(tile + r, w0);
    for (int j = 0; j < 4; ++j) {
      if (w0[j] == c[0] && rest_equal(tile, r + j, c)) {
        member = true;
        if (counted != nullptr) {
          counted[r + j] = 1;
        }
      }
    }
    if (member && counted == nullptr) {
      return true;
    }
  }
  for (; r < rows; ++r) {
    if (tile[r] == c[0] && rest_equal(tile, r, c)) {
      member = true;
      if (counted == nullptr) {
        return true;
      }
      counted[r] = 1;
    }
  }
  return member;
}

// Lane i against one tile: sets mask[i] where it is a member.
LANE_FN void check_lane(const Lanes& l, long long i, const int32_t* tile, int rows,
                        uint8_t* counted) {
  if (!signed_by_claimed(l, i)) {
    return;
  }
  int32_t c[kWords];
  for (int k = 0; k < kWords; ++k) {
    c[k] = l.claimed[i * kWords + k];
  }
  if (scan_tile(tile, rows, c, counted)) {
    l.mask[i] = 1;
  }
}

struct Verdict {
  int32_t lo, hi;
  bool reached;
};

// The carry fold and the compare of power_reduce on the 32-bit sums.
// Signed overflow is undefined in C++, so the sums wrap as uint32 and the
// shift brings in the sign bits by hand.
LANE_FN Verdict fold(uint32_t lo_sum, uint32_t hi_sum, long long thr_lo, long long thr_hi) {
  const uint32_t carry = (lo_sum >> 16) | ((lo_sum & 0x80000000u) ? 0xFFFF0000u : 0u);
  const auto hi = static_cast<int32_t>(hi_sum + carry);
  const auto lo = static_cast<int32_t>(lo_sum & 0xFFFFu);
  return {lo, hi, hi > thr_hi || (hi == thr_hi && lo >= thr_lo)};
}

}  // namespace certify

#if defined(__CUDACC__)

namespace {

using namespace certify;

// kCount: block b runs phase b; else block b checks lanes b * 256 + t alone.
template <bool kCount>
__global__ void __launch_bounds__(kCount ? kPhaseThreads : kMaskThreads)
    certify_lanes_kernel(Lanes l, long long n, Phases phases, uint8_t* reached, int32_t* lo_out,
                         int32_t* hi_out) {
  __shared__ __align__(16) int32_t tile[kWords * kTile];
  __shared__ uint8_t counted[kCount ? kTile : 1];
  __shared__ uint32_t part[2][kPhaseThreads / 32];
  long long first, last, step;
  if (kCount) {
    first = phases.p[blockIdx.x].begin + threadIdx.x;
    last = phases.p[blockIdx.x].end;
    step = blockDim.x;
  } else {
    first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    last = first < n ? first + 1 : first;
    step = 1;
  }
  for (long long i = first; i < last; i += step) {
    l.mask[i] = 0;
  }
  uint32_t lo = 0, hi = 0;
  for (long long t0 = 0; t0 < l.rows; t0 += kTile) {
    const int rows = static_cast<int>(l.rows - t0 < kTile ? l.rows - t0 : kTile);
    __syncthreads();  // the last tile's readers are done
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      stage_row(l, t0, r, tile);
      if (kCount) {
        counted[r] = 0;
      }
    }
    __syncthreads();
    for (long long i = first; i < last; i += step) {
      if (kCount || !l.mask[i]) {
        check_lane(l, i, tile, rows, kCount ? counted : nullptr);
      }
    }
    if (kCount) {
      __syncthreads();
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        if (counted[r]) {
          lo += static_cast<uint32_t>(l.plo[t0 + r]);
          hi += static_cast<uint32_t>(l.phi[t0 + r]);
        }
      }
    }
  }
  if (!kCount) {
    return;
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo += __shfl_down_sync(0xFFFFFFFFu, lo, off);
    hi += __shfl_down_sync(0xFFFFFFFFu, hi, off);
  }
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = lo;
    part[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (unsigned w = 1; w < blockDim.x / 32; ++w) {
      lo += part[0][w];
      hi += part[1][w];
    }
    const Phase& p = phases.p[blockIdx.x];
    const long long thr_lo = p.thr_lo_at != nullptr ? *p.thr_lo_at : p.thr_lo;
    const long long thr_hi = p.thr_hi_at != nullptr ? *p.thr_hi_at : p.thr_hi;
    const Verdict v = fold(lo, hi, thr_lo, thr_hi);
    reached[blockIdx.x] = v.reached;
    lo_out[blockIdx.x] = v.lo;
    hi_out[blockIdx.x] = v.hi;
  }
}

}  // namespace

// C entry point, bound with ctypes.  n lanes: addr and claimed 5 int32 a
// lane, ok and live one byte (torch.bool); the table `rows` x 5 int32 with
// its power halves plo and phi; `phases` in {0, 1, 2}, phase 0 the first
// `split` lanes (all n where phases is 1).  thr_values holds, on the host,
// (thr_lo, thr_hi) as long long for each phase; thr_at, on the host, a
// pointer for each of those values, to an int32 on the card that is read
// in its place, or null.  mask gets n bytes; reached (bytes), lo and hi
// (int32) one entry a phase.  Launches on `stream`; returns the cudaError_t
// of the launch.  n <= 0 launches nothing.
extern "C" int certify_lanes(const void* addr, const void* ok, const void* claimed, const void* live,
                             long long n, const void* table, const void* plo, const void* phi,
                             long long rows, int phases, long long split, const void* thr_values,
                             const void* thr_at, void* mask, void* reached, void* lo, void* hi,
                             void* stream) {
  if (n <= 0) {
    return 0;
  }
  if (phases < 0 || phases > kMaxPhases || split < 0 || split > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Lanes l{static_cast<const int32_t*>(addr),  static_cast<const uint8_t*>(ok),
                static_cast<const int32_t*>(claimed), static_cast<const uint8_t*>(live),
                static_cast<const int32_t*>(table), static_cast<const int32_t*>(plo),
                static_cast<const int32_t*>(phi),   rows,
                static_cast<uint8_t*>(mask)};
  const auto* values = static_cast<const long long*>(thr_values);
  const auto* at = static_cast<const int32_t* const*>(thr_at);
  Phases ph{};
  for (int p = 0; p < phases; ++p) {
    ph.p[p] = {p == 0 ? 0 : split, phases == 1 || p == 1 ? n : split, values[2 * p],
               values[2 * p + 1], at[2 * p], at[2 * p + 1]};
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (phases == 0) {
    const long long blocks = (n + kMaskThreads - 1) / kMaskThreads;
    certify_lanes_kernel<false><<<static_cast<unsigned int>(blocks), kMaskThreads, 0, s>>>(
        l, n, ph, nullptr, nullptr, nullptr);
  } else {
    certify_lanes_kernel<true><<<phases, kPhaseThreads, 0, s>>>(
        l, n, ph, static_cast<uint8_t*>(reached), static_cast<int32_t*>(lo),
        static_cast<int32_t*>(hi));
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // a host compiler: the same lane code, for the CPU tests

#include <vector>

// The contract of certify_lanes on host memory, thresholds by value only:
// a phase's lanes one after the other against each tile.
extern "C" int certify_lanes_host(const int32_t* addr, const uint8_t* ok, const int32_t* claimed,
                                  const uint8_t* live, long long n, const int32_t* table,
                                  const int32_t* plo, const int32_t* phi, long long rows,
                                  int phases, long long split, const long long* thr_values,
                                  uint8_t* mask, uint8_t* reached, int32_t* lo_out,
                                  int32_t* hi_out) {
  using namespace certify;
  if (n <= 0) {
    return 0;
  }
  if (phases < 0 || phases > kMaxPhases || split < 0 || split > n) {
    return 1;
  }
  const Lanes l{addr, ok, claimed, live, table, plo, phi, rows, mask};
  std::vector<int32_t> tile(kWords * kTile);
  std::vector<uint8_t> counted(kTile);
  for (int p = 0; p < (phases == 0 ? 1 : phases); ++p) {
    const long long begin = p == 0 ? 0 : split;
    const long long end = phases <= 1 || p == 1 ? n : split;
    uint8_t* cnt = phases == 0 ? nullptr : counted.data();
    for (long long i = begin; i < end; ++i) {
      mask[i] = 0;
    }
    uint32_t lo = 0, hi = 0;
    for (long long t0 = 0; t0 < rows; t0 += kTile) {
      const int tile_rows = static_cast<int>(rows - t0 < kTile ? rows - t0 : kTile);
      for (int r = 0; r < tile_rows; ++r) {
        stage_row(l, t0, r, tile.data());
        counted[r] = 0;
      }
      for (long long i = begin; i < end; ++i) {
        if (cnt != nullptr || !mask[i]) {
          check_lane(l, i, tile.data(), tile_rows, cnt);
        }
      }
      for (int r = 0; r < tile_rows && cnt != nullptr; ++r) {
        if (counted[r]) {
          lo += static_cast<uint32_t>(plo[t0 + r]);
          hi += static_cast<uint32_t>(phi[t0 + r]);
        }
      }
    }
    if (cnt != nullptr) {
      const Verdict v = fold(lo, hi, thr_values[2 * p], thr_values[2 * p + 1]);
      reached[p] = v.reached;
      lo_out[p] = v.lo;
      hi_out[p] = v.hi;
    }
  }
  return 0;
}

#endif
