// The certification after the recovery: each lane's validity mask, and per
// phase the validator set's counted voting power against its threshold.
//
// Replaces what the JAX package's programs go_ibft_tpu/verify/batch.py::
// _certify_fn, _recover_fn and _round_fn compute after the recovery ladder,
// the parts go_ibft_tpu/ops/quorum.py::sig_checks_zw (its tail),
// membership_eq and power_reduce (and ops/quorum.py::round_certify's
// reductions), and the reductions of go_ibft_tpu/parallel/mesh.py::_finish.
// For n lanes, the first `split` of them phase 0 and the rest phase 1
// (phases in {0, 1, 2}; 0 is the mask alone, 1 one phase of all n):
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
// and 2,048 rows, 8.4e6 row comparisons) operations, a fraction of a
// microsecond at the card's integer rate; at 100 validators (256 lanes,
// 128 rows) the launch and a few dependent memory and barrier latencies.
// So the design spreads a phase over as many SMs as it can without a
// second launch, atomics or scratch in device memory:
//
// * A phase runs on a thread-block cluster of 8 blocks (the portable
//   maximum; 8 SMs a phase instead of one).  The phase's lanes are split
//   into 8 contiguous runs, one a block, and every block stages the whole
//   table in shared memory (tiles of 2,048 rows, word-major: word k of row
//   r at k * 2,048 + r, so one 16-byte load brings the first words of four
//   rows).  A lane's mask is therefore final inside its block: one thread
//   writes it once a tile (the first tile's store also clears it), with no
//   separate zeroing pass.
// * Inside a block the threads form a 2-D map, lanes x row stripes: a lane
//   gets `stripes` consecutive threads of one warp (a power of two up to
//   32, as many as the block's threads allow for its lanes and the tile's
//   rows), each scanning every stripes-th group of four rows; the lane's
//   membership is an OR over its stripes (warp shuffles).  At 100
//   validators (16 lanes a block, 128 rows) a thread scans 8 rows; at the
//   worst bucket (256 lanes a block, 2,048 rows) every thread has a lane.
//   A group of four rows costs one shared load and four compares of the
//   first word; only a hit looks at the other four words.
// * Equal rows set a byte of the block's counted set (every writer writes
//   1).  After the tile, each block takes one eighth of the tile's rows and
//   ORs their counted bytes over the cluster through distributed shared
//   memory (map_shared_rank), adding the powers of the counted ones (loaded
//   into registers before the scan); a block reduction (shuffles, a word a
//   warp) leaves the block's two sums, which it stores into rank 0's shared
//   memory.  After one more cluster barrier rank 0 adds the 8 pairs, folds,
//   compares (its threshold, where read on the card, was loaded at the
//   start) and writes the verdict.  A phase of one tile is two cluster
//   barriers and two block barriers, whatever its lane count.
// * The mask alone (phases = 0) needs no reduction and no cluster: blocks
//   of 64 lanes on 256 threads in the same 2-D map (4 stripes a lane), each
//   stripe stopping at its first equal row.
//
// go_ibft_tpu_torch/bench/certify_variants.py times the alternatives on the
// card (256 or 1,024 threads a block, a cluster of 4, an unrolled scan) and
// the scan's and the cluster reduction's shares; PERF.md has the numbers.
// None of them is faster than 512 threads and 8 blocks at both rounds' shapes.
//
// The port's mesh (parallel/mesh.py) runs each lane shard's recovery on its
// own device and then ONE launch of this kernel on its first device over
// the gathered lanes and the whole table: the count needs every valid lane
// against every row in one place anyway, and that launch's mask is the
// sharded mask, so launches a shard would only repeat its work; a validator
// whose valid messages land in several lane shards, or whose address fills
// rows of several table shards, is thereby counted exactly as the JAX
// package's psums count it.
//
// The lane code also compiles with a host C++ compiler (lane.cuh):
// certify_lanes_host runs the same functions, with a cluster's blocks, and
// a block's lanes and stripes, one after the other, and the CPU tests hold
// it against the plain version and the JAX package.

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

#include <cstdint>

#include "lane.cuh"

namespace certify {

constexpr int kWords = 5;          // an address: 5 stream words
constexpr int kTile = 2048;        // table rows in shared memory at once
constexpr int kCluster = 8;        // blocks a phase
constexpr int kPhaseThreads = 512;
constexpr int kMaskThreads = 256;
constexpr int kMaskLanes = 64;     // lanes a block of the mask alone
constexpr int kMaxStripes = 32;    // a lane's stripes stay inside one warp
constexpr int kMaxPhases = 2;
constexpr int kSlice = (kTile + kCluster - 1) / kCluster;  // rows a block reduces
static_assert(kSlice <= kPhaseThreads, "a block reduces at most one row a thread");

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

LANE_FN long long min_ll(long long a, long long b) { return a < b ? a : b; }

// The run of lanes [first, last) of block `rank` of `blocks` that split the
// lanes [begin, end) into contiguous runs.
LANE_FN void block_lanes(long long begin, long long end, int rank, int blocks, long long* first,
                         long long* last) {
  const long long per = (end - begin + blocks - 1) / blocks;
  *first = min_ll(end, begin + rank * per);
  *last = min_ll(end, *first + per);
}

// The rows [r0, r1) of a tile of `rows` that block `rank` of a cluster reduces.
LANE_FN void slice_rows(int rows, int rank, int* r0, int* r1) {
  const int per = (rows + kCluster - 1) / kCluster;
  *r0 = rank * per < rows ? rank * per : rows;
  *r1 = *r0 + per < rows ? *r0 + per : rows;
}

// Row stripes a lane for `lanes` lanes on `threads` threads against a tile
// of `rows`: the largest power of two up to 32 that still gives every lane
// its stripes at once and every stripe two groups of four rows.
LANE_FN int stripes_for(long long lanes, int rows, int threads) {
  int s = 1;
  while (s < kMaxStripes && 2LL * s * lanes <= threads && 8 * s <= rows) {
    s *= 2;
  }
  return s;
}

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

// Stripe `stripe` of `stripes` of a tile of `rows`: the groups of four rows
// g = stripe, stripe + stripes, ..., then the tile's last rows % 4 rows one
// a stripe.  Whether the address c equals one of them; with `counted`,
// every equal row sets its byte, else the scan stops at the first.
LANE_FN bool scan_stripe(const int32_t* tile, int rows, const int32_t c[kWords], int stripe,
                         int stripes, uint8_t* counted) {
  bool member = false;
  const int groups = rows / 4;
  for (int g = stripe; g < groups; g += stripes) {
    int32_t w[4];
    load4(tile + 4 * g, w);
    if ((w[0] == c[0]) | (w[1] == c[0]) | (w[2] == c[0]) | (w[3] == c[0])) {
      for (int j = 0; j < 4; ++j) {
        if (w[j] == c[0] && rest_equal(tile, 4 * g + j, c)) {
          member = true;
          if (counted != nullptr) {
            counted[4 * g + j] = 1;
          }
        }
      }
      if (member && counted == nullptr) {
        return true;
      }
    }
  }
  for (int r = 4 * groups + stripe; r < rows; r += stripes) {
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

// Stripe `stripe` of lane i against one tile: whether the lane passes its
// signature check and its claimed address is among the stripe's rows.
LANE_FN bool lane_stripe(const Lanes& l, long long i, const int32_t* tile, int rows, int stripe,
                         int stripes, uint8_t* counted) {
  if (!signed_by_claimed(l, i)) {
    return false;
  }
  int32_t c[kWords];
  for (int k = 0; k < kWords; ++k) {
    c[k] = l.claimed[i * kWords + k];
  }
  return scan_stripe(tile, rows, c, stripe, stripes, counted);
}

// Lane i's mask after a tile: the first tile's store also clears it, a
// later tile only sets it.
LANE_FN void write_mask(const Lanes& l, long long i, bool member, bool first_tile) {
  if (first_tile || member) {
    l.mask[i] = member;
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

// Where a launch writes its outputs in one buffer: lo (P int32), hi (P
// int32), reached (P bytes), then the mask (n bytes).
struct Out {
  int32_t* lo;
  int32_t* hi;
  uint8_t* reached;
  uint8_t* mask;
};

inline Out out_views(void* base, int phases) {  // on the host, before the launch
  auto* bytes = static_cast<uint8_t*>(base);
  return {reinterpret_cast<int32_t*>(bytes), reinterpret_cast<int32_t*>(bytes + 4 * phases),
          bytes + 8 * phases, bytes + 9 * phases};
}

}  // namespace certify

#if defined(__CUDACC__)

namespace {

using namespace certify;
namespace cg = cooperative_groups;

// Lanes [first, last) of a block against its staged tile in the 2-D map:
// lane slot t / stripes, stripe t % stripes; stripe 0 writes the mask.
// Every thread runs the same number of rounds, so the shuffles see whole
// warps.
__device__ __forceinline__ void scan_block(const Lanes& l, long long first, long long last,
                                           const int32_t* tile, int rows, uint8_t* counted,
                                           bool first_tile) {
  const long long lanes = last - first;
  const int stripes = stripes_for(lanes, rows, blockDim.x);
  const int slots = blockDim.x / stripes;
  const int slot = threadIdx.x / stripes;
  const int stripe = threadIdx.x % stripes;
  for (long long base = 0; base < lanes; base += slots) {
    const long long i = first + base + slot;
    const bool have = base + slot < lanes;
    int member = have && lane_stripe(l, i, tile, rows, stripe, stripes, counted);
    for (int off = 1; off < stripes; off <<= 1) {
      member |= __shfl_xor_sync(0xFFFFFFFFu, member, off);
    }
    if (have && stripe == 0) {
      write_mask(l, i, member != 0, first_tile);
    }
  }
}

__device__ __forceinline__ void stage_tile(const Lanes& l, long long t0, int rows, int32_t* tile,
                                           uint8_t* counted) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    stage_row(l, t0, r, tile);
    if (counted != nullptr) {
      counted[r] = 0;
    }
  }
}

// Block b = phase * 8 + rank: rank `rank` of phase `phase`'s cluster.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kPhaseThreads)
    certify_lanes_count(Lanes l, Phases phases, Out out) {
  __shared__ __align__(16) int32_t tile[kWords * kTile];
  __shared__ uint8_t counted[kTile];
  __shared__ uint32_t warp_part[2][kPhaseThreads / 32];
  __shared__ uint32_t block_part[2][kCluster];  // rank 0's: each block's two sums
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int phase = blockIdx.x / kCluster;
  const Phase& p = phases.p[phase];
  long long thr_lo = p.thr_lo, thr_hi = p.thr_hi;
  if (rank == 0 && threadIdx.x == 0) {  // issued now, used at the end
    thr_lo = p.thr_lo_at != nullptr ? *p.thr_lo_at : thr_lo;
    thr_hi = p.thr_hi_at != nullptr ? *p.thr_hi_at : thr_hi;
  }
  long long first, last;
  block_lanes(p.begin, p.end, rank, kCluster, &first, &last);
  uint32_t lo = 0, hi = 0;
  for (long long t0 = 0; t0 < l.rows; t0 += kTile) {
    const int rows = static_cast<int>(min_ll(l.rows - t0, kTile));
    if (t0 > 0) {
      cluster.sync();  // every block has read the last tile's counted bytes
    }
    stage_tile(l, t0, rows, tile, counted);
    int r0, r1;
    slice_rows(rows, rank, &r0, &r1);
    const int r = r0 + static_cast<int>(threadIdx.x);
    const bool mine = r < r1;
    const uint32_t plo = mine ? static_cast<uint32_t>(l.plo[t0 + r]) : 0u;
    const uint32_t phi = mine ? static_cast<uint32_t>(l.phi[t0 + r]) : 0u;
    __syncthreads();
    scan_block(l, first, last, tile, rows, counted, t0 == 0);
    cluster.sync();  // every block's counted bytes of the tile are written
    if (mine) {
      bool any = false;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        any |= cluster.map_shared_rank(counted, q)[r] != 0;
      }
      lo += any ? plo : 0u;
      hi += any ? phi : 0u;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo += __shfl_down_sync(0xFFFFFFFFu, lo, off);
    hi += __shfl_down_sync(0xFFFFFFFFu, hi, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_part[0][warp] = lo;
    warp_part[1][warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
    lo = lane < warps ? warp_part[0][lane] : 0u;
    hi = lane < warps ? warp_part[1][lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      lo += __shfl_down_sync(0xFFFFFFFFu, lo, off);
      hi += __shfl_down_sync(0xFFFFFFFFu, hi, off);
    }
    if (lane == 0) {
      uint32_t* part = cluster.map_shared_rank(&block_part[0][0], 0);
      part[rank] = lo;
      part[kCluster + rank] = hi;
    }
  }
  cluster.sync();  // rank 0 holds every block's sums; no block reads another's memory after this
  if (rank == 0 && threadIdx.x == 0) {
    lo = hi = 0;
    for (int q = 0; q < kCluster; ++q) {
      lo += block_part[0][q];
      hi += block_part[1][q];
    }
    const Verdict v = fold(lo, hi, thr_lo, thr_hi);
    out.reached[phase] = v.reached;
    out.lo[phase] = v.lo;
    out.hi[phase] = v.hi;
  }
}

// The mask alone: block b checks lanes [64 b, 64 b + 64).
__global__ void __launch_bounds__(kMaskThreads) certify_lanes_mask(Lanes l, long long n) {
  __shared__ __align__(16) int32_t tile[kWords * kTile];
  long long first, last;
  block_lanes(0, n, blockIdx.x, gridDim.x, &first, &last);
  for (long long t0 = 0; t0 < l.rows; t0 += kTile) {
    const int rows = static_cast<int>(min_ll(l.rows - t0, kTile));
    if (t0 > 0) {
      __syncthreads();  // the last tile's readers are done
    }
    stage_tile(l, t0, rows, tile, nullptr);
    __syncthreads();
    scan_block(l, first, last, tile, rows, nullptr, t0 == 0);
  }
}

}  // namespace

// C entry point, bound with ctypes.  n lanes: addr and claimed 5 int32 a
// lane, ok and live one byte (torch.bool); the table `rows` x 5 int32 with
// its power halves plo and phi; `phases` in {0, 1, 2}, phase 0 the first
// `split` lanes (all n where phases is 1).  Phase p's threshold is
// (thr_lo<p>, thr_hi<p>), or, for each half whose pointer at_lo<p> /
// at_hi<p> is not null, the int32 on the card it points to.  `out` is one
// buffer of 9 * phases + n bytes: lo and hi (int32, one a phase), reached
// (a byte a phase) and the mask (n bytes).  Launches on `stream`; returns
// the cudaError_t of the launch.  n <= 0 launches nothing.
extern "C" int certify_lanes(const void* addr, const void* ok, const void* claimed, const void* live,
                             long long n, const void* table, const void* plo, const void* phi,
                             long long rows, int phases, long long split, long long thr_lo0,
                             long long thr_hi0, long long thr_lo1, long long thr_hi1,
                             const void* at_lo0, const void* at_hi0, const void* at_lo1,
                             const void* at_hi1, void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  if (phases < 0 || phases > kMaxPhases || split < 0 || split > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Out o = out_views(out, phases);
  const Lanes l{static_cast<const int32_t*>(addr),  static_cast<const uint8_t*>(ok),
                static_cast<const int32_t*>(claimed), static_cast<const uint8_t*>(live),
                static_cast<const int32_t*>(table), static_cast<const int32_t*>(plo),
                static_cast<const int32_t*>(phi),   rows,
                o.mask};
  const auto s = static_cast<cudaStream_t>(stream);
  if (phases == 0) {
    const long long blocks = (n + kMaskLanes - 1) / kMaskLanes;
    certify_lanes_mask<<<static_cast<unsigned int>(blocks), kMaskThreads, 0, s>>>(l, n);
  } else {
    Phases ph{};
    ph.p[0] = {0, phases == 1 ? n : split, thr_lo0, thr_hi0, static_cast<const int32_t*>(at_lo0),
               static_cast<const int32_t*>(at_hi0)};
    ph.p[1] = {split, n, thr_lo1, thr_hi1, static_cast<const int32_t*>(at_lo1),
               static_cast<const int32_t*>(at_hi1)};
    certify_lanes_count<<<phases * kCluster, kPhaseThreads, 0, s>>>(l, ph, o);
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // a host compiler: the same lane code, for the CPU tests

#include <algorithm>
#include <vector>

namespace {

using namespace certify;

// A block's lanes against its tile, as scan_block maps them on the card,
// the lanes and each lane's stripes one after the other.
void scan_block_host(const Lanes& l, long long first, long long last, const int32_t* tile,
                     int rows, int threads, uint8_t* counted, bool first_tile) {
  const int stripes = stripes_for(last - first, rows, threads);
  for (long long i = first; i < last; ++i) {
    bool member = false;
    for (int stripe = 0; stripe < stripes; ++stripe) {
      member |= lane_stripe(l, i, tile, rows, stripe, stripes, counted);
    }
    write_mask(l, i, member, first_tile);
  }
}

}  // namespace

// The contract of certify_lanes on host memory, thresholds by value only
// ((thr_lo, thr_hi) a phase in thr_values): a phase's cluster blocks one
// after the other between its barriers, the mask alone's blocks in turn.
extern "C" int certify_lanes_host(const int32_t* addr, const uint8_t* ok, const int32_t* claimed,
                                  const uint8_t* live, long long n, const int32_t* table,
                                  const int32_t* plo, const int32_t* phi, long long rows,
                                  int phases, long long split, const long long* thr_values,
                                  uint8_t* mask, uint8_t* reached, int32_t* lo_out,
                                  int32_t* hi_out) {
  if (n <= 0) {
    return 0;
  }
  if (phases < 0 || phases > kMaxPhases || split < 0 || split > n) {
    return 1;
  }
  const Lanes l{addr, ok, claimed, live, table, plo, phi, rows, mask};
  std::vector<int32_t> tile(kWords * kTile);
  if (phases == 0) {
    const long long blocks = (n + kMaskLanes - 1) / kMaskLanes;
    for (long long b = 0; b < blocks; ++b) {
      long long first, last;
      block_lanes(0, n, static_cast<int>(b), static_cast<int>(blocks), &first, &last);
      for (long long t0 = 0; t0 < rows; t0 += kTile) {
        const int tile_rows = static_cast<int>(min_ll(rows - t0, kTile));
        for (int r = 0; r < tile_rows; ++r) {
          stage_row(l, t0, r, tile.data());
        }
        scan_block_host(l, first, last, tile.data(), tile_rows, kMaskThreads, nullptr, t0 == 0);
      }
    }
    return 0;
  }
  std::vector<uint8_t> counted(kCluster * kTile);
  for (int p = 0; p < phases; ++p) {
    const long long begin = p == 0 ? 0 : split;
    const long long end = phases == 1 || p == 1 ? n : split;
    uint32_t lo = 0, hi = 0;
    for (long long t0 = 0; t0 < rows; t0 += kTile) {
      const int tile_rows = static_cast<int>(min_ll(rows - t0, kTile));
      for (int r = 0; r < tile_rows; ++r) {
        stage_row(l, t0, r, tile.data());
      }
      std::fill(counted.begin(), counted.end(), 0);
      for (int rank = 0; rank < kCluster; ++rank) {
        long long first, last;
        block_lanes(begin, end, rank, kCluster, &first, &last);
        scan_block_host(l, first, last, tile.data(), tile_rows, kPhaseThreads,
                        counted.data() + rank * kTile, t0 == 0);
      }
      for (int rank = 0; rank < kCluster; ++rank) {
        int r0, r1;
        slice_rows(tile_rows, rank, &r0, &r1);
        for (int r = r0; r < r1; ++r) {
          bool any = false;
          for (int q = 0; q < kCluster; ++q) {
            any |= counted[q * kTile + r] != 0;
          }
          lo += any ? static_cast<uint32_t>(plo[t0 + r]) : 0u;
          hi += any ? static_cast<uint32_t>(phi[t0 + r]) : 0u;
        }
      }
    }
    const Verdict v = fold(lo, hi, thr_values[2 * p], thr_values[2 * p + 1]);
    reached[p] = v.reached;
    lo_out[p] = v.lo;
    hi_out[p] = v.hi;
  }
  return 0;
}

#endif
