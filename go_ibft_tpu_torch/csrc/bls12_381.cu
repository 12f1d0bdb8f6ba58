// BLS12-381 aggregate verification on the card: three kernels.
//
// * bls_merge (G1 and G2): the masked sum of each group's points, as
//   canonical affine coordinates (y optionally negated) and an infinity
//   flag.  Replaces the JAX package's tree aggregation
//   (go_ibft_tpu/ops/bls12_381.py:759 _aggregate_stage, :1024 g2_merge_tree,
//   :1045 g1_merge_tree, :1098 _multi_g1_neg_aggregate_stage, over
//   _tree_reduce and _jac_ops).  Its design is below ("The merge").
// * bls_miller: per lane i the Miller loops of its two sides, (S_i, G1) and
//   (H_i, -PK_i), and their product in Fp12.  Replaces :789
//   _miller_product_stage and :1117 _multi_miller_stage (:576 miller_loop,
//   :515 _dbl_step, :534 _add_step).
// * bls_final_exp: per lane f^(3 (p^12 - 1) / r) == 1, gated on the lane's
//   flag (its aggregates are not infinity and the lane is live), and the
//   Fp12 result.  Replaces :809 _easy_part_stage, :838 _hard_part_stage,
//   :898 _finish_stage and :685 f12_eq_one.
//
// What bounds the two pairing kernels on an H100: operations, and at one
// lane (a 100-validator check is one Miller lane and one final-exponentiation
// lane) the latency of the tower's critical path, not the card's width.  A
// lane's least work is ~10,500 Fp products for its Miller loops and ~7,700
// and one inversion for its final exponentiation (chip_smoke.py's
// BLS_*_MULS), each ~600 dependent 32-bit multiply-adds; inputs and outputs
// are a few hundred bytes.  The first version ran a lane on one thread (two
// for the Miller loop) with its Fp12 values in local memory: 31.9 ms and
// 59.6 ms at one lane on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6 has
// this version's times beside them).
//
// The design: a lane on a block of kMillerThreads / kExpThreads threads,
// its values in shared memory, its work the fixed sequence of rounds of
// bls12_381_schedule.cuh (generated by ops/bls_schedule.py, which explains
// the schedules).  In a round every thread computes an independent Fp
// product in registers, so a round costs about one product's latency and
// two short sums however wide it is:
//   - an Fp12 product is one round of 54 products, a squaring 36 (the
//     complex method), a cyclotomic squaring 18 (Granger-Scott), a
//     Frobenius map 10-12; an output sum of more than 8 terms is split over
//     several threads and finished in a second, short store phase;
//   - the Miller loop keeps one accumulator for both sides (f <- f^2 l0 l1
//     a step: the product of the two sides' values, with 63 squarings and
//     the closing product saved) and software-pipelines it: the two sides'
//     doubling and line work of step k runs in the same three rounds as f's
//     squaring, the product of step k - 1's two lines (18) and f^2 times it
//     (51): 219 rounds and 11,266 products in all, the five additions on the
//     set bits of |x|;
//   - the final exponentiation: the easy part's inverse goes down the tower
//     to one Fp inversion (a safegcd, one thread), the hard part is five
//     x-powers of 63 cyclotomic squarings and 5 products each, the
//     Frobenius maps fused into squaring rounds: 358 rounds, 7,617 products.
// One block a lane: lanes never share a barrier, and a grid of N blocks
// covers N lanes.  The products are a fifth to a third of a round's time on
// the card; the rest is the sums, whose terms are loaded a batch at a time
// (bench/bls_variants.py measures the split and every constant below).
//
// The merge.  The sum is unique, so any order and any coordinates give the
// same words; the inputs must be points on the curve (the port decodes seals
// with on-curve and subgroup checks, pubkeys come from keys): E(Fp) and
// E'(Fp2) have odd order, so the complete formulas below hold on every such
// input.  What bounds it on an H100: at one group the latency of a chain of
// ceil(log2 n) tree levels, each two dependent Fp products (~1.3 us each on
// one thread: a carry chain that no other instruction can share) and their
// operand sums, and of the one inversion; at 1,024 groups the operations
// (n - 1 additions a group).  The design (times: NVIDIA H100 80GB HBM3 at
// 700 W, from bench/bls_variants.py; PERF.md §6 has them all):
//   - homogeneous projective points and the complete formulas of Renes,
//     Costello and Batina (Eurocrypt 2016) for a = 0: Algorithm 7, and
//     Algorithm 8's mixed form on the first level, where both points are
//     affine.  P + P, P + (-P) and the identity (0 : 1 : 0) come out of the
//     one formula, so no thread branches on a point.  An addition is two
//     rounds of independent Fp products (6 + 6 on G1, 18 + 18 on G2 with
//     Karatsuba; 3 + 6 and 9 + 18 mixed) and a store, the operands and
//     outputs small integer combinations (the forms that
//     ops/bls_schedule.py's merge_addition writes into
//     bls12_381_schedule.cuh, summed by bls::merge_eval, written by hand for
//     the merge: the pairing interpreter's coefficients stop at 8, b3 under
//     Karatsuba reaches 24);
//   - a level of the tree is spread over the block: a thread takes one
//     (pair, product) of a wave of threads / 18 (G2) or / 6 (G1) pairs, its
//     operands in registers, the points in shared memory; the live points
//     are compacted first, so n live points take ceil(log2 n) levels, and an
//     odd last point carries over.  A level costs ~8 us on G1 and ~13 us on
//     G2, two product latencies and the forms' sums (the first version's 7
//     halving levels of one-thread Jacobian additions took 0.5 ms of a G2
//     1 x 128 merge);
//   - a block of one group has kMergeWideThreads = 512 threads (G2 1 x 128
//     0.151 ms against 0.164 on 256 and 0.206 on 128; G2 1 x 1,024 0.716
//     against 0.878 and 1.271); a group of more than kMergeCap points goes
//     through a region of kMergeCap: refill the region's free half, one
//     level, again;
//   - small groups share a block of kMergeThreads = 256 (two blocks an SM):
//     as many as one wave of the first level serves (10 G1 or 3 G2 groups of
//     8); threads without a group reach every barrier and write nothing (G1
//     1,024 x 8 0.088 ms against 0.100 on 512);
//   - one inversion a block: Montgomery's trick over the block's groups'
//     Z (G2: the norm Z conj(Z) in Fp), prefix and suffix products in log2
//     rounds, groups at infinity (Z = 0, or no live point) skipped and
//     written as zeros with their flag.  The inverse is a safegcd
//     (bls12_381.cuh) that stops when g = 0, its divsteps in runs: a third
//     of a G1 1 x 128 merge (the first version's Kaliski inverse was 63 us
//     of 0.47 ms).
//
// The lane arithmetic is in bls12_381.cuh.  Under a host C++ compiler this
// file builds the _host entry points instead of the kernels: the same
// rounds and the same merge phases, each phase's threads one after another
// over a host array that stands for shared memory, which the CPU tests hold
// against the host oracle and the plain versions.

#include "bls12_381.cuh"

namespace {

// The merge: threads a block where a block holds several groups, and where
// it holds one (see merge_plan); points a block's region holds; groups a
// block.
constexpr int kMergeThreads = 256;
constexpr int kMergeWideThreads = 512;
constexpr int kMergeCap = 512;
constexpr int kMergeMaxGroups = 32;
// Threads a Miller lane: its widest rounds hold 62 products.
constexpr int kMillerThreads = 64;
// Threads a final-exponentiation lane: 64 while lanes are few (a lane's
// rounds are latency-bound, and its products rounds hold 54), 32 from
// kExpWideLanes lanes on, where the card is full and a lane's idle threads
// would cost other lanes' time (the two cross between 256 and 512 lanes).
constexpr int kExpThreads = 64;
constexpr int kExpWideThreads = 32;
constexpr long long kExpWideLanes = 512;
constexpr int kF12Words = 12 * bls::kWords;

namespace sched = bls::sched;

// The constants of a layout into a lane's elements, word by word.
LANE_FN void load_consts(const uint32_t* words, int n, uint32_t* elems, int t, int threads) {
  for (int w = t; w < n * bls::kWords; w += threads) {
    const uint32_t* c = words + (w / bls::kWords) * (bls::kWords + 1);
    elems[c[0] * bls::kWords + w % bls::kWords] = c[1 + w % bls::kWords];
  }
}

// Lane i's Miller inputs: q (2, n, 4, 12) and p (2, n, 2, 12).
LANE_FN void miller_in(const uint32_t* q, const uint32_t* p, long long n, long long i, uint32_t* elems, int t,
                       int threads) {
  load_consts(sched::kMillerConstWords, sched::kMillerConsts, elems, t, threads);
  for (int w = t; w < 2 * 6 * bls::kWords; w += threads) {
    const int side = w / (6 * bls::kWords), c = (w / bls::kWords) % 6, j = w % bls::kWords;
    const uint32_t v = c < 4 ? q[((side * n + i) * 4 + c) * bls::kWords + j]
                             : p[((side * n + i) * 2 + c - 4) * bls::kWords + j];
    elems[(c < 4 ? sched::kMillerQ[side * 4 + c] : sched::kMillerP[side * 2 + c - 4]) * bls::kWords + j] = v;
  }
}

// 12 elements (an Fp12 in the tower's order) to or from 144 words.
LANE_FN void f12_in(const uint32_t* src, const uint16_t* at, uint32_t* elems, int t, int threads) {
  for (int w = t; w < kF12Words; w += threads) {
    elems[at[w / bls::kWords] * bls::kWords + w % bls::kWords] = src[w];
  }
}

LANE_FN void f12_out(const uint32_t* elems, const uint16_t* at, uint32_t* dst, int t, int threads) {
  for (int w = t; w < kF12Words; w += threads) {
    dst[w] = elems[at[w / bls::kWords] * bls::kWords + w % bls::kWords];
  }
}

// -- the merge ------------------------------------------------------------------

LANE_FN int imin(int a, int b) { return a < b ? a : b; }

// A merge launch's shape: how a block packs its groups and lays out its
// shared memory (offsets in 32-bit words, each element 16-byte aligned).
struct MergePlan {
  int v, coords, half;  // points a group; elements an input point (2: G1, 4: G2) and a projective one
  int slots;            // a round's most products a pair
  int threads, gpb;     // a block's threads and groups
  int capg, window, pw;  // points a group's region holds, its fill window, pairs a wave
  int region, prod1, prod2, map, ints, flags, words;
};

// A block holds as many groups as one wave of the first level serves on
// kMergeThreads threads, where they fit; a block of one group takes
// kMergeWideThreads (its levels are wider than a wave).
inline MergePlan merge_plan(int v, int coords, long long groups) {
  MergePlan p{};
  p.v = v;
  p.coords = coords;
  p.half = coords == 2 ? 3 : 6;
  p.slots = coords == 2 ? sched::kMergeG1Slots : sched::kMergeG2Slots;
  p.capg = v < kMergeCap ? v : kMergeCap;
  long long gpb = 1;
  if (v < kMergeCap) {
    const int by_wave = kMergeThreads / (((p.capg + 1) / 2) * p.slots);
    gpb = by_wave < 1 ? 1 : by_wave;
    gpb = gpb < kMergeCap / v ? gpb : kMergeCap / v;
  }
  gpb = gpb < kMergeMaxGroups ? gpb : kMergeMaxGroups;
  p.threads = gpb == 1 ? kMergeWideThreads : kMergeThreads;
  p.pw = p.threads / p.slots;
  p.gpb = static_cast<int>(gpb < groups ? gpb : groups);
  p.window = (p.capg + 31) / 32 * 32;
  const int segs = p.gpb * p.window / 32;
  int at = 0;
  p.region = at;
  at += p.gpb * p.capg * p.half * bls::kWords;
  p.prod1 = at;  // also the affine map's products (10 a group on G2)
  at += p.pw * p.slots * bls::kWords;
  p.prod2 = at;
  at += p.pw * p.slots * bls::kWords;
  p.map = at;  // a group's prefix (two), suffix (two), cofactor and coordinates; the inverse
  at += (p.gpb * (5 + p.coords) + 1) * bls::kWords;
  p.ints = at;  // n, cursor, next cursor, infinity, pfx (gpb + 1), segment counts, control
  at += (4 * p.gpb + (p.gpb + 1) + segs + 4 + 3) / 4 * 4;
  p.flags = at;
  at += (p.gpb * p.window + 15) / 16 * 4;
  p.words = at;
  return p;
}

enum { kCtlPairs, kCtlFill };

// The block's phases: each runs its body for every thread t, then a barrier
// of the block (on the card: the block's threads at once; on the host: one
// after another).
#if defined(__CUDACC__)
struct Block {
  template <class Fn>
  __device__ void phase(Fn fn) {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};
#else
struct Block {
  int threads;
  template <class Fn>
  void phase(Fn fn) {
    for (int t = 0; t < threads; ++t) {
      fn(t);
    }
  }
};
#endif

// One block's groups [first, first + gpb) of the launch: fill each group's
// region with its next live points (compacted, affine with Z = 1), add
// pairs (2j, 2j + 1) -> j level by level in waves of pw pairs (two rounds of
// products and a store, the first level in the mixed form), carry an odd
// last point, until every group holds one point; then the affine map with
// one inversion for the block (Montgomery's trick).
LANE_FN void merge_block(Block& blk, const MergePlan& pl, uint32_t* sm, const uint32_t* pts, const uint8_t* live,
                         long long groups, long long first, bool neg_y, uint32_t* out, uint8_t* inf_out) {
  const int nt = pl.threads, gpb = pl.gpb, half = pl.half, w12 = half * bls::kWords, ngroups =
      static_cast<int>(groups - first < gpb ? groups - first : gpb);
  uint32_t* region = sm + pl.region;
  uint32_t* prod1 = sm + pl.prod1;
  uint32_t* prod2 = sm + pl.prod2;
  int* n = reinterpret_cast<int*>(sm + pl.ints);
  int* cursor = n + gpb;
  int* next = cursor + gpb;
  int* infl = next + gpb;
  int* pfx = infl + gpb;
  int* cnt = pfx + gpb + 1;
  int* ctl = cnt + gpb * pl.window / 32;
  uint8_t* flags = reinterpret_cast<uint8_t*>(sm + pl.flags);
  const int items = gpb * pl.window, segs = items / 32, per_group = pl.window / 32;
  auto slot = [&](int g, int j) { return region + (g * pl.capg + j) * w12; };
  auto locate = [&](int pr, int& j) {
    int g = 0;
    while (pfx[g + 1] <= pr) {
      ++g;
    }
    j = pr - pfx[g];
    return g;
  };

  blk.phase([&](int t) {
    for (int g = t; g < gpb; g += nt) {
      n[g] = 0;
      cursor[g] = g < ngroups ? 0 : pl.v;
    }
    if (t == 0) {
      ctl[kCtlFill] = 1;
    }
  });
  // Fills and levels: a fill where some group has input left, a level where
  // some group holds a pair (a window can hold too few live points for one).
  for (int level = 0;;) {
    if (ctl[kCtlFill] != 0) {
      // Fill: flag the window's live points, count them by segments of 32,
      // place each at n + its rank where that is inside the region.
      blk.phase([&](int t) {
        for (int i = t; i < items; i += nt) {
          const int g = i / pl.window, pos = cursor[g] + i % pl.window;
          flags[i] = n[g] < pl.capg && pos < pl.v && live[(first + g) * pl.v + pos] != 0;
        }
        for (int g = t; g < gpb; g += nt) {
          next[g] = n[g] < pl.capg ? imin(pl.v, cursor[g] + pl.window) : cursor[g];
        }
      });
      blk.phase([&](int t) {
        for (int s = t; s < segs; s += nt) {
          int c = 0;
          for (int i = 0; i < 32; ++i) {
            c += flags[32 * s + i];
          }
          cnt[s] = c;
        }
      });
      blk.phase([&](int t) {
        for (int i = t; i < items; i += nt) {
          if (flags[i] == 0) {
            continue;
          }
          const int g = i / pl.window, pos = cursor[g] + i % pl.window;
          int rank = 0;
          for (int s = g * per_group; s < i / 32; ++s) {
            rank += cnt[s];
          }
          for (int k = i & ~31; k < i; ++k) {
            rank += flags[k];
          }
          const int at = n[g] + rank;
          if (at >= pl.capg) {
            continue;
          }
          const uint32_t* src = pts + ((first + g) * pl.v + pos) * pl.coords * bls::kWords;
          uint32_t* dst = slot(g, at);
          for (int e = 0; e < pl.coords; ++e) {  // X, Y (G2: X0, X1, Y0, Y1)
            bls::store(dst + e * bls::kWords, bls::load(src + e * bls::kWords));
          }
          bls::store(dst + pl.coords * bls::kWords, bls::fp_one());  // Z = 1 (G2: 1 + 0 u)
          if (pl.coords == 4) {
            bls::store(dst + 5 * bls::kWords, bls::fp_zero());
          }
          if (at == pl.capg - 1) {
            next[g] = pos + 1;
          }
        }
      });
      blk.phase([&](int t) {
        for (int g = t; g < gpb; g += nt) {
          int total = 0;
          for (int s = g * per_group; s < (g + 1) * per_group; ++s) {
            total += cnt[s];
          }
          n[g] = imin(pl.capg, n[g] + total);
          cursor[g] = next[g];
        }
      });
    }
    blk.phase([&](int t) {
      if (t == 0) {
        int pairs = 0, fill = 0;
        for (int g = 0; g < gpb; ++g) {
          pfx[g] = pairs;
          pairs += n[g] / 2;
          fill |= cursor[g] < pl.v;
        }
        pfx[gpb] = pairs;
        ctl[kCtlPairs] = pairs;
        ctl[kCtlFill] = fill;
      }
    });
    const int pairs = ctl[kCtlPairs];
    if (pairs == 0) {
      if (ctl[kCtlFill] != 0) {
        continue;
      }
      break;
    }
    const int kind = (pl.coords == 2 ? 0 : 12) + (level == 0 ? 6 : 0);
    const int f1 = sched::kMergeKinds[kind], s1 = sched::kMergeKinds[kind + 1];
    const int f2 = sched::kMergeKinds[kind + 2], s2 = sched::kMergeKinds[kind + 3];
    const int fo = sched::kMergeKinds[kind + 4];
    for (int w0 = 0; w0 < pairs; w0 += pl.pw) {
      const int np = imin(pl.pw, pairs - w0);
      blk.phase([&](int t) {  // round 1: products of the inputs' forms
        for (int k = t; k < np * s1; k += nt) {
          const int sl = k / np, pr = w0 + k % np;
          int j;
          const int g = locate(pr, j);
          const uint32_t* in = slot(g, 2 * j);
          const bls::Fp a = bls::merge_eval(sched::kMergeForms[f1 + 2 * sl], nullptr, in, false);
          const bls::Fp b = bls::merge_eval(sched::kMergeForms[f1 + 2 * sl + 1], nullptr, in, false);
          bls::store(prod1 + ((pr - w0) * pl.slots + sl) * bls::kWords, bls::mul(a, b));
        }
      });
      blk.phase([&](int t) {  // round 2: products of forms of round 1's
        for (int k = t; k < np * s2; k += nt) {
          const int sl = k / np, pr = w0 + k % np;
          int j;
          const int g = locate(pr, j);
          const uint32_t* in = slot(g, 2 * j);
          const uint32_t* p1 = prod1 + (pr - w0) * pl.slots * bls::kWords;
          const bls::Fp a = bls::merge_eval(sched::kMergeForms[f2 + 2 * sl], p1, in, false);
          const bls::Fp b = bls::merge_eval(sched::kMergeForms[f2 + 2 * sl + 1], p1, in, false);
          bls::store(prod2 + ((pr - w0) * pl.slots + sl) * bls::kWords, bls::mul(a, b));
        }
      });
      blk.phase([&](int t) {  // the sums: pair j's point to slot j
        for (int k = t; k < np * half; k += nt) {
          const int e = k / np, pr = w0 + k % np;
          int j;
          const int g = locate(pr, j);
          const uint32_t* p2 = prod2 + (pr - w0) * pl.slots * bls::kWords;
          bls::store(slot(g, j) + e * bls::kWords, bls::merge_eval(sched::kMergeForms[fo + e], p2, nullptr, true));
        }
      });
    }
    blk.phase([&](int t) {  // an odd last point carries over
      for (int k = t; k < gpb * w12; k += nt) {
        const int g = k / w12;
        if (n[g] >= 3 && (n[g] & 1) != 0) {
          slot(g, n[g] / 2)[k % w12] = slot(g, n[g] - 1)[k % w12];
        }
      }
    });
    blk.phase([&](int t) {
      for (int g = t; g < gpb; g += nt) {
        n[g] = n[g] >= 2 ? (n[g] + 1) / 2 : n[g];
      }
    });
    ++level;
  }

  // The affine map: x = X / Z, y = Y / Z (G2: X conj(Z) / N, with N = Z
  // conj(Z) in Fp), all of the block's N or Z inverted at once.
  uint32_t* map = sm + pl.map;
  auto pre = [&](int b) { return map + b * gpb * bls::kWords; };  // two buffers of prefix products
  auto suf = [&](int b) { return map + (2 + b) * gpb * bls::kWords; };  // and of suffix products
  uint32_t* cof = map + 4 * gpb * bls::kWords;
  uint32_t* coord = map + 5 * gpb * bls::kWords;  // (group, c)
  uint32_t* tinv = coord + gpb * pl.coords * bls::kWords;
  if (pl.coords == 4) {
    blk.phase([&](int t) {  // the products of Z conj(Z), X conj(Z), Y conj(Z)
      for (int k = t; k < gpb * 10; k += nt) {
        // Product m of (Z0 Z0, Z1 Z1, X0 Z0, X1 Z1, X1 Z0, X0 Z1, Y0 Z0, Y1 Z1,
        // Y1 Z0, Y0 Z1): the first factor's element is nibble m of kA, the
        // second's Z0 or Z1 by m's parity.
        constexpr uint64_t kA = 0x2332011054ull;
        const int m = k % 10;
        const uint32_t* el = slot(k / 10, 0);
        bls::store(prod1 + k * bls::kWords, bls::mul(bls::load(el + ((kA >> (4 * m)) & 15u) * bls::kWords),
                                                     bls::load(el + (4 + (m & 1)) * bls::kWords)));
      }
    });
  }
  blk.phase([&](int t) {
    for (int g = t; g < gpb; g += nt) {
      const uint32_t* el = slot(g, 0);
      bls::Fp e;
      uint32_t* c = coord + g * pl.coords * bls::kWords;
      if (pl.coords == 2) {
        e = bls::load(el + 2 * bls::kWords);
        bls::store(c, bls::load(el));
        bls::store(c + bls::kWords, bls::load(el + bls::kWords));
      } else {
        const uint32_t* m = prod1 + g * 10 * bls::kWords;
        auto at = [&](int i) { return bls::load(m + i * bls::kWords); };
        e = bls::add(at(0), at(1));
        bls::store(c, bls::add(at(2), at(3)));
        bls::store(c + bls::kWords, bls::sub(at(4), at(5)));
        bls::store(c + 2 * bls::kWords, bls::add(at(6), at(7)));
        bls::store(c + 3 * bls::kWords, bls::sub(at(8), at(9)));
      }
      const bool inf = n[g] == 0 || bls::is_zero(e);
      infl[g] = inf;
      if (inf) {
        e = bls::fp_one();
      }
      bls::store(pre(0) + g * bls::kWords, e);
      bls::store(suf(0) + g * bls::kWords, e);
    }
  });
  int src = 0;
  for (int d = 1; d < gpb; d <<= 1, src ^= 1) {  // prefix and suffix products
    blk.phase([&](int t) {
      for (int k = t; k < 2 * gpb; k += nt) {
        const int i = k % gpb, other = k < gpb ? i - d : i + d;
        const uint32_t* from = k < gpb ? pre(src) : suf(src);
        bls::Fp x = bls::load(from + i * bls::kWords);
        if (other >= 0 && other < gpb) {
          x = bls::mul(x, bls::load(from + other * bls::kWords));
        }
        bls::store((k < gpb ? pre(src ^ 1) : suf(src ^ 1)) + i * bls::kWords, x);
      }
    });
  }
  blk.phase([&](int t) {  // each group's cofactor; the product's inverse
    for (int g = t; g < gpb; g += nt) {
      const bls::Fp lo = g > 0 ? bls::load(pre(src) + (g - 1) * bls::kWords) : bls::fp_one();
      const bls::Fp hi = g + 1 < gpb ? bls::load(suf(src) + (g + 1) * bls::kWords) : bls::fp_one();
      bls::store(cof + g * bls::kWords, bls::mul(lo, hi));
    }
    if (t == 0) {
      bls::store(tinv, bls::inv(bls::load(pre(src) + (gpb - 1) * bls::kWords)));
    }
  });
  blk.phase([&](int t) {
    for (int k = t; k < ngroups * pl.coords; k += nt) {
      const int g = k / pl.coords, c = k % pl.coords;
      bls::Fp x = bls::mul(bls::load(coord + k * bls::kWords),
                           bls::mul(bls::load(cof + g * bls::kWords), bls::load(tinv)));
      if (neg_y && 2 * c >= pl.coords) {
        x = bls::neg(x);
      }
      bls::store(out + ((first + g) * pl.coords + c) * bls::kWords, infl[g] ? bls::fp_zero() : x);
      if (c == 0) {
        inf_out[first + g] = static_cast<uint8_t>(infl[g]);
      }
    }
  });
}
}  // namespace

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

// One block of kThreads a launch's plan's groups (at most 128 registers a
// thread: a block of 256 leaves room for a second on the SM).
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == kMergeWideThreads ? 1 : 2)
bls_merge_kernel(const uint32_t* __restrict__ pts, const uint8_t* __restrict__ live, long long groups,
                 MergePlan plan, int neg_y, uint32_t* __restrict__ out, uint8_t* __restrict__ inf) {
  extern __shared__ __align__(16) uint32_t smem[];
  Block blk;
  merge_block(blk, plan, smem, pts, live, groups, static_cast<long long>(blockIdx.x) * plan.gpb, neg_y != 0, out,
              inf);
}

// A schedule's rounds on the block's lane: every round its product phase and
// one or two store phases, each ending in a barrier of the block (one lane a
// block).
template <int kThreads, bool kInverts>
__device__ void run(const uint8_t* seq, int rounds, uint32_t* elems) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const uint32_t rid = seq[r];
    bls::slot_phase(rid, elems, t, kThreads);
    __syncthreads();
    bls::store_phase<kInverts>(rid, 0, elems, t, kThreads);
    __syncthreads();
    if (bls::round_stores(rid, 1) != 0) {  // the same for every thread of the block
      bls::store_phase<kInverts>(rid, 1, elems, t, kThreads);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMillerThreads)
bls_miller_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ p, long long n,
                  uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t elems[sched::kMillerElems * bls::kWords];  // 10.8 KB
  const long long i = blockIdx.x;
  miller_in(q, p, n, i, elems, threadIdx.x, kMillerThreads);
  __syncthreads();
  run<kMillerThreads, false>(sched::kMillerSeq, sched::kMillerRounds, elems);
  f12_out(elems, sched::kMillerOut, out + i * kF12Words, threadIdx.x, kMillerThreads);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
bls_final_exp_kernel(const uint32_t* __restrict__ f, const uint8_t* __restrict__ gate, long long n,
                     uint8_t* __restrict__ ok, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t elems[sched::kExpElems * bls::kWords];
  const long long i = blockIdx.x;
  load_consts(sched::kExpConstWords, sched::kExpConsts, elems, threadIdx.x, kThreads);
  f12_in(f + i * kF12Words, sched::kExpIn, elems, threadIdx.x, kThreads);
  __syncthreads();
  run<kThreads, true>(sched::kExpSeq, sched::kExpRounds, elems);
  if (threadIdx.x == 0) {
    ok[i] = gate[i] != 0 && bls::is_one(elems, sched::kExpOut);
  }
  if (out != nullptr) {
    f12_out(elems, sched::kExpOut, out + i * kF12Words, threadIdx.x, kThreads);
  }
}

}  // namespace

// C entry points, bound with ctypes.  Every pointer is a CUDA tensor's
// data; field elements are 12 int32 words (canonical Montgomery form, R =
// 2^384); flags are bytes (torch.bool).  Each launches on `stream` (a
// cudaStream_t) and returns the cudaError_t of the launch.

// groups x v points of `coords` field elements (2: G1, 4: G2) with a live
// byte each -> groups x coords affine field elements and an infinity byte.
// A block takes merge_plan's groups, with its dynamic shared memory.
extern "C" int bls_merge(const void* pts, const void* live, long long groups, int v, int coords, int neg_y,
                         void* out, void* inf, void* stream) {
  if (groups <= 0) {
    return 0;
  }
  if (v <= 0 || (coords != 2 && coords != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MergePlan plan = merge_plan(v, coords, groups);
  const size_t bytes = static_cast<size_t>(plan.words) * sizeof(uint32_t);
  const auto kernel = plan.threads == kMergeWideThreads ? bls_merge_kernel<kMergeWideThreads>
                                                        : bls_merge_kernel<kMergeThreads>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  const long long blocks = (groups + plan.gpb - 1) / plan.gpb;
  kernel<<<static_cast<unsigned int>(blocks), plan.threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const uint8_t*>(live), groups, plan, neg_y,
      static_cast<uint32_t*>(out), static_cast<uint8_t*>(inf));
  return static_cast<int>(cudaGetLastError());
}

// q: (2, n, 4) field elements (the G2 points of side 0, then side 1); p:
// (2, n, 2) (the G1 points) -> out: n x 12 field elements (Fp12).  One
// block a lane.
extern "C" int bls_miller(const void* q, const void* p, long long n, void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  bls_miller_kernel<<<static_cast<unsigned int>(n), kMillerThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(p), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// f: n x 12 field elements, gate: n bytes -> ok: n bytes, and out (n x 12
// field elements, the exponentiation's result) unless it is null.  One
// block a lane, of kExpThreads threads below kExpWideLanes lanes and of
// kExpWideThreads from there on.
extern "C" int bls_final_exp(const void* f, const void* gate, long long n, void* ok, void* out,
                             void* stream) {
  if (n <= 0) {
    return 0;
  }
  const auto* fi = static_cast<const uint32_t*>(f);
  const auto* g = static_cast<const uint8_t*>(gate);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < kExpWideLanes) {
    bls_final_exp_kernel<kExpThreads><<<static_cast<unsigned int>(n), kExpThreads, 0, s>>>(
        fi, g, n, static_cast<uint8_t*>(ok), static_cast<uint32_t*>(out));
  } else {
    bls_final_exp_kernel<kExpWideThreads><<<static_cast<unsigned int>(n), kExpWideThreads, 0, s>>>(
        fi, g, n, static_cast<uint8_t*>(ok), static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

#else

#include <vector>

// The kernels' work on the host, lane after lane: the CPU tests' view of the
// lane arithmetic.  Not used by the port's wrappers.

namespace {

// A schedule's rounds as the kernels run them: phase by phase, the threads
// of a phase one after another; `elems` stands for the lane's shared memory.
void run_host(const uint8_t* seq, int rounds, uint32_t* elems, int threads) {
  for (int r = 0; r < rounds; ++r) {
    for (int t = 0; t < threads; ++t) {
      bls::slot_phase(seq[r], elems, t, threads);
    }
    for (int phase = 0; phase < 2; ++phase) {
      for (int t = 0; t < threads; ++t) {
        bls::store_phase(seq[r], phase, elems, t, threads);
      }
    }
  }
}

// Each "thread" of a block's word loop, one after another.
template <class Fn>
void each_thread(int threads, Fn fn) {
  for (int t = 0; t < threads; ++t) {
    fn(t);
  }
}

}  // namespace

extern "C" int bls_merge_host(const uint32_t* pts, const uint8_t* live, long long groups, int v,
                              int coords, int neg_y, uint32_t* out, uint8_t* inf) {
  if (groups <= 0) {
    return 0;
  }
  if (v <= 0 || (coords != 2 && coords != 4)) {
    return 1;
  }
  const MergePlan plan = merge_plan(v, coords, groups);
  std::vector<uint32_t> smem(plan.words);
  Block blk{plan.threads};
  for (long long first = 0; first < groups; first += plan.gpb) {
    merge_block(blk, plan, smem.data(), pts, live, groups, first, neg_y != 0, out, inf);
  }
  return 0;
}

// The launch's plan: threads and groups a block, points a group's region,
// the shared memory's words (the CPU tests' view of the packing).
extern "C" int bls_merge_plan_host(int v, int coords, long long groups, int* threads, int* gpb, int* capg,
                                   int* words) {
  const MergePlan plan = merge_plan(v, coords, groups);
  *threads = plan.threads;
  *gpb = plan.gpb;
  *capg = plan.capg;
  *words = plan.words;
  return 0;
}

extern "C" int bls_miller_host(const uint32_t* q, const uint32_t* p, long long n, uint32_t* out) {
  std::vector<uint32_t> elems(sched::kMillerElems * bls::kWords);
  for (long long i = 0; i < n; ++i) {
    each_thread(kMillerThreads, [&](int t) { miller_in(q, p, n, i, elems.data(), t, kMillerThreads); });
    run_host(sched::kMillerSeq, sched::kMillerRounds, elems.data(), kMillerThreads);
    each_thread(kMillerThreads,
                [&](int t) { f12_out(elems.data(), sched::kMillerOut, out + i * kF12Words, t, kMillerThreads); });
  }
  return 0;
}

extern "C" int bls_final_exp_host(const uint32_t* f, const uint8_t* gate, long long n, uint8_t* ok,
                                  uint32_t* out) {
  std::vector<uint32_t> elems(sched::kExpElems * bls::kWords);
  const int threads = n < kExpWideLanes ? kExpThreads : kExpWideThreads;
  for (long long i = 0; i < n; ++i) {
    each_thread(threads, [&](int t) {
      load_consts(sched::kExpConstWords, sched::kExpConsts, elems.data(), t, threads);
      f12_in(f + i * kF12Words, sched::kExpIn, elems.data(), t, threads);
    });
    run_host(sched::kExpSeq, sched::kExpRounds, elems.data(), threads);
    ok[i] = gate[i] != 0 && bls::is_one(elems.data(), sched::kExpOut);
    if (out != nullptr) {
      each_thread(threads, [&](int t) { f12_out(elems.data(), sched::kExpOut, out + i * kF12Words, t, threads); });
    }
  }
  return 0;
}

// Field products and inverses of n pairs of canonical elements.
extern "C" int bls_fp_mul_host(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    bls::store(out + i * bls::kWords, bls::mul(bls::load(a + i * bls::kWords), bls::load(b + i * bls::kWords)));
  }
  return 0;
}

extern "C" int bls_fp_inv_host(const uint32_t* a, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    bls::store(out + i * bls::kWords, bls::inv(bls::load(a + i * bls::kWords)));
  }
  return 0;
}

// Fp12 operations on n elements through the schedules' rounds (the final
// exponentiation's layout): op 0 a * b, 1 a^2, 2 a^-1, 3 a^p, 4 a^(p^2),
// 5 a^(p^6), 6 the cyclotomic square of a, 7 the product of the lines in
// slots 0, 3 and 5 of a and of b, 8 a times b with b's c1.c0 taken as 0 (a
// product of two lines).  b is read by ops 0, 7 and 8.
extern "C" int bls_f12_op_host(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, long long n) {
  if (op < 0 || op >= sched::kOps) {
    return 1;
  }
  std::vector<uint32_t> elems(sched::kExpElems * bls::kWords);
  const int first = sched::kOpFirst[op];
  for (long long i = 0; i < n; ++i) {
    each_thread(kExpThreads, [&](int t) {
      load_consts(sched::kExpConstWords, sched::kExpConsts, elems.data(), t, kExpThreads);
      f12_in(a + i * kF12Words, sched::kExpIn, elems.data(), t, kExpThreads);
      if (b != nullptr) {
        f12_in(b + i * kF12Words, sched::kExpB, elems.data(), t, kExpThreads);
      }
    });
    run_host(sched::kOpSeq + first, sched::kOpFirst[op + 1] - first, elems.data(), kExpThreads);
    each_thread(kExpThreads,
                [&](int t) { f12_out(elems.data(), sched::kExpOut, out + i * kF12Words, t, kExpThreads); });
  }
  return 0;
}

// One complete addition of the merge for n pairs of projective points (3
// elements each on G1: X, Y, Z; 6 on G2), P and Q side by side: in, n x 2 x
// (3 or 6) elements -> out, n x (3 or 6).  mixed: the affine form (both Z =
// 1).
extern "C" int bls_add_host(int coords, int mixed, const uint32_t* in, uint32_t* out, long long n) {
  const int half = coords == 2 ? 3 : 6, kind = (coords == 2 ? 0 : 12) + (mixed ? 6 : 0);
  const int f1 = sched::kMergeKinds[kind], s1 = sched::kMergeKinds[kind + 1];
  const int f2 = sched::kMergeKinds[kind + 2], s2 = sched::kMergeKinds[kind + 3];
  const int fo = sched::kMergeKinds[kind + 4];
  std::vector<uint32_t> p1(s1 * bls::kWords), p2(s2 * bls::kWords);
  for (long long i = 0; i < n; ++i) {
    const uint32_t* pin = in + i * 2 * half * bls::kWords;
    for (int s = 0; s < s1; ++s) {
      bls::store(p1.data() + s * bls::kWords,
                 bls::mul(bls::merge_eval(sched::kMergeForms[f1 + 2 * s], nullptr, pin, false),
                          bls::merge_eval(sched::kMergeForms[f1 + 2 * s + 1], nullptr, pin, false)));
    }
    for (int s = 0; s < s2; ++s) {
      bls::store(p2.data() + s * bls::kWords,
                 bls::mul(bls::merge_eval(sched::kMergeForms[f2 + 2 * s], p1.data(), pin, false),
                          bls::merge_eval(sched::kMergeForms[f2 + 2 * s + 1], p1.data(), pin, false)));
    }
    for (int e = 0; e < half; ++e) {
      bls::store(out + (i * half + e) * bls::kWords,
                 bls::merge_eval(sched::kMergeForms[fo + e], p2.data(), nullptr, true));
    }
  }
  return 0;
}

// P + Q on G2 for n pairs of affine points with infinity bytes: the merge
// of each pair (the complete addition, then the affine map).
extern "C" int bls_g2_add_host(const uint32_t* p, const uint8_t* p_inf, const uint32_t* q,
                               const uint8_t* q_inf, uint32_t* out, uint8_t* out_inf, long long n) {
  std::vector<uint32_t> pts(n * 2 * 4 * bls::kWords);
  std::vector<uint8_t> live(n * 2);
  for (long long i = 0; i < n; ++i) {
    for (int w = 0; w < 4 * bls::kWords; ++w) {
      pts[(2 * i) * 4 * bls::kWords + w] = p[i * 4 * bls::kWords + w];
      pts[(2 * i + 1) * 4 * bls::kWords + w] = q[i * 4 * bls::kWords + w];
    }
    live[2 * i] = p_inf[i] == 0;
    live[2 * i + 1] = q_inf[i] == 0;
  }
  return bls_merge_host(pts.data(), live.data(), n, 2, 4, 0, out, out_inf);
}

#endif
