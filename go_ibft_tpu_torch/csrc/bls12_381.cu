// BLS12-381 aggregate verification on the card: three kernels.
//
// * bls_merge (G1 and G2): the masked sum of each group's points, as
//   canonical affine coordinates (y optionally negated) and an infinity
//   flag.  Replaces the JAX package's tree aggregation
//   (go_ibft_tpu/ops/bls12_381.py:759 _aggregate_stage, :1024 g2_merge_tree,
//   :1045 g1_merge_tree, :1098 _multi_g1_neg_aggregate_stage, over
//   _tree_reduce and _jac_ops).  One block of 128 threads a group: thread t
//   folds the live points t, t + 128, ... serially, then the block sums its
//   128 partial sums in a halving tree in shared memory, and thread 0
//   inverts z once.  The additions are complete (P + P doubles, P + (-P) is
//   infinity, infinity returns the other point), so every order of the sum
//   gives the same point.  Its algorithm is its first version's; it now
//   runs on the register product and the Kaliski inverse below.
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
//     to one Fp inversion (Kaliski, one thread), the hard part is five
//     x-powers of 63 cyclotomic squarings and 5 products each, the
//     Frobenius maps fused into squaring rounds: 358 rounds, 7,617 products.
// One block a lane: lanes never share a barrier, and a grid of N blocks
// covers N lanes.  The products are a fifth to a third of a round's time on
// the card; the rest is the sums, whose terms are loaded a batch at a time
// (bench/bls_variants.py measures the split and every constant below).
//
// The lane arithmetic is in bls12_381.cuh.  Under a host C++ compiler this
// file builds the _host entry points instead of the kernels: the same
// rounds, each phase's threads one after another over a host array that
// stands for shared memory, which the CPU tests hold against the host
// oracle and the plain versions.

#include "bls12_381.cuh"

namespace {

constexpr int kMergeThreads = 128;                // threads a group
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

}  // namespace

#if defined(__CUDACC__)

#include <cuda_runtime.h>

namespace {

template <class F>
__global__ void __launch_bounds__(kMergeThreads)
bls_merge_kernel(const uint32_t* __restrict__ pts, const uint8_t* __restrict__ live, int v, int coords,
                 int neg_y, uint32_t* __restrict__ out, uint8_t* __restrict__ inf_out) {
  __shared__ bls::Jac<F> tree[kMergeThreads];
  const long long g = blockIdx.x;
  const int t = threadIdx.x;
  bls::Jac<F> acc = bls::infinity(static_cast<const bls::Jac<F>*>(nullptr));
  for (int i = t; i < v; i += kMergeThreads) {
    const long long at = g * v + i;
    if (live[at]) {
      bls::Jac<F> p;
      bls::load_point(pts + at * coords * bls::kWords, p);
      acc = bls::jac_add(acc, p);
    }
  }
  tree[t] = acc;
  __syncthreads();
  for (int s = kMergeThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      tree[t] = bls::jac_add(tree[t], tree[t + s]);
    }
    __syncthreads();
  }
  if (t == 0) {
    inf_out[g] = bls::store_affine(out + g * coords * bls::kWords, tree[0], neg_y != 0);
  }
}

// A schedule's rounds on the block's lane: every round its product phase and
// one or two store phases, each ending in a barrier of the block (one lane a
// block).
template <int kThreads>
__device__ void run(const uint8_t* seq, int rounds, uint32_t* elems) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const uint32_t rid = seq[r];
    bls::slot_phase(rid, elems, t, kThreads);
    __syncthreads();
    bls::store_phase(rid, 0, elems, t, kThreads);
    __syncthreads();
    if (bls::round_stores(rid, 1) != 0) {  // the same for every thread of the block
      bls::store_phase(rid, 1, elems, t, kThreads);
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
  run<kMillerThreads>(sched::kMillerSeq, sched::kMillerRounds, elems);
  f12_out(elems, sched::kMillerOut, out + i * kF12Words, threadIdx.x, kMillerThreads);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
bls_final_exp_kernel(const uint32_t* __restrict__ f, const uint8_t* __restrict__ gate, long long n,
                     uint8_t* __restrict__ ok, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t elems[sched::kExpElems * bls::kWords];
  const long long i = blockIdx.x;
  load_consts(sched::kExpConstWords, sched::kExpConsts, elems, threadIdx.x, kThreads);
  f12_in(f + i * kF12Words, sched::kExpIn, elems, threadIdx.x, kThreads);
  __syncthreads();
  run<kThreads>(sched::kExpSeq, sched::kExpRounds, elems);
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
extern "C" int bls_merge(const void* pts, const void* live, long long groups, int v, int coords,
                         int neg_y, void* out, void* inf, void* stream) {
  if (groups <= 0) {
    return 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(pts);
  const auto* l = static_cast<const uint8_t*>(live);
  auto* o = static_cast<uint32_t*>(out);
  auto* f = static_cast<uint8_t*>(inf);
  if (coords == 2) {
    bls_merge_kernel<bls::Fp><<<static_cast<unsigned int>(groups), kMergeThreads, 0, s>>>(
        p, l, v, coords, neg_y, o, f);
  } else {
    bls_merge_kernel<bls::Fp2><<<static_cast<unsigned int>(groups), kMergeThreads, 0, s>>>(
        p, l, v, coords, neg_y, o, f);
  }
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

template <class F>
void merge_group(const uint32_t* pts, const uint8_t* live, int v, int coords, bool neg_y, uint32_t* out,
                 uint8_t* inf) {
  bls::Jac<F> tree[kMergeThreads];
  for (int t = 0; t < kMergeThreads; ++t) {
    bls::Jac<F> acc = bls::infinity(static_cast<const bls::Jac<F>*>(nullptr));
    for (int i = t; i < v; i += kMergeThreads) {
      if (live[i]) {
        bls::Jac<F> p;
        bls::load_point(pts + static_cast<long long>(i) * coords * bls::kWords, p);
        acc = bls::jac_add(acc, p);
      }
    }
    tree[t] = acc;
  }
  for (int s = kMergeThreads / 2; s > 0; s >>= 1) {
    for (int t = 0; t < s; ++t) {
      tree[t] = bls::jac_add(tree[t], tree[t + s]);
    }
  }
  *inf = bls::store_affine(out, tree[0], neg_y);
}

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
  for (long long g = 0; g < groups; ++g) {
    const uint32_t* gp = pts + g * v * coords * bls::kWords;
    uint32_t* go = out + g * coords * bls::kWords;
    if (coords == 2) {
      merge_group<bls::Fp>(gp, live + g * v, v, coords, neg_y != 0, go, inf + g);
    } else {
      merge_group<bls::Fp2>(gp, live + g * v, v, coords, neg_y != 0, go, inf + g);
    }
  }
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

// P + Q on G2 for n pairs of affine points with infinity bytes (the
// complete addition, then the affine map).
extern "C" int bls_g2_add_host(const uint32_t* p, const uint8_t* p_inf, const uint32_t* q,
                               const uint8_t* q_inf, uint32_t* out, uint8_t* out_inf, long long n) {
  for (long long i = 0; i < n; ++i) {
    bls::Jac<bls::Fp2> a = bls::load_g2(p + i * 4 * bls::kWords);
    bls::Jac<bls::Fp2> b = bls::load_g2(q + i * 4 * bls::kWords);
    if (p_inf[i]) {
      a.z = bls::f2_zero();
    }
    if (q_inf[i]) {
      b.z = bls::f2_zero();
    }
    out_inf[i] = bls::store_affine(out + i * 4 * bls::kWords, bls::jac_add(a, b), false);
  }
  return 0;
}

#endif
