// BLS12-381 aggregate verification on the card: three kernels.
//
// * bls_merge (G1 and G2): the masked sum of each group's points, as
//   canonical affine coordinates (y optionally negated) and an infinity
//   flag.  Replaces the JAX package's tree aggregation
//   (go_ibft_tpu/ops/bls12_381.py: _aggregate_stage, g1_merge_tree,
//   g2_merge_tree, _multi_g1_neg_aggregate_stage, over _tree_reduce and
//   _jac_ops).  One block of 128 threads a group: thread t folds the live
//   points t, t + 128, ... serially, then the block sums its 128 partial
//   sums in a halving tree in shared memory (a G2 Jacobian point is 288 B,
//   so 128 of them are 36 KB, and a 1,024-point group takes 8 serial
//   additions a thread), and thread 0 inverts z once.  The additions are
//   complete (P + P doubles, P + (-P) is infinity, infinity returns the
//   other point), so every order of the sum gives the same point.
// * bls_miller: per lane i the Miller loops of its two sides, (S_i, G1) and
//   (H_i, -PK_i), and their product in Fp12.  Replaces _miller_product_stage
//   and _multi_miller_stage (miller_loop, _dbl_step, _add_step).  Two
//   threads a lane, one a side, in one warp; the second side's value goes
//   through shared memory to the first, which multiplies.  The loop runs the
//   five addition steps on the set bits of |x| only, where the JAX program
//   computes one on every bit and selects.
// * bls_final_exp: per lane f^(3 (p^12 - 1) / r) == 1, gated on the lane's
//   flag (its aggregates are not infinity and the lane is live), and the
//   Fp12 result where asked.  Replaces _easy_part_stage, _hard_part_stage,
//   _finish_stage and f12_eq_one.  One thread a lane.
//
// What bounds them on an H100: operations.  A lane's Miller loop is about
// 7,000 field products and its final exponentiation about 20,000, each 288
// 32-bit multiply-adds; inputs and outputs are a few hundred bytes.  This
// first version is one thread a lane (two for the Miller loop) with the
// state in local memory: a 100-validator check is one Miller lane and one
// final-exponentiation lane, so the time is one thread's dependency chain.
// Spreading a lane's field products over a warp is a later redesign.
//
// The lane arithmetic is in bls12_381.cuh.  Under a host C++ compiler this
// file builds the _host entry points instead of the kernels: the same lane
// functions, a group's 128 "threads" and a lane's two sides one after the
// other, which the CPU tests hold against the host oracle.

#include "bls12_381.cuh"

namespace {

constexpr int kMergeThreads = 128;  // threads a group
constexpr int kMillerLanes = 32;    // lanes a block, two threads each
constexpr int kExpLanes = 32;       // lanes a block, one thread each
constexpr int kF12Words = 12 * bls::kWords;

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

__global__ void __launch_bounds__(2 * kMillerLanes)
bls_miller_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ p, long long n,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t second[kMillerLanes][kF12Words];  // 18 KB
  const int local = threadIdx.x >> 1;
  const int side = threadIdx.x & 1;
  const long long i = static_cast<long long>(blockIdx.x) * kMillerLanes + local;
  bls::Fp12 f;
  if (i < n) {
    const uint32_t* qs = q + (side * n + i) * 4 * bls::kWords;
    const uint32_t* ps = p + (side * n + i) * 2 * bls::kWords;
    f = bls::miller_loop(bls::load2(qs), bls::load2(qs + 2 * bls::kWords), bls::load(ps),
                         bls::load(ps + bls::kWords));
    if (side == 1) {
      bls::store12(second[local], f);
    }
  }
  __syncthreads();
  if (i < n && side == 0) {
    bls::store12(out + i * kF12Words, bls::mul(f, bls::load12(second[local])));
  }
}

__global__ void __launch_bounds__(kExpLanes)
bls_final_exp_kernel(const uint32_t* __restrict__ f, const uint8_t* __restrict__ gate, long long n,
                     uint8_t* __restrict__ ok, uint32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kExpLanes + threadIdx.x;
  if (i >= n) {
    return;
  }
  const bls::Fp12 r = bls::final_exp(bls::load12(f + i * kF12Words));
  ok[i] = gate[i] != 0 && bls::is_one(r);
  if (out != nullptr) {
    bls::store12(out + i * kF12Words, r);
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
// (2, n, 2) (the G1 points) -> out: n x 12 field elements (Fp12).
extern "C" int bls_miller(const void* q, const void* p, long long n, void* out, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kMillerLanes - 1) / kMillerLanes;
  bls_miller_kernel<<<static_cast<unsigned int>(blocks), 2 * kMillerLanes, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(p), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// f: n x 12 field elements, gate: n bytes -> ok: n bytes, and out (n x 12
// field elements, the exponentiation's result) unless it is null.
extern "C" int bls_final_exp(const void* f, const void* gate, long long n, void* ok, void* out,
                             void* stream) {
  if (n <= 0) {
    return 0;
  }
  const long long blocks = (n + kExpLanes - 1) / kExpLanes;
  bls_final_exp_kernel<<<static_cast<unsigned int>(blocks), kExpLanes, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<const uint8_t*>(gate), n,
      static_cast<uint8_t*>(ok), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

#else

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
  for (long long i = 0; i < n; ++i) {
    bls::Fp12 f[2];
    for (int side = 0; side < 2; ++side) {
      const uint32_t* qs = q + (side * n + i) * 4 * bls::kWords;
      const uint32_t* ps = p + (side * n + i) * 2 * bls::kWords;
      f[side] = bls::miller_loop(bls::load2(qs), bls::load2(qs + 2 * bls::kWords), bls::load(ps),
                                 bls::load(ps + bls::kWords));
    }
    bls::store12(out + i * kF12Words, bls::mul(f[0], f[1]));
  }
  return 0;
}

extern "C" int bls_final_exp_host(const uint32_t* f, const uint8_t* gate, long long n, uint8_t* ok,
                                  uint32_t* out) {
  for (long long i = 0; i < n; ++i) {
    const bls::Fp12 r = bls::final_exp(bls::load12(f + i * kF12Words));
    ok[i] = gate[i] != 0 && bls::is_one(r);
    if (out != nullptr) {
      bls::store12(out + i * kF12Words, r);
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

// Fp12 operations on n elements: op 0 a * b, 1 a^2, 2 a^-1, 3 a^p, 4 a^(p^2),
// 5 a^(p^6).
extern "C" int bls_f12_op_host(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    const bls::Fp12 x = bls::load12(a + i * kF12Words);
    bls::Fp12 r;
    switch (op) {
      case 0: r = bls::mul(x, bls::load12(b + i * kF12Words)); break;
      case 1: r = bls::sqr(x); break;
      case 2: r = bls::inv(x); break;
      case 3: r = bls::frob(x, 1); break;
      case 4: r = bls::frob(x, 2); break;
      default: r = bls::conj(x); break;
    }
    bls::store12(out + i * kF12Words, r);
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
