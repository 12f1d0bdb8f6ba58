// Qualifiers for the per-lane arithmetic that the port's kernels share.
//
// Under nvcc the lane functions are __device__ and their tables live in
// __constant__ memory.  Under a host C++ compiler (the CPU tests build the
// same sources with g++ to check the lane arithmetic against the host
// oracle) they are plain inline functions and static tables.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define LANE_FN __device__ __forceinline__
#define LANE_TABLE __constant__
#else
#define LANE_FN inline
#define LANE_TABLE static const
#endif

// A group of kThreads consecutive threads of one warp that hold one lane's
// values together, each thread a copy of them: the shuffle layer of the
// kernels that spread a lane's independent products over threads.
// step(out, f) has thread t of the group compute f(t) for t < kCount (the
// threads past kCount compute f(kCount - 1) again) and gives every thread
// the kCount results: on the card one __shfl_sync a 32-bit word of each
// result; on the host, where the group is a loop over its threads, f(t)
// for each t in turn.  A result type holds its words in an array `w`.
// Between steps the group's threads take the same branches, which copies of
// one lane's values do.
template <int kThreads>
struct Group {
#if defined(__CUDACC__)
  int rank;       // the thread's place in its group
  uint32_t mask;  // the group's threads in their warp

  LANE_FN static Group of_thread(unsigned thread) {
    const unsigned first = (thread % 32u) / kThreads * kThreads;
    return Group{static_cast<int>(thread % kThreads), ((1u << kThreads) - 1u) << first};
  }
  LANE_FN bool leader() const { return rank == 0; }
  LANE_FN void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp(mask);
#endif
  }
#else
  LANE_FN bool leader() const { return true; }
  LANE_FN void sync() const {}
#endif

  template <int kCount, class T, class F>
  LANE_FN void step(T (&out)[kCount], F f) const {
    static_assert(kCount <= kThreads, "one result a thread");
#if defined(__CUDA_ARCH__)
    const T mine = f(rank < kCount ? rank : kCount - 1);
    constexpr int kWords = sizeof(mine.w) / sizeof(mine.w[0]);
#pragma unroll
    for (int k = 0; k < kCount; ++k) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        out[k].w[i] = __shfl_sync(mask, mine.w[i], k, kThreads);
      }
    }
#else
    for (int t = 0; t < kCount; ++t) {
      out[t] = f(t);
    }
#endif
  }
};
