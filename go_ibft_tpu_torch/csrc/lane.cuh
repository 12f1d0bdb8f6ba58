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
