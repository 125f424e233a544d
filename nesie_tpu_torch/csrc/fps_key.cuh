// The (value, index) key the on-chip FPS kernel (fps_onchip.cu) reduces
// across the threads and CTAs of a row.
//
// A pair packs into one 64-bit key whose unsigned order is fps_ref's tie
// rule: larger value first, then lower index. Distances are >= 0, so
// their float bits order as unsigned integers; key 0 is "no point". The
// order is total on distinct indices, so every CTA of a cluster reduces
// the same candidates to the same winner, in any order.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long pack(float v, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         (0xffffffffu - static_cast<unsigned>(i));
}

__device__ __forceinline__ int unpack_index(unsigned long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

// the largest key of the warp, in lane 0
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, k, off);
    k = o > k ? o : k;
  }
  return k;
}

// A CTA's (or a warp's) best point: its key and its coordinates.
struct Candidate {
  unsigned long long key;
  float x, y, z;
};
