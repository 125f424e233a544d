// Furthest point sampling (D-FPS) for Hopper (sm_90a).
//
// Replaces: nesie_tpu/ops/pallas_fps.py::_fps_batched_kernel (and the
// single-row _fps_kernel, which computes the same function for clouds too
// large for the TPU's VMEM budget; this kernel has no such bound).
//
// Semantics: slot 0 is index 0 with every distance at 1e10. Each of the
// M-1 following steps sets dist[i] = min(dist[i], |p_i - p_last|^2) and
// picks the argmax of dist, the lowest index among equal values.
//
// What bounds it on the H100: the M-1 steps are dependent, and each ends
// in a block-wide (value, index) reduction. At B=32, N=40000, M=2048 that
// is 2047 reductions of 40000 values per row, each behind two
// __syncthreads(). The bytes per step (12 B of coordinates + 8 B of
// distance read/write per point) stay in the 50 MB L2: 32 rows of
// 40000 x 16 B are 20 MB.
//
// The simple design: one block of 1024 threads per batch row, a
// strided loop over the row's points, a thread-local best, a warp-shuffle
// reduction and a shared-memory reduction across the 32 warps. Thread 0
// writes the slot and publishes the next point. The min-distance cache is
// a global scratch buffer that the wrapper allocates. Only B blocks run,
// so at B=32 only 32 of the 132 SMs are busy; splitting a row across a
// cluster is later work.
//
// The squared distance is sq_dist.cuh's, free of FMA contraction: a
// contracted sum can flip a near-tie argmax, and a flip changes every
// later step.

#include <cuda_runtime.h>

#include "sq_dist.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (bv, bi): larger value, or equal value at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int m,
           float* __restrict__ dist, int* __restrict__ out) {
  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* d = dist + static_cast<size_t>(b) * n;
  int* o = out + static_cast<size_t>(b) * m;

  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int last_shared;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < n; i += kThreads) d[i] = 1e10f;
  if (tid == 0) {
    o[0] = 0;
    last_shared = 0;
  }
  __syncthreads();

  for (int step = 1; step < m; ++step) {
    const int last = last_shared;
    const float lx = p[last * 3 + 0];
    const float ly = p[last * 3 + 1];
    const float lz = p[last * 3 + 2];

    float best_v = -1.0f;
    int best_i = n;
    for (int i = tid; i < n; i += kThreads) {
      const float nd = fminf(
          d[i], sq_dist(p[i * 3 + 0], p[i * 3 + 1], p[i * 3 + 2], lx, ly, lz));
      d[i] = nd;
      if (nd > best_v) {  // ascending i: the first of equal values stays
        best_v = nd;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, best_v, off);
      const int i = __shfl_down_sync(0xffffffffu, best_i, off);
      if (better(v, i, best_v, best_i)) {
        best_v = v;
        best_i = i;
      }
    }
    if (lane == 0) {
      warp_val[warp] = best_v;
      warp_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = warp_val[lane];
      best_i = warp_idx[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, best_v, off);
        const int i = __shfl_down_sync(0xffffffffu, best_i, off);
        if (better(v, i, best_v, best_i)) {
          best_v = v;
          best_i = i;
        }
      }
      if (lane == 0) {
        o[step] = best_i;
        last_shared = best_i;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int nesie_fps(const void* xyz, int b, int n, int m, void* dist,
                         void* out, void* stream) {
  fps_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, m, static_cast<float*>(dist),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
