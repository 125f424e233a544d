// Three nearest neighbours for Hopper (sm_90a).
//
// Replaces: nesie_tpu/ops/pallas_three_nn.py::_three_nn_kernel.
//
// Semantics: for each query, the indices of the 3 nearest sources by the
// exact squared distance ((dx*dx + dy*dy) + dz*dz), ascending, the lower
// index first among equal distances. A linear scan in index order with a
// best-3 insertion on strict '<' gives exactly that order, the same as the
// Pallas kernel's three masked argmin passes. The distance is
// sq_dist.cuh's, free of FMA contraction.
// The caller recomputes the returned distances from the indices.
//
// What bounds it on the H100: the bytes of source coordinates read per
// query, 12 B x N. On the eval path N is 256 to 1024 and there are up to
// 24576 queries per scene, so every source is read many thousand times.
//
// The simple design: one thread per query, one batch row per block
// column (gridDim.y = B). The block stages the row's sources through
// shared memory in tiles of 1024 points (12 KB), so each source is read
// from device memory once per block and from shared memory (a broadcast:
// all threads read the same address) for every query.

#include <cuda_runtime.h>

#include "sq_dist.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query,
                const float* __restrict__ source, int m, int n,
                int* __restrict__ idx) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < m;
  const float* src = source + static_cast<size_t>(b) * n * 3;
  const size_t qoff = (static_cast<size_t>(b) * m + (active ? q : 0)) * 3;
  const float qx = active ? query[qoff + 0] : 0.0f;
  const float qy = active ? query[qoff + 1] : 0.0f;
  const float qz = active ? query[qoff + 2] : 0.0f;

  float b1 = __int_as_float(0x7f800000), b2 = b1, b3 = b1;  // +inf
  int i1 = 0, i2 = 0, i3 = 0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < len; j += kThreads) {
      sx[j] = src[(t0 + j) * 3 + 0];
      sy[j] = src[(t0 + j) * 3 + 1];
      sz[j] = src[(t0 + j) * 3 + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < len; ++j) {
      const float d = sq_dist(sx[j], sy[j], sz[j], qx, qy, qz);
      if (d < b3) {
        const int i = t0 + j;
        if (d < b2) {
          b3 = b2;
          i3 = i2;
          if (d < b1) {
            b2 = b1;
            i2 = i1;
            b1 = d;
            i1 = i;
          } else {
            b2 = d;
            i2 = i;
          }
        } else {
          b3 = d;
          i3 = i;
        }
      }
    }
  }
  if (active) {
    int* o = idx + (static_cast<size_t>(b) * m + q) * 3;
    o[0] = i1;
    o[1] = i2;
    o[2] = i3;
  }
}

}  // namespace

extern "C" int nesie_three_nn(const void* query, const void* source, int b,
                              int m, int n, void* idx, void* stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(source), m,
      n, static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
