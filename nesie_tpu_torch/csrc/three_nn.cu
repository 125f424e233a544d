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
// What bounds it on the H100: instruction slots. Every (query, source) pair
// costs the 8 operations of sq_dist.cuh, which may not contract into
// FMAs, and one compare: about 9 slots a pair at 128 lanes an SM. The
// eval path's side grid is 32 x 24576 queries against 1024 seeds, 805M
// pairs, about 0.22 ms at that floor; the bytes (the row's 12 KB read
// once a block) are far below it.
//
// The design: a block of T threads serves T x Q queries of one batch row
// (gridDim.y = B); each thread holds Q queries (Q in {1, 2, 4}, a
// compile-time constant) and their best three (distance, index) pairs in
// registers. The block stages its row's sources into shared memory once,
// as x[], y[] and z[] padded to a multiple of 4, read as 16-byte
// broadcasts (every thread reads the same address), so one shared load
// serves four sources for Q queries. The inner loop is unrolled by 4 over
// the padded row, and a query tests the least of its four distances
// against its third best before it inserts them in index order. The
// padding sources have NaN coordinates: their distance is NaN, every '<'
// on NaN is false, so they are never inserted. Rows longer than kTile
// points (past the main path's N <= 1024) are scanned in tiles of kTile,
// in index order, with the same code.
//
// Beside the arithmetic, a warp runs the insertion whenever any of its
// lanes inserts. One compare for four sources lets a warp skip a group
// when none of its queries would insert any of them, which happens most
// where a warp's queries lie close together (the grids' box faces).
//
// The host plan picks Q: the largest whose grid still gives every SM
// kMinWarpsPerSm warps of queries, else Q=1 (a request's FP queries,
// 1024 a row); T is 256.

#include <cuda_runtime.h>

#include "sq_dist.cuh"

namespace {

constexpr int kTile = 2048;  // sources staged at once: 24 KB
constexpr int kMinWarpsPerSm = 16;
constexpr int kThreads = 256;

struct Best3 {
  float b1, b2, b3;
  int i1, i2, i3;
};

__device__ __forceinline__ void insert(Best3& r, float d, int i) {
  if (d < r.b3) {
    if (d < r.b2) {
      r.b3 = r.b2;
      r.i3 = r.i2;
      if (d < r.b1) {
        r.b2 = r.b1;
        r.i2 = r.i1;
        r.b1 = d;
        r.i1 = i;
      } else {
        r.b2 = d;
        r.i2 = i;
      }
    } else {
      r.b3 = d;
      r.i3 = i;
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query,
                const float* __restrict__ source, int m, int n,
                int* __restrict__ idx) {
  extern __shared__ float4 s4[];  // x[tile4], y[tile4], z[tile4]
  const int b = blockIdx.y;
  const int nthreads = blockDim.x;
  const float* src = source + static_cast<size_t>(b) * n * 3;
  const int tile = min(n, kTile);
  const int groups = (tile + 3) >> 2;  // float4 groups of a full tile
  float* sx = reinterpret_cast<float*>(s4);
  float* sy = sx + 4 * groups;
  float* sz = sy + 4 * groups;
  const float4* x4 = s4;
  const float4* y4 = s4 + groups;
  const float4* z4 = s4 + 2 * groups;

  float qx[Q], qy[Q], qz[Q];
  Best3 r[Q];
  const int base = blockIdx.x * nthreads * Q + threadIdx.x;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = min(base + k * nthreads, m - 1);  // a spare slot repeats
    const float* qp = query + (static_cast<size_t>(b) * m + q) * 3;
    qx[k] = qp[0];
    qy[k] = qp[1];
    qz[k] = qp[2];
    const float inf = __int_as_float(0x7f800000);
    r[k] = Best3{inf, inf, inf, 0, 0, 0};
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    const int g = (len + 3) >> 2;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < 4 * g; j += nthreads) {
      const bool real = j < len;
      const float nan = __int_as_float(0x7fc00000);
      const size_t e = static_cast<size_t>(t0 + j) * 3;
      sx[j] = real ? src[e + 0] : nan;
      sy[j] = real ? src[e + 1] : nan;
      sz[j] = real ? src[e + 2] : nan;
    }
    __syncthreads();
    for (int c = 0; c < g; ++c) {
      const float4 x = x4[c];
      const float4 y = y4[c];
      const float4 z = z4[c];
      const int i = t0 + 4 * c;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float d0 = sq_dist(x.x, y.x, z.x, qx[k], qy[k], qz[k]);
        const float d1 = sq_dist(x.y, y.y, z.y, qx[k], qy[k], qz[k]);
        const float d2 = sq_dist(x.z, y.z, z.z, qx[k], qy[k], qz[k]);
        const float d3 = sq_dist(x.w, y.w, z.w, qx[k], qy[k], qz[k]);
        // one compare for the four: fminf skips a NaN, so a group of
        // padding alone compares NaN and is skipped too
        if (fminf(fminf(d0, d1), fminf(d2, d3)) < r[k].b3) {
          insert(r[k], d0, i);
          insert(r[k], d1, i + 1);
          insert(r[k], d2, i + 2);
          insert(r[k], d3, i + 3);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = base + k * nthreads;
    if (q < m) {
      int* o = idx + (static_cast<size_t>(b) * m + q) * 3;
      o[0] = r[k].i1;
      o[1] = r[k].i2;
      o[2] = r[k].i3;
    }
  }
}

using Kernel = void (*)(const float*, const float*, int, int, int*);

struct Plan {
  int q;
  int threads;
  Kernel fn;
};

int multiprocessors() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess) {
      cudaGetLastError();
      count = 1;
    }
  }
  return count;
}

// q: 0 lets the plan choose. False for a q the kernel does not take.
bool make_plan(int b, int m, int q, Plan* plan) {
  if (!(q == 0 || q == 1 || q == 2 || q == 4)) return false;
  plan->threads = kThreads;
  if (q == 0) {
    const long long queries = static_cast<long long>(b) * m;
    const long long want = 32LL * kMinWarpsPerSm * multiprocessors();
    q = queries >= 4 * want ? 4 : queries >= 2 * want ? 2 : 1;
  }
  plan->q = q;
  plan->fn = q == 4   ? three_nn_kernel<4>
             : q == 2 ? three_nn_kernel<2>
                      : three_nn_kernel<1>;
  return true;
}

}  // namespace

// The plan a launch of (b, m) queries takes: queries a thread, threads a
// block. q: 0 lets the plan choose (q in {1, 2, 4}).
extern "C" int nesie_three_nn_plan(int b, int m, int q, void* plan_out) {
  Plan plan;
  if (!make_plan(b, m, q, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(plan_out);
  o[0] = plan.q;
  o[1] = plan.threads;
  return 0;
}

extern "C" int nesie_three_nn(const void* query, const void* source, int b,
                              int m, int n, int q, void* idx,
                              void* stream) {
  Plan plan;
  if (!make_plan(b, m, q, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = plan.threads * plan.q;
  const dim3 grid((m + per_block - 1) / per_block, b);
  const int tile = n < kTile ? n : kTile;
  const size_t smem = 3 * sizeof(float4) * ((tile + 3) / 4);
  plan.fn<<<grid, plan.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(source), m,
      n, static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
