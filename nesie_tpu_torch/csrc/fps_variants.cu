// The FPS lab's step variants for Hopper (sm_90a).
//
// Replaces the step bodies of the TPU FPS lab, one instantiation of
// fps_variant_kernel each (the variant id is the C entry point's first
// argument; nesie_tpu_torch/ops/fps_variants.py names them):
//
//   id  name         TPU kernel                                  select fetch rows unroll
//   0   v2_merged    tools/fps_lab.py:45  _v2_kernel             S2     F2    1    1
//   1   v3_blocked   tools/fps_lab.py:112 _v3_kernel             S2     F3    1    1
//   2   v4_blocked2  tools/fps_lab.py:150 _v4_kernel             S3     F3    1    1
//   3   v1           tools/fps_experiments.py:86  _kernel_v12    S2     F1    1    1
//                    with _tie_argmax_sum (:57)
//   4   v2           tools/fps_experiments.py:86  _kernel_v12    S4     F1    1    1
//                    with _tie_bitcast (:67)
//   5   v3           tools/fps_experiments.py:106 _kernel_v3     S4     F1    2    1
//   6   v4           tools/fps_experiments.py:134 _kernel_v4     S4     F2    1    1
//   7   v5           the same, unroll=4 (:262)                   S4     F2    1    4
//
// Every variant computes exactly fps.cu's D-FPS (slot 0 is index 0, every
// distance starts at 1e10, each step takes min(dist, |p - p_last|^2) from
// sq_dist.cuh and the lowest index of the maximum). All keep fps.cu's
// frame (fps.cu:45-115): one block of 1024 threads per row, a strided loop
// over the row's points, the min-distance cache in a global scratch. So
// each differs from fps.cu only by its own idea.
//
// What bounds them on the H100 is what bounds fps.cu (fps.cu:11-16): the
// M-1 dependent steps, each a pass over the row (40000 x 16 B of
// coordinates and distance a row, which stays in the 50 MB L2) that ends
// in block-wide reductions behind __syncthreads(). The ideas move the
// reduction latency and the fetch of the next point, not the bytes:
//
// Select, how the next index is found:
//   S2 max-then-min: a block max of the values, then a block min of the
//      index over the threads whose local first maximum equals it. Two
//      block reductions (four barriers a step, fps.cu has two), each with
//      one shuffle a level instead of fps.cu's two.
//   S3 argmax-refetch-min: a block max that keeps any index, the value
//      read back from the distance cache by that index (the TPU's dynamic
//      load from the blocked cache) by one thread and shared, then the min
//      index among equal values. Also four barriers.
//   S4 bitcast-redux: distances are >= +0 and finite, so their bits order
//      as uint32: __reduce_max_sync of the bits, then __reduce_min_sync of
//      the index over the lanes holding that max. redux.sync is one
//      instruction a warp where a shuffle tree is five levels; warp 0 does
//      the same across the block's warps. Two barriers, as fps.cu. A
//      thread that holds no point contributes (0, n), which never wins a
//      tie against a real index.
// Fetch, where the next step's centre comes from (and the layout the
// point loop reads):
//   F1 aos3: every thread loads p[last*3 + 0..2] from the (B, N, 3) input
//      at the start of the step (fps.cu's form).
//   F2 merged4: the point loop reads one 16-byte float4 a point from a
//      (B, N, 4) padded copy; the thread that decides the winner loads its
//      float4 and hands the coordinates to the block through shared
//      memory with the index (the TPU's one merged fetch).
//   F3 soa: the same hand-over, with three loads by index from a (B, 3, N)
//      copy that the point loop also reads (the TPU's dynamic load from
//      its blocked layout).
// Rows: v3 carries two rows in a block (the TPU's two interleaved row
// chains): one point loop updates both, and both rows' reductions share
// each redux step and barrier. An odd B leaves the last block one row.
// Unroll: v5 puts `#pragma unroll 4` on the step loop, as the TPU's
// fori_loop(unroll=4). nvcc 12.9 (-O3, sm_90a) does unroll it 4x and keeps
// a remainder loop: `cuobjdump -sass` of the built library counts 11
// BAR.SYNC and 20 REDUX in v5's kernel against 3 and 4 in v4's. Every
// instantiation takes 31-32 registers and spills nothing (-Xptxas -v).

#include <cuda_runtime.h>

#include "sq_dist.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

enum Select { kMaxThenMin, kRefetch, kBitcast };
enum Fetch { kAos3, kMerged4, kSoa };

template <int kSelect, int kFetch, int kRows, int kUnroll>
__global__ void __launch_bounds__(kThreads)
fps_variant_kernel(const float* __restrict__ xyz, const float* __restrict__ aux,
                   int b, int n, int m, float* __restrict__ dist,
                   int* __restrict__ out) {
  const int row0 = blockIdx.x * kRows;
  const int rows = kRows == 1 ? 1 : min(kRows, b - row0);

  __shared__ float red_v[kRows][kWarps];
  __shared__ unsigned red_k[kRows][kWarps];
  __shared__ int red_i[kRows][kWarps];
  __shared__ float max_sh[kRows];  // S2/S3: the max, between two reductions
  __shared__ int last_sh[kRows];
  __shared__ float last_xyz[kRows][3];  // F2/F3: the winner's coordinates

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* pts[kRows];
  float* d[kRows];
  int* o[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t row = row0 + min(r, rows - 1);  // a missing row is never read
    pts[r] = kFetch == kAos3 ? xyz + row * n * 3
                             : aux + row * n * (kFetch == kMerged4 ? 4 : 3);
    d[r] = dist + row * n;
    o[r] = out + row * m;
  }
  auto load = [&](int r, int i) -> float3 {
    if constexpr (kFetch == kAos3) {
      return make_float3(pts[r][i * 3 + 0], pts[r][i * 3 + 1],
                         pts[r][i * 3 + 2]);
    } else if constexpr (kFetch == kMerged4) {
      const float4 q = reinterpret_cast<const float4*>(pts[r])[i];
      return make_float3(q.x, q.y, q.z);
    } else {
      return make_float3(pts[r][i], pts[r][n + i], pts[r][2 * n + i]);
    }
  };
  // warp 0, lane 0: write the slot and hand the winner to the block
  auto publish = [&](int r, int step, int idx) {
    o[r][step] = idx;
    last_sh[r] = idx;
    if constexpr (kFetch != kAos3) {
      const float3 q = load(r, idx);
      last_xyz[r][0] = q.x;
      last_xyz[r][1] = q.y;
      last_xyz[r][2] = q.z;
    }
  };

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      for (int i = tid; i < n; i += kThreads) d[r][i] = 1e10f;
      if (tid == 0) publish(r, 0, 0);
    }
  }
  __syncthreads();

#pragma unroll (kUnroll)
  for (int step = 1; step < m; ++step) {
    float lx[kRows], ly[kRows], lz[kRows], best_v[kRows];
    int best_i[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if constexpr (kFetch == kAos3) {
        const float3 q = load(r, r < rows ? last_sh[r] : 0);
        lx[r] = q.x;
        ly[r] = q.y;
        lz[r] = q.z;
      } else {
        lx[r] = last_xyz[r][0];
        ly[r] = last_xyz[r][1];
        lz[r] = last_xyz[r][2];
      }
      best_v[r] = -1.0f;
      best_i[r] = n;
    }
    for (int i = tid; i < n; i += kThreads) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float3 q = load(r, i);
          const float nd =
              fminf(d[r][i], sq_dist(q.x, q.y, q.z, lx[r], ly[r], lz[r]));
          d[r][i] = nd;
          if (nd > best_v[r]) {  // ascending i: the first of equal values
            best_v[r] = nd;
            best_i[r] = i;
          }
        }
      }
    }

    if constexpr (kSelect == kBitcast) {
      unsigned key[kRows];
      int idx[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        key[r] = best_i[r] < n ? __float_as_uint(best_v[r]) : 0u;
        const unsigned kmax = __reduce_max_sync(kAll, key[r]);
        idx[r] = static_cast<int>(__reduce_min_sync(
            kAll, static_cast<unsigned>(key[r] == kmax ? best_i[r] : n)));
        key[r] = kmax;
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          red_k[r][warp] = key[r];
          red_i[r][warp] = idx[r];
        }
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const unsigned k = red_k[r][lane];
          const unsigned kmax = __reduce_max_sync(kAll, k);
          const int win = static_cast<int>(__reduce_min_sync(
              kAll, static_cast<unsigned>(k == kmax ? red_i[r][lane] : n)));
          if (lane == 0 && r < rows) publish(r, step, win);
        }
      }
      __syncthreads();
    } else {
      // first reduction: the block's max value (S2), or the max with any
      // of its indices, whose value is then read back by index (S3)
      float v[kRows];
      int vi[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        v[r] = best_v[r];
        vi[r] = best_i[r];
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(kAll, v[r], off);
          if constexpr (kSelect == kRefetch) {
            const int oi = __shfl_down_sync(kAll, vi[r], off);
            if (ov > v[r]) {
              v[r] = ov;
              vi[r] = oi;
            }
          } else {
            v[r] = fmaxf(v[r], ov);
          }
        }
        if (lane == 0) {
          red_v[r][warp] = v[r];
          red_i[r][warp] = vi[r];
        }
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          v[r] = red_v[r][lane];
          vi[r] = red_i[r][lane];
          for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(kAll, v[r], off);
            if constexpr (kSelect == kRefetch) {
              const int oi = __shfl_down_sync(kAll, vi[r], off);
              if (ov > v[r]) {
                v[r] = ov;
                vi[r] = oi;
              }
            } else {
              v[r] = fmaxf(v[r], ov);
            }
          }
          if (lane == 0 && r < rows) {
            max_sh[r] = kSelect == kRefetch ? d[r][vi[r]] : v[r];
          }
        }
      }
      __syncthreads();
      // second reduction: the lowest index whose value equals the max
      int c[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        c[r] = (r < rows && best_v[r] == max_sh[r]) ? best_i[r] : n;
        for (int off = 16; off > 0; off >>= 1) {
          c[r] = min(c[r], __shfl_down_sync(kAll, c[r], off));
        }
        if (lane == 0) red_i[r][warp] = c[r];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          c[r] = red_i[r][lane];
          for (int off = 16; off > 0; off >>= 1) {
            c[r] = min(c[r], __shfl_down_sync(kAll, c[r], off));
          }
          if (lane == 0 && r < rows) publish(r, step, c[r]);
        }
      }
      __syncthreads();
    }
  }
}

template <int kSelect, int kFetch, int kRows, int kUnroll>
int launch(const void* xyz, const void* aux, int b, int n, int m, void* dist,
           void* out, void* stream) {
  fps_variant_kernel<kSelect, kFetch, kRows, kUnroll>
      <<<(b + kRows - 1) / kRows, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(xyz), static_cast<const float*>(aux), b,
          n, m, static_cast<float*>(dist), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// aux: the (B, N, 4) copy for F2, the (B, 3, N) copy for F3, unread for F1.
extern "C" int nesie_fps_variant(int variant, const void* xyz, const void* aux,
                                 int b, int n, int m, void* dist, void* out,
                                 void* stream) {
  switch (variant) {
    case 0: return launch<kMaxThenMin, kMerged4, 1, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 1: return launch<kMaxThenMin, kSoa, 1, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 2: return launch<kRefetch, kSoa, 1, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 3: return launch<kMaxThenMin, kAos3, 1, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 4: return launch<kBitcast, kAos3, 1, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 5: return launch<kBitcast, kAos3, 2, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 6: return launch<kBitcast, kMerged4, 1, 1>(xyz, aux, b, n, m, dist, out, stream);
    case 7: return launch<kBitcast, kMerged4, 1, 4>(xyz, aux, b, n, m, dist, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
