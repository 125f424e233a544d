// Radius ball query for Hopper (sm_90a).
//
// Replaces: nesie_tpu/ops/pallas_ball_query.py::_bq_kernel.
//
// Semantics: for each center, the first K source indices, in index order,
// whose squared distance d2 satisfies d2 <= 0 or min_r2 <= d2 < max_r2.
// Slots past the hit count repeat the first hit; a center with no hit gets
// all zeros. d2 is sq_dist.cuh's exact ((dx*dx + dy*dy) + dz*dz) form,
// free of FMA contraction, which could move a point across the radius.
//
// What bounds it on the H100: the bytes of source coordinates read per
// center. A center whose ball holds fewer than K points scans all N
// points: 12 B x 40000 = 480 KB per center at SA1, 65536 centers at B=32.
// One row's coordinates (480 KB) stay in L2, so the scan runs at L2 rate.
//
// The simple design: one warp per center. Each lane tests one point of a
// 32-point chunk; __ballot_sync gives the chunk's hits as a bit mask, and
// __popc of the bits below a lane gives that hit's slot, so the hits are
// written in index order with no serial loop. The warp stops as soon as K
// hits are found. No restriction on M, unlike the Pallas kernel's
// M % 128 == 0.

#include <cuda_runtime.h>

#include "sq_dist.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int b, int n, int m,
                  int k, float min_r2, float max_r2, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long center =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (center >= static_cast<long long>(b) * m) return;  // whole warp exits
  const long long row = center / m;
  const float* p = xyz + row * n * 3;
  const float cx = centers[center * 3 + 0];
  const float cy = centers[center * 3 + 1];
  const float cz = centers[center * 3 + 2];
  int* o = out + center * k;

  int count = 0;
  int first = 0;
  for (int base = 0; base < n && count < k; base += 32) {
    const int i = base + lane;
    bool ok = false;
    if (i < n) {
      const float d2 = sq_dist(p[i * 3 + 0], p[i * 3 + 1], p[i * 3 + 2],
                               cx, cy, cz);
      ok = d2 <= 0.0f || (d2 >= min_r2 && d2 < max_r2);
    }
    const unsigned hits = __ballot_sync(0xffffffffu, ok);
    if (hits == 0u) continue;
    if (count == 0) first = base + __ffs(hits) - 1;
    const int slot = count + __popc(hits & ((1u << lane) - 1u));
    if (ok && slot < k) o[slot] = i;
    count += __popc(hits);
  }
  if (count > k) count = k;
  const int fill = count == 0 ? 0 : first;
  for (int s = count + lane; s < k; s += 32) o[s] = fill;
}

}  // namespace

extern "C" int nesie_ball_query(const void* xyz, const void* centers, int b,
                                int n, int m, int k, float min_r2,
                                float max_r2, void* out, void* stream) {
  const long long warps = static_cast<long long>(b) * m;
  const int blocks =
      static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers), b,
      n, m, k, min_r2, max_r2, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
