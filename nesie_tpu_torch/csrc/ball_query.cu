// Radius ball query for Hopper (sm_90a), with the row's points shared by
// a CTA's centers through shared memory.
//
// Replaces: nesie_tpu/ops/pallas_ball_query.py::_bq_kernel.
//
// Semantics: for each center, the first K source indices, in index order,
// whose squared distance d2 satisfies d2 <= 0 or min_r2 <= d2 < max_r2.
// Slots past the hit count repeat the first hit; a center with no hit gets
// all zeros. d2 is sq_dist.cuh's exact ((dx*dx + dy*dy) + dz*dz) form,
// free of FMA contraction, which could move a point across the radius.
//
// What bounds it on the H100: the (center, point) pairs tested. A center
// whose ball holds fewer than K points tests all N points; at SA1 (B=32,
// 40000 -> 2048, r 0.2, K 64) nearly every center does, about 2.6e9
// pairs of ~12 instructions. One warp per center (the first design)
// made every warp stream its row's 480 KB of coordinates from L1/L2,
// 31.5 GB at SA1, though a CTA's warps all scanned the same row.
//
// The design: one CTA takes T centers of one row (T in 32..256, one
// thread per center). The CTA stages the row through shared memory in
// tiles of 1024 points, double-buffered with cp.async, so each CTA reads
// its row from L2 once (about 1 GB at SA1). Every thread scans the tile
// in index order with broadcast reads (three 16-byte loads cover four
// points) and appends its hits in order, so no ballot or prefix sum is
// needed. Past the row's end the tile holds NaN, which no test accepts.
// A thread stops testing at K hits; the CTA stops staging once all its
// centers hold K (__syncthreads_and after each tile). The (T, K) result
// is staged in shared memory, slot-major with a stride of T + 1 words
// (a thread's appends and the write-out's reads fall on distinct banks),
// and written out coalesced. With min_r2 = 0 < max_r2 the test is the
// single compare d2 < max_r2 (the same set: d2 >= 0, and d2 <= 0 only
// at 0). The host halves T from 256 while the grid would hold fewer CTAs
// than the card has SMs, so the small shapes (SA2-SA4, the aggregation)
// still fill the card.
//
// A query of too few centers to give every SM kMinCentersPerSm threads (a
// Detector request's B=1, the small queries of the semi step) would leave
// the tile kernel a few warps each scanning serially. It takes the first
// design instead, one warp per center (ball_query_warp_kernel): each lane
// tests one point of a 32-point chunk, __ballot_sync gives the chunk's
// hits, and __popc of the bits below a lane gives that hit's slot.

#include <cuda_runtime.h>

#include "sq_dist.cuh"

namespace {

constexpr int kTile = 1024;  // points per shared-memory tile
constexpr int kMaxCenters = 256;
constexpr int kTileBytes = 2 * 3 * kTile * 4;  // both buffers
// fewer centers than this per SM take the warp-per-center kernel
constexpr int kMinCentersPerSm = 64;
constexpr int kWarpsPerBlock = 8;  // of the warp-per-center kernel

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying points [i0, i0 + kTile) of the row into a tile as
// (x, y, z) triples; points past n become NaN.
__device__ __forceinline__ void stage(float* tile, const float* p, int n,
                                      int i0) {
  const int valid = 3 * min(kTile, n - i0);
  const float* src = p + static_cast<size_t>(i0) * 3;
  for (int e = threadIdx.x; e < 3 * kTile; e += blockDim.x) {
    if (e < valid) {
      copy_async4(tile + e, src + e);
    } else {
      tile[e] = __int_as_float(0x7fc00000);
    }
  }
  copy_commit();
}

template <bool kAnnulus>
__global__ void __launch_bounds__(kMaxCenters)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int n, int m, int k,
                  float min_r2, float max_r2, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);  // 2 x (3 * kTile)
  const int nthreads = blockDim.x;
  const int stride = nthreads + 1;
  int* slots = reinterpret_cast<int*>(tiles + 6 * kTile);  // k x stride
  const int per_row = (m + nthreads - 1) / nthreads;
  const int row = blockIdx.x / per_row;
  const int c0 = (blockIdx.x - row * per_row) * nthreads;
  const int tid = threadIdx.x;
  const bool live = c0 + tid < m;
  const float* p = xyz + static_cast<size_t>(row) * n * 3;

  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (live) {
    const float* c = centers + (static_cast<size_t>(row) * m + c0 + tid) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  int count = live ? 0 : k;  // a thread past M counts as full

  auto test = [&](float x, float y, float z, int i) {
    const float d2 = sq_dist(x, y, z, cx, cy, cz);
    const bool ok = kAnnulus ? (d2 <= 0.0f || (d2 >= min_r2 && d2 < max_r2))
                             : d2 < max_r2;
    if (ok && count < k) {
      slots[count * stride + tid] = i;
      ++count;
    }
  };

  const int ntiles = (n + kTile - 1) / kTile;
  stage(tiles, p, n, 0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage(tiles + ((t + 1) & 1) * 3 * kTile, p, n, (t + 1) * kTile);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float4* tile =
        reinterpret_cast<const float4*>(tiles + (t & 1) * 3 * kTile);
    const int i0 = t * kTile;
    const int groups = (min(kTile, n - i0) + 3) / 4;
    for (int g = 0; g < groups && count < k; ++g) {
      const float4 a = tile[3 * g];
      const float4 b = tile[3 * g + 1];
      const float4 c = tile[3 * g + 2];
      const int i = i0 + 4 * g;
      test(a.x, a.y, a.z, i);
      test(a.w, b.x, b.y, i + 1);
      test(b.z, b.w, c.x, i + 2);
      test(c.y, c.z, c.w, i + 3);
    }
    // all centers full: stop; else this tile's buffer is free to refill
    if (__syncthreads_and(count >= k)) break;
  }
  copy_wait<0>();  // a prefetch left in flight by the early stop

  if (live) {
    const int fill = count == 0 ? 0 : slots[tid];
    for (int s = count; s < k; ++s) slots[s * stride + tid] = fill;
  }
  __syncthreads();
  const int rows = min(nthreads, m - c0);
  int* o = out + (static_cast<size_t>(row) * m + c0) * k;
  for (int e = tid; e < rows * k; e += nthreads) {
    const int c = e / k;
    o[e] = slots[(e - c * k) * stride + c];
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_warp_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ centers, int b, int n, int m,
                       int k, float min_r2, float max_r2,
                       int* __restrict__ out) {
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

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&value, attr, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return value;
}

}  // namespace

extern "C" int nesie_ball_query(const void* xyz, const void* centers, int b,
                                int n, int m, int k, float min_r2,
                                float max_r2, void* out, void* stream) {
  static const int sms = device_attribute(cudaDevAttrMultiProcessorCount);
  static const int optin =
      device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xyz);
  const float* c = static_cast<const float*>(centers);
  int* o = static_cast<int*>(out);
  if (static_cast<long long>(b) * m <
      static_cast<long long>(kMinCentersPerSm) * sms) {
    const long long warps = static_cast<long long>(b) * m;
    const int blocks =
        static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
    ball_query_warp_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        x, c, b, n, m, k, min_r2, max_r2, o);
    return static_cast<int>(cudaGetLastError());
  }
  // halve the centers per CTA while the grid would leave SMs idle, or
  // while the staged result does not fit
  int t = kMaxCenters;
  auto smem = [&](int threads) {
    return kTileBytes + 4LL * k * (threads + 1);
  };
  while (t > 32 && (static_cast<long long>(b) * ((m + t - 1) / t) < sms ||
                    smem(t) > optin)) {
    t /= 2;
  }
  if (smem(t) > optin) return static_cast<int>(cudaErrorInvalidValue);
  const bool annulus = !(min_r2 == 0.0f && max_r2 > 0.0f);
  // both instantiations may take all the shared memory a block may have
  static const cudaError_t allowed[2] = {
      cudaFuncSetAttribute(ball_query_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin),
      cudaFuncSetAttribute(ball_query_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin)};
  if (allowed[annulus] != cudaSuccess) {
    return static_cast<int>(allowed[annulus]);
  }
  const long long blocks = static_cast<long long>(b) * ((m + t - 1) / t);
  const size_t bytes = static_cast<size_t>(smem(t));
  if (annulus) {
    ball_query_kernel<true><<<static_cast<unsigned>(blocks), t, bytes, s>>>(
        x, c, n, m, k, min_r2, max_r2, o);
  } else {
    ball_query_kernel<false><<<static_cast<unsigned>(blocks), t, bytes, s>>>(
        x, c, n, m, k, min_r2, max_r2, o);
  }
  return static_cast<int>(cudaGetLastError());
}
