// Furthest point sampling (D-FPS) with one thread-block cluster per batch
// row, for Hopper (sm_90a).
//
// Replaces: nesie_tpu/ops/pallas_fps.py::_fps_kernel, the single-row FPS
// (one grid cell per row, the row's coordinates and min-distance cache
// resident in VMEM for all M steps).
//
// Semantics (as fps.cu and fps_ref): slot 0 is index 0 with every distance
// at 1e10. Each of the M-1 following steps sets
// dist[i] = min(dist[i], ((dx*dx + dy*dy) + dz*dz)) and picks the argmax of
// dist, the lowest index among equal values.
//
// What bounds it on the H100: the M-1 steps are dependent. With few rows
// (a B=1 request, the B=12 semi step) one block per row, as in fps.cu,
// leaves most of the 132 SMs idle and walks the whole row on one SM every
// step. Here a cluster of C CTAs (C up to 16, on neighbouring SMs) shares
// one row:
//
//   * each CTA owns a contiguous slice of ceil(N / C) points and keeps the
//     slice's min-distance cache, and its coordinates where they fit, in
//     shared memory for all M steps (the counterpart of K2's VMEM-resident
//     row); where the coordinates do not fit, they are read from L2;
//   * each step, a CTA reduces its slice to one candidate: a 64-bit key
//     whose unsigned order is fps.cu's tie rule (larger value, then lower
//     index), and the point's coordinates;
//   * the CTAs publish their candidates in their own shared memory and
//     meet at one cluster barrier; warp 0 of every CTA reads the C
//     candidates through distributed shared memory, takes the largest key
//     and hands the winner and its coordinates to the CTA's warps through
//     shared memory. The order is total on distinct indices, so every CTA
//     reaches the same winner, with no round trip through global memory.
//
// Candidates are double-buffered by step parity: a CTA writes step s+1's
// candidate only after the barrier of step s, which every CTA reaches only
// after reading step s-1's candidates, the other buffer. A last barrier
// keeps every CTA's shared memory alive until all have read it.
//
// The host side picks C from N and B: the largest C in {16, 8, 4, 2} whose
// slice is at least kMinPointsPerCta points, whose B*C CTAs take at most
// three quarters of the SMs, and whose clusters can all be resident at
// once (cudaOccupancyMaxActiveClusters >= B); else the plan with the most
// resident rows. Measured on the H100 (nesie_tpu_torch/tools/
// fps_cluster_sweep.py): B=1 runs fastest at C=16, B=12 at C=8, B=16 at
// C=4 (16 clusters of 8 do not pack into the GPCs at once). A lone CTA
// (C=1, short rows) skips the cluster barrier. 16 is a non-portable
// cluster size and is asked for through
// cudaFuncAttributeNonPortableClusterSizeAllowed.
//
// The squared distance is sq_dist.cuh's, free of FMA contraction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_key.cuh"
#include "sq_dist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMinPointsPerCta = 2048;
constexpr int kMaxCluster = 16;
// dynamic shared memory a CTA may take: the H100's 227 KB (232448 bytes)
// less room for the kernel's static arrays
constexpr int kSmemLimit = 232448 - 1024;

// pack, unpack_index, warp_max and Candidate: fps_key.cuh

template <bool kCoordsInSmem>
__global__ void __launch_bounds__(kMaxThreads)
fps_cluster_kernel(const float* __restrict__ xyz, int n, int m, int len,
                   int* __restrict__ out) {
  extern __shared__ float smem[];  // dist[len] (+ x[len], y[len], z[len])
  __shared__ unsigned long long warp_key[kMaxWarps];
  __shared__ Candidate cand[2];  // this CTA's, double-buffered by step
  __shared__ Candidate winner;   // the cluster's, for every thread

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * m;
  const int start = rank * len;
  const int count = max(0, min(n, start + len) - start);
  float* sd = smem;
  float* sx = smem + len;
  float* sy = sx + len;
  float* sz = sy + len;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;

  for (int j = tid; j < count; j += nthreads) {
    sd[j] = 1e10f;
    if (kCoordsInSmem) {
      const size_t g = static_cast<size_t>(start + j) * 3;
      sx[j] = p[g + 0];
      sy[j] = p[g + 1];
      sz[j] = p[g + 2];
    }
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  __syncthreads();

  for (int step = 1; step < m; ++step) {
    float best_v = -1.0f;
    int best_j = -1;
    for (int j = tid; j < count; j += nthreads) {
      float x, y, z;
      if (kCoordsInSmem) {
        x = sx[j];
        y = sy[j];
        z = sz[j];
      } else {
        const size_t g = static_cast<size_t>(start + j) * 3;
        x = p[g + 0];
        y = p[g + 1];
        z = p[g + 2];
      }
      const float nd = fminf(sd[j], sq_dist(x, y, z, lx, ly, lz));
      sd[j] = nd;
      if (nd > best_v) {  // ascending j: the first of equal values stays
        best_v = nd;
        best_j = j;
      }
    }
    unsigned long long key =
        warp_max(best_j < 0 ? 0ull : pack(best_v, start + best_j));
    if (lane == 0) warp_key[warp] = key;
    __syncthreads();
    Candidate* mine = csize == 1 ? &winner : &cand[step & 1];
    if (warp == 0) {
      key = warp_max(lane < nwarps ? warp_key[lane] : 0ull);
      if (lane == 0) {
        Candidate c{key, 0.0f, 0.0f, 0.0f};
        if (key != 0ull) {
          const int i = unpack_index(key);
          if (kCoordsInSmem) {
            c.x = sx[i - start];
            c.y = sy[i - start];
            c.z = sz[i - start];
          } else {
            c.x = p[static_cast<size_t>(i) * 3 + 0];
            c.y = p[static_cast<size_t>(i) * 3 + 1];
            c.z = p[static_cast<size_t>(i) * 3 + 2];
          }
        }
        *mine = c;
        if (csize == 1) o[step] = unpack_index(key);
      }
    }
    if (csize > 1) {
      cluster.sync();
    }
    // warp 0 reduces the cluster's C candidates, read through DSMEM, and
    // hands the winner to the CTA's other warps (a lone CTA's candidate
    // is the winner already)
    if (csize > 1 && warp == 0) {
      Candidate c{0ull, 0.0f, 0.0f, 0.0f};
      if (lane < csize) c = *cluster.map_shared_rank(mine, lane);
      const unsigned long long best = warp_max(c.key);
      const unsigned long long top = __shfl_sync(0xffffffffu, best, 0);
      const unsigned hit = __ballot_sync(0xffffffffu, c.key == top);
      if (lane == __ffs(hit) - 1) {
        winner = c;
        if (rank == 0) o[step] = unpack_index(top);
      }
    }
    __syncthreads();
    lx = winner.x;
    ly = winner.y;
    lz = winner.z;
  }
  cluster.sync();  // no CTA leaves while another may read its candidates
}

struct Plan {
  int cluster;
  int threads;
  int smem;
  bool coords_in_smem;
};

// The shape of one cluster of size c for rows of n points; false where a
// slice's distances do not fit shared memory.
bool shape_for(int n, int c, Plan* plan) {
  const int len = (n + c - 1) / c;
  const long long with_coords = 16LL * len;
  const long long dist_only = 4LL * len;
  if (with_coords <= kSmemLimit) {
    plan->coords_in_smem = true;
    plan->smem = static_cast<int>(with_coords);
  } else if (dist_only <= kSmemLimit) {
    plan->coords_in_smem = false;
    plan->smem = static_cast<int>(dist_only);
  } else {
    return false;
  }
  plan->cluster = c;
  const int t = (len + 31) / 32 * 32;
  plan->threads = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
  return true;
}

// The largest shared memory and cluster size any plan asks for, set once
// per kernel, so that a cached plan launches after any other.
template <bool kCoords>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel<kCoords>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fps_cluster_kernel<kCoords>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

cudaLaunchConfig_t launch_config(const Plan& plan, int b, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * plan.cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(plan.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(plan.smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(plan.cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of this plan the card holds at once (0 if none).
int resident_clusters(const Plan& plan) {
  const cudaError_t err = plan.coords_in_smem ? prepare<true>()
                                              : prepare<false>();
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused attribute is not a launch error
    return 0;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(plan, 1, nullptr, &attr);
  int count = 0;
  const cudaError_t q =
      plan.coords_in_smem
          ? cudaOccupancyMaxActiveClusters(&count, fps_cluster_kernel<true>,
                                           &cfg)
          : cudaOccupancyMaxActiveClusters(&count, fps_cluster_kernel<false>,
                                           &cfg);
  if (q != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// Plans, cached by (b, n, request): the occupancy queries cost more than
// the launch.
struct CachedPlan {
  int b, n, request;
  Plan plan;
};
constexpr int kCacheSize = 64;
CachedPlan g_cache[kCacheSize];
int g_cached = 0;

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

cudaError_t make_plan(int b, int n, int request, Plan* out) {
  for (int k = 0; k < g_cached; ++k) {
    const CachedPlan& e = g_cache[k];
    if (e.b == b && e.n == n && e.request == request) {
      *out = e.plan;
      return cudaSuccess;
    }
  }
  Plan chosen{};
  bool found = false;
  if (request > 0) {  // a cluster size asked for by the caller
    if (request > kMaxCluster || !shape_for(n, request, &chosen) ||
        resident_clusters(chosen) <= 0) {
      return cudaErrorInvalidValue;
    }
    found = true;
  } else {
    int best_rows = 0;
    for (int c = kMaxCluster; c >= 1; c >>= 1) {
      Plan plan;
      if (!shape_for(n, c, &plan)) continue;
      if (c > 1 && ((n + c - 1) / c < kMinPointsPerCta ||
                    4 * b * c > 3 * multiprocessors())) {
        continue;  // slices too short, or too many CTAs to pack
      }
      const int rows = resident_clusters(plan);
      if (rows >= b) {  // every row resident at once: take the widest
        chosen = plan;
        found = true;
        break;
      }
      if (rows > best_rows) {
        best_rows = rows;
        chosen = plan;
        found = true;
      }
    }
  }
  if (!found) return cudaErrorInvalidValue;
  if (g_cached < kCacheSize) g_cache[g_cached++] = CachedPlan{b, n, request, chosen};
  *out = chosen;
  return cudaSuccess;
}

}  // namespace

// The plan a launch with these arguments takes: cluster size, threads per
// CTA, dynamic shared memory bytes, and 1 if the coordinates sit in shared
// memory. request = 0 lets the plan choose the cluster size.
extern "C" int nesie_fps_cluster_plan(int b, int n, int request,
                                      void* plan_out) {
  Plan plan;
  const cudaError_t err = make_plan(b, n, request, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(plan_out);
  o[0] = plan.cluster;
  o[1] = plan.threads;
  o[2] = plan.smem;
  o[3] = plan.coords_in_smem ? 1 : 0;
  return 0;
}

extern "C" int nesie_fps_cluster(const void* xyz, int b, int n, int m,
                                 int request, void* out, void* stream) {
  Plan plan;
  cudaError_t err = make_plan(b, n, request, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(plan, b, static_cast<cudaStream_t>(stream), &attr);
  const int len = (n + plan.cluster - 1) / plan.cluster;
  if (plan.coords_in_smem) {
    err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<true>,
                             static_cast<const float*>(xyz), n, m, len,
                             static_cast<int*>(out));
  } else {
    err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<false>,
                             static_cast<const float*>(xyz), n, m, len,
                             static_cast<int*>(out));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
