// Batched furthest point sampling (D-FPS) with each row held on chip
// across a thread-block cluster, for Hopper (sm_90a).
//
// Replaces: nesie_tpu/ops/pallas_fps.py::_fps_batched_kernel, the batched
// FPS (all rows of a grid cell advance in lockstep, coordinates and
// min-distance cache resident in VMEM for all M steps). The eval forward's
// SA1 runs it at B=32 x 40000 -> 2048; ops/pointops sends every B > 16 here.
//
// Semantics (as fps_ref): slot 0 is index 0 with every distance at 1e10.
// Each of the M-1 following steps sets dist[i] = min(dist[i],
// ((dx*dx + dy*dy) + dz*dz)) (sq_dist.cuh, free of FMA contraction) and
// picks the argmax of dist, the lowest index among equal values.
//
// What bounds it on the H100: the M-1 steps are dependent. fps.cu runs one
// block per row, so at B=32 only 32 of the 132 SMs work, and every step
// streams the row through L2 (12 B of coordinates and 8 B of distance read
// and written per point). A row of 40000 points is 640 KB with its
// distances; an SM has 227 KB of shared memory and 256 KB of registers.
// So a cluster of C CTAs (C <= 8, neighbouring SMs) shares one row, and
// each CTA holds its slice of ceil(N / C) points on chip for all M steps:
//
//   * each thread owns P consecutive points of the slice (P a compile-time
//     multiple of 4): their distances in P registers (an unrolled loop
//     with constant indices keeps them there) and their coordinates in
//     shared memory, (x[4], y[4], z[4]) per group of four points, read as
//     three 16-byte loads. A thread's words are an odd number of 16-byte
//     units apart from its neighbour's, so a quarter warp's loads fall on
//     distinct banks. At B=32, N=40000 the plan takes C=7: 5715 points,
//     78 KB of shared memory and 24 distance registers per thread at 256
//     threads, two CTAs to an SM;
//   * a step reads 12 B per point from shared memory, writes nothing, and
//     reduces to one candidate per warp: a 64-bit key whose unsigned order
//     is the tie rule (fps_key.cuh) and the point's coordinates;
//   * every warp pushes its candidate into every CTA's shared memory
//     through DSMEM; one split cluster barrier (arrive.release after the
//     pushes, wait.acquire before the reads) publishes them; then every
//     warp reduces the C x warps candidates itself from its own shared
//     memory (cluster_winner()). No __syncthreads, no warp-0 hand-off, no
//     global memory: one barrier a step. Candidates are double-buffered by
//     step parity.
//
// Measured on the H100 (nesie_tpu_torch/tools/fps_onchip_sweep.py): a step
// costs about 1.4 us of exchange plus 0.056 ns per point an SM holds, so
// the exchange, not the points, sets the pace once the row is on chip.
// Fewer threads (256) beat 448-1024: fewer warps push and reduce. A second
// exchange, warp 0 reducing the CTA's warps behind a __syncthreads and
// pushing one candidate, was no faster at 256 threads and was dropped.
//
// Rows too long for the register layout at every cluster size keep the
// distances in shared memory (or, past that, in a global scratch row) and
// read the coordinates from L2 (fps_onchip_stream_kernel), with the same
// exchange.
//
// The host side (make_plan) picks C, threads and points per thread, asks
// cudaOccupancyMaxActiveClusters how many clusters are resident, and takes
// the plan with the least modelled time: waves of resident rows x (points
// an SM holds + the exchange's cost in points). An SM holds one CTA where
// the B x C CTAs fit the SMs, else as many as fit it. It caches the
// choice. Where no plan fits, it returns an error; there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fps_key.cuh"
#include "sq_dist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;
constexpr int kMaxWarps = 32;
constexpr int kSlots = kMaxCluster * kMaxWarps;  // candidates of one step
constexpr int kMinPointsPerCta = 2048;
// a thread count the plan does not exceed unless asked to
constexpr int kDefaultThreads = 256;
// the cost model: a step's exchange in points an SM holds (1.4 us over
// 0.056 ns a point, fps_onchip_sweep on the H100), and the cost of a point
// read from L2 against one on chip
constexpr double kExchangePoints = 24000.0;
constexpr double kStreamPenalty = 3.0;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The largest key of the warp, in every lane (xor butterfly).
__device__ __forceinline__ unsigned long long max_all(unsigned long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, k, off);
    k = o > k ? o : k;
  }
  return k;
}

// Every thread's candidate in, the cluster's winner out, in every thread.
// buf is this step's buffer (step parity): a CTA pushes into it only after
// the barrier of the step before, which every CTA passes only after it
// read the other buffer.
__device__ __forceinline__ Candidate cluster_winner(Candidate c,
                                                    Candidate* buf, int rank,
                                                    int csize) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // the warp's best, in every lane (keys of distinct points differ)
  const unsigned long long wk = max_all(c.key);
  const int holder = __ffs(__ballot_sync(kFull, c.key == wk)) - 1;
  const Candidate w{wk, __shfl_sync(kFull, c.x, holder),
                    __shfl_sync(kFull, c.y, holder),
                    __shfl_sync(kFull, c.z, holder)};
  if (lane < csize) {
    *cluster.map_shared_rank(&buf[rank * nwarps + warp], lane) = w;
  }
  __syncwarp();  // the .aligned barrier wants each warp converged
  cluster_arrive();
  cluster_wait();
  unsigned long long k = 0ull;
  int slot = 0;
  for (int s = lane; s < csize * nwarps; s += 32) {
    const unsigned long long o = buf[s].key;
    if (o > k) {
      k = o;
      slot = s;
    }
  }
  const unsigned long long top = max_all(k);
  const int src = __ffs(__ballot_sync(kFull, k == top)) - 1;
  return buf[__shfl_sync(kFull, slot, src)];
}

// Words of shared memory per thread for P points: P/4 groups of
// (x[4], y[4], z[4]), padded to an odd number of 16-byte units.
__host__ __device__ constexpr int stride_words(int p) {
  return (3 * p / 4) % 2 == 1 ? 3 * p : 3 * p + 4;
}

__device__ __forceinline__ void visit(float& d, float x, float y, float z,
                                      float lx, float ly, float lz,
                                      float& bv, int& bt, int t) {
  const float nd = fminf(d, sq_dist(x, y, z, lx, ly, lz));
  d = nd;
  if (nd > bv) {  // ascending t: the first of equal values stays
    bv = nd;
    bt = t;
  }
}

template <int P>
__global__ void __launch_bounds__(P <= 20 ? 1024 : 512)
fps_onchip_kernel(const float* __restrict__ xyz, int n, int m, int len,
                  int* __restrict__ out) {
  static_assert(P % 4 == 0, "points per thread come in groups of four");
  constexpr int S = stride_words(P);
  extern __shared__ float4 coords4[];  // S / 4 float4 per thread
  __shared__ Candidate cand[2][kSlots];
  float* coords = reinterpret_cast<float*>(coords4);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * m;
  const int start = rank * len;
  const int count = max(0, min(n, start + len) - start);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // stage the slice: coalesced reads of its (count, 3) floats; thread
  // tid owns points [tid * P, tid * P + P) of the slice
  const float* src = p + static_cast<size_t>(start) * 3;
  for (int e = tid; e < 3 * count; e += nthreads) {
    const int j = e / 3;
    const int c = e - 3 * j;
    const int owner = j / P;
    const int t = j - owner * P;
    coords[owner * S + (t >> 2) * 12 + c * 4 + (t & 3)] = src[e];
  }
  // a slot past the slice keeps distance -1: never above the best
  float d[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const bool pad = tid * P + t >= count;
    d[t] = pad ? -1.0f : 1e10f;
    if (pad) {
      float* q = coords + tid * S + (t >> 2) * 12 + (t & 3);
      q[0] = q[4] = q[8] = 0.0f;
    }
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  // the staged coordinates are visible to every thread, and every CTA of
  // the cluster has started before the first DSMEM store
  __syncwarp();
  cluster_arrive();
  cluster_wait();

  const float4* mine = coords4 + tid * (S / 4);
  for (int step = 1; step < m; ++step) {
    float bv = -1.0f;
    int bt = 0;
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      const float4 x = mine[3 * g];
      const float4 y = mine[3 * g + 1];
      const float4 z = mine[3 * g + 2];
      visit(d[4 * g + 0], x.x, y.x, z.x, lx, ly, lz, bv, bt, 4 * g + 0);
      visit(d[4 * g + 1], x.y, y.y, z.y, lx, ly, lz, bv, bt, 4 * g + 1);
      visit(d[4 * g + 2], x.z, y.z, z.z, lx, ly, lz, bv, bt, 4 * g + 2);
      visit(d[4 * g + 3], x.w, y.w, z.w, lx, ly, lz, bv, bt, 4 * g + 3);
    }
    Candidate c{0ull, 0.0f, 0.0f, 0.0f};
    if (bv >= 0.0f) {
      const float* q = coords + tid * S + (bt >> 2) * 12 + (bt & 3);
      c = Candidate{pack(bv, start + tid * P + bt), q[0], q[4], q[8]};
    }
    const Candidate win = cluster_winner(c, cand[step & 1], rank, csize);
    lx = win.x;
    ly = win.y;
    lz = win.z;
    if (rank == 0 && tid == 0) o[step] = unpack_index(win.key);
  }
  // every DSMEM store preceded the last barrier: a CTA may leave now
}

// Rows too long for the register layout: distances in shared memory (or
// in the global scratch row where that is given), coordinates from L2.
__global__ void __launch_bounds__(1024)
fps_onchip_stream_kernel(const float* __restrict__ xyz, int n, int m, int len,
                         float* scratch, int* __restrict__ out) {
  extern __shared__ float sdist[];
  __shared__ Candidate cand[2][kSlots];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * m;
  const int start = rank * len;
  const int count = max(0, min(n, start + len) - start);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  float* d = scratch != nullptr ? scratch + static_cast<size_t>(b) * n + start
                                : sdist;

  for (int j = tid; j < count; j += nthreads) d[j] = 1e10f;
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  __syncwarp();
  cluster_arrive();
  cluster_wait();

  for (int step = 1; step < m; ++step) {
    float bv = -1.0f;
    int bj = -1;
    for (int j = tid; j < count; j += nthreads) {
      const float* q = p + static_cast<size_t>(start + j) * 3;
      const float nd = fminf(d[j], sq_dist(q[0], q[1], q[2], lx, ly, lz));
      d[j] = nd;
      if (nd > bv) {
        bv = nd;
        bj = j;
      }
    }
    Candidate c{0ull, 0.0f, 0.0f, 0.0f};
    if (bj >= 0) {
      const float* q = p + static_cast<size_t>(start + bj) * 3;
      c = Candidate{pack(bv, start + bj), q[0], q[1], q[2]};
    }
    const Candidate win = cluster_winner(c, cand[step & 1], rank, csize);
    lx = win.x;
    ly = win.y;
    lz = win.z;
    if (rank == 0 && tid == 0) o[step] = unpack_index(win.key);
  }
}

using RegKernel = void (*)(const float*, int, int, int, int*);
using StreamKernel = void (*)(const float*, int, int, int, float*, int*);

struct RegEntry {
  int p;
  RegKernel fn;
};

const RegEntry kReg[] = {
    {4, fps_onchip_kernel<4>},   {8, fps_onchip_kernel<8>},
    {12, fps_onchip_kernel<12>}, {16, fps_onchip_kernel<16>},
    {20, fps_onchip_kernel<20>}, {24, fps_onchip_kernel<24>},
    {32, fps_onchip_kernel<32>}, {40, fps_onchip_kernel<40>},
    {48, fps_onchip_kernel<48>}, {64, fps_onchip_kernel<64>}};
constexpr int kNumReg = sizeof(kReg) / sizeof(kReg[0]);

struct Plan {
  int cluster;
  int threads;
  int ppt;  // points per thread in registers; 0: the streaming kernel
  int smem;  // dynamic shared memory bytes
  bool scratch;  // the streaming kernel's distances in global scratch
  int resident;  // clusters of this plan the card holds at once
  RegKernel reg;  // the kernel: one of the two is set
  StreamKernel stream;
  const void* fn() const {
    return ppt > 0 ? reinterpret_cast<const void*>(reg)
                   : reinterpret_cast<const void*>(stream);
  }
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&value, attr, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return value;
}

// The kernel's thread limit and the dynamic shared memory left beside its
// static arrays, which it is then allowed to take. False if a query failed.
bool kernel_limits(const void* fn, int* max_threads, int* room) {
  cudaFuncAttributes a;
  const int optin = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (optin <= 0 || cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(a.sharedSizeBytes)) !=
          cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  *max_threads = a.maxThreadsPerBlock;
  *room = optin - static_cast<int>(a.sharedSizeBytes);
  return true;
}

// The register layout for slices of len points: the smallest P whose
// thread count fits max_threads, the kernel and shared memory.
bool register_shape(int len, int max_threads, Plan* plan) {
  for (int e = 0; e < kNumReg; ++e) {
    int limit = 0, room = 0;
    if (!kernel_limits(reinterpret_cast<const void*>(kReg[e].fn), &limit,
                       &room)) {
      continue;
    }
    const int p = kReg[e].p;
    const int t = ceil_div(ceil_div(len, p), 32) * 32;
    const long long smem = 4LL * t * stride_words(p);
    if (t > max_threads || t > limit || smem > room) continue;
    plan->threads = t;
    plan->ppt = p;
    plan->smem = static_cast<int>(smem);
    plan->scratch = false;
    plan->reg = kReg[e].fn;
    return true;
  }
  return false;
}

bool stream_shape(int len, int max_threads, Plan* plan) {
  int limit = 0, room = 0;
  if (!kernel_limits(reinterpret_cast<const void*>(fps_onchip_stream_kernel),
                     &limit, &room)) {
    return false;
  }
  const int t =
      std::min(ceil_div(len, 32) * 32, std::min(limit, max_threads));
  if (t < 32) return false;
  plan->threads = t;
  plan->ppt = 0;
  plan->scratch = 4LL * len > room;
  plan->smem = plan->scratch ? 0 : 4 * len;
  plan->stream = fps_onchip_stream_kernel;
  return true;
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

int resident_clusters(const Plan& plan) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(plan, 1, nullptr, &attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, plan.fn(), &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// How many CTAs of the plan an SM can hold (1 if the query fails).
int ctas_per_sm(const Plan& plan) {
  int count = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &count, plan.fn(), plan.threads, plan.smem) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  return std::max(count, 1);
}

// Plans, cached by their arguments: the queries cost more than a launch.
struct CachedPlan {
  int b, n, cluster, threads;
  Plan plan;
};
constexpr int kCacheSize = 64;
CachedPlan g_cache[kCacheSize];
int g_cached = 0;

// cluster, threads: 0 lets the plan choose.
cudaError_t make_plan(int b, int n, int cluster, int threads, Plan* out) {
  for (int k = 0; k < g_cached; ++k) {
    const CachedPlan& e = g_cache[k];
    if (e.b == b && e.n == n && e.cluster == cluster && e.threads == threads) {
      *out = e.plan;
      return cudaSuccess;
    }
  }
  if (b < 1 || n < 1 || cluster < 0 || cluster > kMaxCluster || threads < 0 ||
      threads > 1024) {
    return cudaErrorInvalidValue;
  }
  const int sms = device_attribute(cudaDevAttrMultiProcessorCount);
  const int max_threads = threads > 0 ? threads : kDefaultThreads;
  Plan chosen{};
  double best = 0.0;
  const int lo = cluster > 0 ? cluster : 1;
  const int hi = cluster > 0 ? cluster : kMaxCluster;
  for (int c = hi; c >= lo; --c) {
    const int len = ceil_div(n, c);
    if (cluster == 0 && c > 1 && len < kMinPointsPerCta) continue;
    Plan plan{};
    plan.cluster = c;
    if (!register_shape(len, max_threads, &plan) &&
        !stream_shape(len, max_threads, &plan)) {
      continue;
    }
    plan.resident = resident_clusters(plan);
    if (plan.resident <= 0) continue;
    const int wave = std::min(b, plan.resident);
    const double waves = ceil_div(b, plan.resident);
    const double per_sm = wave * c <= sms ? 1.0 : ctas_per_sm(plan);
    const double cost =
        waves * (per_sm * len * (plan.ppt > 0 ? 1.0 : kStreamPenalty) +
                 (c > 1 ? kExchangePoints : 0.0));
    if (chosen.cluster == 0 || cost < best) {
      chosen = plan;
      best = cost;
    }
  }
  if (chosen.cluster == 0) return cudaErrorInvalidValue;
  if (g_cached < kCacheSize) {
    g_cache[g_cached++] = CachedPlan{b, n, cluster, threads, chosen};
  }
  *out = chosen;
  return cudaSuccess;
}

}  // namespace

// The plan a launch with these arguments takes, as 6 ints: cluster size,
// threads per CTA, points per thread in registers (0: the streaming
// kernel), dynamic shared memory bytes, 1 if the streaming kernel needs a
// (B, N) float scratch, and the clusters resident at once.
extern "C" int nesie_fps_onchip_plan(int b, int n, int cluster, int threads,
                                     void* plan_out) {
  Plan plan;
  const cudaError_t err = make_plan(b, n, cluster, threads, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(plan_out);
  o[0] = plan.cluster;
  o[1] = plan.threads;
  o[2] = plan.ppt;
  o[3] = plan.smem;
  o[4] = plan.scratch ? 1 : 0;
  o[5] = plan.resident;
  return 0;
}

extern "C" int nesie_fps_onchip(const void* xyz, int b, int n, int m,
                                int cluster, int threads, void* scratch,
                                void* out, void* stream) {
  Plan plan;
  cudaError_t err = make_plan(b, n, cluster, threads, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.scratch && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(plan, b, static_cast<cudaStream_t>(stream), &attr);
  const int len = ceil_div(n, plan.cluster);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  if (plan.ppt > 0) {
    err = cudaLaunchKernelEx(&cfg, plan.reg, x, n, m, len, o);
  } else {
    err = cudaLaunchKernelEx(
        &cfg, plan.stream, x, n, m, len,
        plan.scratch ? static_cast<float*>(scratch) : nullptr, o);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
