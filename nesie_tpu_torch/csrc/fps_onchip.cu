// Furthest point sampling (D-FPS) with each row held on chip, on one CTA
// or across a thread-block cluster, for Hopper (sm_90a).
//
// Replaces: nesie_tpu/ops/pallas_fps.py::_fps_batched_kernel, the batched
// FPS (all rows of a grid cell advance in lockstep, coordinates and
// min-distance cache resident in VMEM for all M steps), and
// nesie_tpu/ops/pallas_fps.py::_fps_kernel, the single-row FPS (one grid
// cell per row). ops/pointops sends every batch here: B > 16 (the eval
// forward's SA1 at 32 x 40000 -> 2048) and B <= 16 (a Detector request,
// the semi step's 12 x 40000 -> 2048 and its vote-mode 12 x 1024 -> 256,
// the supervised step at B=8).
//
// Semantics (as fps_ref): slot 0 is index 0 with every distance at 1e10.
// Each of the M-1 following steps sets dist[i] = min(dist[i],
// ((dx*dx + dy*dy) + dz*dz)) (sq_dist.cuh, free of FMA contraction) and
// picks the argmax of dist, the lowest index among equal values.
//
// What bounds it on the H100: the M-1 steps are dependent, so a step's
// latency is the cost. A row of 40000 points is 640 KB with its
// distances; an SM has 227 KB of shared memory and 256 KB of registers.
// So a cluster of C CTAs (C <= 16, neighbouring SMs) shares one row, and
// each CTA holds its slice of ceil(N / C) points on chip for all M steps:
//
//   * each thread owns P consecutive points of the slice (P a compile-time
//     multiple of 4): their distances in P registers (an unrolled loop
//     with constant indices keeps them there) and their coordinates in
//     shared memory, (x[4], y[4], z[4]) per group of four points, read as
//     three 16-byte loads. A thread's words are an odd number of 16-byte
//     units apart from its neighbour's, so a quarter warp's loads fall on
//     distinct banks. At C=16 a 200000-point row is 12500 points a CTA,
//     147 KB of coordinates;
//   * a step reads 12 B per point from shared memory, writes nothing, and
//     reduces to one candidate per warp; then the exchange (a template
//     parameter, chosen by the host plan) finds the row's winner.
//
// Threads own consecutive points and warps, CTAs and ranks follow in
// index order, so the lowest lane (warp, slot) holding the largest value
// holds the lowest index among equal values. The mailbox and local
// exchanges use that: a candidate's value is its distance's bits plus 1
// (0: no point; distances are >= 0, so their bits order as unsigned
// integers), reduced by redux.sync and a ballot, with no 64-bit shuffles.
//
// The exchanges:
//   * barrier (the exchange of the first design, kept as a reference):
//     every warp reduces a 64-bit key (fps_key.cuh) with 5 rounds of
//     64-bit shuffles, pushes its candidate into every CTA through DSMEM,
//     one split cluster barrier (arrive.release after the pushes,
//     wait.acquire before the reads) publishes them, and every warp
//     reduces the C x warps keys again (cluster_winner());
//   * mailbox: each CTA owns two mbarriers and two candidate buffers,
//     chosen by step parity. Every warp (mailbox) or warp 0 after a CTA
//     barrier and a reduction of the CTA's warps (mailbox_cta) sends its
//     candidate to every CTA of the cluster with
//     st.async...mbarrier::complete_tx::bytes aimed at that CTA's
//     barrier of the same parity. Thread 0 of each CTA arms its own
//     barrier with mbarrier.arrive.expect_tx (C x pushers x 20 bytes);
//     every thread waits with mbarrier.try_wait.parity (acquire, cluster
//     scope) on its own shared memory and reduces its own buffer. No
//     barrier.cluster runs inside the step loop: a CTA waits for the
//     candidates it needs, not for every CTA to reach a point;
//   * local (one CTA, no cluster attribute: short rows such as the
//     vote-mode 1024 -> 256): each warp writes its candidate into a
//     parity buffer in shared memory, one __syncthreads (none for one
//     warp), and every warp reduces the warps' candidates.
//
// Why the mailbox's parity buffers are safe: a CTA pushes its step s+2
// candidate into buffer s & 1 of a peer only after it has the peer's
// step s+1 candidates, which the peer sends only after each of its
// pushing warps has read its step s buffer. The same holds for the
// barrier of parity s & 1: its step s phase completes before any step
// s+2 byte can arrive, and no thread can miss a phase, since the step
// s+2 phase needs its own warp's step s+2 push. Thread 0 arms the
// barrier for step s at the start of step s, after it saw the step s-2
// phase complete. A complete_tx that arrives before that arm drives the
// phase's transaction count below zero; the phase cannot complete while
// its one expected arrival (the arm) is pending, and the arm's
// expect_tx brings the count back, so the early bytes are counted
// against the phase they were sent for. The barriers are initialised and
// made visible to the cluster (fence.mbarrier_init.release.cluster)
// before one cluster barrier that precedes the first remote store, and
// one cluster barrier after the loop keeps every CTA's shared memory
// alive until no peer can write into it.
//
// The instrumented instantiation (template flag kTimed, never on the
// main path) writes clock64() stamps of thread 0 of CTA 0 (rank 0 of
// row 0) for the first kTimedSteps steps: step start, after the point
// loop, after the warp reduction, after the push, after the barrier or
// wait, after the cross-CTA reduction (tools/fps_step_split.py).
//
// Rows too long for the register layout at every cluster size keep the
// distances in shared memory (or, past that, in a global scratch row) and
// read the coordinates from L2 (fps_onchip_stream_kernel), with the
// barrier exchange.
//
// The host side (make_plan) picks C, threads, points per thread and the
// exchange, asks cudaOccupancyMaxActiveClusters how many clusters are
// resident, and takes the plan with the least modelled step time: waves
// of resident rows x (the larger of the points an SM holds at
// kPointNs each and a thread's own points at kThreadPointNs each, plus
// the exchange's measured cost). A row across a cluster takes a mailbox
// (one push per CTA at C=16, every warp pushing below: the step split
// measured the barrier at ~1300-1400 cycles of a ~3300-cycle step, the
// mailbox's wait at ~150-650), a short row one CTA with the local
// exchange; the barrier exchange is left to rows past the register
// layout (the streaming kernel) and to callers that ask for it. It
// caches the choice. Where no plan fits, it returns an error; there is
// no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fps_frame.cuh"
#include "fps_key.cuh"
#include "sq_dist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMinPointsPerCta = 2048;
// the thread caps the plan tries unless asked for one, by exchange:
// the local exchange's for a short row, the mailboxes' (fps_onchip_sweep:
// four warps of up to 64 points each beat eight of fewer at every
// 40000-point shape), and the barrier's (the first design's plan)
constexpr int kLocalThreads[] = {32, 64, 128, 256};
constexpr int kMailboxThreads[] = {128, 256};
constexpr int kBarrierThreads[] = {256};

// The cost model, in ns a step, fitted to fps_onchip_sweep and
// fps_step_split on the H100 (1.98 GHz): a point an SM holds, a point a
// thread owns (its serial loop), a point read from L2 against one on
// chip, and each exchange with its warp reduction. Every warp pushing
// costs 300 ns and 15 ns a slot (C x warps: each CTA receives and scans
// them all); one push per CTA ~800 ns at any C; the barrier ~1350 ns.
constexpr double kPointNs = 0.056;
constexpr double kThreadPointNs = 4.0;
constexpr double kStreamPenalty = 3.0;
constexpr double kBarrierNs = 1344.0;
constexpr double kMailboxNs = 300.0;
constexpr double kMailboxSlotNs = 15.0;
constexpr double kMailboxCtaNs = 800.0;
constexpr double kLocalWarpNs = 374.0;  // one warp: shuffles only
constexpr double kLocalSyncNs = 416.0;  // more warps: one __syncthreads

// bytes a mailbox candidate sends: (value, index, x, y) and z
constexpr int kCandBytes = 20;
constexpr int kStamps = 6;
constexpr int kTimedSteps = 512;

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t)::"memory");
  return t;
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

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Bytes of the exchange's buffers behind the coordinates, for a cluster
// of c CTAs of w warps: two parity buffers of slots, a slot 16 bytes of
// head and 4 of tail (barrier: a Candidate); mailbox_cta adds its warps'
// buffers behind its C slots.
__host__ __device__ constexpr int exchange_bytes(int x, int c, int w) {
  return x == kBarrier ? 2 * c * w * static_cast<int>(sizeof(Candidate))
         : x == kLocal   ? round16(2 * w * kCandBytes)
         : x == kMailbox ? round16(2 * c * w * kCandBytes)
                         : round16(2 * c * kCandBytes) +
                             round16(2 * w * kCandBytes);
}

// The barrier exchange: every thread's candidate in, the cluster's
// winner out, in every thread. buf is this step's buffer (step parity): a
// CTA pushes into it only after the barrier of the step before, which
// every CTA passes only after it read the other buffer. st: the
// instrumented kernel's stamps of this step, or null.
__device__ __forceinline__ Candidate cluster_winner(Candidate c,
                                                    Candidate* buf, int rank,
                                                    int csize,
                                                    long long* st) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned long long wk = max_all(c.key);
  const int holder = __ffs(__ballot_sync(kFull, c.key == wk)) - 1;
  const Candidate w{wk, __shfl_sync(kFull, c.x, holder),
                    __shfl_sync(kFull, c.y, holder),
                    __shfl_sync(kFull, c.z, holder)};
  if (st != nullptr) st[2] = clock_now();
  if (lane < csize) {
    *cluster.map_shared_rank(&buf[rank * nwarps + warp], lane) = w;
  }
  if (st != nullptr) st[3] = clock_now();
  __syncwarp();  // the .aligned barrier wants each warp converged
  cluster_arrive();
  cluster_wait();
  if (st != nullptr) st[4] = clock_now();
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

// stamp k of this step, on the instrumented instantiation's thread
#define STAMP(k)                       \
  do {                                 \
    if (kTimed && st != nullptr) {     \
      st[k] = clock_now();             \
    }                                  \
  } while (0)

template <int P, int X, bool kTimed>
__global__ void __launch_bounds__(P <= 20 ? 1024 : 512)
fps_onchip_kernel(const float* __restrict__ xyz, int n, int m, int len,
                  int* __restrict__ out, long long* __restrict__ stamps) {
  static_assert(P % 4 == 0, "points per thread come in groups of four");
  constexpr int S = stride_words(P);
  extern __shared__ float4 smem4[];  // coordinates, then the exchange
  __shared__ __align__(8) unsigned long long bars[2];
  float* coords = reinterpret_cast<float*>(smem4);

  int rank = 0, csize = 1;
  if (X != kLocal) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    csize = static_cast<int>(cluster.num_blocks());
  }
  const int b = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * m;
  const int start = rank * len;
  const int count = max(0, min(n, start + len) - start);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  void* exch = smem4 + nthreads * (S / 4);

  // the exchange's buffers: slots of one parity buffer
  const int slots = X == kBarrier || X == kMailbox ? csize * nwarps
                    : X == kMailboxCta            ? csize
                                                  : nwarps;
  Candidate* cand = static_cast<Candidate*>(exch);
  uint4* head = static_cast<uint4*>(exch);
  float* tail = reinterpret_cast<float*>(head + 2 * slots);
  // mailbox_cta: the warps' candidates, behind the mailbox
  uint4* stage = reinterpret_cast<uint4*>(static_cast<char*>(exch) +
                                          round16(2 * slots * kCandBytes));
  float* stage_tail = reinterpret_cast<float*>(stage + 2 * nwarps);
  // stage the slice: coalesced reads of its (count, 3) floats; thread
  // tid owns points [tid * P, tid * P + P) of the slice
  stage_slice<P>(coords, p + static_cast<size_t>(start) * 3, count, tid,
                 nthreads);
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
  const bool mailbox = X == kMailbox || X == kMailboxCta;
  if (mailbox && tid == 0) {
    mbar_init(smem_u32(&bars[0]));
    mbar_init(smem_u32(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the staged coordinates (and the barriers) are visible to every
  // thread, and every CTA of the cluster has started before the first
  // remote store
  if (X == kLocal) {
    __syncthreads();
  } else {
    __syncwarp();
    cluster_arrive();
    cluster_wait();
  }
  const unsigned expect =
      static_cast<unsigned>(csize * (X == kMailbox ? nwarps : 1) * kCandBytes);

  const float4* mine = smem4 + tid * (S / 4);
  for (int step = 1; step < m; ++step) {
    long long* st = nullptr;
    if (kTimed && blockIdx.x == 0 && tid == 0 && step <= kTimedSteps) {
      st = stamps + static_cast<size_t>(step - 1) * kStamps;
    }
    const int par = step & 1;
    const unsigned bar = smem_u32(&bars[par]);
    if (mailbox && tid == 0) mbar_arm(bar, expect);
    STAMP(0);
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
    STAMP(1);
    const float* q = coords + tid * S + (bt >> 2) * 12 + (bt & 3);
    if (X == kBarrier) {
      // the first design's exchange: 64-bit keys, one cluster barrier
      const Candidate c = bv >= 0.0f
                              ? Candidate{pack(bv, start + tid * P + bt),
                                          q[0], q[4], q[8]}
                              : Candidate{0ull, 0.0f, 0.0f, 0.0f};
      const Candidate win =
          cluster_winner(c, cand + par * slots, rank, csize, st);
      lx = win.x;
      ly = win.y;
      lz = win.z;
      STAMP(5);
      if (rank == 0 && tid == 0) o[step] = unpack_index(win.key);
      continue;
    }
    const Best c{bv >= 0.0f ? __float_as_uint(bv) + 1u : 0u,
                 static_cast<unsigned>(start + tid * P + bt), q[0], q[4],
                 q[8]};
    Best w = warp_best(c);
    STAMP(2);
    uint4* hb = head + par * slots;
    float* tb = tail + par * slots;
    if (X == kLocal) {
      if (nwarps > 1) {
        if (lane == 0) {
          hb[warp] = w.head();
          tb[warp] = w.z;
        }
        STAMP(3);
        __syncthreads();
        STAMP(4);
        w = slot_best(hb, tb, nwarps);
      }
    } else {
      if (X == kMailboxCta) {
        uint4* sh = stage + par * nwarps;
        float* stl = stage_tail + par * nwarps;
        if (lane == 0) {
          sh[warp] = w.head();
          stl[warp] = w.z;
        }
        __syncthreads();
        if (warp == 0) w = slot_best(sh, stl, nwarps);
      }
      if ((X == kMailbox || warp == 0) && lane < csize) {
        const int s = X == kMailbox ? rank * nwarps + warp : rank;
        push_async(peer(smem_u32(hb + s), lane), peer(smem_u32(tb + s), lane),
                   peer(bar, lane), w.head(), w.z);
      }
      STAMP(3);
      // the k-th use of this parity's barrier waits for phase parity k & 1
      mbar_wait(bar, static_cast<unsigned>((step - 1) >> 1) & 1u);
      STAMP(4);
      w = slot_best(hb, tb, slots);
    }
    lx = w.x;
    ly = w.y;
    lz = w.z;
    STAMP(5);
    if (rank == 0 && tid == 0) o[step] = static_cast<int>(w.i);
  }
  // barrier: every DSMEM store preceded the last barrier. mailbox: no
  // CTA leaves while a peer may still write into its shared memory
  if (mailbox) {
    __syncwarp();
    cluster_arrive();
    cluster_wait();
  }
}

#undef STAMP

// Rows too long for the register layout: distances in shared memory (or
// in the global scratch row where that is given), coordinates from L2;
// the barrier exchange. The candidates of a step sit before the
// distances (clusters of c CTAs of w warps: 2 c w Candidates).
__global__ void __launch_bounds__(1024)
fps_onchip_stream_kernel(const float* __restrict__ xyz, int n, int m, int len,
                         float* scratch, int* __restrict__ out) {
  extern __shared__ Candidate cand_dyn[];  // 2 c w candidates, distances

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
  const int slots = csize * (nthreads >> 5);
  float* sdist = reinterpret_cast<float*>(cand_dyn + 2 * slots);
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
    const Candidate win = cluster_winner(c, cand_dyn + (step & 1) * slots,
                                         rank, csize, nullptr);
    lx = win.x;
    ly = win.y;
    lz = win.z;
    if (rank == 0 && tid == 0) o[step] = unpack_index(win.key);
  }
}

using RegKernel = void (*)(const float*, int, int, int, int*, long long*);
using StreamKernel = void (*)(const float*, int, int, int, float*, int*);

struct RegEntry {
  int p;
  int exchange;
  bool timed;
  RegKernel fn;
};

#define NESIE_REG(P, T)                                            \
  {P, kLocal, T, fps_onchip_kernel<P, kLocal, T>},                 \
      {P, kBarrier, T, fps_onchip_kernel<P, kBarrier, T>},         \
      {P, kMailbox, T, fps_onchip_kernel<P, kMailbox, T>},         \
      {P, kMailboxCta, T, fps_onchip_kernel<P, kMailboxCta, T>}

// the instrumented instantiations cover the step split's plans (C=2 at
// 512 threads, C=4, 7, 8 and 16 at 256 threads, 40000-point rows)
const RegEntry kReg[] = {
    NESIE_REG(4, false),  NESIE_REG(8, false),  NESIE_REG(12, false),
    NESIE_REG(16, false), NESIE_REG(20, false), NESIE_REG(24, false),
    NESIE_REG(32, false), NESIE_REG(40, false), NESIE_REG(48, false),
    NESIE_REG(64, false), NESIE_REG(12, true),  NESIE_REG(20, true),
    NESIE_REG(24, true),  NESIE_REG(40, true)};
constexpr int kNumReg = sizeof(kReg) / sizeof(kReg[0]);

#undef NESIE_REG

struct Plan {
  int cluster;
  int threads;
  int ppt;       // points per thread in registers; 0: the streaming kernel
  int smem;      // dynamic shared memory bytes
  bool scratch;  // the streaming kernel's distances in global scratch
  int resident;  // clusters (CTAs for local) of this plan held at once
  int exchange;
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
// static arrays, which it is then allowed to take, with non-portable
// cluster sizes allowed. False if a query failed.
bool kernel_limits(const void* fn, int* max_threads, int* room) {
  cudaFuncAttributes a;
  const int optin = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (optin <= 0 || cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(a.sharedSizeBytes)) !=
          cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  *max_threads = a.maxThreadsPerBlock;
  *room = optin - static_cast<int>(a.sharedSizeBytes);
  return true;
}

// The register layout for slices of len points with this exchange: the
// smallest P whose thread count fits max_threads, the kernel and shared
// memory.
bool register_shape(int len, int max_threads, int c, int x, bool timed,
                    Plan* plan) {
  for (int e = 0; e < kNumReg; ++e) {
    if (kReg[e].exchange != x || kReg[e].timed != timed) continue;
    int limit = 0, room = 0;
    if (!kernel_limits(reinterpret_cast<const void*>(kReg[e].fn), &limit,
                       &room)) {
      continue;
    }
    const int p = kReg[e].p;
    const int t = ceil_div(ceil_div(len, p), 32) * 32;
    const long long smem =
        4LL * t * stride_words(p) + exchange_bytes(x, c, t / 32);
    if (t > max_threads || t > limit || smem > room) continue;
    plan->threads = t;
    plan->ppt = p;
    plan->smem = static_cast<int>(smem);
    plan->scratch = false;
    plan->exchange = x;
    plan->reg = kReg[e].fn;
    return true;
  }
  return false;
}

bool stream_shape(int len, int max_threads, int c, Plan* plan) {
  int limit = 0, room = 0;
  if (!kernel_limits(reinterpret_cast<const void*>(fps_onchip_stream_kernel),
                     &limit, &room)) {
    return false;
  }
  const int t =
      std::min(ceil_div(len, 32) * 32, std::min(limit, max_threads));
  if (t < 32) return false;
  const int cand = exchange_bytes(kBarrier, c, t / 32);
  if (cand > room) return false;
  plan->threads = t;
  plan->ppt = 0;
  plan->scratch = 4LL * len > room - cand;
  plan->smem = cand + (plan->scratch ? 0 : 4 * len);
  plan->exchange = kBarrier;
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
  if (plan.exchange != kLocal) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = static_cast<unsigned>(plan.cluster);
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// How many CTAs of the plan an SM can hold (0 if the query fails).
int ctas_per_sm(const Plan& plan) {
  int count = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &count, plan.fn(), plan.threads, plan.smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

int resident_clusters(const Plan& plan);

// Clusters of the plan's size the card holds with one CTA to an SM (each
// CTA asking for all of an SM's shared memory): the clusters that run
// without sharing an SM, which the GPCs' sizes limit (0 if unknown).
int exclusive_clusters(const Plan& plan) {
  int limit = 0, room = 0;
  if (!kernel_limits(plan.fn(), &limit, &room)) return 0;
  Plan alone = plan;
  alone.smem = room;
  return resident_clusters(alone);
}

int resident_clusters(const Plan& plan) {
  if (plan.exchange == kLocal) {
    return ctas_per_sm(plan) *
           device_attribute(cudaDevAttrMultiProcessorCount);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(plan, 1, nullptr, &attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, plan.fn(), &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

double exchange_ns(const Plan& plan) {
  switch (plan.exchange) {
    case kLocal:
      return plan.threads > 32 ? kLocalSyncNs : kLocalWarpNs;
    case kMailbox:
      return kMailboxNs + kMailboxSlotNs * plan.cluster * plan.threads / 32;
    case kMailboxCta:
      return kMailboxCtaNs;
    default:
      return kBarrierNs;
  }
}

// The modelled time of one step of the whole batch, in ns.
double step_ns(const Plan& plan, int b, int len, int sms) {
  const int wave = std::min(b, plan.resident);
  const double waves = ceil_div(b, plan.resident);
  // CTAs an SM holds: one where the wave's clusters each find SMs of
  // their own (fps_onchip_sweep: 12 rows at C=9 or 11 ran slower than at
  // C=8, since a GPC holds one such cluster), else at least the even
  // share plus one and at most what fits
  const int ctas = wave * plan.cluster;
  const double per_sm =
      ctas <= sms && (plan.exchange == kLocal ||
                      wave <= exclusive_clusters(plan))
          ? 1.0
          : std::max(1, std::min(ctas_per_sm(plan), ceil_div(ctas, sms) + 1));
  const double points = per_sm * len * kPointNs *
                        (plan.ppt > 0 ? 1.0 : kStreamPenalty);
  const double serial = plan.ppt * kThreadPointNs;
  return waves * (std::max(points, serial) + exchange_ns(plan));
}

// Plans, cached by their arguments: the queries cost more than a launch.
struct CachedPlan {
  int b, n, cluster, threads, exchange;
  bool timed;
  Plan plan;
};
constexpr int kCacheSize = 128;
CachedPlan g_cache[kCacheSize];
int g_cached = 0;

// cluster, threads, exchange: 0 lets the plan choose.
cudaError_t make_plan(int b, int n, int cluster, int threads, int exchange,
                      bool timed, Plan* out) {
  for (int k = 0; k < g_cached; ++k) {
    const CachedPlan& e = g_cache[k];
    if (e.b == b && e.n == n && e.cluster == cluster &&
        e.threads == threads && e.exchange == exchange && e.timed == timed) {
      *out = e.plan;
      return cudaSuccess;
    }
  }
  if (b < 1 || n < 1 || cluster < 0 || cluster > kMaxCluster || threads < 0 ||
      threads > 1024 || exchange < kAuto || exchange > kMailboxCta ||
      (exchange == kLocal && cluster > 1)) {
    return cudaErrorInvalidValue;
  }
  const int sms = device_attribute(cudaDevAttrMultiProcessorCount);
  Plan chosen{};
  double best = 0.0;
  const int lo = cluster > 0 ? cluster : 1;
  const int hi =
      cluster > 0 ? cluster : kMaxCluster;
  for (int c = hi; c >= lo; --c) {
    const int len = ceil_div(n, c);
    if (cluster == 0 && c > 1 && len < kMinPointsPerCta) continue;
    for (int x = kLocal; x <= kMailboxCta; ++x) {
      // the local exchange is one CTA's; auto: one CTA takes it (or the
      // barrier's streaming kernel), a cluster a mailbox (or the
      // barrier's streaming kernel)
      if ((x == kLocal && c > 1) ||
          (exchange != kAuto ? x != exchange : x >= kMailbox && c == 1)) {
        continue;
      }
      // each thread cap of the exchange (or the one asked for); a cap
      // takes the smallest P whose threads fit it
      const int* caps = x == kLocal     ? kLocalThreads
                        : x == kBarrier ? kBarrierThreads
                                        : kMailboxThreads;
      const int ncaps = threads > 0 ? 1
                        : x == kLocal     ? 4
                        : x == kBarrier ? 1
                                          : 2;
      for (int k = 0; k < ncaps; ++k) {
        const int cap = threads > 0 ? threads : caps[k];
        Plan plan{};
        plan.cluster = c;
        if (!register_shape(len, cap, c, x, timed, &plan) &&
            (x != kBarrier || timed || !stream_shape(len, cap, c, &plan))) {
          continue;
        }
        plan.resident = resident_clusters(plan);
        if (plan.resident <= 0) continue;
        const double cost = step_ns(plan, b, len, sms);
        if (chosen.cluster == 0 || cost < best) {
          chosen = plan;
          best = cost;
        }
      }
    }
  }
  if (chosen.cluster == 0) return cudaErrorInvalidValue;
  if (g_cached < kCacheSize) {
    g_cache[g_cached++] =
        CachedPlan{b, n, cluster, threads, exchange, timed, chosen};
  }
  *out = chosen;
  return cudaSuccess;
}

cudaError_t launch(const Plan& plan, const void* xyz, int b, int n, int m,
                   void* scratch, void* out, void* stamps, void* stream) {
  if (plan.scratch && scratch == nullptr) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(plan, b, static_cast<cudaStream_t>(stream), &attr);
  const int len = ceil_div(n, plan.cluster);
  const float* x = static_cast<const float*>(xyz);
  int* o = static_cast<int*>(out);
  cudaError_t err;
  if (plan.ppt > 0) {
    err = cudaLaunchKernelEx(&cfg, plan.reg, x, n, m, len, o,
                             static_cast<long long*>(stamps));
  } else {
    err = cudaLaunchKernelEx(
        &cfg, plan.stream, x, n, m, len,
        plan.scratch ? static_cast<float*>(scratch) : nullptr, o);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The plan a launch with these arguments takes, as 7 ints: cluster size,
// threads per CTA, points per thread in registers (0: the streaming
// kernel), dynamic shared memory bytes, 1 if the streaming kernel needs a
// (B, N) float scratch, the clusters resident at once, and the exchange
// (1 local, 2 barrier, 3 mailbox, 4 mailbox with one push per CTA).
// cluster, threads, exchange: 0 lets the plan choose; timed: the
// instrumented kernels' plan.
extern "C" int nesie_fps_onchip_plan(int b, int n, int cluster, int threads,
                                     int exchange, int timed,
                                     void* plan_out) {
  Plan plan;
  const cudaError_t err =
      make_plan(b, n, cluster, threads, exchange, timed != 0, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(plan_out);
  o[0] = plan.cluster;
  o[1] = plan.threads;
  o[2] = plan.ppt;
  o[3] = plan.smem;
  o[4] = plan.scratch ? 1 : 0;
  o[5] = plan.resident;
  o[6] = plan.exchange;
  return 0;
}

extern "C" int nesie_fps_onchip(const void* xyz, int b, int n, int m,
                                int cluster, int threads, int exchange,
                                void* scratch, void* out, void* stream) {
  Plan plan;
  const cudaError_t err =
      make_plan(b, n, cluster, threads, exchange, false, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch(plan, xyz, b, n, m, scratch, out, nullptr, stream));
}

// The instrumented kernel: as nesie_fps_onchip, and kTimedSteps x 6 int64
// clock64() stamps of CTA 0's thread 0 into stamps (steps past M-1 are
// left as they were).
extern "C" int nesie_fps_onchip_timed(const void* xyz, int b, int n, int m,
                                      int cluster, int threads, int exchange,
                                      void* stamps, void* out, void* stream) {
  Plan plan;
  const cudaError_t err =
      make_plan(b, n, cluster, threads, exchange, true, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch(plan, xyz, b, n, m, nullptr, out, stamps, stream));
}
