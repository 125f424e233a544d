// The FPS lab's step variants for Hopper (sm_90a), on the on-chip frame
// of fps_onchip.cu.
//
// Replaces the step bodies of the TPU FPS lab, one kernel instantiation
// per (variant, points per thread, exchange) (the variant id is the C
// entry point's first argument; nesie_tpu_torch/ops/fps_variants.py names
// them):
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
// Every variant computes exactly fps_ref's D-FPS (slot 0 is index 0,
// every distance starts at 1e10, each step takes min(dist, |p - p_last|^2)
// from sq_dist.cuh and the lowest index of the maximum).
//
// The frame. The TPU lab keeps a row's coordinates and distances in VMEM
// for all M steps (tools/fps_lab.py:223-228, 274-277); on Hopper that is
// fps_onchip.cu's frame (fps_frame.cuh), and every variant runs on it:
// the row is cut into C slices of len = ceil(N / C) points, one CTA each
// (C = 1: one CTA a row, the local exchange; C > 1: a cluster with a
// mailbox or mailbox_cta exchange), each thread owns P consecutive points,
// their distances in P registers and their coordinates in shared memory in
// (x[4], y[4], z[4]) groups. There is no global distance scratch and no
// pass over the row in device memory (F1's one 12-byte load of the winner
// a step is that variant's idea). A launch takes the plan that
// fps_onchip_plan(B, N) gives for the shape (C, threads, P, exchange:
// ops/fps.py), v3 its own two-row plan (below); only the plans the H100
// picks at the lab's shapes, its check clouds and the GPU tests' shapes
// are instantiated (kEntries), and any other returns cudaErrorInvalidValue.
//
// Threads own consecutive points, warps, CTAs and mailbox slots follow in
// index order, and a candidate's value is its distance's bits plus 1 (0:
// no point), reduced by redux.sync and a ballot. Each variant differs
// from the shipped step (v4, the lab's control) by one idea:
//
// Select, how the next index is found:
//   S4 bitcast (v2-v5; the TPU's _tie_bitcast): the shipped step. One
//      exchange a step: the candidate (value, index, ...) reduced in the
//      warp (the lowest lane of the largest value holds the lowest index),
//      then over the slots after the exchange.
//   S2 max-then-min (v2_merged, v3_blocked, v1; the TPU's max, then the
//      min of the iota where the distance equals it): two dependent
//      exchanges a step. Round 1 reduces the value alone over the warp,
//      then the CTA or cluster; round 2 the lowest index among the threads
//      whose own best equals that maximum. Across a cluster that is two
//      mailbox phases a step.
//   S3 argmax-refetch-min (v4_blocked2; the TPU's argmax, then the value
//      read back by that index with a dynamic load from its blocked
//      distance cache, tools/fps_lab.py:183-189, then the min index):
//      round 1 keeps any index of the maximum (the highest lane and slot,
//      so round 2 has ties to undo); the value is read back by that index
//      from the distance cache of the owning thread in the owning CTA
//      (ld.shared::cluster through mapa); round 2 as S2. Registers cannot
//      be addressed by an index, so S3 moved the row's distances from
//      registers into shared memory (slot t of thread i at t * threads +
//      i): its point loop reads and writes them there.
// Fetch, where the next step's centre comes from:
//   F2 merged (v2_merged, v4, v5; the TPU's one merged fetch of the
//      stacked coordinates): the winner's coordinates ride in the
//      candidate, 20 bytes as in the shipped step (S2: in round 2's
//      (index, x, y, z)).
//   F1 aos3 (v1-v3; the TPU's masked-sum fetch from the row): the
//      candidate carries value and index only; after the exchange every
//      thread loads the winner's 12 bytes from the (B, N, 3) input in
//      device memory (an L2 hit): one dependent load a step.
//   F3 blocked (v3_blocked, v4_blocked2; the TPU's dynamic load from its
//      (B, 3, Nb, 128) blocked layout): value and index only; the winner's
//      coordinates are read from the owning CTA's slice through DSMEM
//      (mapa + ld.shared::cluster), or from the CTA's own slice for one
//      CTA.
// Rows 2 (v3; the TPU's two interleaved row chains): one CTA or cluster
//   carries rows 2g and 2g + 1, each thread P points of each (2P
//   registers), one point loop updates both rows, and both rows'
//   (value, index) travel in one 16-byte push, read after one wait: one
//   exchange serves two row-steps. Its plan is fps_onchip_plan(ceil(B / 2),
//   2N) (the cost model with the points an SM holds counted for both
//   rows) with P halved, up to a multiple of 4. An odd B leaves the last
//   CTA or cluster one row.
// Unroll 4 (v5; fori_loop(unroll=4)): `#pragma unroll 4` on the step loop.
//
// What each idea costs on an H100 80GB HBM3 at 700 W, in ns a step
// against the variant that differs by that idea alone, at the same plan
// (`fps_lab bench` and `fps_experiments`, two runs agreeing within 9 ns),
// at 8 x 40000 -> 2048 (C=6, 128 threads, P=64, mailbox) / 32 x 40000 ->
// 2048 (C=7, 128 threads, P=48, mailbox: 224 CTAs, two on most SMs). The
// shipped step takes 910 / 1301-1307 ns, v4 884-888 / 1255-1262:
//   S2's second round (v2_merged - v4)                  +225-231 / +512-518
//   S2 under F1 (v1 - v2)                        +194-203 / -116 to -115
//   F1's load from L2 (v2 - v4)                           +81-83 / +298-302
//   F3's DSMEM read, not F2's ride (v3_blocked - v2_merged)
//                                                    +97-99 / -1 to +3
//   S3, not S2 (v4_blocked2 - v3_blocked)           +1335-1343 / +728-733
//   two rows, v3's plan (v3 - v2)                       +464-472 / +553-556
//   unroll 4 (v5 - v4)                                  +623-629 / +13-14
// S3 pays for the distances in shared memory in its point loop and for
// the read-back; the lab does not split the two. v5 at P=64 is 6384 SASS
// instructions against v4's 2128 (`fps_lab sass`). At 32 x 40000 the
// costs do not add: a second round under F1 is cheaper than one (not
// explained; two CTAs share most SMs).
//
// The exchanges of a step. Exchange k of a row (S4: k = step - 1; S2 and
// S3: k = 2 (step - 1) + round) uses buffer, stage buffer and mbarrier
// k & 1, and waits for that barrier's phase (k >> 1) & 1: S4 alternates
// them by step as fps_onchip.cu does, S2 and S3 give each round its own,
// every step. Why that is safe for any sequence of exchanges: a CTA
// pushes exchange k + 2 into buffer k & 1 of a peer only after it holds
// the peer's exchange k + 1 candidates, which the peer sends only after
// every one of its warps read its exchange k buffer (mailbox: every warp
// pushes its own, after its own read; mailbox_cta: warp 0 pushes after a
// __syncthreads that every warp reaches after its read; one CTA: the
// __syncthreads of exchange k + 1). The same chain orders the barriers:
// thread 0 arms barrier k & 1 for exchange k + 2 at the start of the
// step that holds it, after it waited on exchange k's phase, and no byte
// of exchange k + 2 can arrive before that phase completed; an early
// complete_tx drives the phase's count below zero until the arm brings it
// back (fps_onchip.cu's head note). S3's read-back: the owning warp wrote
// the distance before its push (__syncwarp, then st.async's release at
// cluster scope, or the stage's __syncthreads), the reader reads it after
// its acquire wait, and the owner overwrites it only in the next step's
// point loop, after it holds the reader's round-2 candidate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fps_frame.cuh"
#include "sq_dist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr unsigned kNone = 0xffffffffu;  // a round-2 candidate of no index

enum Select : int { kMaxThenMin, kRefetch, kBitcast };  // S2, S3, S4
enum Fetch : int { kAos3, kMerged, kBlocked };          // F1, F2, F3

struct Idea {
  int select, fetch, rows, unroll;
};

// variant id -> its idea (the order of ops/fps_variants.py's VARIANTS)
__host__ __device__ constexpr Idea idea(int v) {
  switch (v) {
    case 0: return {kMaxThenMin, kMerged, 1, 1};   // v2_merged
    case 1: return {kMaxThenMin, kBlocked, 1, 1};  // v3_blocked
    case 2: return {kRefetch, kBlocked, 1, 1};     // v4_blocked2
    case 3: return {kMaxThenMin, kAos3, 1, 1};     // v1
    case 4: return {kBitcast, kAos3, 1, 1};        // v2
    case 5: return {kBitcast, kAos3, 2, 1};        // v3
    case 6: return {kBitcast, kMerged, 1, 1};      // v4
    default: return {kBitcast, kMerged, 1, 4};     // v5
  }
}

// 32-bit words of exchange round r's candidate: S4 (value, index, x, y,
// z) with F2, (value, index) a row otherwise; S2 (value), then (index, x,
// y, z) with F2 or (index); S3 (value, index), then (index)
__host__ __device__ constexpr int round_words(int v, int r) {
  return idea(v).select == kBitcast
             ? (idea(v).fetch == kMerged ? 5 : 2 * idea(v).rows)
         : r == 0 ? (idea(v).select == kRefetch ? 2 : 1)
         : idea(v).fetch == kMerged ? 4
                                    : 1;
}

__host__ __device__ constexpr int rounds(int v) {
  return idea(v).select == kBitcast ? 1 : 2;
}

// the words a buffer slot is given: the larger round's
__host__ __device__ constexpr int slot_words(int v) {
  return round_words(v, 0) > round_words(v, 1) ? round_words(v, 0)
                                               : round_words(v, 1);
}

// words of a buffer of cap slots of w words (16-byte aligned)
__host__ __device__ constexpr int region_words(int cap, int w) {
  return (cap * w + 3) / 4 * 4;
}

// Slot s of a buffer of cap slots of W words: a vector of W words (W = 1,
// 2, 4), or (W = 5) a 16-byte head at s and a tail word at 4 cap + s, as
// the shipped mailbox keeps them.
template <int W>
__device__ __forceinline__ void put(unsigned* buf, int cap, int s,
                                    const unsigned (&c)[W]) {
  if constexpr (W == 1) {
    buf[s] = c[0];
  } else if constexpr (W == 2) {
    reinterpret_cast<uint2*>(buf)[s] = make_uint2(c[0], c[1]);
  } else {
    reinterpret_cast<uint4*>(buf)[s] = make_uint4(c[0], c[1], c[2], c[3]);
    if constexpr (W == 5) buf[4 * cap + s] = c[4];
  }
}

template <int W>
__device__ __forceinline__ void get(const unsigned* buf, int cap, int s,
                                    unsigned (&c)[W]) {
  if constexpr (W == 1) {
    c[0] = buf[s];
  } else if constexpr (W == 2) {
    const uint2 u = reinterpret_cast<const uint2*>(buf)[s];
    c[0] = u.x;
    c[1] = u.y;
  } else {
    const uint4 u = reinterpret_cast<const uint4*>(buf)[s];
    c[0] = u.x;
    c[1] = u.y;
    c[2] = u.z;
    c[3] = u.w;
    if constexpr (W == 5) c[4] = buf[4 * cap + s];
  }
}

// st.async of slot s's words into the same slot of CTA `to`, completing
// their bytes on its barrier
template <int W>
__device__ __forceinline__ void push(unsigned* buf, int cap, int s, int to,
                                     unsigned bar, const unsigned (&c)[W]) {
  const unsigned b = peer(bar, to);
  if constexpr (W == 5) {
    push_async(peer(smem_u32(reinterpret_cast<uint4*>(buf) + s), to),
               peer(smem_u32(buf + 4 * cap + s), to), b,
               make_uint4(c[0], c[1], c[2], c[3]), __uint_as_float(c[4]));
  } else if constexpr (W == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];\n" ::"r"(
            peer(smem_u32(reinterpret_cast<uint4*>(buf) + s), to)),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(b)
        : "memory");
  } else if constexpr (W == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
        "{%1, %2}, [%3];\n" ::"r"(
            peer(smem_u32(reinterpret_cast<uint2*>(buf) + s), to)),
        "r"(c[0]), "r"(c[1]), "r"(b)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];\n" ::"r"(peer(smem_u32(buf + s), to)),
        "r"(c[0]), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ float ld_cluster(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// How a round picks its winner among the slots.
enum Pick : int {
  kMaxLow,   // the largest word 0, its lowest slot (S4)
  kMaxHigh,  // the largest word 0, its highest slot (S3's round 1)
  kMaxOnly,  // the largest word 0 alone (S2's round 1)
  kMinLow,   // the smallest word 0 (the index of S2's and S3's round 2)
  kRowsMax,  // kMaxLow of words 0 and 2 apart (v3's two rows)
};

// Each lane scans consecutive slots for the largest (kMinLow: smallest)
// word k; *top gets it, in every lane, and the slot holding it is
// returned: the lowest such slot, or the highest for kMaxHigh.
template <int kPick>
__device__ __forceinline__ int scan_slots(const unsigned* buf, int stride,
                                          int k, int count, unsigned* top) {
  constexpr bool kMin = kPick == kMinLow;
  const int lane = threadIdx.x & 31;
  const int per = (count + 31) >> 5;
  unsigned bv = kMin ? kNone : 0u;
  int bs = 0;
  for (int q = 0; q < per; ++q) {
    const int s = lane * per + q;
    if (s < count) {
      const unsigned v = buf[s * stride + k];
      if (kMin ? v < bv : kPick == kMaxHigh ? v >= bv : v > bv) {
        bv = v;
        bs = s;
      }
    }
  }
  *top = kMin ? __reduce_min_sync(kFull, bv) : __reduce_max_sync(kFull, bv);
  if constexpr (kPick == kMaxOnly) return 0;
  const unsigned holders = __ballot_sync(kFull, bv == *top);
  const int h = kPick == kMaxHigh ? 31 - __clz(holders) : __ffs(holders) - 1;
  return __shfl_sync(kFull, bs, h);
}

// The winner of slots [0, count) of a buffer of cap slots, into c, in
// every lane.
template <int W, int kPick>
__device__ __forceinline__ void pick(const unsigned* buf, int cap, int count,
                                     unsigned (&c)[W]) {
  constexpr int stride = W == 5 ? 4 : W;
  unsigned top;
  if constexpr (kPick == kRowsMax) {
    const int s0 = scan_slots<kMaxLow>(buf, stride, 0, count, &top);
    c[0] = top;
    c[1] = buf[s0 * stride + 1];
    const int s1 = scan_slots<kMaxLow>(buf, stride, 2, count, &top);
    c[2] = top;
    c[3] = buf[s1 * stride + 3];
  } else if constexpr (kPick == kMaxOnly) {
    scan_slots<kMaxOnly>(buf, stride, 0, count, &top);
    c[0] = top;
  } else {
    get<W>(buf, cap, scan_slots<kPick>(buf, stride, 0, count, &top), c);
  }
}

// One exchange. c: the warp's candidate, in every lane; on return the
// row's winner of this round, in every thread. buf: the exchange's buffer
// (cap slots), stage: mailbox_cta's buffer of its warps' candidates, bar
// and parity: its barrier and the phase it waits for; rank and csize: the
// CTA's place in its cluster.
template <int X, int W, int kPick>
__device__ __forceinline__ void exchange(unsigned (&c)[W], unsigned* buf,
                                         int cap, unsigned* stage,
                                         unsigned bar, unsigned parity,
                                         int rank, int csize) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if constexpr (X == kLocal) {
    if (nwarps == 1) return;
    if (lane == 0) put<W>(buf, cap, warp, c);
    __syncthreads();
    pick<W, kPick>(buf, cap, nwarps, c);
  } else {
    if constexpr (X == kMailboxCta) {
      if (lane == 0) put<W>(stage, nwarps, warp, c);
      __syncthreads();
      if (warp == 0) pick<W, kPick>(stage, nwarps, nwarps, c);
    }
    if ((X == kMailbox || warp == 0) && lane < csize) {
      push<W>(buf, cap, X == kMailbox ? rank * nwarps + warp : rank, lane,
              bar, c);
    }
    mbar_wait(bar, parity);
    pick<W, kPick>(buf, cap, cap, c);
  }
}

// The slice, CTA and thread that own row index i: point j of the slice
// of CTA r, slot t of thread o.
template <int P, int X>
__device__ __forceinline__ void owner(unsigned i, int len, int* r, int* o,
                                      int* t) {
  *r = X == kLocal ? 0 : static_cast<int>(i) / len;
  const int j = static_cast<int>(i) - *r * len;
  *o = j / P;
  *t = j - *o * P;
}

// S3: the distance of row index i, read back from its owner's slot.
template <int P, int X>
__device__ __forceinline__ float dist_at(const float* sdist, unsigned i,
                                         int len, int nthreads) {
  int r, o, t;
  owner<P, X>(i, len, &r, &o, &t);
  const float* a = sdist + t * nthreads + o;
  if constexpr (X == kLocal) return *a;
  return ld_cluster(peer(smem_u32(a), r));
}

// F3: the coordinates of row index i, from its owner's slice.
template <int P, int X>
__device__ __forceinline__ void coords_at(const float* coords, unsigned i,
                                          int len, float* x, float* y,
                                          float* z) {
  int r, o, t;
  owner<P, X>(i, len, &r, &o, &t);
  const float* a = coords + o * stride_words(P) + (t >> 2) * 12 + (t & 3);
  if constexpr (X == kLocal) {
    *x = a[0];
    *y = a[4];
    *z = a[8];
  } else {
    const unsigned u = peer(smem_u32(a), r);
    *x = ld_cluster(u);
    *y = ld_cluster(u + 16);
    *z = ld_cluster(u + 32);
  }
}

// The CTA's place in its row group: cluster rank and size (1 for the
// local exchange).
template <int X>
__device__ __forceinline__ void cluster_place(int* rank, int* csize) {
  *rank = 0;
  *csize = 1;
  if constexpr (X != kLocal) {
    cg::cluster_group cluster = cg::this_cluster();
    *rank = static_cast<int>(cluster.block_rank());
    *csize = static_cast<int>(cluster.num_blocks());
  }
}

// Barriers initialised and made visible to the cluster, the staged
// slices visible to every thread, and every CTA started before the first
// remote store.
template <int X>
__device__ __forceinline__ void start_exchange(unsigned long long* bars) {
  if constexpr (X == kLocal) {
    __syncthreads();
  } else {
    if (threadIdx.x == 0) {
      mbar_init(smem_u32(&bars[0]));
      mbar_init(smem_u32(&bars[1]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    cluster_arrive();
    cluster_wait();
  }
}

// No CTA leaves while a peer may still write into its shared memory.
template <int X>
__device__ __forceinline__ void end_exchange() {
  if constexpr (X != kLocal) {
    __syncwarp();
    cluster_arrive();
    cluster_wait();
  }
}

// The single-row variants (every id but v3's).
template <int V, int P, int X>
__global__ void __launch_bounds__(P <= 20 ? 1024 : 512)
fps_variant_kernel(const float* __restrict__ xyz, int batch, int n, int m,
                   int len, int* __restrict__ out) {
  static_assert(P % 4 == 0, "points per thread come in groups of four");
  static_assert(idea(V).rows == 1, "v3 has its own kernel");
  constexpr Idea kI = idea(V);
  constexpr int S = stride_words(P);
  constexpr int W = slot_words(V);
  constexpr bool kDistSmem = kI.select == kRefetch;
  constexpr int kUnroll = kI.unroll;
  extern __shared__ float4 smem4[];  // coordinates, then the exchange
  __shared__ __align__(8) unsigned long long bars[2];
  float* coords = reinterpret_cast<float*>(smem4);

  int rank, csize;
  cluster_place<X>(&rank, &csize);
  const int b = blockIdx.x / csize;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * m;
  const int start = rank * len;
  const int count = max(0, min(n, start + len) - start);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  // S3's distances, then two exchange buffers and (mailbox_cta) two stage
  // buffers of its warps' candidates
  float* sdist = coords + nthreads * S;
  unsigned* bufs =
      reinterpret_cast<unsigned*>(sdist + (kDistSmem ? P * nthreads : 0));
  const int cap = X == kMailbox      ? csize * nwarps
                  : X == kMailboxCta ? csize
                                     : nwarps;
  const int region = region_words(cap, W);
  unsigned* stages = bufs + 2 * region;
  const int stage_region = region_words(nwarps, W);

  stage_slice<P>(coords, p + static_cast<size_t>(start) * 3, count, tid,
                 nthreads);
  // a slot past the slice keeps distance -1: never above the best
  float d[kDistSmem ? 1 : P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const bool pad = tid * P + t >= count;
    if constexpr (kDistSmem) {
      sdist[t * nthreads + tid] = pad ? -1.0f : 1e10f;
    } else {
      d[t] = pad ? -1.0f : 1e10f;
    }
    if (pad) {
      float* q = coords + tid * S + (t >> 2) * 12 + (t & 3);
      q[0] = q[4] = q[8] = 0.0f;
    }
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  start_exchange<X>(bars);
  const unsigned pushers =
      static_cast<unsigned>(X == kMailbox ? csize * nwarps : csize);

  const float4* mine = smem4 + tid * (S / 4);
#pragma unroll (kUnroll)
  for (int step = 1; step < m; ++step) {
    // exchange k uses buffer, stage and barrier k & 1 and waits for phase
    // (k >> 1) & 1 of that barrier (head note)
    const int k0 = rounds(V) == 1 ? (step - 1) & 1 : 0;
    const unsigned ph = static_cast<unsigned>(
        rounds(V) == 1 ? ((step - 1) >> 1) & 1 : (step - 1) & 1);
    if (X != kLocal && tid == 0) {
      mbar_arm(smem_u32(&bars[k0]), pushers * 4u * round_words(V, 0));
      if (rounds(V) == 2) {
        mbar_arm(smem_u32(&bars[1]), pushers * 4u * round_words(V, 1));
      }
    }
    float bv = -1.0f;
    int bt = 0;
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      const float4 x = mine[3 * g];
      const float4 y = mine[3 * g + 1];
      const float4 z = mine[3 * g + 2];
      if constexpr (kDistSmem) {
        float* dg = sdist + 4 * g * nthreads + tid;
        visit(dg[0], x.x, y.x, z.x, lx, ly, lz, bv, bt, 4 * g + 0);
        visit(dg[nthreads], x.y, y.y, z.y, lx, ly, lz, bv, bt, 4 * g + 1);
        visit(dg[2 * nthreads], x.z, y.z, z.z, lx, ly, lz, bv, bt, 4 * g + 2);
        visit(dg[3 * nthreads], x.w, y.w, z.w, lx, ly, lz, bv, bt, 4 * g + 3);
      } else {
        visit(d[4 * g + 0], x.x, y.x, z.x, lx, ly, lz, bv, bt, 4 * g + 0);
        visit(d[4 * g + 1], x.y, y.y, z.y, lx, ly, lz, bv, bt, 4 * g + 1);
        visit(d[4 * g + 2], x.z, y.z, z.z, lx, ly, lz, bv, bt, 4 * g + 2);
        visit(d[4 * g + 3], x.w, y.w, z.w, lx, ly, lz, bv, bt, 4 * g + 3);
      }
    }
    const unsigned v = bv >= 0.0f ? __float_as_uint(bv) + 1u : 0u;
    const unsigned gi = static_cast<unsigned>(start + tid * P + bt);
    const float* q = coords + tid * S + (bt >> 2) * 12 + (bt & 3);
    unsigned* buf0 = bufs + k0 * region;
    unsigned* stage0 = stages + k0 * stage_region;
    unsigned win;
    if constexpr (kI.select == kBitcast) {
      if constexpr (kI.fetch == kMerged) {  // the shipped step
        const Best w = warp_best(Best{v, gi, q[0], q[4], q[8]});
        unsigned c[5] = {w.v, w.i, __float_as_uint(w.x),
                         __float_as_uint(w.y), __float_as_uint(w.z)};
        exchange<X, 5, kMaxLow>(c, buf0, cap, stage0, smem_u32(&bars[k0]),
                                ph, rank, csize);
        win = c[1];
        lx = __uint_as_float(c[2]);
        ly = __uint_as_float(c[3]);
        lz = __uint_as_float(c[4]);
      } else {
        const unsigned top = __reduce_max_sync(kFull, v);
        const int h = __ffs(__ballot_sync(kFull, v == top)) - 1;
        unsigned c[2] = {top, __shfl_sync(kFull, gi, h)};
        exchange<X, 2, kMaxLow>(c, buf0, cap, stage0, smem_u32(&bars[k0]),
                                ph, rank, csize);
        win = c[1];
      }
    } else {
      unsigned top;  // the row's largest value
      if constexpr (kI.select == kMaxThenMin) {
        unsigned c[1] = {__reduce_max_sync(kFull, v)};
        exchange<X, 1, kMaxOnly>(c, buf0, cap, stage0, smem_u32(&bars[0]),
                                 ph, rank, csize);
        top = c[0];
      } else {
        __syncwarp();  // the warp's distance writes before its push
        const unsigned wt = __reduce_max_sync(kFull, v);
        const unsigned holders = __ballot_sync(kFull, v == wt);
        unsigned c[2] = {wt, __shfl_sync(kFull, gi, 31 - __clz(holders))};
        exchange<X, 2, kMaxHigh>(c, buf0, cap, stage0, smem_u32(&bars[0]),
                                 ph, rank, csize);
        top = __float_as_uint(dist_at<P, X>(sdist, c[1], len, nthreads)) +
              1u;
      }
      const unsigned ci = v == top ? gi : kNone;
      const unsigned low = __reduce_min_sync(kFull, ci);
      unsigned* buf1 = bufs + region;
      unsigned* stage1 = stages + stage_region;
      if constexpr (kI.fetch == kMerged) {
        const int h = __ffs(__ballot_sync(kFull, ci == low)) - 1;
        unsigned c[4] = {low, __shfl_sync(kFull, __float_as_uint(q[0]), h),
                         __shfl_sync(kFull, __float_as_uint(q[4]), h),
                         __shfl_sync(kFull, __float_as_uint(q[8]), h)};
        exchange<X, 4, kMinLow>(c, buf1, cap, stage1, smem_u32(&bars[1]), ph,
                                rank, csize);
        win = c[0];
        lx = __uint_as_float(c[1]);
        ly = __uint_as_float(c[2]);
        lz = __uint_as_float(c[3]);
      } else {
        unsigned c[1] = {low};
        exchange<X, 1, kMinLow>(c, buf1, cap, stage1, smem_u32(&bars[1]), ph,
                                rank, csize);
        win = c[0];
      }
    }
    if constexpr (kI.fetch == kAos3) {
      const float* w = p + 3 * static_cast<size_t>(win);
      lx = __ldg(w);
      ly = __ldg(w + 1);
      lz = __ldg(w + 2);
    } else if constexpr (kI.fetch == kBlocked) {
      coords_at<P, X>(coords, win, len, &lx, &ly, &lz);
    }
    if (rank == 0 && tid == 0) o[step] = static_cast<int>(win);
  }
  end_exchange<X>();
}

// v3: rows 2g and 2g + 1 on one CTA or cluster (S4, F1), P points of each
// a thread; one exchange a step carries both rows' (value, index).
template <int P, int X>
__global__ void __launch_bounds__(P <= 10 ? 1024 : 512)
fps_variant_rows2_kernel(const float* __restrict__ xyz, int batch, int n,
                         int m, int len, int* __restrict__ out) {
  static_assert(P % 4 == 0, "points per thread come in groups of four");
  constexpr int S = stride_words(P);
  extern __shared__ float4 smem4[];  // both rows' coordinates, the exchange
  __shared__ __align__(8) unsigned long long bars[2];

  int rank, csize;
  cluster_place<X>(&rank, &csize);
  const int r0 = 2 * (blockIdx.x / csize);
  const bool two = r0 + 1 < batch;  // an odd B: the last group has one row
  const float* p0 = xyz + static_cast<size_t>(r0) * n * 3;
  const float* p1 = two ? p0 + static_cast<size_t>(n) * 3 : p0;
  int* o0 = out + static_cast<size_t>(r0) * m;
  int* o1 = o0 + m;
  const int start = rank * len;
  const int count0 = max(0, min(n, start + len) - start);
  const int count1 = two ? count0 : 0;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  float* coords0 = reinterpret_cast<float*>(smem4);
  float* coords1 = coords0 + nthreads * S;
  unsigned* bufs = reinterpret_cast<unsigned*>(coords1 + nthreads * S);
  const int cap = X == kMailbox      ? csize * nwarps
                  : X == kMailboxCta ? csize
                                     : nwarps;
  const int region = region_words(cap, 4);
  unsigned* stages = bufs + 2 * region;
  const int stage_region = region_words(nwarps, 4);

  stage_slice<P>(coords0, p0 + static_cast<size_t>(start) * 3, count0, tid,
                 nthreads);
  stage_slice<P>(coords1, p1 + static_cast<size_t>(start) * 3, count1, tid,
                 nthreads);
  float d0[P], d1[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const bool pad0 = tid * P + t >= count0;
    const bool pad1 = tid * P + t >= count1;
    d0[t] = pad0 ? -1.0f : 1e10f;
    d1[t] = pad1 ? -1.0f : 1e10f;
    const int w = tid * S + (t >> 2) * 12 + (t & 3);
    if (pad0) coords0[w] = coords0[w + 4] = coords0[w + 8] = 0.0f;
    if (pad1) coords1[w] = coords1[w + 4] = coords1[w + 8] = 0.0f;
  }
  float lx0 = p0[0], ly0 = p0[1], lz0 = p0[2];
  float lx1 = p1[0], ly1 = p1[1], lz1 = p1[2];
  if (rank == 0 && tid == 0) {
    o0[0] = 0;
    if (two) o1[0] = 0;
  }
  start_exchange<X>(bars);
  const unsigned pushers =
      static_cast<unsigned>(X == kMailbox ? csize * nwarps : csize);

  const float4* mine0 = smem4 + tid * (S / 4);
  const float4* mine1 = mine0 + nthreads * (S / 4);
  for (int step = 1; step < m; ++step) {
    const int k = (step - 1) & 1;
    const unsigned ph = static_cast<unsigned>(((step - 1) >> 1) & 1);
    if (X != kLocal && tid == 0) mbar_arm(smem_u32(&bars[k]), pushers * 16u);
    float bv0 = -1.0f, bv1 = -1.0f;
    int bt0 = 0, bt1 = 0;
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      const float4 x0 = mine0[3 * g];
      const float4 y0 = mine0[3 * g + 1];
      const float4 z0 = mine0[3 * g + 2];
      const float4 x1 = mine1[3 * g];
      const float4 y1 = mine1[3 * g + 1];
      const float4 z1 = mine1[3 * g + 2];
      visit(d0[4 * g + 0], x0.x, y0.x, z0.x, lx0, ly0, lz0, bv0, bt0, 4 * g);
      visit(d1[4 * g + 0], x1.x, y1.x, z1.x, lx1, ly1, lz1, bv1, bt1, 4 * g);
      visit(d0[4 * g + 1], x0.y, y0.y, z0.y, lx0, ly0, lz0, bv0, bt0,
            4 * g + 1);
      visit(d1[4 * g + 1], x1.y, y1.y, z1.y, lx1, ly1, lz1, bv1, bt1,
            4 * g + 1);
      visit(d0[4 * g + 2], x0.z, y0.z, z0.z, lx0, ly0, lz0, bv0, bt0,
            4 * g + 2);
      visit(d1[4 * g + 2], x1.z, y1.z, z1.z, lx1, ly1, lz1, bv1, bt1,
            4 * g + 2);
      visit(d0[4 * g + 3], x0.w, y0.w, z0.w, lx0, ly0, lz0, bv0, bt0,
            4 * g + 3);
      visit(d1[4 * g + 3], x1.w, y1.w, z1.w, lx1, ly1, lz1, bv1, bt1,
            4 * g + 3);
    }
    const unsigned v0 = bv0 >= 0.0f ? __float_as_uint(bv0) + 1u : 0u;
    const unsigned v1 = bv1 >= 0.0f ? __float_as_uint(bv1) + 1u : 0u;
    const unsigned top0 = __reduce_max_sync(kFull, v0);
    const unsigned top1 = __reduce_max_sync(kFull, v1);
    const int h0 = __ffs(__ballot_sync(kFull, v0 == top0)) - 1;
    const int h1 = __ffs(__ballot_sync(kFull, v1 == top1)) - 1;
    unsigned c[4] = {
        top0, __shfl_sync(kFull, static_cast<unsigned>(start + tid * P + bt0),
                          h0),
        top1, __shfl_sync(kFull, static_cast<unsigned>(start + tid * P + bt1),
                          h1)};
    exchange<X, 4, kRowsMax>(c, bufs + k * region, cap,
                             stages + k * stage_region, smem_u32(&bars[k]),
                             ph, rank, csize);
    const float* w0 = p0 + 3 * static_cast<size_t>(c[1]);
    lx0 = __ldg(w0);
    ly0 = __ldg(w0 + 1);
    lz0 = __ldg(w0 + 2);
    if (two) {
      const float* w1 = p1 + 3 * static_cast<size_t>(c[3]);
      lx1 = __ldg(w1);
      ly1 = __ldg(w1 + 1);
      lz1 = __ldg(w1 + 2);
    }
    if (rank == 0 && tid == 0) {
      o0[step] = static_cast<int>(c[1]);
      if (two) o1[step] = static_cast<int>(c[3]);
    }
  }
  end_exchange<X>();
}

using Kernel = void (*)(const float*, int, int, int, int, int*);

struct Entry {
  int variant;
  int p;  // points a thread (of each row for v3)
  int exchange;
  Kernel fn;
};

#define NESIE_ONE(V, P, X) \
  { V, P, X, fps_variant_kernel<V, P, X> }
#define NESIE_ROW(P, X)                                                     \
  NESIE_ONE(0, P, X), NESIE_ONE(1, P, X), NESIE_ONE(2, P, X),               \
      NESIE_ONE(3, P, X), NESIE_ONE(4, P, X), NESIE_ONE(6, P, X),           \
      NESIE_ONE(7, P, X)
#define NESIE_PAIR(P, X) \
  { 5, P, X, fps_variant_rows2_kernel<P, X> }

// Only the plans fps_onchip_plan picks on the H100 (cluster, threads):
const Entry kEntries[] = {
    NESIE_ROW(8, kLocal),        // 3 x 600 (96), B x 1000 and 1024 (128)
    NESIE_ROW(16, kLocal),       // 1 x 512 (32)
    NESIE_ROW(20, kMailbox),     // 7 x 4099 (2, 128)
    NESIE_ROW(20, kMailboxCta),  // 7 x 40000 (16, 128)
    NESIE_ROW(48, kMailbox),     // 32 x 40000 (7, 128)
    NESIE_ROW(64, kMailbox),     // 8 x 40000 (6, 128)
    // v3: the plan of ceil(B / 2) x 2N, P halved up to a multiple of 4
    NESIE_PAIR(4, kLocal),        // 1 x 512: 1 x 1024's P 8 (128)
    NESIE_PAIR(8, kLocal),        // 3 x 600, B x 1000 and 1024: P 12, 16
    NESIE_PAIR(12, kMailbox),     // 7 x 4099: 4 x 8198's P 24 (3, 128)
    NESIE_PAIR(20, kMailboxCta),  // 7 and 8 x 40000: 4 x 80000's P 40 (16)
    NESIE_PAIR(32, kMailboxCta),  // 32 x 40000: 16 x 80000's P 64 (12)
};

#undef NESIE_PAIR
#undef NESIE_ROW
#undef NESIE_ONE

// Dynamic shared memory of a launch: the coordinates (both rows' for v3),
// S3's distances, two exchange buffers and mailbox_cta's two stage
// buffers, for a cluster of c CTAs of w warps.
int smem_bytes(int v, int p, int x, int c, int w) {
  const int threads = 32 * w;
  const int cap = x == kMailbox ? c * w : x == kMailboxCta ? c : w;
  int words = idea(v).rows * threads * stride_words(p) +
              2 * region_words(cap, slot_words(v));
  if (idea(v).select == kRefetch) words += p * threads;
  if (x == kMailboxCta) words += 2 * region_words(w, slot_words(v));
  return 4 * words;
}

// A kernel's thread limit and the dynamic shared memory left beside its
// static arrays, which it is then allowed to take (with non-portable
// cluster sizes allowed): set on its first launch, then cached.
cudaError_t kernel_limits(const Entry& e, int* max_threads, int* room) {
  constexpr int kNumEntries = sizeof(kEntries) / sizeof(kEntries[0]);
  static int g_limit[kNumEntries], g_room[kNumEntries];
  const int k = static_cast<int>(&e - kEntries);
  if (g_limit[k] == 0) {
    const void* fn = reinterpret_cast<const void*>(e.fn);
    int dev = 0, optin = 0;
    cudaFuncAttributes a;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(a.sharedSizeBytes));
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    g_room[k] = optin - static_cast<int>(a.sharedSizeBytes);
    g_limit[k] = a.maxThreadsPerBlock;
  }
  *max_threads = g_limit[k];
  *room = g_room[k];
  return cudaSuccess;
}

}  // namespace

// Launch variant `variant` with the plan (cluster, threads, points a
// thread, exchange as in nesie_fps_onchip_plan) the host took from
// fps_onchip_plan: (B, N, 3) float32 -> (B, M) int32. A plan outside
// kEntries, or one that does not hold the row, returns
// cudaErrorInvalidValue.
extern "C" int nesie_fps_variant(int variant, const void* xyz, int b, int n,
                                 int m, int cluster, int threads, int ppt,
                                 int exchange, void* out, void* stream) {
  const Entry* e = nullptr;
  for (const Entry& k : kEntries) {
    if (k.variant == variant && k.p == ppt && k.exchange == exchange) e = &k;
  }
  if (e == nullptr || b < 1 || n < 1 || m < 1 || m > n || cluster < 1 ||
      cluster > kMaxCluster || (exchange == kLocal) != (cluster == 1) ||
      threads < 32 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int len = (n + cluster - 1) / cluster;
  if (static_cast<long long>(threads) * ppt < len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(variant, ppt, exchange, cluster, threads / 32);
  int limit = 0, room = 0;
  const cudaError_t err = kernel_limits(*e, &limit, &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads > limit || smem > room) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (b + idea(variant).rows - 1) / idea(variant).rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  if (exchange != kLocal) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(cluster);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, e->fn, static_cast<const float*>(xyz), b, n,
                         m, len, static_cast<int*>(out));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}
