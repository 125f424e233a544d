// The on-chip FPS frame shared by fps_onchip.cu (the main path's FPS) and
// fps_variants.cu (the FPS lab's step variants on the same frame).
//
// A row lives on chip for all M steps: each thread of a CTA owns P
// consecutive points of the CTA's slice, their distances in P registers
// and their coordinates in shared memory in (x[4], y[4], z[4]) groups
// (stride_words, stage_slice). A step's candidates travel through one of
// the exchanges below; the device pieces of the mailbox (the mbarrier
// helpers, mapa and st.async) and the warp and slot reductions of the
// 20-byte candidate (Best, warp_best, slot_best) live here. fps_onchip.cu's
// head note says why each is safe.
#pragma once

#include <cuda_runtime.h>

#include "sq_dist.cuh"

constexpr unsigned kFull = 0xffffffffu;

// the exchanges, by their number in the C interfaces (ops/fps.py
// EXCHANGES)
enum Exchange : int {
  kAuto = 0,
  kLocal = 1,
  kBarrier = 2,
  kMailbox = 3,     // every warp pushes
  kMailboxCta = 4,  // one push per CTA
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// this CTA's shared address a in the shared memory of CTA rank
__device__ __forceinline__ unsigned peer(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// (value, index, x, y) to a peer's head slot and z to its tail slot, each
// completing its bytes on the peer's barrier
__device__ __forceinline__ void push_async(unsigned head, unsigned tail,
                                           unsigned bar, uint4 h, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(head),
      "r"(h.x), "r"(h.y), "r"(h.z), "r"(h.w), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(tail),
      "r"(__float_as_uint(z)), "r"(bar)
      : "memory");
}

// A mailbox candidate: value (distance bits + 1, 0 for none), index and
// coordinates.
struct Best {
  unsigned v;
  unsigned i;
  float x, y, z;
  __device__ uint4 head() const {
    return make_uint4(v, i, __float_as_uint(x), __float_as_uint(y));
  }
};

// The warp's best candidate, in every lane: the lowest lane of the
// largest value (lanes are in index order).
__device__ __forceinline__ Best warp_best(const Best& c) {
  const unsigned top = __reduce_max_sync(kFull, c.v);
  const int h = __ffs(__ballot_sync(kFull, c.v == top)) - 1;
  return Best{top, __shfl_sync(kFull, c.i, h), __shfl_sync(kFull, c.x, h),
              __shfl_sync(kFull, c.y, h), __shfl_sync(kFull, c.z, h)};
}

// The best of slots [0, count) of a buffer (slots in index order), in
// every lane: each lane scans consecutive slots, keeping its first
// largest value, so the lowest lane of the largest value holds the
// lowest slot.
__device__ __forceinline__ Best slot_best(const uint4* head,
                                          const float* tail, int count) {
  const int lane = threadIdx.x & 31;
  const int per = (count + 31) >> 5;
  unsigned bv = 0;
  int bs = 0;
  for (int k = 0; k < per; ++k) {
    const int s = lane * per + k;
    if (s < count) {
      const unsigned v = head[s].x;
      if (v > bv) {
        bv = v;
        bs = s;
      }
    }
  }
  const unsigned top = __reduce_max_sync(kFull, bv);
  const int h = __ffs(__ballot_sync(kFull, bv == top)) - 1;
  const int s = __shfl_sync(kFull, bs, h);
  const uint4 w = head[s];
  return Best{w.x, w.y, __uint_as_float(w.z), __uint_as_float(w.w), tail[s]};
}

// Words of shared memory per thread for P points: P/4 groups of
// (x[4], y[4], z[4]), padded to an odd number of 16-byte units.
__host__ __device__ constexpr int stride_words(int p) {
  return (3 * p / 4) % 2 == 1 ? 3 * p : 3 * p + 4;
}

// Stage a slice of count points (3 * count floats at src, read
// coalesced) into the groups: thread tid owns points [tid * P, tid * P +
// P) of the slice, at coords + tid * stride_words(P).
template <int P>
__device__ __forceinline__ void stage_slice(float* coords, const float* src,
                                            int count, int tid,
                                            int nthreads) {
  constexpr int S = stride_words(P);
  for (int e = tid; e < 3 * count; e += nthreads) {
    const int j = e / 3;
    const int c = e - 3 * j;
    const int owner = j / P;
    const int t = j - owner * P;
    coords[owner * S + (t >> 2) * 12 + c * 4 + (t & 3)] = src[e];
  }
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
