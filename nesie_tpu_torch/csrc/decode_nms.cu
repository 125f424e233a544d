// The eval decode's keep mask for Hopper (sm_90a): the points inside each
// proposal, then class-aware greedy NMS, for a batch of scenes.
//
// Replaces: no TPU kernel. The JAX package decodes in XLA
// (nesie_tpu/eval/postprocess.py, a vmap of the same math); the port's
// plain version (ops/decode_nms.py::keep_mask_ref) loops over the scenes
// and its NMS fixpoint asks the host after every round whether it has
// converged, so a B=32 batch waited on the host ~400 times.
//
// Semantics, bit for bit those of keep_mask_ref on the card: the count
// kernel counts, for every box, the points of its scene inside it by
// core.boxes.points_in_boxes(bottom_center=False): d = p - centre,
// local_x = c*dx - s*dy, local_y = s*dx + c*dy, |local_x| < sx/2 and
// |local_y| < sy/2 (exclusive), |dz| <= sz/2 (inclusive). The keep kernel
// keeps box j iff it holds more than `nonempty` points (5 on the eval
// path) and no kept box of the same class that comes before it in (score
// descending, index ascending) order has IoU > nms_thr with it (core.nms.aligned_3d_nms_mask; the greedy loop
// is the fixpoint that greedy_keep_fixpoint iterates to), and selects it
// iff it is kept and its score > score_thr. Every product, sum,
// difference and quotient that PyTorch rounds as an op of its own is
// written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc
// cannot contract it into an FMA, which would round otherwise and could
// move a point across a face or an IoU across the threshold. The cos and
// sin of the yaw and the boxes' axis-aligned minmax come from PyTorch.
//
// What bounds it on the H100: instruction slots. A point-in-box test is
// ~14 operations; a B=32 batch of 40000 points and 256 boxes is 328M
// tests, ~0.14 ms at 128 lanes an SM on 132 SMs. The NMS is 32 x 256^2 / 2
// IoUs, under 1% of that; its bytes are a few hundred KB.
//
// The design. The count kernel: a grid of (point tiles, scenes); a block
// stages its scene's boxes in shared memory (centre, cos, sin and the
// half sizes as two float4, read as broadcasts), holds PT points a thread
// in registers and walks the boxes; each warp counts a box's hits with a
// ballot and __popc into a shared tally, and the block adds its tally to
// the global count with one atomic a box. The plan takes PT in {4, 2, 1},
// the largest that still gives every SM kMinCtasPerSm blocks, so a B=1
// request spreads over the card as a B=32 batch does. The keep kernel: one
// block a scene (P <= 1024). It sorts (score, index) keys with a bitonic
// sort in shared memory (a float key that orders by value: -0 and +0 are
// one key, so they keep index order, and NaN sorts last, as
// torch.argsort(-scores, stable=True) does), lays the boxes out in that
// order, builds the suppression bitmask of the boxes that may be kept (a
// warp a 32-box word: one IoU a lane and a ballot; bit (i, j) for j later
// than i), and then one warp runs the greedy scan: lane l holds word l of
// the removed set, a kept box ORs its row into it.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 1024;
constexpr int kCountThreads = 256;
constexpr int kKeepThreads = 512;
constexpr int kMinCtasPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;

// a: (cx, cy, cz, cos), b: (sin, sx/2, sy/2, sz/2)
__device__ __forceinline__ bool inside(float px, float py, float pz,
                                       float4 a, float4 b) {
  const float dx = __fsub_rn(px, a.x);
  const float dy = __fsub_rn(py, a.y);
  const float dz = __fsub_rn(pz, a.z);
  const float lx = __fsub_rn(__fmul_rn(a.w, dx), __fmul_rn(b.x, dy));
  const float ly = __fadd_rn(__fmul_rn(b.x, dx), __fmul_rn(a.w, dy));
  return fabsf(lx) < b.y && fabsf(ly) < b.z && fabsf(dz) <= b.w;
}

template <int PT>
__global__ void __launch_bounds__(kCountThreads)
decode_nms_count_kernel(const float* __restrict__ points, int n,
                        int channels, const float* __restrict__ bbox,
                        const float* __restrict__ cosv,
                        const float* __restrict__ sinv, int p,
                        int* __restrict__ counts) {
  extern __shared__ float4 frames[];  // 2 p float4, then p int tallies
  int* tally = reinterpret_cast<int*>(frames + 2 * p);
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * p;
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    const float* box = bbox + (row + k) * 7;
    frames[2 * k] = make_float4(box[0], box[1], box[2], cosv[row + k]);
    frames[2 * k + 1] =
        make_float4(sinv[row + k], __fmul_rn(0.5f, box[3]),
                    __fmul_rn(0.5f, box[4]), __fmul_rn(0.5f, box[5]));
    tally[k] = 0;
  }
  float px[PT], py[PT], pz[PT];
  bool real[PT];
  const int base = blockIdx.x * blockDim.x * PT + threadIdx.x;
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int i = base + r * blockDim.x;
    real[r] = i < n;
    const float* q =
        points + (static_cast<size_t>(b) * n + (real[r] ? i : 0)) * channels;
    px[r] = q[0];
    py[r] = q[1];
    pz[r] = q[2];
  }
  __syncthreads();
  const bool lead = (threadIdx.x & 31) == 0;
  for (int k = 0; k < p; ++k) {
    const float4 fa = frames[2 * k];
    const float4 fb = frames[2 * k + 1];
    int hits = 0;
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      hits += __popc(
          __ballot_sync(kFull, real[r] && inside(px[r], py[r], pz[r], fa, fb)));
    }
    if (lead && hits) atomicAdd(&tally[k], hits);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    if (tally[k]) atomicAdd(&counts[row + k], tally[k]);
  }
}

// torch.maximum / torch.minimum / torch.clamp(min=): a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x || x >= lo) ? x : lo;
}

// Ascending in this key is descending in the score; -0 and +0 share one
// key and NaN comes last.
__device__ __forceinline__ uint32_t score_key(float s) {
  if (s != s) return 0xffffffffu;
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;  // -0 -> +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in s
  return ~u;
}

struct Sorted {  // the scene's boxes in score order, in shared memory
  unsigned long long* keys;  // pow2 >= p
  long long* cls;
  float* lo[3];
  float* hi[3];
  float* vol;
  int* order;  // sorted position -> box index
  uint32_t* mask;  // p rows of `words` words of 32 boxes
  unsigned char* live;  // non-empty
  unsigned char* kept;
};

__device__ __forceinline__ Sorted carve(void* smem, int p, int pp, int words) {
  Sorted s;
  char* at = static_cast<char*>(smem);
  s.keys = reinterpret_cast<unsigned long long*>(at);
  at += sizeof(unsigned long long) * pp;
  s.cls = reinterpret_cast<long long*>(at);
  at += sizeof(long long) * p;
  float* f = reinterpret_cast<float*>(at);
  for (int c = 0; c < 3; ++c) s.lo[c] = f + c * p;
  for (int c = 0; c < 3; ++c) s.hi[c] = f + (3 + c) * p;
  s.vol = f + 6 * p;
  s.order = reinterpret_cast<int*>(f + 7 * p);
  s.mask = reinterpret_cast<uint32_t*>(s.order + p);
  s.live = reinterpret_cast<unsigned char*>(
      s.mask + static_cast<size_t>(p) * words);
  s.kept = s.live + p;
  return s;
}

size_t keep_smem(int p, int pp, int words) {
  return sizeof(unsigned long long) * pp + sizeof(long long) * p +
         sizeof(float) * 7 * p + sizeof(int) * p +
         sizeof(uint32_t) * static_cast<size_t>(p) * words + 2 * p;
}

// IoU of the minmax boxes at sorted positions i and j, in
// core.nms._aligned_iou_matrix's order of operations
__device__ __forceinline__ float iou(const Sorted& s, int i, int j) {
  float e[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lt = max_nan(s.lo[c][i], s.lo[c][j]);
    const float rb = min_nan(s.hi[c][i], s.hi[c][j]);
    e[c] = clamp_min(__fsub_rn(rb, lt), 0.0f);
  }
  const float inter = __fmul_rn(__fmul_rn(e[0], e[1]), e[2]);
  const float uni = __fsub_rn(__fadd_rn(s.vol[i], s.vol[j]), inter);
  return __fdiv_rn(inter, clamp_min(uni, 1e-12f));
}

__global__ void __launch_bounds__(kKeepThreads)
decode_nms_keep_kernel(const float* __restrict__ minmax,
                       const float* __restrict__ obj,
                       const long long* __restrict__ classes,
                       const int* __restrict__ counts, int p, int pp,
                       int nonempty, float nms_thr, float score_thr,
                       unsigned char* __restrict__ selected) {
  extern __shared__ unsigned long long smem[];
  const int words = (p + 31) >> 5;
  const Sorted s = carve(smem, p, pp, words);
  const size_t row = static_cast<size_t>(blockIdx.x) * p;
  const int tid = threadIdx.x;

  for (int i = tid; i < pp; i += blockDim.x) {
    const unsigned long long key =
        i < p ? score_key(obj[row + i]) : 0xffffffffu;
    s.keys[i] = i < p ? (key << 32) | static_cast<unsigned>(i) : ~0ull;
  }
  __syncthreads();
  for (int k = 2; k <= pp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < pp; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s.keys[i];
          const unsigned long long c = s.keys[ixj];
          if ((a > c) == ((i & k) == 0)) {
            s.keys[i] = c;
            s.keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int q = tid; q < p; q += blockDim.x) {
    const int o = static_cast<int>(s.keys[q] & 0xffffffffu);
    const float* m = minmax + (row + o) * 6;
    float d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.lo[c][q] = m[c];
      s.hi[c][q] = m[3 + c];
      d[c] = __fsub_rn(m[3 + c], m[c]);
    }
    s.vol[q] = __fmul_rn(__fmul_rn(d[0], d[1]), d[2]);
    s.cls[q] = classes[row + o];
    s.order[q] = o;
    s.live[q] = counts[row + o] > nonempty;
  }
  __syncthreads();

  // row i of the mask: the later boxes that box i suppresses if kept. A
  // box that is empty is never kept, so its row is never read; nor are the
  // words before row i's own, which hold no later box.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int t = warp; t < p * words; t += blockDim.x >> 5) {
    const int i = t / words;
    const int w = t - i * words;
    if (!s.live[i] || w < (i >> 5)) continue;  // uniform across the warp
    const int j = (w << 5) + lane;
    bool hit = false;
    if (j > i && j < p) {
      const float v = iou(s, i, j);
      // the plain version's iou * (same class), then > thr
      hit = (s.cls[i] == s.cls[j] ? v : __fmul_rn(v, 0.0f)) > nms_thr;
    }
    const uint32_t bits = __ballot_sync(kFull, hit);
    if (lane == 0) s.mask[static_cast<size_t>(i) * words + w] = bits;
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t removed = 0;  // word `lane` of the removed set
    for (int i = 0; i < p; ++i) {
      const uint32_t word = __shfl_sync(kFull, removed, i >> 5);
      const bool keep = s.live[i] && !((word >> (i & 31)) & 1u);
      if (keep && lane >= (i >> 5) && lane < words) {
        removed |= s.mask[static_cast<size_t>(i) * words + lane];
      }
      if (lane == 0) s.kept[i] = keep;
    }
  }
  __syncthreads();
  for (int q = tid; q < p; q += blockDim.x) {
    const int o = s.order[q];
    selected[row + o] = s.kept[q] && obj[row + o] > score_thr;
  }
}

using CountKernel = void (*)(const float*, int, int, const float*,
                             const float*, const float*, int, int*);

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

// Points a thread: the largest of 4, 2, 1 whose grid still gives every SM
// kMinCtasPerSm blocks.
int points_per_thread(int b, int n) {
  const long long want = static_cast<long long>(kMinCtasPerSm) *
                         multiprocessors();
  for (int pt = 4; pt > 1; pt >>= 1) {
    const long long tiles = (n + kCountThreads * pt - 1) / (kCountThreads * pt);
    if (tiles * b >= want) return pt;
  }
  return 1;
}

}  // namespace

// Points inside each box: counts (b, p) int32, zeroed here, then
// accumulated. points (b, n, channels) with x, y, z first; bbox (b, p, 7);
// cosv, sinv (b, p): the cos and sin of the yaw.
extern "C" int nesie_decode_nms_counts(const void* points, int b, int n,
                                       int channels, const void* bbox,
                                       const void* cosv, const void* sinv,
                                       int p, void* counts, void* stream) {
  if (b <= 0 || p <= 0 || p > kMaxBoxes || channels < 3 || n < 0 ||
      b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * b * p, st);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const int pt = points_per_thread(b, n);
  const CountKernel fn = pt == 4   ? decode_nms_count_kernel<4>
                         : pt == 2 ? decode_nms_count_kernel<2>
                                   : decode_nms_count_kernel<1>;
  const dim3 grid((n + kCountThreads * pt - 1) / (kCountThreads * pt), b);
  const size_t smem = 2 * sizeof(float4) * p + sizeof(int) * p;
  fn<<<grid, kCountThreads, smem, st>>>(
      static_cast<const float*>(points), n, channels,
      static_cast<const float*>(bbox), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), p, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The keep mask: selected (b, p) bool from minmax (b, p, 6), obj (b, p)
// scores, classes (b, p) int64 and nesie_decode_nms_counts's counts (a box
// with more than `nonempty` points may be kept).
extern "C" int nesie_decode_nms_keep(const void* minmax, const void* obj,
                                     const void* classes, const void* counts,
                                     int b, int p, int nonempty,
                                     float nms_thr, float score_thr,
                                     void* selected, void* stream) {
  if (b <= 0 || p <= 0 || p > kMaxBoxes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int pp = 1;
  while (pp < p) pp <<= 1;
  const size_t smem = keep_smem(p, pp, (p + 31) >> 5);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_nms_keep_kernel<<<b, kKeepThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(minmax), static_cast<const float*>(obj),
      static_cast<const long long*>(classes), static_cast<const int*>(counts),
      p, pp, nonempty, nms_thr, score_thr,
      static_cast<unsigned char*>(selected));
  return static_cast<int>(cudaGetLastError());
}
