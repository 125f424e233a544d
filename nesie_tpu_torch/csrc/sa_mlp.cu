// Eval-mode set abstraction MLP for Hopper (sm_90a): the neighbour gather,
// three Linear + BatchNorm + ReLU layers and the max over the neighbours of
// a PointSAModule in one kernel, with no intermediate in device memory.
//
// Replaces no TPU kernel: the JAX package leaves the SA modules' shared MLP
// (nesie_tpu/nn/pointnet2.py, PointMLP) to XLA. The torch path it stands in
// for gathers (B, M, K, C) tensors and concatenates them, then runs each
// layer as a Linear, an eval BatchNorm pass and a ReLU pass over the full
// (B*M*K, C) activation in device memory, then reads the last one again
// for the max over K: about 49 GB of traffic a B=32 eval forward.
//
// Semantics (ops/sa_mlp.py::sa_mlp_ref): for each centre (b, m) and
// neighbour j of the ball query's idx (B, M, K), the input row is
// [(xyz[b, idx] - new_xyz[b, m]) * (1 / radius), features[b, idx]]
// (without the factor when normalize is 0); each layer is
// relu(bn(row @ W^T)) with the BN's running statistics; the output
// (B, M, C3) is the max over the K rows of the third layer.
//
// Rounding, written as PyTorch's CUDA ops round:
// - the offsets as two ops, a difference and a product with the float
//   reciprocal of the radius (PyTorch divides by a host scalar so);
// - each Linear output as one chain of FMAs over the input channels in
//   order from 0, the order of cuBLAS's SIMT float32 GEMM, which it
//   matches in all but a few outputs in a million;
// - BatchNorm as ATen's channels-last eval kernel:
//   fma(gamma * (x - mean), rsqrtf(var + eps), beta);
// - ReLU and the max propagate NaN as clamp_min and amax do.
// So the torch path and the kernel differ where cuBLAS sums otherwise.
//
// What bounds it on the H100: float32 FFMA, TF32 being off. The five calls
// of a B=32 eval forward (SA1-SA4 and the vote aggregation) are ~325 GFLOP,
// 4.86 ms at 66.9 TFLOP/s; their bytes (idx, the gathered rows, most of
// them L2 hits, the weights and the pooled output) take well under 1 ms.
//
// The design: a CTA of 256 threads owns a tile of 16 * RPT grouped rows
// that holds whole neighbourhoods (K divides the tile and RPT divides K),
// and runs all three layers on it in shared memory. A thread owns RPT
// consecutive rows (one neighbourhood's) and 4 or 8 output columns, and
// keeps their sums in registers (a register-blocked outer product).
// - Layer 1 streams its input in chunks of up to 36 channels through a
//   double-buffered ring: the offsets are computed into the first chunk,
//   the features are gathered straight from idx with cp.async (16 bytes a
//   copy where the rows allow, else 4). W1's rows, whose width c + 3 no
//   16-byte copy can follow, are first padded (pad_w1_kernel, one small
//   launch a call, from the raw weight) into the input's order: the
//   offsets, a zero, the features, zeros. So each chunk of W1 is 16-byte
//   copies beside its input chunk ([row][channel] and [column][channel],
//   rows of 36 floats: per 4 channels, RPT + 8 16-byte shared loads feed
//   32 RPT FFMAs).
// - Layers 1 and 2 write relu(bn(sums)) transposed, one row a channel,
//   into one shared buffer (layer 2 in place, after a barrier), so no
//   activation leaves the SM. Layers 2 and 3 read it per channel as
//   float4s of rows and their weights as transposed [channel][column]
//   chunks, loaded a chunk ahead into registers (two lanes a 32-byte
//   sector) and stored transposed while the previous chunk is multiplied:
//   per channel, RPT / 4 + 2 16-byte loads feed 8 RPT FFMAs, with one
//   barrier a chunk. All CTAs read the same weights from L2.
// - Layer 3 runs in passes of 128 columns; each pass's rows are reduced to
//   their max in registers, then across the neighbourhood's threads
//   through shared memory, and only (centres x 128) is stored.
// A tile of 128 rows (RPT 8) takes ~112 KB of shared memory, so two CTAs
// share an SM. Batches whose grid would not fill the card (a B=1 request's
// SA3, SA4 and aggregation) take 64- or 32-row tiles (RPT 4, 2).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups (ty) x 16 column lanes (tx)
constexpr int kChunk = 32;     // input channels of a layer-2/3 chunk
constexpr int kLd = 36;        // floats a row of a layer-1 slot (its
                               // first chunk holds 36 channels)
constexpr int kWidth = 128;    // widest layer-1/2 output; a layer-3 pass
constexpr int kLdW = kWidth + 4;     // a transposed weight chunk's row
constexpr int kRing = kWidth * kLd;  // floats of one weight slot (layer 1's
                                     // [col][k] or a [k][col] chunk)
constexpr int kPool = 16 * kWidth;   // per-(ty, column) partial maxima
constexpr int kCentreFloats = 64;    // the tile's centres (<= 16 x 3)

struct Layer {
  const float* w;  // (cout, cin) row-major
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
};

struct Params {
  const float* xyz;      // point p of row b at b * xsb + p * xsn
  const float* new_xyz;  // (B, M, 3) contiguous
  const float* feats;    // point p of row b at b * fsb + p * fsn, or null
  const int* idx;        // (B, M, K) contiguous
  float* out;            // (B, M, c3) contiguous
  long long xsb, xsn, fsb, fsn;
  long long rows;  // B * M * K
  int m, k, c;     // centres a row, neighbours, feature channels
  int c1, c2, c3;
  float inv_radius;
  int normalize;
  float* w1p;  // (c1, cinp): W1 in layer 1's input order (pad_w1_kernel)
  Layer layer[3];
};

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ReLU and max as clamp_min and amax: a NaN wins
__device__ __forceinline__ float relu_nan(float y) {
  return (y > 0.0f || y != y) ? y : 0.0f;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a >= b || a != a) ? a : b;
}

// Layer 1's input quads (4 channels each): quad 0 the offsets and a zero,
// quads 1.. the features, zero-padded to a multiple of 4. Chunk 0 holds
// quads [0, 9), chunk ch >= 1 quads [8 ch + 1, 8 ch + 9).
__device__ __forceinline__ int chunk_first_quad(int ch) {
  return ch == 0 ? 0 : 8 * ch + 1;
}

// Start copying layer 1's feature quads of chunk ch into slot a (rows x
// kLd) and W1's matching columns into slot w (c1 x kLd).
template <bool kVec>
__device__ __forceinline__ void stage_layer1(const Params& p, float* a,
                                             float* w, int ch, int nq,
                                             int rows,
                                             const long long* foff) {
  const int nfq = (p.c + 3) / 4;  // feature quads
  for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
    const int r = i >> 3;
    const int f = 8 * ch + (i & 7);  // feature quad
    if (f >= nfq) continue;
    float* dst = a + r * kLd + 4 * (f - chunk_first_quad(ch) + 1);
    const long long off = foff[r];
    if (kVec) {
      const float* src = off >= 0 ? p.feats + off + 4 * f : p.feats;
      copy16(dst, src, off >= 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = off >= 0 && 4 * f + e < p.c;
        copy4(dst + e, live ? p.feats + off + 4 * f + e : p.xyz,
              live ? 4 : 0);
      }
    }
  }
  // W1's padded rows, quads [first, first + nq) of each column
  const int first = chunk_first_quad(ch);
  const int cinp = 4 * (1 + (p.c + 3) / 4);
  for (int i = threadIdx.x; i < p.c1 * 9; i += kThreads) {
    const int col = i / 9;
    const int q = i - 9 * col;
    if (q < nq) {
      copy16(w + col * kLd + 4 * q,
             p.w1p + static_cast<long long>(col) * cinp + 4 * (first + q),
             16);
    }
  }
}

// W1 (c1, c + 3) into wp (c1, cinp), cinp = 4 (1 + ceil(c / 4)), in the
// order of layer 1's input: the offsets, a zero, the features, zeros
__global__ void pad_w1_kernel(const float* w, float* wp, int c1, int c,
                              int cinp) {
  const int n = c1 * cinp;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int col = i / cinp;
    const int kp = i - col * cinp;
    const int src = kp < 3 ? kp : (kp >= 4 && kp - 4 < c ? kp - 1 : -1);
    wp[i] = src >= 0 ? w[static_cast<long long>(col) * (c + 3) + src] : 0.0f;
  }
}

// acc[i][j] += sum over 4 channels at a[row r0 + i][4 kq ...] and
// w[column tx + 16 j][4 kq ...], one FMA a channel, channels in order.
template <int RPT, int NC>
__device__ __forceinline__ void mma_quad(float (&acc)[RPT][NC],
                                         const float* a, int lda,
                                         const float* w, int kq, int r0,
                                         int tx) {
  float4 av[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    av[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * lda + 4 * kq);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float4 wv =
        *reinterpret_cast<const float4*>(w + (tx + 16 * j) * kLd + 4 * kq);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      acc[i][j] = __fmaf_rn(av[i].x, wv.x, acc[i][j]);
      acc[i][j] = __fmaf_rn(av[i].y, wv.y, acc[i][j]);
      acc[i][j] = __fmaf_rn(av[i].z, wv.z, acc[i][j]);
      acc[i][j] = __fmaf_rn(av[i].w, wv.w, acc[i][j]);
    }
  }
}

template <int RPT, int NC>
__device__ __forceinline__ void zero(float (&acc)[RPT][NC]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }
}

// The BN of one column as ATen's eval kernel computes it.
struct Bn {
  float gamma, beta, mean, inv;
  __device__ __forceinline__ float operator()(float x) const {
    return __fmaf_rn(__fmul_rn(gamma, __fsub_rn(x, mean)), inv, beta);
  }
};

__device__ __forceinline__ Bn column_bn(const Layer& l, int col) {
  return Bn{l.gamma[col], l.beta[col], l.mean[col],
            rsqrtf(__fadd_rn(l.var[col], l.eps))};
}

// Columns [col0, col0 + ncols) x input channels [32 ch, 32 ch + 32) of
// a (cout, cin) weight, as float4s of 4 channels: item i of this thread
// is column (i / 2) % ncols, quad 2 ((i / 2) / ncols) + i % 2, so two
// lanes read one 32-byte sector and the transposed stores of a warp fall
// on 32 banks.
template <int NCOLS>
__device__ __forceinline__ void load_weights(float4 (&v)[NCOLS / 32],
                                             const float* weight, int cin,
                                             int col0, int ch) {
#pragma unroll
  for (int s = 0; s < NCOLS / 32; ++s) {
    const int i = threadIdx.x + kThreads * s;
    const int c = (i >> 1) % NCOLS;
    const int q = 2 * ((i >> 1) / NCOLS) + (i & 1);
    v[s] = __ldg(reinterpret_cast<const float4*>(
        weight + static_cast<long long>(col0 + c) * cin + kChunk * ch +
        4 * q));
  }
}

// The loaded chunk into slot w as [k][column] (rows of kLdW floats)
template <int NCOLS>
__device__ __forceinline__ void store_weights(const float4 (&v)[NCOLS / 32],
                                              float* w) {
#pragma unroll
  for (int s = 0; s < NCOLS / 32; ++s) {
    const int i = threadIdx.x + kThreads * s;
    const int c = (i >> 1) % NCOLS;
    const int q = 2 * ((i >> 1) / NCOLS) + (i & 1);
    w[(4 * q + 0) * kLdW + c] = v[s].x;
    w[(4 * q + 1) * kLdW + c] = v[s].y;
    w[(4 * q + 2) * kLdW + c] = v[s].z;
    w[(4 * q + 3) * kLdW + c] = v[s].w;
  }
}

// Column of sum j of a thread in the transposed product: 4 tx + j, then
// 64 + 4 tx + j - 4
__device__ __forceinline__ int t_col(int tx, int j) {
  return (j < 4 ? 0 : 60) + 4 * tx + j;
}

// acc[i][j] += the 32 channels of a chunk: rows r0 + i of ht ([k][row],
// rows of ldt floats, from channel k0) times columns t_col(tx, j) of w
// ([k][column]), one FMA a channel, channels in order.
template <int RPT, int NC>
__device__ __forceinline__ void mma_chunk_t(float (&acc)[RPT][NC],
                                            const float* ht, int ldt,
                                            int k0, const float* w, int r0,
                                            int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kChunk; ++kk) {
    float a[RPT];
    const float* ar = ht + (k0 + kk) * ldt + r0;
    if constexpr (RPT >= 4) {
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(ar + i);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
    } else {
      const float2 v = *reinterpret_cast<const float2*>(ar);
      a[0] = v.x;
      a[RPT - 1] = v.y;
    }
    float b[NC];
#pragma unroll
    for (int j = 0; j < NC; j += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(w + kk * kLdW + t_col(tx, j));
      b[j] = v.x;
      b[j + 1] = v.y;
      b[j + 2] = v.z;
      b[j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
    }
  }
}

// relu(bn(acc)) of column col(j) into ht[col][r0 ...]
template <int RPT, int NC, typename Col>
__device__ __forceinline__ void store_t(const float (&acc)[RPT][NC],
                                        const Layer& l, float* ht, int ldt,
                                        int r0, Col col) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = col(j);
    const Bn bn = column_bn(l, c);
    float v[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) v[i] = relu_nan(bn(acc[i][j]));
    float* dst = ht + c * ldt + r0;
    if constexpr (RPT >= 4) {
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[RPT - 1]);
    }
  }
}

template <int RPT, int NC1, int NC2, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    sa_mlp_kernel(const Params p) {
  constexpr int kRows = 16 * RPT;
  constexpr int kLdT = kRows + 4;  // a row of ht: one channel, every row
  extern __shared__ float4 smem4[];
  float* ht = reinterpret_cast<float*>(smem4);  // kWidth x kLdT
  float* ring = ht + kWidth * kLdT;             // 2 weight slots
  float* pool = ring + 2 * kRing;
  float* centre = pool + kPool;
  long long* foff = reinterpret_cast<long long*>(centre + kCentreFloats);
  long long* xoff = foff + kRows;
  float* a_ring = ht;  // layer 1's input slots, each kRows x kLd, in ht

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;  // a warp holds two row groups
  const int r0 = ty * RPT;
  const int k = p.k;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long centre0 = row0 / k;
  const long long centres = p.rows / k;
  const int tile_centres = kRows / k;

  if (tid < kRows) {
    const long long g = row0 + tid;
    long long fo = -1, xo = -1;
    if (g < p.rows) {
      const long long b = g / k / p.m;
      const long long pt = p.idx[g];
      xo = b * p.xsb + pt * p.xsn;
      fo = b * p.fsb + pt * p.fsn;
    }
    foff[tid] = fo;
    xoff[tid] = xo;
  }
  if (tid < 3 * tile_centres) {
    const long long c = centre0 + tid / 3;
    centre[tid] = c < centres ? p.new_xyz[3 * c + tid % 3] : 0.0f;
  }
  __syncthreads();

  // ---- layer 1: offsets and gathered features -> c1 ----
  const int nq1 = 1 + (p.c + 3) / 4;
  const int nch1 = nq1 <= 9 ? 1 : 1 + (nq1 - 9 + 7) / 8;
  auto quads = [&](int ch) {
    return min(ch == 0 ? 9 : 8, nq1 - chunk_first_quad(ch));
  };
  if (tid < kRows) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const long long xo = xoff[tid];
    if (xo >= 0) {
      const float* s = p.xyz + xo;
      const float* c = centre + 3 * (tid / k);
      v.x = __fsub_rn(s[0], c[0]);
      v.y = __fsub_rn(s[1], c[1]);
      v.z = __fsub_rn(s[2], c[2]);
      if (p.normalize) {
        v.x = __fmul_rn(v.x, p.inv_radius);
        v.y = __fmul_rn(v.y, p.inv_radius);
        v.z = __fmul_rn(v.z, p.inv_radius);
      }
    }
    *reinterpret_cast<float4*>(a_ring + tid * kLd) = v;
  }
  stage_layer1<kVec>(p, a_ring, ring, 0, quads(0), kRows, foff);
  copy_commit();
  float acc1[RPT][NC1];
  zero(acc1);
  for (int ch = 0; ch < nch1; ++ch) {
    if (ch + 1 < nch1) {
      const int s = (ch + 1) & 1;
      stage_layer1<kVec>(p, a_ring + s * kRows * kLd, ring + s * kRing,
                         ch + 1, quads(ch + 1), kRows, foff);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* a = a_ring + (ch & 1) * kRows * kLd;
    const float* w = ring + (ch & 1) * kRing;
    const int nq = quads(ch);
#pragma unroll
    for (int kq = 0; kq < 9; ++kq) {
      if (kq < nq) mma_quad<RPT, NC1>(acc1, a, kLd, w, kq, r0, tx);
    }
    __syncthreads();
  }
  // the rings are free: fetch layer 2's first chunk, store layer 1
  constexpr int kCols2 = 16 * NC2;
  float4 wv2[kCols2 / 32];
  load_weights<kCols2>(wv2, p.layer[1].w, p.c1, 0, 0);
  store_t<RPT, NC1>(acc1, p.layer[0], ht, kLdT, r0,
                    [tx](int j) { return tx + 16 * j; });
  store_weights<kCols2>(wv2, ring);
  __syncthreads();

  // ---- layer 2: c1 -> c2, in place in ht ----
  const int nch2 = p.c1 / kChunk;
  float acc2[RPT][NC2];
  zero(acc2);
  for (int ch = 0; ch < nch2; ++ch) {
    const bool more = ch + 1 < nch2;
    if (more) load_weights<kCols2>(wv2, p.layer[1].w, p.c1, 0, ch + 1);
    mma_chunk_t<RPT, NC2>(acc2, ht, kLdT, kChunk * ch,
                          ring + (ch & 1) * kRing, r0, tx);
    if (more) store_weights<kCols2>(wv2, ring + ((ch + 1) & 1) * kRing);
    __syncthreads();
  }
  float4 wv3[kWidth / 32];
  load_weights<kWidth>(wv3, p.layer[2].w, p.c2, 0, 0);
  store_t<RPT, NC2>(acc2, p.layer[1], ht, kLdT, r0,
                    [tx](int j) { return t_col(tx, j); });
  store_weights<kWidth>(wv3, ring);
  __syncthreads();

  // ---- layer 3: c2 -> c3 in passes of 128 columns, max over K ----
  const int nch3 = p.c2 / kChunk;
  const int steps = (p.c3 / kWidth) * nch3;
  float acc3[RPT][8];
  for (int t = 0; t < steps; ++t) {
    const int pass = t / nch3;
    const int ch = t - pass * nch3;
    if (ch == 0) zero(acc3);
    const bool more = t + 1 < steps;
    if (more) {
      const int next = (t + 1) / nch3;
      load_weights<kWidth>(wv3, p.layer[2].w, p.c2, next * kWidth,
                           t + 1 - next * nch3);
    }
    mma_chunk_t<RPT, 8>(acc3, ht, kLdT, kChunk * ch, ring + (t & 1) * kRing,
                        r0, tx);
    if (more) store_weights<kWidth>(wv3, ring + ((t + 1) & 1) * kRing);
    __syncthreads();
    if (ch != nch3 - 1) continue;
    // this thread's rows to their max, then the neighbourhood's
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = t_col(tx, j);
      const Bn bn = column_bn(p.layer[2], pass * kWidth + col);
      float mx = relu_nan(bn(acc3[0][j]));
#pragma unroll
      for (int i = 1; i < RPT; ++i) mx = max_nan(mx, relu_nan(bn(acc3[i][j])));
      pool[ty * kWidth + col] = mx;
    }
    __syncthreads();
    const int groups = k / RPT;
    for (int o = tid; o < tile_centres * kWidth; o += kThreads) {
      const int c = o / kWidth;
      const int col = o - c * kWidth;
      const float* part = pool + c * groups * kWidth + col;
      float mx = part[0];
      for (int g = 1; g < groups; ++g) mx = max_nan(mx, part[g * kWidth]);
      if (centre0 + c < centres) {
        p.out[(centre0 + c) * p.c3 + pass * kWidth + col] = mx;
      }
    }
    // the next pass writes pool only after its chunks' barriers
  }
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

size_t smem_bytes(int rpt) {
  const int rows = 16 * rpt;
  return 4 * static_cast<size_t>(kWidth * (rows + 4) + 2 * kRing + kPool +
                                 kCentreFloats) +
         2 * 8 * static_cast<size_t>(rows);
}

template <int RPT, int NC1, int NC2, bool kVec>
cudaError_t launch(const Params& p, cudaStream_t s) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      sa_mlp_kernel<RPT, NC1, NC2, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(RPT)));
  if (allowed != cudaSuccess) return allowed;
  const int cinp = 4 * (1 + (p.c + 3) / 4);
  pad_w1_kernel<<<(p.c1 * cinp + 255) / 256, 256, 0, s>>>(
      p.layer[0].w, p.w1p, p.c1, p.c, cinp);
  const long long tiles = (p.rows + 16 * RPT - 1) / (16 * RPT);
  sa_mlp_kernel<RPT, NC1, NC2, kVec>
      <<<static_cast<unsigned>(tiles), kThreads, smem_bytes(RPT), s>>>(p);
  return cudaGetLastError();
}

// Rows per thread for a call of `rows` grouped rows, K neighbours, hidden
// widths c1 = c2, vectorised feature rows `vec`: 8, unless the grid would
// leave SMs idle, then 4 or 2 where the instantiations and K allow.
int rows_per_thread(long long rows, int k, int c1, int vec) {
  static const int sms = device_attribute(cudaDevAttrMultiProcessorCount);
  int rpt = 8;
  if (c1 == 128 && vec) {
    while (rpt > 2 && (rows + 16 * rpt - 1) / (16 * rpt) < sms &&
           k % (rpt / 2) == 0 && (8 * rpt) % k == 0) {
      rpt /= 2;
    }
  }
  return rpt;
}

}  // namespace

// params: 15 device pointers, for each layer its weight (cout, cin), then
// the BN's gamma, beta, running mean and running var; eps: the three BNs'
// eps, on the host; w1p: a (c1, 4 (1 + ceil(c / 4))) float32 scratch that
// the call writes W1 padded into. Two launches on the stream: the padding,
// then the kernel. The caller checks every layout (ops/sa_mlp.py); a
// combination with no instantiation returns cudaErrorInvalidValue without
// launching.
extern "C" int nesie_sa_mlp(const void* xyz, long long xsb, long long xsn,
                            const void* new_xyz, const void* feats,
                            long long fsb, long long fsn, const void* idx,
                            int b, int m, int k, int c, int vec,
                            float inv_radius, int normalize,
                            int c1, int c2, int c3, const void* const* params,
                            const float* eps, void* out, void* w1p,
                            void* stream) {
  Params p;
  p.xyz = static_cast<const float*>(xyz);
  p.new_xyz = static_cast<const float*>(new_xyz);
  p.feats = static_cast<const float*>(feats);
  p.idx = static_cast<const int*>(idx);
  p.out = static_cast<float*>(out);
  p.xsb = xsb;
  p.xsn = xsn;
  p.fsb = fsb;
  p.fsn = fsn;
  p.rows = static_cast<long long>(b) * m * k;
  p.m = m;
  p.k = k;
  p.c = c;
  p.c1 = c1;
  p.c2 = c2;
  p.c3 = c3;
  p.inv_radius = inv_radius;
  p.normalize = normalize;
  p.w1p = static_cast<float*>(w1p);
  const float* const* f = reinterpret_cast<const float* const*>(params);
  for (int l = 0; l < 3; ++l) {
    p.layer[l] = Layer{f[5 * l], f[5 * l + 1], f[5 * l + 2], f[5 * l + 3],
                       f[5 * l + 4], eps[l]};
  }
  if (p.rows == 0) return 0;
  if (c == 0) {
    p.feats = p.xyz;  // never read: no feature quad exists
    vec = 0;
  }
  const int rpt = rows_per_thread(p.rows, k, c1, vec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 != c2 || c3 % kWidth != 0 || k % rpt != 0 || (16 * rpt) % k != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c1 == 128) {
    if (vec) {
      if (rpt == 2) return static_cast<int>(launch<2, 8, 8, true>(p, s));
      if (rpt == 4) return static_cast<int>(launch<4, 8, 8, true>(p, s));
      return static_cast<int>(launch<8, 8, 8, true>(p, s));
    }
    return static_cast<int>(launch<8, 8, 8, false>(p, s));
  }
  if (c1 == 64) {
    if (vec) return static_cast<int>(launch<8, 4, 4, true>(p, s));
    return static_cast<int>(launch<8, 4, 4, false>(p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
