// The fused FFN kernels of the PyTorch port, hand-written for Hopper (sm_90a):
// #3 (FFN), #4 (FFN block) and #5 (dense block), each a forward and a backward.
//
// Replaces the Pallas TPU kernels of univl_tpu/kernels/ffn.py:
//   #3 fused_ffn:          _ffn_fwd_kernel / _ffn_fwd_save_kernel, _ffn_bwd_kernel
//   #4 fused_ffn_block:    _ffn_block_fwd_kernel, _ffn_block_bwd_kernel
//   #5 fused_dense_block:  _dense_block_fwd_kernel, _dense_block_bwd_kernel
// and computes what they compute at their rounding points (round: to the
// input type T; every product summed in f32):
//   #3 fwd  pre = round(round(x W1) + b1), h = round(gelu(pre)),
//           y = round(round(h W2) + b2); the save variant also writes pre
//   #3 bwd  h = round(gelu(pre)), dpre = round((g W2^T) * gelu'(pre)),
//           dx = round(dpre W1^T)
//   #4 fwd  #3's y, y = keep ? round(y / (1 - rate)) : 0, s = round(y + x),
//           out = round(LN(s)) with TF LayerNorm (f32 stats, eps inside the
//           rsqrt); saves pre and s
//   #4 bwd  ds = LN backward (f32), dffn = round(keep ? ds / (1 - rate) : 0),
//           #3's backward on dffn, dx = round(ds + dpre W1^T), and each
//           block's column sums of g and g * xhat (the dbias, dscale partials)
//   #5 fwd  y = round(round(x W) + b), dropped, s = round(y + r), out = round(LN(s))
//   #5 bwd  ds, dy = round(keep ? ds / (1 - rate) : 0), dr = round(ds),
//           dx = round(dy W^T), and the partials
// The weight and bias gradients and the partials' final sums are left to
// plain PyTorch, as the TPU kernels leave them to XLA (ffn.py:238-250,
// 486-498, 705-712). The f32 kernels use erff, the bf16 ones the TPU
// kernels' A&S 7.1.26 erf polynomial (|err| <= 1.5e-7). The forwards take
// their weights as nn.Linear stores them ([out, in]: W1^T, W2^T, W^T), the
// backwards in the JAX layout ([in, out]): either way a product's B operand
// is read along its depth, in 16-byte rows.
//
// Dropout bits: counter-based Philox4x32-10 (philox.cuh). Element (row, col)
// is kept where word col % 4 of Philox(counter = (col / 4, row, tag, 0), key =
// seed) is at least rate * 2^32, tag 4 for #4 and 5 for #5. The mask is a pure
// function of the element, so the forward, the backward and the plain version
// (univl_tpu_torch/kernels/ffn.py) drop the same entries. The TPU kernels'
// bits cannot be reproduced; the distribution is the same.
//
// What bounds it: at FT-Align's cross tower (98,304 rows, H 768, F 3072) #3
// and #4 do 4 N H F = 0.93 TFLOP a call over ~0.9 GB (and the [N, F] pre, h
// and dpre the function writes): far above the H100's ridge, so operations
// bound them (0.94 ms at the bf16 tensor-core peak). #5 does 2 N H^2 = 0.12
// TFLOP over the ~0.6 GB of its [N, H] inputs and outputs: bytes bound it
// (0.18 ms forward, 0.23 backward, at 3.35 TB/s).
//
// What the design does about it. In bf16, #3 and #4 are two GEMMs on
// Hopper's wgmma and TMA, through device memory where the function already
// writes: x W1 (epilogue: bias, pre, h = gelu(pre)) and h W2 (bias, y) in
// the forward, (dffn or g) W2^T (dpre = . * gelu'(pre), h) and dpre W1^T
// (dx, + ds for #4) in the backward; row kernels do #4's dropout, residual
// and LayerNorm (forward and backward) and add F splits. A GEMM tile of 128
// x 256 reads each staged weight byte for 128 rows (a 32-row block of the
// first version restaged all of W1 and W2: 29 GB of L2 traffic a call). A
// persistent block a SM: one producer warpgroup keeps TMA loads in flight
// into a ring of three 48 KB stages, two consumer warpgroups run wgmma
// m64n256k16 (128 f32 accumulators a thread), and each epilogue writes its
// bf16 outputs through swizzled staging buffers to TMA stores, its inputs
// (pre; #4's s and g) prefetched by TMA while the products run. At a
// tower's 1,536 rows h W2 and dpre W1^T split F until every SM has a tile
// (ffn_plan in kernels/ffn.py); the splits' f32 sums are added in split
// order, so every output is bitwise the same from call to call. The bf16
// GELU is the TPU kernels' erf polynomial (one exp, one reciprocal for gelu
// and gelu'). A fused alternative (one kernel a direction, the [64, 768]
// output in registers, W1 and W2 restaged per 64 rows) took 2.6x this
// route's time on #3's forward (PERF.md). #5 in bf16 is the same GEMM
// under names of its own: x W with the bias epilogue, then a row kernel
// (dropout with #5's tag, the residual r, the LayerNorm) in the forward; a
// LayerNorm head (dy, dr, the partials), then dy W^T in the backward. Its
// depth H is not split: at a tower's 1,536 rows (36 tiles) a 3-way split
// saved ~1 us of GEMM and cost a ~5 us row kernel to add the splits
// (PERF.md). A block of the first version owned 32 rows
// and restaged all of W (1.2 MB) for them: 3.6 GB of L2 traffic a call at
// 98,304 rows.
// In f32 (the agreement runs) #3, #4 and #5 run on CUDA cores, 4 rows x 24
// columns a thread over staged f32 tiles. The kernels take H = 768 and F a
// multiple of 256.

#include <cuda_bf16.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"
#include "philox.cuh"
#include "wgmma.cuh"

namespace {

using univl::Dropout;
using univl::pack_bf16;
using univl::philox4x32_10;
using univl::philox_word;
using bf16 = __nv_bfloat16;

constexpr int kH = 768;                       // the hidden width the kernels take
constexpr int kRows = 32;                     // rows a block owns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = kRows / kWarps;  // 4
constexpr int kFc = 256;                      // F chunk
constexpr int kQH = kH / 128;                 // column quads a lane holds across H
constexpr int kQF = kFc / 128;                // ... across an F chunk
constexpr unsigned kFfnBlockTag = 4, kDenseBlockTag = 5;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and back: the TPU kernels' astype(compute dtype) points
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float& at(float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}
__device__ __forceinline__ float at(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const float2 a = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[0]);
  const float2 b = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z), round_to<T>(v.w));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// erf-GELU and its derivative in f32 (univl_tpu/kernels/ffn.py:70-78)
__device__ __forceinline__ float gelu(float x) { return x * 0.5f * (1.0f + erff(x * kInvSqrt2)); }
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * kInvSqrt2));
  return cdf + x * (expf(-0.5f * x * x) * kInvSqrt2Pi);
}

// The bf16 route's GELU: the TPU kernels' erf (Abramowitz & Stegun 7.1.26,
// |err| <= 1.5e-7; univl_tpu/kernels/ffn.py:54-66), whose exp(-x^2 / 2) is
// also the derivative's: cdf = Phi(x) and pdf = exp(-x^2 / 2) / sqrt(2 pi)
// from one exp and one fast reciprocal. gelu = x cdf, gelu' = cdf + x pdf.
__device__ __forceinline__ float2 gelu_cdf_pdf(float x) {
  const float a = fabsf(x) * kInvSqrt2;
  const float e = __expf(-a * a);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, a, 1.0f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return make_float2(0.5f * (1.0f + copysignf(1.0f - poly * e, x)), e * kInvSqrt2Pi);
}

// The lane's first column of quad q of a row: lanes hold 4 adjacent columns,
// a warp 128 adjacent columns per quad.
__device__ __forceinline__ int quad_col(int q) { return q * 128 + 4 * (threadIdx.x & 31); }

// The dropout factors of the 4 columns from col (a multiple of 4) of a row:
// 1/(1-rate) where kept, 0 where dropped. One Philox call per quad. The
// counter's row is row + drop.offset: a sequence-parallel rank's rows are
// rows [offset, offset + N) of the whole call.
__device__ __forceinline__ float4 keep4(const Dropout& drop, int row, int col, unsigned tag) {
  const uint4 w =
      philox4x32_10(make_uint4(col >> 2, row + drop.offset, tag, 0), univl::key_of(drop));
  float4 k;
#pragma unroll
  for (int t = 0; t < 4; ++t) at(k, t) = philox_word(w, t) >= drop.threshold ? drop.inv_keep : 0.0f;
  return k;
}

// ---------------------------------------------------------------- f32: CUDA cores

constexpr int kKc = 16;            // depth of a staged weight tile
constexpr int kBStride = kH + 4;   // staged tile row, 16-byte aligned

// Rows [row0, row0 + kRows) of a [N, width] matrix into f32 shared memory,
// zeros past N.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int N, int row0,
                                           int width) {
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    const int r = e / width, c = e % width;
    dst[e] = row0 + r < N ? to_float(src[static_cast<long long>(row0 + r) * width + c]) : 0.0f;
  }
}

// Rows [k0, k0 + kKc) and columns [n0, n0 + NC) of B(k, n) = M[n * ld + k]
// into bs[kk * kBStride + n].
template <int NC, typename W>
__device__ __forceinline__ void stage_b(float* bs, const W* __restrict__ M, int ld, int k0,
                                        int n0) {
  for (int e = threadIdx.x; e < kKc * NC; e += kThreads) {
    const int kk = e % kKc, n = e / kKc;
    bs[kk * kBStride + n] = to_float(M[static_cast<long long>(n0 + n) * ld + k0 + kk]);
  }
}

// acc[r][q] += sum over k < K of A[warp's row r][k] * B(k, n0 + quad_col(q) + 0..3),
// A in shared memory (row stride lda), B as in stage_b, staged kKc rows at a time.
template <int NQ, typename W>
__device__ __forceinline__ void gemm_tile(float4 (&acc)[kRowsPerWarp][NQ], const float* as,
                                          int lda, int K, const W* __restrict__ M, int ld,
                                          int n0, float* bs) {
  const float* arow = as + (threadIdx.x >> 5) * kRowsPerWarp * lda;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    __syncthreads();  // every warp is done with bs (and with the rows of `as` it reads)
    stage_b<NQ * 128>(bs, M, ld, k0, n0);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kKc; ++kk) {
      float a[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) a[r] = arow[r * lda + k0 + kk];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 b = load4(bs + kk * kBStride + quad_col(q));
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          acc[r][q].x = fmaf(a[r], b.x, acc[r][q].x);
          acc[r][q].y = fmaf(a[r], b.y, acc[r][q].y);
          acc[r][q].z = fmaf(a[r], b.z, acc[r][q].z);
          acc[r][q].w = fmaf(a[r], b.w, acc[r][q].w);
        }
      }
    }
  }
}

template <int NQ>
__device__ __forceinline__ void zero(float4 (&acc)[kRowsPerWarp][NQ]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[r][q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------- epilogues

// The block epilogue of one row held by a warp: y (already + bias, rounded)
// dropped, s = round(y + res), s saved, out = round(LN(s)) (ffn.py:290-326).
template <typename T>
__device__ __forceinline__ void residual_layer_norm(float4 (&y)[kQH], const float4 (&res)[kQH],
                                                    int row, bool valid, const float* ln_scale,
                                                    const float* ln_bias, float eps,
                                                    const Dropout& drop, unsigned tag, T* out,
                                                    T* s_out) {
  float sum = 0.0f;
#pragma unroll
  for (int q = 0; q < kQH; ++q) {
    const float4 k = drop.on ? keep4(drop, row, quad_col(q), tag) : make_float4(1, 1, 1, 1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float v = at(y[q], t);
      if (drop.on) v = at(k, t) != 0.0f ? round_to<T>(v * at(k, t)) : 0.0f;
      v = round_to<T>(v + at(res[q], t));
      at(y[q], t) = v;
      sum += v;
    }
  }
  const float u = warp_sum(sum) / kH;
  float sq = 0.0f;
#pragma unroll
  for (int q = 0; q < kQH; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float d = at(y[q], t) - u;
      sq += d * d;
    }
  const float rstd = rsqrtf(warp_sum(sq) / kH + eps);
  if (!valid) return;
  const long long base = static_cast<long long>(row) * kH;
#pragma unroll
  for (int q = 0; q < kQH; ++q) {
    const int col = quad_col(q);
    if (s_out) store4(s_out + base + col, y[q]);
    const float4 sc = load4(ln_scale + col), bi = load4(ln_bias + col);
    float4 o;
#pragma unroll
    for (int t = 0; t < 4; ++t) at(o, t) = ((at(y[q], t) - u) * rstd) * at(sc, t) + at(bi, t);
    store4(out + base + col, o);
  }
}
// LayerNormTF's backward for the block's rows (ffn.py:335-362): with
// xhat = (s - u) * rstd and gs = g * scale,
//   ds = rstd * (gs - mean(gs) - xhat * mean(gs * xhat))   (f32),
// the dropped gradient round(keep ? ds / (1 - rate) : 0) to `as` (the next
// product's A, rows of lda) and to dropped_out, round(ds) to ds_out (if
// given), each row's (u, rstd, mean(gs), mean(gs * xhat)) to stats (if
// given), and the block's column sums of g and g * xhat, summed in a fixed
// order, to the partials. A warp takes kRpw rows: the block kWarps * kRpw.
template <typename T, typename A, int kRpw = kRowsPerWarp>
__device__ void layer_norm_backward(const T* __restrict__ s, const T* __restrict__ g,
                                    const float* __restrict__ ln_scale, int N, int row0,
                                    float eps, const Dropout& drop, unsigned tag, A* as, int lda,
                                    T* dropped_out, T* ds_out, float* stats, float* red,
                                    float* dscale_p, float* dbias_p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 pg[kQH], pgx[kQH];
#pragma unroll
  for (int q = 0; q < kQH; ++q) pg[q] = pgx[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < kRpw; ++r) {
    const int lr = warp * kRpw + r, row = row0 + lr;
    const bool valid = row < N;
    const long long base = static_cast<long long>(row) * kH;
    float4 sv[kQH], gv[kQH];
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kQH; ++q) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      sv[q] = valid ? load4(s + base + quad_col(q)) : z;
      gv[q] = valid ? load4(g + base + quad_col(q)) : z;
      sum += sv[q].x + sv[q].y + sv[q].z + sv[q].w;
    }
    const float u = warp_sum(sum) / kH;
    float sq = 0.0f;
#pragma unroll
    for (int q = 0; q < kQH; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float d = at(sv[q], t) - u;
        sq += d * d;
      }
    const float rstd = rsqrtf(warp_sum(sq) / kH + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int q = 0; q < kQH; ++q) {
      const float4 sc = load4(ln_scale + quad_col(q));
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float xh = (at(sv[q], t) - u) * rstd, gval = at(gv[q], t);
        at(sv[q], t) = xh;  // sv holds xhat from here on
        at(pg[q], t) += gval;
        at(pgx[q], t) += gval * xh;
        const float gs = gval * at(sc, t);
        at(gv[q], t) = gs;  // gv holds gs from here on
        s1 += gs;
        s2 += gs * xh;
      }
    }
    const float m1 = warp_sum(s1) / kH, m2 = warp_sum(s2) / kH;
    if (lane == 0 && stats) {
      stats[4 * lr] = u;
      stats[4 * lr + 1] = rstd;
      stats[4 * lr + 2] = m1;
      stats[4 * lr + 3] = m2;
    }
#pragma unroll
    for (int q = 0; q < kQH; ++q) {
      const int col = quad_col(q);
      const float4 k = drop.on ? keep4(drop, row, col, tag) : make_float4(1, 1, 1, 1);
      float4 ds, dd;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        at(ds, t) = rstd * (at(gv[q], t) - m1 - at(sv[q], t) * m2);
        at(dd, t) = round_to<T>(drop.on ? at(ds, t) * at(k, t) : at(ds, t));
      }
      if (as) store4(as + lr * lda + col, dd);
      if (valid) {
        store4(dropped_out + base + col, dd);
        if (ds_out) store4(ds_out + base + col, round4<T>(ds));
      }
    }
  }
  __syncthreads();  // red is the weight-tile buffer: no warp still reads it
#pragma unroll
  for (int q = 0; q < kQH; ++q) {
    store4(red + warp * kH + quad_col(q), pg[q]);
    store4(red + (kWarps + warp) * kH + quad_col(q), pgx[q]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kH; c += kThreads) {
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * kH + c];
      b += red[(kWarps + w) * kH + c];
    }
    dbias_p[static_cast<long long>(blockIdx.x) * kH + c] = a;
    dscale_p[static_cast<long long>(blockIdx.x) * kH + c] = b;
  }
}

// ds of one element from its row's statistics (dx = ds + the FFN's dx in #4)
__device__ __forceinline__ float ds_of(const float* st, float s, float g, float scale) {
  return st[1] * (g * scale - st[2] - (s - st[0]) * st[1] * st[3]);
}
__device__ __forceinline__ float ds_of(float4 st, float s, float g, float scale) {
  return st.y * (g * scale - st.z - (s - st.x) * st.y * st.w);
}

// ---------------------------------------------------------------- #3, #4 forward

template <typename T, bool kBlock>
__device__ __forceinline__ void ffn_fwd_cc(
    const T* __restrict__ x, const T* __restrict__ w1t, const T* __restrict__ b1,
    const T* __restrict__ w2t, const T* __restrict__ b2, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, T* __restrict__ out, T* __restrict__ pre_out,
    T* __restrict__ s_out, int N, int F, float eps, const Dropout& drop) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [kRows][kH] the block's rows of x
  float* hs = xs + kRows * kH;   // [kRows][kFc] the chunk's activation
  float* bs = hs + kRows * kFc;  // [kKc][kBStride] a weight tile
  const int rb = (threadIdx.x >> 5) * kRowsPerWarp;
  const int row0 = blockIdx.x * kRows;
  stage_rows(xs, x, N, row0, kH);
  float4 acc[kRowsPerWarp][kQH];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += kFc) {
    float4 c1[kRowsPerWarp][kQF];
    zero(c1);
    gemm_tile<kQF>(c1, xs, kH, kH, w1t, kH, f0, bs);  // x W1[:, f0:f0+kFc]
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + rb + r;
#pragma unroll
      for (int q = 0; q < kQF; ++q) {
        const int col = quad_col(q);
        const float4 bias = load4(b1 + f0 + col);
        float4 p, h;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          at(p, t) = round_to<T>(round_to<T>(at(c1[r][q], t)) + at(bias, t));
          at(h, t) = round_to<T>(gelu(at(p, t)));
        }
        if (pre_out && row < N) store4(pre_out + static_cast<long long>(row) * F + f0 + col, p);
        store4(hs + (rb + r) * kFc + col, h);
      }
    }
    gemm_tile<kQH>(acc, hs, kFc, kFc, w2t + f0, F, 0, bs);  // h W2[f0:f0+kFc, :]
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + rb + r;
    const bool valid = row < N;
    float4 y[kQH], res[kQH];
#pragma unroll
    for (int q = 0; q < kQH; ++q) {
      const int col = quad_col(q);
      const float4 bias = load4(b2 + col);
#pragma unroll
      for (int t = 0; t < 4; ++t) at(y[q], t) = round_to<T>(round_to<T>(at(acc[r][q], t)) + at(bias, t));
      res[q] = load4(xs + (rb + r) * kH + col);
    }
    if (kBlock) {
      residual_layer_norm<T>(y, res, row, valid, ln_scale, ln_bias, eps, drop, kFfnBlockTag, out,
                             s_out);
    } else if (valid) {
#pragma unroll
      for (int q = 0; q < kQH; ++q) store4(out + static_cast<long long>(row) * kH + quad_col(q), y[q]);
    }
  }
}

// ---------------------------------------------------------------- #3, #4 backward

template <typename T, bool kBlock>
__device__ __forceinline__ void ffn_bwd_cc(
    const T* __restrict__ pre, const T* __restrict__ g, const T* __restrict__ w1,
    const T* __restrict__ w2, const T* __restrict__ s, const float* __restrict__ ln_scale,
    T* __restrict__ dx, T* __restrict__ dpre, T* __restrict__ h, T* __restrict__ dffn,
    float* __restrict__ dscale_p, float* __restrict__ dbias_p, int N, int F, float eps,
    const Dropout& drop) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                        // [kRows][kH] the gradient entering the FFN
  float* hs = as + kRows * kH;             // [kRows][kFc] the chunk's dpre
  float* bs = hs + kRows * kFc;            // [kKc][kBStride] a weight tile
  float* stats = bs + kKc * kBStride;      // [kRows][4] LayerNorm row statistics
  const int rb = (threadIdx.x >> 5) * kRowsPerWarp;
  const int row0 = blockIdx.x * kRows;
  if (kBlock) {
    layer_norm_backward<T>(s, g, ln_scale, N, row0, eps, drop, kFfnBlockTag, as, kH, dffn,
                           static_cast<T*>(nullptr), stats, bs, dscale_p, dbias_p);
  } else {
    stage_rows(as, g, N, row0, kH);
  }
  float4 acc[kRowsPerWarp][kQH];
  zero(acc);
  for (int f0 = 0; f0 < F; f0 += kFc) {
    float4 c1[kRowsPerWarp][kQF];
    zero(c1);
    gemm_tile<kQF>(c1, as, kH, kH, w2, kH, f0, bs);  // g W2[f0:f0+kFc, :]^T
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + rb + r;
      const bool valid = row < N;
      const long long base = static_cast<long long>(row) * F + f0;
#pragma unroll
      for (int q = 0; q < kQF; ++q) {
        const int col = quad_col(q);
        const float4 p = valid ? load4(pre + base + col) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 hv, dp;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          at(hv, t) = gelu(at(p, t));
          at(dp, t) = round_to<T>(at(c1[r][q], t) * gelu_grad(at(p, t)));
        }
        if (valid) {
          store4(h + base + col, hv);
          store4(dpre + base + col, dp);
        }
        store4(hs + (rb + r) * kFc + col, dp);
      }
    }
    gemm_tile<kQH>(acc, hs, kFc, kFc, w1 + f0, F, 0, bs);  // dpre W1[:, f0:f0+kFc]^T
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = rb + r, row = row0 + lr;
    if (row >= N) continue;
    const long long base = static_cast<long long>(row) * kH;
#pragma unroll
    for (int q = 0; q < kQH; ++q) {
      const int col = quad_col(q);
      float4 o = acc[r][q];
      if (kBlock) {  // dx = ds + dx_ffn, ds recomputed from the row statistics
        const float4 sv = load4(s + base + col), gv = load4(g + base + col);
        const float4 sc = load4(ln_scale + col);
#pragma unroll
        for (int t = 0; t < 4; ++t) at(o, t) += ds_of(stats + 4 * lr, at(sv, t), at(gv, t), at(sc, t));
      }
      store4(dx + base + col, o);
    }
  }
}

// ---------------------------------------------------------------- #3, #4 in bf16: wgmma GEMMs

// A bf16 call is two GEMMs and row kernels, all through device memory where
// the function already writes ([N, F] pre, h, dpre): GEMM tiles of kBM x kBN
// read each staged weight byte for kBM rows. A persistent block a SM: one
// producer warpgroup issues TMA loads of A and B tiles, kBK deep, into a
// ring of kStages; two consumer warpgroups each run wgmma m64n256k16 on 64
// rows of the tile into 128 f32 registers a thread. A consumer's epilogue
// writes its bf16 outputs into a staging tile in shared memory and one of
// its threads hands the tile to TMA stores, which run on while the
// consumer takes up the next tile's products (the producer has filled the
// ring meanwhile). Both operands are K-major: A [M, K] (x, h, dffn or g,
// dpre) and B [N, K] (W1^T, W2^T as nn.Linear stores them; W2, W1 in the
// JAX layout).
constexpr int kBM = 128;           // rows of a tile: a 64-row wgmma for each consumer
constexpr int kBN = 256;           // its columns: one m64n256 accumulator a consumer
constexpr int kBK = 64;            // depth of a stage: one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kGemmThreads = 384;  // the producer warpgroup and two consumers
constexpr int kStageA = kBM * kBK, kStageB = kBN * kBK;  // bf16 elements of a stage
constexpr uint32_t kStageBytes = (kStageA + kStageB) * sizeof(bf16);
constexpr int kOutTile = 64 * kBN;  // bf16 elements of a consumer's two staging buffers
constexpr int kOutBox = 64 * 64;    // ... of one of their TMA boxes (two a buffer)
constexpr size_t kGemmSmem =        // the ring, the staging tiles, their alignment
    kStages * kStageBytes + 2 * kOutTile * sizeof(bf16) + 1024;
constexpr int kMinSteps = 4;        // stages of depth a split takes at least

enum Epilogue { kBias, kPartial, kDGelu, kDx };

struct EpiArgs {
  bf16* out;            // [M, N]: pre or y (kBias; may be null), dpre (kDGelu), dx (kDx)
  bf16* h;              // [M, N]: round(gelu(out)) (kBias, where not null), h (kDGelu)
  const bf16* bias;     // [N] (kBias)
  const bf16* pre;      // [M, N] (kDGelu)
  float* part;          // [splits, M, N]: each split's f32 sums (kPartial)
  const bf16* s;        // kDx for #4: the LayerNorm input, the output gradient,
  const bf16* g;        // the scale and the row statistics, from which ds is
  const float* scale;   // added; stats null for #3
  const float* stats;
};

// The TMA maps of a GEMM: its operands, its bf16 outputs (out, h) and the
// epilogue's prefetched inputs (kDGelu: pre; kDx for #4: s and g).
struct GemmMaps {
  CUtensorMap a, b, out, h, in0, in1;
};

// Element (r, c) of a staging buffer: two 64 x 64 boxes in TMA's 128-byte
// swizzle, so a warp's fragment writes and reads (8 rows x 4 column pairs)
// hit 32 banks.
__device__ __forceinline__ int staged(int r, int c) {
  return (c >> 6) * kOutBox + r * 64 + ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The epilogue's inputs for column half `half` of a consumer's tile at
// (row0, col0), loaded by its leader into the staging buffers once the last
// stores have read them (for half 0 while the products run): kDGelu pre into
// buffer 0; kDx for #4 s into buffer 0 and g into buffer 1.
template <int kEpi>
__device__ __forceinline__ void epilogue_prefetch(const GemmMaps& m, bf16* tile, uint64_t* bar,
                                                  int row0, int col0, int half) {
  univl::tma_store_wait<0, true>();
  const int boxes = kEpi == kDGelu ? 2 : 4;
  univl::mbar_arrive_expect_tx(bar, boxes * kOutBox * sizeof(bf16));
  for (int b = 0; b < boxes; ++b) {
    univl::tma_load_2d(tile + b * kOutBox, b < 2 ? &m.in0 : &m.in1, bar,
                       col0 + 128 * half + 64 * (b & 1), row0);
  }
}

// The epilogue of a consumer's 64 x 256 accumulator at (row0, col0). kPartial
// stores its f32 sums straight from registers. The others go by column
// parts: each bf16 output of the part goes into a staging buffer (of 64 x
// 128 columns, or 64 for kBias's quarters), which the leader hands to TMA
// stores (they drop rows past M):
// kBias pre (buffer 0, when saved) and h (buffer 1, when wanted; y alone in
// buffer 0); kDGelu h over the prefetched pre (buffer 0) and dpre (buffer
// 1); kDx dx (buffer 0; for #4 over the prefetched s, with g in buffer 1).
template <int kEpi>
__device__ __forceinline__ void gemm_epilogue(const float (&d)[128], const EpiArgs& e,
                                              const GemmMaps& m, bf16* tile, uint64_t* bar,
                                              uint32_t& phase, int M, int N, int row0, int col0,
                                              int split) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int rl = 16 * (t >> 5) + (lane >> 2), cl = 2 * (lane & 3);
  if constexpr (kEpi == kPartial) {
    float* part = e.part + static_cast<long long>(split) * M * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + rl + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        *reinterpret_cast<float2*>(part + static_cast<long long>(row) * N + col0 + cl + 8 * j) =
            make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
      }
    }
  } else {
    // kBias goes by quarters, alternating between two sets of buffers (64
    // columns of pre and of h each), so a quarter's stores read shared
    // memory while the next quarter is computed; the others go by halves.
    constexpr int kParts = kEpi == kBias ? 4 : 2, kJ = 32 / kParts, kBoxes = 4 / kParts;
    const bool leader = t == 0;
    const int named = threadIdx.x / 128;  // named barriers 1 and 2, one a consumer
    const bool loaded = kEpi == kDGelu || (kEpi == kDx && e.stats);
    float4 st[2];
    if (kEpi == kDx && e.stats) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        st[half] = *reinterpret_cast<const float4*>(e.stats + 4 * min(row0 + rl + 8 * half, M - 1));
      }
    }
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      bf16* buf0 = kParts == 4 ? tile + (part & 1) * 2 * kOutBox : tile;
      bf16* buf1 = buf0 + kBoxes * kOutBox;
      if (loaded) {
        if (part == 1 && leader) epilogue_prefetch<kEpi>(m, tile, bar, row0, col0, 1);
        univl::mbar_wait(bar, phase);
        phase ^= 1;
      } else {
        // the stores that last read these buffers: two parts ago (quarters)
        // or one (halves)
        if (leader) {
          if (kParts == 4) univl::tma_store_wait<1, true>();
          else univl::tma_store_wait<0, true>();
        }
        univl::named_barrier(named, 128);
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = part * kJ + jj;
        const int col = col0 + cl + 8 * j;
        float2 b;
        if constexpr (kEpi == kBias) b = load2(e.bias + col);
        float2 sc;
        if constexpr (kEpi == kDx) sc = e.stats ? *reinterpret_cast<const float2*>(e.scale + col)
                                                : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float a0 = d[4 * j + 2 * half], a1 = d[4 * j + 2 * half + 1];
          const int at = staged(rl + 8 * half, cl + 8 * jj);
          uint32_t* b0 = reinterpret_cast<uint32_t*>(buf0 + at);
          uint32_t* b1 = reinterpret_cast<uint32_t*>(buf1 + at);
          if constexpr (kEpi == kBias) {  // pre (or y) to buffer 0; h from it below
            *b0 = pack_bf16(round_to<bf16>(a0) + b.x, round_to<bf16>(a1) + b.y);
          } else if constexpr (kEpi == kDGelu) {
            const float2 p = unpack2(*b0);
            const float2 c0 = gelu_cdf_pdf(p.x), c1 = gelu_cdf_pdf(p.y);
            *b0 = pack_bf16(p.x * c0.x, p.y * c1.x);  // h over pre
            *b1 = pack_bf16(a0 * fmaf(p.x, c0.y, c0.x), a1 * fmaf(p.y, c1.y, c1.x));
          } else if (e.stats) {  // kDx for #4: dx = ds + dx_ffn, ds from the row statistics
            const float2 sv = unpack2(*b0), gv = unpack2(*b1);
            *b0 = pack_bf16(a0 + ds_of(st[half], sv.x, gv.x, sc.x), a1 + ds_of(st[half], sv.y, gv.y, sc.y));
          } else {
            *b0 = pack_bf16(a0, a1);
          }
        }
      }
      if (kEpi == kBias && e.h) {  // h = round(gelu(pre)), each thread over its own pairs
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int at = staged(rl + 8 * half, cl + 8 * jj);
            const float2 p = unpack2(*reinterpret_cast<const uint32_t*>(buf0 + at));
            *reinterpret_cast<uint32_t*>(buf1 + at) =
                pack_bf16(p.x * gelu_cdf_pdf(p.x).x, p.y * gelu_cdf_pdf(p.y).x);
          }
      }
      univl::fence_proxy_async();
      univl::named_barrier(named, 128);
      if (leader) {
        const bool first = kEpi != kBias || e.out, second = kEpi == kDGelu || (kEpi == kBias && e.h);
        for (int b = 0; b < kBoxes; ++b) {
          const int col = col0 + part * 64 * kBoxes + 64 * b;
          if (first) univl::tma_store_2d(kEpi == kDGelu ? &m.h : &m.out, buf0 + b * kOutBox, col, row0);
          if (second) univl::tma_store_2d(kEpi == kDGelu ? &m.out : &m.h, buf1 + b * kOutBox, col, row0);
        }
        univl::tma_store_commit();
      }
    }
  }
}

// C = A B^T, [M, N] over depth K (K a multiple of kBK * splits; N a
// multiple of kBN, or for kDx without the ds term any multiple of 64: the
// last column tile's loads past N read zeros and TMA drops its stores there),
// tile by tile: tile t is split t % splits of column tile (t / splits) %
// (N / kBN) of row tile t / splits / (N / kBN), so the blocks at work at
// once share their weight tiles and rows in L2. A split takes K / splits of
// the depth and writes its own f32 sums (kPartial), summed later in split
// order: every output is the same from call to call.
template <int kEpi>
__device__ __forceinline__ void gemm_body(const GemmMaps& m, int M, int N, int K, int splits,
                                          const EpiArgs& e) {
  extern __shared__ uint8_t gemm_smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], epi[2];
  bf16* sa = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* sb = sa + kStages * kStageA;
  const int tiles_n = (N + kBN - 1) / kBN, tiles = (M + kBM - 1) / kBM * tiles_n * splits;
  const int steps = K / kBK / splits;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      univl::mbar_init(&full[i], 1);   // the producer's arrival, then the bytes
      univl::mbar_init(&empty[i], 2);  // one arrival a consumer
    }
    univl::mbar_init(&epi[0], 1);  // a consumer leader's prefetch, then its bytes
    univl::mbar_init(&epi[1], 1);
    univl::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer
    univl::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int split = tile % splits, tn = tile / splits % tiles_n, tm = tile / splits / tiles_n;
        for (int k = 0; k < steps; ++k, ++it) {
          const int st = it % kStages;
          univl::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          univl::mbar_arrive_expect_tx(&full[st], kStageBytes);
          const int kc = (split * steps + k) * kBK;
          univl::tma_load_2d(sa + st * kStageA, &m.a, &full[st], kc, tm * kBM);
          univl::tma_load_2d(sb + st * kStageB, &m.b, &full[st], kc, tn * kBN);
        }
      }
    }
  } else {
    univl::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;  // this consumer's 64 rows of the tile
    bf16* staging = sb + kStages * kStageB + c * kOutTile;
    const bool leader = (threadIdx.x & 127) == 0;
    const bool prefetch = kEpi == kDGelu || (kEpi == kDx && e.stats);
    uint32_t phase = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int split = tile % splits, tn = tile / splits % tiles_n, tm = tile / splits / tiles_n;
      const int row0 = tm * kBM + 64 * c, col0 = tn * kBN;
      if (prefetch && leader && row0 < M) {
        epilogue_prefetch<kEpi>(m, staging, &epi[c], row0, col0, 0);
      }
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      univl::wgmma_fence_operands(d);
      int prev = 0;
      for (int k = 0; k < steps; ++k, ++it) {
        const int st = it % kStages;
        univl::mbar_wait(&full[st], (it / kStages) & 1);
        univl::wgmma_fence();
        const bf16* a = sa + st * kStageA + c * 64 * kBK;
        const bf16* b = sb + st * kStageB;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          univl::wgmma_m64n256k16(d, univl::wgmma_desc(a + kk), univl::wgmma_desc(b + kk), 1);
        }
        univl::wgmma_commit();
        univl::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (k > 0 && leader) univl::mbar_arrive(&empty[prev]);
        prev = st;
      }
      univl::wgmma_wait<0>();
      univl::wgmma_fence_operands(d);
      if (leader) univl::mbar_arrive(&empty[prev]);
      if (row0 < M) gemm_epilogue<kEpi>(d, e, m, staging, &epi[c], phase, M, N, row0, col0, split);
    }
    if (leader) univl::tma_store_wait<0, false>();  // the last stores are done with the tile
  }
}

// Under names of their own for #3's and #4's forward and backward and #5's,
// so a profile tells them apart: one body (gemm_body) under four names
#define UNIVL_GEMM_KERNEL(name)                                                                 \
  template <int kEpi>                                                                          \
  __global__ void __launch_bounds__(kGemmThreads, 1)                                           \
      name(const __grid_constant__ GemmMaps m, int M, int N, int K, int splits, EpiArgs e) {   \
    gemm_body<kEpi>(m, M, N, K, splits, e);                                                    \
  }
UNIVL_GEMM_KERNEL(ffn_fwd_gemm_kernel)
UNIVL_GEMM_KERNEL(ffn_bwd_gemm_kernel)
UNIVL_GEMM_KERNEL(dense_fwd_gemm_kernel)
UNIVL_GEMM_KERNEL(dense_bwd_gemm_kernel)
#undef UNIVL_GEMM_KERNEL

// A forward's rows after its last product (h W2 for #3 and #4, x W for #5):
// y = round(round(sum of the splits' partials) + b), or with splits = 0 the
// GEMM's y, already in out (always for #5); for #4 and #5 (kBlock) then
// dropped with the kernel's Philox tag, s = round(y + res), out =
// round(LN(s)) (in place over y); res is x for #4, r for #5. A warp a row.
template <bool kBlock>
__device__ __forceinline__ void fwd_rows(const float* __restrict__ part, int splits,
                                         const bf16* __restrict__ b, const bf16* __restrict__ res,
                                         const float* __restrict__ ln_scale,
                                         const float* __restrict__ ln_bias, bf16* out,
                                         bf16* __restrict__ s_out, int N, float eps,
                                         const Dropout& drop, unsigned tag) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const long long base = static_cast<long long>(row) * kH, stride = static_cast<long long>(N) * kH;
  float4 y[kQH], rv[kQH];
#pragma unroll
  for (int q = 0; q < kQH; ++q) {
    const int col = quad_col(q);
    if (splits == 0) {
      y[q] = load4(out + base + col);
    } else {
      float4 acc = load4(part + base + col);
      for (int sp = 1; sp < splits; ++sp) {
        const float4 v = load4(part + sp * stride + base + col);
        acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
      }
      const float4 bv = load4(b + col);
#pragma unroll
      for (int t = 0; t < 4; ++t) at(y[q], t) = round_to<bf16>(round_to<bf16>(at(acc, t)) + at(bv, t));
    }
    rv[q] = kBlock ? load4(res + base + col) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (kBlock) {
    residual_layer_norm<bf16>(y, rv, row, true, ln_scale, ln_bias, eps, drop, tag, out, s_out);
  } else {
#pragma unroll
    for (int q = 0; q < kQH; ++q) store4(out + base + quad_col(q), y[q]);
  }
}

template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
    ffn_fwd_rows_kernel(const float* __restrict__ part, int splits, const bf16* __restrict__ b2,
                        const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                        const float* __restrict__ ln_bias, bf16* out, bf16* __restrict__ s_out,
                        int N, float eps, Dropout drop) {
  fwd_rows<kBlock>(part, splits, b2, x, ln_scale, ln_bias, out, s_out, N, eps, drop, kFfnBlockTag);
}
__global__ void __launch_bounds__(kThreads)
    dense_fwd_rows_kernel(const bf16* __restrict__ r, const float* __restrict__ ln_scale,
                          const float* __restrict__ ln_bias, bf16* out, bf16* __restrict__ s_out,
                          int N, float eps, Dropout drop) {
  fwd_rows<true>(nullptr, 0, nullptr, r, ln_scale, ln_bias, out, s_out, N, eps, drop,
                 kDenseBlockTag);
}

// The backward's rows after dpre W1^T split along F: dx = round(sum of the
// partials + ds), ds from the row statistics (#4; stats null for #3).
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_rows_kernel(const float* __restrict__ part, int splits, const bf16* __restrict__ s,
                        const bf16* __restrict__ g, const float* __restrict__ ln_scale,
                        const float* __restrict__ stats, bf16* __restrict__ dx, int N) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;
  const long long base = static_cast<long long>(row) * kH, stride = static_cast<long long>(N) * kH;
#pragma unroll
  for (int q = 0; q < kQH; ++q) {
    const int col = quad_col(q);
    float4 acc = load4(part + base + col);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 v = load4(part + sp * stride + base + col);
      acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
    }
    if (stats) {
      const float4 sv = load4(s + base + col), gv = load4(g + base + col);
      const float4 sc = load4(ln_scale + col);
#pragma unroll
      for (int t = 0; t < 4; ++t) at(acc, t) += ds_of(stats + 4 * row, at(sv, t), at(gv, t), at(sc, t));
    }
    store4(dx + base + col, acc);
  }
}

// The split halves of #3-#5 under tensor parallelism (kernels/ffn.py): a
// rank's GEMMs over its share of the depth leave an f32 partial [N, H]
// (summed over the splits here, in split order), the ranks' partials are
// all-reduced or reduce-scattered outside, and the row kernels below finish
// on the rows the rank holds, with drop.offset the first one's index.
__global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(float* __restrict__ part, int splits, long long count) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (i >= count) return;
  float4 acc = load4(part + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 v = load4(part + sp * count + i);
    acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
  }
  store4(part + i, acc);
}

// After the reduce: y = round(round(part) + b); for #4 and #5 (kBlock) then
// dropped with `tag` at row + drop.offset, s = round(y + res), out =
// round(LN(s)). A warp a row.
template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
    split_rows_kernel(const float* __restrict__ part, const bf16* __restrict__ b,
                      const bf16* __restrict__ res, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, bf16* out, bf16* __restrict__ s_out,
                      int N, float eps, Dropout drop, unsigned tag) {
  fwd_rows<kBlock>(part, 1, b, res, ln_scale, ln_bias, out, s_out, N, eps, drop, tag);
}

// A backward's head for #4 and #5: the LayerNorm backward of kWarps * kRpw
// rows a block (layer_norm_backward), the dropped gradient (#4's dffn, #5's
// dy: the next product's A) with the kernel's Philox tag, the row
// statistics (#4), round(ds) (#5's dr), and the block's dscale/dbias
// partials. Two blocks an SM (128 registers a thread): one block a SM left
// each warp's loads and Philox words waiting on each other. kRpw is 4 where
// that gives every SM two blocks, else 1 (kernels/ffn.py:ln_block_rows): a
// tower's 1,536 rows make 192 blocks, not 48.
template <int kRpw>
__device__ __forceinline__ void bwd_ln(const bf16* __restrict__ s, const bf16* __restrict__ g,
                                       const float* __restrict__ ln_scale,
                                       bf16* __restrict__ dropped, bf16* __restrict__ ds_out,
                                       float* __restrict__ stats, float* __restrict__ dscale_p,
                                       float* __restrict__ dbias_p, int N, float eps,
                                       const Dropout& drop, unsigned tag) {
  __shared__ __align__(16) float red[2 * kWarps * kH];
  const int row0 = blockIdx.x * kWarps * kRpw;
  layer_norm_backward<bf16, bf16, kRpw>(s, g, ln_scale, N, row0, eps, drop, tag, nullptr, 0,
                                        dropped, ds_out, stats ? stats + 4 * row0 : nullptr, red,
                                        dscale_p, dbias_p);
}

template <int kRpw>
__global__ void __launch_bounds__(kThreads, 2)
    ffn_bwd_ln_kernel(const bf16* __restrict__ s, const bf16* __restrict__ g,
                      const float* __restrict__ ln_scale, bf16* __restrict__ dffn,
                      float* __restrict__ stats, float* __restrict__ dscale_p,
                      float* __restrict__ dbias_p, int N, float eps, Dropout drop) {
  bwd_ln<kRpw>(s, g, ln_scale, dffn, nullptr, stats, dscale_p, dbias_p, N, eps, drop,
               kFfnBlockTag);
}
template <int kRpw>
__global__ void __launch_bounds__(kThreads, 2)
    dense_bwd_ln_kernel(const bf16* __restrict__ s, const bf16* __restrict__ g,
                        const float* __restrict__ ln_scale, bf16* __restrict__ dy,
                        bf16* __restrict__ dr, float* __restrict__ dscale_p,
                        float* __restrict__ dbias_p, int N, float eps, Dropout drop) {
  bwd_ln<kRpw>(s, g, ln_scale, dy, dr, nullptr, dscale_p, dbias_p, N, eps, drop,
               kDenseBlockTag);
}

// ---------------------------------------------------------------- #5

template <typename T>
__device__ __forceinline__ void dense_fwd_cc(
    const T* __restrict__ x, const T* __restrict__ res_in, const T* __restrict__ wt,
    const T* __restrict__ b, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, T* __restrict__ out, T* __restrict__ s_out, int N,
    float eps, const Dropout& drop) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [kRows][kH]
  float* bs = xs + kRows * kH;  // [kKc][kBStride]
  const int rb = (threadIdx.x >> 5) * kRowsPerWarp;
  const int row0 = blockIdx.x * kRows;
  stage_rows(xs, x, N, row0, kH);
  float4 acc[kRowsPerWarp][kQH];
  zero(acc);
  gemm_tile<kQH>(acc, xs, kH, kH, wt, kH, 0, bs);  // x W
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + rb + r;
    const bool valid = row < N;
    float4 y[kQH], res[kQH];
#pragma unroll
    for (int q = 0; q < kQH; ++q) {
      const int col = quad_col(q);
      const float4 bias = load4(b + col);
#pragma unroll
      for (int t = 0; t < 4; ++t) at(y[q], t) = round_to<T>(round_to<T>(at(acc[r][q], t)) + at(bias, t));
      res[q] = valid ? load4(res_in + static_cast<long long>(row) * kH + col)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    residual_layer_norm<T>(y, res, row, valid, ln_scale, ln_bias, eps, drop, kDenseBlockTag, out,
                           s_out);
  }
}

template <typename T>
__device__ __forceinline__ void dense_bwd_cc(
    const T* __restrict__ s, const T* __restrict__ g, const T* __restrict__ w,
    const float* __restrict__ ln_scale, T* __restrict__ dx, T* __restrict__ dy,
    T* __restrict__ dr, float* __restrict__ dscale_p, float* __restrict__ dbias_p, int N,
    float eps, const Dropout& drop) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                    // [kRows][kH] dy
  float* bs = as + kRows * kH;         // [kKc][kBStride]
  float* stats = bs + kKc * kBStride;  // [kRows][4]
  const int rb = (threadIdx.x >> 5) * kRowsPerWarp;
  const int row0 = blockIdx.x * kRows;
  layer_norm_backward<T>(s, g, ln_scale, N, row0, eps, drop, kDenseBlockTag, as, kH, dy, dr,
                         stats, bs, dscale_p, dbias_p);
  float4 acc[kRowsPerWarp][kQH];
  zero(acc);
  gemm_tile<kQH>(acc, as, kH, kH, w, kH, 0, bs);  // dy W^T
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + rb + r;
    if (row >= N) continue;
#pragma unroll
    for (int q = 0; q < kQH; ++q) store4(dx + static_cast<long long>(row) * kH + quad_col(q), acc[r][q]);
  }
}
// ---------------------------------------------------------------- the kernels

// f32 #3 and #4 under names of their own, so a profile tells them apart (in
// bf16 they are the wgmma GEMMs and row kernels above)
#define UNIVL_FFN_FWD_PARAMS                                                                   \
  const float *__restrict__ x, const float *__restrict__ w1t, const float *__restrict__ b1,    \
      const float *__restrict__ w2t, const float *__restrict__ b2,                             \
      const float *__restrict__ ln_scale, const float *__restrict__ ln_bias,                   \
      float *__restrict__ out, float *__restrict__ pre_out, float *__restrict__ s_out, int N,  \
      int F, float eps, Dropout drop
#define UNIVL_FFN_FWD_ARGS \
  x, w1t, b1, w2t, b2, ln_scale, ln_bias, out, pre_out, s_out, N, F, eps, drop
#define UNIVL_FFN_BWD_PARAMS                                                                   \
  const float *__restrict__ pre, const float *__restrict__ g, const float *__restrict__ w1,     \
      const float *__restrict__ w2, const float *__restrict__ s,                               \
      const float *__restrict__ ln_scale, float *__restrict__ dx, float *__restrict__ dpre,     \
      float *__restrict__ h, float *__restrict__ dffn, float *__restrict__ dscale_p,           \
      float *__restrict__ dbias_p, int N, int F, float eps, Dropout drop
#define UNIVL_FFN_BWD_ARGS \
  pre, g, w1, w2, s, ln_scale, dx, dpre, h, dffn, dscale_p, dbias_p, N, F, eps, drop

__global__ void __launch_bounds__(kThreads, 1) ffn_fwd_kernel(UNIVL_FFN_FWD_PARAMS) {
  ffn_fwd_cc<float, false>(UNIVL_FFN_FWD_ARGS);
}
__global__ void __launch_bounds__(kThreads, 1) ffn_block_fwd_kernel(UNIVL_FFN_FWD_PARAMS) {
  ffn_fwd_cc<float, true>(UNIVL_FFN_FWD_ARGS);
}
__global__ void __launch_bounds__(kThreads, 1) ffn_bwd_kernel(UNIVL_FFN_BWD_PARAMS) {
  ffn_bwd_cc<float, false>(UNIVL_FFN_BWD_ARGS);
}
__global__ void __launch_bounds__(kThreads, 1) ffn_block_bwd_kernel(UNIVL_FFN_BWD_PARAMS) {
  ffn_bwd_cc<float, true>(UNIVL_FFN_BWD_ARGS);
}

// f32 #5 (in bf16 it is the wgmma GEMM and the row kernels above)
__global__ void __launch_bounds__(kThreads, 1)
dense_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ res_in,
                       const float* __restrict__ wt, const float* __restrict__ b,
                       const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                       float* __restrict__ out, float* __restrict__ s_out, int N, float eps,
                       Dropout drop) {
  dense_fwd_cc<float>(x, res_in, wt, b, ln_scale, ln_bias, out, s_out, N, eps, drop);
}

__global__ void __launch_bounds__(kThreads, 1)
dense_block_bwd_kernel(const float* __restrict__ s, const float* __restrict__ g,
                       const float* __restrict__ w, const float* __restrict__ ln_scale,
                       float* __restrict__ dx, float* __restrict__ dy, float* __restrict__ dr,
                       float* __restrict__ dscale_p, float* __restrict__ dbias_p, int N, float eps,
                       Dropout drop) {
  dense_bwd_cc<float>(s, g, w, ln_scale, dx, dy, dr, dscale_p, dbias_p, N, eps, drop);
}

// ---------------------------------------------------------------- launch

// Dynamic shared memory of the f32 (CUDA-core) kernels, with the row
// statistics of the backwards; their dscale/dbias partials reuse the
// weight-tile buffer.
constexpr size_t kFfnSmemCc = (kRows * kH + kRows * kFc + kKc * kBStride + 4 * kRows) * sizeof(float);
constexpr size_t kDenseSmemCc = (kRows * kH + kKc * kBStride + 4 * kRows) * sizeof(float);
static_assert(2 * kWarps * kH <= kKc * kBStride, "the partials' buffer must fit in the tile's");
static_assert(kFfnSmemCc <= 232448 && kGemmSmem <= 232448, "over Hopper's shared memory");
static_assert(kH % kBN == 0 && kFc % kBN == 0 && kH % (kBK * kMinSteps) == 0 &&
                  kFc % (kBK * kMinSteps) == 0,
              "the GEMM tiles must divide H and the F granule");
constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a block needs the per-kernel opt-in,
// set once per device and kernel (as in train_attention.cu).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

int blocks(int N) { return (N + kRows - 1) / kRows; }

// The bf16 backwards' LayerNorm head at `ln_rows` rows a block (kRows, or
// kWarps: one a warp): its kernel and grid.
template <typename Kernel>
bool ln_head(Kernel four, Kernel one, int ln_rows, int N, Kernel* kernel, int* grid) {
  if (ln_rows != kRows && ln_rows != kWarps) return false;
  *kernel = ln_rows == kRows ? four : one;
  *grid = (N + ln_rows - 1) / ln_rows;
  return true;
}
int row_blocks(int N) { return (N + kWarps - 1) / kWarps; }  // a warp a row

bool bad_shape(int N, int H, int F) { return N < 1 || H != kH || F < kFc || F % kFc; }

// splits must cut F into equal parts of at least kMinSteps stages
bool bad_splits(int F, int splits) {
  return splits < 1 || (F / kBK) % splits || F / kBK / splits < kMinSteps;
}

cudaError_t launch_ffn_fwd(const float* x, const float* w1t, const float* b1, const float* w2t,
                           const float* b2, const float* sc, const float* bi, float* out,
                           float* pre, float* s, bool block, int N, int F, float eps,
                           Dropout drop, cudaStream_t stream) {
  static std::atomic<bool> done[2][kMaxDevices];
  const auto kernel = block ? ffn_block_fwd_kernel : ffn_fwd_kernel;
  const cudaError_t err = opt_in(kernel, kFfnSmemCc, done[block]);
  if (err != cudaSuccess) return err;
  kernel<<<blocks(N), kThreads, kFfnSmemCc, stream>>>(x, w1t, b1, w2t, b2, sc, bi, out, pre, s,
                                                      N, F, eps, drop);
  return cudaGetLastError();
}

cudaError_t launch_ffn_bwd(const float* pre, const float* g, const float* w1, const float* w2,
                           const float* s, const float* sc, float* dx, float* dpre, float* h,
                           float* dffn, float* dsc, float* dbi, bool block, int N, int F,
                           float eps, Dropout drop, cudaStream_t stream) {
  static std::atomic<bool> done[2][kMaxDevices];
  const auto kernel = block ? ffn_block_bwd_kernel : ffn_bwd_kernel;
  const cudaError_t err = opt_in(kernel, kFfnSmemCc, done[block]);
  if (err != cudaSuccess) return err;
  kernel<<<blocks(N), kThreads, kFfnSmemCc, stream>>>(pre, g, w1, w2, s, sc, dx, dpre, h, dffn,
                                                      dsc, dbi, N, F, eps, drop);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver-API function, fetched through the runtime
// so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major bf16 [rows, cols] matrix in boxes of box_cols
// (64: 128 bytes) by box_rows, 128-byte swizzled; rows past the end read as
// zeros and are not written.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static std::atomic<int> count[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && count[dev].load(std::memory_order_acquire)) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) count[dev].store(n, std::memory_order_release);
  return n;
}

// C = A B^T through `kernel`: A [M, K] and B [N, K] bf16, row-major; the
// epilogue's bf16 outputs e.out and e.h ([M, N]) stored, and its inputs
// (kDGelu: pre; kDx: s, g) loaded through TMA.
template <typename Kernel>
cudaError_t launch_gemm(Kernel kernel, std::atomic<bool>* done, const void* a, const void* b,
                        int M, int N, int K, int splits, const EpiArgs& e, cudaStream_t stream) {
  GemmMaps m{};
  const auto map = [&](CUtensorMap* t, const void* p, int rows, int cols, int box_rows) {
    return !p || tensor_map(t, p, rows, cols, 64, box_rows);
  };
  if (!map(&m.a, a, M, K, kBM) || !map(&m.b, b, N, K, kBN) || !map(&m.out, e.out, M, N, 64) ||
      !map(&m.h, e.h, M, N, 64) || !map(&m.in0, e.pre ? e.pre : e.stats ? e.s : nullptr, M, N, 64) ||
      !map(&m.in1, e.stats ? e.g : nullptr, M, N, 64)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = opt_in(kernel, kGemmSmem, done);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN) * splits, sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  kernel<<<tiles < sms ? tiles : sms, kGemmThreads, kGemmSmem, stream>>>(m, M, N, K, splits, e);
  return cudaGetLastError();
}

// The GEMM kernels by name: #3's and #4's forward (kBias, kPartial) and
// backward (kDGelu, kDx, kPartial), #5's forward (kBias) and backward (kDx
// without the ds term).
enum GemmName { kFfnFwd, kFfnBwd, kDenseFwd, kDenseBwd };

template <int kName, int kEpi>
cudaError_t gemm(const void* a, const void* b, int M, int N, int K, int splits, const EpiArgs& e,
                 cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  if constexpr (kName == kFfnFwd) {
    return launch_gemm(ffn_fwd_gemm_kernel<kEpi>, done, a, b, M, N, K, splits, e, stream);
  } else if constexpr (kName == kFfnBwd) {
    return launch_gemm(ffn_bwd_gemm_kernel<kEpi>, done, a, b, M, N, K, splits, e, stream);
  } else if constexpr (kName == kDenseFwd) {
    return launch_gemm(dense_fwd_gemm_kernel<kEpi>, done, a, b, M, N, K, splits, e, stream);
  } else {
    return launch_gemm(dense_bwd_gemm_kernel<kEpi>, done, a, b, M, N, K, splits, e, stream);
  }
}


// part[0] = the sum of the splits' partials, in split order (none to add at one)
cudaError_t sum_splits(float* part, int splits, int N, cudaStream_t st) {
  if (splits == 1) return cudaSuccess;
  const long long count = static_cast<long long>(N) * kH;
  sum_splits_kernel<<<static_cast<unsigned>((count / 4 + kThreads - 1) / kThreads), kThreads, 0,
                      st>>>(part, splits, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry below that drops takes `key`, the device address of the 64-bit
// Philox key (read by the kernels' draws, so a CUDA graph that captured the
// launch draws the key written there before each replay; null without
// dropout).

// Rows a block owns in the backwards' LayerNorm: their dscale/dbias
// partials are [ceil(N / rows), H] f32, the row statistics [that many
// blocks x rows, 4] f32.
int univl_ffn_block_rows() { return kRows; }

// #3 (block = 0) or #4 (block = 1) forward in f32 on CUDA cores. x: [N, H];
// w1t: [F, H] (W1 transposed, as nn.Linear stores it); b1: [F]; w2t: [H, F];
// b2: [H]; all contiguous, 16-byte aligned. ln_scale, ln_bias: [H] (#4). out
// like x; pre [N, F] and s like x: written when not null (pre: #3's save
// variant and #4; s: #4). H must be 768 and F a multiple of 256. Launches on
// `stream`, returns cudaGetLastError().
int univl_ffn_fwd(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
                  const void* ln_scale, const void* ln_bias, void* out, void* pre, void* s,
                  int block, int N, int H, int F, float eps, unsigned int threshold,
                  float inv_keep, int dropout_on, const void* key, void* stream) {
  if (bad_shape(N, H, F)) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return static_cast<int>(launch_ffn_fwd(
      f(x), f(w1t), f(b1), f(w2t), f(b2), f(ln_scale), f(ln_bias), static_cast<float*>(out),
      static_cast<float*>(pre), static_cast<float*>(s), block, N, F, eps,
      univl::dropout_of(key, threshold, inv_keep, dropout_on),
      static_cast<cudaStream_t>(stream)));
}

// #3 (block = 0) or #4 (block = 1) backward in f32 on CUDA cores. pre: [N,
// F] from the forward; g: the output gradient like x; w1: [H, F], w2: [F, H]
// (the JAX layout); s and ln_scale (#4): the forward's LayerNorm input and
// scale. Writes dx like x, dpre and h [N, F], and for #4 dffn like x and the
// partials dscale_p, dbias_p (f32 [ceil(N / 32), H]).
int univl_ffn_bwd(const void* pre, const void* g, const void* w1, const void* w2, const void* s,
                  const void* ln_scale, void* dx, void* dpre, void* h, void* dffn,
                  void* dscale_p, void* dbias_p, int block, int N, int H, int F, float eps,
                  unsigned int threshold, float inv_keep, int dropout_on,
                  const void* key, void* stream) {
  if (bad_shape(N, H, F)) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(launch_ffn_bwd(
      f(pre), f(g), f(w1), f(w2), f(s), f(ln_scale), o(dx), o(dpre), o(h), o(dffn), o(dscale_p),
      o(dbias_p), block, N, F, eps, univl::dropout_of(key, threshold, inv_keep, dropout_on),
      static_cast<cudaStream_t>(stream)));
}

// #3 (block = 0) or #4 (block = 1) forward in bf16: x W1 with the bias and
// GELU epilogue (pre, when not null, and h: [N, F], h scratch), then h W2:
// with splits = 1 y = round(round(h W2) + b2) from its epilogue, else split
// `splits` ways along F into part (f32 [splits, N, H]) and summed by the row
// kernel; for #4 the row kernel then drops, adds x and normalizes (s written
// when not null). part is needed only where split.
// Arguments otherwise as univl_ffn_fwd's; splits must cut F / 64 into equal
// parts of at least 4.
int univl_ffn_fwd_tc(const void* x, const void* w1t, const void* b1, const void* w2t,
                     const void* b2, const void* ln_scale, const void* ln_bias, void* out,
                     void* pre, void* s, void* h, void* part, int block, int N, int H, int F,
                     int splits, float eps, unsigned int threshold, float inv_keep,
                     int dropout_on, const void* key, void* stream) {
  if (bad_shape(N, H, F) || bad_splits(F, splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EpiArgs e{};
  e.out = static_cast<bf16*>(pre);
  e.h = static_cast<bf16*>(h);
  e.bias = static_cast<const bf16*>(b1);
  cudaError_t err = gemm<kFfnFwd, kBias>(x, w1t, N, F, kH, 1, e, st);  // pre, h
  if (err != cudaSuccess) return static_cast<int>(err);
  e = EpiArgs{};
  const Dropout drop = univl::dropout_of(key, threshold, inv_keep, dropout_on);
  const auto rows = block ? ffn_fwd_rows_kernel<true> : ffn_fwd_rows_kernel<false>;
  if (splits == 1) {  // y from the GEMM's epilogue; #4 then its rows in place
    e.out = static_cast<bf16*>(out);
    e.bias = static_cast<const bf16*>(b2);
    err = gemm<kFfnFwd, kBias>(h, w2t, N, kH, F, 1, e, st);
    if (err != cudaSuccess || !block) return static_cast<int>(err);
    splits = 0;
  } else {
    e.part = static_cast<float*>(part);
    err = gemm<kFfnFwd, kPartial>(h, w2t, N, kH, F, splits, e, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rows<<<row_blocks(N), kThreads, 0, st>>>(
      static_cast<const float*>(part), splits, static_cast<const bf16*>(b2),
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<bf16*>(out), static_cast<bf16*>(s), N,
      eps, drop);
  return static_cast<int>(cudaGetLastError());
}

// #3 (block = 0) or #4 (block = 1) backward in bf16: for #4 first the
// LayerNorm backward at ln_rows (32 or 8) rows a block (dffn, the row
// statistics stats [ceil(N / 32) x 32, 4] f32 and the partials, f32
// [ceil(N / ln_rows), H] each); then (dffn or g) W2^T with the GELU-gradient
// epilogue (dpre, h), then dpre W1^T split `splits` ways along F, with ds
// added for #4 (from the GEMM's epilogue when splits = 1, else through part,
// f32 [splits, N, H], and a row kernel). Arguments otherwise as
// univl_ffn_bwd's.
int univl_ffn_bwd_tc(const void* pre, const void* g, const void* w1, const void* w2,
                     const void* s, const void* ln_scale, void* dx, void* dpre, void* h,
                     void* dffn, void* dscale_p, void* dbias_p, void* stats, void* part,
                     int block, int N, int H, int F, int splits, int ln_rows, float eps,
                     unsigned int threshold, float inv_keep, int dropout_on,
                     const void* key, void* stream) {
  if (bad_shape(N, H, F) || bad_splits(F, splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* sv = static_cast<const bf16*>(s);
  const bf16* gv = static_cast<const bf16*>(g);
  const float* sc = static_cast<const float*>(ln_scale);
  float* stv = block ? static_cast<float*>(stats) : nullptr;
  if (block) {
    auto head = ffn_bwd_ln_kernel<kRowsPerWarp>;
    int grid = 0;
    if (!ln_head(ffn_bwd_ln_kernel<kRowsPerWarp>, ffn_bwd_ln_kernel<1>, ln_rows, N, &head, &grid)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    head<<<grid, kThreads, 0, st>>>(sv, gv, sc, static_cast<bf16*>(dffn), stv,
                                    static_cast<float*>(dscale_p), static_cast<float*>(dbias_p),
                                    N, eps, univl::dropout_of(key, threshold, inv_keep, dropout_on));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  EpiArgs e{};
  e.out = static_cast<bf16*>(dpre);
  e.h = static_cast<bf16*>(h);
  e.pre = static_cast<const bf16*>(pre);
  cudaError_t err = gemm<kFfnBwd, kDGelu>(block ? dffn : g, w2, N, F, kH, 1, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  e = EpiArgs{};
  if (splits == 1) {
    e.out = static_cast<bf16*>(dx);
    e.s = sv;
    e.g = gv;
    e.scale = sc;
    e.stats = stv;
    return static_cast<int>(gemm<kFfnBwd, kDx>(dpre, w1, N, kH, F, 1, e, st));
  }
  e.part = static_cast<float*>(part);
  err = gemm<kFfnBwd, kPartial>(dpre, w1, N, kH, F, splits, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_rows_kernel<<<row_blocks(N), kThreads, 0, st>>>(static_cast<const float*>(part),
                                                          splits, sv, gv, sc, stv,
                                                          static_cast<bf16*>(dx), N);
  return static_cast<int>(cudaGetLastError());
}

// #5 forward in f32 on CUDA cores. x (the product's input), r (the
// residual): [N, H]; wt: [H, H] (W transposed, as nn.Linear stores it); b:
// [H]; ln_scale, ln_bias [H]; all f32. out like x; s like x when not null.
int univl_dense_block_fwd(const void* x, const void* r, const void* wt, const void* b,
                          const void* ln_scale, const void* ln_bias, void* out, void* s, int N,
                          int H, float eps, unsigned int threshold, float inv_keep,
                          int dropout_on, const void* key, void* stream) {
  if (bad_shape(N, H, kFc)) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = opt_in(dense_block_fwd_kernel, kDenseSmemCc, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  dense_block_fwd_kernel<<<blocks(N), kThreads, kDenseSmemCc, static_cast<cudaStream_t>(stream)>>>(
      f(x), f(r), f(wt), f(b), f(ln_scale), f(ln_bias), static_cast<float*>(out),
      static_cast<float*>(s), N, eps, univl::dropout_of(key, threshold, inv_keep, dropout_on));
  return static_cast<int>(cudaGetLastError());
}

// #5 backward in f32 on CUDA cores. s: the forward's LayerNorm input; g: the
// output gradient; w: [H, H] (the JAX layout); ln_scale as in the forward.
// Writes dx, dy (the dense output's gradient), dr (the residual's) like x,
// and the partials dscale_p, dbias_p (f32 [ceil(N / 32), H]).
int univl_dense_block_bwd(const void* s, const void* g, const void* w, const void* ln_scale,
                          void* dx, void* dy, void* dr, void* dscale_p, void* dbias_p, int N,
                          int H, float eps, unsigned int threshold, float inv_keep,
                          int dropout_on, const void* key, void* stream) {
  if (bad_shape(N, H, kFc)) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = opt_in(dense_block_bwd_kernel, kDenseSmemCc, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  dense_block_bwd_kernel<<<blocks(N), kThreads, kDenseSmemCc, static_cast<cudaStream_t>(stream)>>>(
      f(s), f(g), f(w), f(ln_scale), o(dx), o(dy), o(dr), o(dscale_p), o(dbias_p), N, eps,
      univl::dropout_of(key, threshold, inv_keep, dropout_on));
  return static_cast<int>(cudaGetLastError());
}

// #5 forward in bf16: x W on the wgmma GEMM, whose epilogue writes y =
// round(round(x W) + b) into out, then the rows kernel: y dropped, r added,
// normalized (in place over y; s written when not null). Arguments as
// univl_dense_block_fwd's, in bf16.
int univl_dense_block_fwd_tc(const void* x, const void* r, const void* wt, const void* b,
                             const void* ln_scale, const void* ln_bias, void* out, void* s,
                             int N, int H, float eps, unsigned int threshold, float inv_keep,
                             int dropout_on, const void* key, void* stream) {
  if (bad_shape(N, H, kFc)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EpiArgs e{};
  e.out = static_cast<bf16*>(out);
  e.bias = static_cast<const bf16*>(b);
  const cudaError_t err = gemm<kDenseFwd, kBias>(x, wt, N, kH, kH, 1, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_fwd_rows_kernel<<<row_blocks(N), kThreads, 0, st>>>(
      static_cast<const bf16*>(r), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<bf16*>(out), static_cast<bf16*>(s), N, eps,
      univl::dropout_of(key, threshold, inv_keep, dropout_on));
  return static_cast<int>(cudaGetLastError());
}

// #5 backward in bf16: the LayerNorm head at ln_rows (32 or 8) rows a block
// (dy, dr and the partials, f32 [ceil(N / ln_rows), H] each), then dx =
// round(dy W^T) from the wgmma GEMM's epilogue. Arguments otherwise as
// univl_dense_block_bwd's, in bf16.
int univl_dense_block_bwd_tc(const void* s, const void* g, const void* w, const void* ln_scale,
                             void* dx, void* dy, void* dr, void* dscale_p, void* dbias_p, int N,
                             int H, int ln_rows, float eps, unsigned int threshold,
                             float inv_keep, int dropout_on, const void* key,
                             void* stream) {
  if (bad_shape(N, H, kFc)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto head = dense_bwd_ln_kernel<kRowsPerWarp>;
  int grid = 0;
  if (!ln_head(dense_bwd_ln_kernel<kRowsPerWarp>, dense_bwd_ln_kernel<1>, ln_rows, N, &head,
               &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  head<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(s), static_cast<const bf16*>(g),
      static_cast<const float*>(ln_scale), static_cast<bf16*>(dy), static_cast<bf16*>(dr),
      static_cast<float*>(dscale_p), static_cast<float*>(dbias_p), N, eps,
      univl::dropout_of(key, threshold, inv_keep, dropout_on));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  EpiArgs e{};
  e.out = static_cast<bf16*>(dx);
  return static_cast<int>(gemm<kDenseBwd, kDx>(dy, w, N, kH, kH, 1, e, st));
}


// ---------------------------------------------------------------- the split halves
// (tensor parallelism, bf16): a rank's share of the depth, then the rows


// #3's and #4's forward GEMMs over a rank's F columns of W1 (and rows of
// W2): x W1 with the bias and GELU epilogue (pre when not null, h), then
// h W2 into part (f32 [splits, N, H]), split `splits` ways along F and summed
// into part[0]: the rank's partial of y before the bias. x: [N, H]; w1t:
// [F, H]; b1: [F]; w2t: [H, F]; all bf16.
int univl_ffn_fwd_part_tc(const void* x, const void* w1t, const void* b1, const void* w2t,
                          void* pre, void* h, void* part, int N, int H, int F, int splits,
                          void* stream) {
  if (bad_shape(N, H, F) || bad_splits(F, splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EpiArgs e{};
  e.out = static_cast<bf16*>(pre);
  e.h = static_cast<bf16*>(h);
  e.bias = static_cast<const bf16*>(b1);
  cudaError_t err = gemm<kFfnFwd, kBias>(x, w1t, N, F, kH, 1, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  e = EpiArgs{};
  e.part = static_cast<float*>(part);
  err = gemm<kFfnFwd, kPartial>(h, w2t, N, kH, F, splits, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_splits(static_cast<float*>(part), splits, N, st));
}

// #5's forward GEMM over a rank's K input columns: part = x W (f32 [N, H]),
// x: [N, K]; wt: [H, K] (the rank's columns of nn.Linear's weight); K a
// multiple of 64.
int univl_dense_fwd_part_tc(const void* x, const void* wt, void* part, int N, int H, int K,
                            void* stream) {
  if (N < 1 || H != kH || K < kBK || K % kBK) return static_cast<int>(cudaErrorInvalidValue);
  EpiArgs e{};
  e.part = static_cast<float*>(part);
  return static_cast<int>(
      gemm<kDenseFwd, kPartial>(x, wt, N, kH, K, 1, e, static_cast<cudaStream_t>(stream)));
}

// The forward rows after the reduce, over the N rows a rank holds: y =
// round(round(part) + b); kind 3 (#3) writes y to out; kind 4 (#4) and 5
// (#5) drop it with their tag at rows row0 + [0, N), add res and normalize
// (s written when not null). part: f32 [N, H]; b: bf16 [H]; res, out, s:
// bf16 [N, H]; ln_scale, ln_bias: f32 [H].
int univl_split_rows_tc(const void* part, const void* b, const void* res, const void* ln_scale,
                        const void* ln_bias, void* out, void* s, int N, int H, int kind,
                        float eps, unsigned int threshold, float inv_keep, int dropout_on,
                        const void* key, int row0, void* stream) {
  if (N < 1 || H != kH || kind < 3 || kind > 5) return static_cast<int>(cudaErrorInvalidValue);
  const auto rows = kind == 3 ? split_rows_kernel<false> : split_rows_kernel<true>;
  rows<<<row_blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(b), static_cast<const bf16*>(res),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<bf16*>(out), static_cast<bf16*>(s), N, eps,
      univl::dropout_of(key, threshold, inv_keep, dropout_on, row0),
      kind == 5 ? kDenseBlockTag : kFfnBlockTag);
  return static_cast<int>(cudaGetLastError());
}

// A backward's LayerNorm head over the N rows a rank holds (rows row0 + [0,
// N) of the call, for the dropout counter), at ln_rows (32 or 8) rows a
// block: kind 4 (#4) writes dropped (dffn) and stats ([ceil(N / 32) x 32,
// 4] f32), kind 5 (#5) dropped (dy) and dr; both the dscale/dbias partials
// (f32 [ceil(N / ln_rows), H]).
int univl_block_bwd_ln_tc(int kind, const void* s, const void* g, const void* ln_scale,
                          void* dropped, void* dr, void* stats, void* dscale_p, void* dbias_p,
                          int N, int H, int ln_rows, float eps, unsigned int threshold,
                          float inv_keep, int dropout_on, const void* key, int row0,
                          void* stream) {
  if (N < 1 || H != kH || (kind != 4 && kind != 5)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop = univl::dropout_of(key, threshold, inv_keep, dropout_on, row0);
  const bf16* sv = static_cast<const bf16*>(s);
  const bf16* gv = static_cast<const bf16*>(g);
  const float* sc = static_cast<const float*>(ln_scale);
  float* dsc = static_cast<float*>(dscale_p);
  float* dbi = static_cast<float*>(dbias_p);
  int grid = 0;
  if (kind == 4) {
    auto head = ffn_bwd_ln_kernel<kRowsPerWarp>;
    if (!ln_head(ffn_bwd_ln_kernel<kRowsPerWarp>, ffn_bwd_ln_kernel<1>, ln_rows, N, &head, &grid)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    head<<<grid, kThreads, 0, st>>>(sv, gv, sc, static_cast<bf16*>(dropped),
                                    static_cast<float*>(stats), dsc, dbi, N, eps, drop);
  } else {
    auto head = dense_bwd_ln_kernel<kRowsPerWarp>;
    if (!ln_head(dense_bwd_ln_kernel<kRowsPerWarp>, dense_bwd_ln_kernel<1>, ln_rows, N, &head,
                 &grid)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    head<<<grid, kThreads, 0, st>>>(sv, gv, sc, static_cast<bf16*>(dropped),
                                    static_cast<bf16*>(dr), dsc, dbi, N, eps, drop);
  }
  return static_cast<int>(cudaGetLastError());
}

// #3's and #4's backward GEMMs over a rank's F: (dffn or g) W2^T with the
// GELU-gradient epilogue (dpre, h: [N, F]), then dpre W1^T into part (f32
// [splits, N, H], summed into part[0]). g: [N, H] (every row of the call);
// pre: [N, F]; w1: [H, F], w2: [F, H] (the JAX layout, the rank's share).
int univl_ffn_bwd_part_tc(const void* pre, const void* g, const void* w1, const void* w2,
                          void* dpre, void* h, void* part, int N, int H, int F, int splits,
                          void* stream) {
  if (bad_shape(N, H, F) || bad_splits(F, splits)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EpiArgs e{};
  e.out = static_cast<bf16*>(dpre);
  e.h = static_cast<bf16*>(h);
  e.pre = static_cast<const bf16*>(pre);
  cudaError_t err = gemm<kFfnBwd, kDGelu>(g, w2, N, F, kH, 1, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  e = EpiArgs{};
  e.part = static_cast<float*>(part);
  err = gemm<kFfnBwd, kPartial>(dpre, w1, N, kH, F, splits, e, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_splits(static_cast<float*>(part), splits, N, st));
}

// The backward rows after the reduce, over the N rows a rank holds: dx =
// round(part + ds), ds from the LayerNorm head's row statistics (#4), or dx
// = round(part) with stats null (#3). s, g: the rank's rows of the
// LayerNorm's input and of the output gradient (#4).
int univl_ffn_bwd_rows_tc(const void* part, const void* s, const void* g, const void* ln_scale,
                          const void* stats, void* dx, int N, int H, void* stream) {
  if (N < 1 || H != kH) return static_cast<int>(cudaErrorInvalidValue);
  ffn_bwd_rows_kernel<<<row_blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), 1, static_cast<const bf16*>(s),
      static_cast<const bf16*>(g), static_cast<const float*>(ln_scale),
      static_cast<const float*>(stats), static_cast<bf16*>(dx), N);
  return static_cast<int>(cudaGetLastError());
}

// #5's dx over a rank's K input columns: dx = round(dy W^T), dy: [N, H] (every
// row of the call); w: [K, H] (the JAX layout, the rank's rows); dx: [N, K],
// K a multiple of 64 (the last column tile may run past K).
int univl_dense_bwd_dx_tc(const void* dy, const void* w, void* dx, int N, int H, int K,
                          void* stream) {
  if (N < 1 || H != kH || K < kBK || K % kBK) return static_cast<int>(cudaErrorInvalidValue);
  EpiArgs e{};
  e.out = static_cast<bf16*>(dx);
  return static_cast<int>(
      gemm<kDenseBwd, kDx>(dy, w, N, K, kH, 1, e, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
