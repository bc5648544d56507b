// Training attention for the PyTorch port, hand-written for Hopper (sm_90a):
// a forward and a backward kernel with in-kernel dropout of the attention
// probabilities.
//
// Replaces the Pallas TPU kernels of univl_tpu/kernels/train_attention.py:
// _attn_train_fwd_kernel (called from _fwd_call) and _attn_train_bwd_kernel
// (called from _ft_attn_bwd), the two halves of fused_train_attention.
//
// Forward, per (batch row b, head h), inputs the dense [B, L, H*D] projections:
//   s = q k^T / sqrt(D) + (1 - key_mask) * -1e9           (f32)
//   m = rowmax(s), l = rowsum(exp(s - m)), p = exp(s - m) / l
//   p = keep ? p / (1 - rate) : 0                        (dropout)
//   out = round(p) v, summed in f32                       (round: to the input type)
// and m, l are written ([B, H, Lq] f32) for the backward, which recomputes
//   p = exp(s - m) / l, the same keep mask,
//   dp = keep ? (g v^T) / (1 - rate) : 0,  dv = round(p_dropped)^T g,
//   ds = round(p * (dp - rowsum(dp * p))),  dq = (ds k) * scale, dk = (ds^T q) * scale
// with the TPU kernels' rounding points (train_attention.py:140-172).
//
// Dropout bits: counter-based Philox4x32-10 (philox.cuh). Element (b, h, i, j) is kept
// where word j % 4 of Philox(counter = (j / 4, i, h, b), key = seed) is at
// least rate * 2^32. The mask is a pure function of (seed, b, h, i, j), so the
// forward, the backward and the plain PyTorch version
// (univl_tpu_torch/kernels/train_attention.py) regenerate it bit for bit.
// The TPU kernels' bits (pltpu.prng_random_bits) cannot be reproduced; the
// distribution is the same.
//
// What bounds it: at UniVL's lengths (L <= 224, D = 64) one (b, h) does
// ~4 L^2 D flops forward and ~10 L^2 D backward over ~4-7 L D * 2 bytes: far
// below the H100's ~295 flop/byte ridge, so the work is bound by memory
// traffic and, at FT-Joint's 3-5 us per call, by launch latency and occupancy.
//
// What the design does about it: every input byte is read from device memory
// once and the [Lq, Lk] scores, probabilities and dropout bits never leave
// the SM. One block owns one (b, h): it stages that head's rows in shared
// memory (16-byte loads, rows padded to D + 4 floats so the lanes of a
// quarter-warp reading different rows hit distinct banks). Forward: each
// warp takes query rows in turn, one key per lane, as in attention.cu.
// Backward: the warps fill the block's [Lq, Lk] tiles of dropped
// probabilities and ds, then every thread computes four adjacent columns of
// dq, dk and dv with fixed-order sums: no atomics, so the result is
// deterministic. One Philox call gives the keep bits of four keys. A head
// that does not fit the block's shared memory (Lq = Lk = 128 needs 283 KB,
// the caption cross tower's 224 positions 668 KB; the card gives 227 KB)
// takes the tiled backward below: 32-row tiles of queries and keys, two
// kernels, the same arithmetic. Tensor-core products (mma.sync / wgmma) and
// TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "philox.cuh"

namespace {

using univl::Dropout;
using univl::philox4x32_10;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskBias = -1e9f;  // univl_tpu/kernels/train_attention.py:93

struct Shape {
  int H, Lq, Lk, D;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the TPU kernels' astype(compute dtype) points
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// The warp's keep factors for query row i of (b, h) and keys [j0, j0 + n):
// kw[j - j0] = 1/(1-rate) where key j is kept, 0 where it is dropped. One
// Philox call per four keys; j0 is a multiple of 4.
__device__ __forceinline__ void keep_row(float* kw, const Dropout& drop, int b, int h, int i,
                                         int j0, int n, int lane) {
  for (int c = lane; 4 * c < n; c += 32) {
    const uint4 w = philox4x32_10(make_uint4(j0 / 4 + c, i, h, b), drop.seed);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      kw[4 * c + t] = words[t] >= drop.threshold ? drop.inv_keep : 0.0f;
    }
  }
}

// Rows [0, L) of one head of a dense [., L, H*D] tensor into f32 shared memory
// rows of `stride` floats, with 16-byte loads.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int L, int D, long long row,
                                      int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = D / kVec;
  for (int c = threadIdx.x; c < L * chunks; c += kThreads) {
    const int j = c / chunks;
    const int d0 = (c % chunks) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + j * row + d0);
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < kVec; ++t) dst[j * stride + d0 + t] = to_float(x[t]);
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.0f;
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = a4[d4];
    const float4 y = b4[d4];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<__nv_bfloat162*>(p)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(p)[1] = hi;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float* x) {
  const float4 v = *reinterpret_cast<const float4*>(x);
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
train_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ key_mask,
                           T* __restrict__ out, float* __restrict__ m_out,
                           float* __restrict__ l_out, Shape sh, Dropout drop) {
  extern __shared__ float smem[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk, D = sh.D;
  const int stride = D + 4;
  const int lk4 = (Lk + 3) & ~3;
  float* ks = smem;                 // [Lk][D + 4]
  float* vs = ks + Lk * stride;     // [Lk][D]
  float* qs = vs + Lk * D;          // [kWarps][D]
  float* ps = qs + kWarps * D;      // [kWarps][lk4] probabilities
  float* kp = ps + kWarps * lk4;    // [kWarps][lk4] keep factors
  float* bias = kp + kWarps * lk4;  // [Lk]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long row = static_cast<long long>(H) * D;
  stage(ks, k + b * Lk * row + h * D, Lk, D, row, stride);
  stage(vs, v + b * Lk * row + h * D, Lk, D, row, D);
  for (int j = threadIdx.x; j < Lk; j += kThreads) {
    bias[j] = (1.0f - key_mask[static_cast<long long>(b) * Lk + j]) * kMaskBias;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = qs + warp * D;
  float* pw = ps + warp * lk4;
  float* kw = kp + warp * lk4;
  for (int i = warp; i < Lq; i += kWarps) {
    const T* qrow = q + (b * Lq + i) * row + h * D;
    for (int d = lane; d < D; d += 32) qw[d] = to_float(qrow[d]);
    if (drop.on) keep_row(kw, drop, b, h, i, 0, Lk, lane);
    __syncwarp();

    float row_max = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float s = dot(qw, ks + j * stride, D) * sh.scale + bias[j];
      pw[j] = s;
      row_max = fmaxf(row_max, s);
    }
    row_max = warp_max(row_max);
    float row_sum = 0.0f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pw[j] - row_max);
      pw[j] = e;
      row_sum += e;
    }
    row_sum = warp_sum(row_sum);
    if (lane == 0) {
      const long long stat = (static_cast<long long>(b) * H + h) * Lq + i;
      m_out[stat] = row_max;
      l_out[stat] = row_sum;
    }
    for (int j = lane; j < Lk; j += 32) {
      float p = pw[j] / row_sum;
      if (drop.on) p = p * kw[j];
      pw[j] = round_to<T>(p);
    }
    __syncwarp();

    T* orow = out + (b * Lq + i) * row + h * D;
    for (int d2 = lane; d2 < D / 2; d2 += 32) {
      const float* vcol = vs + 2 * d2;
      float ax = 0.0f, ay = 0.0f;
      for (int j = 0; j < Lk; ++j) {
        const float2 vj = *reinterpret_cast<const float2*>(vcol + j * D);
        ax = fmaf(pw[j], vj.x, ax);
        ay = fmaf(pw[j], vj.y, ay);
      }
      orow[2 * d2] = from_float<T>(ax);
      orow[2 * d2 + 1] = from_float<T>(ay);
    }
    __syncwarp();  // qw, pw and kw are rewritten for the warp's next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
train_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ key_mask,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
                           T* __restrict__ dv, Shape sh, Dropout drop) {
  extern __shared__ float smem[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk, D = sh.D;
  const int stride = D + 4;
  const int lk4 = (Lk + 3) & ~3;
  float* qs = smem;                 // [Lq][D + 4]
  float* gs = qs + Lq * stride;     // [Lq][D + 4]
  float* ks = gs + Lq * stride;     // [Lk][D + 4]
  float* vs = ks + Lk * stride;     // [Lk][D + 4]
  float* P = vs + Lk * stride;      // [Lq][lk4] dropped probabilities, rounded
  float* S = P + Lq * lk4;          // [Lq][lk4] ds, rounded
  float* ps = S + Lq * lk4;         // [kWarps][lk4] probabilities of the warp's row
  float* dps = ps + kWarps * lk4;   // [kWarps][lk4] dp of the warp's row
  float* kp = dps + kWarps * lk4;   // [kWarps][lk4] keep factors
  float* bias = kp + kWarps * lk4;  // [Lk]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const long long row = static_cast<long long>(H) * D;
  stage(qs, q + b * Lq * row + h * D, Lq, D, row, stride);
  stage(gs, g + b * Lq * row + h * D, Lq, D, row, stride);
  stage(ks, k + b * Lk * row + h * D, Lk, D, row, stride);
  stage(vs, v + b * Lk * row + h * D, Lk, D, row, stride);
  for (int j = threadIdx.x; j < Lk; j += kThreads) {
    bias[j] = (1.0f - key_mask[static_cast<long long>(b) * Lk + j]) * kMaskBias;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* pw = ps + warp * lk4;
  float* dw = dps + warp * lk4;
  float* kw = kp + warp * lk4;
  for (int i = warp; i < Lq; i += kWarps) {
    const long long stat = (static_cast<long long>(b) * H + h) * Lq + i;
    const float mi = m_in[stat], li = l_in[stat];
    if (drop.on) keep_row(kw, drop, b, h, i, 0, Lk, lane);
    __syncwarp();
    float acc = 0.0f;
    for (int j = lane; j < Lk; j += 32) {
      const float s = dot(qs + i * stride, ks + j * stride, D) * sh.scale + bias[j];
      const float p = expf(s - mi) / li;  // the forward's probability, bit for bit
      float dp = dot(gs + i * stride, vs + j * stride, D);
      float pd = p;
      if (drop.on) {
        pd = p * kw[j];
        dp = dp * kw[j];
      }
      P[i * lk4 + j] = round_to<T>(pd);
      pw[j] = p;
      dw[j] = dp;
      acc += dp * p;
    }
    const float rowsum = warp_sum(acc);
    for (int j = lane; j < Lk; j += 32) {
      S[i * lk4 + j] = round_to<T>(pw[j] * (dw[j] - rowsum));
    }
    __syncwarp();  // pw, dw and kw are rewritten for the warp's next row
  }
  __syncthreads();

  // four adjacent output columns per thread; sums over i or j in ascending order
  const int quads = D / 4;
  for (int t = threadIdx.x; t < Lq * quads; t += kThreads) {
    const int i = t / quads;
    const int d0 = 4 * (t % quads);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < Lk; ++j) fma4(acc, S[i * lk4 + j], ks + j * stride + d0);
    store4(dq + (b * Lq + i) * row + h * D + d0, scaled(acc, sh.scale));
  }
  for (int t = threadIdx.x; t < Lk * quads; t += kThreads) {
    const int j = t / quads;
    const int d0 = 4 * (t % quads);
    float4 ak = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 av = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < Lq; ++i) {
      fma4(ak, S[i * lk4 + j], qs + i * stride + d0);
      fma4(av, P[i * lk4 + j], gs + i * stride + d0);
    }
    const long long o = (b * Lk + j) * row + h * D + d0;
    store4(dk + o, scaled(ak, sh.scale));
    store4(dv + o, av);
  }
}

// The tiled backward, for heads the whole-head kernel cannot stage: the
// FlashAttention-2 split into two kernels over kTile-row tiles. The first,
// one block per (b, h, query tile), sums rowsum(dp * p) of its rows over all
// key tiles (written to `delta` for the second), then walks the key tiles
// again for ds and dq. The second, one block per (b, h, key tile), walks the
// query tiles for dk and dv. Each recomputes p from the forward's m and l and
// the keep bits from Philox, as the whole-head kernel does; every sum runs
// over i or j in ascending order, one accumulator per output element in
// shared memory, so the results are the whole-head kernel's arithmetic
// (rowsum's lane j % 32 sums keys j in ascending order there too).
constexpr int kTile = 32;              // one key a lane
constexpr int kRows = kTile / kWarps;  // query rows a warp owns in a tile: warp + kWarps t

template <typename T>
__global__ void __launch_bounds__(kThreads)
train_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ key_mask,
                              const float* __restrict__ m_in, const float* __restrict__ l_in,
                              const T* __restrict__ g, T* __restrict__ dq,
                              float* __restrict__ delta, Shape sh, Dropout drop) {
  extern __shared__ float smem[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk, D = sh.D;
  const int stride = D + 4;
  float* qs = smem;                   // [kTile][D + 4] the block's query rows
  float* gs = qs + kTile * stride;    // [kTile][D + 4] their output gradients
  float* ks = gs + kTile * stride;    // [kTile][D + 4] a tile of keys
  float* vs = ks + kTile * stride;    // [kTile][D + 4] and of values
  float* S = vs + kTile * stride;     // [kTile][kTile] ds, rounded
  float* acc = S + kTile * kTile;     // [kTile][D] dq sums
  float* kp = acc + kTile * D;        // [kWarps][kTile] keep factors
  float* bias = kp + kWarps * kTile;  // [kTile]
  float* rs = bias + kTile;           // [kTile] rowsum(dp * p)

  const int tiles = (Lq + kTile - 1) / kTile;
  const int b = blockIdx.x / tiles / H, h = blockIdx.x / tiles % H;
  const int i0 = (blockIdx.x % tiles) * kTile;
  const int nq = min(kTile, Lq - i0);
  const long long row = static_cast<long long>(H) * D;
  stage(qs, q + (static_cast<long long>(b) * Lq + i0) * row + h * D, nq, D, row, stride);
  stage(gs, g + (static_cast<long long>(b) * Lq + i0) * row + h * D, nq, D, row, stride);
  for (int t = threadIdx.x; t < kTile * D; t += kThreads) acc[t] = 0.0f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* kw = kp + warp * kTile;
  float part[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) part[t] = 0.0f;

  // the key tile j0 into ks, vs and bias; returns its row count
  auto stage_keys = [&](int j0) {
    const int nk = min(kTile, Lk - j0);
    __syncthreads();  // the previous tile's readers are done
    stage(ks, k + (static_cast<long long>(b) * Lk + j0) * row + h * D, nk, D, row, stride);
    stage(vs, v + (static_cast<long long>(b) * Lk + j0) * row + h * D, nk, D, row, stride);
    for (int j = threadIdx.x; j < nk; j += kThreads) {
      bias[j] = (1.0f - key_mask[static_cast<long long>(b) * Lk + j0 + j]) * kMaskBias;
    }
    __syncthreads();
    return nk;
  };

  for (int j0 = 0; j0 < Lk; j0 += kTile) {  // pass 1: rowsum(dp * p)
    const int nk = stage_keys(j0);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int r = warp + kWarps * t;
      if (r < nq) {
        const long long stat = (static_cast<long long>(b) * H + h) * Lq + i0 + r;
        if (drop.on) keep_row(kw, drop, b, h, i0 + r, j0, nk, lane);
        __syncwarp();
        if (lane < nk) {
          const float s = dot(qs + r * stride, ks + lane * stride, D) * sh.scale + bias[lane];
          const float p = expf(s - m_in[stat]) / l_in[stat];
          float dp = dot(gs + r * stride, vs + lane * stride, D);
          if (drop.on) dp = dp * kw[lane];
          part[t] += dp * p;
        }
        __syncwarp();  // kw is rewritten for the warp's next row
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int r = warp + kWarps * t;
    if (r < nq) {
      const float sum = warp_sum(part[t]);
      if (lane == 0) {
        rs[r] = sum;
        delta[(static_cast<long long>(b) * H + h) * Lq + i0 + r] = sum;
      }
    }
  }

  const int quads = D / 4;
  for (int j0 = 0; j0 < Lk; j0 += kTile) {  // pass 2: ds, then dq += ds k
    const int nk = stage_keys(j0);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int r = warp + kWarps * t;
      if (r < nq) {
        const long long stat = (static_cast<long long>(b) * H + h) * Lq + i0 + r;
        if (drop.on) keep_row(kw, drop, b, h, i0 + r, j0, nk, lane);
        __syncwarp();
        if (lane < nk) {
          const float s = dot(qs + r * stride, ks + lane * stride, D) * sh.scale + bias[lane];
          const float p = expf(s - m_in[stat]) / l_in[stat];
          float dp = dot(gs + r * stride, vs + lane * stride, D);
          if (drop.on) dp = dp * kw[lane];
          S[r * kTile + lane] = round_to<T>(p * (dp - rs[r]));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nq * quads; t += kThreads) {
      const int r = t / quads;
      const int d0 = 4 * (t % quads);
      float4 a = *reinterpret_cast<const float4*>(acc + r * D + d0);
      for (int j = 0; j < nk; ++j) fma4(a, S[r * kTile + j], ks + j * stride + d0);
      *reinterpret_cast<float4*>(acc + r * D + d0) = a;
    }
  }
  for (int t = threadIdx.x; t < nq * quads; t += kThreads) {  // each thread its own sums
    const int r = t / quads;
    const int d0 = 4 * (t % quads);
    store4(dq + (static_cast<long long>(b) * Lq + i0 + r) * row + h * D + d0,
           scaled(*reinterpret_cast<const float4*>(acc + r * D + d0), sh.scale));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
train_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const float* __restrict__ key_mask,
                                const float* __restrict__ m_in, const float* __restrict__ l_in,
                                const T* __restrict__ g, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, Shape sh, Dropout drop) {
  extern __shared__ float smem[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk, D = sh.D;
  const int stride = D + 4;
  float* ks = smem;                   // [kTile][D + 4] the block's keys
  float* vs = ks + kTile * stride;    // [kTile][D + 4] and values
  float* qs = vs + kTile * stride;    // [kTile][D + 4] a tile of query rows
  float* gs = qs + kTile * stride;    // [kTile][D + 4] and of output gradients
  float* P = gs + kTile * stride;     // [kTile][kTile] dropped probabilities, rounded
  float* S = P + kTile * kTile;       // [kTile][kTile] ds, rounded
  float* acck = S + kTile * kTile;    // [kTile][D] dk sums
  float* accv = acck + kTile * D;     // [kTile][D] dv sums
  float* kp = accv + kTile * D;       // [kWarps][kTile] keep factors
  float* bias = kp + kWarps * kTile;  // [kTile]

  const int tiles = (Lk + kTile - 1) / kTile;
  const int b = blockIdx.x / tiles / H, h = blockIdx.x / tiles % H;
  const int j0 = (blockIdx.x % tiles) * kTile;
  const int nk = min(kTile, Lk - j0);
  const long long row = static_cast<long long>(H) * D;
  stage(ks, k + (static_cast<long long>(b) * Lk + j0) * row + h * D, nk, D, row, stride);
  stage(vs, v + (static_cast<long long>(b) * Lk + j0) * row + h * D, nk, D, row, stride);
  for (int j = threadIdx.x; j < nk; j += kThreads) {
    bias[j] = (1.0f - key_mask[static_cast<long long>(b) * Lk + j0 + j]) * kMaskBias;
  }
  for (int t = threadIdx.x; t < kTile * D; t += kThreads) acck[t] = accv[t] = 0.0f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* kw = kp + warp * kTile;
  const int quads = D / 4;
  for (int i0 = 0; i0 < Lq; i0 += kTile) {
    const int nq = min(kTile, Lq - i0);
    __syncthreads();  // the previous tile's readers are done
    stage(qs, q + (static_cast<long long>(b) * Lq + i0) * row + h * D, nq, D, row, stride);
    stage(gs, g + (static_cast<long long>(b) * Lq + i0) * row + h * D, nq, D, row, stride);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int r = warp + kWarps * t;
      if (r < nq) {
        const long long stat = (static_cast<long long>(b) * H + h) * Lq + i0 + r;
        if (drop.on) keep_row(kw, drop, b, h, i0 + r, j0, nk, lane);
        __syncwarp();
        if (lane < nk) {
          const float s = dot(qs + r * stride, ks + lane * stride, D) * sh.scale + bias[lane];
          const float p = expf(s - m_in[stat]) / l_in[stat];
          float dp = dot(gs + r * stride, vs + lane * stride, D);
          float pd = p;
          if (drop.on) {
            pd = p * kw[lane];
            dp = dp * kw[lane];
          }
          P[r * kTile + lane] = round_to<T>(pd);
          S[r * kTile + lane] = round_to<T>(p * (dp - delta[stat]));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nk * quads; t += kThreads) {
      const int j = t / quads;
      const int d0 = 4 * (t % quads);
      float4 ak = *reinterpret_cast<const float4*>(acck + j * D + d0);
      float4 av = *reinterpret_cast<const float4*>(accv + j * D + d0);
      for (int r = 0; r < nq; ++r) {
        fma4(ak, S[r * kTile + j], qs + r * stride + d0);
        fma4(av, P[r * kTile + j], gs + r * stride + d0);
      }
      *reinterpret_cast<float4*>(acck + j * D + d0) = ak;
      *reinterpret_cast<float4*>(accv + j * D + d0) = av;
    }
  }
  for (int t = threadIdx.x; t < nk * quads; t += kThreads) {  // each thread its own sums
    const int j = t / quads;
    const int d0 = 4 * (t % quads);
    const long long o = (static_cast<long long>(b) * Lk + j0 + j) * row + h * D + d0;
    store4(dk + o, scaled(*reinterpret_cast<const float4*>(acck + j * D + d0), sh.scale));
    store4(dv + o, *reinterpret_cast<const float4*>(accv + j * D + d0));
  }
}

size_t fwd_smem_bytes(int Lq, int Lk, int D) {
  const size_t lk4 = (Lk + 3) & ~3;
  return (static_cast<size_t>(Lk) * (2 * D + 5) + kWarps * (D + 2 * lk4)) * sizeof(float);
}

size_t bwd_smem_bytes(int Lq, int Lk, int D) {
  const size_t lk4 = (Lk + 3) & ~3, stride = D + 4;
  return ((static_cast<size_t>(Lq) + Lk) * 2 * stride + Lq * 2 * lk4 + kWarps * 3 * lk4 + Lk) *
         sizeof(float);
}

// The larger of the tiled backward's two kernels (the dk/dv one), whatever Lq and Lk.
size_t tiled_smem_bytes(int D) {
  const size_t stride = D + 4;
  return (4 * kTile * stride + 2 * kTile * kTile + 2 * static_cast<size_t>(kTile) * D +
          kWarps * kTile + kTile) *
         sizeof(float);
}

size_t dq_smem_bytes(int D) {
  const size_t stride = D + 4;
  return (4 * kTile * stride + kTile * kTile + static_cast<size_t>(kTile) * D + kWarps * kTile +
          2 * kTile) *
         sizeof(float);
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a block needs the per-kernel opt-in,
// set once per device and kernel to the device's largest block size (as in
// attention.cu). Two threads may both set it on first use; it is idempotent.
template <typename Kernel>
cudaError_t opt_in_shared_memory(Kernel kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
                       float* m, float* l, int B, Shape sh, Dropout drop, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = fwd_smem_bytes(sh.Lq, sh.Lk, sh.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory(train_attention_fwd_kernel<T>, done);
    if (err != cudaSuccess) return err;
  }
  train_attention_fwd_kernel<T><<<B * sh.H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), m, l, sh, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* mask,
                       const float* m, const float* l, const void* g, void* dq, void* dk,
                       void* dv, int B, Shape sh, Dropout drop, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = bwd_smem_bytes(sh.Lq, sh.Lk, sh.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory(train_attention_bwd_kernel<T>, done);
    if (err != cudaSuccess) return err;
  }
  train_attention_bwd_kernel<T><<<B * sh.H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, m, l,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      sh, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_tiled(const void* q, const void* k, const void* v, const float* mask,
                             const float* m, const float* l, const void* g, void* dq, void* dk,
                             void* dv, float* delta, int B, Shape sh, Dropout drop,
                             cudaStream_t stream) {
  static std::atomic<bool> done_dq[kMaxDevices], done_dkdv[kMaxDevices];
  cudaError_t err = opt_in_shared_memory(train_attention_bwd_dq_kernel<T>, done_dq);
  if (err != cudaSuccess) return err;
  err = opt_in_shared_memory(train_attention_bwd_dkdv_kernel<T>, done_dkdv);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const int q_tiles = (sh.Lq + kTile - 1) / kTile, k_tiles = (sh.Lk + kTile - 1) / kTile;
  train_attention_bwd_dq_kernel<T><<<B * sh.H * q_tiles, kThreads, dq_smem_bytes(sh.D), stream>>>(
      qt, kt, vt, mask, m, l, gt, static_cast<T*>(dq), delta, sh, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_attention_bwd_dkdv_kernel<T>
      <<<B * sh.H * k_tiles, kThreads, tiled_smem_bytes(sh.D), stream>>>(
          qt, kt, vt, mask, m, l, gt, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh, drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, so the caller can check the budget
// and pick the backward: kind 0 the forward, 1 the whole-head backward, 2 the
// tiled backward.
long long univl_train_attention_smem_bytes(int Lq, int Lk, int D, int kind) {
  const size_t bytes = kind == 0   ? fwd_smem_bytes(Lq, Lk, D)
                       : kind == 1 ? bwd_smem_bytes(Lq, Lk, D)
                                   : tiled_smem_bytes(D);
  return static_cast<long long>(bytes);
}

// q: [B, Lq, H*D], k, v: [B, Lk, H*D], contiguous, 16-byte aligned, float32
// or bfloat16 (is_bf16); key_mask: contiguous f32 [B, Lk]; out like q;
// m, l: f32 [B, H, Lq]. Launches on `stream`, returns cudaGetLastError().
int univl_train_attention_fwd(const void* q, const void* k, const void* v, const void* key_mask,
                              void* out, void* m, void* l, int is_bf16, int B, int H, int Lq,
                              int Lk, int D, float scale, unsigned int threshold, float inv_keep,
                              int dropout_on, unsigned long long seed, void* stream) {
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on};
  const float* mask = static_cast<const float*>(key_mask);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, mask, out, mf, lf, B, sh, drop, s)
              : launch_fwd<float>(q, k, v, mask, out, mf, lf, B, sh, drop, s);
  return static_cast<int>(err);
}

// The forward's inputs and its m, l; g: the output gradient, like q; dq like
// q, dk and dv like k. Launches on `stream`, returns cudaGetLastError().
int univl_train_attention_bwd(const void* q, const void* k, const void* v, const void* key_mask,
                              const void* m, const void* l, const void* g, void* dq, void* dk,
                              void* dv, int is_bf16, int B, int H, int Lq, int Lk, int D,
                              float scale, unsigned int threshold, float inv_keep, int dropout_on,
                              unsigned long long seed, void* stream) {
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on};
  const float* mask = static_cast<const float*>(key_mask);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, mask, mf, lf, g, dq, dk, dv, B, sh, drop, s)
              : launch_bwd<float>(q, k, v, mask, mf, lf, g, dq, dk, dv, B, sh, drop, s);
  return static_cast<int>(err);
}

// The tiled backward: the whole-head backward's arguments plus `delta`, f32
// [B, H, Lq] scratch for rowsum(dp * p), written by its first kernel and read
// by its second. Launches both on `stream`, returns cudaGetLastError().
int univl_train_attention_bwd_tiled(const void* q, const void* k, const void* v,
                                    const void* key_mask, const void* m, const void* l,
                                    const void* g, void* dq, void* dk, void* dv, void* delta,
                                    int is_bf16, int B, int H, int Lq, int Lk, int D, float scale,
                                    unsigned int threshold, float inv_keep, int dropout_on,
                                    unsigned long long seed, void* stream) {
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on};
  const float* mask = static_cast<const float*>(key_mask);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16
          ? launch_bwd_tiled<__nv_bfloat16>(q, k, v, mask, mf, lf, g, dq, dk, dv, df, B, sh, drop, s)
          : launch_bwd_tiled<float>(q, k, v, mask, mf, lf, g, dq, dk, dv, df, B, sh, drop, s);
  return static_cast<int>(err);
}

}  // extern "C"
