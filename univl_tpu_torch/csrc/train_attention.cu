// Training attention for the PyTorch port, hand-written for Hopper (sm_90a):
// forward and backward kernels with in-kernel dropout of the attention
// probabilities, on two routes: tensor-core kernels for bf16 and CUDA-core
// kernels for f32.
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
// Under tensor parallelism a rank holds heads [head0, head0 + H) as its local
// heads 0 .. H - 1: every entry point takes head0, added to h in the counter,
// so a call on a rank's heads draws those heads' bits of the whole call.
// The TPU kernels' bits (pltpu.prng_random_bits) cannot be reproduced; the
// distribution is the same.
//
// Routes. bf16 at head dim 64 with Lk <= 256 and Lq <= 512 (every bf16 head
// of UniVL) takes the tensor-core kernels. f32 takes the CUDA-core kernels:
// the tensor cores multiply f32 as TF32 (a 10-bit mantissa), which would
// break the 1e-5 agreement of the card's f32 runs with the plain version; so
// does a bf16 head outside those limits. The wrapper picks the route.
//
// What bounds it: at UniVL's lengths (L <= 224, D = 64) one (b, h) does
// ~4 L^2 D flops forward and ~10 L^2 D backward over ~4-7 L D * 2 bytes: far
// below the H100's ~295 flop/byte ridge, so by the roofline memory traffic
// bounds the work (at FT-Align's [1024, 96] in bf16, 0.18 ms forward and
// 0.32 ms backward) and, at FT-Joint's few microseconds a call, launch
// latency and occupancy. What the kernels spend is the per-score work that
// the bound does not count: the products, exp, the dropout bits, the
// shuffles and the staging.
//
// The tensor-core kernels (bf16; their staging, product and softmax helpers
// are shared with the eval attention in attention_mma.cuh). Products run on
// mma.sync m16n8k16 (bf16 in, f32 accumulators); every warp owns 16 rows of
// a product's output, so the accumulator layout of one product is the
// A-fragment layout of the next and the [Lq, Lk] tiles never leave
// registers. Rows are staged in shared memory as bf16 with cp.async, padded
// to 144 bytes so ldmatrix's eight rows hit distinct banks. Blocks take 3
// warps (48 rows) where the length is a multiple of 48, else 4 (64 rows).
//  - Forward: one block per (b, h, query tile), the head's k and v staged.
//    A warp's 16 x Lk scores stay in registers (8 floats a thread per 16
//    keys; the kernel is instantiated for 2 to 16 chunks of 16 keys), the
//    row max and sum are taken across each quad with shuffles, and p is
//    dropped and rounded to bf16 straight into the A fragments of p v (v read
//    with ldmatrix.trans). No online rescaling: the whole row is in
//    registers, so the kernel keeps the TPU kernel's one-pass softmax and
//    its rounding points, and m and l are the exact row max and sum.
//  - Backward: FlashAttention-2's split into two kernels, no atomics, so
//    the result is deterministic. The dq kernel, one block per (b, h, query
//    tile) with the head's k and v staged, makes two passes over the keys:
//    the first sums delta = rowsum(dp * p), the TPU kernel's form (FA2's
//    rowsum(dO * O) differs from it by O's rounding), and leaves the keep
//    bits in shared memory; the second recomputes p and dp, forms ds in
//    registers and accumulates ds k. Two passes, since a warp's p and dp
//    over 224 keys (2 x 112 floats a thread) do not fit its registers, and
//    four warps' of them in shared memory (114 KB beside k and v's 64 KB)
//    would leave one block an SM. The dk/dv kernel,
//    one block per (b, h, key tile) with the head's q, g, m, l and delta
//    staged, walks the queries 16 at a time; each warp keeps its 16 keys' k
//    and v fragments in registers, forms the scores as the forward does, and
//    transposes p and ds in registers (movmatrix) into the A fragments of
//    round(p_dropped)^T g and ds^T q.
//  - The scores are formed the same way in all three kernels: q as the A
//    operand and k as B, the head dim in four 16-deep steps in ascending
//    order, then (acc * scale) + bias; p = expf(s - m) / l, the quotient
//    taken as e (1 / l) plus one fma correction. So the
//    backward's recomputed p is the forward's bit for bit, as the TPU
//    kernel requires (train_attention.py:141-144).
//  - Dropout: in the accumulator layout a thread holds two adjacent keys of
//    an 8-key tile; lane t of a quad draws Philox for keys 4t .. 4t + 3 of a
//    16-key chunk and the quad shares the words with two shuffles: one call
//    per row and four keys.
//
// The CUDA-core kernels (f32, and bf16 heads past the limits above): every
// input byte is read from device memory once and the [Lq, Lk] scores,
// probabilities and dropout bits never leave the SM. One block owns one
// (b, h): it stages that head's rows in f32 shared memory (16-byte loads,
// rows padded to D + 4 floats so the lanes of a quarter-warp reading
// different rows hit distinct banks). Forward: each warp takes query rows in
// turn, one key per lane, as in attention.cu. Backward: the warps fill the
// block's [Lq, Lk] tiles of dropped probabilities and ds, then every thread
// computes four adjacent columns of dq, dk and dv with fixed-order sums: no
// atomics, so the result is deterministic. One Philox call gives the keep
// bits of four keys. A head that does not fit the block's shared memory
// (Lq = Lk = 128 needs 283 KB, the caption cross tower's 224 positions 668
// KB; the card gives 227 KB) takes the tiled backward below: 32-row tiles of
// queries and keys, two kernels, the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "attention_mma.cuh"
#include "mma.cuh"
#include "opt_in.cuh"
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
    const uint4 w = philox4x32_10(make_uint4(j0 / 4 + c, i, h + drop.offset, b), drop.seed);
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

// ---------------------------------------------------------------- bf16: tensor cores
// (the design is in the note at the top of the file)

using univl::bf16;
using univl::cp_async16;
using univl::cp_async_commit;
using univl::cp_async_wait;
using univl::ldmatrix_x4;
using univl::ldmatrix_x4_trans;
using univl::mma16816;
using univl::movmatrix_trans;
using univl::kMaxDevices;
using univl::opt_in_shared_memory;
using univl::pack_bf16;
using univl::kD;
using univl::kRowPad;
using univl::kDSteps;
using univl::kDTiles;
using univl::stage_rows;
using univl::stage_bias;
using univl::load_a;
using univl::load_bt;
using univl::product16;
using univl::accumulate;
using univl::to_a;
using univl::quotient;
using univl::quad_max;
using univl::quad_sum;
using univl::score;
using univl::scores;
using univl::store_rows;

constexpr int kMaxChunks = 16;    // the forward holds a row's scores in registers: Lk <= 256
constexpr int kMaxQueries = 512;  // the dk/dv kernel stages a head's q and g: Lq <= 512
constexpr int kMmaMaxWarps = 4;

// Warps a block of the tensor-core kernels takes along a length L, 16 rows
// each: 3 where L is a multiple of 48 (the towers' 48 and FT-Align's 96, no
// ragged tile), else 4.
int mma_warps(int L) { return L % 48 == 0 ? 3 : 4; }

// The A fragments of the transpose of the tile whose fragments are a.
__device__ __forceinline__ void transpose_a(uint32_t (&at)[4], const uint32_t (&a)[4]) {
  at[0] = movmatrix_trans(a[0]);
  at[1] = movmatrix_trans(a[2]);
  at[2] = movmatrix_trans(a[1]);
  at[3] = movmatrix_trans(a[3]);
}

// Keep bits of the four words of Philox(counter = (quad, i, h, b)): bit w for word w.
__device__ __forceinline__ uint32_t keep_quad(const Dropout& drop, int b, int h, int i, int quad) {
  const uint4 w = philox4x32_10(make_uint4(quad, i, h + drop.offset, b), drop.seed);
  return static_cast<uint32_t>(w.x >= drop.threshold) |
         static_cast<uint32_t>(w.y >= drop.threshold) << 1 |
         static_cast<uint32_t>(w.z >= drop.threshold) << 2 |
         static_cast<uint32_t>(w.w >= drop.threshold) << 3;
}

// The keep bits of a thread's eight scores of the 16-key chunk c in
// product16's layout, rows i and i + 8: bit 4n + r for x[n][r]. One Philox
// call per row and four keys: lane t of a quad draws keys 16c + 4t .. + 3
// and the quad shares the words with two shuffles.
__device__ __forceinline__ uint32_t keep_chunk(const Dropout& drop, int b, int h, int i, int c,
                                               int lane) {
  const int t = lane & 3, base = lane & ~3, sh = 2 * (t & 1);
  const uint32_t mine = keep_quad(drop, b, h, i, 4 * c + t) |
                        keep_quad(drop, b, h, i + 8, 4 * c + t) << 4;
  const uint32_t lo = __shfl_sync(0xffffffffu, mine, base | (t >> 1));
  const uint32_t hi = __shfl_sync(0xffffffffu, mine, base | (2 + (t >> 1)));
  return ((lo >> sh) & 3u) | ((lo >> (4 + sh)) & 3u) << 2 | ((hi >> sh) & 3u) << 4 |
         ((hi >> (4 + sh)) & 3u) << 6;
}


// Forward: one block per (b, h, tile of 16 x warps query rows). The block
// stages the head's keys and values; each warp holds its 16 rows' scores
// over all Lk <= 16 KC keys in registers, takes the row max and sum across
// its quads (no online rescaling: the TPU kernel's whole-row softmax), then
// drops and rounds the probabilities straight into the A fragments of p v.
template <int KC>
__global__ void __launch_bounds__(32 * kMmaMaxWarps)
train_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ key_mask,
                               bf16* __restrict__ out, float* __restrict__ m_out,
                               float* __restrict__ l_out, Shape sh, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk;
  const int rows = blockDim.x / 2;  // 16 a warp
  const int nc = (Lk + 15) / 16;    // 16-key chunks
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);               // [16 nc][kRowPad]
  bf16* vs = ks + 16 * nc * kRowPad;                         // [16 nc][kRowPad]
  bf16* qs = vs + 16 * nc * kRowPad;                         // [rows][kRowPad]
  float* bias = reinterpret_cast<float*>(qs + rows * kRowPad);  // [16 nc]

  const int tiles = (Lq + rows - 1) / rows;
  const int b = blockIdx.x / tiles / H, h = blockIdx.x / tiles % H;
  const int i0 = blockIdx.x % tiles * rows;
  const long long ld = static_cast<long long>(H) * kD;
  stage_rows(ks, k + static_cast<long long>(b) * Lk * ld + h * kD, ld, Lk, 16 * nc);
  stage_rows(vs, v + static_cast<long long>(b) * Lk * ld + h * kD, ld, Lk, 16 * nc);
  stage_rows(qs, q + (static_cast<long long>(b) * Lq + i0) * ld + h * kD, ld, min(rows, Lq - i0),
             rows);
  cp_async_commit();
  stage_bias(bias, key_mask + static_cast<long long>(b) * Lk, Lk, 16 * nc);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int i = i0 + 16 * warp + lane / 4;  // the thread's rows: i and i + 8
  if (i0 + 16 * warp >= Lq) return;         // a ragged tile's idle warp
  uint32_t qa[kDSteps][4];
  load_a(qa, qs + 16 * warp * kRowPad, lane);

  float s[KC][2][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < nc) {
      scores(s[c], qa, ks + 16 * c * kRowPad, bias + 16 * c, sh.scale, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) mx[r / 2] = fmaxf(mx[r / 2], s[c][n][r]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < nc) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[c][n][r] = expf(s[c][n][r] - mx[r / 2]);
          sum[r / 2] += s[c][n][r];
        }
    }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  const float rsum[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (i + 8 * half < Lq) {
        const long long stat = (static_cast<long long>(b) * H + h) * Lq + i + 8 * half;
        m_out[stat] = mx[half];
        l_out[stat] = sum[half];
      }
    }
  }

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.0f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < nc) {
      const uint32_t keep = drop.on ? keep_chunk(drop, b, h, i, c, lane) : 0xffu;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = quotient(s[c][n][r], sum[r / 2], rsum[r / 2]);
          if (drop.on) p = (keep >> (4 * n + r)) & 1u ? p * drop.inv_keep : 0.0f;
          s[c][n][r] = p;
        }
      uint32_t pa[4];
      to_a(pa, s[c]);
      accumulate(o, pa, vs + 16 * c * kRowPad, lane);
    }
  }
  store_rows(out + static_cast<long long>(b) * Lq * ld + h * kD, o, ld, i, Lq, 1.0f, t);
}

// The probabilities, the dropped dp and the dropped probabilities of a
// thread's eight entries of a 16-key chunk, from the scores s and g v^T
// (dp), the rows' m, l and 1 / l, and the keep bits.
__device__ __forceinline__ void probs(float (&p)[2][4], float (&dp)[2][4], float (&pd)[2][4],
                                      const float (&s)[2][4], const float (&m)[2],
                                      const float (&l)[2], const float (&rl)[2], uint32_t keep,
                                      const Dropout& drop) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[n][r] = quotient(expf(s[n][r] - m[r / 2]), l[r / 2], rl[r / 2]);  // the forward's p
      pd[n][r] = p[n][r];
      if (drop.on) {
        const bool kept = (keep >> (4 * n + r)) & 1u;
        pd[n][r] = kept ? p[n][r] * drop.inv_keep : 0.0f;
        dp[n][r] = kept ? dp[n][r] * drop.inv_keep : 0.0f;
      }
    }
}

// Backward, first kernel: one block per (b, h, tile of 16 x warps query
// rows), the head's keys and values staged. Pass 1 over the key chunks sums
// delta = rowsum(dp * p) (written for the second kernel); pass 2 recomputes
// the chunk's p and dp, forms ds = round(p * (dp - delta)) in registers and
// accumulates dq += ds k. Pass 1 leaves each chunk's keep bits in shared
// memory for pass 2.
__global__ void __launch_bounds__(32 * kMmaMaxWarps)
train_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const float* __restrict__ key_mask,
                                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                                  const bf16* __restrict__ g, bf16* __restrict__ dq,
                                  float* __restrict__ delta, Shape sh, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk;
  const int rows = blockDim.x / 2;
  const int nc = (Lk + 15) / 16;
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);               // [16 nc][kRowPad]
  bf16* vs = ks + 16 * nc * kRowPad;                         // [16 nc][kRowPad]
  bf16* qs = vs + 16 * nc * kRowPad;                         // [rows][kRowPad]
  bf16* gs = qs + rows * kRowPad;                            // [rows][kRowPad]
  float* bias = reinterpret_cast<float*>(gs + rows * kRowPad);  // [16 nc]
  uint8_t* keeps = reinterpret_cast<uint8_t*>(bias + 16 * nc);  // [warps][nc][32]

  const int tiles = (Lq + rows - 1) / rows;
  const int b = blockIdx.x / tiles / H, h = blockIdx.x / tiles % H;
  const int i0 = blockIdx.x % tiles * rows;
  const long long ld = static_cast<long long>(H) * kD;
  const long long q0 = (static_cast<long long>(b) * Lq + i0) * ld + h * kD;
  stage_rows(ks, k + static_cast<long long>(b) * Lk * ld + h * kD, ld, Lk, 16 * nc);
  stage_rows(vs, v + static_cast<long long>(b) * Lk * ld + h * kD, ld, Lk, 16 * nc);
  stage_rows(qs, q + q0, ld, min(rows, Lq - i0), rows);
  stage_rows(gs, g + q0, ld, min(rows, Lq - i0), rows);
  cp_async_commit();
  stage_bias(bias, key_mask + static_cast<long long>(b) * Lk, Lk, 16 * nc);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int i = i0 + 16 * warp + lane / 4;
  if (i0 + 16 * warp >= Lq) return;
  uint32_t qa[kDSteps][4], ga[kDSteps][4];
  load_a(qa, qs + 16 * warp * kRowPad, lane);
  load_a(ga, gs + 16 * warp * kRowPad, lane);
  float m[2] = {0.0f, 0.0f}, l[2] = {1.0f, 1.0f};  // rows past Lq: finite, never written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (i + 8 * half < Lq) {
      const long long stat = (static_cast<long long>(b) * H + h) * Lq + i + 8 * half;
      m[half] = m_in[stat];
      l[half] = l_in[stat];
    }
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  uint8_t* kw = keeps + warp * nc * 32 + lane;

  float rs[2] = {0.0f, 0.0f};
  for (int c = 0; c < nc; ++c) {  // pass 1: delta
    float s[2][4], dp[2][4], p[2][4], pd[2][4];
    uint32_t vb[kDSteps][4];
    scores(s, qa, ks + 16 * c * kRowPad, bias + 16 * c, sh.scale, lane);
    load_bt(vb, vs + 16 * c * kRowPad, lane);
    product16(dp, ga, vb);
    uint32_t keep = 0xffu;
    if (drop.on) {
      keep = keep_chunk(drop, b, h, i, c, lane);
      kw[32 * c] = static_cast<uint8_t>(keep);
    }
    probs(p, dp, pd, s, m, l, rl, keep, drop);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) rs[r / 2] += dp[n][r] * p[n][r];
  }
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = i + 8 * half;
      if (row < Lq) delta[(static_cast<long long>(b) * H + h) * Lq + row] = rs[half];
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.0f;
  for (int c = 0; c < nc; ++c) {  // pass 2: ds, dq += ds k
    float s[2][4], dp[2][4], p[2][4], pd[2][4];
    uint32_t vb[kDSteps][4];
    scores(s, qa, ks + 16 * c * kRowPad, bias + 16 * c, sh.scale, lane);
    load_bt(vb, vs + 16 * c * kRowPad, lane);
    product16(dp, ga, vb);
    probs(p, dp, pd, s, m, l, rl, drop.on ? kw[32 * c] : 0xffu, drop);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[n][r] = p[n][r] * (dp[n][r] - rs[r / 2]);
    uint32_t da[4];
    to_a(da, p);
    accumulate(acc, da, ks + 16 * c * kRowPad, lane);
  }
  store_rows(dq + static_cast<long long>(b) * Lq * ld + h * kD, acc, ld, i, Lq, sh.scale, t);
}

// Backward, second kernel: one block per (b, h, tile of 16 x warps keys),
// the head's queries, output gradients, m, l and delta staged. Each warp
// keeps its 16 keys' k and v fragments in registers and walks the query rows
// 16 at a time: the scores as the forward forms them (q as A), p and ds in
// registers, their transposes by movmatrix, dv += round(p_dropped)^T g and
// dk += ds^T q. Sums run over the queries in ascending order and no two
// blocks write one element: no atomics, deterministic.
__global__ void __launch_bounds__(32 * kMmaMaxWarps)
train_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const float* __restrict__ key_mask,
                                    const float* __restrict__ m_in,
                                    const float* __restrict__ l_in, const bf16* __restrict__ g,
                                    const float* __restrict__ delta, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, Shape sh, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int H = sh.H, Lq = sh.Lq, Lk = sh.Lk;
  const int keys = blockDim.x / 2;
  const int nq = (Lq + 15) / 16;  // 16-row query chunks
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);             // [16 nq][kRowPad]
  bf16* gs = qs + 16 * nq * kRowPad;                       // [16 nq][kRowPad]
  bf16* kts = gs + 16 * nq * kRowPad;                      // [keys][kRowPad]
  bf16* vts = kts + keys * kRowPad;                        // [keys][kRowPad]
  float* ms = reinterpret_cast<float*>(vts + keys * kRowPad);  // [16 nq]
  float* ls = ms + 16 * nq;                                // [16 nq]
  float* rls = ls + 16 * nq;                               // [16 nq] 1 / l
  float* deltas = rls + 16 * nq;                           // [16 nq]

  const int tiles = (Lk + keys - 1) / keys;
  const int b = blockIdx.x / tiles / H, h = blockIdx.x / tiles % H;
  const int j0 = blockIdx.x % tiles * keys;
  const long long ld = static_cast<long long>(H) * kD;
  const long long k0 = (static_cast<long long>(b) * Lk + j0) * ld + h * kD;
  stage_rows(qs, q + static_cast<long long>(b) * Lq * ld + h * kD, ld, Lq, 16 * nq);
  stage_rows(gs, g + static_cast<long long>(b) * Lq * ld + h * kD, ld, Lq, 16 * nq);
  stage_rows(kts, k + k0, ld, min(keys, Lk - j0), keys);
  stage_rows(vts, v + k0, ld, min(keys, Lk - j0), keys);
  cp_async_commit();
  const long long stat0 = (static_cast<long long>(b) * H + h) * Lq;
  for (int r = threadIdx.x; r < 16 * nq; r += blockDim.x) {
    const bool row = r < Lq;  // padding rows: p = exp(s - inf) = 0, ds = 0
    ms[r] = row ? m_in[stat0 + r] : INFINITY;
    ls[r] = row ? l_in[stat0 + r] : 1.0f;
    rls[r] = __frcp_rn(ls[r]);
    deltas[r] = row ? delta[stat0 + r] : 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int jw = j0 + 16 * warp;  // the warp's first key
  if (jw >= Lk) return;
  uint32_t kb[kDSteps][4], vb[kDSteps][4];
  load_bt(kb, kts + 16 * warp * kRowPad, lane);
  load_bt(vb, vts + 16 * warp * kRowPad, lane);
  float bias[2][2];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = jw + 8 * n + 2 * t + e;
      bias[n][e] = j < Lk ? (1.0f - key_mask[static_cast<long long>(b) * Lk + j]) * kMaskBias
                          : -INFINITY;
    }

  float ak[kDTiles][4], av[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) ak[n][r] = av[n][r] = 0.0f;
  for (int qc = 0; qc < nq; ++qc) {
    uint32_t qa[kDSteps][4], ga[kDSteps][4];
    load_a(qa, qs + 16 * qc * kRowPad, lane);
    load_a(ga, gs + 16 * qc * kRowPad, lane);
    float s[2][4], dp[2][4], p[2][4], pd[2][4];
    product16(s, qa, kb);
    product16(dp, ga, vb);
    const int r0 = 16 * qc + lane / 4;  // the thread's rows r0 and r0 + 8
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = score(s[n][r], sh.scale, bias[n][r & 1]);
    const float m[2] = {ms[r0], ms[r0 + 8]}, l[2] = {ls[r0], ls[r0 + 8]};
    const float rl[2] = {rls[r0], rls[r0 + 8]};
    probs(p, dp, pd, s, m, l, rl, drop.on ? keep_chunk(drop, b, h, r0, jw / 16, lane) : 0xffu,
          drop);
    const float rs[2] = {deltas[r0], deltas[r0 + 8]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[n][r] = p[n][r] * (dp[n][r] - rs[r / 2]);
    uint32_t a[4], at[4];
    to_a(a, pd);
    transpose_a(at, a);
    accumulate(av, at, gs + 16 * qc * kRowPad, lane);
    to_a(a, p);
    transpose_a(at, a);
    accumulate(ak, at, qs + 16 * qc * kRowPad, lane);
  }
  const long long out0 = static_cast<long long>(b) * Lk * ld + h * kD;
  store_rows(dk + out0, ak, ld, jw + lane / 4, Lk, sh.scale, t);
  store_rows(dv + out0, av, ld, jw + lane / 4, Lk, 1.0f, t);
}

size_t fwd_mma_smem_bytes(int Lq, int Lk) {
  const size_t nc = (Lk + 15) / 16, rows = 16 * mma_warps(Lq);
  return (32 * nc + rows) * kRowPad * sizeof(bf16) + 16 * nc * sizeof(float);
}

size_t dq_mma_smem_bytes(int Lq, int Lk) {
  const size_t nc = (Lk + 15) / 16, rows = 16 * mma_warps(Lq);
  return (32 * nc + 2 * rows) * kRowPad * sizeof(bf16) + 16 * nc * sizeof(float) +
         rows / 16 * nc * 32;
}

size_t dkdv_mma_smem_bytes(int Lq, int Lk) {
  const size_t nq = (Lq + 15) / 16, keys = 16 * mma_warps(Lk);
  return (32 * nq + 2 * keys) * kRowPad * sizeof(bf16) + 4 * 16 * nq * sizeof(float);
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

template <int KC>
cudaError_t launch_fwd_mma_chunks(const void* q, const void* k, const void* v, const float* mask,
                                  void* out, float* m, float* l, int B, Shape sh, Dropout drop,
                                  cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = fwd_mma_smem_bytes(sh.Lq, sh.Lk);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory(train_attention_fwd_mma_kernel<KC>, done);
    if (err != cudaSuccess) return err;
  }
  const int warps = mma_warps(sh.Lq), tiles = (sh.Lq + 16 * warps - 1) / (16 * warps);
  train_attention_fwd_mma_kernel<KC><<<B * sh.H * tiles, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      static_cast<bf16*>(out), m, l, sh, drop);
  return cudaGetLastError();
}

// The forward instance whose registers hold the row's scores: 32 keys apart.
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const float* mask,
                           void* out, float* m, float* l, int B, Shape sh, Dropout drop,
                           cudaStream_t stream) {
  switch ((sh.Lk + 31) / 32) {
    case 1: return launch_fwd_mma_chunks<2>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 2: return launch_fwd_mma_chunks<4>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 3: return launch_fwd_mma_chunks<6>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 4: return launch_fwd_mma_chunks<8>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 5: return launch_fwd_mma_chunks<10>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 6: return launch_fwd_mma_chunks<12>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 7: return launch_fwd_mma_chunks<14>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    case 8: return launch_fwd_mma_chunks<16>(q, k, v, mask, out, m, l, B, sh, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const float* mask,
                           const float* m, const float* l, const void* g, void* dq, void* dk,
                           void* dv, float* delta, int B, Shape sh, Dropout drop,
                           cudaStream_t stream) {
  static std::atomic<bool> done_dq[kMaxDevices], done_dkdv[kMaxDevices];
  cudaError_t err = opt_in_shared_memory(train_attention_bwd_dq_mma_kernel, done_dq);
  if (err != cudaSuccess) return err;
  err = opt_in_shared_memory(train_attention_bwd_dkdv_mma_kernel, done_dkdv);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(g);
  const int wq = mma_warps(sh.Lq), wk = mma_warps(sh.Lk);
  const int q_tiles = (sh.Lq + 16 * wq - 1) / (16 * wq);
  const int k_tiles = (sh.Lk + 16 * wk - 1) / (16 * wk);
  train_attention_bwd_dq_mma_kernel<<<B * sh.H * q_tiles, 32 * wq,
                                      dq_mma_smem_bytes(sh.Lq, sh.Lk), stream>>>(
      qt, kt, vt, mask, m, l, gt, static_cast<bf16*>(dq), delta, sh, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_attention_bwd_dkdv_mma_kernel<<<B * sh.H * k_tiles, 32 * wk,
                                        dkdv_mma_smem_bytes(sh.Lq, sh.Lk), stream>>>(
      qt, kt, vt, mask, m, l, gt, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh, drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, so the caller can check the budget
// and pick the backward: kind 0 the forward, 1 the whole-head backward, 2 the
// tiled backward (the CUDA-core kernels); 3 the tensor-core forward, 4 the
// larger of the tensor-core backward's two kernels.
long long univl_train_attention_smem_bytes(int Lq, int Lk, int D, int kind) {
  const size_t bytes = kind == 0   ? fwd_smem_bytes(Lq, Lk, D)
                       : kind == 1 ? bwd_smem_bytes(Lq, Lk, D)
                       : kind == 2 ? tiled_smem_bytes(D)
                       : kind == 3 ? fwd_mma_smem_bytes(Lq, Lk)
                                   : std::max(dq_mma_smem_bytes(Lq, Lk),
                                              dkdv_mma_smem_bytes(Lq, Lk));
  return static_cast<long long>(bytes);
}

// q: [B, Lq, H*D], k, v: [B, Lk, H*D], contiguous, 16-byte aligned, float32
// or bfloat16 (is_bf16); key_mask: contiguous f32 [B, Lk]; out like q;
// m, l: f32 [B, H, Lq]; head0: the index of local head 0 in the whole call
// (a tensor-parallel rank's first head; 0 otherwise), added to the dropout
// counter's head word by every entry point below. Launches on `stream`,
// returns cudaGetLastError().
int univl_train_attention_fwd(const void* q, const void* k, const void* v, const void* key_mask,
                              void* out, void* m, void* l, int is_bf16, int B, int H, int Lq,
                              int Lk, int D, float scale, unsigned int threshold, float inv_keep,
                              int dropout_on, unsigned long long seed, int head0, void* stream) {
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on, head0};
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
                              unsigned long long seed, int head0, void* stream) {
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on, head0};
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
                                    unsigned long long seed, int head0, void* stream) {
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on, head0};
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

// The tensor-core forward: the forward's arguments, bf16 only (is_bf16 = 1),
// D = 64, Lk <= 256; otherwise cudaErrorInvalidValue and no launch.
int univl_train_attention_fwd_mma(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* out, void* m, void* l, int is_bf16,
                                  int B, int H, int Lq, int Lk, int D, float scale,
                                  unsigned int threshold, float inv_keep, int dropout_on,
                                  unsigned long long seed, int head0, void* stream) {
  if (!is_bf16 || D != kD || Lk > 16 * kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on, head0};
  return static_cast<int>(launch_fwd_mma(q, k, v, static_cast<const float*>(key_mask), out,
                                         static_cast<float*>(m), static_cast<float*>(l), B, sh,
                                         drop, static_cast<cudaStream_t>(stream)));
}

// The tensor-core backward: the tiled backward's arguments, bf16 only, D =
// 64, Lq <= 512; `delta` is written by its first kernel and read by its second.
int univl_train_attention_bwd_mma(const void* q, const void* k, const void* v,
                                  const void* key_mask, const void* m, const void* l,
                                  const void* g, void* dq, void* dk, void* dv, void* delta,
                                  int is_bf16, int B, int H, int Lq, int Lk, int D, float scale,
                                  unsigned int threshold, float inv_keep, int dropout_on,
                                  unsigned long long seed, int head0, void* stream) {
  if (!is_bf16 || D != kD || Lq > kMaxQueries) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{H, Lq, Lk, D, scale};
  const Dropout drop{seed, threshold, inv_keep, dropout_on, head0};
  return static_cast<int>(launch_bwd_mma(q, k, v, static_cast<const float*>(key_mask),
                                         static_cast<const float*>(m),
                                         static_cast<const float*>(l), g, dq, dk, dv,
                                         static_cast<float*>(delta), B, sh, drop,
                                         static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
