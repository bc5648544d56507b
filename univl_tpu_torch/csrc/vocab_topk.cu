// Tied-classifier top-k for the PyTorch port, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel univl_tpu/kernels/vocab_topk.py:
// vocab_topk_partials and its epilogue in classify_topk. For hidden states
// h [R, H] and the tied classifier W [V, H], bias [V] (f32):
//
//   logits = h W^T + bias                 (f32 accumulation)
//   logp_topk, idx = top_k(logits - logsumexp(logits), k)
//
// without writing the [R, V] logits to device memory. Among equal values
// the lower vocab index comes first, as lax.top_k orders them.
//
// What bounds it: bytes. W is read once (46.9 MB in bf16 at BERT's 30,522
// x 768); the 3.75 GFLOP at the caption slice's R = 80 beam rows take ~4 us
// at the tensor cores' bf16 rate, against ~14 us to read W.
//
// What the design does about it: a first kernel streams the vocabulary in
// tiles of kTileV rows of W through shared memory. A block computes a
// [kTileR, kTileV] logits tile for its rows and vocab tile on the CUDA cores
// (each thread a 4 x 4 register tile, f32 sums over H in chunks of kChunkH),
// adds the bias, and reduces the tile on chip to per-row partials: the max,
// the sum of exp(logit - max), and the top-k with their vocab indices. The
// blocks of one vocab tile for all row tiles are adjacent in launch order,
// so the tile of W is read from device memory once and from L2 after that.
// A second kernel, one block per row, merges the partials of all vocab
// tiles: logsumexp = M + log(sum_j s_j exp(m_j - M)), then the top-k over
// the tiles' winners. Tensor cores (mma.sync / wgmma), TMA and
// double-buffered tiles are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 16;    // rows of h per block
constexpr int kTileV = 128;   // vocab rows of W per block
constexpr int kChunkH = 32;   // hidden elements per shared-memory stage
constexpr int kThreads = 128;  // 4 warps: warp w owns rows 4w..4w+3, lane l cols 4l..4l+3
constexpr int kMaxK = 32;
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// (value, index) a is ranked above b: larger value, or equal value and lower index
__device__ __forceinline__ bool ranks_above(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ranks_above(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vocab_tile_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const float* __restrict__ bias, int R, int H, int k,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  float* __restrict__ part_max, float* __restrict__ part_sum) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ __align__(16) float hs[kChunkH][kTileR];
  __shared__ __align__(16) float ws[kChunkH * kTileV];  // [kChunkH][kTileV], then the logits tile
  const int row0 = blockIdx.x * kTileR;
  const int tile = blockIdx.y;
  const long long v0 = static_cast<long long>(tile) * kTileV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += kChunkH) {
    // W tile chunk: thread c stages vocab row v0 + c, stored transposed so the
    // product below reads 4 consecutive vocab columns as one float4
    const T* wrow = w + (v0 + threadIdx.x) * H + k0;
#pragma unroll
    for (int e0 = 0; e0 < kChunkH; e0 += kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wrow + e0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) ws[(e0 + i) * kTileV + threadIdx.x] = to_float(e[i]);
    }
    for (int e = threadIdx.x; e < kTileR * kChunkH; e += kThreads) {
      const int r = e / kChunkH, kk = e % kChunkH;
      hs[kk][r] = row0 + r < R ? to_float(h[static_cast<long long>(row0 + r) * H + k0 + kk])
                               : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunkH; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[kk][warp * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk * kTileV + lane * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the logits tile, [kTileR][kTileV + 1], in the space of the W stage
  float* lt = ws;
  constexpr int kLd = kTileV + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane * 4 + j;
      lt[(warp * 4 + i) * kLd + c] = acc[i][j] + bias[v0 + c];
    }
  __syncthreads();

  // per-row partials: warp w reduces rows w, w + 4, w + 8, w + 12
  constexpr int kPerLane = kTileV / 32;
  for (int r = warp; r < kTileR; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= R) break;  // the same for the whole warp
    float x[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) x[i] = lt[r * kLd + lane + 32 * i];
    float m = x[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = fmaxf(m, x[i]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s += expf(x[i] - m);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const long long slot = static_cast<long long>(tile) * R + row;
    if (lane == 0) {
      part_max[slot] = m;
      part_sum[slot] = s;
    }
    unsigned taken = 0u;  // bit i: x[i] is already among the winners
    for (int round = 0; round < k; ++round) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int col = lane + 32 * i;
        if (!(taken >> i & 1u) && ranks_above(x[i], col, bv, bi)) {
          bv = x[i];
          bi = col;
        }
      }
      warp_argmax(bv, bi);
      if (bi % 32 == lane) taken |= 1u << (bi / 32);
      if (lane == 0) {
        part_val[slot * k + round] = bv;
        part_idx[slot * k + round] = static_cast<int>(v0) + bi;
      }
    }
  }
}

// One block per row: logsumexp over the vocab tiles' partials, then the
// top-k of the tiles' winners, written as log-probabilities.
__global__ void __launch_bounds__(kMergeThreads)
vocab_merge_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                   const float* __restrict__ part_max, const float* __restrict__ part_sum,
                   int R, int n_tiles, int k, float* __restrict__ out_logp,
                   long long* __restrict__ out_idx) {
  __shared__ float red_v[kMergeThreads / 32];
  __shared__ int red_i[kMergeThreads / 32];
  __shared__ int red_p[kMergeThreads / 32];
  __shared__ float lse_s;
  __shared__ int won[kMaxK];  // candidate positions already taken
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float m = -INFINITY;
  for (int j = threadIdx.x; j < n_tiles; j += kMergeThreads) m = fmaxf(m, part_max[j * R + row]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red_v[warp] = m;
  __syncthreads();
  float M = red_v[0];
  for (int i = 1; i < kMergeThreads / 32; ++i) M = fmaxf(M, red_v[i]);
  __syncthreads();
  float s = 0.0f;
  for (int j = threadIdx.x; j < n_tiles; j += kMergeThreads) {
    s += part_sum[j * R + row] * expf(part_max[j * R + row] - M);
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red_v[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kMergeThreads / 32; ++i) total += red_v[i];
    lse_s = M + logf(total);
  }
  __syncthreads();
  const float lse = lse_s;

  const int n_cand = n_tiles * k;  // candidate p: tile p / k, rank p % k
  for (int round = 0; round < k; ++round) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, bp = -1;
    for (int p = threadIdx.x; p < n_cand; p += kMergeThreads) {
      bool taken = false;
      for (int i = 0; i < round; ++i) taken |= won[i] == p;
      const long long at = (static_cast<long long>(p / k) * R + row) * k + p % k;
      const float v = part_val[at];
      const int vi = part_idx[at];
      if (!taken && ranks_above(v, vi, bv, bi)) {
        bv = v;
        bi = vi;
        bp = p;
      }
    }
    // block argmax over (value, vocab index); the winner's candidate position
    // travels with it through the same comparisons
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (ranks_above(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
      red_p[warp] = bp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 1; i < kMergeThreads / 32; ++i) {
        if (ranks_above(red_v[i], red_i[i], bv, bi)) {
          bv = red_v[i];
          bi = red_i[i];
          bp = red_p[i];
        }
      }
      won[round] = bp;
      out_logp[static_cast<long long>(row) * k + round] = bv - lse;
      out_idx[static_cast<long long>(row) * k + round] = bi;
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* w, const float* bias, int R, int H, int Vp, int k,
                   float* part_val, int* part_idx, float* part_max, float* part_sum,
                   float* out_logp, long long* out_idx, cudaStream_t stream) {
  const int n_tiles = Vp / kTileV;
  const dim3 grid((R + kTileR - 1) / kTileR, n_tiles);
  vocab_tile_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), bias, R, H, k, part_val, part_idx,
      part_max, part_sum);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vocab_merge_kernel<<<R, kMergeThreads, 0, stream>>>(part_val, part_idx, part_max, part_sum,
                                                      R, n_tiles, k, out_logp, out_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h: contiguous [R, H]; w: contiguous [Vp, H] of h's type, Vp a multiple of
// the vocab tile; bias: contiguous f32 [Vp]; H a multiple of the hidden
// chunk; 1 <= k <= kMaxK. part_*: scratch of n_tiles * R (* k) entries;
// out_logp: f32 [R, k]; out_idx: int64 [R, k]. Launches two kernels on
// `stream`; returns the first CUDA error.
int univl_vocab_topk(const void* h, const void* w, const void* bias, int is_bf16, int R, int H,
                     int Vp, int k, void* part_val, void* part_idx, void* part_max,
                     void* part_sum, void* out_logp, void* out_idx, void* stream) {
  if (R < 1 || k < 1 || k > kMaxK || Vp % kTileV != 0 || H % kChunkH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* b = static_cast<const float*>(bias);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_idx);
  float* pm = static_cast<float*>(part_max);
  float* ps = static_cast<float*>(part_sum);
  float* ol = static_cast<float*>(out_logp);
  long long* oi = static_cast<long long*>(out_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(h, w, b, R, H, Vp, k, pv, pi, pm, ps, ol, oi, s)
              : launch<float>(h, w, b, R, H, Vp, k, pv, pi, pm, ps, ol, oi, s);
  return static_cast<int>(err);
}

}  // extern "C"
