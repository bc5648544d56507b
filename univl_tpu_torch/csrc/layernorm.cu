// TF-style LayerNorm for the PyTorch port, hand-written for Hopper (sm_90a):
// a forward and a backward kernel over the rows of a [rows, D] tensor.
//
// Replaces the Pallas TPU kernels of univl_tpu/kernels/layernorm.py:
// _fwd_kernel (called from _pallas_fwd) and _bwd_kernel (called from
// _pallas_bwd), the two halves of the custom VJP fused_layer_norm.
//
// Forward, per row x (f32 or bf16), f32 gamma and beta:
//   mu = mean(x), var = mean((x - mu)^2), rstd = rsqrt(var + eps)   (f32)
//   y = (x - mu) * rstd * gamma + beta, rounded to x's type
// Backward, per row, recomputing mu and rstd from the saved x:
//   xhat = (x - mu) * rstd, dyg = dy * gamma
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)), rounded to x's type
// and the sums over the rows of dy * xhat (dgamma) and dy (dbeta), in f32.
//
// What bounds it: a row of D = 768 or 1024 takes ~8 flops an element against
// 4-12 bytes of device traffic, far below the H100's ~295 flop/byte ridge,
// so the kernels are bound by memory traffic (bytes over 3.35 TB/s) and, at
// the model's 1,536-3,584 rows (3-19 MB, a few microseconds), by how many
// bytes are in flight and how long each row's chain of steps takes.
//
// What the design does about it: one warp owns one row and holds it in
// registers, eight contiguous elements a lane (one 16-byte load for bf16,
// two for f32), so x and dy are read from device memory once and the
// statistics are warp shuffles; gamma and beta are read through the cache.
// Backward: a grid of one 8-warp block an SM (the wrapper sizes it to the
// card; registers hold one such block an SM), each block a contiguous range
// of rows, its warps taking every eighth. A row's x and dy are loaded before
// its reductions begin, and the warp's next row is loaded before the current
// row's arithmetic (a double buffer in registers; widths past 1,024 load
// one row at a time). The reductions take two rounds of two interleaved
// warp sums: sum(x) with sum(dyg), then sum((x - mu)^2) with
// sum(dyg (x - mu)). Each warp adds its rows' dy * xhat and dy into its own
// slice of shared memory; the block then sums its warps' slices in warp
// order into one partial row, and a second kernel sums the blocks' partials
// per column in block order. No atomics: the order is fixed by the grid, so
// two calls give bitwise equal dgamma and dbeta. Widths are multiples of 8
// up to 4096 (kChunks eight-element chunks a lane, chosen per call; 4-warp
// blocks past 2,048).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "opt_in.cuh"

namespace {

using univl::kMaxDevices;
using univl::opt_in_shared_memory;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSumGroups = 16;  // row groups of a block of the partials' sum

// Warps a backward block takes: 8, or 4 past 2,048 columns (each warp keeps
// its [2][D] f32 sums in shared memory).
template <int kChunks>
constexpr int kBwdWarps = kChunks <= 8 ? 8 : 4;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The warp's row into registers: chunk t of lane is columns 8 (lane + 32 t) ..
// + 7; returns (mu, rstd) of the row.
template <typename T, int kChunks>
__device__ __forceinline__ float2 row_stats(const T* xr, float* v, int D, float eps, int lane) {
  const int chunks = D / 8;
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + 32 * t;
    if (c < chunks) {
      load8(xr + 8 * c, v + 8 * t);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v[8 * t + i];
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.0f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    if (lane + 32 * t < chunks) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = v[8 * t + i] - mu;
        sq += d * d;
      }
    }
  }
  return make_float2(mu, rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps));
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, int rows, int D,
                     float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  float v[kChunks * 8];
  const float2 st = row_stats<T, kChunks>(x + row * D, v, D, eps, lane);
  T* yr = y + row * D;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + 32 * t;
    if (c < D / 8) {
      float g[8], b[8], o[8];
      load8(gamma + 8 * c, g);
      load8(beta + 8 * c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (v[8 * t + i] - st.x) * st.y * g[i] + b[i];
      store8(yr + 8 * c, o);
    }
  }
}

// A row's x and dy into registers: chunk t of lane is columns 8 (lane + 32 t) .. + 7.
template <typename T, int kChunks>
__device__ __forceinline__ void load_row(const T* xr, const T* dyr, float* xv, float* gv, int D,
                                         int lane) {
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + 32 * t;
    if (c < D / 8) {
      load8(xr + 8 * c, xv + 8 * t);
      load8(dyr + 8 * c, gv + 8 * t);
    }
  }
}

// Two warp sums, their shuffles interleaved.
__device__ __forceinline__ float2 warp_sum2(float a, float b) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  return make_float2(a, b);
}

// One row's dx from its x and dy in registers (xv, gv), and its dy * xhat and
// dy added into the warp's partial sums (wacc: [2][D] in shared memory).
template <typename T, int kChunks>
__device__ __forceinline__ void row_bwd(const float* xv, const float* gv,
                                        const float* __restrict__ gamma, T* dxr, float* wacc,
                                        int D, float eps, int lane) {
  const int chunks = D / 8;
  const float inv_d = 1.0f / static_cast<float>(D);
  float sx = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + 32 * t;
    if (c < chunks) {
      float gm[8];
      load8(gamma + 8 * c, gm);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sx += xv[8 * t + i];
        s1 += gv[8 * t + i] * gm[i];
      }
    }
  }
  const float2 r1 = warp_sum2(sx, s1);
  const float mu = r1.x * inv_d, m1 = r1.y * inv_d;
  float sq = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + 32 * t;
    if (c < chunks) {
      float gm[8];
      load8(gamma + 8 * c, gm);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = xv[8 * t + i] - mu;
        sq += d * d;
        s2 += gv[8 * t + i] * gm[i] * d;
      }
    }
  }
  const float2 r2 = warp_sum2(sq, s2);
  const float rstd = rsqrtf(r2.x * inv_d + eps);
  const float m2 = r2.y * inv_d * rstd;  // mean(dyg * xhat)
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    const int c = lane + 32 * t;
    if (c < chunks) {
      float gm[8], o[8], dg[8], db[8];
      load8(gamma + 8 * c, gm);
      load8(wacc + 8 * c, dg);
      load8(wacc + D + 8 * c, db);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dyv = gv[8 * t + i];
        const float xhat = (xv[8 * t + i] - mu) * rstd;
        dg[i] += dyv * xhat;
        db[i] += dyv;
        o[i] = rstd * (dyv * gm[i] - m1 - xhat * m2);
      }
      store8(wacc + 8 * c, dg);
      store8(wacc + D + 8 * c, db);
      store8(dxr + 8 * c, o);
    }
  }
}

// Backward: block g owns rows [g R, (g + 1) R) (R = rows_per_block), its
// warps every kBwdWarps-th of them; writes dx and the block's partial sums
// (part: [gridDim.x][2][D], dgamma's row then dbeta's).
template <typename T, int kChunks>
__global__ void __launch_bounds__(32 * kBwdWarps<kChunks>)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                     int rows, int D, int rows_per_block, float eps) {
  constexpr int kW = kBwdWarps<kChunks>, kT = 32 * kW;
  extern __shared__ __align__(16) float acc[];  // [kW][2][D]: each warp's sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < kW * 2 * D; c += kT) acc[c] = 0.0f;
  __syncthreads();
  float* wacc = acc + warp * 2 * D;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long end = min(first + rows_per_block, static_cast<long long>(rows));
  constexpr int N = kChunks * 8;
  float xa[N], ga[N];
  if constexpr (kChunks <= 4) {  // the next row loaded before this row's arithmetic
    float xb[N], gb[N];
    long long r = first + warp;
    if (r < end) load_row<T, kChunks>(x + r * D, dy + r * D, xa, ga, D, lane);
    while (r < end) {
      const long long rn = r + kW;
      if (rn < end) load_row<T, kChunks>(x + rn * D, dy + rn * D, xb, gb, D, lane);
      row_bwd<T, kChunks>(xa, ga, gamma, dx + r * D, wacc, D, eps, lane);
      if (rn >= end) break;
      r = rn + kW;
      if (r < end) load_row<T, kChunks>(x + r * D, dy + r * D, xa, ga, D, lane);
      row_bwd<T, kChunks>(xb, gb, gamma, dx + rn * D, wacc, D, eps, lane);
    }
  } else {  // wide rows: one row in registers at a time
    for (long long r = first + warp; r < end; r += kW) {
      load_row<T, kChunks>(x + r * D, dy + r * D, xa, ga, D, lane);
      row_bwd<T, kChunks>(xa, ga, gamma, dx + r * D, wacc, D, eps, lane);
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int c = threadIdx.x; c < 2 * D; c += kT) {
    float s = acc[c];
#pragma unroll
    for (int w = 1; w < kW; ++w) s += acc[w * 2 * D + c];  // warp order
    out[c] = s;
  }
}

// The blocks' partials summed per column in block order: a block takes 32
// of part's 2 D columns, its warps every kSumGroups-th partial row, then
// warp 0 adds the warps' sums in warp order.
__global__ void __launch_bounds__(32 * kSumGroups)
layernorm_bwd_sum_kernel(const float* __restrict__ part, int blocks, int D,
                         float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float red[kSumGroups][32];
  const int group = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < 2 * D) {
#pragma unroll 4
    for (int g = group; g < blocks; g += kSumGroups) {
      s += part[static_cast<long long>(g) * 2 * D + c];
    }
  }
  red[group][lane] = s;
  __syncthreads();
  if (group == 0 && c < 2 * D) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kSumGroups; ++w) t += red[w][lane];
    if (c < D) {
      dgamma[c] = t;
    } else {
      dbeta[c - D] = t;
    }
  }
}

// The smallest instantiated chunk count that holds D / 8 chunks over 32 lanes.
int chunks_for(int D) {
  const int need = (D / 8 + 31) / 32;
  const int counts[] = {1, 2, 3, 4, 8, 16};
  for (int k : counts) {
    if (need <= k) return k;
  }
  return 0;
}

template <typename T, int kChunks>
cudaError_t fwd(const void* x, const float* gamma, const float* beta, void* y, int rows, int D,
                float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  layernorm_fwd_kernel<T, kChunks><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

template <int kChunks>
size_t bwd_smem_bytes(int D) {
  return static_cast<size_t>(kBwdWarps<kChunks>) * 2 * D * sizeof(float);
}

template <typename T, int kChunks>
cudaError_t bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                float* dgamma, float* dbeta, int rows, int D, float eps, int blocks,
                cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = bwd_smem_bytes<kChunks>(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory(layernorm_bwd_kernel<T, kChunks>, done);
    if (err != cudaSuccess) return err;
  }
  layernorm_bwd_kernel<T, kChunks><<<blocks, 32 * kBwdWarps<kChunks>, smem, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part,
      rows, D, (rows + blocks - 1) / blocks, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layernorm_bwd_sum_kernel<<<(2 * D + 31) / 32, 32 * kSumGroups, 0, stream>>>(part, blocks, D,
                                                                               dgamma, dbeta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_dispatch(const void* x, const float* gamma, const float* beta, void* y, int rows,
                         int D, float eps, cudaStream_t s) {
  switch (chunks_for(D)) {
    case 1: return fwd<T, 1>(x, gamma, beta, y, rows, D, eps, s);
    case 2: return fwd<T, 2>(x, gamma, beta, y, rows, D, eps, s);
    case 3: return fwd<T, 3>(x, gamma, beta, y, rows, D, eps, s);
    case 4: return fwd<T, 4>(x, gamma, beta, y, rows, D, eps, s);
    case 8: return fwd<T, 8>(x, gamma, beta, y, rows, D, eps, s);
    case 16: return fwd<T, 16>(x, gamma, beta, y, rows, D, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_dispatch(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                         float* dg, float* db, int rows, int D, float eps, int blocks,
                         cudaStream_t s) {
  switch (chunks_for(D)) {
    case 1: return bwd<T, 1>(x, gamma, dy, dx, part, dg, db, rows, D, eps, blocks, s);
    case 2: return bwd<T, 2>(x, gamma, dy, dx, part, dg, db, rows, D, eps, blocks, s);
    case 3: return bwd<T, 3>(x, gamma, dy, dx, part, dg, db, rows, D, eps, blocks, s);
    case 4: return bwd<T, 4>(x, gamma, dy, dx, part, dg, db, rows, D, eps, blocks, s);
    case 8: return bwd<T, 8>(x, gamma, dy, dx, part, dg, db, rows, D, eps, blocks, s);
    case 16: return bwd<T, 16>(x, gamma, dy, dx, part, dg, db, rows, D, eps, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The widest row the kernels take (a multiple of 8).
int univl_layernorm_max_width() { return 8 * 32 * 16; }

// x, y: contiguous [rows, D], 16-byte aligned, float32 or bfloat16 (is_bf16);
// gamma, beta: f32 [D]. rows >= 1, D a multiple of 8 up to the max width.
// Launches on `stream`, returns cudaGetLastError().
int univl_layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y, int is_bf16,
                        int rows, int D, float eps, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? fwd_dispatch<__nv_bfloat16>(x, g, b, y, rows, D, eps, s)
                                  : fwd_dispatch<float>(x, g, b, y, rows, D, eps, s));
}

// x, dy, dx: like the forward's x; gamma f32 [D]; part: f32 scratch
// [blocks][2][D] for the blocks' partial sums; dgamma, dbeta: f32 [D].
// blocks >= 1: the backward's grid, each block a contiguous range of
// ceil(rows / blocks) rows. Launches the backward and the partials' sum on
// `stream`, returns cudaGetLastError().
int univl_layernorm_bwd(const void* x, const void* gamma, const void* dy, void* dx, void* part,
                        void* dgamma, void* dbeta, int is_bf16, int rows, int D, float eps,
                        int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  float* pt = static_cast<float*>(part);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? bwd_dispatch<__nv_bfloat16>(x, g, dy, dx, pt, dg, db, rows, D, eps, blocks, s)
              : bwd_dispatch<float>(x, g, dy, dx, pt, dg, db, rows, D, eps, blocks, s));
}

}  // extern "C"
