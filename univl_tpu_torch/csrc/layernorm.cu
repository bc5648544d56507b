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
// and per-block partial sums of dy * xhat (dgamma) and dy (dbeta) over the
// block's rows, in f32, which the wrapper sums over the blocks in a fixed
// order: no atomics, so the result is deterministic.
//
// What bounds it: a row of D = 768 or 1024 takes ~8 flops an element against
// 4-12 bytes of device traffic, far below the H100's ~295 flop/byte ridge,
// so the kernels are bound by memory traffic (bytes over 3.35 TB/s).
//
// What the design does about it: one warp owns one row and holds it in
// registers, eight contiguous elements a lane (one 16-byte load for bf16,
// two for f32), so x and dy are read from device memory once and the
// statistics are warp shuffles; gamma and beta are read through the cache.
// The backward's block takes kBwdRows rows (kBwdRows / kWarps a warp); each
// lane keeps its columns' dgamma and dbeta sums in registers over its warp's
// rows, and the warps add theirs into shared memory one after another (a
// fixed order) before the block writes its partials. Widths are multiples
// of 8 up to 4096 (kChunks eight-element chunks a lane, chosen per call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBwdRows = 16;  // rows a backward block owns: 2 a warp

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

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int rows,
                     int D, float eps) {
  extern __shared__ float acc[];  // [2][D]: the block's dgamma and dbeta sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = D / 8;
  const float inv_d = 1.0f / static_cast<float>(D);
  float dg[kChunks * 8], db[kChunks * 8];
#pragma unroll
  for (int i = 0; i < kChunks * 8; ++i) dg[i] = db[i] = 0.0f;

  for (int r = warp; r < kBwdRows; r += kWarps) {
    const long long row = static_cast<long long>(blockIdx.x) * kBwdRows + r;
    if (row >= rows) break;
    float v[kChunks * 8], g[kChunks * 8];
    const float2 st = row_stats<T, kChunks>(x + row * D, v, D, eps, lane);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      const int c = lane + 32 * t;
      if (c < chunks) {
        float gm[8];
        load8(dy + row * D + 8 * c, g + 8 * t);
        load8(gamma + 8 * c, gm);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 8 * t + i;
          const float xhat = (v[e] - st.x) * st.y;
          dg[e] += g[e] * xhat;
          db[e] += g[e];
          v[e] = xhat;
          g[e] *= gm[i];  // dyg
          s1 += g[e];
          s2 += g[e] * xhat;
        }
      }
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    T* dxr = dx + row * D;
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      const int c = lane + 32 * t;
      if (c < chunks) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 8 * t + i;
          o[i] = st.y * (g[e] - m1 - v[e] * m2);
        }
        store8(dxr + 8 * c, o);
      }
    }
  }

  for (int c = threadIdx.x; c < 2 * D; c += kThreads) acc[c] = 0.0f;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {  // one warp after another: a fixed order
    if (warp == w) {
#pragma unroll
      for (int t = 0; t < kChunks; ++t) {
        const int c = lane + 32 * t;
        if (c < chunks) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[8 * c + i] += dg[8 * t + i];
            acc[D + 8 * c + i] += db[8 * t + i];
          }
        }
      }
    }
    __syncthreads();
  }
  const long long base = static_cast<long long>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    dgamma_part[base + c] = acc[c];
    dbeta_part[base + c] = acc[D + c];
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

template <typename T, int kChunks>
cudaError_t bwd(const void* x, const float* gamma, const void* dy, void* dx, float* dgp,
                float* dbp, int rows, int D, float eps, cudaStream_t stream) {
  const int blocks = (rows + kBwdRows - 1) / kBwdRows;
  layernorm_bwd_kernel<T, kChunks><<<blocks, kThreads, 2 * D * sizeof(float), stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), dgp, dbp,
      rows, D, eps);
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
cudaError_t bwd_dispatch(const void* x, const float* gamma, const void* dy, void* dx, float* dgp,
                         float* dbp, int rows, int D, float eps, cudaStream_t s) {
  switch (chunks_for(D)) {
    case 1: return bwd<T, 1>(x, gamma, dy, dx, dgp, dbp, rows, D, eps, s);
    case 2: return bwd<T, 2>(x, gamma, dy, dx, dgp, dbp, rows, D, eps, s);
    case 3: return bwd<T, 3>(x, gamma, dy, dx, dgp, dbp, rows, D, eps, s);
    case 4: return bwd<T, 4>(x, gamma, dy, dx, dgp, dbp, rows, D, eps, s);
    case 8: return bwd<T, 8>(x, gamma, dy, dx, dgp, dbp, rows, D, eps, s);
    case 16: return bwd<T, 16>(x, gamma, dy, dx, dgp, dbp, rows, D, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows a backward block owns: the wrapper allocates one partial row per block.
int univl_layernorm_bwd_rows() { return kBwdRows; }

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

// x, dy, dx: like the forward's x; gamma f32 [D]; dgamma_part, dbeta_part:
// f32 [ceil(rows / univl_layernorm_bwd_rows()), D], one row per block.
int univl_layernorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                        void* dgamma_part, void* dbeta_part, int is_bf16, int rows, int D,
                        float eps, void* stream) {
  const float* g = static_cast<const float*>(gamma);
  float* dgp = static_cast<float*>(dgamma_part);
  float* dbp = static_cast<float*>(dbeta_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? bwd_dispatch<__nv_bfloat16>(x, g, dy, dx, dgp, dbp, rows, D, eps, s)
              : bwd_dispatch<float>(x, g, dy, dx, dgp, dbp, rows, D, eps, s));
}

}  // extern "C"
