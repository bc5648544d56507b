// Fused beam-decode self-attention for the PyTorch port, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel univl_tpu/kernels/decode_attention.py:
// beam_decode_self_attention. For one decoder layer and one beam step t,
// in a single pass over the KV cache, for every beam row n and head h:
//
//   1. the pending beam permutation: row n reads its cache from source row
//      s = (n / group) * group + prev_k[n] (the cache arrives one
//      permutation behind; rows move only within their instance's group),
//   2. the position-t update: key/value t are the step's k_new/v_new,
//   3. attention over positions 0..t: scores q.k_j / sqrt(D) in f32,
//      positions > t masked (they get probability exactly 0, as the TPU
//      kernel's -1e9 gives), softmax in f32, the probabilities rounded to
//      the cache type, and sum_j p_j v_j in f32,
//
// and writes the context and the permuted, updated caches.
//
// What bounds it: bytes. It reads q, k_new, v_new and cache positions < t,
// and writes both caches whole (~15.7 MB at the caption slice's
// [80,12,32,64] bf16 caches, ~23.6 MB at L = 48) for ~4 flops per cache
// element.
//
// What the design does about it: every cache byte is read at most once and
// written once. Positions > t are zero by construction (caches start at
// zero, each position is written once, a bucket grows with zeros), so the
// kernel writes zeros there without reading them. The outputs are fresh
// buffers, not the inputs: the in-place variant would race between the
// blocks of one group (a row's output is another row's source). This is
// the TPU kernel's donate=False form; the caller drops the old caches, and
// PyTorch's caching allocator hands their memory to the next step.
//
// One block owns one (row, head). Its threads split each position's D
// elements into 16-byte words (D * sizeof(T) / 16 threads a position, so a
// 128-byte bf16 row is one coalesced 8-thread read) and take positions in
// turn. Scores: each thread's partial dot product, summed over the
// position's threads with shuffles. Softmax: one warp over the <= L scores
// in shared memory. PV: each thread keeps its 16-byte word of columns in f32
// and the block sums the partials in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, long long q_row, long long k_row,
                        long long v_row, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache, const int* __restrict__ prev_k,
                        T* __restrict__ ctx, T* __restrict__ k_out, T* __restrict__ v_out,
                        int H, int L, int D, int t, int group, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte word
  extern __shared__ float smem[];
  float* probs = smem;         // [L]
  float* partial = smem + L;   // [kWarps][D]

  const int n = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int src = (n / group) * group + prev_k[n];
  const int lpr = D / kVec;              // threads per position (a power of two <= 32)
  const int rows = kThreads / lpr;       // positions per pass
  const int r = threadIdx.x / lpr;
  const int c = threadIdx.x % lpr;
  const int col = c * kVec;
  const long long in_base = (static_cast<long long>(src) * H + h) * L * D + col;
  const long long out_base = (static_cast<long long>(n) * H + h) * L * D + col;

  float qv[kVec];
  {
    const uint4 raw = *reinterpret_cast<const uint4*>(q + n * q_row + h * D + col);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qv[i] = to_float(e[i]);
  }
  const uint4 k_t = *reinterpret_cast<const uint4*>(k_new + n * k_row + h * D + col);
  const uint4 v_t = *reinterpret_cast<const uint4*>(v_new + n * v_row + h * D + col);

  // keys: scores for positions <= t, and the permuted, updated K cache.
  // The loop bound is the same for every thread, so the shuffles below
  // always run with the whole warp.
  for (int base = 0; base < L; base += rows) {
    const int j = base + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (j < t) {
      raw = *reinterpret_cast<const uint4*>(k_cache + in_base + static_cast<long long>(j) * D);
    } else if (j == t) {
      raw = k_t;
    }
    if (j < L) *reinterpret_cast<uint4*>(k_out + out_base + static_cast<long long>(j) * D) = raw;
    const T* e = reinterpret_cast<const T*>(&raw);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) s = fmaf(qv[i], to_float(e[i]), s);
    for (int off = lpr / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (c == 0 && j <= t) probs[j] = s * scale;
  }
  __syncthreads();

  // softmax over positions 0..t: the TPU kernel's -1e9 on the others gives
  // them exp(-1e9 - max) = 0 exactly, so leaving them out is the same sum
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = -INFINITY;
    for (int j = lane; j <= t; j += 32) m = fmaxf(m, probs[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j <= t; j += 32) {
      const float e = expf(probs[j] - m);
      probs[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    // probabilities in the cache type before PV (decode_attention.py:161)
    for (int j = lane; j <= t; j += 32) probs[j] = to_float(from_float<T>(probs[j] / sum));
  }
  __syncthreads();

  // values: sum_j p_j v_j over positions <= t, and the permuted, updated V cache
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  for (int base = 0; base < L; base += rows) {
    const int j = base + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (j < t) {
      raw = *reinterpret_cast<const uint4*>(v_cache + in_base + static_cast<long long>(j) * D);
    } else if (j == t) {
      raw = v_t;
    }
    if (j < L) *reinterpret_cast<uint4*>(v_out + out_base + static_cast<long long>(j) * D) = raw;
    if (j <= t) {
      const float p = probs[j];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, to_float(e[i]), acc[i]);
    }
  }
  // sum the positions' partials: first across the warp's position groups,
  // then across warps in order
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < lpr) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) partial[warp * D + col + i] = acc[i];
  }
  __syncthreads();
  T* out = ctx + (static_cast<long long>(n) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += partial[w * D + d];
    out[d] = from_float<T>(s);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, long long q_row,
                   long long k_row, long long v_row, const void* k_cache, const void* v_cache,
                   const int* prev_k, void* ctx, void* k_out, void* v_out, int N, int H, int L,
                   int D, int t, int group, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L + kWarps * D) * sizeof(float);
  decode_attention_kernel<T><<<N * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      q_row, k_row, v_row, static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      prev_k, static_cast<T*>(ctx), static_cast<T*>(k_out), static_cast<T*>(v_out), H, L, D,
      t, group, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k_new, v_new: [N, H, D] with the given row strides (elements; [H, D]
// contiguous in a row, rows 16-byte aligned); k_cache, v_cache, k_out,
// v_out: contiguous [N, H, L, D]; ctx: contiguous [N, H, D]; prev_k: device
// int32 [N], values in [0, group). D * sizeof(T) must be 16 times a power of
// two no larger than 32, and 0 <= t < L. Launches on `stream` and returns
// cudaGetLastError().
int univl_decode_attention(const void* q, const void* k_new, const void* v_new,
                           long long q_row, long long k_row, long long v_row,
                           const void* k_cache, const void* v_cache, const void* prev_k,
                           void* ctx, void* k_out, void* v_out, int is_bf16, int N, int H,
                           int L, int D, int t, int group, float scale, void* stream) {
  const int* idx = static_cast<const int*>(prev_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_new, v_new, q_row, k_row, v_row, k_cache, v_cache,
                                      idx, ctx, k_out, v_out, N, H, L, D, t, group, scale, s)
              : launch<float>(q, k_new, v_new, q_row, k_row, v_row, k_cache, v_cache, idx, ctx,
                              k_out, v_out, N, H, L, D, t, group, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
