// Eval attention for the PyTorch port, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel univl_tpu/kernels/attention.py:
// fused_attention_masked (its body is _attn_kernel, causal=False):
//
//   out = softmax(q k^T / sqrt(D) + (1 - key_mask) * -1e9) v
//
// with the scores, the softmax and the PV sum in f32, and the probabilities
// rounded to the input type before the PV product, as the TPU kernel does.
//
// What bounds it: UniVL's encoder attention is short (L <= 96) with D = 64,
// so one (batch row, head) pair does ~4 L^2 D flops over ~4 L D * 2 bytes,
// about 24 flop/byte at L = 48 -- far below the H100's ~295 flop/byte ridge.
// The kernel is bound by memory traffic and latency, not by the tensor cores.
//
// What the design does about it: every byte of q, k and v is read from
// device memory once, and the [Lq, Lk] scores never leave the SM. One block
// owns one (batch row, head); it stages that head's K and V in shared memory
// with 16-byte loads (converted to f32), then each warp takes query rows in
// turn. Scores: one key per lane, reading the query and the key row as float4
// (K rows padded to D + 4 floats, so the 8 lanes of each quarter-warp phase hit
// 32 distinct banks). Row max and sum: warp shuffles. PV: two output columns
// per lane, read as float2, with the probabilities read four at a time as a
// float4 broadcast. Sums run in a fixed order (d, then j, ascending). Inputs may
// be strided views (the head-split [B, L, H, D] layout of the projections), so
// no transpose is materialised. Tensor-core products (mma.sync / wgmma), TMA
// and several heads per block are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskBias = -1e9f;  // univl_tpu/kernels/attention.py:45

struct Strides {
  long long b, h, l;  // elements; the last dim has stride 1
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
eval_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ key_mask,
                      T* __restrict__ out, int H, int Lq, int Lk, int D,
                      Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float smem[];
  const int kstride = D + 4;
  const int lk4 = (Lk + 3) & ~3;
  float* ks = smem;                 // [Lk][D + 4]
  float* vs = ks + Lk * kstride;    // [Lk][D]
  float* qs = vs + Lk * D;          // [kWarps][D]
  float* ps = qs + kWarps * D;      // [kWarps][lk4]
  float* bias = ps + kWarps * lk4;  // [Lk]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int chunks = D / kVec;
  for (int c = threadIdx.x; c < Lk * chunks; c += kThreads) {
    const int j = c / chunks;
    const int d0 = (c % chunks) * kVec;
    const uint4 kraw = *reinterpret_cast<const uint4*>(kb + j * sk.l + d0);
    const uint4 vraw = *reinterpret_cast<const uint4*>(vb + j * sv.l + d0);
    const T* kv = reinterpret_cast<const T*>(&kraw);
    const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      ks[j * kstride + d0 + t] = to_float(kv[t]);
      vs[j * D + d0 + t] = to_float(vv[t]);
    }
  }
  for (int j = threadIdx.x; j < Lk; j += kThreads) {
    bias[j] = (1.0f - key_mask[static_cast<long long>(b) * Lk + j]) * kMaskBias;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = qs + warp * D;
  float* pw = ps + warp * lk4;
  const float4* q4 = reinterpret_cast<const float4*>(qw);
  for (int i = warp; i < Lq; i += kWarps) {
    const T* qrow = q + b * sq.b + h * sq.h + i * sq.l;
    for (int d = lane; d < D; d += 32) qw[d] = to_float(qrow[d]);
    __syncwarp();

    float row_max = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float4* k4 = reinterpret_cast<const float4*>(ks + j * kstride);
      float s = 0.0f;
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = q4[d4];
        const float4 c = k4[d4];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      s = s * scale + bias[j];
      pw[j] = s;
      row_max = fmaxf(row_max, s);
    }
    for (int off = 16; off > 0; off >>= 1) {
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    }
    float row_sum = 0.0f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pw[j] - row_max);
      pw[j] = e;
      row_sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) {
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    }
    // probs in the input type before PV (univl_tpu/kernels/attention.py:56)
    for (int j = lane; j < Lk; j += 32) pw[j] = to_float(from_float<T>(pw[j] / row_sum));
    __syncwarp();

    T* orow = out + b * so.b + h * so.h + i * so.l;
    for (int d2 = lane; d2 < D / 2; d2 += 32) {
      const float* vcol = vs + 2 * d2;
      float ax = 0.0f, ay = 0.0f;
      int j = 0;
      for (; j + 4 <= Lk; j += 4) {
        const float4 p = *reinterpret_cast<const float4*>(pw + j);
        const float2 v0 = *reinterpret_cast<const float2*>(vcol + (j + 0) * D);
        const float2 v1 = *reinterpret_cast<const float2*>(vcol + (j + 1) * D);
        const float2 v2 = *reinterpret_cast<const float2*>(vcol + (j + 2) * D);
        const float2 v3 = *reinterpret_cast<const float2*>(vcol + (j + 3) * D);
        ax = fmaf(p.x, v0.x, ax);
        ay = fmaf(p.x, v0.y, ay);
        ax = fmaf(p.y, v1.x, ax);
        ay = fmaf(p.y, v1.y, ay);
        ax = fmaf(p.z, v2.x, ax);
        ay = fmaf(p.z, v2.y, ay);
        ax = fmaf(p.w, v3.x, ax);
        ay = fmaf(p.w, v3.y, ay);
      }
      for (; j < Lk; ++j) {
        const float2 vj = *reinterpret_cast<const float2*>(vcol + j * D);
        ax = fmaf(pw[j], vj.x, ax);
        ay = fmaf(pw[j], vj.y, ay);
      }
      orow[2 * d2] = from_float<T>(ax);
      orow[2 * d2 + 1] = from_float<T>(ay);
    }
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

size_t smem_bytes(int Lk, int D) {
  const size_t lk4 = (Lk + 3) & ~3;
  return (static_cast<size_t>(Lk) * (2 * D + 5) + kWarps * (D + lk4)) * sizeof(float);
}

constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a block needs the per-kernel opt-in.
// It is set once per device and instantiation, to the device's largest
// block size, so a launch makes no driver call besides the launch itself.
// Two threads may both set it on first use; the call is idempotent.
template <typename T>
cudaError_t opt_in_shared_memory() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(eval_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_mask,
                   void* out, int B, int H, int Lq, int Lk, int D, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Lk, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory<T>();
    if (err != cudaSuccess) return err;
  }
  eval_attention_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      static_cast<T*>(out), H, Lq, Lk, D, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, so the caller can check the budget.
long long univl_eval_attention_smem_bytes(int Lk, int D) {
  return static_cast<long long>(smem_bytes(Lk, D));
}

const char* univl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v: [B, H, L, D] with the given element strides (last dim contiguous,
// 16-byte aligned rows); key_mask: contiguous f32 [B, Lk]; out: [B, H, Lq, D]
// with its own strides. Launches on `stream` and returns cudaGetLastError().
int univl_eval_attention(const void* q, const void* k, const void* v, const void* key_mask,
                         void* out, int is_bf16, int B, int H, int Lq, int Lk, int D,
                         long long qb, long long qh, long long ql, long long kb, long long kh,
                         long long kl, long long vb, long long vh, long long vl, long long ob,
                         long long oh, long long ol, float scale, void* stream) {
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl}, so{ob, oh, ol};
  const float* mask = static_cast<const float*>(key_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                                      scale, s)
              : launch<float>(q, k, v, mask, out, B, H, Lq, Lk, D, sq, sk, sv, so, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
