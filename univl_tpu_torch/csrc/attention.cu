// Eval attention for the PyTorch port, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel univl_tpu/kernels/attention.py:
// fused_attention_masked (its body is _attn_kernel), both branches:
//
//   out = softmax(q k^T / sqrt(D) + (1 - key_mask) * -1e9) v
//
// with the scores, the softmax and the PV sum in f32, and the probabilities
// rounded to the input type before the PV product, as the TPU kernel does.
// With `causal` (attention.py:47-51) every score whose key column is past
// its query row (j > i, compared directly, with no offset when Lq != Lk) is
// set to -1e9 after the key bias.
//
// What bounds it: UniVL's encoder attention is short (L <= 224) with D = 64,
// so one (batch row, head) pair does ~4 L^2 D flops over ~4 L D * 2 bytes,
// about 24 flop/byte at L = 48 and 48 at L = 96 -- far below the H100's
// ~295 flop/byte ridge. By the roofline the kernel is bound by memory
// traffic (at the FT-Align rescoring's [512, 12, 96, 64] in bf16, 0.09 ms)
// and, at a tower's few microseconds a call, by launch latency and
// occupancy. What it spends beyond that is the per-score work: the products,
// exp, the row reductions and the staging.
//
// Two routes; the wrapper (univl_tpu_torch/kernels/attention.py:cuda_route)
// picks one.
//
// The tensor-core kernel (bf16, D = 64, Lk <= 256: every bf16 call of the
// model). One block per (batch row, head, tile of 16 x warps query rows),
// so even a tower's [16, 12, 48, 64] spreads over the card. The block stages
// the head's k and v and its tile's q as bf16 with cp.async into 144-byte
// rows for ldmatrix (attention_mma.cuh). Each warp owns 16 query rows: their
// scores over all Lk keys stay in registers (8 floats a thread per 16 keys;
// instantiated for 2 to 16 chunks of 16 keys), the key bias and the causal
// test go into the score epilogue, the row max and sum are taken across each
// quad with shuffles -- the TPU kernel's whole-row softmax, no online
// rescaling -- and each probability, e / l taken as e (1 / l) plus one fma
// correction (the IEEE quotient for normal operands), is rounded to bf16
// straight into the A fragments of p v (mma.sync m16n8k16, f32
// accumulators; v read with ldmatrix.trans). The q k^T sums run in the
// tensor cores' order, so results are not bitwise the plain version's.
//
// The CUDA-core kernel (f32, and bf16 heads outside the limits above): the
// tensor cores would multiply f32 as TF32 (a 10-bit mantissa), which the
// card's f32 runs, held to 1e-5 of the plain version, cannot take. Every
// byte of q, k and v is read from device memory once, and the [Lq, Lk]
// scores never leave the SM. One block owns one (batch row, head); it stages
// that head's K and V in shared memory with 16-byte loads (converted to
// f32), then each warp takes query rows in turn. Scores: one key per lane,
// reading the query and the key row as float4 (K rows padded to D + 4
// floats, so the 8 lanes of each quarter-warp phase hit 32 distinct banks).
// Row max and sum: warp shuffles. PV: two output columns per lane, read as
// float2, with the probabilities read four at a time as a float4 broadcast.
// Sums run in a fixed order (d, then j, ascending).
//
// Both read strided views (the head-split [B, L, H, D] layout of the
// projections), so no transpose is materialised, and write the output into
// the [B, Lq, H, D] memory the wrapper allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_mma.cuh"
#include "opt_in.cuh"

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
                      Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal) {
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
      if (causal && j > i) s = kMaskBias;
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

// ---------------------------------------------------------------- bf16: tensor cores
// (the design is in the note at the top of the file)

using univl::accumulate;
using univl::bf16;
using univl::cp_async_commit;
using univl::cp_async_wait;
using univl::kD;
using univl::kDSteps;
using univl::kDTiles;
using univl::kRowPad;
using univl::kMaxDevices;
using univl::load_a;
using univl::opt_in_shared_memory;
using univl::quad_max;
using univl::quad_sum;
using univl::quotient;
using univl::scores;
using univl::stage_bias;
using univl::stage_rows;
using univl::store_rows;
using univl::to_a;

constexpr int kMmaMaxChunks = 16;  // a row's scores are held in registers: Lk <= 256
constexpr int kMmaMaxWarps = 4;

// One block per (b, h, tile of 16 x warps query rows); a warp's 16 rows of
// scores over all Lk <= 16 KC keys in registers.
template <int KC>
__global__ void __launch_bounds__(32 * kMmaMaxWarps)
eval_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ key_mask,
                          bf16* __restrict__ out, int H, int Lq, int Lk, Strides sq, Strides sk,
                          Strides sv, Strides so, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int rows = blockDim.x / 2;  // 16 a warp
  const int nc = (Lk + 15) / 16;    // 16-key chunks
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);                  // [16 nc][kRowPad]
  bf16* vs = ks + 16 * nc * kRowPad;                            // [16 nc][kRowPad]
  bf16* qs = vs + 16 * nc * kRowPad;                            // [rows][kRowPad]
  float* bias = reinterpret_cast<float*>(qs + rows * kRowPad);  // [16 nc]

  const int tiles = (Lq + rows - 1) / rows;
  const int b = blockIdx.x / tiles / H, h = blockIdx.x / tiles % H;
  const int i0 = blockIdx.x % tiles * rows;
  stage_rows(ks, k + b * sk.b + h * sk.h, sk.l, Lk, 16 * nc);
  stage_rows(vs, v + b * sv.b + h * sv.h, sv.l, Lk, 16 * nc);
  stage_rows(qs, q + b * sq.b + h * sq.h + i0 * sq.l, sq.l, min(rows, Lq - i0), rows);
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
      scores(s[c], qa, ks + 16 * c * kRowPad, bias + 16 * c, scale, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // after the key bias, a key past the row; the padding keys past Lk keep -inf
          const int j = 16 * c + 8 * n + 2 * t + (r & 1);
          if (causal && j > i + 8 * (r / 2) && j < Lk) s[c][n][r] = kMaskBias;
          mx[r / 2] = fmaxf(mx[r / 2], s[c][n][r]);
        }
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

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.0f;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < nc) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[c][n][r] = quotient(s[c][n][r], sum[r / 2], rsum[r / 2]);
      uint32_t pa[4];
      to_a(pa, s[c]);  // the probabilities rounded to bf16 (attention.py:56)
      accumulate(o, pa, vs + 16 * c * kRowPad, lane);
    }
  }
  store_rows(out + b * so.b + h * so.h, o, so.l, i, Lq, 1.0f, t);
}

// ---------------------------------------------------------------- launches

size_t smem_bytes(int Lk, int D) {
  const size_t lk4 = (Lk + 3) & ~3;
  return (static_cast<size_t>(Lk) * (2 * D + 5) + kWarps * (D + lk4)) * sizeof(float);
}

// The tensor-core kernel's: k and v, `warps` 16-row tiles of q, the key bias.
size_t mma_smem_bytes(int Lk, int warps) {
  const size_t nc = (Lk + 15) / 16;
  return (32 * nc + 16 * warps) * kRowPad * sizeof(bf16) + 16 * nc * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_mask,
                   void* out, int B, int H, int Lq, int Lk, int D, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, int causal, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = smem_bytes(Lk, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory(eval_attention_kernel<T>, done);
    if (err != cudaSuccess) return err;
  }
  eval_attention_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      static_cast<T*>(out), H, Lq, Lk, D, sq, sk, sv, so, scale, causal);
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_mma_chunks(const void* q, const void* k, const void* v, const float* key_mask,
                              void* out, int B, int H, int Lq, int Lk, Strides sq, Strides sk,
                              Strides sv, Strides so, float scale, int causal, int warps,
                              cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const size_t smem = mma_smem_bytes(Lk, warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_shared_memory(eval_attention_mma_kernel<KC>, done);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (Lq + 16 * warps - 1) / (16 * warps);
  eval_attention_mma_kernel<KC><<<B * H * tiles, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, static_cast<bf16*>(out), H, Lq, Lk, sq, sk, sv, so, scale, causal);
  return cudaGetLastError();
}

// The instance whose registers hold the row's scores: 32 keys apart.
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* key_mask,
                       void* out, int B, int H, int Lq, int Lk, Strides sq, Strides sk,
                       Strides sv, Strides so, float scale, int causal, int warps,
                       cudaStream_t s) {
#define UNIVL_EVAL_MMA(KC)                                                                    \
  return launch_mma_chunks<KC>(q, k, v, key_mask, out, B, H, Lq, Lk, sq, sk, sv, so, scale, \
                               causal, warps, s)
  switch ((Lk + 31) / 32) {
    case 1: UNIVL_EVAL_MMA(2);
    case 2: UNIVL_EVAL_MMA(4);
    case 3: UNIVL_EVAL_MMA(6);
    case 4: UNIVL_EVAL_MMA(8);
    case 5: UNIVL_EVAL_MMA(10);
    case 6: UNIVL_EVAL_MMA(12);
    case 7: UNIVL_EVAL_MMA(14);
    case 8: UNIVL_EVAL_MMA(16);
    default: return cudaErrorInvalidValue;
  }
#undef UNIVL_EVAL_MMA
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, so the caller can check the budget:
// the CUDA-core kernel's (warps = 0) or the tensor-core kernel's with
// `warps` 16-row query tiles a block.
long long univl_eval_attention_smem_bytes(int Lk, int D, int warps) {
  return static_cast<long long>(warps ? mma_smem_bytes(Lk, warps) : smem_bytes(Lk, D));
}

const char* univl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The CUDA-core kernel. q, k, v: [B, H, L, D] with the given element strides
// (last dim contiguous, 16-byte aligned rows); key_mask: contiguous f32
// [B, Lk]; out: [B, H, Lq, D] with its own strides; causal: 0 or 1. Launches
// on `stream` and returns cudaGetLastError().
int univl_eval_attention(const void* q, const void* k, const void* v, const void* key_mask,
                         void* out, int is_bf16, int B, int H, int Lq, int Lk, int D,
                         long long qb, long long qh, long long ql, long long kb, long long kh,
                         long long kl, long long vb, long long vh, long long vl, long long ob,
                         long long oh, long long ol, float scale, int causal, void* stream) {
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl}, so{ob, oh, ol};
  const float* mask = static_cast<const float*>(key_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Lq, Lk, D, sq, sk, sv, so,
                                      scale, causal, s)
              : launch<float>(q, k, v, mask, out, B, H, Lq, Lk, D, sq, sk, sv, so, scale,
                              causal, s);
  return static_cast<int>(err);
}

// The tensor-core kernel: the CUDA-core kernel's arguments for bf16 (D =
// 64, Lk <= 256), plus `warps` (1 to 4), the 16-row query tiles a block
// takes; otherwise cudaErrorInvalidValue and no launch.
int univl_eval_attention_mma(const void* q, const void* k, const void* v, const void* key_mask,
                             void* out, int B, int H, int Lq, int Lk, int D, long long qb,
                             long long qh, long long ql, long long kb, long long kh, long long kl,
                             long long vb, long long vh, long long vl, long long ob, long long oh,
                             long long ol, float scale, int causal, int warps, void* stream) {
  if (D != kD || Lk > 16 * kMmaMaxChunks || warps < 1 || warps > kMmaMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl}, so{ob, oh, ol};
  return static_cast<int>(launch_mma(q, k, v, static_cast<const float*>(key_mask), out, B, H,
                                     Lq, Lk, sq, sk, sv, so, scale, causal, warps,
                                     static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
