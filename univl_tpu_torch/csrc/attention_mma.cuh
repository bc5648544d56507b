// Tensor-core attention helpers shared by the port's bf16 attention kernels
// (attention.cu: the eval attention; train_attention.cu: the training
// attention's forward and backward), on top of mma.cuh.
//
// A head is D = 64 wide. Its rows are staged in shared memory as bf16 with
// cp.async, padded to 144 bytes so ldmatrix's eight rows hit distinct banks.
// A warp owns 16 rows of a product's output, so the accumulator layout of
// one product (q k^T) is the A-fragment layout of the next (p v) and the
// scores never leave registers. Scores are formed alike everywhere: q as the
// A operand and k as B, the head dim in four 16-deep steps in ascending
// order, then (acc * scale) + bias, two roundings; a probability is the
// quotient e / l taken as e (1 / l) plus one fma correction.

#pragma once

#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace univl {

constexpr float kKeyMaskBias = -1e9f;  // the TPU kernels' key bias for a masked key

constexpr int kD = 64;            // the head dim the tensor-core kernels take
constexpr int kRowPad = kD + 8;   // a staged row: 144 bytes, ldmatrix's 8 rows on distinct banks
constexpr int kDSteps = kD / 16;  // 16-deep steps of a product over the head dim
constexpr int kDTiles = kD / 8;   // 8-column tiles of a [16, kD] output

// Rows [0, n) of one head of a dense [., L, H * kD] bf16 tensor (src: its
// first row, rows ld elements apart) into `rows` staged rows of kRowPad,
// zeros past n, with cp.async 16-byte copies (the caller commits them).
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, long long ld,
                                           int n, int rows) {
  constexpr int kVec = kD / 8;
  for (int e = threadIdx.x; e < rows * kVec; e += blockDim.x) {
    const int r = e / kVec, c = (e % kVec) * 8;
    bf16* d = dst + r * kRowPad + c;
    if (r < n) {
      cp_async16(d, src + r * ld + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The key bias of keys [0, n) of batch row `mask` (a row of the f32 key
// mask): -1e9 where masked, 0 where kept, -inf for the padding keys [Lk, n)
// (no probability at all).
__device__ __forceinline__ void stage_bias(float* bias, const float* __restrict__ mask, int Lk,
                                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    bias[j] = j < Lk ? (1.0f - mask[j]) * kKeyMaskBias : -INFINITY;
  }
}

// A fragments of 16 staged rows over the head dim, a[kk] the step kk.
__device__ __forceinline__ void load_a(uint32_t (&a)[kDSteps][4], const bf16* rows, int lane) {
  const bf16* p = rows + (lane & 15) * kRowPad + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) ldmatrix_x4(a[kk], p + 16 * kk);
}

// B fragments of 16 staged rows read along the head dim, for a product
// with their transpose (k in q k^T, v in g v^T): b[kk][0..1] give the
// product's columns 0-7, b[kk][2..3] columns 8-15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[kDSteps][4], const bf16* rows, int lane) {
  const bf16* p = rows + ((lane & 7) + ((lane >> 4) << 3)) * kRowPad + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) ldmatrix_x4(b[kk], p + 16 * kk);
}

// x = A B^T over the head dim for a 16 x 16 tile; x[n] the columns 8n .. 8n + 7.
__device__ __forceinline__ void product16(float (&x)[2][4], const uint32_t (&a)[kDSteps][4],
                                          const uint32_t (&b)[kDSteps][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[n][r] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    mma16816(x[0], a[kk], b[kk][0], b[kk][1]);
    mma16816(x[1], a[kk], b[kk][2], b[kk][3]);
  }
}

// acc += A X for a 16 x 16 A (fragments a) and X 16 staged rows (the depth)
// of a [., kD] matrix, read across with ldmatrix.trans: p v, ds k, p^T g, ds^T q.
__device__ __forceinline__ void accumulate(float (&acc)[kDTiles][4], const uint32_t (&a)[4],
                                           const bf16* rows, int lane) {
  const bf16* p = rows + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRowPad + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < kDTiles / 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + 16 * np);
    mma16816(acc[2 * np], a, b[0], b[1]);
    mma16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// The A fragments of a 16 x 16 tile held in product16's layout, each value
// rounded to bf16 (the TPU kernels' astype points).
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// e / l given rl = 1 / l correctly rounded: e rl, then one fma correction
// (Markstein), the rounded quotient for normal operands as IEEE division
// gives it, without the division's range check and slow-path call in every
// score. A subnormal quotient (p < 2^-126) may differ in its last bit.
__device__ __forceinline__ float quotient(float e, float l, float rl) {
  const float q = __fmul_rn(e, rl);
  return fmaf(fmaf(-l, q, e), rl, q);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A score from its f32 product: scaled, then biased, two roundings as the
// TPU kernel and the plain version take them (no contraction into an fma).
__device__ __forceinline__ float score(float acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

// The scores of the 16-key chunk whose staged rows are `krows`, for the
// warp's 16 query rows (fragments qa): the f32 product, scaled, plus the key
// bias (bias: the chunk's 16 keys).
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&qa)[kDSteps][4],
                                       const bf16* krows, const float* bias, float scale,
                                       int lane) {
  uint32_t kb[kDSteps][4];
  load_bt(kb, krows, lane);
  product16(s, qa, kb);
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[n][r] = score(s[n][r], scale, bias[8 * n + 2 * t + (r & 1)]);
}

// Rows i and i + 8 (those below L) of [16, kD] accumulators times `scale`,
// rounded to bf16, into one head of a dense [., L, H * kD] tensor (dst: its
// first row, rows ld elements apart).
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[kDTiles][4],
                                           long long ld, int i, int L, float scale, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i + 8 * half;
    if (row < L) {
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        *reinterpret_cast<uint32_t*>(dst + row * ld + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
      }
    }
  }
}

}  // namespace univl
