// Tensor-core and copy helpers shared by the port's bf16 kernels
// (vocab_topk.cu, ffn.cu's packing, and through attention_mma.cuh
// attention.cu and train_attention.cu): cp.async 16-byte copies to shared memory, fragment
// loads (ldmatrix, plain 32-bit pairs), the warp-wide transpose of an 8 x 8
// fragment (movmatrix) and mma.sync m16n8k16 with bf16 operands and f32
// accumulators.
//
// Fragment layout of m16n8k16 (PTX ISA, g = lane / 4, t = lane % 4): A rows g
// and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9 (a[0] rows g cols 0-7,
// a[1] rows g + 8 cols 0-7, a[2] rows g cols 8-15, a[3] rows g + 8 cols
// 8-15); B depth 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; C c[0..1] row g,
// c[2..3] row g + 8, columns 2t, 2t + 1. In each 32-bit register the lower
// half holds the element of the smaller column (or depth).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace univl {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += A B for one 16 x 8 tile, 16 deep, bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8m .. 8m + 7 give the
// addresses of matrix m's eight 16-byte rows; r[m] is its fragment (row g,
// elements 2t, 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, each matrix transposed: r[m] holds elements (2t, g) and (2t + 1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The fragment of an 8 x 8 bf16 matrix (row g, elements 2t, 2t + 1 in each
// lane) -> the fragment of its transpose, across the warp in registers.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Two f32 values rounded to bf16 and packed, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace univl
