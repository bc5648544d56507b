// Probe of design A for #3's bf16 forward (PERF.md, Findings), measured
// against the kept design B (csrc/ffn.cu) by ffn_design.py: one fused
// kernel a call. A persistent block owns 64 rows at a time: their x stays
// in shared memory, W1 and W2 stream through a TMA ring of three 32 KB
// stages for every 64 rows, each 64-wide F chunk's x W1 runs on wgmma
// m64n32k16 (each consumer warpgroup 32 of its columns), its bias, GELU and
// rounding go through a swizzled shared-memory tile, and h W2 accumulates
// into the [64, 768] output held in registers (3 x m64n128k16 a consumer:
// 192 f32 a thread). It writes y only (no pre, no LayerNorm): a lower bound
// of A's time. Built and loaded by ffn_design.py, never by the package.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRing = 3;                 // 32 KB stages: 4 W1 boxes or one W2 box
constexpr int kSlab = 64 * 64;           // bf16 elements of a 64 x 64 box
constexpr int kStage = 4 * kSlab;
constexpr int kX = 12 * kSlab;           // the block's 64 rows of x
constexpr size_t kSmem = (kX + kRing * kStage + 2 * kSlab) * 2 + 1024;

// d += A B^T over 16 of the depth, m64n32k16 (both operands K-major)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
// d += A B^T over 16 of the depth, m64n128k16 (both operands K-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// the TPU kernels' erf-GELU (as csrc/ffn.cu's bf16 route)
__device__ __forceinline__ float gelu(float x) {
  const float a = fabsf(x) * 0.70710678118654752f;
  const float e = __expf(-a * a);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, a, 1.0f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return x * 0.5f * (1.0f + copysignf(1.0f - poly * e, x));
}
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
// element (r, c) of a 64 x 64 box in TMA's 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

struct Maps {
  CUtensorMap x, w1, w2;
};

__global__ void __launch_bounds__(384, 1)
    design_a_kernel(const __grid_constant__ Maps m, const bf16* b1, const bf16* b2, bf16* y,
                    int M, int F) {
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing], xfull, xempty;
  bf16* xs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  bf16* ring = xs + kX;
  bf16* hs = ring + kRing * kStage;  // two 64 x 64 chunks of h
  const int tiles = (M + 63) / 64, chunks = F / 64;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      univl::mbar_init(&full[i], 1);
      univl::mbar_init(&empty[i], 2);
    }
    univl::mbar_init(&xfull, 1);
    univl::mbar_init(&xempty, 2);
    univl::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // the producer: x once a tile, then W1 and W2 a chunk at a time
    univl::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0, ti = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
        univl::mbar_wait(&xempty, (ti & 1) ^ 1);
        univl::mbar_arrive_expect_tx(&xfull, kX * 2);
        for (int s = 0; s < 12; ++s) {
          univl::tma_load_2d(xs + s * kSlab, &m.x, &xfull, 64 * s, tile * 64);
        }
        for (int ch = 0; ch < chunks; ++ch) {
          for (int q = 0; q < 6; ++q, ++it) {  // 3 stages of W1 rows, 3 of W2 columns
            const int st = it % kRing;
            univl::mbar_wait(&empty[st], ((it / kRing) & 1) ^ 1);
            univl::mbar_arrive_expect_tx(&full[st], kStage * 2);
            bf16* dst = ring + st * kStage;
            if (q < 3) {
              for (int i = 0; i < 4; ++i) {
                univl::tma_load_2d(dst + i * kSlab, &m.w1, &full[st], 256 * q + 64 * i, ch * 64);
              }
            } else {
              univl::tma_load_2d(dst, &m.w2, &full[st], ch * 64, 256 * (q - 3));
            }
          }
        }
      }
    }
  } else {
    univl::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x & 127, lane = t & 31;
    const int rl = 16 * (t >> 5) + (lane >> 2), cl = 2 * (lane & 3);
    const bool leader = t == 0;
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
      univl::mbar_wait(&xfull, ti & 1);
      float acc0[64], acc1[64], acc2[64];  // output columns 384 c + 128 i, i = 0..2
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = acc2[i] = 0.0f;
      univl::wgmma_fence_operands(acc0);
      univl::wgmma_fence_operands(acc1);
      univl::wgmma_fence_operands(acc2);
      for (int ch = 0; ch < chunks; ++ch) {
        float a1[16];  // this consumer's 32 columns of the chunk's x W1
#pragma unroll
        for (int i = 0; i < 16; ++i) a1[i] = 0.0f;
        univl::wgmma_fence_operands(a1);
        for (int q = 0; q < 3; ++q, ++it) {
          const int st = it % kRing;
          univl::mbar_wait(&full[st], (it / kRing) & 1);
          univl::wgmma_fence();
          const bf16* w = ring + st * kStage + c * 32 * 64;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int kk = 0; kk < 64; kk += 16)
              wgmma_m64n32k16(a1, univl::wgmma_desc(xs + (4 * q + i) * kSlab + kk),
                              univl::wgmma_desc(w + i * kSlab + kk));
          univl::wgmma_commit();
          univl::wgmma_wait<0>();
          if (leader) univl::mbar_arrive(&empty[st]);
        }
        univl::wgmma_fence_operands(a1);
        if (ch == chunks - 1 && leader) univl::mbar_arrive(&xempty);
        bf16* hb = hs + (ch & 1) * kSlab;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * c + 8 * j + cl;
          const float2 b =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + ch * 64 + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float p0 = rnd(rnd(a1[4 * j + 2 * half]) + b.x);
            const float p1 = rnd(rnd(a1[4 * j + 2 * half + 1]) + b.y);
            *reinterpret_cast<__nv_bfloat162*>(hb + swz(rl + 8 * half, col)) =
                __floats2bfloat162_rn(gelu(p0), gelu(p1));
          }
        }
        univl::fence_proxy_async();
        univl::named_barrier(3, 256);  // both consumers' halves of the chunk's h
        for (int q = 0; q < 3; ++q, ++it) {
          const int st = it % kRing;
          univl::mbar_wait(&full[st], (it / kRing) & 1);
          univl::wgmma_fence();
          const bf16* w = ring + st * kStage;
          const int g0 = 3 * c, g1 = 3 * c + 1, g2 = 3 * c + 2;  // 128-column blocks of W2
#pragma unroll
          for (int kk = 0; kk < 64; kk += 16) {
            const uint64_t da = univl::wgmma_desc(hb + kk);
            if (g0 / 2 == q) wgmma_m64n128k16(acc0, da, univl::wgmma_desc(w + (g0 % 2) * 8192 + kk));
            if (g1 / 2 == q) wgmma_m64n128k16(acc1, da, univl::wgmma_desc(w + (g1 % 2) * 8192 + kk));
            if (g2 / 2 == q) wgmma_m64n128k16(acc2, da, univl::wgmma_desc(w + (g2 % 2) * 8192 + kk));
          }
          univl::wgmma_commit();
          univl::wgmma_wait<0>();
          if (leader) univl::mbar_arrive(&empty[st]);
        }
      }
      univl::wgmma_fence_operands(acc0);
      univl::wgmma_fence_operands(acc1);
      univl::wgmma_fence_operands(acc2);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* a = i == 0 ? acc0 : i == 1 ? acc1 : acc2;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 384 * c + 128 * i + 8 * j + cl;
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = tile * 64 + rl + 8 * half;
            if (row < M) {
              *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(row) * 768 + col) =
                  __floats2bfloat162_rn(rnd(rnd(a[4 * j + 2 * half]) + b.x),
                                        rnd(rnd(a[4 * j + 2 * half + 1]) + b.y));
            }
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess || !fn) {
    return false;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)}, elem[2] = {1, 1};
  return reinterpret_cast<EncodeTiled>(fn)(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// y = round(round(gelu(round(round(x W1) + b1)) W2) + b2): x [M, 768], w1t [F, 768], w2t
// [768, F], bf16, F a multiple of 64. Returns a CUDA error code, or 1 if a map fails.
extern "C" int design_a_ffn_fwd(const void* x, const void* w1t, const void* b1, const void* w2t,
                                const void* b2, void* y, int M, int F, int sms, void* stream) {
  Maps m;
  if (!tensor_map(&m.x, x, M, 768, 64) || !tensor_map(&m.w1, w1t, F, 768, 64) ||
      !tensor_map(&m.w2, w2t, 768, F, 256)) {
    return 1;
  }
  cudaFuncSetAttribute(design_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kSmem));
  const int tiles = (M + 63) / 64;
  design_a_kernel<<<tiles < sms ? tiles : sms, 384, kSmem, static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(y), M, F);
  return static_cast<int>(cudaGetLastError());
}
