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
// x 768); the 3.75 GFLOP at the caption slice's R = 80 beam rows (7.5 at
// the MSRVTT eval's R = 160) take ~4 us (~8) at the tensor cores' bf16 rate,
// against ~14 us to read W.
//
// What the design does about it: a first kernel streams the vocabulary in
// tiles of kTileV rows of W through shared memory, and reduces each [rows,
// kTileV] logits tile on chip to per-row partials: the max, the sum of
// exp(logit - max), and the top-k with their vocab indices. A second
// kernel, one block per row, merges the partials of all vocab tiles:
// logsumexp = M + log(sum_j s_j exp(m_j - M)), then the top-k over the
// tiles' winners.
//
// In bf16 the tile kernel (vocab_tile_mma_kernel) runs on the tensor cores:
// one block a vocab tile holds up to kTcRows rows of h (the eval's 32 clips
// x beam 5; more rows take more row groups, grid.y), so each byte of W
// comes from device memory once, into shared memory once. h and the W tile
// stream together by depth, 64 (a 128-byte line of each row) at a time,
// through a ring of 2 or 3 cp.async stages (h, 123 to 246 KB at R = 80 to
// 160, cannot stay whole in shared memory beside a W ring); 8 warps, 2 over
// the rows x 4 over the vocab, run mma.sync m16n8k16 with f32 sums
// (fragments by ldmatrix from rows padded to 144 bytes, conflict-free).
// The tile's logits (+ bias) go through shared memory to the row
// reductions, 8 lanes a row. Two blocks an SM: the BERT vocab's 239 tiles
// are all resident at once, and one block's reductions overlap the other's
// loads (64-row tiles would read h twice as often from L2). The merge
// stages the tiles' winners in shared memory and takes each round's best
// from the tiles' heads. The first version ran every dtype
// on the CUDA cores, 16 rows a block (each W tile read again from L2 by
// every row tile): 18x its bound at R = 80. In f32 (the agreement runs)
// vocab_tile_kernel keeps that route: a [kTileR, kTileV] tile a block, each
// thread a 4 x 4 register tile, f32 sums over H in chunks of kChunkH; the
// tensor cores would multiply f32 as TF32.
//
// The classifier transform (univl_tpu_torch/kernels/vocab_topk.py,
// ``transform=``; the TPU kernel's transform branch, vocab_topk.py:106-133):
// with it, h is the decoder's raw hidden and the classifier's input is
//
//   ht = round(LN(gelu(h Wt^T + bt)) * g + b)      (f32 throughout, one rounding)
//
// with the erf GELU (erff stands in for the TPU kernel's A&S 7.1.26 erf,
// |err| <= 1.5e-7) and the TF LayerNorm (eps inside the rsqrt). Wt is
// [H_out, H_in], as nn.Linear stores it, in f32 (the parameter itself). On
// the TPU the grid runs in order and vocab tile 0 writes ht into a scratch
// that later tiles read; here the vocab tiles run in parallel and no block
// can wait on another, so two small kernels run first on the same stream: a
// dense + GELU kernel (a [16, 32] output tile per block, f32 sums on the CUDA
// cores, the depth in stages of 128, so that few barriers wait on device
// memory) into an f32 scratch, then a LayerNorm kernel (one block per row)
// that rounds once into the [R, H] scratch the tile kernel reads. The
// dense's 2 R H^2 flops (94 MFLOP at R = 80) are computed once, not in each
// of the 239 vocab tiles. One C entry point launches all four kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"
#include "opt_in.cuh"

namespace {

using univl::cp_async16;
using univl::cp_async_commit;
using univl::cp_async_wait;
using univl::ldmatrix_x4;
using univl::mma16816;

constexpr int kTileR = 16;    // rows of h per block
constexpr int kTileV = 128;   // vocab rows of W per block
constexpr int kChunkH = 32;   // hidden elements per shared-memory stage
constexpr int kThreads = 128;  // 4 warps: warp w owns rows 4w..4w+3, lane l cols 4l..4l+3
constexpr int kMaxK = 32;
constexpr int kMergeThreads = 256;
constexpr int kTfRows = 16;     // transform: rows of h per dense block
constexpr int kTfCols = 32;     // output columns per dense block
constexpr int kTfChunk = 128;   // input elements per shared-memory stage
constexpr int kTfThreads = 128;  // thread t: column t % 32, rows 4 (t / 32) .. + 3
constexpr int kLnThreads = 256;
constexpr float kRsqrt2 = 0.70710678118654752f;
// bf16 tile kernel (tensor cores): kTileV vocab rows a block, as above
constexpr int kTcRows = 160;               // rows of h a block (a row group)
constexpr int kTcDepth = 64;               // depth of a stage: a 128-byte line of each row
constexpr int kTcThreads = 256;            // 8 warps: 2 over the rows x 4 over the vocab
constexpr int kTcLd = kTcDepth + 8;        // a staged row: 144 bytes, conflict-free ldmatrix
constexpr int kTcMtWarp = kTcRows / 32;    // m16 tiles a warp: every other one
constexpr int kLtLd = kTileV + 8;          // an f32 logits row: 4 rows of a warp, 32 banks
constexpr int kRowLanes = 8;               // lanes a row in the reductions
constexpr size_t kTcSmemTarget = 112 * 1024;  // two blocks an SM
static_assert(kTcRows % 32 == 0 && kTileV == 4 * 32, "the warps' layout over the tile");

// The ring's stages for row groups of `rows` (padded to m16 tiles): 3 where
// two blocks an SM leave room for them, else 2. At 80 rows 3 stages take
// 0.0440 ms against 2's 0.0460; at 160 rows 3 (one block an SM) take 0.0831
// against 2's 0.0650; a fourth gains nothing at 35 rows (PERF.md).
int tc_stages(int rows) {
  const int rp = (rows + 15) / 16 * 16;
  return kTcSmemTarget >= 3 * (rp + kTileV) * kTcLd * sizeof(__nv_bfloat16) ? 3 : 2;
}

// Dynamic shared memory of the bf16 tile kernel: the ring, or the logits
// tile that reuses it.
size_t tc_smem_bytes(int rows, int stages) {
  const size_t rp = (rows + 15) / 16 * 16;
  const size_t ring = stages * (rp + kTileV) * kTcLd * sizeof(__nv_bfloat16);
  const size_t logits = rp * kLtLd * sizeof(float);
  return ring > logits ? ring : logits;
}

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

// (value, index) a is ranked above b: larger value, or equal value and lower index
__device__ __forceinline__ bool ranks_above(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The per-row partials of a logits tile in shared memory (lt: rows of ld
// floats, kTileV columns, row r of the tile is row row0 + r of h): kLanes
// lanes a row (32: a warp; 8: four rows a warp at once, so four chains of
// shuffles overlap), lane l of a row's group holding columns l, l + kLanes,
// ... They reduce the row to the max, the sum of exp(logit - max) and the
// top-k (ties to the lower index), into slot tile * R + row.
template <int kWarpsPerBlock, int kLanes>
__device__ __forceinline__ void row_partials(const float* lt, int ld, int rows, int row0, int R,
                                             int tile, long long v0, int k,
                                             float* __restrict__ part_val,
                                             int* __restrict__ part_idx,
                                             float* __restrict__ part_max,
                                             float* __restrict__ part_sum) {
  constexpr int kPerLane = kTileV / kLanes;
  constexpr int kRowsPerWarp = 32 / kLanes;
  static_assert(kPerLane <= 32, "the taken mask holds a lane's columns");
  const int warp = threadIdx.x / 32;
  const int l = threadIdx.x % kLanes;
  const bool leader = l == 0;
  // the warp's rows r0 + (lane / kLanes); the loop's bounds are the same for
  // the whole warp, so every shuffle has all its lanes
  for (int r0 = warp * kRowsPerWarp; r0 < rows && row0 + r0 < R;
       r0 += kWarpsPerBlock * kRowsPerWarp) {
    const int r = r0 + (threadIdx.x % 32) / kLanes, row = row0 + r;
    const bool valid = r < rows && row < R;
    float x[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) x[i] = valid ? lt[r * ld + l + kLanes * i] : 0.0f;
    float m = x[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = fmaxf(m, x[i]);
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s += expf(x[i] - m);
    for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const long long slot = static_cast<long long>(tile) * R + row;
    if (leader && valid) {
      part_max[slot] = m;
      part_sum[slot] = s;
    }
    unsigned taken = 0u;  // bit i: x[i] is already among the winners
    for (int round = 0; round < k; ++round) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int col = l + kLanes * i;
        if (!(taken >> i & 1u) && ranks_above(x[i], col, bv, bi)) {
          bv = x[i];
          bi = col;
        }
      }
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ranks_above(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bi % kLanes == l && bi < kTileV) taken |= 1u << (bi / kLanes);
      if (leader && valid) {
        part_val[slot * k + round] = bv;
        part_idx[slot * k + round] = static_cast<int>(v0) + bi;
      }
    }
  }
}

// The f32 tile kernel (CUDA cores): rows [row0, row0 + kTileR) of h,
// row0 = blockIdx.x * kTileR, against vocab tile blockIdx.y.
__global__ void __launch_bounds__(kThreads)
vocab_tile_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ bias, int R, int H, int k,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  float* __restrict__ part_max, float* __restrict__ part_sum) {
  constexpr int kVec = 16 / sizeof(float);
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
    const float* wrow = w + (v0 + threadIdx.x) * H + k0;
#pragma unroll
    for (int e0 = 0; e0 < kChunkH; e0 += kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wrow + e0);
      const float* e = reinterpret_cast<const float*>(&raw);
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

  row_partials<kThreads / 32, 32>(lt, kLd, kTileR, row0, R, tile, v0, k, part_val, part_idx,
                                  part_max, part_sum);
}

// The bf16 tile kernel: vocab tile blockIdx.x against rows [row0, row0 +
// kTcRows) of h, row0 = blockIdx.y * kTcRows, on the tensor cores, through
// a ring of kStages (tc_stages). H a multiple of kTcDepth; h and w 16-byte
// aligned. Two blocks an SM (128 registers a thread; shared memory from
// tc_smem_bytes: 88 KB at 80 rows, 85 KB at 160), so one block's
// reductions overlap the other's loads and all 239 tiles of BERT's vocab
// are resident at once.
template <int kTcStages>
__global__ void __launch_bounds__(kTcThreads, 2)
vocab_tile_mma_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias, int R, int H, int k,
                      float* __restrict__ part_val, int* __restrict__ part_idx,
                      float* __restrict__ part_max, float* __restrict__ part_sum) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kTcRows;
  const int rows = min(kTcRows, R - row0);
  const int mt = (rows + 15) / 16;  // m16 tiles with rows of h
  const int stage_h = (min(kTcRows, R) + 15) / 16 * 16;  // rows of a staged h: the first group's
  bf16* hs = reinterpret_cast<bf16*>(tc_smem);  // kTcStages x [stage_h rows][kTcLd]
  bf16* ws = hs + kTcStages * stage_h * kTcLd;  // kTcStages x [kTileV][kTcLd]
  const long long v0 = static_cast<long long>(tile) * kTileV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 1;   // the warp's m16 tiles: wm, wm + 2, ...
  const int wn = warp >> 1;  // its 32 vocab columns: 32 wn ..
  const int steps = H / kTcDepth;
  constexpr int kChunks = kTcDepth / 8;  // 16-byte copies a staged row

  // rows past R in the last m16 tile: zeros, which no copy overwrites
  const int pad = mt * 16 - rows;
  for (int e = threadIdx.x; e < kTcStages * pad * kChunks; e += kTcThreads) {
    const int st = e / (pad * kChunks), rem = e % (pad * kChunks);
    *reinterpret_cast<uint4*>(hs + (st * stage_h + rows + rem / kChunks) * kTcLd +
                              (rem % kChunks) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  // stage `step` of the depth into ring buffer `st`: 16-byte copies
  const auto load = [&](int st, int step) {
    const int k0 = step * kTcDepth;
    bf16* hd = hs + st * stage_h * kTcLd;
    bf16* wd = ws + st * kTileV * kTcLd;
    for (int e = threadIdx.x; e < rows * kChunks; e += kTcThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      cp_async16(hd + r * kTcLd + c, h + static_cast<long long>(row0 + r) * H + k0 + c);
    }
    for (int e = threadIdx.x; e < kTileV * kChunks; e += kTcThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      cp_async16(wd + r * kTcLd + c, w + (v0 + r) * H + k0 + c);
    }
  };
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < steps) load(st, st);
    cp_async_commit();
  }

  // acc[i][j]: m16 tile wm + 2 i, n8 tile j of the warp's 32 columns
  float acc[kTcMtWarp][4][4];
#pragma unroll
  for (int i = 0; i < kTcMtWarp; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kTcStages - 2>();  // this thread's copies of stage `step` have landed
    __syncthreads();  // everyone's have, and every warp is done with the buffer refilled next
    const int next = step + kTcStages - 1;
    if (next < steps) load(next % kTcStages, next);
    cp_async_commit();
    const bf16* hb = hs + (step % kTcStages) * stage_h * kTcLd;
    const bf16* wb = ws + (step % kTcStages) * kTileV * kTcLd;
#pragma unroll
    for (int kk = 0; kk < kTcDepth; kk += 16) {
      // B: two ldmatrix.x4 of 16 vocab rows each; matrix q = lane / 8 is n8
      // tile q / 2 of the pair at depth half q % 2, so b[p][2 t], b[p][2 t +
      // 1] are n8 tile 2 p + t's two fragment registers
      uint32_t b[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = lane / 8;
        ldmatrix_x4(b[p], wb + (wn * 32 + p * 16 + (q / 2) * 8 + lane % 8) * kTcLd + kk +
                              (q % 2) * 8);
      }
#pragma unroll
      for (int i = 0; i < kTcMtWarp; ++i) {
        const int m = wm + 2 * i;
        if (m < mt) {  // the same for the whole warp
          uint32_t a[4];
          ldmatrix_x4(a, hb + (m * 16 + lane % 16) * kTcLd + kk + (lane / 16) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma16816(acc[i][j], a, b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which the logits tile overwrites

  // the logits tile (+ bias), [mt * 16][kLtLd] f32, then the row partials.
  // Accumulator (PTX m16n8k16, g = lane / 4, t = lane % 4): e 0, 1 row g,
  // columns 2 t, 2 t + 1; e 2, 3 row g + 8.
  float* lt = reinterpret_cast<float*>(tc_smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kTcMtWarp; ++i) {
    const int m = wm + 2 * i;
    if (m >= mt) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + 2 * t;
      const float2 bv = make_float2(bias[v0 + col], bias[v0 + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float2*>(lt + (m * 16 + g + 8 * half) * kLtLd + col) =
            make_float2(acc[i][j][2 * half] + bv.x, acc[i][j][2 * half + 1] + bv.y);
      }
    }
  }
  __syncthreads();
  row_partials<kTcThreads / 32, kRowLanes>(lt, kLtLd, rows, row0, R, tile, v0, k, part_val,
                                           part_idx, part_max, part_sum);
}

// One block per row: logsumexp over the vocab tiles' partials, then the
// top-k of the tiles' winners, written as log-probabilities. Each tile's k
// winners are already in rank order, so the merge keeps a head per tile:
// all winners are staged in shared memory first (their loads overlap the
// logsumexp's), and each round takes the best head (ties to the lower
// vocab index) and advances that tile's head. The rounds read shared
// memory only.
__global__ void __launch_bounds__(kMergeThreads)
vocab_merge_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                   const float* __restrict__ part_max, const float* __restrict__ part_sum,
                   int R, int n_tiles, int k, float* __restrict__ out_logp,
                   long long* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  float* cand_v = reinterpret_cast<float*>(merge_smem);  // [n_tiles][k]
  int* cand_i = reinterpret_cast<int*>(cand_v + n_tiles * k);
  int* head = cand_i + n_tiles * k;  // [n_tiles]: the tile's next winner
  __shared__ float red_v[kMergeThreads / 32];
  __shared__ int red_i[kMergeThreads / 32];
  __shared__ int red_t[kMergeThreads / 32];
  __shared__ float lse_s;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int p = threadIdx.x; p < n_tiles * k; p += kMergeThreads) {
    const long long at = (static_cast<long long>(p / k) * R + row) * k + p % k;
    cand_v[p] = part_val[at];
    cand_i[p] = part_idx[at];
  }
  for (int j = threadIdx.x; j < n_tiles; j += kMergeThreads) head[j] = 0;
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

  for (int round = 0; round < k; ++round) {
    float bv = -INFINITY;
    int bi = 0x7fffffff, bt = -1;
    for (int j = threadIdx.x; j < n_tiles; j += kMergeThreads) {
      if (head[j] < k) {
        const float v = cand_v[j * k + head[j]];
        const int vi = cand_i[j * k + head[j]];
        if (ranks_above(v, vi, bv, bi)) {
          bv = v;
          bi = vi;
          bt = j;
        }
      }
    }
    // block argmax over (value, vocab index); the winner's tile travels with it
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
      if (ranks_above(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bt = ot;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
      red_t[warp] = bt;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 1; i < kMergeThreads / 32; ++i) {
        if (ranks_above(red_v[i], red_i[i], bv, bi)) {
          bv = red_v[i];
          bi = red_i[i];
          bt = red_t[i];
        }
      }
      if (bt >= 0) ++head[bt];
      out_logp[static_cast<long long>(row) * k + round] = bv - lse;
      out_idx[static_cast<long long>(row) * k + round] = bi;
    }
    __syncthreads();
  }
}

size_t merge_smem_bytes(int n_tiles, int k) {
  return static_cast<size_t>(n_tiles) * (2 * k + 1) * sizeof(int);
}
constexpr size_t kMaxMergeSmem = 200 * 1024;  // under the opt-in limit beside the static arrays

// u[r][c] = gelu(sum_k h[r][k] wt[c][k] + bt[c]), all in f32
template <typename T>
__global__ void __launch_bounds__(kTfThreads)
cls_dense_gelu_kernel(const T* __restrict__ h, const float* __restrict__ wt,
                      const float* __restrict__ bt, int R, int H, float* __restrict__ u) {
  __shared__ float hs[kTfChunk][kTfRows + 1];
  __shared__ float ws[kTfChunk][kTfCols + 1];
  const int row0 = blockIdx.x * kTfRows;
  const int col0 = blockIdx.y * kTfCols;
  const int c = threadIdx.x % kTfCols;
  const int r0 = (threadIdx.x / kTfCols) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < H; k0 += kTfChunk) {
    for (int e = threadIdx.x; e < kTfRows * kTfChunk; e += kTfThreads) {
      const int r = e / kTfChunk, kk = e % kTfChunk;
      hs[kk][r] = row0 + r < R ? to_float(h[static_cast<long long>(row0 + r) * H + k0 + kk])
                               : 0.0f;
    }
    for (int e = threadIdx.x; e < kTfCols * kTfChunk / 4; e += kTfThreads) {
      const int cc = e / (kTfChunk / 4), kk = 4 * (e % (kTfChunk / 4));
      const float4 v =
          *reinterpret_cast<const float4*>(wt + static_cast<long long>(col0 + cc) * H + k0 + kk);
      ws[kk][cc] = v.x;
      ws[kk + 1][cc] = v.y;
      ws[kk + 2][cc] = v.z;
      ws[kk + 3][cc] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTfChunk; ++kk) {
      const float b = ws[kk][c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(hs[kk][r0 + i], b, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + r0 + i;
    if (row < R) {
      const float t = acc[i] + bt[col0 + c];
      u[static_cast<long long>(row) * H + col0 + c] = t * 0.5f * (1.0f + erff(t * kRsqrt2));
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red may still be read from the previous sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int i = 0; i < kLnThreads / 32; ++i) total += red[i];
  return total;
}

// one block per row: ht[r] = round((u[r] - mean) rsqrt(var + eps) g + b)
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
cls_layernorm_kernel(const float* __restrict__ u, const float* __restrict__ g,
                     const float* __restrict__ b, int H, float eps, T* __restrict__ ht) {
  __shared__ float red[kLnThreads / 32];
  const float* x = u + static_cast<long long>(blockIdx.x) * H;
  float s = 0.0f;
  for (int c = threadIdx.x; c < H; c += kLnThreads) s += x[c];
  const float mean = block_sum(s, red) / H;
  float q = 0.0f;
  for (int c = threadIdx.x; c < H; c += kLnThreads) {
    const float d = x[c] - mean;
    q = fmaf(d, d, q);
  }
  const float inv = rsqrtf(block_sum(q, red) / H + eps);
  T* y = ht + static_cast<long long>(blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += kLnThreads) {
    y[c] = from_float<T>((x[c] - mean) * inv * g[c] + b[c]);
  }
}

// The tile kernel of h's type (bf16: the tensor cores; f32: the CUDA cores),
// then the merge.
cudaError_t launch(const void* h, const void* w, const float* bias, bool is_bf16, int R, int H,
                   int Vp, int k, float* part_val, int* part_idx, float* part_max,
                   float* part_sum, float* out_logp, long long* out_idx, cudaStream_t stream) {
  const int n_tiles = Vp / kTileV;
  if (is_bf16) {
    const int rows = R < kTcRows ? R : kTcRows;
    const int stages = tc_stages(rows);
    const auto kernel = stages == 2 ? &vocab_tile_mma_kernel<2> : &vocab_tile_mma_kernel<3>;
    static std::atomic<bool> done[2][univl::kMaxDevices];
    const cudaError_t err = univl::opt_in_shared_memory(kernel, done[stages - 2]);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_tiles, (R + kTcRows - 1) / kTcRows);
    kernel<<<grid, kTcThreads, tc_smem_bytes(rows, stages), stream>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w), bias, R, H,
        k, part_val, part_idx, part_max, part_sum);
  } else {
    const dim3 grid((R + kTileR - 1) / kTileR, n_tiles);
    vocab_tile_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bias, R, H, k, part_val,
        part_idx, part_max, part_sum);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // past 48 KB (k > 24 at BERT's 239 tiles) the merge needs the opt-in
  static std::atomic<bool> merge_done[univl::kMaxDevices];
  const cudaError_t opt = univl::opt_in_shared_memory(vocab_merge_kernel, merge_done);
  if (opt != cudaSuccess) return opt;
  vocab_merge_kernel<<<R, kMergeThreads, merge_smem_bytes(n_tiles, k), stream>>>(
      part_val, part_idx, part_max, part_sum, R, n_tiles, k, out_logp, out_idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_transform(const void* h, const float* wt, const float* bt, const float* g,
                             const float* b, float eps, float* u, void* ht, int R, int H,
                             cudaStream_t stream) {
  const dim3 grid((R + kTfRows - 1) / kTfRows, H / kTfCols);
  cls_dense_gelu_kernel<T><<<grid, kTfThreads, 0, stream>>>(static_cast<const T*>(h), wt, bt,
                                                            R, H, u);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cls_layernorm_kernel<T><<<R, kLnThreads, 0, stream>>>(u, g, b, H, eps, static_cast<T*>(ht));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h: contiguous [R, H]; w: contiguous [Vp, H] of h's type, Vp a multiple of
// the vocab tile; bias: contiguous f32 [Vp]; H a multiple of the hidden
// chunk (f32) or of the stage depth (bf16); 1 <= k <= kMaxK. part_*:
// scratch of n_tiles * R (* k) entries; out_logp: f32 [R, k]; out_idx: int64
// [R, k]. Launches two kernels on `stream` (bf16: the tensor-core tile
// kernel; f32: the CUDA-core one); returns the first CUDA error.
int univl_vocab_topk(const void* h, const void* w, const void* bias, int is_bf16, int R, int H,
                     int Vp, int k, void* part_val, void* part_idx, void* part_max,
                     void* part_sum, void* out_logp, void* out_idx, void* stream) {
  if (R < 1 || k < 1 || k > kMaxK || Vp % kTileV != 0 || H % (is_bf16 ? kTcDepth : kChunkH) ||
      merge_smem_bytes(Vp / kTileV, k) > kMaxMergeSmem) {
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
  return static_cast<int>(launch(h, w, b, is_bf16, R, H, Vp, k, pv, pi, pm, ps, ol, oi, s));
}

// univl_vocab_topk with the classifier transform first: h is the raw hidden
// [R, H]; wt: contiguous f32 [H, H] (nn.Linear's [out, in]); bt, g, b: f32
// [H]; H a multiple of 128. u: f32 scratch [R, H]; ht: scratch [R, H] of h's
// type, which the vocab kernels then read in place of h. Launches four
// kernels on `stream`; returns the first CUDA error.
int univl_vocab_topk_transform(const void* h, const void* wt, const void* bt, const void* g,
                               const void* b, float eps, void* u, void* ht, const void* w,
                               const void* bias, int is_bf16, int R, int H, int Vp, int k,
                               void* part_val, void* part_idx, void* part_max, void* part_sum,
                               void* out_logp, void* out_idx, void* stream) {
  if (R < 1 || k < 1 || k > kMaxK || Vp % kTileV != 0 || H % kTfChunk != 0 ||
      H % kChunkH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float *wtf = static_cast<const float*>(wt), *btf = static_cast<const float*>(bt);
  const float *gf = static_cast<const float*>(g), *bf = static_cast<const float*>(b);
  float* uf = static_cast<float*>(u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_transform<__nv_bfloat16>(h, wtf, btf, gf, bf, eps, uf, ht, R, H, s)
              : launch_transform<float>(h, wtf, btf, gf, bf, eps, uf, ht, R, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return univl_vocab_topk(ht, w, bias, is_bf16, R, H, Vp, k, part_val, part_idx, part_max,
                          part_sum, out_logp, out_idx, stream);
}

}  // extern "C"
