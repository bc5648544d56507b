// Grouped in-place beam reorder for the PyTorch port, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel univl_tpu/kernels/reorder.py:
// beam_reorder_groups_inplace. Rows permute only within consecutive groups
// of `group` rows (beam search: group = beam width K, rows [g K, (g+1) K)
// are instance g's beams):
//
//   out[g K + k] = in[g K + prev_k[g K + k]]     for every array, in place.
//
// What bounds it: it is a copy. Every byte of every array is read once and
// written once (~70.8 MB at the caption slice's 6 caches of [80,12,48,64]
// bf16), so device-memory bandwidth is the only limit.
//
// What the design does about it: one launch covers all arrays (up to
// kMaxArrays). A block owns one (array, group, column chunk): it reads the
// chunk of its group's K source rows into shared memory with 16-byte loads,
// waits for the whole block (__syncthreads), then writes the K destination
// rows. That staging is what makes the permutation safe in place, the
// counterpart of the TPU kernel loading every source row of its group
// before the first store; no two blocks touch the same bytes. Neighbouring
// threads move neighbouring 16-byte words, so loads and stores coalesce.
//
// Also replaces univl_tpu/kernels/reorder.py:beam_reorder_rows, a row gather
// into new buffers over several arrays that share a leading dim N:
//
//   out[a][i] = in[a][src[i]]      for every array a and row i in [0, N).
//
// Duplicate indices are allowed. It is a copy as well, bound by device
// memory: one launch for all arrays, a block per (array, row, column chunk),
// each thread moving 16-byte words straight from the source row to the
// destination row (out of place, so nothing is staged). The kernel does not
// check src on the host, which would synchronize: an index outside [0, N)
// is not followed, and that output row is written with zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxArrays = 16;
constexpr int kThreads = 256;
constexpr int kChunk = 512;  // 16-byte words per row chunk: 8 KB
constexpr int kMaxGroup = 16;

struct Arrays {
  uint4* ptr[kMaxArrays];
  long long row_words[kMaxArrays];  // 16-byte words per row
};

__global__ void __launch_bounds__(kThreads)
reorder_groups_kernel(Arrays arrays, const int* __restrict__ prev_k, int group) {
  extern __shared__ uint4 stage[];  // [group][kChunk]
  const int a = blockIdx.z;
  const int g = blockIdx.y;
  const long long row_words = arrays.row_words[a];
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  if (c0 >= row_words) return;  // this array's rows are shorter than the longest
  const int width = static_cast<int>(min(static_cast<long long>(kChunk), row_words - c0));
  uint4* base = arrays.ptr[a] + static_cast<long long>(g) * group * row_words + c0;
  for (int k = 0; k < group; ++k) {
    const uint4* src = base + static_cast<long long>(prev_k[g * group + k]) * row_words;
    for (int c = threadIdx.x; c < width; c += kThreads) stage[k * kChunk + c] = src[c];
  }
  __syncthreads();  // every source word of the group is staged before any store
  for (int k = 0; k < group; ++k) {
    uint4* dst = base + static_cast<long long>(k) * row_words;
    for (int c = threadIdx.x; c < width; c += kThreads) dst[c] = stage[k * kChunk + c];
  }
}

struct RowArrays {
  const uint4* src[kMaxArrays];
  uint4* dst[kMaxArrays];
  long long row_words[kMaxArrays];  // 16-byte words per row
};

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(RowArrays arrays, const int* __restrict__ src_rows, int n_rows) {
  const int a = blockIdx.z;
  const int i = blockIdx.y;
  const long long row_words = arrays.row_words[a];
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  if (c0 >= row_words) return;  // this array's rows are shorter than the longest
  const int width = static_cast<int>(min(static_cast<long long>(kChunk), row_words - c0));
  uint4* dst = arrays.dst[a] + static_cast<long long>(i) * row_words + c0;
  const int r = src_rows[i];
  if (r < 0 || r >= n_rows) {
    for (int c = threadIdx.x; c < width; c += kThreads) dst[c] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* src = arrays.src[a] + static_cast<long long>(r) * row_words + c0;
  for (int c = threadIdx.x; c < width; c += kThreads) dst[c] = src[c];
}

}  // namespace

extern "C" {

// ptrs: n_arrays device pointers, 16-byte aligned, each [n_rows, row_bytes]
// contiguous with row_bytes a multiple of 16; prev_k: device int32 [n_rows],
// values in [0, group). Launches on `stream`; returns cudaGetLastError().
int univl_reorder_groups(void* const* ptrs, const long long* row_bytes, int n_arrays,
                         const void* prev_k, int n_rows, int group, void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxArrays || group < 1 || group > kMaxGroup ||
      n_rows % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Arrays arrays{};
  long long longest = 0;
  for (int i = 0; i < n_arrays; ++i) {
    arrays.ptr[i] = static_cast<uint4*>(ptrs[i]);
    arrays.row_words[i] = row_bytes[i] / 16;
    if (arrays.row_words[i] > longest) longest = arrays.row_words[i];
  }
  const dim3 grid(static_cast<unsigned>((longest + kChunk - 1) / kChunk),
                  static_cast<unsigned>(n_rows / group), static_cast<unsigned>(n_arrays));
  const size_t smem = static_cast<size_t>(group) * kChunk * sizeof(uint4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reorder_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reorder_groups_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      arrays, static_cast<const int*>(prev_k), group);
  return static_cast<int>(cudaGetLastError());
}

// src_ptrs, dst_ptrs: n_arrays device pointers each, 16-byte aligned, every
// array [n_rows, row_bytes] contiguous with row_bytes a multiple of 16 (dst
// not overlapping src); src_rows: device int32 [n_rows]. Launches on
// `stream`; returns cudaGetLastError().
int univl_gather_rows(const void* const* src_ptrs, void* const* dst_ptrs,
                      const long long* row_bytes, int n_arrays, const void* src_rows,
                      int n_rows, void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxArrays || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowArrays arrays{};
  long long longest = 0;
  for (int i = 0; i < n_arrays; ++i) {
    arrays.src[i] = static_cast<const uint4*>(src_ptrs[i]);
    arrays.dst[i] = static_cast<uint4*>(dst_ptrs[i]);
    arrays.row_words[i] = row_bytes[i] / 16;
    if (arrays.row_words[i] > longest) longest = arrays.row_words[i];
  }
  if (longest == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((longest + kChunk - 1) / kChunk),
                  static_cast<unsigned>(n_rows), static_cast<unsigned>(n_arrays));
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      arrays, static_cast<const int*>(src_rows), n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
