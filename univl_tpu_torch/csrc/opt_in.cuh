// Host helper shared by the port's kernels (attention.cu, layernorm.cu,
// train_attention.cu, vocab_topk.cu): the opt-in a kernel needs to take more
// than 48 KB of dynamic shared memory a block.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace univl {

constexpr int kMaxDevices = 64;

// Sets `kernel`'s largest dynamic shared memory to the device's opt-in
// limit less the kernel's static shared memory (the two together may not
// pass the limit), once per device (`done`: the kernel's flags, one a
// device), so a launch makes no other CUDA call. Two threads may both set it
// on first use; the call is idempotent.
template <typename Kernel>
cudaError_t opt_in_shared_memory(Kernel kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace univl
