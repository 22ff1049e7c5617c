// Small building blocks: for the im2col gather of conv_stem.cu (K11e),
// 16-byte cp.async copies into shared memory with zero fill (completed on an
// mbarrier); for every kernel with more than 48 KB of dynamic shared memory,
// the opt-in, kept per device.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace gemm {

// Copy 16 bytes global -> shared; with valid == false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

// Device ordinals a launch function keeps state for.
constexpr int kMaxDevices = 64;

// The current device's ordinal, checked against kMaxDevices.
inline cudaError_t current_device(int& device) {
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return device >= 0 && device < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// The largest dynamic shared-memory size one kernel has been allowed, per
// device ordinal.  A launch function keeps one as a static: the attribute
// belongs to the kernel in the current device's context, so a process that
// drives two cards must set it on each.
struct SmemAllowed {
  std::atomic<int> bytes[kMaxDevices];
  std::mutex mu;
};

// Allow `kernel` `bytes` of dynamic shared memory on the current device,
// once per device and size: a size at most the largest already allowed
// there sets nothing.  Setting and recording happen under one lock, so the
// attribute is never left below what the record says.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, SmemAllowed& allowed) {
  int device = 0;
  cudaError_t err = current_device(device);
  if (err != cudaSuccess) return err;
  std::atomic<int>& have = allowed.bytes[device];
  if (have.load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  std::lock_guard<std::mutex> lock(allowed.mu);
  if (have.load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have.store(bytes, std::memory_order_release);
  return err;
}

}  // namespace gemm
