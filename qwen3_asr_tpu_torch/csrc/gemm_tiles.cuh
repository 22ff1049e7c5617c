// Building blocks shared by the cp.async kernels: the im2col gather of
// conv_stem.cu (K11e) and the ring of decode_stream.cuh (K11d):
// 16-byte cp.async copies into shared memory with zero fill, the group
// commit/wait pair, and the dynamic shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Allow a kernel more than 48 KB of dynamic shared memory (once per kernel;
// the attribute persists for the process).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace gemm
