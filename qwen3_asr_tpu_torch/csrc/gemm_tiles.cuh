// Small building blocks: for the im2col gather of conv_stem.cu (K11e),
// 16-byte cp.async copies into shared memory with zero fill (completed on an
// mbarrier); for K11e and the decode stream (decode_pair_stream.cuh,
// K11a-K11d), the dynamic shared-memory opt-in.
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
