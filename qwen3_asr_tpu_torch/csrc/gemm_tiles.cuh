// Building blocks shared by the tensor-core kernels (quantized_matmul.cu,
// K9; w8a8_matmul.cu, K10), the im2col gather of conv_stem.cu (K11e) and
// the cp.async rings of decode_stream.cuh (K11a-K11d): 16-byte cp.async
// copies into shared memory with zero fill, the group commit/wait pair, the
// two mma.sync shapes, and the dynamic shared-memory opt-in.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16/k32"): in a
// warp, lane = 4 * g + t (g = lane >> 2, t = lane & 3).  The accumulator
// holds rows g and g + 8, columns 2t and 2t + 1, of a 16x8 tile.
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

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col); int8 operands, int32 accumulator.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
