// K11e: fused 3x3 stride-2 pad-1 convolution + bias + exact GELU, NHWC.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/conv_stem.py:conv_s2_gelu
// (:82; kernel _kernel :47, pallas_call :133).  x (N, H, W, C) bf16, w
// (3, 3, C, O) bf16 (HWIO), b (O,) f32; out (N, H', W', O) bf16 with
// H' = (H - 1) / 2 + 1, W' = (W - 1) / 2 + 1.
//
// Bound on the H100: operations.  At the encoder's 1.7B widths (C = O =
// 480) conv2 does 2 * 32 * 25 * 480 * 4320 = 3.3 GFLOP per 100-frame chunk
// against ~2.6 MB of input and output, far above the card's ~295 FLOP/byte
// ridge.  Design: an implicit GEMM on the tensor cores, M = N * H' * W'
// output pixels, N = O, K = 9 * C ordered (dy, dx, c), so that w read as a
// row-major (K, O) matrix is the B operand as it lies in memory:
//   * one block of 8 warps per (128-pixel, 128-channel) output tile, each
//     warp a 32 x 64 sub-tile (2 x 8 mma.sync m16n8k16, bf16 in, f32
//     accumulate);
//   * a 4-stage cp.async ring of 32-deep K slices.  Each A row of a slice
//     is read straight from the NHWC input at the tap's stride-2 offset
//     (2h' + dy - 1, 2w' + dx - 1), zero-filled outside the image: the TPU
//     kernel's padded, phase-separated copy of the input (needed there for
//     static VMEM windows) is not made, and no slicing of N is needed;
//   * fragments through ldmatrix (.trans for B), rows padded by 16 bytes so
//     that the eight row addresses of a matrix hit distinct banks;
//   * epilogue: acc + b rounded to bf16 (the TPU kernel's output), then the
//     exact GELU 0.5 v (1 + erf(v / sqrt 2)) in f32 (the TPU applies it
//     outside its kernel: Mosaic has no erf), rounded to bf16.
// C and O must be multiples of 8 (one 16-byte copy never straddles a tap
// or the column edge); K is zero-padded to the slice depth, M and the
// column edge are masked.  No wgmma or TMA yet: simple first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;           // output pixels per block
constexpr int kBN = 128;           // output channels per block
constexpr int kBK = 32;            // K depth per pipeline stage
constexpr int kStages = 4;
constexpr int kAs = kBK + 8;       // bf16 per shared A row (80 B)
constexpr int kBs = kBN + 8;       // bf16 per shared B row (272 B)
constexpr int kAStage = kBM * kAs;
constexpr int kBStage = kBK * kBs;
constexpr int kSmem = kStages * (kAStage + kBStage) * 2;   // 75,776 bytes

__device__ __forceinline__ float gelu_of_rounded(float v) {
  const float y = __bfloat162float(__float2bfloat16(v));
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

__global__ void __launch_bounds__(kThreads)
    conv_s2_gelu_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ b,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C,
                        int O, int Ho, int Wo, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + kStages * kAStage;

  const int K = 9 * C;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp % 4) * 32;    // warp's first row in the tile
  const int wn = (warp / 4) * 64;    // warp's first column in the tile

  // A loads: thread copies 8 channels (one 16-byte chunk, column kc * 8 of
  // the slice) of tile rows ra and ra + 64; their pixels are fixed, so the
  // image offset and window corner are computed once.
  const int ra = tid / 4;
  const int kc = tid % 4;
  int64_t img[2];
  int ih0[2], iw0[2];
  bool row_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + ra + 64 * j;
    row_ok[j] = m < M;
    const int mm = row_ok[j] ? m : 0;
    const int n = mm / (Ho * Wo);
    const int r = mm - n * (Ho * Wo);
    const int ho = r / Wo;
    const int wo = r - ho * Wo;
    img[j] = (int64_t)n * H * W * C;
    ih0[j] = 2 * ho - 1;
    iw0[j] = 2 * wo - 1;
  }
  // B loads: thread copies columns cb * 8 .. +7 of slice rows rb and rb + 16.
  const int rb = tid / 16;
  const int cb = tid % 16;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int k = k0 + kc * 8;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / C : 0;
    const int c = k - tap * C;
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
    __nv_bfloat16* ad = as + stage * kAStage;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ih = ih0[j] + dy;
      const int iw = iw0[j] + dx;
      const bool ok = row_ok[j] && k_ok && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const __nv_bfloat16* src =
          x + (ok ? img[j] + ((int64_t)ih * W + iw) * C + c : 0);
      gemm::cp_async16(ad + (ra + 64 * j) * kAs + kc * 8, src, ok);
    }
    __nv_bfloat16* bd = bs + stage * kBStage;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = rb + 16 * j;
      const int col = n0 + cb * 8;
      const bool ok = k0 + r < K && col < O;
      const __nv_bfloat16* src = w + (ok ? (int64_t)(k0 + r) * O + col : 0);
      gemm::cp_async16(bd + r * kBs + cb * 8, src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int k_tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_tiles) load(st, st);
    gemm::cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    gemm::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next % kStages, next);
    gemm::cp_async_commit();

    const __nv_bfloat16* at = as + (kt % kStages) * kAStage;
    const __nv_bfloat16* bt = bs + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        gemm::ldmatrix_x4(
            a[mi], at + (wm + mi * 16 + (lane % 16)) * kAs + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bf[4];
        gemm::ldmatrix_x4_trans(
            bf, bt + (kk + (lane % 8) + ((lane / 8) % 2) * 8) * kBs + wn +
                    nj * 16 + (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          gemm::mma_bf16_16816(acc[mi][2 * nj], a[mi], bf[0], bf[1]);
          gemm::mma_bf16_16816(acc[mi][2 * nj + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
  }
  gemm::cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= O) continue;
    const float b0 = b[col];
    const float b1 = b[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + 8 * half;
        if (row >= M) continue;
        const float v0 = gelu_of_rounded(acc[mi][ni][2 * half] + b0);
        const float v1 = gelu_of_rounded(acc[mi][ni][2 * half + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * O + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x (N, H, W, C), w (3, 3, C, O), out (N, H', W', O) bf16; b (O,) f32; all
// contiguous on the device, 16-byte aligned.  C % 8 == 0, O % 8 == 0 and
// N * H' * W' < 2^31.  Returns the launch's cudaError_t.
extern "C" int conv_s2_gelu_bf16(const void* x, const void* w, const void* b,
                                 void* out, int N, int H, int W, int C, int O,
                                 void* stream) {
  if (N == 0 || H == 0 || W == 0 || O == 0) return (int)cudaSuccess;
  if (C <= 0 || C % 8 || O % 8) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;
  cudaError_t err = gemm::allow_smem(conv_s2_gelu_kernel, kSmem, smem_ok);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (O + kBN - 1) / kBN);
  conv_s2_gelu_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), H, W, C, O,
      Ho, Wo, (int)M);
  return (int)cudaGetLastError();
}
