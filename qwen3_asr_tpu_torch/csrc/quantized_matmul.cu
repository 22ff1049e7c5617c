// K9: weight-only int8 matmul (W8A16): out = (x @ wq) * s.
//
// Replaces qwen3_asr_tpu/ops/quant.py:quantized_matmul (:129, kernel
// _qmm_kernel :110).  x (M, K) bf16 row-major; wq (K, N) int8 row-major (the
// JAX package's (in, out) layout); s (N,) f32 per-output-channel scales;
// out (M, N) bf16 or f32.  The product accumulates in f32 and the column
// scale is applied to the accumulator, as in the TPU kernel.
//
// Bound on the H100: the int8 weight bytes.  At decode M is the batch
// (1..96), so each weight byte meets at most 2 * 96 FLOPs, far below the
// card's ~295 FLOP/byte ridge; the design keeps many weight bytes in flight
// and never writes a bf16 copy of the weights:
//   * one block of 4 warps per (64-column, 16/32/64-row) output tile, the
//     row tile picked from M (MT = 1, 2 or 4 m16 tiles), so a decode batch
//     of 8 pads to 16 rows inside the kernel (zero-filled loads, masked
//     stores; no padded copy of x);
//   * a 4-stage cp.async ring of (128 x 64) int8 weight tiles and the
//     matching x tiles in shared memory (3 tiles in flight while one is
//     consumed), rows padded so that fragment reads hit distinct banks;
//   * each warp owns 16 output columns; per 16-deep step it converts its
//     int8 weight column pairs to bf16 (exact: |q| <= 127) and runs
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) for all its row tiles;
//   * epilogue: acc * s[col], stored as bf16 or f32.
// K must be a multiple of 128 and N of 16 (the wrapper checks); M and the
// column edge are masked.  No split-K, TMA or wgmma yet: simple first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;            // output columns per block, 16 per warp
constexpr int kBK = 128;           // K depth per pipeline stage
constexpr int kStages = 4;
constexpr int kXs = kBK + 8;       // bf16 per shared x row (272 B)
constexpr int kWs = kBN + 16;      // bytes per shared weight row (80 B)

template <int MT>
struct Tile {
  static constexpr int kBM = 16 * MT;
  static constexpr int kXStage = kBM * kXs;      // bf16 elements
  static constexpr int kWStage = kBK * kWs;      // bytes
  static constexpr int kSmem = kStages * (kXStage * 2 + kWStage);
};

__device__ __forceinline__ uint32_t int8_pair_bf16(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int MT, bool kF32Out>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w, const float* __restrict__ s,
               void* __restrict__ out, int M, int N, int K) {
  using T = Tile<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + kStages * T::kXStage * 2);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * T::kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_tiles = K / kBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* xd = xs + stage * T::kXStage;
    for (int c = tid; c < T::kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = x + (int64_t)(ok ? m0 + r : 0) * K + k0 + col;
      gemm::cp_async16(xd + r * kXs + col, src, ok);
    }
    int8_t* wd = ws + stage * T::kWStage;
    for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16);
      const int col = (c % (kBN / 16)) * 16;
      const bool ok = n0 + col < N;
      const int8_t* src = w + (int64_t)(k0 + r) * N + (ok ? n0 + col : 0);
      gemm::cp_async16(wd + r * kWs + col, src, ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

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

    const __nv_bfloat16* xt = xs + (kt % kStages) * T::kXStage;
    const int8_t* wt = ws + (kt % kStages) * T::kWStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const __nv_bfloat16* p = xt + (mi * 16 + g) * kXs + kk + 2 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kXs);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kXs + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int8_t* p = wt + (kk + 2 * t) * kWs + warp * 16 + ni * 8 + g;
        const uint32_t b0 = int8_pair_bf16(p[0], p[kWs]);
        const uint32_t b1 = int8_pair_bf16(p[8 * kWs], p[9 * kWs]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) gemm::mma_bf16_16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }
  gemm::cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
    const int col = n0 + warp * 16 + ni * 8 + 2 * t;
    if (col >= N) continue;
    const float s0 = s[col];
    const float s1 = s[col + 1];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + mi * 16 + g + 8 * half;
        if (row >= M) continue;
        const float v0 = __fmul_rn(acc[mi][ni][2 * half], s0);
        const float v1 = __fmul_rn(acc[mi][ni][2 * half + 1], s1);
        const int64_t off = (int64_t)row * N + col;
        if (kF32Out) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int MT, bool kF32Out>
int launch(const void* x, const void* w, const void* s, void* out, int M,
           int N, int K, cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = qmm_kernel<MT, kF32Out>;
  cudaError_t err = gemm::allow_smem(kernel, Tile<MT>::kSmem, smem_ok);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (M + Tile<MT>::kBM - 1) / Tile<MT>::kBM);
  kernel<<<grid, kThreads, Tile<MT>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), out, M, N, K);
  return (int)cudaGetLastError();
}

template <bool kF32Out>
int dispatch(const void* x, const void* w, const void* s, void* out, int M,
             int N, int K, cudaStream_t stream) {
  if (M <= 16) return launch<1, kF32Out>(x, w, s, out, M, N, K, stream);
  if (M <= 32) return launch<2, kF32Out>(x, w, s, out, M, N, K, stream);
  return launch<4, kF32Out>(x, w, s, out, M, N, K, stream);
}

}  // namespace

// x (M, K) bf16, wq (K, N) int8, s (N,) f32, out (M, N) bf16 (out_f32 == 0)
// or f32; all contiguous on the device.  K % 128 == 0 and N % 16 == 0.
// Returns the launch's cudaError_t.
extern "C" int quantized_matmul_bf16(const void* x, const void* wq,
                                     const void* s, void* out, int M, int N,
                                     int K, int out_f32, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (K <= 0 || K % kBK || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? dispatch<true>(x, wq, s, out, M, N, K, st)
                 : dispatch<false>(x, wq, s, out, M, N, K, st);
}
