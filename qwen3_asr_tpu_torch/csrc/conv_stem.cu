// K11e: fused 3x3 stride-2 pad-1 convolution + bias + exact GELU, NHWC.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/conv_stem.py:conv_s2_gelu
// (:82; kernel _kernel :47, pallas_call :133).  x (N, H, W, C) bf16, w
// (3, 3, C, O) bf16 (HWIO), b (O,) f32; out (N, H', W', O) bf16 with
// H' = (H - 1) / 2 + 1, W' = (W - 1) / 2 + 1.
//
// Bound on the H100: operations.  At the encoder's 1.7B widths (C = O =
// 480) conv2 of the smoke's 256 chunks is 849 GFLOP against ~1 GB of input
// and output, far above the card's ~295 FLOP/byte ridge.  Design, for
// Hopper: an implicit GEMM, M = N * H' * W' output pixels, N = O, K = 9 * C
// ordered (dy, dx, c), so that w read as a row-major (K, O) matrix is the B
// operand as it lies in memory:
//   * one block per (128-pixel, 240-channel) output tile: O = 480 splits
//     into two column tiles with no waste, so each A row is gathered twice;
//     wgmma m64n240k16 (bf16 in, f32 accumulate), one consumer warpgroup
//     per 64 pixel rows;
//   * a 4-stage ring of 64-deep K slices (16 KB of A, 32 KB of B a stage),
//     synchronised by mbarriers (full: the TMA bytes and the 128 producer
//     threads' copies; empty: the 256 consumer threads), never by
//     __syncthreads.  Each consumer keeps one wgmma group in flight and
//     frees the slice before it;
//   * B arrives by TMA: four 64-row x 64-column boxes of a (K, O) map with
//     the 128-byte swizzle (the MN-major operand, the transpose bit),
//     columns past O and rows past K as zeros;
//   * A (the im2col rows) is gathered by the producer warpgroup with 16-byte
//     cp.async copies straight from the NHWC input at the tap's stride-2
//     offset (2h' + dy - 1, 2w' + dx - 1), zero-filled outside the image or
//     past K, into the 128-byte-swizzled K-major layout the descriptor
//     reads.  Each 16-byte chunk computes its own tap, so a 64-deep slice
//     may straddle taps (C = 480 is no multiple of 64).  The TPU kernel's
//     padded, phase-separated copy of the input is not made;
//   * epilogue from registers: acc + b rounded to bf16 (the TPU kernel's
//     output), then the exact GELU 0.5 v (1 + erf(v / sqrt 2)) in f32 (the
//     TPU applies it outside its kernel: Mosaic has no erf), rounded to
//     bf16; rows past M and columns past O are not stored.
// The products run over K in the earlier mma.sync kernel's order of k16
// steps, and the output is bit-identical to that kernel's.
// C and O must be multiples of 8 (one 16-byte copy never straddles a tap,
// the map's row stride is a multiple of 16 bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;             // output pixels per block, 64 per consumer
constexpr int kBN = 240;             // output channels per block
constexpr int kBK = 64;              // K depth per stage (one 128-byte row)
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;    // two consumer warpgroups, one producer
constexpr int kBoxB = kBK * 64 * 2;  // one 64 x 64 box of w: 8 KB
constexpr int kBoxesB = 4;           // 256 columns landed, 240 used
constexpr int kStageA = kBM * kBK * 2;          // 16 KB
constexpr int kStageB = kBoxesB * kBoxB;        // 32 KB
constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kStages * kStageA;
constexpr int kOffBar = kOffB + kStages * kStageB;
constexpr int kSmem = kOffBar + 8 * 2 * kStages + 1024;   // + alignment slack
constexpr int kRowsPerThread = kBM / 16;       // producer: 16 rows a pass

__device__ __forceinline__ float gelu_of_rounded(float v) {
  const float y = __bfloat162float(__float2bfloat16(v));
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

__global__ void __launch_bounds__(kThreads, 1)
    conv_s2_gelu_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ b,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C,
                        int O, int Ho, int Wo, int M, int n_tiles_n, int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;

  const int m0 = (blockIdx.x / n_tiles_n) * kBM;
  const int n0 = (blockIdx.x % n_tiles_n) * kBN;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 128 + 1);   // 128 copy arrivals + the TMA's
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer warpgroup: thread tid copies the 16-byte chunk c = tid % 8 of
    // the slice (K offset 8c) for tile rows tid / 8 + 16 i.
    hopper::setmaxnreg_dec<56>();
    const int c = tid % 8;
    const int row0 = tid / 8;
    int pix[kRowsPerThread];     // n * H * W of the row's image
    int corner[kRowsPerThread];  // (2h' - 1) << 16 | (2w' - 1) & 0xffff
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = m0 + row0 + 16 * i;
      if (m < M) {
        const int n = m / (Ho * Wo);
        const int r = m - n * (Ho * Wo);
        const int ho = r / Wo;
        const int wo = r - ho * Wo;
        pix[i] = n * H * W;
        corner[i] = ((2 * ho - 1) << 16) | ((2 * wo - 1) & 0xffff);
      } else {
        pix[i] = 0;
        corner[i] = (-(1 << 14)) << 16;    // every tap lands above the image
      }
    }
    const int K = 9 * C;
    const int n_boxes = min(kBoxesB, (O - n0 + 63) / 64);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      if (tid == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], n_boxes * kBoxB);
        uint8_t* db = smem + kOffB + stage * kStageB;
        for (int box = 0; box < n_boxes; ++box) {
          hopper::tma_load_2d(db + box * kBoxB, &map_w, &full[stage], n0 + 64 * box,
                              kt * kBK);
        }
      }
      const int k = kt * kBK + 8 * c;
      const bool k_ok = k < K;
      const int tap = k_ok ? k / C : 0;
      const int ch = k - tap * C;
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
      uint8_t* da = smem + kOffA + stage * kStageA;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = row0 + 16 * i;
        const int ih = (corner[i] >> 16) + dy;
        const int iw = (int)(int16_t)(corner[i] & 0xffff) + dx;
        const bool ok = k_ok && ih >= 0 && ih < H && iw >= 0 && iw < W;
        const __nv_bfloat16* src =
            x + (ok ? (int64_t)(pix[i] + ih * W + iw) * C + ch : 0);
        gemm::cp_async16(da + row * 128 + ((c ^ (row & 7)) << 4), src, ok);
      }
      hopper::mbar_arrive_cp_async(&full[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // Consumer warpgroup wg: tile rows 64 wg .. 64 wg + 63.
    hopper::setmaxnreg_inc<224>();
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    const uint32_t sa0 = hopper::smem_u32(smem + kOffA) + wg * 64 * 128;
    const uint32_t sb0 = hopper::smem_u32(smem + kOffB);
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      hopper::fence_proxy_async();          // the cp.async rows of A
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        hopper::wgmma_m64n240k16_ss<1>(
            acc, hopper::desc_sw128(sa0 + stage * kStageA + ks * 32, 16, 1024),
            hopper::desc_sw128(sb0 + stage * kStageB + ks * 16 * 128, kBoxB, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();              // the slice before this one is read
      hopper::fence_regs(acc);
      if (kt > 0) hopper::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= O) continue;
      const float b0 = b[col];
      const float b1 = b[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wg * 64 + warp * 16 + g + 8 * half;
        if (row >= M) continue;
        const float v0 = gelu_of_rounded(acc[4 * j + 2 * half] + b0);
        const float v1 = gelu_of_rounded(acc[4 * j + 2 * half + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * O + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x (N, H, W, C), w (3, 3, C, O), out (N, H', W', O) bf16; b (O,) f32; all
// contiguous on the device, 16-byte aligned.  C % 8 == 0, O % 8 == 0,
// N * H * W < 2^31, H, W < 2^14 and N * H' * W' < 2^31.  Returns the
// cudaError_t of the weight map's encoding or of the launch.
extern "C" int conv_s2_gelu_bf16(const void* x, const void* w, const void* b,
                                 void* out, int N, int H, int W, int C, int O,
                                 void* stream) {
  if (N == 0 || H == 0 || W == 0 || O == 0) return (int)cudaSuccess;
  if (C <= 0 || C % 8 || O % 8) return (int)cudaErrorInvalidValue;
  if (H >= (1 << 14) || W >= (1 << 14) || (int64_t)N * H * W >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const int64_t M = (int64_t)N * Ho * Wo;
  const int K = 9 * C;
  const int n_tiles_n = (O + kBN - 1) / kBN;
  const int64_t m_tiles = (M + kBM - 1) / kBM;
  if (m_tiles * n_tiles_n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_w;
  const cuuint64_t dims[2] = {(cuuint64_t)O, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)O * 2};
  const cuuint32_t box[2] = {64, kBK};
  cudaError_t err = hopper::make_map_bf16(&map_w, w, 2, dims, strides, box);
  if (err != cudaSuccess) return (int)err;
  static gemm::SmemAllowed smem;
  err = gemm::allow_smem(conv_s2_gelu_kernel, kSmem, smem);
  if (err != cudaSuccess) return (int)err;
  conv_s2_gelu_kernel<<<(unsigned)(m_tiles * n_tiles_n), kThreads, kSmem,
                        (cudaStream_t)stream>>>(
      map_w, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), H, W, C, O, Ho, Wo, (int)M, n_tiles_n,
      (K + kBK - 1) / kBK);
  return (int)cudaGetLastError();
}
