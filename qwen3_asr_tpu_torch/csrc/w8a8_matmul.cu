// K10: W8A8 matmul with the activation quantize fused into the tile loads.
//
// Replaces qwen3_asr_tpu/ops/pallas/w8a8_matmul.py:w8a8_matmul (:65, kernel
// _w8a8_kernel :40).  x (M, K) bf16 row-major; sx (M,) f32 per-row scales
// (abs-max / 127, computed by the wrapper, outside the kernel as in the TPU
// wrapper); wq (K, N) int8 row-major; ws (N,) f32 per-column scales; out
// (M, N) bf16 or f32:
//     xq  = clip(round_half_even(x / sx), -127, 127)      (IEEE f32 divide)
//     out = float(xq @ wq) * sx * ws                      (int32 accumulate)
// bit for bit the function of qwen3_asr_tpu/ops/quant.py:qlinear's W8A8
// branch (:229-236): the integer product is exact and the epilogue applies
// the two scales in the same order.
//
// Bound on the H100: int8 tensor-core operations at prefill shapes (M in the
// thousands, K and N 1024..12288), and in this kernel the instructions
// around them.  Design, simple first (no TMA, wgmma or warp specialisation):
//   * one block of 8 warps (2 x 4) per 64 x 256 output tile, each warp a
//     32 x 64 sub-tile of 2 x 8 mma.sync m16n8k32 (s8 x s8 -> s32) tiles;
//   * a 3-stage cp.async ring of the bf16 x tile (64 x 64) and the int8
//     weight tile (64 x 256) in shared memory;
//   * per stage the block quantizes the bf16 x tile once into an int8 tile.
//     The quotient x / sx is taken as x * (1 / sx) and rounded; only where
//     that product lies within 1e-4 of a half-integer (where it could round
//     otherwise than the IEEE quotient, whose error it is within 2.3e-5 of)
//     is the IEEE division itself taken, so the result is exactly
//     round_half_even(x / sx).  The 256-column tile re-quantizes each x row
//     N / 256 times (the TPU finding of ops/quant.py:177-185: the fused
//     form re-reads the bf16 activations once per column tile);
//   * the int8 B operand needs 4 consecutive k of one column per register,
//     but the weights are (K, N) row-major.  Each warp loads 32-bit words
//     (4 adjacent columns of one k row) from 4 rows and transposes the 4 x 4
//     bytes in registers (__byte_perm), giving the B registers of 4 n8
//     tiles at once.  Tile columns are assigned so that those 4 tiles own
//     adjacent columns (column 32h + 4c + r is lane column c of n8 tile
//     4h + r), which also leaves each thread 8 adjacent output columns;
//   * the weight tile's 16-byte chunks are XOR-swizzled by row, so those
//     word loads hit 32 distinct banks;
//   * epilogue float(acc) * sx[row] * ws[col], stored 8 columns at a time as
//     bf16 or f32.
// Compiled without --use_fast_math.  K must be a multiple of 64 and N of 16
// (the wrapper checks); M and the column edge are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 256;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kXs = kBK + 8;       // bf16 per shared x row (144 B)
constexpr int kQs = kBK + 16;      // bytes per quantized x row (80 B)
constexpr int kXStage = kBM * kXs;               // bf16 elements
constexpr int kWStage = kBK * kBN;               // bytes, rows of 256 B
constexpr int kSmem = kStages * (kXStage * 2 + kWStage) + kBM * kQs +
                      2 * kBM * (int)sizeof(float);

// Word w (of 64) of weight-tile row r lives at word w ^ swizzle(r): rows
// 4t..4t+3 of a k32 step spread their loads over four 8-word bank groups.
__device__ __forceinline__ int swizzle(int r) { return ((r >> 2) & 3) << 3; }

__device__ __forceinline__ int quantize_rn(float x, float s, float rcp) {
  const float y = __fmul_rn(x, rcp);
  float r = rintf(y);
  if (!(fabsf(y - r) <= 0.4999f)) r = rintf(__fdiv_rn(x, s));
  return max(-127, min(127, static_cast<int>(r)));
}

// b[r] byte j = w[j] byte r.
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&b)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(lo01, lo23, 0x5410);
  b[1] = __byte_perm(lo01, lo23, 0x7632);
  b[2] = __byte_perm(hi01, hi23, 0x5410);
  b[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <bool kF32Out>
__global__ void __launch_bounds__(kThreads, 2)
    w8a8_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ sx, const int8_t* __restrict__ w,
                const float* __restrict__ ws, void* __restrict__ out, int M,
                int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + kStages * kXStage * 2);
  int8_t* xq = wsm + kStages * kWStage;
  float* sx_s = reinterpret_cast<float*>(xq + kBM * kQs);
  float* rcp_s = sx_s + kBM;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / 4;           // warp row (32 rows)
  const int wn = warp % 4;           // warp column (64 columns)
  const int k_tiles = K / kBK;

  for (int r = tid; r < kBM; r += kThreads) {
    const float s = m0 + r < M ? sx[m0 + r] : 1.f;
    sx_s[r] = s;
    rcp_s[r] = __frcp_rn(s);
  }

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* xd = xs + stage * kXStage;
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = x + (int64_t)(ok ? m0 + r : 0) * K + k0 + col;
      gemm::cp_async16(xd + r * kXs + col, src, ok);
    }
    int8_t* wd = wsm + stage * kWStage;
    for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16);
      const int chunk = c % (kBN / 16);
      const bool ok = n0 + chunk * 16 < N;
      const int8_t* src = w + (int64_t)(k0 + r) * N + (ok ? n0 + chunk * 16 : 0);
      gemm::cp_async16(wd + r * kBN + ((chunk * 4) ^ swizzle(r)) * 4, src, ok);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

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

    // Quantize this stage's x tile: 8 elements (16 bytes) per step.
    const __nv_bfloat16* xt = xs + (kt % kStages) * kXStage;
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(xt + r * kXs + col);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float s = sx_s[r];
      const float rcp = rcp_s[r];
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int q = quantize_rn(__bfloat162float(v[e]), s, rcp);
        packed[e / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e % 4));
      }
      *reinterpret_cast<uint2*>(xq + r * kQs + col) = make_uint2(packed[0], packed[1]);
    }
    __syncthreads();

    const int8_t* wt = wsm + (kt % kStages) * kWStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = xq + (wm * 32 + mi * 16 + g) * kQs + kk + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kQs);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kQs + 16);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int word = wn * 16 + h * 8 + g;     // columns wn*64 + 32h + 4g ..+3
        uint32_t w0[4], w1[4], b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r0 = kk + 4 * t + j;
          const int r1 = r0 + 16;
          w0[j] = reinterpret_cast<const uint32_t*>(wt + r0 * kBN)[word ^ swizzle(r0)];
          w1[j] = reinterpret_cast<const uint32_t*>(wt + r1 * kBN)[word ^ swizzle(r1)];
        }
        transpose4x4(w0, b0);
        transpose4x4(w1, b1);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            gemm::mma_s8_16832(acc[mi][4 * h + r], a[mi], b0[r], b1[r]);
      }
    }
  }
  gemm::cp_async_wait<0>();

  // Thread (g, t) holds, per (row, h), columns 32h + 8t + 4e + r from
  // acc[.][4h + r][2 * half + e]: 8 adjacent columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + wn * 64 + 32 * h + 8 * t;
    if (col >= N) continue;
    const float4 wa = *reinterpret_cast<const float4*>(ws + col);
    const float4 wb = *reinterpret_cast<const float4*>(ws + col + 4);
    const float wsc[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mi * 16 + g + 8 * half;
        if (m0 + r >= M) continue;
        const float srow = sx_s[r];
        float v[8];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[4 * e + q] = __fmul_rn(
                __fmul_rn(static_cast<float>(acc[mi][4 * h + q][2 * half + e]), srow),
                wsc[4 * e + q]);
        const int64_t off = (int64_t)(m0 + r) * N + col;
        if (kF32Out) {
          float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          uint4 packed;
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) = packed;
        }
      }
    }
  }
}

template <bool kF32Out>
int launch(const void* x, const void* sx, const void* w, const void* ws,
           void* out, int M, int N, int K, cudaStream_t stream) {
  static bool smem_ok = false;
  auto kernel = w8a8_kernel<kF32Out>;
  cudaError_t err = gemm::allow_smem(kernel, kSmem, smem_ok);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws), out, M, N,
      K);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, sx (M,) f32, wq (K, N) int8, ws (N,) f32, out (M, N) bf16
// (out_f32 == 0) or f32; all contiguous on the device.  K % 64 == 0 and
// N % 16 == 0.  Returns the launch's cudaError_t.
extern "C" int w8a8_matmul_bf16(const void* x, const void* sx, const void* wq,
                                const void* ws, void* out, int M, int N, int K,
                                int out_f32, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (K <= 0 || K % kBK || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? launch<true>(x, sx, wq, ws, out, M, N, K, st)
                 : launch<false>(x, sx, wq, ws, out, M, N, K, st);
}
