// K10: W8A8 matmul: one per-row quantize pass, then an int8 wgmma GEMM.
//
// Replaces qwen3_asr_tpu/ops/pallas/w8a8_matmul.py:w8a8_matmul (:65, kernel
// _w8a8_kernel :40).  x (M, K) bf16 row-major; wq the (K, N) int8 weight
// stored K-major, i.e. the transpose of a row-major (N, K) int8 matrix qt;
// ws (N,) f32 per-column scales; out (M, N) bf16 or f32:
//     sx  = max|x[row]| / 127 (1 for a zero row)           (IEEE f32 divide)
//     xq  = clip(round_half_even(x / sx), -127, 127)      (IEEE f32 divide)
//     out = float(xq @ wq) * sx * ws                      (int32 accumulate)
// bit for bit the function of qwen3_asr_tpu/ops/quant.py:qlinear's W8A8
// branch (:229-236): the integer product is exact and the epilogue applies
// the two scales in the same order.
//
// Bound on the H100: int8 tensor-core operations at prefill shapes (M in the
// thousands, K and N 1024..12288).  Design:
//   * quantize_rows_kernel reads each bf16 row of x once (into shared
//     memory), takes its abs-max, and writes xq (M, K) int8 and sx (M,) f32.
//     The quotient x / sx is taken as x * (1 / sx) and rounded; only where
//     that product lies within 1e-4 of a half-integer (where it could round
//     otherwise than the IEEE quotient, whose error it is within 2.3e-5 of)
//     is the IEEE division itself taken, so the result is exactly
//     round_half_even(x / sx).  The TPU kernel's fault (ops/quant.py:177-185),
//     a quantize fused into the product that re-reads x once per column
//     tile, is gone: x is read once and xq (half its bytes) is what the
//     GEMM streams;
//   * the GEMM: persistent blocks, one per SM, each of three warpgroups.
//     One thread of the producer warpgroup keeps TMA loads of 128 x 128 xq
//     tiles and 256 x 128 weight tiles (both K-major, the 128-byte swizzle)
//     in flight into a 4-stage ring of 48 KB stages, synchronised by
//     mbarriers (full: the TMA bytes; empty: the 256 consumer threads);
//   * two consumer warpgroups (setmaxnreg: 232 registers each, 40 for the
//     producer) each run wgmma.mma_async m64n256k32 s8 x s8 -> s32 on 64 of
//     the tile's 128 rows, four k32 steps per stage, and release a stage as
//     soon as the wgmma group that read it has completed;
//   * 128 x 256 output tiles, walked in groups of row tiles whose xq fits in
//     L2 (16 MB): inside a group consecutive tiles share a weight panel, so
//     the 28 row tiles of the smoke's 3584 rows read each weight panel from
//     HBM once; the ring runs on across tiles, so one tile's epilogue
//     overlaps the next one's loads;
//   * epilogue __fmul_rn(__fmul_rn(float(acc), sx[row]), ws[col]), stored
//     as bf16 or f32 pairs.
// Integer wgmma takes both operands K-major in shared memory, hence the
// K-major weight layout (ops/quant.py:quantize_weight stores it so; no copy
// per call).  Rows past M, columns past N and the K tail (K % 128 == 64)
// load as zeros through TMA and add nothing.  Compiled without
// --use_fast_math.  K must be a multiple of 64 and N of 16 (the wrapper
// checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;              // output rows per tile (2 x 64)
constexpr int kBN = 256;              // output columns per tile
constexpr int kBK = 128;              // k per stage (bytes = elements)
constexpr int kStages = 4;
constexpr int kThreads = 3 * 128;     // producer + two consumer warpgroups
constexpr int kTileA = kBM * kBK;     // 16 KB
constexpr int kTileB = kBN * kBK;     // 32 KB
constexpr int kStage = kTileA + kTileB;
constexpr int kOffBar = kStages * kStage;
constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;   // + alignment slack
constexpr int64_t kL2Budget = 16 << 20;  // xq bytes a group of row tiles keeps in L2
constexpr int kQThreads = 128;        // quantize_rows_kernel block

__device__ __forceinline__ int quantize_rn(float x, float s, float rcp) {
  const float y = __fmul_rn(x, rcp);
  float r = rintf(y);
  if (!(fabsf(y - r) <= 0.4999f)) r = rintf(__fdiv_rn(x, s));
  return max(-127, min(127, static_cast<int>(r)));
}

// One block per row: the row lands in shared memory, its abs-max is
// reduced, then it is quantized from there.
__global__ void __launch_bounds__(kQThreads)
    quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int K) {
  extern __shared__ uint4 row[];
  __shared__ float warp_max[kQThreads / 32];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + (int64_t)r * K);
  const int chunks = K / 8;
  float amax = 0.f;
  for (int c = tid; c < chunks; c += kQThreads) {
    const uint4 v = src[c];
    row[c] = v;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tid % 32 == 0) warp_max[tid / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fdiv_rn(amax > 0.f ? amax : 127.f, 127.f);
  const float rcp = __frcp_rn(s);
  if (tid == 0) sx[r] = s;
  uint2* dst = reinterpret_cast<uint2*>(xq + (int64_t)r * K);
  for (int c = tid; c < chunks; c += kQThreads) {
    const uint4 v = row[c];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = quantize_rn(__bfloat162float(e[i]), s, rcp);
      packed[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
    }
    dst[c] = make_uint2(packed[0], packed[1]);
  }
}

// The quantize pass of a row-parallel shard, which holds a K-slice of each
// row: the row's scale sx[r] comes from the caller (the abs-max of the whole
// row, taken across the shards, over 127), and the slice is quantized with
// it as quantize_rows_kernel quantizes a row.  No shared memory: each thread
// reads its 16-byte chunks once.
__global__ void __launch_bounds__(kQThreads)
    quantize_rows_scaled_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ sx, int8_t* __restrict__ xq,
                                int K) {
  const int r = blockIdx.x;
  const float s = sx[r];
  const float rcp = __frcp_rn(s);
  const uint4* src = reinterpret_cast<const uint4*>(x + (int64_t)r * K);
  uint2* dst = reinterpret_cast<uint2*>(xq + (int64_t)r * K);
  for (int c = threadIdx.x; c < K / 8; c += kQThreads) {
    const uint4 v = src[c];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = quantize_rn(__bfloat162float(e[i]), s, rcp);
      packed[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
    }
    dst[c] = make_uint2(packed[0], packed[1]);
  }
}

struct Geometry {
  int M, N, K;
  int m_tiles, n_tiles, k_blocks;
  int group;       // row tiles per L2 group
  int n_items;     // m_tiles * n_tiles
};

// Tile `item` -> (row tile, column tile): groups of `group` row tiles, and
// inside a group the row tiles of one weight panel one after another.
__device__ __forceinline__ void tile_of(const Geometry& g, int item, int& mt, int& nt) {
  const int per_group = g.group * g.n_tiles;
  const int grp = item / per_group;
  const int first = grp * g.group;
  const int rows = min(g.group, g.m_tiles - first);
  const int local = item - grp * per_group;
  mt = first + local % rows;
  nt = local / rows;
}

template <bool kF32Out>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ sx, const float* __restrict__ ws,
                     void* __restrict__ out, const Geometry g) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      hopper::prefetch_tensormap(&map_x);
      hopper::prefetch_tensormap(&map_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < g.n_items; item += gridDim.x) {
        int mt, nt;
        tile_of(g, item, mt, nt);
        for (int kb = 0; kb < g.k_blocks; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[stage], kStage);
          uint8_t* dst = smem + stage * kStage;
          hopper::tma_load_2d(dst, &map_x, &full[stage], kb * kBK, mt * kBM);
          hopper::tma_load_2d(dst + kTileA, &map_w, &full[stage], kb * kBK, nt * kBN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gq = lane >> 2;
    const int tq = lane & 3;
    const uint32_t base = hopper::smem_u32(smem);
    int stage = 0;
    uint32_t phase = 0;
    int acc[128];
    for (int item = blockIdx.x; item < g.n_items; item += gridDim.x) {
      int mt, nt;
      tile_of(g, item, mt, nt);
      int prev = 0;
      for (int kb = 0; kb < g.k_blocks; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const uint32_t a = base + stage * kStage + wg * 64 * kBK;
        const uint32_t b = base + stage * kStage + kTileA;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int s = 0; s < kBK / 32; ++s) {
          hopper::wgmma_m64n256k32_s8(acc, hopper::desc_sw128(a + s * 32, 16, 1024),
                                      hopper::desc_sw128(b + s * 32, 16, 1024),
                                      kb > 0 || s > 0);
        }
        hopper::wgmma_commit();
        if (kb > 0) {
          hopper::wgmma_wait<1>();
          hopper::mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[prev]);

      // Register 4j + 2h + e: row 16 warp + g + 8h of this warpgroup's 64,
      // column 8j + 2t + e.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * kBM + wg * 64 + warp * 16 + gq + 8 * h;
        if (row >= g.M) continue;
        const float srow = sx[row];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = nt * kBN + 8 * j + 2 * tq;
          if (col >= g.N) continue;
          const float2 wc = *reinterpret_cast<const float2*>(ws + col);
          const float v0 = __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * h]), srow), wc.x);
          const float v1 =
              __fmul_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * h + 1]), srow), wc.y);
          const int64_t off = (int64_t)row * g.N + col;
          if (kF32Out) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

int quantize_rows(const void* x, void* xq, void* sx, int M, int K, cudaStream_t stream) {
  static gemm::SmemAllowed smem;
  const int bytes = K * 2;
  if (bytes > (48 << 10)) {
    const cudaError_t err = gemm::allow_smem(quantize_rows_kernel, bytes, smem);
    if (err != cudaSuccess) return (int)err;
  }
  quantize_rows_kernel<<<M, kQThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), K);
  return (int)cudaGetLastError();
}

int quantize_rows_scaled(const void* x, const void* sx, void* xq, int M, int K,
                         cudaStream_t stream) {
  quantize_rows_scaled_kernel<<<M, kQThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(sx),
      static_cast<int8_t*>(xq), K);
  return (int)cudaGetLastError();
}

template <bool kF32Out>
int run_gemm(const void* xq, const void* sx, const void* wq, const void* ws, void* out, int M,
             int N, int K, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  cudaError_t err = hopper::make_map_s8(&map_x, xq, M, K, K, kBM, kBK,
                                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_map_s8(&map_w, wq, N, K, K, kBN, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return (int)err;
  static gemm::SmemAllowed smem;
  err = gemm::allow_smem(w8a8_gemm_kernel<kF32Out>, kSmem, smem);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  g.M = M;
  g.N = N;
  g.K = K;
  g.m_tiles = (M + kBM - 1) / kBM;
  g.n_tiles = (N + kBN - 1) / kBN;
  g.k_blocks = (K + kBK - 1) / kBK;
  const int64_t fit = kL2Budget / ((int64_t)kBM * K);
  g.group = (int)(fit < 1 ? 1 : (fit > g.m_tiles ? g.m_tiles : fit));
  g.n_items = g.m_tiles * g.n_tiles;
  int sms = 0;
  err = hopper::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = g.n_items < sms ? g.n_items : sms;
  w8a8_gemm_kernel<kF32Out><<<grid, kThreads, kSmem, stream>>>(
      map_x, map_w, static_cast<const float*>(sx), static_cast<const float*>(ws), out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 -> xq (M, K) int8 and sx (M,) f32; contiguous on the
// device, K % 64 == 0.  Returns the launch's cudaError_t.
extern "C" int quantize_rows_bf16(const void* x, void* xq, void* sx, int M, int K,
                                  void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (K <= 0 || K % 64) return (int)cudaErrorInvalidValue;
  return quantize_rows(x, xq, sx, M, K, (cudaStream_t)stream);
}

// x (M, K) bf16; xq (M, K) int8 and sx (M,) f32 scratch that this call
// fills; wq the K-major (K, N) int8 weight (a row-major (N, K) matrix, 16-
// byte aligned); ws (N,) f32; out (M, N) bf16 (out_f32 == 0) or f32.
// K % 64 == 0 and N % 16 == 0.  Returns the first failing cudaError_t.
extern "C" int w8a8_matmul_bf16(const void* x, void* xq, void* sx, const void* wq,
                                const void* ws, void* out, int M, int N, int K,
                                int out_f32, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (K <= 0 || K % 64 || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = quantize_rows(x, xq, sx, M, K, st);
  if (err != 0) return err;
  return out_f32 ? run_gemm<true>(xq, sx, wq, ws, out, M, N, K, st)
                 : run_gemm<false>(xq, sx, wq, ws, out, M, N, K, st);
}

// x (M, K) bf16 and sx (M,) f32 row scales given by the caller -> xq (M, K)
// int8; contiguous on the device, K % 64 == 0.
extern "C" int quantize_rows_scaled_bf16(const void* x, const void* sx, void* xq, int M,
                                         int K, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (K <= 0 || K % 64) return (int)cudaErrorInvalidValue;
  return quantize_rows_scaled(x, sx, xq, M, K, (cudaStream_t)stream);
}

// As w8a8_matmul_bf16, with the row scales sx (M,) f32 given by the caller
// (a row-parallel shard's: the whole row's abs-max over 127) instead of taken
// from x: xq (M, K) int8 scratch that this call fills.
extern "C" int w8a8_matmul_scaled_bf16(const void* x, const void* sx, void* xq, const void* wq,
                                       const void* ws, void* out, int M, int N, int K,
                                       int out_f32, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (K <= 0 || K % 64 || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = quantize_rows_scaled(x, sx, xq, M, K, st);
  if (err != 0) return err;
  return out_f32 ? run_gemm<true>(xq, sx, wq, ws, out, M, N, K, st)
                 : run_gemm<false>(xq, sx, wq, ws, out, M, N, K, st);
}
