// K9: weight-only int8 matmul (W8A16): out = (x @ wq) * s.
//
// Replaces qwen3_asr_tpu/ops/quant.py:quantized_matmul (:129, kernel
// _qmm_kernel :110).  x (M, K) bf16 row-major; wq the (K, N) int8 weight
// stored K-major, i.e. the transpose of a row-major (N, K) int8 matrix qt
// (ops/quant.py:quantize_weight stores it so); s (N,) f32 per-output-channel
// scales; out (M, N) bf16 or f32.  The product accumulates in f32 and the
// column scale is applied to the accumulator, as in the TPU kernel.
//
// Bound on the H100: the int8 weight bytes at decode (M = the batch, 1..96:
// at most 2 * 96 FLOPs per weight byte, far below the ~295 FLOP/byte ridge),
// bf16 tensor-core operations at prefill (M = batch x prompt, thousands).
// One design serves both, computing out^T = qt . x^T:
//   * the weight is wgmma's A operand: a block owns 128 weight rows (output
//     columns), 64 per consumer warpgroup.  Weight tiles (128 rows x 64 k,
//     the 64-byte swizzle) arrive by TMA; each thread reads its m16n8k16 A
//     fragment from them as int8 pairs, converts them to bf16 in registers
//     (exact: |q| <= 127) and issues an RS wgmma.  No bf16 copy of the
//     weights exists anywhere;
//   * x is the B operand: a tile of NB rows (K-major, 64 k, the 128-byte
//     swizzle) by TMA beside each weight tile, NB = 8 .. 256 (wgmma
//     m64nNBk16), picked on the host (ops/kernels/quantized_matmul.py:
//     split_k_plan, from tools/torch_k9_sweep.py's device times): M rounded
//     up to a power of two, so up to 256 rows sit in one tile and each
//     weight byte is read from HBM once, except that from NB = 128 the tile
//     is halved where the tiles would fill less than half the card (two
//     64-row tiles at two blocks per SM beat one of 128 at M = 96 with
//     N = 2048).  Many row tiles are walked in groups whose x fits in L2,
//     each group's row tiles of one weight panel one after another;
//   * each thread's A fragments are double-buffered in registers: the next
//     stage's are read and converted while this stage's wgmma run;
//   * one thread of a producer warp (a warpgroup from NB = 128, which
//     gives its registers to the consumers by setmaxnreg) keeps the ring
//     full: 5-8 stages, 8 KB of weights each, 2 blocks per SM up to
//     NB = 64, so 40-128 KB of weights are in flight per SM;
//   * split K (row tiles up to 64): where the (row tile, 128-column tile)
//     pairs leave SMs idle, the k-blocks are split into `splits` contiguous
//     ranges of `per` 64-deep blocks, planned by split_k_plan.  Each range
//     writes its f32 partial tile to a workspace; the last block of a tile
//     to arrive (an int counter per tile, reset by that block) sums the
//     partials in range order 0, 1, ... and applies the scale, so the
//     result does not depend on which block finishes last.  No float atomics.  The sum
//     keeps the loads of several ranges (up to 32 values a thread) in
//     flight together, since a decode tile has up to 16 ranges;
//   * epilogue: acc * s[col], stored as bf16 or f32 (the lm head).
// The accumulator holds out^T, so the stores are 2- or 4-byte scatters
// along a column of out; at decode they are a few KB.  K must be a multiple
// of 128 and N of 16 (the wrapper checks); M and the column edge are
// masked, rows past M and columns past N load as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 128;            // weight rows (output columns) per block
constexpr int kBK = 64;               // k per stage
constexpr int kConsumers = 2 * 128;   // two consumer warpgroups
constexpr int kTileW = kRows * kBK;   // 8 KB of int8 weights per stage
constexpr int64_t kL2Budget = 16 << 20;     // x bytes a group of row tiles keeps in L2

template <int NB>
struct Cfg {
  static constexpr int kTileX = NB * kBK * 2;   // bf16, one 128-byte-swizzled box
  static constexpr int kStage = kTileX + kTileW;
  static constexpr int kStages = NB == 256 ? 5 : (NB == 64 ? 6 : 8);
  static constexpr int kOffBar = kStages * kStage;
  static constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;   // + alignment slack
  static constexpr int kMinBlocks = NB <= 64 ? 2 : 1;
  // From NB = 128 the accumulators need more than the 168 registers a
  // thread of a 288- or 384-thread block gets: the producer is a whole
  // warpgroup that hands its registers to the consumers (setmaxnreg).
  static constexpr bool kWideProducer = NB >= 128;
  static constexpr int kThreads = kConsumers + (kWideProducer ? 128 : 32);
};

struct Geometry {
  int M, N, K;
  int m_tiles, n_tiles;
  int group;       // row tiles per L2 group
  int splits;      // k ranges per tile
  int per;         // 64-deep k-blocks per range
  int k_blocks;
};

// Block -> (row tile, column tile, k range); the ranges of a tile are
// neighbours, the tiles grouped as in w8a8_matmul.cu.
__device__ __forceinline__ void unit_of(const Geometry& g, int& mt, int& nt, int& split) {
  const int item = blockIdx.x / g.splits;
  split = blockIdx.x - item * g.splits;
  const int per_group = g.group * g.n_tiles;
  const int grp = item / per_group;
  const int first = grp * g.group;
  const int rows = min(g.group, g.m_tiles - first);
  const int local = item - grp * per_group;
  mt = first + local % rows;
  nt = local / rows;
}

// Two int8 values (low byte first) -> bf16x2, exact.
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t v) {
  const float lo = static_cast<float>(static_cast<int8_t>(v & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((v >> 8) & 0xffu));
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&b);
}

__device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// This thread's m16n8k16 A fragments of the four k16 steps of one stage's
// weight tile (p: its row r0 at byte 2t; rows r0 and r0 + 8 share the
// 64-byte swizzle phase swz), converted to bf16.
__device__ __forceinline__ void load_a(uint32_t (&a)[kBK / 16][4], const uint8_t* p0, int swz) {
  const uint8_t* p1 = p0 + 8 * kBK;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    const int c = (ks ^ swz) << 4;
    a[ks][0] = s8x2_bf16x2(ld_u16(p0 + c));
    a[ks][1] = s8x2_bf16x2(ld_u16(p1 + c));
    a[ks][2] = s8x2_bf16x2(ld_u16(p0 + c + 8));
    a[ks][3] = s8x2_bf16x2(ld_u16(p1 + c + 8));
  }
}

// Keeps A's registers live until the wgmma that read them has completed.
__device__ __forceinline__ void fence_a(uint32_t (&a)[kBK / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
}

// acc += A (registers) x the stage's x tile at shared address xb (K-major,
// the 128-byte swizzle): four k16 steps, committed as one group.
template <int NB>
__device__ __forceinline__ void issue_kblock(float (&acc)[NB / 2],
                                             const uint32_t (&a)[kBK / 16][4], uint32_t xb) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    hopper::WgmmaRsBf16<NB>::template mma<0>(
        acc, a[ks], hopper::desc_sw128(xb + ks * 32, 16, 1024), 1);
  }
  hopper::wgmma_commit();
}

// Where this thread's accumulators land in out (M, N): register 4j + 2h + e
// is row m0 + 8j + e, column n0 + 8h.
struct Frag {
  int m0, n0, M, N;
  __device__ __forceinline__ bool ok(int j, int h, int e) const {
    return m0 + 8 * j + e < M && n0 + 8 * h < N;
  }
  __device__ __forceinline__ int64_t off(int j, int h, int e) const {
    return (int64_t)(m0 + 8 * j + e) * N + n0 + 8 * h;
  }
};

template <int NB>
__device__ __forceinline__ void store_partial(const float (&acc)[NB / 2], float* p,
                                              const Frag& f) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (f.ok(j, h, e)) p[f.off(j, h, e)] = acc[4 * j + 2 * h + e];
}

// acc = the sum of the `splits` partial tiles in range order 0, 1, ...,
// every one (this block's too) read back from the workspace.  64 / NB
// ranges' loads (32 values a thread) are in flight together, since a
// decode tile has up to 16 ranges.
template <int NB>
__device__ __forceinline__ void sum_partials(float (&acc)[NB / 2], const float* partial,
                                             int64_t slice, int splits, const Frag& f) {
  constexpr int kR = 64 / NB;
  for (int sp0 = 0; sp0 < splits; sp0 += kR) {
    float t[kR][NB / 2];
#pragma unroll
    for (int u = 0; u < kR; ++u)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = sp0 + u < splits && f.ok(j, h, e);
            t[u][4 * j + 2 * h + e] =
                ok ? __ldcg(partial + (sp0 + u) * slice + f.off(j, h, e)) : 0.f;
          }
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      if (sp0 + u >= splits) break;
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = (sp0 + u == 0 ? 0.f : acc[i]) + t[u][i];
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

template <int NB, bool kF32Out>
__global__ void __launch_bounds__(Cfg<NB>::kThreads, Cfg<NB>::kMinBlocks)
    qmm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w, const float* __restrict__ s,
               void* __restrict__ out, float* __restrict__ partial,
               int* __restrict__ counters, const Geometry g) {
  using C = Cfg<NB>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_flag;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  uint64_t* empty = full + C::kStages;

  int mt, nt, split;
  unit_of(g, mt, nt, split);
  const int kb0 = split * g.per;
  const int kb1 = min(kb0 + g.per, g.k_blocks);

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warp(group): one thread issues every load.
    if constexpr (C::kWideProducer) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      hopper::prefetch_tensormap(&map_x);
      hopper::prefetch_tensormap(&map_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], C::kStage);
        uint8_t* dst = smem + stage * C::kStage;
        hopper::tma_load_2d(dst, &map_x, &full[stage], kb * kBK, mt * NB);
        hopper::tma_load_2d(dst + C::kTileX, &map_w, &full[stage], kb * kBK, nt * kRows);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (C::kWideProducer) hopper::setmaxnreg_inc<232>();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // This thread's A rows r0 and r0 + 8 (same 64-byte swizzle phase) in the
  // weight tile: 16-byte chunk c of row r sits at chunk c ^ ((r >> 1) & 3).
  const int r0 = wg * 64 + warp * 16 + gq;
  const int swz = (r0 >> 1) & 3;
  const uint32_t base = hopper::smem_u32(smem);

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // The A fragments are double-buffered: the next stage's are read and
  // converted while this stage's wgmma run on the tensor cores.
  uint32_t a0[kBK / 16][4], a1[kBK / 16][4];
  auto tile_w = [&](int st) { return smem + st * C::kStage + C::kTileX + r0 * kBK + 2 * tq; };
  auto tile_x = [&](int st) { return base + st * C::kStage; };
  int stage = 0;
  uint32_t phase = 0;
  hopper::mbar_wait(&full[0], 0);
  load_a(a0, tile_w(0), swz);
  // One k-block: issue its wgmma on fragments `a`, read the next block's
  // into `b` meanwhile, then retire the stage.
  auto step = [&](uint32_t(&a)[kBK / 16][4], uint32_t(&b)[kBK / 16][4], bool more) {
    issue_kblock<NB>(acc, a, tile_x(stage));
    int next = stage + 1;
    uint32_t next_phase = phase;
    if (next == C::kStages) {
      next = 0;
      next_phase ^= 1;
    }
    if (more) {
      hopper::mbar_wait(&full[next], next_phase);
      load_a(b, tile_w(next), swz);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    fence_a(a);
    hopper::mbar_arrive(&empty[stage]);
    stage = next;
    phase = next_phase;
  };
  for (int kb = kb0; kb < kb1; kb += 2) {
    step(a0, a1, kb + 1 < kb1);
    if (kb + 1 < kb1) step(a1, a0, kb + 2 < kb1);
  }

  // Register 4j + 2h + e: weight row (output column) r0 + 8h, x row
  // 8j + 2t + e of the tile.
  const Frag f{mt * NB + 2 * tq, nt * kRows + r0, g.M, g.N};
  if constexpr (NB <= 64) {
    if (g.splits > 1) {
      const int64_t slice = (int64_t)g.M * g.N;
      store_partial<NB>(acc, partial + split * slice, f);
      __threadfence();
      consumer_sync();
      const int tile = mt * g.n_tiles + nt;
      if (threadIdx.x == 0) last_flag = atomicAdd(&counters[tile], 1) == g.splits - 1;
      consumer_sync();
      if (!last_flag) return;
      __threadfence();
      if (threadIdx.x == 0) counters[tile] = 0;
      sum_partials<NB>(acc, partial, slice, g.splits, f);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (f.n0 + 8 * h >= g.N) continue;
    const float sc = s[f.n0 + 8 * h];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!f.ok(j, h, e)) continue;
        const float v = __fmul_rn(acc[4 * j + 2 * h + e], sc);
        if (kF32Out) {
          static_cast<float*>(out)[f.off(j, h, e)] = v;
        } else {
          static_cast<__nv_bfloat16*>(out)[f.off(j, h, e)] = __float2bfloat16_rn(v);
        }
      }
  }
}

template <int NB, bool kF32Out>
int launch(const void* x, const void* wq, const void* s, void* out, void* partial,
           void* counters, Geometry g, cudaStream_t stream) {
  using C = Cfg<NB>;
  CUtensorMap map_x, map_w;
  const cuuint64_t xdims[2] = {(cuuint64_t)g.K, (cuuint64_t)g.M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)g.K * 2};
  const cuuint32_t xbox[2] = {kBK, NB};
  cudaError_t err = hopper::make_map_bf16(&map_x, x, 2, xdims, xstrides, xbox);
  if (err == cudaSuccess) {
    err = hopper::make_map_s8(&map_w, wq, g.N, g.K, g.K, kRows, kBK,
                              CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != cudaSuccess) return (int)err;
  static gemm::SmemAllowed smem;
  auto kernel = qmm_kernel<NB, kF32Out>;
  err = gemm::allow_smem(kernel, C::kSmem, smem);
  if (err != cudaSuccess) return (int)err;
  g.m_tiles = (g.M + NB - 1) / NB;
  const int64_t fit = kL2Budget / ((int64_t)NB * g.K * 2);
  g.group = (int)(fit < 1 ? 1 : (fit > g.m_tiles ? g.m_tiles : fit));
  const int blocks = g.m_tiles * g.n_tiles * g.splits;
  kernel<<<blocks, C::kThreads, C::kSmem, stream>>>(
      map_x, map_w, static_cast<const float*>(s), out, static_cast<float*>(partial),
      static_cast<int*>(counters), g);
  return (int)cudaGetLastError();
}

template <bool kF32Out>
int dispatch(int nb, const void* x, const void* wq, const void* s, void* out, void* partial,
             void* counters, const Geometry& g, cudaStream_t st) {
  switch (nb) {
    case 8: return launch<8, kF32Out>(x, wq, s, out, partial, counters, g, st);
    case 16: return launch<16, kF32Out>(x, wq, s, out, partial, counters, g, st);
    case 32: return launch<32, kF32Out>(x, wq, s, out, partial, counters, g, st);
    case 64: return launch<64, kF32Out>(x, wq, s, out, partial, counters, g, st);
    case 128: return launch<128, kF32Out>(x, wq, s, out, partial, counters, g, st);
    case 256: return launch<256, kF32Out>(x, wq, s, out, partial, counters, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) bf16; wq the K-major (K, N) int8 weight (a row-major (N, K)
// matrix); s (N,) f32; out (M, N) bf16 (out_f32 == 0) or f32; all on the
// device, 16-byte aligned.  nb (8 .. 256, a power of two) is the row tile,
// `splits` k ranges of `per` 64-deep blocks cover K / 64 (splits > 1 only
// for nb <= 64); with splits > 1, partial is (splits, M, N) f32 scratch and
// counters holds one zeroed int per (row tile, 128-column tile), left
// zeroed.  K % 128 == 0, N % 16 == 0.
// Returns the launch's cudaError_t.
extern "C" int quantized_matmul_bf16(const void* x, const void* wq, const void* s, void* out,
                                     void* partial, void* counters, int M, int N, int K,
                                     int out_f32, int nb, int splits, int per, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (K <= 0 || K % 128 || N % 16 || splits < 1 || per < 1) return (int)cudaErrorInvalidValue;
  Geometry g;
  g.M = M;
  g.N = N;
  g.K = K;
  g.k_blocks = K / kBK;
  g.n_tiles = (N + kRows - 1) / kRows;
  g.splits = splits;
  g.per = per;
  g.m_tiles = 0;
  g.group = 1;
  if ((int64_t)splits * per < g.k_blocks || (int64_t)(splits - 1) * per >= g.k_blocks) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits > 1 && (nb > 64 || partial == nullptr || counters == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? dispatch<true>(nb, x, wq, s, out, partial, counters, g, st)
                 : dispatch<false>(nb, x, wq, s, out, partial, counters, g, st);
}
