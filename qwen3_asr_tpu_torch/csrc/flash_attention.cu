// K1: causal GQA flash attention for the decoder's fresh prefill.
//
// Replaces qwen3_asr_tpu/ops/pallas/flash_attention.py:flash_attention_causal
// (:95, kernel _fa_kernel :37).  q (B, Hq, T, 128), k/v (B, Hkv, T, 128)
// bf16 -> out (B, Hq, T, 128) bf16; query i attends keys j <= i; query head
// h reads KV head h / (Hq / Hkv).
//
// Bound on the H100: bytes at the main path's prompts (B=8, T=448: 44 MB of
// q, k, v and out against 6.6 GFLOP, 13 us against 7 us), operations from
// T ~ 1000 on.  Design, for Hopper:
//   * a work item is one KV head's 64-key/value tiles shared by two 64-row
//     query units: the two query heads of a GQA pair on the same 64 rows
//     (Hq / Hkv >= 2; a lone last head of an odd group leaves its unit
//     idle), or two neighbouring 64-row tiles of one head (Hq == Hkv), so
//     every K/V tile is read once for both units;
//   * a block of three warpgroups: a producer whose one thread keeps TMA
//     loads in flight, and two consumers, one per query unit.  Q arrives by
//     TMA per unit into one of two buffers (each refilled as soon as its
//     unit's last Q K^T on it is done); K and V tiles by TMA into a 4-stage ring of 32 KB stages,
//     synchronised by mbarriers (full: the TMA bytes; empty: the 256
//     consumer threads).  All tiles use the 128-byte swizzle, loaded as
//     64-column boxes of a 3-D map (B*H, T, 128), so rows past T inside a
//     head load as zeros;
//   * S = Q K^T by wgmma m64n64k16 (both operands K-major in shared
//     memory); the online softmax in f32; P rounded to bf16 in registers
//     is the A operand of O += P V, wgmma m64n128k16 with V as the
//     MN-major B operand (the transpose bit), so P never touches shared
//     memory;
//   * each consumer issues tile t's Q K^T together with tile t-1's P V
//     and runs tile t's softmax while that P V is on the tensor cores;
//   * persistent blocks, one per SM, walk the items in chunks of KV heads
//     whose K/V fit in L2 (24 MB), heaviest causal rows first inside a
//     chunk, in a snake order (round r forwards when r is even, backwards
//     when odd) that evens out the triangle's work.  The ring runs on
//     across items and Q is double-buffered, so the next item's loads
//     overlap this one's tail.
// The mask value is finite (-0.7 * FLT_MAX, as the TPU kernel) and the
// row sum l == 0 -> 1 guard stays; only a unit's diagonal tile is masked
// (key > query); rows past T are computed on zeros and not stored.  The
// arithmetic is that of the earlier mma.sync kernel, operation for
// operation (s * scale, expf, the same summation orders), and its output
// is bit-identical to that kernel's: an exp2f softmax with scale * log2(e)
// folded in was 5-7% faster but moved bits, and with them the greedy
// streams downstream.  Turn-taking between the two consumers (named
// barriers, so that one's softmax runs under the other's products) was
// 11-16% slower at T=448 and is not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBM = 64;               // query rows per consumer warpgroup
constexpr int kBN = 64;               // keys per K/V tile
constexpr int kStages = 4;
constexpr int kUnits = 2;             // consumer warpgroups
constexpr int kThreads = (kUnits + 1) * 128;
constexpr int kBox = 64 * 64 * 2;     // one 64-row x 64-column box: 8 KB
constexpr int kTile = 2 * kBox;       // 64 rows x 128 head dims: 16 KB
constexpr int kOffQ = 0;
constexpr int kOffK = kOffQ + kUnits * 2 * kTile;   // Q double-buffered
constexpr int kOffV = kOffK + kStages * kTile;
constexpr int kOffBar = kOffV + kStages * kTile;
constexpr int kBars = 2 * kStages + 4 * kUnits;
constexpr int kSmem = kOffBar + 8 * kBars + 1024;   // + alignment slack
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int64_t kL2Budget = 24 << 20;   // K/V bytes a chunk of items keeps in L2

struct Geometry {
  int Hq, Hkv, T;
  int group;      // Hq / Hkv
  int pairs;      // head pairs per KV head (1 when group == 1)
  int n_groups;   // B * Hkv * pairs
  int n_qb;       // query blocks per head: 64 rows (group >= 2) or 128
  int chunk;      // groups whose query blocks run together (K/V in L2)
  int n_items;
};

// One item: its batch element, KV head and the two units' query heads,
// first rows and tile counts (0 for an idle unit).
struct Work {
  int b, hkv, n_tiles;
  int h[kUnits], q0[kUnits], tiles[kUnits];
};

__device__ __forceinline__ Work decode_item(const Geometry& g, int item) {
  Work w;
  // Items run chunk by chunk of g.chunk groups, so that the K/V rows every
  // query block of a group re-reads stay in L2; inside a chunk the
  // heaviest query blocks come first.
  const int per_chunk = g.chunk * g.n_qb;
  const int ci = item / per_chunk;
  const int r = item - ci * per_chunk;
  const int gc = min(g.chunk, g.n_groups - ci * g.chunk);
  const int qb = g.n_qb - 1 - r / gc;
  const int rest = ci * g.chunk + r % gc;
  const int pair = rest % g.pairs;
  w.hkv = (rest / g.pairs) % g.Hkv;
  w.b = rest / (g.pairs * g.Hkv);
  w.n_tiles = 0;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    bool valid;
    if (g.group >= 2) {
      const int hi = 2 * pair + u;
      valid = hi < g.group;
      w.h[u] = w.hkv * g.group + min(hi, g.group - 1);
      w.q0[u] = qb * kBM;
    } else {
      w.h[u] = w.hkv;
      w.q0[u] = qb * 2 * kBM + u * kBM;
      valid = w.q0[u] < g.T;
    }
    w.tiles[u] = valid ? w.q0[u] / kBN + 1 : 0;
    w.n_tiles = max(w.n_tiles, w.tiles[u]);
  }
  return w;
}

// The item of round r for this block (snake order), or -1.
__device__ __forceinline__ int item_of(const Geometry& g, int r) {
  const int base = r * gridDim.x;
  const int i = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return base + i < g.n_items ? base + i : -1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one 64-key tile: eight k16 steps over the head dim, Q and K
// both K-major (each a pair of 64-column boxes).  Issued, not committed.
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBox + (ks % 4) * 32;
    hopper::wgmma_m64n64k16_ss<0>(s, hopper::desc_sw128(sq + off, 16, 1024),
                                  hopper::desc_sw128(sk + off, 16, 1024), ks > 0);
  }
}

// O += P V: P as the register A operand, V the MN-major B operand (its two
// 64-column boxes LBO apart).  Issued, not committed.
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    hopper::WgmmaRsBf16<128>::mma<1>(o, pa[kk],
                                     hopper::desc_sw128(sv + kk * 16 * 128, kBox, 1024), 1);
  }
}

// Keeps P's registers live until the PV wgmma that reads them has completed.
__device__ __forceinline__ void fence_p(uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i])::"memory");
}

// The online softmax of one tile: scales s, masks keys past
// the diagonal (diag: the unit's last tile), folds the tile into the running
// max m and sums l (this thread's share), leaves p = exp(s - m) in s and
// returns the factors a by which the output must be rescaled.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1,
                                             bool diag, int j0, int r0, int tq,
                                             float scale) {
  float tmax0 = kMaskValue, tmax1 = kMaskValue;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e < 2 ? 0 : 8);
      const int col = j0 + j * 8 + tq * 2 + (e & 1);
      float x = s[4 * j + e] * scale;
      if (diag && col > row) x = kMaskValue;
      s[4 * j + e] = x;
      if (e < 2) {
        tmax0 = fmaxf(tmax0, x);
      } else {
        tmax1 = fmaxf(tmax1, x);
      }
    }
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {   // the 4 threads sharing a row
    tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, o2));
    tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, o2));
  }
  const float mn0 = fmaxf(m0, tmax0);
  const float mn1 = fmaxf(m1, tmax1);
  a0 = expf(m0 - mn0);
  a1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[4 * j + 0] = expf(s[4 * j + 0] - mn0);
    s[4 * j + 1] = expf(s[4 * j + 1] - mn0);
    s[4 * j + 2] = expf(s[4 * j + 2] - mn1);
    s[4 * j + 3] = expf(s[4 * j + 3] - mn1);
    ps0 += s[4 * j + 0] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// P's accumulator layout is mma.sync's A fragment: k16 step kk takes the
// column pairs j = 2kk (registers 8kk..8kk+3) and 2kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBN / 16][4], const float (&s)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ void scale_o(float (&o)[kD / 2], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j + 0] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     __nv_bfloat16* __restrict__ out, const Geometry g,
                     float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;      // [unit][buffer]
  uint64_t* q_empty = q_full + kUnits * 2;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kUnits * 128);
    }
    for (int i = 0; i < kUnits * 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kUnits) {
    // Producer warpgroup: one thread issues every load.  Q of a block's
    // c-th item goes to buffer c % 2, so it lands while item c - 1 runs.
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      hopper::prefetch_tensormap(&map_q);
      hopper::prefetch_tensormap(&map_k);
      hopper::prefetch_tensormap(&map_v);
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0;; ++c) {
        const int item = item_of(g, c);
        if (item < 0) break;
        const Work w = decode_item(g, item);
        const int buf = c & 1;
        const uint32_t q_phase = (c >> 1) & 1;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          uint64_t* qf = &q_full[u * 2 + buf];
          hopper::mbar_wait(&q_empty[u * 2 + buf], q_phase ^ 1);
          hopper::mbar_arrive_expect_tx(qf, kTile);
          uint8_t* dst = smem + kOffQ + (u * 2 + buf) * kTile;
          const int head = w.b * g.Hq + w.h[u];
          hopper::tma_load_3d(dst, &map_q, qf, 0, w.q0[u], head);
          hopper::tma_load_3d(dst + kBox, &map_q, qf, 64, w.q0[u], head);
        }
        const int head = w.b * g.Hkv + w.hkv;
        for (int t = 0; t < w.n_tiles; ++t) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[stage], 2 * kTile);
          uint8_t* dk = smem + kOffK + stage * kTile;
          uint8_t* dv = smem + kOffV + stage * kTile;
          hopper::tma_load_3d(dk, &map_k, &full[stage], 0, t * kBN, head);
          hopper::tma_load_3d(dk + kBox, &map_k, &full[stage], 64, t * kBN, head);
          hopper::tma_load_3d(dv, &map_v, &full[stage], 0, t * kBN, head);
          hopper::tma_load_3d(dv + kBox, &map_v, &full[stage], 64, t * kBN, head);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query unit wg of every item.  Tile t's Q K^T
    // is issued together with tile t-1's P V; the softmax of tile t runs
    // while that P V is still on the tensor cores.
    hopper::setmaxnreg_inc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gq = lane >> 2;        // accumulator row group
    const int tq = lane & 3;         // thread in group
    const uint32_t sk0 = hopper::smem_u32(smem + kOffK);
    const uint32_t sv0 = hopper::smem_u32(smem + kOffV);
    int stage = 0;
    uint32_t phase = 0;
    for (int c = 0;; ++c) {
      const int item = item_of(g, c);
      if (item < 0) break;
      const Work w = decode_item(g, item);
      const int my_tiles = wg == 0 ? w.tiles[0] : w.tiles[1];
      const int q0 = wg == 0 ? w.q0[0] : w.q0[1];
      const int h = wg == 0 ? w.h[0] : w.h[1];
      const int r0 = q0 + warp * 16 + gq;     // this thread's rows r0, r0 + 8
      const int qi = wg * 2 + (c & 1);
      const uint32_t sq = hopper::smem_u32(smem + kOffQ + qi * kTile);
      hopper::mbar_wait(&q_full[qi], (c >> 1) & 1);

      float o[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max
      float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
      float a0, a1;
      float s[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
      uint32_t pa[kBN / 16][4];
      int prev = 0;                          // stage of the tile P belongs to

      for (int t = 0; t < my_tiles; ++t) {
        hopper::mbar_wait(&full[stage], phase);
        hopper::fence_regs(s);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
        issue_qk(s, sq, sk0 + stage * kTile);
        hopper::wgmma_commit();
        if (t > 0) {
          issue_pv(o, pa, sv0 + prev * kTile);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();           // S of tile t is in
        } else {
          hopper::wgmma_wait<0>();
        }
        hopper::fence_regs(s);
        if (t == my_tiles - 1) hopper::mbar_arrive(&q_empty[qi]);
        softmax_tile(s, m0, m1, l0, l1, a0, a1, t == my_tiles - 1, t * kBN, r0, tq,
                     scale);
        if (t > 0) {
          hopper::wgmma_wait<0>();           // P V of tile t - 1 is in
          hopper::fence_regs(o);
          fence_p(pa);
          hopper::mbar_arrive(&empty[prev]);
        }
        scale_o(o, a0, a1);
        pack_p(pa, s);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (my_tiles > 0) {
        hopper::fence_regs(o);
        hopper::wgmma_fence();
        issue_pv(o, pa, sv0 + prev * kTile);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        fence_p(pa);
        hopper::mbar_arrive(&empty[prev]);
      } else {
        hopper::mbar_arrive(&q_empty[qi]);
      }
      // Tiles the other unit needs and this one does not (an idle unit, or
      // the lower query tile when Hq == Hkv).
      for (int t = my_tiles; t < w.n_tiles; ++t) {
        hopper::mbar_wait(&full[stage], phase);
        hopper::mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (my_tiles == 0) continue;

#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
      }
      const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
      const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
      const int r1 = r0 + 8;
      __nv_bfloat16* base = out + ((int64_t)w.b * g.Hq + h) * g.T * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int col = j * 8 + tq * 2;
        if (r0 < g.T) {
          *reinterpret_cast<uint32_t*>(base + (int64_t)r0 * kD + col) =
              pack_bf16(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
        }
        if (r1 < g.T) {
          *reinterpret_cast<uint32_t*>(base + (int64_t)r1 * kD + col) =
              pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
    }
  }
}

// A (n_heads, T, 128) bf16 map, 64-row x 64-column boxes.
cudaError_t head_map(CUtensorMap* map, const void* base, int n_heads, int T) {
  const cuuint64_t dims[3] = {kD, (cuuint64_t)T, (cuuint64_t)n_heads};
  const cuuint64_t strides[2] = {kD * 2, (cuuint64_t)T * kD * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return hopper::make_map_bf16(map, base, 3, dims, strides, box);
}

}  // namespace

// q (B, Hq, T, 128), k/v (B, Hkv, T, 128), out (B, Hq, T, 128): bf16,
// contiguous, 16-byte aligned, on the device; Hq % Hkv == 0.  Returns the
// cudaError_t (of the tensor maps' encoding or of the launch).
extern "C" int flash_attention_causal_bf16(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int Hq, int Hkv, int T, float scale,
                                           void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = head_map(&map_q, q, B * Hq, T);
  if (err == cudaSuccess) err = head_map(&map_k, k, B * Hkv, T);
  if (err == cudaSuccess) err = head_map(&map_v, v, B * Hkv, T);
  if (err != cudaSuccess) return (int)err;
  static gemm::SmemAllowed smem;
  err = gemm::allow_smem(flash_fwd_kernel, kSmem, smem);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  g.Hq = Hq;
  g.Hkv = Hkv;
  g.T = T;
  g.group = Hq / Hkv;
  g.pairs = g.group >= 2 ? (g.group + 1) / 2 : 1;
  g.n_groups = B * Hkv * g.pairs;
  g.n_qb = g.group >= 2 ? (T + kBM - 1) / kBM : (T + 2 * kBM - 1) / (2 * kBM);
  const int64_t kv_bytes = (int64_t)T * kD * 2 * 2;    // one KV head's K and V
  const int64_t fit = kL2Budget / kv_bytes;
  g.chunk = (int)(fit < 1 ? 1 : (fit > g.n_groups ? g.n_groups : fit));
  g.n_items = g.n_groups * g.n_qb;
  int sms = 0;
  err = hopper::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = g.n_items < sms ? g.n_items : sms;
  flash_fwd_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), g,
      scale);
  return (int)cudaGetLastError();
}
