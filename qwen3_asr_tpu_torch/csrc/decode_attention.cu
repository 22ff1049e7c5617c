// K2: one-token decode attention over the layer-stacked KV cache.
//
// Replaces qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:
// decode_attention_hbm4 (:405; kernel _kernel :39, wiring _hbm4_call :272).
// q (B, Hq, 128); kall/vall (L, B, Hkv, S, 128); k_new/v_new (B, Hkv, 1, 128),
// all bf16; prompt_len and decode_end (B,) int32.  Cache row s of lane b is
// valid when s < prompt_len[b] or prompt_bucket <= s < decode_end[b]; the
// step's own k_new/v_new row is always attended (the self-term): it is not
// in the cache yet.  With write_slots (B,) int32, the kernel also stores
// that row at slot write_slots[b] of the layer (K3's work,
// qwen3_asr_tpu/ops/pallas/kv_write.py:kv_write_rows :260 and
// kv_write_rows_batch :85, fused; a slot outside [0, S) is dropped), after
// every read of the lane's rows: the JAX decode loop's order (attention over
// the pre-step cache, then the write), one launch instead of three.
//
// Bound on the H100: bytes.  Each step reads every valid K and V row once
// (2 * 256 B per row and KV head) and does 2 * group FMAs per element read,
// far below the card's ~295 FLOP/byte ridge, so the CUDA cores suffice and
// the design's job is to keep bytes in flight and launch once.  As in the TPU
// kernel, only the valid rows [0, plen) and [pb, dend) are read, never the
// padded middle of the cache, and each row once for the whole GQA group:
//   * one launch, one block per (split, kv head, lane).  The lane's valid
//     rows are numbered 0..n_valid and cut into `splits` contiguous chunks
//     so that small batches still fill the card.  A chunk is at most two
//     contiguous runs of cache rows (prompt rows, then decode rows).
//   * a producer warp: one thread walks the chunk in tiles of kTileRows
//     rows and issues 1-D bulk copies (cp.async.bulk, no tensor map) of each
//     tile's K and V rows, one per run the tile touches, into a kStages-deep
//     mbarrier ring; at B <= 8 a block's rows all fit in the ring, so all its
//     bytes are in flight at once.
//   * four consumer warps, as eight 16-thread workers: worker w takes the
//     chunk's rows w, w + 8, ... from the ring, dots each with the group's
//     query heads (f32, shuffles across the half-warp) and keeps an online
//     softmax (max, sum, 128-wide accumulator) in registers; the workers
//     merge through shared memory into one partial (m, l, acc) per query
//     head, written to an f32 workspace that the wrapper allocates.
//   * each worker computes the scores of its rows of a tile together,
//     branch-free (their shuffle trees and exponentials overlap), releases
//     the stage, then runs the online-softmax updates in row order; the
//     self-term score q . k_new is reduced while the ring fills.
//   * the last block of each (lane, kv head) to finish, counted by an int
//     ticket (one acq_rel atomic) that it resets to zero, folds the partials
//     in split order and the self-term into the output, 32 partials to a
//     round of loads (with one split the block folds its own partial from
//     registers, without the workspace), then stores the fresh row into the
//     cache when given a write slot (decode_split.cuh's fresh rows' store:
//     the slot resolved and, for int8, the row's abs-max reduced while the
//     ring fills; 256 B of K and V a (lane, KV head) against the launch and
//     the staging copies the standalone K3 cost).
// The ring, a tile's consumer work, the merge, the ticket, the fold and the
// fresh rows' store are decode_split.cuh's, shared with K6/K7
// (decode_attention_paged.cu); this file holds K2's tiles (at most two runs
// of cache rows) and its self-term.
// The arithmetic (row assignment, fmaf order, shuffle tree, softmax update,
// worker merge, split fold) is that of the earlier two-kernel version, so
// the output is bit-identical to it.  Masking is by construction (only valid
// rows are visited) and the running max starts at a finite -0.7 * FLT_MAX,
// so an idle lane (prompt_len 0, decode_end == prompt_bucket) yields the
// self-term alone: finite, no NaN.
//
// K4, the int8-cache variant, is the same kernel instantiated with Q8:
// replaces decode_attention_hbm4.py:decode_attention_hbm4_q8 (:434).  The
// cache is int8 rows (128 B) with one f32 scale per row, kscale/vscale
// (L, B, Hkv, S).  Each tile also copies its runs of scales: a run of f32
// scales starting at row r is 16-byte aligned only when r % 4 == 0, so the
// copy takes the aligned superset of the run, which stays inside the lane
// because the wrapper requires S % 4 == 0.  The scales fold into the small
// quantities, as in ops/quant_kv.py:20-23: the row's score is (q . k8) * ks
// and its probability p weighs v8 as (p * vs) . v8, while the softmax sum
// takes p itself.  Half the K/V bytes of the bf16 cache, plus 8 bytes of
// scales per row; k_new/v_new stay bf16 (the fused store quantizes the
// fresh row as kv_write.cu's kv_write_rows_q8 does, bit for bit).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"
#include "gemm_tiles.cuh"

namespace {

using namespace decode_split;

// A tile copies at most two runs: prompt rows, then decode rows.
constexpr int kRuns = 2;
constexpr int kBlockThreads = kThreads + 32;  // one consumer group, one producer warp

// The runs of tile [ta, tb) of a lane's valid rows: n0 prompt rows from
// cache row ta, then n1 decode rows from cache row c1.
struct Tile {
  int ta, n0, n1, c1;
  __device__ Tile(int start, int end, int t, int plen, int pb) {
    ta = start + t * kTileRows;
    const int tb = min(end, ta + kTileRows);
    n0 = max(0, min(tb, plen) - ta);
    n1 = tb - ta - n0;
    c1 = pb + (ta + n0) - plen;
  }
};

// Producer: the bulk copies of tile t into `stage`, completing on `bar`.
template <bool Q8>
__device__ __forceinline__ void issue_tile(uint8_t* stage, uint64_t* bar, const Tile& tl,
                                           const uint8_t* kbase, const uint8_t* vbase,
                                           const float* ks_lane, const float* vs_lane) {
  using Rg = Ring<1, Q8, kRuns>;
  const int runs[kRuns][2] = {{tl.ta, tl.n0}, {tl.c1, tl.n1}};
  uint32_t bytes = (uint32_t)(tl.n0 + tl.n1) * Rg::kRowBytes * 2;
  if (Q8) {
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int c = runs[r][0], n = runs[r][1];
      if (n) bytes += (uint32_t)(((c + n + 3) & ~3) - (c & ~3)) * 4 * 2;
    }
  }
  hopper::mbar_arrive_expect_tx(bar, bytes);
  int row = 0;
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int c = runs[r][0], n = runs[r][1];
    if (!n) continue;
    const uint32_t nb = (uint32_t)n * Rg::kRowBytes;
    hopper::bulk_load(stage + row * Rg::kRowBytes, kbase + (int64_t)c * Rg::kRowBytes, nb,
                      bar);
    hopper::bulk_load(stage + Rg::kRows + row * Rg::kRowBytes,
                      vbase + (int64_t)c * Rg::kRowBytes, nb, bar);
    if (Q8) {
      float* sc = reinterpret_cast<float*>(stage + 2 * Rg::kRows);
      const int c0 = c & ~3;
      const uint32_t sb = (uint32_t)(((c + n + 3) & ~3) - c0) * 4;
      hopper::bulk_load(sc + r * kScaleSlots, ks_lane + c0, sb, bar);
      hopper::bulk_load(sc + Rg::kScales + r * kScaleSlots, vs_lane + c0, sb, bar);
    }
    row += n;
  }
}

// Q8: kall/vall are int8 rows with per-row scales kscale/vscale; otherwise
// bf16 rows and the scale pointers are unused.  The cache is read by bulk
// copies and written only by the fresh row's store (write_slots non-null).
template <int G, bool Q8>
__global__ void __launch_bounds__(kBlockThreads)
    decode_kernel(const __nv_bfloat16* __restrict__ q, void* __restrict__ kall,
                  void* __restrict__ vall, float* __restrict__ kscale,
                  float* __restrict__ vscale, const __nv_bfloat16* __restrict__ k_new,
                  const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ prompt_len,
                  const int* __restrict__ decode_end, const int* __restrict__ write_slots,
                  float* __restrict__ ws, int* __restrict__ counters,
                  __nv_bfloat16* __restrict__ out, int layer, int B, int Hkv, int S, int pb,
                  int splits, float scale) {
  using Rg = Ring<G, Q8, kRuns>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Rg::kBars);
  uint64_t* empty = full + kStages;
  __shared__ float self_sums[G][kThreads / 32];
  __shared__ FreshStore<1> fresh;
  const bool write = write_slots != nullptr;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int sub = threadIdx.x % kRowThreads;
  const bool consumer = threadIdx.x < kThreads;
  const int Hq = Hkv * G;

  const int plen = min(max(prompt_len[b], 0), pb);
  const int dend = min(max(decode_end[b], pb), S);
  const int n_valid = plen + (dend - pb);
  const int chunk = (n_valid + splits - 1) / splits;
  const int start = min(n_valid, split * chunk);
  const int end = min(n_valid, start + chunk);
  const int n_tiles = (end - start + kTileRows - 1) / kTileRows;
  const int64_t lane_row0 = (((int64_t)layer * B + b) * Hkv + hk) * S;

  if (threadIdx.x == 0) ring_init(full, empty, kThreads / 32);
  __syncthreads();

  float m[G], l[G], acc[G][kPerThread];
  float k_self, v_self;  // k_new[d], v_new[d]: the fresh row's elements of this thread
  if (!consumer) {
    if (threadIdx.x == kThreads) {
      const uint8_t* kbase = static_cast<const uint8_t*>(kall) + lane_row0 * Rg::kRowBytes;
      const uint8_t* vbase = static_cast<const uint8_t*>(vall) + lane_row0 * Rg::kRowBytes;
      const float* ks_lane = Q8 ? kscale + lane_row0 : nullptr;
      const float* vs_lane = Q8 ? vscale + lane_row0 : nullptr;
      for (int t = 0; t < n_tiles; ++t) {
        ring_reserve(empty, t);
        issue_tile<Q8>(smem + (t % kStages) * Rg::kStage, &full[t % kStages],
                       Tile(start, end, t, plen, pb), kbase, vbase, ks_lane, vs_lane);
      }
    }
  } else {
    float qv[G][kPerThread];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((int64_t)b * Hq + hk * G + gi) * kD + sub * kPerThread);
      unpack8(raw, qv[gi]);
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) qv[gi][e] *= scale;
    }
    // The self-term score q . k_new per warp, while the ring fills (every
    // block; the last one to finish folds it in).
    {
      const int d = threadIdx.x;
      k_self = __bfloat162float(k_new[((int64_t)b * Hkv + hk) * kD + d]);
      v_self = __bfloat162float(v_new[((int64_t)b * Hkv + hk) * kD + d]);
      const int slot = write && d == 0 ? write_slots[b] : 0;  // consumed below
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float qd =
            __bfloat162float(q[((int64_t)b * Hq + hk * G + gi) * kD + d]) * scale;
        float part = qd * k_self;
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, o);
        }
        if (d % 32 == 0) self_sums[gi][d / 32] = part;
      }
      // The fresh row's store, prepared from values loaded with the
      // self-term's, once it is reduced (visible after the merge's barrier).
      if (write) {
        if (d == 0) fresh.dst[0] = slot >= 0 && slot < S ? lane_row0 + slot : -1;
        if (Q8) {
          warp_absmax(k_self, &fresh.amax[0][0][d / 32]);
          warp_absmax(v_self, &fresh.amax[0][1][d / 32]);
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      m[gi] = kMaskValue;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) acc[gi][e] = 0.f;
    }

    for (int t = 0; t < n_tiles; ++t) {
      const Tile tl(start, end, t, plen, pb);
      ring_wait(full, t);
      // Row j's slot in its run's aligned superset of scales.
      auto slot = [&](int j) {
        return j < plen ? j - (tl.ta & ~3) : kScaleSlots + (pb + j - plen) - (tl.c1 & ~3);
      };
      consume_tile<G, Q8, kRuns, 0>(smem + (t % kStages) * Rg::kStage, tl.ta,
                                    tl.ta + tl.n0 + tl.n1, t, empty, qv, m, l, acc, slot);
    }
  }

  // The block's partial; the last block of the lane and KV head folds the
  // self-term, then the partials in split order.
  float* const base = ws + (((int64_t)b * Hkv + hk) * splits) * G * (kD + 2);
  if (!consumer) return;
  float pm[G], pl[G], pa[G];
  merge_workers<G, 1>(reinterpret_cast<float*>(smem), m, l, acc, pm, pl, pa);  // in the ring
  if (splits > 1) {
    store_partial<G>(base + (int64_t)split * G * (kD + 2), pm, pl, pa);
    if (!take_ticket<kThreads>(counters + (int64_t)b * Hkv + hk, splits, 1)) return;
  }
  float M[G], L[G], A[G], s_self[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    s_self[gi] = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s_self[gi] += self_sums[gi][w];
    M[gi] = s_self[gi];
  }
  fold_splits<G, G>(base, splits, 0, pm, pl, pa, M, L, A,
                    [&](int gi, float Mg, float& Lg, float& Ag) {
                      Lg = expf(s_self[gi] - Mg);
                      Ag = Lg * v_self;
                    });
  const int d = threadIdx.x;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    out[((int64_t)b * Hq + hk * G + gi) * kD + d] = __float2bfloat16(A[gi] / L[gi]);
  }
  if (write) store_fresh_row<Q8, 1>(fresh, 0, k_self, v_self, kall, vall, kscale, vscale);
}

template <int G, bool Q8>
int launch(const void* q, void* kall, void* vall, void* kscale, void* vscale,
           const void* k_new, const void* v_new, const void* prompt_len,
           const void* decode_end, const void* write_slots, void* ws, void* counters,
           void* out, int layer, int B, int Hkv, int S, int pb, int splits, float scale,
           cudaStream_t stream) {
  using Rg = Ring<G, Q8, kRuns>;
  auto kernel = decode_kernel<G, Q8>;
  static gemm::SmemAllowed smem;
  const cudaError_t err = gemm::allow_smem(kernel, Rg::kBytes, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, Hkv, B);
  kernel<<<grid, kBlockThreads, Rg::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kall, vall, static_cast<float*>(kscale),
      static_cast<float*>(vscale), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int*>(prompt_len),
      static_cast<const int*>(decode_end), static_cast<const int*>(write_slots),
      static_cast<float*>(ws), static_cast<int*>(counters), static_cast<__nv_bfloat16*>(out),
      layer, B, Hkv, S, pb, splits, scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch(const void* q, void* kall, void* vall, void* kscale, void* vscale,
             const void* k_new, const void* v_new, const void* prompt_len,
             const void* decode_end, const void* write_slots, void* ws, void* counters,
             void* out, int layer, int B, int Hq, int Hkv, int S, int pb, int splits,
             float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if ((Q8 && S % 4) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1:
      return launch<1, Q8>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len,
                           decode_end, write_slots, ws, counters, out, layer, B, Hkv, S, pb,
                           splits, scale, st);
    case 2:
      return launch<2, Q8>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len,
                           decode_end, write_slots, ws, counters, out, layer, B, Hkv, S, pb,
                           splits, scale, st);
    case 4:
      return launch<4, Q8>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len,
                           decode_end, write_slots, ws, counters, out, layer, B, Hkv, S, pb,
                           splits, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes as in the header comment; write_slots (B,) int32 or null (no
// store); ws is f32 (B, Hkv, splits, Hq/Hkv, 130), counters int32
// (B * Hkv,), zero on entry and left zero.  Hq / Hkv must be 1, 2 or 4;
// every pointer 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int decode_attention_bf16(const void* q, void* kall, void* vall, const void* k_new,
                                     const void* v_new, const void* prompt_len,
                                     const void* decode_end, const void* write_slots, void* ws,
                                     void* counters, void* out, int layer, int B, int Hq,
                                     int Hkv, int S, int pb, int splits, float scale,
                                     void* stream) {
  return dispatch<false>(q, kall, vall, nullptr, nullptr, k_new, v_new, prompt_len,
                         decode_end, write_slots, ws, counters, out, layer, B, Hq, Hkv, S, pb,
                         splits, scale, stream);
}

// K4: kall/vall int8 (L, B, Hkv, S, 128), kscale/vscale f32 (L, B, Hkv, S)
// with S % 4 == 0; everything else as decode_attention_bf16.
extern "C" int decode_attention_q8(const void* q, void* kall, void* vall, void* kscale,
                                   void* vscale, const void* k_new, const void* v_new,
                                   const void* prompt_len, const void* decode_end,
                                   const void* write_slots, void* ws, void* counters,
                                   void* out, int layer, int B, int Hq, int Hkv, int S,
                                   int pb, int splits, float scale, void* stream) {
  return dispatch<true>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len, decode_end,
                        write_slots, ws, counters, out, layer, B, Hq, Hkv, S, pb, splits, scale,
                        stream);
}
