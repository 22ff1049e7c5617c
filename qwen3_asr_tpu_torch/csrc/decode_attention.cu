// K2: one-token decode attention over the layer-stacked KV cache.
//
// Replaces qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:
// decode_attention_hbm4 (:405; kernel _kernel :39, wiring _hbm4_call :272).
// q (B, Hq, 128); kall/vall (L, B, Hkv, S, 128); k_new/v_new (B, Hkv, 1, 128),
// all bf16; prompt_len and decode_end (B,) int32.  Cache row s of lane b is
// valid when s < prompt_len[b] or prompt_bucket <= s < decode_end[b]; the
// step's own k_new/v_new row is always attended (the self-term), because the
// decode loop writes the step's rows into the cache only after all layers.
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
//     registers, without the workspace).
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
// scales per row; k_new/v_new stay bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = 128;                     // consumer threads
constexpr int kBlockThreads = kThreads + 32;      // and one producer warp
constexpr int kRowThreads = 16;                   // threads per cache row
constexpr int kWorkers = kThreads / kRowThreads;  // 16-thread workers
constexpr int kPerThread = kD / kRowThreads;      // 8 elements
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kTileRows = 32;                     // rows per ring stage
constexpr int kStages = 4;
// f32 slots of one run of scales: the 16-byte aligned superset of at most
// kTileRows rows starts up to 3 rows early and ends up to 3 rows late.
constexpr int kScaleSlots = kTileRows + 8;
static_assert(kTileRows % kWorkers == 0, "a tile holds whole rounds of workers");

// Shared memory: kStages stages of [K rows | V rows | (Q8) scale runs
// k0 k1 v0 v1], then the full and empty barriers.  The workers' merge
// reuses the ring once every tile is consumed.
template <int G, bool Q8>
struct Ring {
  static constexpr int kRowBytes = Q8 ? kD : kD * 2;
  static constexpr int kRows = kTileRows * kRowBytes;
  static constexpr int kStage = 2 * kRows + (Q8 ? 4 * kScaleSlots * 4 : 0);
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static constexpr int kMerge = kWorkers * G * (kD + 2) * 4;
  static_assert(kMerge <= kBars, "the merge fits in the ring");
  static_assert(kStage % 16 == 0 && kRowBytes % 16 == 0, "bulk copies need 16 B");
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack8_i8(const uint2& raw, float (&out)[8]) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(p[i]);
}

// atom.add.acq_rel.gpu: the old value of *ticket.
__device__ __forceinline__ int ticket_add(int* ticket) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

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
  constexpr int kRowBytes = Q8 ? kD : kD * 2;
  constexpr int kRows = kTileRows * kRowBytes;
  const int runs[2][2] = {{tl.ta, tl.n0}, {tl.c1, tl.n1}};
  uint32_t bytes = (uint32_t)(tl.n0 + tl.n1) * kRowBytes * 2;
  if (Q8) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = runs[r][0], n = runs[r][1];
      if (n) bytes += (uint32_t)(((c + n + 3) & ~3) - (c & ~3)) * 4 * 2;
    }
  }
  hopper::mbar_arrive_expect_tx(bar, bytes);
  int row = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = runs[r][0], n = runs[r][1];
    if (!n) continue;
    const uint32_t nb = (uint32_t)n * kRowBytes;
    hopper::bulk_load(stage + row * kRowBytes, kbase + (int64_t)c * kRowBytes, nb, bar);
    hopper::bulk_load(stage + kRows + row * kRowBytes, vbase + (int64_t)c * kRowBytes, nb,
                      bar);
    if (Q8) {
      float* sc = reinterpret_cast<float*>(stage + 2 * kRows);
      const int c0 = c & ~3;
      const uint32_t sb = (uint32_t)(((c + n + 3) & ~3) - c0) * 4;
      hopper::bulk_load(sc + r * kScaleSlots, ks_lane + c0, sb, bar);
      hopper::bulk_load(sc + (2 + r) * kScaleSlots, vs_lane + c0, sb, bar);
    }
    row += n;
  }
}

// Q8: kall/vall are int8 rows with per-row scales kscale/vscale; otherwise
// bf16 rows and the scale pointers are unused.
template <int G, bool Q8>
__global__ void __launch_bounds__(kBlockThreads)
    decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kall,
                  const void* __restrict__ vall, const float* __restrict__ kscale,
                  const float* __restrict__ vscale, const __nv_bfloat16* __restrict__ k_new,
                  const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ prompt_len,
                  const int* __restrict__ decode_end, float* __restrict__ ws,
                  int* __restrict__ counters, __nv_bfloat16* __restrict__ out, int layer,
                  int B, int Hkv, int S, int pb, int splits, float scale) {
  using R = Ring<G, Q8>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBars);
  uint64_t* empty = full + kStages;
  __shared__ float self_sums[G][kThreads / 32];
  __shared__ bool last;

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int half = (threadIdx.x / kRowThreads) & 1;
  const int worker = threadIdx.x / kRowThreads;
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kThreads / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  float m[G], l[G], acc[G][kPerThread];
  float v_self;  // v_new[d], the fresh V row's element of this thread
  if (!consumer) {
    if (threadIdx.x == kThreads) {
      const uint8_t* kbase = static_cast<const uint8_t*>(kall) + lane_row0 * R::kRowBytes;
      const uint8_t* vbase = static_cast<const uint8_t*>(vall) + lane_row0 * R::kRowBytes;
      const float* ks_lane = Q8 ? kscale + lane_row0 : nullptr;
      const float* vs_lane = Q8 ? vscale + lane_row0 : nullptr;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) hopper::mbar_wait(&empty[s], ((t / kStages) + 1) & 1);
        issue_tile<Q8>(smem + s * R::kStage, &full[s], Tile(start, end, t, plen, pb), kbase,
                       vbase, ks_lane, vs_lane);
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
      const float kd = __bfloat162float(k_new[((int64_t)b * Hkv + hk) * kD + d]);
      v_self = __bfloat162float(v_new[((int64_t)b * Hkv + hk) * kD + d]);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float qd =
            __bfloat162float(q[((int64_t)b * Hq + hk * G + gi) * kD + d]) * scale;
        float part = qd * kd;
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, o);
        }
        if (d % 32 == 0) self_sums[gi][d / 32] = part;
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
      const int s = t % kStages;
      const uint8_t* stage = smem + s * R::kStage;
      const float* sc = reinterpret_cast<const float*>(stage + 2 * R::kRows);
      const Tile tl(start, end, t, plen, pb);
      const int tb = tl.ta + tl.n0 + tl.n1;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      // The warp's kRounds rounds of the tile: its two half-warps take rows
      // j0 and j0 + 1, j0 = ta + 2 warp + 8 i.  Branch-free, so that the
      // rounds' shuffle trees and exponentials overlap: every round's scores
      // first (all 32 lanes take part; a row past the tile reads the tile's
      // first row and counts nothing), then the online-softmax updates in row
      // order, where a dead row leaves the state as it is (mn = m, alpha =
      // expf(0) = 1, p = 0, v = 0).
      constexpr int kRounds = kTileRows / kWorkers;
      float sr[kRounds][G], vf[kRounds][kPerThread], vs[kRounds];
      bool live[kRounds];
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
        const int jl = tl.ta + warp * 2 + i * kWorkers + half;
        live[i] = jl < tb;
        const int j = live[i] ? jl : tl.ta;
        const int off = (j - tl.ta) * R::kRowBytes + sub * kPerThread * (Q8 ? 1 : 2);
        float kf[kPerThread];
        float ks = 1.f;
        vs[i] = 1.f;
        if (Q8) {
          unpack8_i8(*reinterpret_cast<const uint2*>(stage + off), kf);
          unpack8_i8(*reinterpret_cast<const uint2*>(stage + R::kRows + off), vf[i]);
          // The slot of the row in its run's aligned superset.
          const int r = j < plen ? 0 : 1;
          const int slot = j < plen ? j - (tl.ta & ~3) : (pb + j - plen) - (tl.c1 & ~3);
          ks = sc[r * kScaleSlots + slot];
          vs[i] = sc[(2 + r) * kScaleSlots + slot];
        } else {
          unpack8(*reinterpret_cast<const uint4*>(stage + off), kf);
          unpack8(*reinterpret_cast<const uint4*>(stage + R::kRows + off), vf[i]);
        }
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) vf[i][e] = live[i] ? vf[i][e] : 0.f;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kPerThread; ++e) part = fmaf(qv[gi][e], kf[e], part);
#pragma unroll
          for (int o = kRowThreads / 2; o >= 1; o >>= 1) {
            part += __shfl_xor_sync(0xffffffffu, part, o);
          }
          sr[i][gi] = Q8 ? part * ks : part;
        }
      }
      __syncwarp();
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float mn = live[i] ? fmaxf(m[gi], sr[i][gi]) : m[gi];
          const float alpha = expf(m[gi] - mn);
          const float p = live[i] ? expf(sr[i][gi] - mn) : 0.f;
          l[gi] = l[gi] * alpha + p;
          const float pv = Q8 ? p * vs[i] : p;
#pragma unroll
          for (int e = 0; e < kPerThread; ++e) {
            acc[gi][e] = fmaf(pv, vf[i][e], acc[gi][e] * alpha);
          }
          m[gi] = mn;
        }
      }
    }
  }
  __syncthreads();  // every tile consumed: the ring is free for the merge

  float* sm_m = reinterpret_cast<float*>(smem);                // [kWorkers][G]
  float* sm_l = sm_m + kWorkers * G;                           // [kWorkers][G]
  float* sm_acc = sm_l + kWorkers * G;                         // [kWorkers][G][kD]
  if (consumer) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (sub == 0) {
        sm_m[worker * G + gi] = m[gi];
        sm_l[worker * G + gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        sm_acc[(worker * G + gi) * kD + sub * kPerThread + e] = acc[gi][e];
      }
    }
  }
  __syncthreads();

  // The block's partial (M, L, A[d]) per head; with more than one split it
  // goes to the workspace, from which the last block folds them all.
  const int d = threadIdx.x;  // kThreads == kD
  float* const base = ws + (((int64_t)b * Hkv + hk) * splits) * G * (kD + 2);
  float pm[G], pl[G], pa[G];
  if (consumer) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float M = kMaskValue;
#pragma unroll
      for (int w = 0; w < kWorkers; ++w) M = fmaxf(M, sm_m[w * G + gi]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWorkers; ++w) {
        const float wt = expf(sm_m[w * G + gi] - M);
        L = fmaf(sm_l[w * G + gi], wt, L);
        A = fmaf(sm_acc[(w * G + gi) * kD + d], wt, A);
      }
      pm[gi] = M;
      pl[gi] = L;
      pa[gi] = A;
      if (splits > 1) {
        float* dst = base + ((int64_t)split * G + gi) * (kD + 2);
        dst[d] = A;
        if (d == 0) {
          dst[kD] = M;
          dst[kD + 1] = L;
        }
      }
    }
  }
  if (splits > 1) {
    // One thread takes a ticket with an acq_rel atomic at gpu scope, after
    // the barrier that orders the block's partial stores before it: the
    // release publishes the partial, and the last of the lane's `splits`
    // blocks acquires every other one's (the barrier after it hands them to
    // the block's threads).
    __syncthreads();
    if (threadIdx.x == 0) {
      int* const ticket = counters + (int64_t)b * Hkv + hk;
      last = ticket_add(ticket) == splits - 1;
      if (last) *ticket = 0;
    }
    __syncthreads();
    if (!last) return;
  }
  if (!consumer) return;

  // Each head: the self-term, then the partials in split order.  With more
  // than one split the partials, items sp * G + gi, are read 32 to a round
  // of loads: lane l of each warp loads item l's M and L, each thread its
  // own A values.  M is a max, exact in any order (a butterfly over the
  // lanes of one head); the L and A sums run in split order, on values
  // broadcast by shuffles.
  float M[G], L[G], A[G], s_self[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    s_self[gi] = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s_self[gi] += self_sums[gi][w];
    M[gi] = s_self[gi];
  }
  if (splits == 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      M[gi] = fmaxf(M[gi], pm[gi]);
      L[gi] = expf(s_self[gi] - M[gi]);
      A[gi] = L[gi] * v_self;
      const float wt = expf(pm[gi] - M[gi]);
      L[gi] = fmaf(pl[gi], wt, L[gi]);
      A[gi] = fmaf(pa[gi], wt, A[gi]);
    }
  } else {
    const int lane = d % 32;
    const int items = splits * G;
    float mc, lc, v[32];
    // Items [c, c + 32): M and L of item c + lane, this thread's A values.
    auto load = [&](int c) {
      const float* p = base + (int64_t)(c + lane) * (kD + 2);
      mc = c + lane < items ? __ldcg(p + kD) : kMaskValue;
      lc = c + lane < items ? __ldcg(p + kD + 1) : 0.f;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        if (c + u < items) v[u] = __ldcg(base + (int64_t)(c + u) * (kD + 2) + d);
      }
    };
    load(0);
    float mx = mc;
    for (int c = 32; c < items; c += 32) {
      if (c + lane < items) mx = fmaxf(mx, __ldcg(base + (int64_t)(c + lane) * (kD + 2) + kD));
    }
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      M[gi] = fmaxf(M[gi], __shfl_sync(0xffffffffu, mx, gi));
      L[gi] = expf(s_self[gi] - M[gi]);
      A[gi] = L[gi] * v_self;
    }
    for (int c = 0; c < items; c += 32) {
      if (c > 0) load(c);
#pragma unroll
      for (int u = 0; u < 32; u += G) {
        if (c + u >= items) break;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float wt = expf(__shfl_sync(0xffffffffu, mc, u + gi) - M[gi]);
          L[gi] = fmaf(__shfl_sync(0xffffffffu, lc, u + gi), wt, L[gi]);
          A[gi] = fmaf(v[u + gi], wt, A[gi]);
        }
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    out[((int64_t)b * Hq + hk * G + gi) * kD + d] = __float2bfloat16(A[gi] / L[gi]);
  }
}

template <int G, bool Q8>
int launch(const void* q, const void* kall, const void* vall, const void* kscale,
           const void* vscale, const void* k_new, const void* v_new, const void* prompt_len,
           const void* decode_end, void* ws, void* counters, void* out, int layer, int B,
           int Hkv, int S, int pb, int splits, float scale, cudaStream_t stream) {
  using R = Ring<G, Q8>;
  auto kernel = decode_kernel<G, Q8>;
  static bool smem_ok = false;
  if (!smem_ok) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  const dim3 grid(splits, Hkv, B);
  kernel<<<grid, kBlockThreads, R::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kall, vall, static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int*>(prompt_len),
      static_cast<const int*>(decode_end), static_cast<float*>(ws),
      static_cast<int*>(counters), static_cast<__nv_bfloat16*>(out), layer, B, Hkv, S, pb,
      splits, scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch(const void* q, const void* kall, const void* vall, const void* kscale,
             const void* vscale, const void* k_new, const void* v_new, const void* prompt_len,
             const void* decode_end, void* ws, void* counters, void* out, int layer, int B,
             int Hq, int Hkv, int S, int pb, int splits, float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if ((Q8 && S % 4) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1:
      return launch<1, Q8>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len,
                           decode_end, ws, counters, out, layer, B, Hkv, S, pb, splits,
                           scale, st);
    case 2:
      return launch<2, Q8>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len,
                           decode_end, ws, counters, out, layer, B, Hkv, S, pb, splits,
                           scale, st);
    case 4:
      return launch<4, Q8>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len,
                           decode_end, ws, counters, out, layer, B, Hkv, S, pb, splits,
                           scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes as in the header comment; ws is f32 (B, Hkv, splits, Hq/Hkv, 130),
// counters int32 (B * Hkv,), zero on entry and left zero.  Hq / Hkv must be
// 1, 2 or 4; every pointer 16-byte aligned.  Returns the cudaError_t of the
// launch.
extern "C" int decode_attention_bf16(const void* q, const void* kall, const void* vall,
                                     const void* k_new, const void* v_new,
                                     const void* prompt_len, const void* decode_end, void* ws,
                                     void* counters, void* out, int layer, int B, int Hq,
                                     int Hkv, int S, int pb, int splits, float scale,
                                     void* stream) {
  return dispatch<false>(q, kall, vall, nullptr, nullptr, k_new, v_new, prompt_len,
                         decode_end, ws, counters, out, layer, B, Hq, Hkv, S, pb, splits,
                         scale, stream);
}

// K4: kall/vall int8 (L, B, Hkv, S, 128), kscale/vscale f32 (L, B, Hkv, S)
// with S % 4 == 0; everything else as decode_attention_bf16.
extern "C" int decode_attention_q8(const void* q, const void* kall, const void* vall,
                                   const void* kscale, const void* vscale, const void* k_new,
                                   const void* v_new, const void* prompt_len,
                                   const void* decode_end, void* ws, void* counters,
                                   void* out, int layer, int B, int Hq, int Hkv, int S,
                                   int pb, int splits, float scale, void* stream) {
  return dispatch<true>(q, kall, vall, kscale, vscale, k_new, v_new, prompt_len, decode_end,
                        ws, counters, out, layer, B, Hq, Hkv, S, pb, splits, scale, stream);
}
