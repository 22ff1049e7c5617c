// The split decode attention shared by K2/K4 (decode_attention.cu, the
// contiguous cache) and K6/K7 (decode_attention_paged.cu, the paged pool).
//
// One launch, blocks per (KV head, lane) that take one split each (K6/K7:
// or several, one after the other): one or two consumer groups of kThreads
// threads (four warps, as eight 16-thread workers) and one producer warp.
// A lane's valid rows are numbered densely and cut into `splits` chunks;
// the producer streams a block's chunks in tiles of
// kTileRows rows by 1-D bulk copies into a kStages-deep mbarrier ring, and
// worker w of each group takes the chunk's rows w, w + 8, ...: it dots each
// with the group's query rows of the KV head (f32, shuffles across the
// half-warp) and keeps an online softmax (max, sum, 128-wide accumulator)
// per query row in registers.  A second group takes the other half of the
// query rows from the same tiles, so that each row is still read once.  The
// workers merge through shared memory into one partial (m, l, acc) per
// query row; the last block of each (lane, KV head) to finish, counted by
// an acq_rel ticket that it resets to zero, folds the fresh rows' terms and
// the partials, in split order, into the output.
//
// With a write target the fold block also stores the lane's fresh K and V
// rows of the KV head into the cache or pool (K3's and K8's work, fused; see
// "the fresh rows' store" below), after every read of that (lane, KV head).
//
// This header holds what both kernels share: the ring's layout and barrier
// protocol, a tile's consumer work, the workers' merge, the partial's store,
// the ticket, the split fold and the fresh rows' store.  After the ring's
// setup only the consumers synchronise (a named barrier), so that the
// producer warp may run ahead.
// The arithmetic (row assignment, fmaf order, shuffle tree, softmax update,
// worker merge, split fold) is that of the port's earlier two-kernel
// versions, so both kernels give those versions' outputs bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace decode_split {

constexpr int kD = 128;
constexpr int kThreads = 128;                     // consumer threads of a group
constexpr int kRowThreads = 16;                   // threads per cache row
constexpr int kWorkers = kThreads / kRowThreads;  // 16-thread workers
constexpr int kPerThread = kD / kRowThreads;      // 8 elements
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr int kTileRows = 32;                     // rows per ring stage
constexpr int kStages = 4;
constexpr int kRounds = kTileRows / kWorkers;     // a worker's rows per tile
// f32 slots of one run of scales: the 16-byte aligned superset of at most
// kTileRows rows starts up to 3 rows early and ends up to 3 rows late.
constexpr int kScaleSlots = kTileRows + 8;
static_assert(kTileRows % kWorkers == 0, "a tile holds whole rounds of workers");

// Shared memory: kStages stages of [K rows | V rows | (Q8) K scale runs |
// V scale runs | kMeta ints], then the full and empty barriers.  kRuns is
// the most runs of rows a tile copies, R the query rows per KV head; the
// workers' merge takes kMerge bytes (in the ring once every tile is
// consumed; K6/K7 merge a block's earlier splits in a buffer of their own).
template <int R, bool Q8, int kRuns, int kMeta = 0>
struct Ring {
  static constexpr int kRowBytes = Q8 ? kD : kD * 2;
  static constexpr int kRows = kTileRows * kRowBytes;
  static constexpr int kScales = kRuns * kScaleSlots;  // f32 per K or V
  static constexpr int kStage = 2 * kRows + (Q8 ? (2 * kScales + kMeta) * 4 : 0);
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
  static constexpr int kMerge = kWorkers * R * (kD + 2) * 4;
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

// atom.add.acq_rel.gpu: adds n, returns the old value of *ticket.
__device__ __forceinline__ int ticket_add(int* ticket, int n) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(ticket), "r"(n)
               : "memory");
  return old;
}

// A barrier of the block's kConsumers consumer threads alone (named barrier
// 1), so that the producer warp may still be issuing, or gone.
template <int kConsumers>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// -- the ring ------------------------------------------------------------------
// Tile t lives in stage t % NS (NS = kStages here; K11b's stream,
// decode_attention_hbm3.cu, runs a deeper ring on the same protocol).
// full[s] takes the producer's one arrival and the tile's bytes; empty[s]
// one arrival per consumer warp.

// One thread, before the block's first barrier.
template <int NS = kStages>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int consumer_warps) {
  for (int s = 0; s < NS; ++s) {
    hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(&empty[s], consumer_warps);
  }
  hopper::fence_barrier_init();
}

// Producer: wait until tile t's stage is free (tile t - NS consumed).
template <int NS = kStages>
__device__ __forceinline__ void ring_reserve(uint64_t* empty, int t) {
  if (t >= NS) hopper::mbar_wait(&empty[t % NS], ((t / NS) + 1) & 1);
}

// Consumers: wait for tile t's bytes.
template <int NS = kStages>
__device__ __forceinline__ void ring_wait(uint64_t* full, int t) {
  hopper::mbar_wait(&full[t % NS], (t / NS) & 1);
}

// A consumer warp is done reading tile t's stage.
template <int NS = kStages>
__device__ __forceinline__ void ring_release(uint64_t* empty, int t) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[t % NS]);
}

// -- the consumers -------------------------------------------------------------

// A consumer thread's share of the tile of rows [ta, tb) in `stage` (row j
// at stage row j - ta), tile t of its block, for its group's R query rows:
// the warp's two half-warps take rows j0 and j0 + 1, j0 = ta + 2 warp + 8 i
// (warp of the group), for the tile's kRounds rounds
// i.  Branch-free, so that the rounds' shuffle trees and exponentials
// overlap: kBatch rounds' scores first (all 32 lanes take part; a row past
// the tile reads the tile's first row and counts nothing), then their
// online-softmax updates in row order, where a dead row leaves the state as
// it is (mn = m, alpha = expf(0) = 1, p = 0, v = 0).  A worker's 16 lanes
// hold the same scores and state, so each of a row's 2 R exponentials is
// taken once, on its own lane, and broadcast by a shuffle.  The stage is
// released once its last round is read.  With Q8, `slot(j)` is row j's
// slot in the stage's K scale runs (its V scale sits kScales slots later).
template <int R, bool Q8, int kRuns, int kMeta, class Slot>
__device__ __forceinline__ void consume_tile(const uint8_t* stage, int ta, int tb, int t,
                                             uint64_t* empty, const float (&qv)[R][kPerThread],
                                             float (&m)[R], float (&l)[R],
                                             float (&acc)[R][kPerThread], Slot slot) {
  using Rg = Ring<R, Q8, kRuns, kMeta>;
  static_assert(2 * R <= kRowThreads, "a worker's exponentials fit its lanes");
  // Rounds to a batch: all of a tile's for up to 4 query rows, fewer for
  // more rows, whose scores would not fit the registers.
  constexpr int kBatch = R <= 4 ? kRounds : (8 / R >= 2 ? 2 : 1);
  const int warp = threadIdx.x % kThreads / 32;
  const int half = (threadIdx.x / kRowThreads) & 1;
  const int sub = threadIdx.x % kRowThreads;
  const float* sc = reinterpret_cast<const float*>(stage + 2 * Rg::kRows);
#pragma unroll
  for (int i0 = 0; i0 < kRounds; i0 += kBatch) {
    float sr[kBatch][R], vf[kBatch][kPerThread], vs[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int jl = ta + warp * 2 + (i0 + k) * kWorkers + half;
      live[k] = jl < tb;
      const int j = live[k] ? jl : ta;
      const int off = (j - ta) * Rg::kRowBytes + sub * kPerThread * (Q8 ? 1 : 2);
      float kf[kPerThread];
      float ks = 1.f;
      vs[k] = 1.f;
      if constexpr (Q8) {
        unpack8_i8(*reinterpret_cast<const uint2*>(stage + off), kf);
        unpack8_i8(*reinterpret_cast<const uint2*>(stage + Rg::kRows + off), vf[k]);
        const int s = slot(j);
        ks = sc[s];
        vs[k] = sc[Rg::kScales + s];
      } else {
        unpack8(*reinterpret_cast<const uint4*>(stage + off), kf);
        unpack8(*reinterpret_cast<const uint4*>(stage + Rg::kRows + off), vf[k]);
      }
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) vf[k][e] = live[k] ? vf[k][e] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) part = fmaf(qv[r][e], kf[e], part);
#pragma unroll
        for (int o = kRowThreads / 2; o >= 1; o >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, o);
        }
        sr[k][r] = Q8 ? part * ks : part;
      }
    }
    if (i0 + kBatch == kRounds) ring_release(empty, t);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      float mn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mn[r] = live[k] ? fmaxf(m[r], sr[k][r]) : m[r];
      // Lane r of the worker takes alpha_r = expf(m_r - mn_r), lane R + r
      // takes expf(s_r - mn_r).
      float x = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x = sub == r ? m[r] - mn[r] : x;
        x = sub == R + r ? sr[k][r] - mn[r] : x;
      }
      const float ex = expf(x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float alpha = __shfl_sync(0xffffffffu, ex, r, kRowThreads);
        const float pe = __shfl_sync(0xffffffffu, ex, R + r, kRowThreads);
        const float p = live[k] ? pe : 0.f;
        l[r] = l[r] * alpha + p;
        const float pv = Q8 ? p * vs[k] : p;
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
          acc[r][e] = fmaf(pv, vf[k][e], acc[r][e] * alpha);
        }
        m[r] = mn[r];
      }
    }
  }
}

// -- the merge, the ticket and the fold ----------------------------------------

// The consumers, once every one is done with `buf` (a barrier of theirs
// first): the workers' states merge through shared memory `buf` into the
// block's partial (pm, pl, pa[d]) per query row of the thread's group,
// thread d = threadIdx.x % kThreads of the group's; group g holds rows
// [g R, g R + R) of the block's kGroups * R.  Each worker weight
// expf(m_w - M) is taken once a warp, on its own lane, and broadcast by a
// shuffle.
template <int R, int kGroups>
__device__ __forceinline__ void merge_workers(float* buf, const float (&m)[R],
                                              const float (&l)[R],
                                              const float (&acc)[R][kPerThread],
                                              float (&pm)[R], float (&pl)[R], float (&pa)[R]) {
  constexpr int kRowsAll = kGroups * R;
  const int r0 = threadIdx.x / kThreads * R;
  const int worker = threadIdx.x % kThreads / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  float* sm_m = buf;                          // [kWorkers][kRowsAll]
  float* sm_l = sm_m + kWorkers * kRowsAll;   // [kWorkers][kRowsAll]
  float* sm_acc = sm_l + kWorkers * kRowsAll; // [kWorkers][kRowsAll][kD]
  consumer_sync<kGroups * kThreads>();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = worker * kRowsAll + r0 + r;
    if (sub == 0) {
      sm_m[row] = m[r];
      sm_l[row] = l[r];
    }
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) sm_acc[row * kD + sub * kPerThread + e] = acc[r][e];
  }
  consumer_sync<kGroups * kThreads>();

  const int d = threadIdx.x % kThreads;  // kThreads == kD
  constexpr int kPairs = R * kWorkers;   // (row, worker) weights
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pm[r] = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) pm[r] = fmaxf(pm[r], sm_m[w * kRowsAll + r0 + r]);
    pl[r] = 0.f;
    pa[r] = 0.f;
  }
  // Pairs [c, c + 32): lane i takes pair c + i's weight; the sums run per
  // row in worker order.
#pragma unroll
  for (int c = 0; c < kPairs; c += 32) {
    const int pr = min(c + d % 32, kPairs - 1);
    float Mp = pm[0];
#pragma unroll
    for (int r = 1; r < R; ++r) Mp = pr / kWorkers == r ? pm[r] : Mp;
    const float ex = expf(sm_m[pr % kWorkers * kRowsAll + r0 + pr / kWorkers] - Mp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (c + i < kPairs) {
        const int r = (c + i) / kWorkers;
        const int row = (c + i) % kWorkers * kRowsAll + r0 + r;
        const float wt = __shfl_sync(0xffffffffu, ex, i);
        pl[r] = fmaf(sm_l[row], wt, pl[r]);
        pa[r] = fmaf(sm_acc[row * kD + d], wt, pa[r]);
      }
    }
  }
}

// A consumer's share of the block's partial to `part` (the block's rows,
// kD + 2 floats each: A[0..kD), M, L).
template <int R>
__device__ __forceinline__ void store_partial(float* part, const float (&pm)[R],
                                              const float (&pl)[R], const float (&pa)[R]) {
  const int r0 = threadIdx.x / kThreads * R;
  const int d = threadIdx.x % kThreads;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* dst = part + (r0 + r) * (kD + 2);
    dst[d] = pa[r];
    if (d == 0) {
      dst[kD] = pm[r];
      dst[kD + 1] = pl[r];
    }
  }
}

// The consumers, after storing the partials of n of a (lane, KV head)'s
// `total` splits: whether this block is the last to arrive.  Thread 0 takes
// the ticket with an acq_rel atomic at gpu scope, after the barrier that
// orders the block's partial stores before it: the release publishes the
// partials, and the last block acquires every other one's (the barrier
// after it hands them to the block's threads); the last block resets the
// ticket to zero.
template <int kConsumers>
__device__ __forceinline__ bool take_ticket(int* ticket, int total, int n) {
  __shared__ bool last;
  consumer_sync<kConsumers>();
  if (threadIdx.x == 0) {
    last = ticket_add(ticket, n) == total - n;
    if (last) *ticket = 0;
  }
  consumer_sync<kConsumers>();
  return last;
}

// The fold of a group's R query rows, rows r0.. of the block's kRowsAll
// (thread d = threadIdx.x % kThreads): M[r] arrives holding the max of the
// row's fresh scores; `fresh(r, M, L, A)` sets L and A to the fresh terms'
// sum and weighted V under the final max M.  Then the partials join in
// split order: from registers (pm, pl, pa) when splits == 1, else from
// `base`, row r0 + r of split sp at (sp * kRowsAll + r0 + r) (kD + 2)
// floats, the group's items i = sp * R + r read kChunk to a round of loads,
// a round ahead (lane u of each warp loads item u's M and L, each thread its
// own A values).  M is a max, exact in any order; the L and A sums run in split
// order, on values broadcast by shuffles; each item's weight expf(M_i - M)
// is taken once, on the lane that loaded the item.
template <int R, int kRowsAll, class Fresh>
__device__ __forceinline__ void fold_splits(const float* base, int splits, int r0,
                                            const float (&pm)[R], const float (&pl)[R],
                                            const float (&pa)[R], float (&M)[R], float (&L)[R],
                                            float (&A)[R], Fresh fresh) {
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      M[r] = fmaxf(M[r], pm[r]);
      fresh(r, M[r], L[r], A[r]);
      const float wt = expf(pm[r] - M[r]);
      L[r] = fmaf(pl[r], wt, L[r]);
      A[r] = fmaf(pa[r], wt, A[r]);
    }
    return;
  }
  constexpr int kChunk = 32 / R * R;  // whole rows' items to a round
  const int d = threadIdx.x % kThreads;
  const int lane = d % 32;
  const int items = splits * R;
  // Item i: row r0 + i % R of split i / R.
  auto item = [&](int i) {
    return base + ((int64_t)(i / R) * kRowsAll + r0 + i % R) * (kD + 2);
  };
  // Items [c, c + kChunk) into one of two buffers: M and L of item c + lane,
  // this thread's A values.  A round's loads are issued a round ahead.
  float mc0, lc0, v0[kChunk], mc1, lc1, v1[kChunk];
  auto load = [&](int c, float& mc, float& lc, float (&v)[kChunk]) {
    const bool mine = lane < kChunk && c + lane < items;
    const float* p = item(mine ? c + lane : 0);
    mc = mine ? __ldcg(p + kD) : kMaskValue;
    lc = mine ? __ldcg(p + kD + 1) : 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (c + u < items) v[u] = __ldcg(item(c + u) + d);
    }
  };
  load(0, mc0, lc0, v0);
  if (kChunk < items) load(kChunk, mc1, lc1, v1);
  float mx = mc0;
  for (int c = kChunk; c < items; c += kChunk) {
    if (lane < kChunk && c + lane < items) mx = fmaxf(mx, __ldcg(item(c + lane) + kD));
  }
  if constexpr ((R & (R - 1)) == 0) {
    // Lane r ends with the max over the lanes of row r (lane % R == r).
#pragma unroll
    for (int o = 16; o >= R; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
#pragma unroll
    for (int r = 0; r < R; ++r) M[r] = fmaxf(M[r], __shfl_sync(0xffffffffu, mx, r));
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = r; u < kChunk; u += R) M[r] = fmaxf(M[r], __shfl_sync(0xffffffffu, mx, u));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) fresh(r, M[r], L[r], A[r]);
  float Mlane = M[0];  // the max of the row of this lane's items
#pragma unroll
  for (int r = 1; r < R; ++r) Mlane = lane % R == r ? M[r] : Mlane;
  auto step = [&](int c, float mc, float lc, const float (&v)[kChunk]) {
    const float wl = expf(mc - Mlane);
#pragma unroll
    for (int u = 0; u < kChunk; u += R) {
      if (c + u >= items) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float wt = __shfl_sync(0xffffffffu, wl, u + r);
        L[r] = fmaf(__shfl_sync(0xffffffffu, lc, u + r), wt, L[r]);
        A[r] = fmaf(v[u + r], wt, A[r]);
      }
    }
  };
  for (int c = 0; c < items; c += 2 * kChunk) {
    step(c, mc0, lc0, v0);
    if (c + kChunk >= items) break;
    if (c + 2 * kChunk < items) load(c + 2 * kChunk, mc0, lc0, v0);
    step(c + kChunk, mc1, lc1, v1);
    if (c + 3 * kChunk < items) load(c + 3 * kChunk, mc1, lc1, v1);
  }
}

// -- the fresh rows' store -----------------------------------------------------
// The fold block of a (lane, KV head) stores the lane's T fresh K and V rows
// of the KV head (the step's or the verify's, the rows the attention took
// from k_new/v_new) into the cache or pool, once it has written the output.
// Consumer group g stores rows t with t % kGroups == g, thread d of the
// group element d.  Every block prepares the shared FreshStore before its
// first consumer barrier (the workers' merge opens with one): each row's
// destination row of the cache or pool, -1 when the row is dropped, and for
// int8 rows each consumer warp's max |x| of its 32 elements of the K and of
// the V row, reduced while the ring fills.  So the fold block's store reads
// shared memory and its own registers: no global load and one barrier
// fewer on the path to the block's end.
//
// Int8 rows are quantized as kv_write.cu's writers do, bit for bit: s =
// max|x| / 127 by __fdiv_rn, or 1 for an all-zero row; q =
// clip(__float2int_rn(__fdiv_rn(x, s)), -127, 127).  A max is exact in any
// order, so the four warps' maxima give the writer's half-warp tree's value.
//
// Why the store needs no other synchronisation:
//   * Every read of the (lane, KV head)'s cache or pool rows in this launch
//     is a bulk copy (the async proxy) by one of its blocks, whose
//     completion a consumer of that block observed on a full barrier before
//     the block's ticket (splits == 1: before this block's merge).  The
//     fold block's ticket acquires every other block's release, and the
//     completion of a bulk copy is followed by an implicit generic-async
//     proxy fence (PTX ISA, the async proxy), so these generic stores are
//     ordered after all of those reads, the clamp case's too (a write slot
//     inside the interval being read).  No fence.proxy.async is needed: that
//     fence orders generic writes before later async-proxy reads, and no
//     bulk copy of this launch reads a stored row; the next launch's do, in
//     stream order.
//   * Blocks of other (lane, KV head) pairs read other rows: a lane's cache
//     rows are its own, and the engine gives each sequence pages of its own.
//     Only the trash page 0, which no lane reads as a valid row, may take
//     stores of several idle lanes at one offset; those race, as in K8.

template <int T>
struct FreshStore {
  int64_t dst[T];                   // destination row of fresh row t; -1: dropped
  float amax[T][2][kThreads / 32];  // int8: per-warp max |K| ([0]) and |V| ([1])
};

// The warp's max |x| over its 32 threads' elements, to *slot (lane 0), as
// the writers' fmaxf tree from 0 gives it (a NaN element is passed over):
// one redux.sync on the bit patterns, whose unsigned order is the order of
// non-negative floats.
__device__ __forceinline__ void warp_absmax(float x, float* slot) {
  const unsigned a = __reduce_max_sync(0xffffffffu, __float_as_uint(fmaxf(0.f, fabsf(x))));
  if (threadIdx.x % 32 == 0) *slot = __uint_as_float(a);
}

// Thread d of the group that owns fresh row t: element d of its K value xk
// and V value xv to row fs.dst[t] of kc / vc (bf16 rows, or int8 rows with
// their f32 scales in ks / vs).  After a consumer barrier that followed the
// FreshStore's preparation.
template <bool Q8, int T>
__device__ __forceinline__ void store_fresh_row(const FreshStore<T>& fs, int t, float xk,
                                                float xv, void* kc, void* vc, float* ks,
                                                float* vs) {
  const int64_t row = fs.dst[t];
  if (row < 0) return;
  const int d = threadIdx.x % kThreads;
  if constexpr (Q8) {
    const float x[2] = {xk, xv};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) a = fmaxf(a, fs.amax[t][c][w]);
      const float s = a == 0.f ? 1.f : __fdiv_rn(a, 127.f);
      const int q = max(-127, min(127, __float2int_rn(__fdiv_rn(x[c], s))));
      static_cast<int8_t*>(c ? vc : kc)[row * kD + d] = static_cast<int8_t>(q);
      if (d == 0) (c ? vs : ks)[row] = s;
    }
  } else {
    // xk, xv are bf16 values widened to f32: the round trip is exact.
    static_cast<__nv_bfloat16*>(kc)[row * kD + d] = __float2bfloat16(xk);
    static_cast<__nv_bfloat16*>(vc)[row * kD + d] = __float2bfloat16(xv);
  }
}

}  // namespace decode_split
