// K6 and K7: decode attention over the paged KV pool, through a page table.
//
// Replaces qwen3_asr_tpu/ops/pallas/decode_attention_paged.py (_kernel :53,
// wiring _paged_call :329, pallas_call :432): decode_attention_paged (:472)
// and decode_attention_paged_q8 (:499) as K6, decode_attention_paged_verify
// (:526) and decode_attention_paged_verify_q8 (:560) as K7.
// q (B, Hq, T, 128) bf16 (T = 1 for K6, the step); kpool/vpool
// (L, n_pages, Hkv, PS, 128); k_new/v_new (B, Hkv, T, 128) bf16, the fresh
// rows of this forward; table (B, max_pages) int32 physical pages;
// prompt_len, decode_count (B,) int32.  Masking is compact, as in the TPU
// kernel: lane b's prompt rows are compact rows [0, plen) on its first
// pp = ceil(plen / PS) table entries, its decode rows [0, dcount) start at
// entry pp; decode_count excludes the T fresh rows.  Table entries are
// clipped into [0, n_pages) (the TPU wrapper's clip, :386-389).  Every
// query row attends the same history; the fresh T x T block is causal
// (query position t sees fresh column u iff u <= t, :303-308).  With
// write_pages and write_offsets (B, T) int32, the kernel also stores fresh
// row t of lane b at pool[layer, clip(write_pages[b, t], 0, n_pages - 1),
// hk, write_offsets[b, t]] (K8's work, qwen3_asr_tpu/ops/pallas/kv_write.py:
// kv_write_rows_paged :219, fused; an offset outside [0, PS) is dropped),
// after every read of the lane's pages: the JAX decoder's order (attention
// over the pre-step pool, then the write), one launch instead of three.
//
// Bound on the H100: bytes.  A forward reads each valid K and V row once
// (2 * 256 B per row and KV head, bf16) and does 2 * R FMAs per element,
// R = T * group query rows per KV head, far below the ~295 FLOP/byte ridge;
// at R = 8 (K7) the card runs out of issue slots before bytes.
// Design: K2's (decode_split.cuh) with page addressing, in one launch:
//   * the lane's valid rows are numbered densely 0..plen+dcount and cut into
//     `splits` chunks (K2's split_count), so small batches still fill the
//     card.  K7's T positions ride in the rows K2 gives its GQA group, so
//     every query row of a lane reads each page once -- the point of the
//     TPU verify kernel (:285-294).
//   * blocks per (kv head, lane): one a split when every split's block fits
//     on the card at once (the occupancy the runtime reports), else as few
//     splits to a block as make them fit, taken one after the other.
//   * a producer warp reads the lane's table row once, clipped, into shared
//     memory; one thread of it cuts each 32-row tile into runs, breaking at
//     every page boundary and at the switch from prompt to decode rows (at
//     most three runs when PS >= 32: a page boundary among the prompt rows
//     and the switch, or a page boundary among the decode rows), and issues
//     one 1-D bulk copy per run for K and for V into a 4-stage mbarrier
//     ring; within one (layer, page, kv head) a run's rows are contiguous
//     in the pool.
//   * consumer warps, as 16-thread workers, take the chunk's rows w, w + 8,
//     ... from the ring, dot each with their query rows (f32, shuffles
//     across the half-warp) and keep an online softmax per query row; with
//     R = 8 two groups of four warps take four query rows each from the
//     same tiles.  The workers merge through shared memory into one partial
//     per query row, and the last block of the (lane, kv head) to finish (an
//     acq_rel ticket in the arrival counters, left at zero) folds the causal
//     fresh block, reduced by every block while its first tile lands, and
//     the partials in split order into the output, then stores the fresh
//     rows into the pool when given a write target (decode_split.cuh's
//     fresh rows' store: each row's pool row resolved and, for int8, its
//     abs-max reduced while the first tile lands; the groups take the T
//     rows in turn).
// The arithmetic is that of the two-kernel version (a split pass and a
// combine pass) it replaces, so the output is bit-identical to it.
// Masking is by construction (only valid rows are visited); the running max
// starts at a finite -0.7 * FLT_MAX (the TPU kernel's mask value), so a
// lane with no valid rows (an idle slot) yields its fresh block alone:
// finite, and the fresh column u = 0 keeps every row's sum above zero.
//
// The int8 pool (Q8): int8 rows with one f32 scale per row, kscale/vscale
// (L, n_pages, Hkv, PS); the scales fold into the score and the
// probability as in K4 (ops/quant_kv.py): half the row bytes, plus 8 bytes
// of scales per row.  Each run's scales are copied as their 16-byte aligned
// superset, which stays inside the page because PS % 4 == 0; the producer
// writes each run's first row and scale slot beside the stage's scales.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"
#include "gemm_tiles.cuh"

namespace {

using namespace decode_split;

// Runs a tile copies: with PS >= kTileRows, a page boundary and the switch
// from prompt to decode rows, or one page boundary among the decode rows.
constexpr int kRuns = 3;
// Per stage (int8 pool): each run's first stage row, then its scale slot
// base; padded to 16 bytes.
constexpr int kMeta = 8;
static_assert(2 * kRuns <= kMeta, "the run table fits");
constexpr int kMaxRows = 8;  // query rows per KV head (T x group)

// Consumer groups for R query rows per KV head: two when R is even and
// above 4 (K7's 8 rows: each group keeps 4 rows' state in registers, and
// eight consumer warps share the SM), else one.
template <int R>
struct Groups {
  static constexpr int kCount = R > 4 && R % 2 == 0 ? 2 : 1;
  static constexpr int kRows = R / kCount;  // query rows of one group
  static constexpr int kConsumers = kCount * kThreads;
  static constexpr int kBlockThreads = kConsumers + 32;
};

// n compact rows of a lane from row j0, at offset off of table entry
// `entry` (a run lies inside one page and one interval).
struct Run {
  int j0, n, entry, off;
};

// The runs of tile [ta, tb) of a lane's compact rows; returns their count.
// A run breaks at every page boundary and at the switch from prompt rows
// (entries [0, pp)) to decode rows (entries from pp).  Mirrored by
// tile_runs in tests/test_torch_paged.py.
__device__ __forceinline__ int plan_tile(int ta, int tb, int plen, int pp, int PS,
                                         Run (&runs)[kRuns]) {
  int j = ta, n_runs = 0;
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    if (j < tb) {
      int entry, off, room;
      if (j < plen) {
        entry = j / PS;
        off = j - entry * PS;
        room = min(PS - off, plen - j);
      } else {
        const int dj = j - plen;
        entry = pp + dj / PS;
        off = dj - (entry - pp) * PS;
        room = PS - off;
      }
      runs[k] = Run{j, min(room, tb - j), entry, off};
      j += runs[k].n;
      n_runs = k + 1;
    }
  }
  return n_runs;
}

// Producer: the bulk copies of the tile of rows [ta, tb) into `stage`,
// completing on `bar`.  Row r of the pool's (layer, page, kv head) block is
// pool row head_row0 + page * page_rows + r.
template <bool Q8>
__device__ __forceinline__ void issue_tile(uint8_t* stage, uint64_t* bar, int ta, int tb,
                                           int plen, int pp, int PS, const int* pages,
                                           int max_pages, int64_t head_row0, int64_t page_rows,
                                           const uint8_t* kpool, const uint8_t* vpool,
                                           const float* kscale, const float* vscale) {
  using Rg = Ring<1, Q8, kRuns, kMeta>;
  Run runs[kRuns];
  const int n_runs = plan_tile(ta, tb, plen, pp, PS, runs);
  float* sc = reinterpret_cast<float*>(stage + 2 * Rg::kRows);
  uint32_t bytes = (uint32_t)(tb - ta) * Rg::kRowBytes * 2;
  if (Q8) {
    // Written before the arrive below, whose release the consumers'
    // wait acquires.
    int* meta = reinterpret_cast<int*>(sc + 2 * Rg::kScales);
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      if (k < n_runs) {
        const int off = runs[k].off, n = runs[k].n;
        bytes += (uint32_t)(((off + n + 3) & ~3) - (off & ~3)) * 4 * 2;
        meta[k] = runs[k].j0 - ta;
        meta[kRuns + k] = k * kScaleSlots + (off & 3) - (runs[k].j0 - ta);
      } else {
        meta[k] = kTileRows;
      }
    }
  }
  hopper::mbar_arrive_expect_tx(bar, bytes);
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    if (k >= n_runs) break;
    const Run& run = runs[k];
    const int page = pages[min(run.entry, max_pages - 1)];
    const int64_t row = head_row0 + (int64_t)page * page_rows + run.off;
    const uint32_t nb = (uint32_t)run.n * Rg::kRowBytes;
    const int at = (run.j0 - ta) * Rg::kRowBytes;
    hopper::bulk_load(stage + at, kpool + row * Rg::kRowBytes, nb, bar);
    hopper::bulk_load(stage + Rg::kRows + at, vpool + row * Rg::kRowBytes, nb, bar);
    if (Q8) {
      const int lead = run.off & 3;
      const uint32_t sb = (uint32_t)(((run.off + run.n + 3) & ~3) - (run.off - lead)) * 4;
      hopper::bulk_load(sc + k * kScaleSlots, kscale + row - lead, sb, bar);
      hopper::bulk_load(sc + Rg::kScales + k * kScaleSlots, vscale + row - lead, sb, bar);
    }
  }
}

// R query rows per KV head (T * group), row r = g * T + t, so that q, the
// workspace and the output are (B, Hkv, R, ...) in memory; consumer group c
// takes rows [c RG, c RG + RG).  Block x of a (lane, KV head) takes splits
// x, x + nb, ... (nb = gridDim.x <= splits): the producer streams their
// tiles through the ring back to back, and the consumers merge each split
// in a buffer of its own while the next split's tiles land.  T is a
// template parameter so that the causal fresh block's loops are static.
// Q8: int8 pools with per-row scales; otherwise bf16 pools and the scale
// pointers unused.
// The pools are read by bulk copies and written only by the fresh rows'
// store (write_pages and write_offsets non-null).
template <int R, int T, bool Q8>
__global__ void __launch_bounds__(Groups<R>::kBlockThreads)
    paged_kernel(const __nv_bfloat16* __restrict__ q, void* __restrict__ kpool,
                 void* __restrict__ vpool, float* __restrict__ kscale,
                 float* __restrict__ vscale, const __nv_bfloat16* __restrict__ k_new,
                 const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ table,
                 const int* __restrict__ prompt_len, const int* __restrict__ decode_count,
                 const int* __restrict__ write_pages, const int* __restrict__ write_offsets,
                 float* __restrict__ ws, int* __restrict__ counters,
                 __nv_bfloat16* __restrict__ out, int layer, int Hkv, int n_pages,
                 int PS, int max_pages, int splits, float scale) {
  using Rg = Ring<R, Q8, kRuns, kMeta>;
  using Gr = Groups<R>;
  constexpr int RG = Gr::kRows;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Rg::kBars);
  uint64_t* empty = full + kStages;
  // A block with more than one split merges all but its last in a buffer of
  // their own (the ring still streams), the last in the ring.
  const bool many = gridDim.x < splits;
  float* merge_buf = reinterpret_cast<float*>(smem + Rg::kBytes);  // Rg::kMerge bytes
  int* pages = reinterpret_cast<int*>(smem + Rg::kBytes + (many ? Rg::kMerge : 0));
  // The fresh scores q_r . k_new[u], u <= t, per warp of a group.
  __shared__ float fresh_sums[R][T][kThreads / 32];
  __shared__ FreshStore<T> fresh;
  const bool write = write_pages != nullptr;

  const int nb = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int sub = threadIdx.x % kRowThreads;
  const bool consumer = threadIdx.x < Gr::kConsumers;
  const int grp = threadIdx.x / kThreads;      // a consumer's group
  const int r0 = grp * RG;                     // the group's first query row
  const int d = threadIdx.x % kThreads;        // a consumer's element of a row

  const int plen = max(prompt_len[b], 0);
  const int dcount = max(decode_count[b], 0);
  const int pp = (plen + PS - 1) / PS;
  const int n_valid = plen + dcount;
  const int chunk = (n_valid + splits - 1) / splits;
  // Split s covers the lane's compact rows [start, end).
  auto range = [&](int s, int& start, int& end) {
    start = min(n_valid, s * chunk);
    end = min(n_valid, start + chunk);
  };
  const int64_t lane_head = ((int64_t)b * Hkv + hk) * R;  // q / out row of r = 0
  const int64_t fresh0 = ((int64_t)b * Hkv + hk) * T;     // k_new / v_new row of u = 0
  // The fresh position t of the group's row r: static when every group's
  // rows start at a multiple of T.
  auto t_of = [&](int r) { return RG % T == 0 ? r % T : (r0 + r) % T; };

  if (threadIdx.x == 0) ring_init(full, empty, Gr::kConsumers / 32);
  __syncthreads();

  if (!consumer) {
    if (n_valid == 0) return;
    const int lane = threadIdx.x - Gr::kConsumers;
    const int* tab = table + (int64_t)b * max_pages;
    for (int i = lane; i < max_pages; i += 32) pages[i] = min(max(tab[i], 0), n_pages - 1);
    __syncwarp();
    if (lane != 0) return;
    const int64_t head_row0 = ((int64_t)layer * n_pages * Hkv + hk) * PS;
    const int64_t page_rows = (int64_t)Hkv * PS;
    int g = 0;  // the block's tile count: tile g lives in stage g % kStages
    for (int s = blockIdx.x; s < splits; s += nb) {
      int start, end;
      range(s, start, end);
      for (int ta = start; ta < end; ta += kTileRows, ++g) {
        ring_reserve(empty, g);
        issue_tile<Q8>(smem + (g % kStages) * Rg::kStage, &full[g % kStages], ta,
                       min(end, ta + kTileRows), plen, pp, PS, pages, max_pages, head_row0,
                       page_rows, static_cast<const uint8_t*>(kpool),
                       static_cast<const uint8_t*>(vpool), kscale, vscale);
      }
    }
    return;
  }

  float qv[RG][kPerThread];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(q + (lane_head + r0 + r) * kD + sub * kPerThread);
    unpack8(raw, qv[r]);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) qv[r][e] *= scale;
  }
  // The group's fresh scores q_r . k_new[u] while the first tile lands
  // (every block; the last one to finish folds them in): per fresh column u
  // the rows' shuffle trees run together; a row with t < u sums zeros and
  // its score is never read.
  {
    float qd[RG], kn[T];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      qd[r] = __bfloat162float(q[(lane_head + r0 + r) * kD + d]) * scale;
    }
#pragma unroll
    for (int u = 0; u < T; ++u) kn[u] = __bfloat162float(k_new[(fresh0 + u) * kD + d]);
    // The fresh rows' store's inputs, loaded beside them and consumed once
    // the scores are reduced: thread t's row t position, and for int8 the
    // V elements of the group's rows.
    int wpage = 0, woff = -1;
    if (write && threadIdx.x < T) {
      wpage = write_pages[b * T + threadIdx.x];
      woff = write_offsets[b * T + threadIdx.x];
    }
    float vq[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      vq[u] = Q8 && write && u % Gr::kCount == grp
                  ? __bfloat162float(v_new[(fresh0 + u) * kD + d])
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < T; ++u) {
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float part = u <= t_of(r) ? qd[r] * kn[u] : 0.f;
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (d % 32 == 0) fresh_sums[r0 + r][u][d / 32] = part;
      }
    }
    // The store, prepared (visible after the merge's barrier): row t's pool
    // row by thread t, its int8 abs-maxima by its group.
    if (write) {
      if (threadIdx.x < T) {
        const int page = min(max(wpage, 0), n_pages - 1);
        fresh.dst[threadIdx.x] =
            woff >= 0 && woff < PS
                ? (((int64_t)layer * n_pages + page) * Hkv + hk) * PS + woff
                : -1;
      }
      if (Q8) {
#pragma unroll
        for (int u = 0; u < T; ++u) {
          if (u % Gr::kCount == grp) {
            warp_absmax(kn[u], &fresh.amax[u][0][d / 32]);
            warp_absmax(vq[u], &fresh.amax[u][1][d / 32]);
          }
        }
      }
    }
  }

  // Each split: its tiles, then its partial (to the workspace, or kept in
  // registers when the lane has one split).
  float* const base = ws + (((int64_t)b * Hkv + hk) * splits) * R * (kD + 2);
  float pm[RG], pl[RG], pa[RG];
  int g = 0, n_mine = 0;
  for (int s = blockIdx.x; s < splits; s += nb, ++n_mine) {
    int start, end;
    range(s, start, end);
    float m[RG], l[RG], acc[RG][kPerThread];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      m[r] = kMaskValue;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) acc[r][e] = 0.f;
    }
    for (int ta = start; ta < end; ta += kTileRows, ++g) {
      const int tb = min(end, ta + kTileRows);
      const uint8_t* stage = smem + (g % kStages) * Rg::kStage;
      ring_wait(full, g);
      if constexpr (Q8) {
        // Row j's slot: its run's slot base plus its stage row.
        const int* meta =
            reinterpret_cast<const int*>(stage + 2 * Rg::kRows + 2 * Rg::kScales * 4);
        int first[kRuns], slot0[kRuns];
#pragma unroll
        for (int k = 0; k < kRuns; ++k) {
          first[k] = meta[k];
          slot0[k] = meta[kRuns + k];
        }
        auto slot = [&](int j) {
          const int i = j - ta;
          int sl = slot0[0] + i;
#pragma unroll
          for (int k = 1; k < kRuns; ++k) sl = i >= first[k] ? slot0[k] + i : sl;
          return sl;
        };
        consume_tile<RG, Q8, kRuns, kMeta>(stage, ta, tb, g, empty, qv, m, l, acc, slot);
      } else {
        consume_tile<RG, Q8, kRuns, kMeta>(stage, ta, tb, g, empty, qv, m, l, acc,
                                           [](int) { return 0; });
      }
    }
    merge_workers<RG, Gr::kCount>(s + nb < splits ? merge_buf : reinterpret_cast<float*>(smem),
                                  m, l, acc, pm, pl, pa);
    if (splits > 1) store_partial<RG>(base + (int64_t)s * R * (kD + 2), pm, pl, pa);
  }
  // The last block of the lane and KV head folds the causal fresh block,
  // then the partials in split order.
  if (splits > 1 &&
      !take_ticket<Gr::kConsumers>(counters + (int64_t)b * Hkv + hk, splits, n_mine)) {
    return;
  }
  float vn[T], kw[T];  // kw: the K elements of the group's fresh rows, for the store
#pragma unroll
  for (int u = 0; u < T; ++u) {
    vn[u] = __bfloat162float(v_new[(fresh0 + u) * kD + d]);
    kw[u] = write && u % Gr::kCount == grp ? __bfloat162float(k_new[(fresh0 + u) * kD + d])
                                           : 0.f;
  }
  // Fresh score (r, u) of the group's row r: the four warps' sums in order.
  auto fresh_score = [&](int r, int u) {
    float sc = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sc += fresh_sums[r0 + r][u][w];
    return sc;
  };
  float M[RG], L[RG], A[RG];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    M[r] = kMaskValue;
#pragma unroll
    for (int u = 0; u < T; ++u) M[r] = u <= t_of(r) ? fmaxf(M[r], fresh_score(r, u)) : M[r];
  }
  fold_splits<RG, R>(base, splits, r0, pm, pl, pa, M, L, A,
                     [&](int r, float Mr, float& Lr, float& Ar) {
                       Lr = 0.f;
                       Ar = 0.f;
#pragma unroll
                       for (int u = 0; u < T; ++u) {
                         const float p = expf(fresh_score(r, u) - Mr);
                         const bool seen = u <= t_of(r);
                         Lr = seen ? Lr + p : Lr;
                         Ar = seen ? fmaf(p, vn[u], Ar) : Ar;
                       }
                     });
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    out[(lane_head + r0 + r) * kD + d] = __float2bfloat16(A[r] / L[r]);
  }
  if (write) {
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (u % Gr::kCount == grp) {
        store_fresh_row<Q8, T>(fresh, u, kw[u], vn[u], kpool, vpool, kscale, vscale);
      }
    }
  }
}

struct Args {
  const void* q;
  void* kpool;
  void* vpool;
  void* kscale;
  void* vscale;
  const void* k_new;
  const void* v_new;
  const void* table;
  const void* prompt_len;
  const void* decode_count;
  const void* write_pages;
  const void* write_offsets;
  void* ws;
  void* counters;
  void* out;
  int layer, B, Hkv, T, n_pages, PS, max_pages, splits;
  float scale;
  cudaStream_t stream;
};

template <int R, int T, bool Q8>
int launch(const Args& a) {
  using Rg = Ring<R, Q8, kRuns, kMeta>;
  constexpr int kThreadsAll = Groups<R>::kBlockThreads;
  auto kernel = paged_kernel<R, T, Q8>;
  // The ring, the merge buffer of blocks with more than one split, then
  // the lane's table row.
  const int table = ((a.max_pages + 3) & ~3) * 4;
  // Per device: the shared memory allowed, and the blocks an SM holds at
  // the last ring-and-table size asked there.
  static gemm::SmemAllowed allowed;
  static std::mutex occupancy_mu;
  static int occupancy_smem[gemm::kMaxDevices], per_sm_of[gemm::kMaxDevices];
  int device = 0, sms = 0, per_sm = 1;
  cudaError_t err = gemm::current_device(device);
  if (err == cudaSuccess) err = gemm::allow_smem(kernel, Rg::kBytes + table, allowed);
  if (err == cudaSuccess) {
    std::lock_guard<std::mutex> lock(occupancy_mu);
    if (Rg::kBytes + table != occupancy_smem[device]) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_of[device], kernel,
                                                          kThreadsAll, Rg::kBytes + table);
      per_sm_of[device] = max(per_sm_of[device], 1);
      if (err == cudaSuccess) occupancy_smem[device] = Rg::kBytes + table;
    }
    per_sm = per_sm_of[device];
  }
  // Blocks per (lane, KV head): every split its own block when they all fit
  // on the card at once, else as few splits to a block as make them fit.
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t units = (int64_t)a.B * a.Hkv * a.splits;
  const int64_t resident = (int64_t)per_sm * sms;
  const int per_block = (int)((units + resident - 1) / resident);
  const int nb = (a.splits + per_block - 1) / per_block;
  const int smem = Rg::kBytes + (nb < a.splits ? Rg::kMerge : 0) + table;
  err = gemm::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, a.Hkv, a.B);
  kernel<<<grid, kThreadsAll, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.kpool, a.vpool, static_cast<float*>(a.kscale),
      static_cast<float*>(a.vscale), static_cast<const __nv_bfloat16*>(a.k_new),
      static_cast<const __nv_bfloat16*>(a.v_new), static_cast<const int*>(a.table),
      static_cast<const int*>(a.prompt_len), static_cast<const int*>(a.decode_count),
      static_cast<const int*>(a.write_pages), static_cast<const int*>(a.write_offsets),
      static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), static_cast<__nv_bfloat16*>(a.out), a.layer, a.Hkv,
      a.n_pages, a.PS, a.max_pages, a.splits, a.scale);
  return (int)cudaGetLastError();
}

// The GQA group G and the fresh positions T, G * T <= kMaxRows.
template <int G, bool Q8>
int launch_group(const Args& a) {
  switch (a.T) {
#define PAGED_T(t)                                                   \
  case t:                                                            \
    if constexpr (G * t <= kMaxRows) return launch<G * t, t, Q8>(a); \
    else return (int)cudaErrorInvalidValue;
    PAGED_T(1) PAGED_T(2) PAGED_T(3) PAGED_T(4) PAGED_T(5) PAGED_T(6) PAGED_T(7) PAGED_T(8)
#undef PAGED_T
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool Q8>
int dispatch(const Args& a, int Hq) {
  if (a.B == 0) return (int)cudaSuccess;
  if (a.T < 1 || Hq % a.Hkv || Hq / a.Hkv * a.T > kMaxRows || a.splits < 1 ||
      a.max_pages < 1 || a.PS < kTileRows || (Q8 && a.PS % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (Hq / a.Hkv) {
    case 1: return launch_group<1, Q8>(a);
    case 2: return launch_group<2, Q8>(a);
    case 3: return launch_group<3, Q8>(a);
    case 4: return launch_group<4, Q8>(a);
    case 5: return launch_group<5, Q8>(a);
    case 6: return launch_group<6, Q8>(a);
    case 7: return launch_group<7, Q8>(a);
    case 8: return launch_group<8, Q8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes as in the header comment; write_pages and write_offsets (B, T)
// int32, both null for no store; ws is f32 (B, Hkv, splits, T * Hq / Hkv,
// 130), counters int32 (B * Hkv,), zero on entry and left zero.
// T * Hq / Hkv must be at most 8, PS at least 32; every pool pointer
// 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int decode_attention_paged_bf16(
    const void* q, void* kpool, void* vpool, const void* k_new, const void* v_new,
    const void* table, const void* prompt_len, const void* decode_count,
    const void* write_pages, const void* write_offsets, void* ws, void* counters, void* out,
    int layer, int B, int Hq, int Hkv, int T, int n_pages, int PS, int max_pages, int splits,
    float scale, void* stream) {
  if ((write_pages == nullptr) != (write_offsets == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, kpool, vpool, nullptr, nullptr, k_new, v_new, table, prompt_len,
               decode_count, write_pages, write_offsets, ws, counters, out, layer, B, Hkv, T,
               n_pages, PS, max_pages, splits, scale, (cudaStream_t)stream};
  return dispatch<false>(a, Hq);
}

// The int8 pool: kpool/vpool int8 (L, n_pages, Hkv, PS, 128), kscale/vscale
// f32 (L, n_pages, Hkv, PS) with PS % 4 == 0; everything else as
// decode_attention_paged_bf16.
extern "C" int decode_attention_paged_q8(
    const void* q, void* kpool, void* vpool, void* kscale, void* vscale, const void* k_new,
    const void* v_new, const void* table, const void* prompt_len, const void* decode_count,
    const void* write_pages, const void* write_offsets, void* ws, void* counters, void* out,
    int layer, int B, int Hq, int Hkv, int T, int n_pages, int PS, int max_pages, int splits,
    float scale, void* stream) {
  if ((write_pages == nullptr) != (write_offsets == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, kpool, vpool, kscale, vscale, k_new, v_new, table, prompt_len,
               decode_count, write_pages, write_offsets, ws, counters, out, layer, B, Hkv, T,
               n_pages, PS, max_pages, splits, scale, (cudaStream_t)stream};
  return dispatch<true>(a, Hq);
}
