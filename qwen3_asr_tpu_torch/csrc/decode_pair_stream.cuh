// The persistent (lane, KV head) stream of one-token decode attention over
// the layer-stacked cache: K11a (decode_attention_hbm2.cu), K11b
// (decode_attention_hbm3.cu), K11c (decode_attention_hbm5.cu) and K11d
// (decode_attention_sched.cu) each launch a kernel of their own that runs
// run_stream below.
//
// Function.  q (B, Hq, 128); kall/vall (L, B, Hkv, S, 128); k_new/v_new (B,
// Hkv, 1, 128), all bf16.  Cache row s of lane b is valid when s < plen[b]
// or pb <= s < dend[b], and the fresh row is folded in as a self-term.  Each
// entry point says where a pair finds its lane's geometry (the stream's
// kLane and ends arguments, span_of below):
//   * one decode end for every lane (K11a and K11b: ends points at one
//     int32 in device memory, which each block reads once, before its
//     producer warp plans a tile, and clamps to [pb, S], as the TPU kernels
//     read theirs by scalar prefetch), prompt lengths (Args::prompt_len)
//     and Args::pb: prompt lengths clamped to [0, pb], so a lane with
//     prompt_len 0 and dend == pb has no valid row and yields v_new;
//   * per-lane ends (kLane, ends the (B,) decode ends; K11c), each clamped
//     to [pb, S], and prompt lengths clamped to [1, pb], as the TPU kernel
//     clamps them so that every lane owns a block: an idle lane attends row
//     0 and its fresh row;
//   * per-lane runs (kLane, ends a table of LaneRuns; K11d): each lane's
//     plen, pb and dend as K11d reads them from its block schedule
//     (decode_attention_sched.cu).
//
// Numerics follow the TPU kernels, not K2 (decode_attention_hbm2.py :160,
// :65, :79-126), and every tile's arithmetic is that of the port's cp.async
// kernels of commit f0ebdf1 (decode_stream.cuh's fold_tile and finish_pair
// there), operation for operation, so that the output is bit-identical to
// theirs: 32-row tiles; q * scale rounded to bf16; the score of a row as 16
// fmaf chains of 8 elements summed by the xor tree 8, 4, 2, 1, masked to
// -0.7 * FLT_MAX (selected, not added: a masked row may hold inf); the
// tile's max, exponentials and the xor-tree sum 16 .. 1 over its 32 rows; p
// rounded to bf16 before P.V, one fmaf chain over the tile's rows in order
// per output element; then l = alpha l + sum and acc = acc alpha + pv, tile
// after tile; the self-term score the bf16-rounded products q * k_new,
// reduced over four groups of 32 elements by the xor tree 16 .. 1 and the
// four sums added in order from 0, in f32; l == 0 -> 1; the output rounded
// once to bf16.  The folds are written as the fused products that commit's
// compiler formed from their a * b + c (for the self-term's acc alpha +
// p_self vn: p_self vn fused, acc alpha rounded), so that the bits do not
// hang on which product a compiler chooses to fuse.
//
// Schedule (the card's, not the TPU grid's):
//   * the grid is up to one block per SM, and each block owns a contiguous
//     range of pairs (pair = b Hkv + hk): `per` pairs each (the wrappers'
//     stream_grid; per-lane launches pass 1), or, for per-lane geometry
//     with more pairs than blocks, a range balanced by tiles (block_range
//     below);
//   * a producer warp streams the block's tiles, across pair boundaries, by
//     1-D bulk copies (a tile's 32 K rows and 32 V rows are contiguous) into
//     a kStages-deep mbarrier ring (decode_split.cuh's ring protocol);
//   * eight consumer warps take the tiles in turn, warp w tiles w, w + 8,
//     ...: each computes its tile's scores, exponentials and P.V alone, on
//     warp shuffles, with no block-wide barrier.  Only the online softmax's
//     running values pass from tile to tile: the running max m through a
//     hand-off (mbarriers m_bar) right after the tile's scores, and (l, acc)
//     through another (a_bar) after its P.V, so that a pair's tiles overlap
//     in everything but those two folds;
//   * whole tiles whose rows are all masked are not read: each pair walks
//     cdiv(plen, 32) prompt tiles from row 0 and cdiv(dend - pb, 32) decode
//     tiles from row pb, its own lane's geometry.  The first visited tile
//     holds a valid row, so m is finite from then on; a skipped tile's
//     scores would all be the mask value, weigh expf(mask - m) = 0 and leave
//     l, acc and m as they were, so skipping leaves the output bit for bit
//     that of a walk over whole blocks (the TPU's block_k / block_p, which
//     then decide nothing but the input check), over a group's largest
//     geometry (K11c's TPU walk) or over every tile of a schedule's 128-row
//     entries (K11d's).
//
// Bound on the H100: bytes (one FMA per element read for each of the G
// heads).  A tile is 16 KB; the ring keeps up to kStages of them in flight
// per SM, enough to cover HBM latency at every batch.
#pragma once

#include "decode_split.cuh"
#include "decode_stream.cuh"
#include "gemm_tiles.cuh"

namespace pstream {

using dstream::Args;
using dstream::bf16_round;
using dstream::kMaskValue;

constexpr int kD = 128;
constexpr int kTile = dstream::kTile;               // 32 rows
constexpr int kWarps = 8;                           // consumer warps
constexpr int kStages = 12;                         // ring depth
constexpr int kBlockThreads = (kWarps + 1) * 32;    // + the producer warp
constexpr int kTileBytes = kTile * kD * 2;          // 32 K (or V) rows, 8 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kRingBytes = kStages * kStageBytes;

// The shapes a scalar-end launch takes: head_dim 128 (checked by the
// wrapper), block_k a positive multiple of the 32-row tile dividing S and pb.
inline bool valid_tiling(int S, int pb, int block_k) {
  return block_k > 0 && block_k % kTile == 0 && S % block_k == 0 &&
         pb % block_k == 0 && pb <= S;
}

// One pair's visited tiles: n_prompt from row 0, then decode tiles from pb,
// n in all; the lane's clamped prompt length and decode end.
struct Span {
  int b, hk, plen, dend, n_prompt, n;
};

// A lane's geometry as K11d reads it from its block schedule
// (decode_attention_sched.cu): prompt rows [0, plen), decode rows [pb,
// dend), each already clamped.
struct LaneRuns {
  int plen, pb, dend;
};

// ends: the (B,) per-lane decode ends when kLane, else the block's one
// decode end, already clamped (run_stream's copy in shared memory).
template <bool kLane>
__device__ __forceinline__ Span span_of(const Args& a, const int* ends, int pair) {
  Span s;
  s.b = pair / a.Hkv;
  s.hk = pair - s.b * a.Hkv;
  s.plen = min(max(a.prompt_len[s.b], kLane ? 1 : 0), a.pb);
  s.dend = kLane ? min(max(ends[s.b], a.pb), a.S) : ends[0];
  s.n_prompt = (s.plen + kTile - 1) / kTile;
  s.n = s.n_prompt + (s.dend - a.pb + kTile - 1) / kTile;
  return s;
}

// runs: the block's table of every lane's runs (kLane).
template <bool kLane>
__device__ __forceinline__ Span span_of(const Args& a, const LaneRuns* runs, int pair) {
  Span s;
  s.b = pair / a.Hkv;
  s.hk = pair - s.b * a.Hkv;
  const LaneRuns r = runs[s.b];
  s.plen = r.plen;
  s.dend = r.dend;
  s.n_prompt = (s.plen + kTile - 1) / kTile;
  s.n = s.n_prompt + (s.dend - r.pb + kTile - 1) / kTile;
  return s;
}

// The first decode row of a pair's lane: the launch's, or its own run's.
__device__ __forceinline__ int pb_of(const Args& a, const int*, const Span&) { return a.pb; }
__device__ __forceinline__ int pb_of(const Args&, const LaneRuns* runs, const Span& s) {
  return runs[s.b].pb;
}

template <typename Ends>
__device__ __forceinline__ int row0_of(const Args& a, Ends ends, const Span& s, int t) {
  return t < s.n_prompt ? t * kTile : pb_of(a, ends, s) + (t - s.n_prompt) * kTile;
}

// Tile t of pair `pair` of the block's stream [.., end).
template <bool kLane, typename Ends>
struct Cursor {
  int pair, t;
  Span s;
  __device__ Cursor(const Args& a, Ends ends, int begin, int end, int skip)
      : pair(begin), t(0) {
    if (pair < end) s = span_of<kLane>(a, ends, pair);
    advance(a, ends, end, skip);
  }
  __device__ void advance(const Args& a, Ends ends, int end, int n) {
    t += n;
    while (pair < end && t >= s.n) {
      t -= s.n;
      if (++pair < end) s = span_of<kLane>(a, ends, pair);
    }
  }
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pairs (b, hk), hk < Hkv, whose first tile's index in the stream, first + hk
// t, times nblk lies below thr.
__device__ __forceinline__ int pairs_below(int64_t first, int t, int Hkv, int nblk,
                                           int64_t thr) {
  const int64_t r = thr - first * nblk;
  if (r <= 0) return 0;
  if (t == 0) return Hkv;
  const int64_t step = (int64_t)t * nblk;
  return (int)min((int64_t)Hkv, (r + step - 1) / step);
}

// The tile-balanced range [begin, end) of block blk of nblk (per-lane ends
// or runs):
// the stream's T tiles, pairs in order, cut into nblk equal shares, and the
// block takes the pairs whose first tile lies in its share, [blk T / nblk,
// (blk + 1) T / nblk).  Pairs stay whole and in order, so a block's tiles are
// at most its share plus one pair's.  One warp: the lanes' tile counts are
// summed, then scanned 32 lanes at a time.
template <typename Ends>
__device__ __forceinline__ int2 block_range(const Args& a, Ends ends, int blk, int nblk) {
  const int lane = threadIdx.x % 32;
  int total = 0;
  for (int b = lane; b < a.B; b += 32) total += span_of<true>(a, ends, b * a.Hkv).n;
  const int64_t T = (int64_t)warp_sum(total) * a.Hkv;
  const int64_t lo = blk * T, hi = lo + T;
  int64_t before = 0;   // tiles of one pair of every lane before the chunk
  int n_lo = 0, n_hi = 0;
  for (int b0 = 0; b0 < a.B; b0 += 32) {
    const int b = b0 + lane;
    const int t = b < a.B ? span_of<true>(a, ends, b * a.Hkv).n : 0;
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (b < a.B) {
      const int64_t first = (before + incl - t) * a.Hkv;
      n_lo += pairs_below(first, t, a.Hkv, nblk, lo);
      n_hi += pairs_below(first, t, a.Hkv, nblk, hi);
    }
    before += __shfl_sync(0xffffffffu, incl, 31);
  }
  n_lo = warp_sum(n_lo);
  n_hi = warp_sum(n_hi);
  return make_int2(n_lo, blk == nblk - 1 ? a.B * a.Hkv : n_hi);
}

__device__ __forceinline__ void unpack4(const uint2& raw, float (&out)[4]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The pair's G output rows from its running state (m, l, and acc of the
// lane's elements 4 lane .. 4 lane + 3): the self-term q . k_new, reduced as
// in the header's numerics (four groups of 32 elements, each by the xor
// tree, then summed in order from group 0), folded in, then 1 / l.  One
// warp.
template <int G>
__device__ __forceinline__ void finish(const Args& a, const Span& s, const float (&m)[G],
                                       const float (&l)[G], const float (&acc)[G][4]) {
  const int lane = threadIdx.x % 32;
  const int Hq = a.Hkv * G;
  const int64_t kv = ((int64_t)s.b * a.Hkv + s.hk) * kD;
  const __nv_bfloat16* qrow = a.q + ((int64_t)s.b * Hq + s.hk * G) * kD;
  float vn[4];
  unpack4(*reinterpret_cast<const uint2*>(a.v_new + kv + 4 * lane), vn);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float red[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int d = 32 * w + lane;
      const float qd = bf16_round(__bfloat162float(qrow[gi * kD + d]) * a.scale);
      float part = bf16_round(qd * __bfloat162float(a.k_new[kv + d]));
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      red[w] = part;
    }
    float s_self = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s_self += red[w];
    const float m_next = fmaxf(m[gi], s_self);
    const float alpha = expf(m[gi] - m_next);
    const float p_self = expf(s_self - m_next);
    float lt = fmaf(alpha, l[gi], p_self);
    if (lt == 0.f) lt = 1.f;
    __align__(8) __nv_bfloat16 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float at = fmaf(p_self, vn[e], __fmul_rn(acc[gi][e], alpha));
      o[e] = __float2bfloat16(at / lt);
    }
    *reinterpret_cast<uint2*>(a.out + ((int64_t)s.b * Hq + s.hk * G + gi) * kD + 4 * lane) =
        *reinterpret_cast<const uint2*>(o);
  }
}

// The body of each entry point's kernel (kBlockThreads threads, kRingBytes
// of dynamic shared memory).  Block blockIdx.x streams pairs [blockIdx.x
// per, + per), or, with per-lane ends or runs and more pairs than blocks,
// its block_range.  Without kLane, ends points at the launch's one decode
// end in device memory: thread 0 reads it once and every thread then reads
// the block's clamped copy, so a captured launch takes the end that its
// replay finds there.
template <int G, bool kLane, typename Ends>
__device__ __forceinline__ void run_stream(const Args& a, Ends ends, int per) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[kStages], empty[kStages];
  // The tile-to-tile hand-offs: slot j % 2 holds tile j's values; m_bar[j %
  // kWarps] and a_bar[j % kWarps] complete a phase when tile j has stored
  // them.  Tiles arrive in order (each after the one before), and the warp of
  // tile j arrived for tile j - kWarps before it waits for tile j - 1, so a
  // waiter finds its barrier at most one phase short: kWarps barriers keep
  // the parity wait exact.  Two data slots suffice: tile j overwrites tile
  // j - 2's only after tile j - 1, its last reader, has arrived.
  __shared__ uint64_t m_bar[kWarps], a_bar[kWarps];
  __shared__ float m_slot[2][G], l_slot[2][G];
  __shared__ __align__(16) float acc_slot[2][G][kD];
  __shared__ int2 range;
  __shared__ int end_s;   // the one decode end, clamped (without kLane)

  const int pairs = a.B * a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % dstream::kRowThreads;
  int begin = min((int)blockIdx.x * per, pairs);
  int end = min(begin + per, pairs);
  const bool balanced = kLane && pairs > (int)gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
      hopper::mbar_init(&m_bar[i], 1);
      hopper::mbar_init(&a_bar[i], 1);
    }
    decode_split::ring_init<kStages>(full, empty, 1);
    if constexpr (!kLane) end_s = min(max(*ends, a.pb), a.S);
  }
  if constexpr (kLane) {
    if (balanced && warp == kWarps) {
      const int2 r = block_range(a, ends, blockIdx.x, gridDim.x);
      if (lane == 0) range = r;
    }
  }
  __syncthreads();
  if constexpr (kLane) {
    if (balanced) {
      begin = range.x;
      end = range.y;
    }
  } else {
    ends = &end_s;
  }

  if (warp == kWarps) {
    if (lane == 0) {
      Cursor<kLane, Ends> c(a, ends, begin, end, 0);
      for (int j = 0; c.pair < end; ++j, c.advance(a, ends, end, 1)) {
        decode_split::ring_reserve<kStages>(empty, j);
        uint8_t* stage = ring + (j % kStages) * kStageBytes;
        const int64_t row0 =
            (((int64_t)a.layer * a.B + c.s.b) * a.Hkv + c.s.hk) * a.S + row0_of(a, ends, c.s, c.t);
        hopper::mbar_arrive_expect_tx(&full[j % kStages], kStageBytes);
        hopper::bulk_load(stage, a.kall + row0 * kD, kTileBytes, &full[j % kStages]);
        hopper::bulk_load(stage + kTileBytes, a.vall + row0 * kD, kTileBytes,
                          &full[j % kStages]);
      }
    }
    return;
  }

  // Pairs with no tile (prompt_len 0, decode_end == pb): the self-term alone.
  for (int pi = begin + warp; pi < end; pi += kWarps) {
    const Span s = span_of<kLane>(a, ends, pi);
    if (s.n == 0) {
      float m[G], l[G], acc[G][4];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        m[gi] = -INFINITY;
        l[gi] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][e] = 0.f;
      }
      finish<G>(a, s, m, l, acc);
    }
  }

  float qf[G][dstream::kPerThread];   // bf16(q * scale), elements sub * 8 .. + 7
  int q_pair = -1;
  Cursor<kLane, Ends> c(a, ends, begin, end, warp);
  for (int j = warp; c.pair < end; j += kWarps, c.advance(a, ends, end, kWarps)) {
    const Span& s = c.s;
    if (c.pair != q_pair) {
      q_pair = c.pair;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            a.q + ((int64_t)s.b * a.Hkv * G + s.hk * G + gi) * kD + sub * dstream::kPerThread);
        dstream::unpack8(raw, qf[gi]);
#pragma unroll
        for (int e = 0; e < dstream::kPerThread; ++e) qf[gi][e] = bf16_round(qf[gi][e] * a.scale);
      }
    }
    const bool first = c.t == 0;
    const bool last = c.t == s.n - 1;
    const int row0 = row0_of(a, ends, s, c.t);
    const uint8_t* kb = ring + (j % kStages) * kStageBytes;
    const uint8_t* vb = kb + kTileBytes;
    decode_split::ring_wait<kStages>(full, j);

    // Scores: half-warp h takes row 2 i + h, thread sub elements sub * 8 ..;
    // lane r keeps row r's score.
    float sc[G] = {};
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int r = 2 * i + lane / 16;
      float kf[dstream::kPerThread];
      dstream::unpack8(*reinterpret_cast<const uint4*>(kb + r * kD * 2 + sub * 16), kf);
      const int row = row0 + r;
      const bool ok =
          row < s.plen || (row >= pb_of(a, ends, s) && row < s.dend);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < dstream::kPerThread; ++e) part = fmaf(qf[gi][e], kf[e], part);
#pragma unroll
        for (int o = dstream::kRowThreads / 2; o >= 1; o >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, o);
        }
        const float got = __shfl_sync(0xffffffffu, ok ? part : kMaskValue, (lane & 1) * 16);
        if (lane / 2 == i) sc[gi] = got;
      }
    }

    // The running max: tile j - 1's, then this tile's.
    float mx[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      mx[gi] = sc[gi];
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(0xffffffffu, mx[gi], o));
    }
    if (j > 0) hopper::mbar_wait(&m_bar[(j - 1) % kWarps], ((j - 1) / kWarps) & 1);
    float m_prev[G], m_next[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      m_prev[gi] = first ? -INFINITY : m_slot[(j - 1) & 1][gi];
      m_next[gi] = fmaxf(m_prev[gi], mx[gi]);
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) m_slot[j & 1][gi] = m_next[gi];
      hopper::mbar_arrive(&m_bar[j % kWarps]);
    }

    // Exponentials (lane r: row r), the tile's sum, then P.V (lane: output
    // elements 4 lane .. 4 lane + 3, rows in order).
    float alpha[G], p[G], sum[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      alpha[gi] = expf(m_prev[gi] - m_next[gi]);
      const float pr = expf(sc[gi] - m_next[gi]);
      p[gi] = bf16_round(pr);
      sum[gi] = pr;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sum[gi] += __shfl_xor_sync(0xffffffffu, sum[gi], o);
    }
    float pv[G][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[gi][e] = 0.f;
    }
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      float v[4];
      unpack4(*reinterpret_cast<const uint2*>(vb + r * kD * 2 + lane * 8), v);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float pr = __shfl_sync(0xffffffffu, p[gi], r);
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[gi][e] = fmaf(pr, v[e], pv[gi][e]);
      }
    }
    decode_split::ring_release<kStages>(empty, j);

    // The running (l, acc): tile j - 1's, then this tile's.
    if (j > 0) hopper::mbar_wait(&a_bar[(j - 1) % kWarps], ((j - 1) / kWarps) & 1);
    float l[G], acc[G][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float lp = first ? 0.f : l_slot[(j - 1) & 1][gi];
      l[gi] = fmaf(alpha[gi], lp, sum[gi]);
      float ap[4] = {0.f, 0.f, 0.f, 0.f};
      if (!first) {
        const float4 prev = *reinterpret_cast<const float4*>(&acc_slot[(j - 1) & 1][gi][4 * lane]);
        ap[0] = prev.x;
        ap[1] = prev.y;
        ap[2] = prev.z;
        ap[3] = prev.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][e] = fmaf(ap[e], alpha[gi], pv[gi][e]);
      if (!last) {
        *reinterpret_cast<float4*>(&acc_slot[j & 1][gi][4 * lane]) =
            make_float4(acc[gi][0], acc[gi][1], acc[gi][2], acc[gi][3]);
        if (lane == 0) l_slot[j & 1][gi] = l[gi];
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&a_bar[j % kWarps]);
    if (last) finish<G>(a, s, m_next, l, acc);
  }
}

// Launch `kernel` (one of run_stream's entry kernels) on `grid` blocks,
// allowing it kRingBytes of shared memory once per device (`smem`).
template <typename Kernel, typename... KArgs>
int launch(Kernel kernel, gemm::SmemAllowed& smem, int grid, cudaStream_t stream,
           KArgs... args) {
  const cudaError_t err = gemm::allow_smem(kernel, kRingBytes, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kBlockThreads, kRingBytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pstream
