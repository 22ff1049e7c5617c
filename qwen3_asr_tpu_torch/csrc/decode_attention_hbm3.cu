// K11b: one-token decode attention as a persistent (lane, KV head) stream.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:
// decode_attention_hbm3 (:181; kernel _kernel :28, pallas_call :253).
// Function, arguments, tiling rule and numerics: decode_stream.cuh (K11a's),
// whose per-tile arithmetic this kernel repeats operation for operation, so
// that its output is bit-identical to the cp.async version's (fold_tile):
// the same 32-row tiles, the score of a row as 16 fmaf chains of 8 elements
// summed by the xor tree 8, 4, 2, 1; the tile's max, exponentials and the
// xor-tree sum 16 .. 1 over its 32 rows; P.V as one fmaf chain over the
// tile's rows in order per output element; then l = alpha l + sum and
// acc = acc alpha + pv, tile after tile.  The folds are written as the
// fused products the cp.async version's compiler formed from its a * b + c
// (for the self-term's acc alpha + p_self vn: p_self vn fused, acc alpha
// rounded), so that the bits do not hang on this file's compiler choosing
// the same.
//
// The TPU kernel's grid is its two TensorCores, each walking half the batch
// as one stream of (lane, block) pairs, because a TPU grid cell has a fixed
// cost.  The card has no such cost and 132 SMs, so the schedule here is the
// card's:
//   * the grid is up to one block per SM; block i owns the contiguous pairs
//     [i per, (i + 1) per), per = cdiv(B Hkv, blocks) (the wrapper's
//     stream_grid), so at B = 8 every one of the 64 pairs has an SM;
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
//     cdiv(prompt_len, 32) prompt tiles from row 0 and cdiv(decode_end - pb,
//     32) decode tiles from row pb.  The first visited tile holds a valid
//     row, so m is finite from then on; a skipped tile's scores would all be
//     the mask value, weigh expf(mask - m) = 0 and leave l, acc and m as
//     they were, so skipping leaves the output bit for bit the same.
//     (block_k, which the TPU walk rounds each interval up to, then decides
//     nothing but the input check.)
//
// Bound on the H100: bytes (one FMA per element read for each of the G
// heads).  A tile is 16 KB; the ring keeps up to kStages of them in flight
// per SM, enough to cover HBM latency at every batch.
#include "decode_split.cuh"
#include "decode_stream.cuh"

namespace {

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

// One pair's visited tiles: n_prompt from row 0, then decode tiles from pb.
struct Span {
  int b, hk, plen, n_prompt, n;
};

__device__ __forceinline__ Span span_of(const Args& a, int pair) {
  Span s;
  s.b = pair / a.Hkv;
  s.hk = pair - s.b * a.Hkv;
  s.plen = min(max(a.prompt_len[s.b], 0), a.pb);
  s.n_prompt = (s.plen + kTile - 1) / kTile;
  s.n = s.n_prompt + (a.dend - a.pb + kTile - 1) / kTile;
  return s;
}

__device__ __forceinline__ int row0_of(const Args& a, const Span& s, int t) {
  return t < s.n_prompt ? t * kTile : a.pb + (t - s.n_prompt) * kTile;
}

// Tile t of pair `pair` of the block's stream [.., end).
struct Cursor {
  int pair, t;
  Span s;
  __device__ Cursor(const Args& a, int begin, int end, int skip) : pair(begin), t(0) {
    if (pair < end) s = span_of(a, pair);
    advance(a, end, skip);
  }
  __device__ void advance(const Args& a, int end, int n) {
    t += n;
    while (pair < end && t >= s.n) {
      t -= s.n;
      if (++pair < end) s = span_of(a, pair);
    }
  }
};

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
// decode_stream.cuh's finish_pair reduces it (four warps of 32 elements,
// each by the xor tree, then summed in warp order from 0), folded in, then
// 1 / l.  One warp.
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

template <int G>
__global__ void __launch_bounds__(kBlockThreads) decode_hbm3_kernel(Args a, int per) {
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

  const int pairs = a.B * a.Hkv;
  const int begin = min((int)blockIdx.x * per, pairs);
  const int end = min(begin + per, pairs);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % dstream::kRowThreads;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
      hopper::mbar_init(&m_bar[i], 1);
      hopper::mbar_init(&a_bar[i], 1);
    }
    decode_split::ring_init<kStages>(full, empty, 1);
  }
  __syncthreads();

  if (warp == kWarps) {
    if (lane == 0) {
      Cursor c(a, begin, end, 0);
      for (int j = 0; c.pair < end; ++j, c.advance(a, end, 1)) {
        decode_split::ring_reserve<kStages>(empty, j);
        uint8_t* stage = ring + (j % kStages) * kStageBytes;
        const int64_t row0 =
            (((int64_t)a.layer * a.B + c.s.b) * a.Hkv + c.s.hk) * a.S + row0_of(a, c.s, c.t);
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
    const Span s = span_of(a, pi);
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
  Cursor c(a, begin, end, warp);
  for (int j = warp; c.pair < end; j += kWarps, c.advance(a, end, kWarps)) {
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
    const int row0 = row0_of(a, s, c.t);
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
      const bool ok = row < s.plen || (row >= a.pb && row < a.dend);
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

template <int G>
int launch(const Args& a, int per, cudaStream_t stream) {
  static bool smem_ok = false;
  const cudaError_t err = gemm::allow_smem(decode_hbm3_kernel<G>, kRingBytes, smem_ok);
  if (err != cudaSuccess) return (int)err;
  const int pairs = a.B * a.Hkv;
  const int grid = (pairs + per - 1) / per;
  decode_hbm3_kernel<G><<<grid, kBlockThreads, kRingBytes, stream>>>(a, per);
  return (int)cudaGetLastError();
}

}  // namespace

// As decode_attention_hbm2_bf16, plus per >= 1: the (lane, KV head) pairs
// each block streams (the wrapper's stream_grid: cdiv(B Hkv, min(B Hkv,
// SM count))).
extern "C" int decode_attention_hbm3_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* prompt_len, void* out, int layer, int B,
    int Hq, int Hkv, int S, int pb, int decode_end, int block_k, int per,
    float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || per < 1 || !dstream::valid_tiling(S, pb, block_k)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = dstream::make_args(q, kall, vall, k_new, v_new, prompt_len, out, layer, B,
                                    Hkv, S, pb, decode_end, block_k, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, per, st);
    case 2: return launch<2>(a, per, st);
    case 4: return launch<4>(a, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
