// The cp.async per-tile pieces of K11d (decode_attention_sched.cu), which
// walks the cache on a precomputed block schedule: load_rows, start_pair,
// fold_tile (a 32-row tile's online-softmax update under a caller-given row
// mask) and finish_pair (self-term and 1 / l).  The persistent stream of
// K11a-K11c (decode_pair_stream.cuh) repeats fold_tile's and finish_pair's
// arithmetic operation for operation and shares Args, make_args and the
// element helpers.
//
// q (B, Hq, 128); kall/vall (L, B, Hkv, S, 128); k_new/v_new (B, Hkv, 1, 128),
// all bf16.  One CUDA block of 4 warps folds one (lane, KV head) pair at a
// time and keeps its state in registers and shared memory; the caller's
// kernel picks the tiles, their masks and how deep its cp.async ring is.
//
// Numerics follow the TPU kernels, not K2 (decode_attention_hbm2.py
// :160, :65, :79-126):
//   * q * scale is formed in f32 and rounded to bf16;
//   * scores are bf16 q . bf16 k with f32 accumulation (exact f32
//     products), masked to -0.7 * FLT_MAX;
//   * the online softmax runs in f32 from m = -inf; l sums the f32 p, and p
//     is rounded to bf16 before P.V (f32 accumulation);
//   * the self-term score is the bf16-rounded elementwise product q * k_new
//     summed in f32; l == 0 -> 1; the output is rounded once to bf16.
// The caller's first tile of a pair must hold a valid row, so that m is
// finite from then on and masked rows weigh exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tiles.cuh"

namespace dstream {

constexpr int kD = 128;
constexpr int kThreads = 128;                  // 4 warps; group size <= 4
constexpr int kTile = 32;                      // cache rows per ring stage
constexpr int kRowThreads = 16;                // threads per row, score pass
constexpr int kRowsInFlight = kThreads / kRowThreads;
constexpr int kPerThread = kD / kRowThreads;   // 8 elements, 16 bytes
constexpr int kTileElems = kTile * kD;         // one K or V tile (8 KB)
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* kall;
  const __nv_bfloat16* vall;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  const int* prompt_len;
  __nv_bfloat16* out;
  int layer, B, Hkv, S, pb, dend;
  float scale;
};

// Dynamic shared memory of an NBUF-stage ring: K and V tiles per stage.
constexpr int ring_bytes(int nbuf) { return nbuf * 2 * kTileElems * 2; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One (lane, KV head) pair.
struct Pair {
  int b, hk;
};

// Start the cp.async copies of cache rows [row0, row0 + 32) of lane b, KV
// head hk (32 contiguous K rows and the matching V rows: 1024 16-byte
// chunks, 8 per thread); rows at or past S, a negative row0 and a lane
// outside [0, B) are zero-filled instead of read.
__device__ __forceinline__ void load_rows(const Args& a, int b, int hk, int row0,
                                          __nv_bfloat16* kbuf,
                                          __nv_bfloat16* vbuf) {
  const bool lane_ok = b >= 0 && b < a.B && row0 >= 0;
  const int64_t base =
      ((((int64_t)a.layer * a.B + b) * a.Hkv + hk) * a.S + row0) * kD;
  for (int c = threadIdx.x; c < kTileElems / 8; c += kThreads) {
    const bool ok = lane_ok && row0 + c / (kD / 8) < a.S;
    const int64_t off = ok ? base + c * 8 : 0;
    gemm::cp_async16(kbuf + c * 8, a.kall + off, ok);
    gemm::cp_async16(vbuf + c * 8, a.vall + off, ok);
  }
}

template <int G>
struct State {
  float qf[G][kPerThread];   // bf16(q * scale), elements sub * 8 .. + 7
  float acc[G];              // P.V accumulator of element d = threadIdx.x
  float m, l;                // softmax state of head warp (warps < G)
};

template <int G>
struct Shared {
  float s[G][kTile];         // masked scores of the tile
  float p[G][kTile];         // bf16-rounded probabilities
  float alpha[G];
  float m[G], l[G];
  float red[G][kThreads / 32];
};

template <int G>
__device__ __forceinline__ void start_pair(const Args& a, const Pair& p,
                                           State<G>& st) {
  const int sub = threadIdx.x % kRowThreads;
  const int Hq = a.Hkv * G;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        a.q + ((int64_t)p.b * Hq + p.hk * G + gi) * kD + sub * kPerThread);
    unpack8(raw, st.qf[gi]);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) st.qf[gi][e] = bf16_round(st.qf[gi][e] * a.scale);
    st.acc[gi] = 0.f;
  }
  st.m = -INFINITY;
  st.l = 0.f;
}

// Fold one 32-row tile (kbuf, vbuf in shared memory; cache rows row0 ..
// row0 + 31) into a pair's state; valid(row) says which rows count, the
// others score kMaskValue (selected, not added: a masked row may hold inf).
// Every thread of the block calls it (it synchronizes).
template <int G, typename Valid>
__device__ __forceinline__ void fold_tile(int row0, Valid valid,
                                          const __nv_bfloat16* kbuf,
                                          const __nv_bfloat16* vbuf,
                                          State<G>& st, Shared<G>& sh) {
  const int tid = threadIdx.x;
  const int sub = tid % kRowThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Scores: 16 threads per row, 8 rows at a time.
  for (int r = tid / kRowThreads; r < kTile; r += kRowsInFlight) {
    float kf[kPerThread];
    unpack8(*reinterpret_cast<const uint4*>(kbuf + r * kD + sub * kPerThread), kf);
    const bool ok = valid(row0 + r);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) part = fmaf(st.qf[gi][e], kf[e], part);
#pragma unroll
      for (int o = kRowThreads / 2; o >= 1; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (sub == 0) sh.s[gi][r] = ok ? part : kMaskValue;
    }
  }
  __syncthreads();

  // Online softmax: warp gi takes head gi, one row per lane.
  if (warp < G) {
    const float s = sh.s[warp][lane];
    float mx = s;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_next = fmaxf(st.m, mx);
    const float alpha = expf(st.m - m_next);
    const float pr = expf(s - m_next);
    sh.p[warp][lane] = bf16_round(pr);
    float sum = pr;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    st.l = alpha * st.l + sum;
    st.m = m_next;
    if (lane == 0) sh.alpha[warp] = alpha;
  }
  __syncthreads();

  // P.V: thread d accumulates element d of every head of the group.
  float pv[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) pv[gi] = 0.f;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    const float v = __bfloat162float(vbuf[r * kD + tid]);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) pv[gi] = fmaf(sh.p[gi][r], v, pv[gi]);
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) st.acc[gi] = st.acc[gi] * sh.alpha[gi] + pv[gi];
}

// Self-term and 1 / l: write the pair's G output rows.
template <int G>
__device__ __forceinline__ void finish_pair(const Args& a, const Pair& p,
                                            State<G>& st, Shared<G>& sh) {
  const int d = threadIdx.x;
  const int warp = d / 32;
  const int lane = d % 32;
  const int Hq = a.Hkv * G;
  const int64_t kv = ((int64_t)p.b * a.Hkv + p.hk) * kD + d;
  const float kn = __bfloat162float(a.k_new[kv]);
  const float vn = __bfloat162float(a.v_new[kv]);
  float qd[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    qd[gi] = bf16_round(
        __bfloat162float(a.q[((int64_t)p.b * Hq + p.hk * G + gi) * kD + d]) * a.scale);
    float part = bf16_round(qd[gi] * kn);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) sh.red[gi][warp] = part;
  }
  if (warp < G && lane == 0) {
    sh.m[warp] = st.m;
    sh.l[warp] = st.l;
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float s_self = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s_self += sh.red[gi][w];
    const float m = sh.m[gi];
    const float m_next = fmaxf(m, s_self);
    const float alpha = expf(m - m_next);
    const float p_self = expf(s_self - m_next);
    float l = alpha * sh.l[gi] + p_self;
    const float acc = st.acc[gi] * alpha + p_self * vn;
    if (l == 0.f) l = 1.f;
    a.out[((int64_t)p.b * Hq + p.hk * G + gi) * kD + d] = __float2bfloat16(acc / l);
  }
  __syncthreads();   // sh.red / sh.m / sh.l are reused by the next pair
}

// Clamp the launch arguments as K2 does (prompt rows inside the prompt
// bucket, the decode end inside [pb, S]).
inline Args make_args(const void* q, const void* kall, const void* vall,
                      const void* k_new, const void* v_new,
                      const void* prompt_len, void* out, int layer, int B,
                      int Hkv, int S, int pb, int dend, float scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kall = static_cast<const __nv_bfloat16*>(kall);
  a.vall = static_cast<const __nv_bfloat16*>(vall);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.prompt_len = static_cast<const int*>(prompt_len);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer;
  a.B = B;
  a.Hkv = Hkv;
  a.S = S;
  a.pb = pb;
  a.dend = dend < pb ? pb : (dend > S ? S : dend);
  a.scale = scale;
  return a;
}

}  // namespace dstream
