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
// (query position t sees fresh column u iff u <= t, :303-308).
//
// Bound on the H100: bytes.  A forward reads each valid K and V row once
// (2 * 256 B per row and KV head, bf16) and does 2 * R FMAs per element,
// R = T * group query rows per KV head, far below the ~295 FLOP/byte ridge.
// Design (PR 1's K2 design, csrc/decode_attention.cu, with page
// addressing):
//   * pass 1 (split kernel): one block per (split, kv head, lane).  The
//     lane's valid rows are numbered densely 0..plen+dcount and cut into
//     `splits` chunks, so small batches still fill the card.  Each row
//     resolves through table[b, entry] to (page, offset); each 16-thread
//     half-warp streams one 256-byte row with 16-byte loads, dots it with
//     all R query rows of the KV head (f32, shuffles across the half-warp)
//     and keeps an online softmax per query row in registers.  K7's T
//     positions ride in the rows K2 gives its GQA group, so every query row
//     of a lane reads each page once -- the point of the TPU verify kernel
//     (:285-294).  The block's 8 half-warps merge through shared memory into
//     one partial (m, l, acc) per query row in an f32 workspace.
//   * pass 2 (combine kernel): one block per (query row, lane) folds the
//     partials and the causal fresh block q . k_new[u], u <= t, into the
//     output.
// Masking is by construction (only valid rows are visited); the running max
// starts at a finite -0.7 * FLT_MAX (the TPU kernel's mask value), so a
// lane with no valid rows (an idle slot) yields its fresh block alone:
// finite, and the fresh column u = 0 keeps every row's sum above zero.
//
// The int8 pool (Q8): int8 rows with one f32 scale per row, kscale/vscale
// (L, n_pages, Hkv, PS); the scales fold into the score and the
// probability as in K4 (ops/quant_kv.py): half the row bytes, plus 8 bytes
// of scales per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kThreads = 128;
constexpr int kRowThreads = 16;                   // threads per pool row
constexpr int kWorkers = kThreads / kRowThreads;  // rows in flight per block
constexpr int kPerThread = kD / kRowThreads;      // 8 elements, 16 bytes
constexpr int kMaxT = 8;                          // fresh positions per lane
constexpr float kMaskValue = -0.7f * FLT_MAX;

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

// R query rows per KV head (T * group), row r = g * T + t, so that q, the
// workspace and the output are (B, Hkv, R, ...) in memory.
template <int R, bool Q8>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ kpool,
                       const void* __restrict__ vpool,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       const int* __restrict__ table,
                       const int* __restrict__ prompt_len,
                       const int* __restrict__ decode_count,
                       float* __restrict__ ws, int layer, int Hkv,
                       int n_pages, int PS, int max_pages, int splits,
                       float scale) {
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int half = (threadIdx.x / kRowThreads) & 1;
  const int worker = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;

  const int plen = max(prompt_len[b], 0);
  const int dcount = max(decode_count[b], 0);
  const int pp = (plen + PS - 1) / PS;
  const int n_valid = plen + dcount;
  const int chunk = (n_valid + splits - 1) / splits;
  const int start = split * chunk;
  const int end = min(n_valid, start + chunk);

  float qv[R][kPerThread];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + (((int64_t)b * Hkv + hk) * R + r) * kD + sub * kPerThread);
    unpack8(raw, qv[r]);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) qv[r][e] *= scale;
  }

  float m[R], l[R], acc[R][kPerThread];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) acc[r][e] = 0.f;
  }

  const int* tab = table + (int64_t)b * max_pages;
  const int64_t layer_pages = (int64_t)layer * n_pages;
  // Warp-uniform trip count (the shuffles need all 32 lanes): the warp's
  // two half-warps take compact rows j0 and j0 + 1.
  for (int j0 = start + warp * 2; j0 < end; j0 += kWorkers) {
    const int j = j0 + half;
    const bool live = j < end;
    float kf[kPerThread], vf[kPerThread];
    float ks = 1.f, vs = 1.f;
    if (live) {
      int entry, off;
      if (j < plen) {
        entry = j / PS;
        off = j - entry * PS;
      } else {
        const int dj = j - plen;
        entry = pp + dj / PS;
        off = dj - (dj / PS) * PS;
      }
      const int page = min(max(tab[min(entry, max_pages - 1)], 0), n_pages - 1);
      const int64_t row = ((layer_pages + page) * Hkv + hk) * PS + off;
      const int64_t el = row * kD + sub * kPerThread;
      if (Q8) {
        unpack8_i8(*reinterpret_cast<const uint2*>(
                       static_cast<const int8_t*>(kpool) + el), kf);
        unpack8_i8(*reinterpret_cast<const uint2*>(
                       static_cast<const int8_t*>(vpool) + el), vf);
        ks = kscale[row];
        vs = vscale[row];
      } else {
        unpack8(*reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(kpool) + el), kf);
        unpack8(*reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(vpool) + el), vf);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) kf[e] = vf[e] = 0.f;
    }
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) part = fmaf(qv[r][e], kf[e], part);
#pragma unroll
      for (int o = kRowThreads / 2; o >= 1; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      s[r] = Q8 ? part * ks : part;
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float mn = fmaxf(m[r], s[r]);
        const float alpha = expf(m[r] - mn);
        const float p = expf(s[r] - mn);
        l[r] = l[r] * alpha + p;
        const float pv = Q8 ? p * vs : p;
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
          acc[r][e] = fmaf(pv, vf[e], acc[r][e] * alpha);
        }
        m[r] = mn;
      }
    }
  }

  __shared__ float sm_m[kWorkers][R];
  __shared__ float sm_l[kWorkers][R];
  __shared__ float sm_acc[kWorkers][R][kD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (sub == 0) {
      sm_m[worker][r] = m[r];
      sm_l[worker][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      sm_acc[worker][r][sub * kPerThread + e] = acc[r][e];
    }
  }
  __syncthreads();

  const int d = threadIdx.x;  // kThreads == kD
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float M = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) M = fmaxf(M, sm_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) {
      const float wt = expf(sm_m[w][r] - M);
      L = fmaf(sm_l[w][r], wt, L);
      A = fmaf(sm_acc[w][r][d], wt, A);
    }
    float* dst =
        ws + ((((int64_t)b * Hkv + hk) * splits + split) * R + r) * (kD + 2);
    dst[d] = A;
    if (d == 0) {
      dst[kD] = M;
      dst[kD + 1] = L;
    }
  }
}

// One block per (kv head x query row, lane); R = T * group rows per head.
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_new,
                         const __nv_bfloat16* __restrict__ v_new,
                         const float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ out, int Hkv, int R,
                         int T, int splits, float scale) {
  const int hk = blockIdx.x / R;
  const int r = blockIdx.x % R;
  const int t = r % T;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int64_t qrow = ((int64_t)b * Hkv + hk) * R + r;
  const int64_t fresh0 = ((int64_t)b * Hkv + hk) * T;

  // Fresh scores q . k_new[u] for u <= t, reduced over the 128 threads.
  const float qd = __bfloat162float(q[qrow * kD + d]) * scale;
  float part[kMaxT];
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) {
    part[u] = u <= t ? qd * __bfloat162float(k_new[(fresh0 + u) * kD + d]) : 0.f;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
    }
  }
  __shared__ float warp_sums[kThreads / 32][kMaxT];
  if (d % 32 == 0) {
#pragma unroll
    for (int u = 0; u < kMaxT; ++u) warp_sums[d / 32][u] = part[u];
  }
  __syncthreads();
  float s_self[kMaxT];
  float M = kMaskValue;
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) {
    s_self[u] = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s_self[u] += warp_sums[w][u];
    if (u <= t) M = fmaxf(M, s_self[u]);
  }

  const float* base = ws + (((int64_t)b * Hkv + hk) * splits) * R * (kD + 2);
  for (int sp = 0; sp < splits; ++sp) {
    M = fmaxf(M, base[((int64_t)sp * R + r) * (kD + 2) + kD]);
  }
  float L = 0.f, A = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) {
    if (u <= t) {
      const float p = expf(s_self[u] - M);
      L += p;
      A = fmaf(p, __bfloat162float(v_new[(fresh0 + u) * kD + d]), A);
    }
  }
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = base + ((int64_t)sp * R + r) * (kD + 2);
    const float wt = expf(p[kD] - M);
    L = fmaf(p[kD + 1], wt, L);
    A = fmaf(p[d], wt, A);
  }
  out[qrow * kD + d] = __float2bfloat16(A / L);
}

struct Args {
  const void* q;
  const void* kpool;
  const void* vpool;
  const void* kscale;
  const void* vscale;
  const void* k_new;
  const void* v_new;
  const void* table;
  const void* prompt_len;
  const void* decode_count;
  void* ws;
  void* out;
  int layer, B, Hkv, T, n_pages, PS, max_pages, splits;
  float scale;
  cudaStream_t stream;
};

template <int R, bool Q8>
int launch(const Args& a) {
  const dim3 grid1(a.splits, a.Hkv, a.B);
  paged_split_kernel<R, Q8><<<grid1, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.kpool, a.vpool,
      static_cast<const float*>(a.kscale), static_cast<const float*>(a.vscale),
      static_cast<const int*>(a.table), static_cast<const int*>(a.prompt_len),
      static_cast<const int*>(a.decode_count), static_cast<float*>(a.ws),
      a.layer, a.Hkv, a.n_pages, a.PS, a.max_pages, a.splits, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(a.Hkv * R, a.B);
  paged_combine_kernel<<<grid2, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k_new),
      static_cast<const __nv_bfloat16*>(a.v_new),
      static_cast<const float*>(a.ws), static_cast<__nv_bfloat16*>(a.out),
      a.Hkv, R, a.T, a.splits, a.scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch(const Args& a, int Hq) {
  if (a.B == 0) return (int)cudaSuccess;
  if (a.T < 1 || a.T > kMaxT || Hq % a.Hkv) return (int)cudaErrorInvalidValue;
  switch ((Hq / a.Hkv) * a.T) {
    case 1: return launch<1, Q8>(a);
    case 2: return launch<2, Q8>(a);
    case 3: return launch<3, Q8>(a);
    case 4: return launch<4, Q8>(a);
    case 5: return launch<5, Q8>(a);
    case 6: return launch<6, Q8>(a);
    case 7: return launch<7, Q8>(a);
    case 8: return launch<8, Q8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes as in the header comment; ws is f32 (B, Hkv, splits, T * Hq / Hkv,
// 130).  T * Hq / Hkv must be at most 8.  Returns the cudaError_t of the
// launches.
extern "C" int decode_attention_paged_bf16(
    const void* q, const void* kpool, const void* vpool, const void* k_new,
    const void* v_new, const void* table, const void* prompt_len,
    const void* decode_count, void* ws, void* out, int layer, int B, int Hq,
    int Hkv, int T, int n_pages, int PS, int max_pages, int splits,
    float scale, void* stream) {
  const Args a{q, kpool, vpool, nullptr, nullptr, k_new, v_new, table,
               prompt_len, decode_count, ws, out, layer, B, Hkv, T, n_pages,
               PS, max_pages, splits, scale, (cudaStream_t)stream};
  return dispatch<false>(a, Hq);
}

// The int8 pool: kpool/vpool int8 (L, n_pages, Hkv, PS, 128), kscale/vscale
// f32 (L, n_pages, Hkv, PS); everything else as decode_attention_paged_bf16.
extern "C" int decode_attention_paged_q8(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* k_new, const void* v_new,
    const void* table, const void* prompt_len, const void* decode_count,
    void* ws, void* out, int layer, int B, int Hq, int Hkv, int T, int n_pages,
    int PS, int max_pages, int splits, float scale, void* stream) {
  const Args a{q, kpool, vpool, kscale, vscale, k_new, v_new, table,
               prompt_len, decode_count, ws, out, layer, B, Hkv, T, n_pages,
               PS, max_pages, splits, scale, (cudaStream_t)stream};
  return dispatch<true>(a, Hq);
}
