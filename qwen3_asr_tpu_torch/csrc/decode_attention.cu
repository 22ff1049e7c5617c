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
// far below the card's ~295 FLOP/byte ridge.  Design, as in the TPU kernel,
// is to read only the valid rows [0, plen) and [pb, dend), never the padded
// middle of the cache, and to read them once for the whole GQA group:
//   * pass 1 (split kernel): one block per (split, kv head, lane).  The
//     lane's valid rows are numbered 0..n_valid and cut into `splits`
//     contiguous chunks so that small batches still fill the card.  Each
//     16-thread half-warp streams one 256-byte row per step with 16-byte
//     loads, dots it with the group's query heads (f32, shuffles across the
//     half-warp) and keeps an online softmax (max, sum, 128-wide
//     accumulator) in registers; the block's 8 half-warps merge through
//     shared memory into one partial (m, l, acc) per query head, written to
//     an f32 workspace that the wrapper allocates.
//   * pass 2 (combine kernel): one block per (query head, lane) folds the
//     partials and the self-term q . k_new into the output.
// Masking is by construction (only valid rows are visited) and the running
// max starts at a finite -0.7 * FLT_MAX, so an idle lane (prompt_len 0,
// decode_end == prompt_bucket) yields the self-term alone: finite, no NaN.
//
// K4, the int8-cache variant, is the same kernel instantiated with Q8:
// replaces decode_attention_hbm4.py:decode_attention_hbm4_q8 (:434).  The
// cache is int8 rows (128 B) with one f32 scale per row, kscale/vscale
// (L, B, Hkv, S).  Each half-warp thread reads 8 bytes of a row, and the
// scales fold into the small quantities, as in ops/quant_kv.py:20-23: the
// row's score is (q . k8) * ks and its probability p weighs v8 as
// (p * vs) . v8, while the softmax sum takes p itself.  Half the K/V bytes
// of the bf16 cache, plus 8 bytes of scales per row; k_new/v_new stay bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kThreads = 128;
constexpr int kRowThreads = 16;                 // threads per cache row
constexpr int kWorkers = kThreads / kRowThreads;  // rows in flight per block
constexpr int kPerThread = kD / kRowThreads;      // 8 elements, 16 bytes
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

// Q8: kall/vall are int8 rows with per-row scales kscale/vscale; otherwise
// bf16 rows and the scale pointers are unused.
template <int G, bool Q8>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ kall,
                        const void* __restrict__ vall,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        const int* __restrict__ prompt_len,
                        const int* __restrict__ decode_end,
                        float* __restrict__ ws, int layer, int B, int Hkv,
                        int S, int pb, int splits, float scale) {
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int half = (threadIdx.x / kRowThreads) & 1;
  const int worker = threadIdx.x / kRowThreads;
  const int sub = threadIdx.x % kRowThreads;
  const int Hq = Hkv * G;

  const int plen = min(max(prompt_len[b], 0), pb);
  const int dend = min(max(decode_end[b], pb), S);
  const int n_valid = plen + (dend - pb);
  const int chunk = (n_valid + splits - 1) / splits;
  const int start = split * chunk;
  const int end = min(n_valid, start + chunk);

  float qv[G][kPerThread];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((int64_t)b * Hq + hk * G + gi) * kD + sub * kPerThread);
    unpack8(raw, qv[gi]);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) qv[gi][e] *= scale;
  }

  float m[G], l[G], acc[G][kPerThread];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kMaskValue;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) acc[gi][e] = 0.f;
  }

  const int64_t lane_row0 = (((int64_t)layer * B + b) * Hkv + hk) * S;
  // Warp-uniform trip count (the shuffles need all 32 lanes): the warp's
  // two half-warps take rows j0 and j0 + 1.
  for (int j0 = start + warp * 2; j0 < end; j0 += kWorkers) {
    const int j = j0 + half;
    const bool live = j < end;
    const int row = j < plen ? j : pb + (j - plen);
    float kf[kPerThread], vf[kPerThread];
    float ks = 1.f, vs = 1.f;
    if (live) {
      const int64_t r = lane_row0 + row;
      const int64_t off = r * kD + sub * kPerThread;
      if (Q8) {
        unpack8_i8(*reinterpret_cast<const uint2*>(
                       static_cast<const int8_t*>(kall) + off), kf);
        unpack8_i8(*reinterpret_cast<const uint2*>(
                       static_cast<const int8_t*>(vall) + off), vf);
        ks = kscale[r];
        vs = vscale[r];
      } else {
        unpack8(*reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(kall) + off), kf);
        unpack8(*reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(vall) + off), vf);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) kf[e] = vf[e] = 0.f;
    }
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) part = fmaf(qv[gi][e], kf[e], part);
#pragma unroll
      for (int o = kRowThreads / 2; o >= 1; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      s[gi] = Q8 ? part * ks : part;
    }
    if (live) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float mn = fmaxf(m[gi], s[gi]);
        const float alpha = expf(m[gi] - mn);
        const float p = expf(s[gi] - mn);
        l[gi] = l[gi] * alpha + p;
        const float pv = Q8 ? p * vs : p;
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
          acc[gi][e] = fmaf(pv, vf[e], acc[gi][e] * alpha);
        }
        m[gi] = mn;
      }
    }
  }

  __shared__ float sm_m[kWorkers][G];
  __shared__ float sm_l[kWorkers][G];
  __shared__ float sm_acc[kWorkers][G][kD];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (sub == 0) {
      sm_m[worker][gi] = m[gi];
      sm_l[worker][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      sm_acc[worker][gi][sub * kPerThread + e] = acc[gi][e];
    }
  }
  __syncthreads();

  const int d = threadIdx.x;  // kThreads == kD
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float M = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) M = fmaxf(M, sm_m[w][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWorkers; ++w) {
      const float wt = expf(sm_m[w][gi] - M);
      L = fmaf(sm_l[w][gi], wt, L);
      A = fmaf(sm_acc[w][gi][d], wt, A);
    }
    float* dst =
        ws + ((((int64_t)b * Hkv + hk) * splits + split) * G + gi) * (kD + 2);
    dst[d] = A;
    if (d == 0) {
      dst[kD] = M;
      dst[kD + 1] = L;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_new,
                          const __nv_bfloat16* __restrict__ v_new,
                          const float* __restrict__ ws,
                          __nv_bfloat16* __restrict__ out, int Hkv, int splits,
                          float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int Hq = Hkv * G;
  const int hk = h / G;
  const int gi = h % G;

  // Self-term score q . k_new, reduced over the block's 128 threads.
  const float qd =
      __bfloat162float(q[((int64_t)b * Hq + h) * kD + d]) * scale;
  float part =
      qd * __bfloat162float(k_new[((int64_t)b * Hkv + hk) * kD + d]);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, o);
  }
  __shared__ float warp_sums[kThreads / 32];
  if (d % 32 == 0) warp_sums[d / 32] = part;
  __syncthreads();
  float s_self = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s_self += warp_sums[w];

  const float* base = ws + (((int64_t)b * Hkv + hk) * splits) * G * (kD + 2);
  float M = s_self;
  for (int sp = 0; sp < splits; ++sp) {
    M = fmaxf(M, base[((int64_t)sp * G + gi) * (kD + 2) + kD]);
  }
  float L = expf(s_self - M);
  float A = L * __bfloat162float(v_new[((int64_t)b * Hkv + hk) * kD + d]);
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = base + ((int64_t)sp * G + gi) * (kD + 2);
    const float wt = expf(p[kD] - M);
    L = fmaf(p[kD + 1], wt, L);
    A = fmaf(p[d], wt, A);
  }
  out[((int64_t)b * Hq + h) * kD + d] = __float2bfloat16(A / L);
}

template <int G, bool Q8>
int launch(const void* q, const void* kall, const void* vall,
           const void* kscale, const void* vscale, const void* k_new,
           const void* v_new, const void* prompt_len, const void* decode_end,
           void* ws, void* out, int layer, int B, int Hkv, int S, int pb,
           int splits, float scale, cudaStream_t stream) {
  const dim3 grid1(splits, Hkv, B);
  decode_split_kernel<G, Q8><<<grid1, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kall, vall,
      static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<const int*>(prompt_len), static_cast<const int*>(decode_end),
      static_cast<float*>(ws), layer, B, Hkv, S, pb, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(Hkv * G, B);
  decode_combine_kernel<G><<<grid2, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), Hkv, splits, scale);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch(const void* q, const void* kall, const void* vall,
             const void* kscale, const void* vscale, const void* k_new,
             const void* v_new, const void* prompt_len, const void* decode_end,
             void* ws, void* out, int layer, int B, int Hq, int Hkv, int S,
             int pb, int splits, float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1:
      return launch<1, Q8>(q, kall, vall, kscale, vscale, k_new, v_new,
                           prompt_len, decode_end, ws, out, layer, B, Hkv, S,
                           pb, splits, scale, st);
    case 2:
      return launch<2, Q8>(q, kall, vall, kscale, vscale, k_new, v_new,
                           prompt_len, decode_end, ws, out, layer, B, Hkv, S,
                           pb, splits, scale, st);
    case 4:
      return launch<4, Q8>(q, kall, vall, kscale, vscale, k_new, v_new,
                           prompt_len, decode_end, ws, out, layer, B, Hkv, S,
                           pb, splits, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shapes as in the header comment; ws is f32 (B, Hkv, splits, Hq/Hkv, 130).
// Hq / Hkv must be 1, 2 or 4.  Returns the cudaError_t of the launches.
extern "C" int decode_attention_bf16(const void* q, const void* kall,
                                     const void* vall, const void* k_new,
                                     const void* v_new, const void* prompt_len,
                                     const void* decode_end, void* ws,
                                     void* out, int layer, int B, int Hq,
                                     int Hkv, int S, int pb, int splits,
                                     float scale, void* stream) {
  return dispatch<false>(q, kall, vall, nullptr, nullptr, k_new, v_new,
                         prompt_len, decode_end, ws, out, layer, B, Hq, Hkv,
                         S, pb, splits, scale, stream);
}

// K4: kall/vall int8 (L, B, Hkv, S, 128), kscale/vscale f32 (L, B, Hkv, S);
// everything else as decode_attention_bf16.
extern "C" int decode_attention_q8(const void* q, const void* kall,
                                   const void* vall, const void* kscale,
                                   const void* vscale, const void* k_new,
                                   const void* v_new, const void* prompt_len,
                                   const void* decode_end, void* ws, void* out,
                                   int layer, int B, int Hq, int Hkv, int S,
                                   int pb, int splits, float scale,
                                   void* stream) {
  return dispatch<true>(q, kall, vall, kscale, vscale, k_new, v_new,
                        prompt_len, decode_end, ws, out, layer, B, Hq, Hkv, S,
                        pb, splits, scale, stream);
}
