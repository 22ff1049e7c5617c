// The launch arguments and element helpers of the persistent decode stream
// (decode_pair_stream.cuh), which runs K11a-K11d: Args, make_args,
// bf16_round, unpack8, and the tile and row-split constants.
//
// q (B, Hq, 128); kall/vall (L, B, Hkv, S, 128); k_new/v_new (B, Hkv, 1, 128),
// all bf16.  Numerics follow the TPU kernels, not K2 (decode_attention_hbm2.py
// :160, :65, :79-126): q * scale formed in f32 and rounded to bf16; scores
// bf16 q . bf16 k with f32 accumulation, masked to kMaskValue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace dstream {

constexpr int kD = 128;
constexpr int kTile = 32;                      // cache rows per ring stage
constexpr int kRowThreads = 16;                // threads per row, score pass
constexpr int kPerThread = kD / kRowThreads;   // 8 elements, 16 bytes
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* kall;
  const __nv_bfloat16* vall;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  const int* prompt_len;
  __nv_bfloat16* out;
  int layer, B, Hkv, S, pb;
  float scale;
};

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

// The launch arguments.  The decode end is not among them: K11a and K11b
// read theirs from device memory in the kernel (decode_pair_stream.cuh's
// run_stream), K11c and K11d per lane.
inline Args make_args(const void* q, const void* kall, const void* vall,
                      const void* k_new, const void* v_new,
                      const void* prompt_len, void* out, int layer, int B,
                      int Hkv, int S, int pb, float scale) {
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
  a.scale = scale;
  return a;
}

}  // namespace dstream
