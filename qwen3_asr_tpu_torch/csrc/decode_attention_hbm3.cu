// K11b: one-token decode attention as a persistent (lane, KV head) stream
// (decode mode "4").
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:
// decode_attention_hbm3 (:181; kernel _kernel :28, pallas_call :253).
// K11a's function, arguments and tiling rule, with one decode end for every
// lane, read from device memory (the TPU kernel's scalar prefetch, :42,
// :228).
//
// The TPU kernel's grid is its two TensorCores, each walking half the batch
// as one stream of (lane, block) pairs, because a TPU grid cell has a fixed
// cost.  The card has no such cost and 132 SMs: decode_pair_stream.cuh's
// stream, up to one block per SM, each owning `per` contiguous pairs (the
// wrapper's stream_grid), a producer warp's bulk copies into a 12-stage ring
// and eight consumer warps taking whole tiles.  K11a runs the same stream
// under a kernel of its own name.
//
// Bound on the H100: bytes.
#include "decode_pair_stream.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(pstream::kBlockThreads)
    decode_hbm3_kernel(dstream::Args a, const int* decode_end, int per) {
  pstream::run_stream<G, false, const int*>(a, decode_end, per);
}

template <int G>
int launch(const dstream::Args& a, const int* decode_end, int per, cudaStream_t stream) {
  static gemm::SmemAllowed smem;
  return pstream::launch(decode_hbm3_kernel<G>, smem, (a.B * a.Hkv + per - 1) / per, stream,
                         a, decode_end, per);
}

}  // namespace

// As decode_attention_hbm2_bf16 (the same arguments, per included).
extern "C" int decode_attention_hbm3_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* prompt_len, void* out, int layer, int B,
    int Hq, int Hkv, int S, int pb, const void* decode_end, int block_k, int per,
    float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || per < 1 || !pstream::valid_tiling(S, pb, block_k)) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, prompt_len, out,
                                             layer, B, Hkv, S, pb, scale);
  const int* dend = static_cast<const int*>(decode_end);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, dend, per, st);
    case 2: return launch<2>(a, dend, per, st);
    case 4: return launch<4>(a, dend, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
