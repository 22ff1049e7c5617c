// K11a: one-token decode attention with whole-lane cells, one launch (decode
// mode "3").
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm2.py:
// decode_attention_hbm2 (:134; kernel _kernel :23, pallas_call :181).
// Shapes, masking and numerics: decode_pair_stream.cuh (one decode end for
// every lane, read from device memory, prompt lengths clamped to [0, pb]).
//
// The TPU kernel gives each lane one grid cell that walks all its KV heads'
// blocks of block_k rows with a double-buffered DMA, with no split of the
// rows and no combine pass.  The card runs the same function as
// decode_pair_stream.cuh's persistent stream, as K11b does: up to one block
// per SM, each owning `per` contiguous (lane, KV head) pairs (the wrapper's
// stream_grid); a producer warp streams the pairs' 32-row tiles by bulk
// copies into a 12-stage mbarrier ring, skipping the tiles whose rows are
// all masked, and eight consumer warps take whole tiles, passing only the
// online softmax's running values from tile to tile.  Still no split of a
// pair's rows and no combine pass, and each pair's G output rows are
// written by the warp that folds its last tile.  The kernel has a name of
// its own, so that a profile tells K11a from K11b; its output is K11b's bit
// for bit.
//
// Bound on the H100: bytes.  At B = 8 every one of the 64 pairs has an SM,
// and a pair's tiles are in flight together.
#include "decode_pair_stream.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(pstream::kBlockThreads)
    decode_hbm2_kernel(dstream::Args a, const int* decode_end, int per) {
  pstream::run_stream<G, false, const int*>(a, decode_end, per);
}

template <int G>
int launch(const dstream::Args& a, const int* decode_end, int per, cudaStream_t stream) {
  static gemm::SmemAllowed smem;
  return pstream::launch(decode_hbm2_kernel<G>, smem, (a.B * a.Hkv + per - 1) / per, stream,
                         a, decode_end, per);
}

}  // namespace

// q (B, Hq, 128), kall/vall (L, B, Hkv, S, 128), k_new/v_new (B, Hkv, 1,
// 128), out (B, Hq, 128) bf16; prompt_len (B,) int32; all contiguous on the
// device.  decode_end points at one int32 on the device, the decode end of
// every lane, which the kernel reads (a graph replay takes the value it
// finds there, as the TPU kernel reads its end by scalar prefetch, :38,
// :164); block_k divides S and pb and is a multiple of 32; Hq / Hkv is 1, 2
// or 4; per >= 1 is the pairs each block streams (the wrapper's
// stream_grid: cdiv(B Hkv, min(B Hkv, SM count))).  Returns the launch's
// cudaError_t.
extern "C" int decode_attention_hbm2_bf16(
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
