// K11c: one-token decode attention with per-lane decode ends.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm5.py:
// decode_attention_hbm5 (:268; kernel _kernel :41, pallas_call :368).
// Shapes, masking and numerics: decode_pair_stream.cuh with per-lane ends
// (each clamped to [pb, S]) and prompt lengths clamped to [1, pb], as the
// TPU wrapper clamps them (:324-327).
//
// The TPU kernel amortizes its DMA issue cost over G = 4 lanes (_GROUP :38):
// one strided copy brings the same rows of 4 lanes at once, and the group
// walks the largest geometry of its lanes.  The card has no per-copy cost
// to amortize: each (lane, KV head) pair walks its own lane's geometry
// (cdiv(plen, 32) prompt tiles from row 0, cdiv(dend - pb, 32) decode tiles
// from row pb) in decode_pair_stream.cuh's persistent stream, up to one
// block per SM.  The group walk's extra tiles are all masked for the lane,
// so the output is the group walk's bit for bit.
//
// With per-lane ends, equal runs of pairs load the SMs unevenly: a run is
// mostly one lane's heads, whose depth is drawn from [pb, S].  So with more
// pairs than blocks each block takes a range balanced by tiles
// (block_range: each block scans the lanes' tile counts on the device; no
// host sync, no host-built schedule; a pair is never split, which would move
// bits).  With no more pairs than blocks, each block takes one pair.
//
// Bound on the H100: bytes (the valid rows' K and V, read once).
#include "decode_pair_stream.cuh"

namespace {

constexpr int kDecodeBlock = 128;

template <int G>
__global__ void __launch_bounds__(pstream::kBlockThreads)
    decode_hbm5_kernel(dstream::Args a, const int* decode_end) {
  pstream::run_stream<G, true>(a, decode_end, 1);
}

template <int G>
int launch(const dstream::Args& a, const int* decode_end, int blocks, cudaStream_t stream) {
  static gemm::SmemAllowed smem;
  return pstream::launch(decode_hbm5_kernel<G>, smem, blocks, stream, a, decode_end);
}

}  // namespace

// q (B, Hq, 128), kall/vall (L, B, Hkv, S, 128), k_new/v_new (B, Hkv, 1,
// 128), out (B, Hq, 128) bf16; prompt_len and decode_end (B,) int32; all
// contiguous on the device.  block_p is 128, 256 or 512 and divides pb;
// S - pb is a multiple of 128; Hq / Hkv is 1, 2 or 4; blocks >= 1 (the
// wrapper's: min(B Hkv, SM count)).  Returns the launch's cudaError_t.
extern "C" int decode_attention_hbm5_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* prompt_len, const void* decode_end, void* out,
    int layer, int B, int Hq, int Hkv, int S, int pb, int block_p, int blocks,
    float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || blocks < 1 ||
      (block_p != 128 && block_p != 256 && block_p != 512) || pb < 0 || pb > S ||
      pb % block_p || (S - pb) % kDecodeBlock) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, prompt_len, out,
                                             layer, B, Hkv, S, pb, scale);
  const int* dend = static_cast<const int*>(decode_end);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, dend, blocks, st);
    case 2: return launch<2>(a, dend, blocks, st);
    case 4: return launch<4>(a, dend, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
