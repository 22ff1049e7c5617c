// K11b: one-token decode attention as a persistent (lane, block) stream.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:
// decode_attention_hbm3 (:181; kernel _kernel :28, pallas_call :253).
// Shapes, masking and numerics: decode_stream.cuh.
//
// Schedule: the TPU kernel's grid is its two TensorCores; each core owns a
// contiguous half of the batch and walks it as ONE software-pipelined
// stream of (lane, block) pairs with a 4-deep DMA ring that keeps
// prefetching across lane boundaries (:83-115), finalizing a lane as its
// last block drains.  Here the grid is a fixed set of at most one CUDA block
// per SM (the wrapper passes n_blocks); block i owns the contiguous range of
// (lane, KV head) pairs [i * per, (i + 1) * per), per = cdiv(B * Hkv,
// n_blocks), and walks their 32-row tiles as one stream through a 4-stage
// cp.async ring whose producer runs ahead into the next pair.  One launch,
// no split of a pair's rows, no combine pass.
//
// Bound on the H100: bytes.  The wrapper spreads the stream over at most
// half as many blocks as there are pairs, so every block owns at least two
// pairs and its ring crosses a pair boundary (at B = 8: 32 blocks of 2).
#include "decode_stream.cuh"

namespace {

constexpr int kStages = 4;

template <int G>
__global__ void __launch_bounds__(dstream::kThreads)
    decode_hbm3_kernel(dstream::Args a, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = a.B * a.Hkv;
  const int begin = min((int)blockIdx.x * per, pairs);
  const int end = min(begin + per, pairs);
  dstream::run_pairs<G, kStages>(a, begin, end,
                                 reinterpret_cast<__nv_bfloat16*>(smem));
}

template <int G>
int launch(const dstream::Args& a, int n_blocks, cudaStream_t stream) {
  constexpr int bytes = dstream::ring_bytes(kStages);
  static bool smem_ok = false;
  cudaError_t err = gemm::allow_smem(decode_hbm3_kernel<G>, bytes, smem_ok);
  if (err != cudaSuccess) return (int)err;
  const int pairs = a.B * a.Hkv;
  const int per = (pairs + n_blocks - 1) / n_blocks;
  const int grid = (pairs + per - 1) / per;
  decode_hbm3_kernel<G><<<grid, dstream::kThreads, bytes, stream>>>(a, per);
  return (int)cudaGetLastError();
}

}  // namespace

// As decode_attention_hbm2_bf16, plus n_blocks >= 1: the most CUDA blocks
// the stream is spread over (the wrapper passes min(B * Hkv / 2, SM count)).
extern "C" int decode_attention_hbm3_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* prompt_len, void* out, int layer, int B,
    int Hq, int Hkv, int S, int pb, int decode_end, int block_k, int n_blocks,
    float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || n_blocks < 1 ||
      !dstream::valid_tiling(S, pb, block_k)) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, prompt_len,
                                             out, layer, B, Hkv, S, pb, decode_end,
                                             block_k, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, n_blocks, st);
    case 2: return launch<2>(a, n_blocks, st);
    case 4: return launch<4>(a, n_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
