// K11a: one-token decode attention, whole-lane cells, one launch.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm2.py:
// decode_attention_hbm2 (:134; kernel _kernel :23, pallas_call :181).
// Shapes, masking and numerics: decode_stream.cuh.
//
// Schedule: the TPU kernel gives each lane one grid cell that walks all
// its KV heads' blocks of block_k rows with a double-buffered DMA, with no
// split of the rows and no combine pass.  Its (Hkv, block_k, 128) K and V
// blocks (512 KB at block_k = 128) do not fit in an SM's shared memory, so
// here each (lane, KV head) pair is its own CUDA block (grid B * Hkv), which
// walks the pair's blocks as 32-row tiles through a 2-stage cp.async ring
// and writes the pair's G output rows itself.
//
// Bound on the H100: bytes.  With B * Hkv blocks (64 at B = 8) it fills
// half of the card's 132 SMs and keeps one tile per block in flight, so it
// is expected to run well below K2 (which splits a lane's rows over ~2
// blocks per SM): the TPU schedule, measured as it is.
#include "decode_stream.cuh"

namespace {

constexpr int kStages = 2;

template <int G>
__global__ void __launch_bounds__(dstream::kThreads)
    decode_hbm2_kernel(dstream::Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  dstream::run_pairs<G, kStages>(a, blockIdx.x, blockIdx.x + 1,
                                 reinterpret_cast<__nv_bfloat16*>(smem));
}

template <int G>
int launch(const dstream::Args& a, cudaStream_t stream) {
  constexpr int bytes = dstream::ring_bytes(kStages);
  static bool smem_ok = false;
  cudaError_t err = gemm::allow_smem(decode_hbm2_kernel<G>, bytes, smem_ok);
  if (err != cudaSuccess) return (int)err;
  decode_hbm2_kernel<G><<<a.B * a.Hkv, dstream::kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, 128), kall/vall (L, B, Hkv, S, 128), k_new/v_new (B, Hkv, 1,
// 128), out (B, Hq, 128) bf16; prompt_len (B,) int32; all contiguous on the
// device.  decode_end is one int for every lane; block_k divides S and pb
// and is a multiple of 32; Hq / Hkv is 1, 2 or 4.  Returns the launch's
// cudaError_t.
extern "C" int decode_attention_hbm2_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* prompt_len, void* out, int layer, int B,
    int Hq, int Hkv, int S, int pb, int decode_end, int block_k, float scale,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || !dstream::valid_tiling(S, pb, block_k)) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, prompt_len,
                                             out, layer, B, Hkv, S, pb, decode_end,
                                             block_k, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
