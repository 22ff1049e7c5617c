// K11c: one-token decode attention with lane-grouped reads.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm5.py:
// decode_attention_hbm5 (:268; kernel _kernel :41, pallas_call :368).
// Tile loads, online softmax, self-term and numerics: decode_stream.cuh.
//
// The TPU kernel amortizes its DMA issue cost over G = 4 lanes (_GROUP :38):
// one strided copy brings the same rows of 4 lanes at once, the group walks
// the largest geometry of its lanes (max prompt blocks of block_p rows from
// row 0, then max decode blocks of 128 rows from row pb, :339-340), and
// each lane keeps its own softmax state and its own two-interval mask
// (row < plen[j]) | (pb <= row < dend[j]), finalized at the end of the group.
//
// Here one CUDA block owns one (group of 4 lanes, KV head).  Each ring stage
// holds the group's 32-row tile for all 4 lanes -- 4 x 32 rows x 128 x bf16
// x (K + V) = 64 KB, issued together -- and each lane's rows are folded into
// that lane's state in turn.  The ring is 3 stages deep, as the TPU's (:35):
// 192 KB of the 227 KB a block may use, one block per SM, two stages (128
// KB) in flight.  A fourth stage would not fit.  Lanes past B in the last
// group are neither read nor written (the TPU wrapper instead pads the
// cache to whole groups, :333-336).
//
// Bound on the H100: bytes.  The grid is cdiv(B, 4) x Hkv blocks (16 at
// B = 8 on 132 SMs), so small batches leave most of the card idle: the TPU
// schedule, measured as it is.
#include "decode_stream.cuh"

namespace {

constexpr int kGroup = 4;                                   // lanes per stage
constexpr int kStages = 3;
constexpr int kStageElems = kGroup * 2 * dstream::kTileElems;   // 64 KB
constexpr int kDecodeBlock = 128;

template <int G>
__global__ void __launch_bounds__(dstream::kThreads)
    decode_hbm5_kernel(dstream::Args a, const int* decode_end, int block_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ dstream::Shared<G> sh;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto kbuf = [&](int stage, int j) {
    return ring + stage * kStageElems + j * 2 * dstream::kTileElems;
  };
  auto vbuf = [&](int stage, int j) { return kbuf(stage, j) + dstream::kTileElems; };

  const int grp = blockIdx.x / a.Hkv;
  const int hk = blockIdx.x - grp * a.Hkv;
  const int b0 = grp * kGroup;

  // Per-lane intervals (prompt rows clamped to [1, pb], decode ends to
  // [pb, S]) and the group's geometry, the max over its lanes.
  int plen[kGroup], dend[kGroup];
  int gplen = 1, gdend = a.pb;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const int b = b0 + j;
    plen[j] = b < a.B ? min(max(a.prompt_len[b], 1), a.pb) : 0;
    dend[j] = b < a.B ? min(max(decode_end[b], a.pb), a.S) : a.pb;
    gplen = max(gplen, plen[j]);
    gdend = max(gdend, dend[j]);
  }
  const int prompt_tiles =
      (gplen + block_p - 1) / block_p * (block_p / dstream::kTile);
  const int n_tiles = prompt_tiles + (gdend - a.pb + kDecodeBlock - 1) / kDecodeBlock *
                                         (kDecodeBlock / dstream::kTile);
  auto row_of = [&](int t) {
    return t < prompt_tiles ? t * dstream::kTile
                            : a.pb + (t - prompt_tiles) * dstream::kTile;
  };
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int stage = t % kStages;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (b0 + j < a.B) {
          dstream::load_rows(a, b0 + j, hk, row_of(t), kbuf(stage, j), vbuf(stage, j));
        }
      }
    }
    gemm::cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  dstream::State<G> st[kGroup];
  dstream::Pair p[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    p[j].b = b0 + j;
    p[j].hk = hk;
    if (b0 + j < a.B) dstream::start_pair<G>(a, p[j], st[j]);
  }
  for (int t = 0; t < n_tiles; ++t) {
    gemm::cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(t + kStages - 1);   // the stage consumed at t - 1: all threads are past it
    const int stage = t % kStages;
    const int row0 = row_of(t);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (b0 + j < a.B) {
        const int pl = plen[j], de = dend[j], pb = a.pb;
        dstream::fold_tile<G>(
            row0, [&](int row) { return row < pl || (row >= pb && row < de); },
            kbuf(stage, j), vbuf(stage, j), st[j], sh);
      }
    }
  }
  gemm::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (b0 + j < a.B) dstream::finish_pair<G>(a, p[j], st[j], sh);
  }
}

template <int G>
int launch(const dstream::Args& a, const int* decode_end, int block_p,
           cudaStream_t stream) {
  constexpr int bytes = kStages * kStageElems * 2;
  static bool smem_ok = false;
  cudaError_t err = gemm::allow_smem(decode_hbm5_kernel<G>, bytes, smem_ok);
  if (err != cudaSuccess) return (int)err;
  const int groups = (a.B + kGroup - 1) / kGroup;
  decode_hbm5_kernel<G><<<groups * a.Hkv, dstream::kThreads, bytes, stream>>>(
      a, decode_end, block_p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, 128), kall/vall (L, B, Hkv, S, 128), k_new/v_new (B, Hkv, 1,
// 128), out (B, Hq, 128) bf16; prompt_len and decode_end (B,) int32; all
// contiguous on the device.  block_p is 128, 256 or 512 and divides pb;
// S - pb is a multiple of 128; Hq / Hkv is 1, 2 or 4.  Returns the launch's
// cudaError_t.
extern "C" int decode_attention_hbm5_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* prompt_len, const void* decode_end, void* out,
    int layer, int B, int Hq, int Hkv, int S, int pb, int block_p, float scale,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || (block_p != 128 && block_p != 256 && block_p != 512) ||
      pb < 0 || pb > S || pb % block_p || (S - pb) % kDecodeBlock) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, prompt_len,
                                             out, layer, B, Hkv, S, pb, S, block_p, scale);
  const int* dend = static_cast<const int*>(decode_end);
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, dend, block_p, st);
    case 2: return launch<2>(a, dend, block_p, st);
    case 4: return launch<4>(a, dend, block_p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
