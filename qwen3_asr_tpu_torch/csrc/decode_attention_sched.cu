// K11d: one-token decode attention over a precomputed flat block schedule.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_sched.py:
// decode_attention_sched (:280; kernel _kernel :146, pallas_call :360).
// Shapes, masking, tiles and numerics: decode_pair_stream.cuh, with each
// lane's geometry read from the schedule.
//
// The schedule (build_decode_schedule, :70, ported in plain torch) lists for
// each "core" c its 128-row blocks in lane order: entry j < totals[c] is
// lane c * per_core + bl[c, j], cache rows [off, off + 128), valid while
// row < lim, with first/last-of-lane flags.  A lane's entries are two runs:
// its prompt blocks from row 0, each with lim = prompt_len (clamped to [1,
// pb]), then its decode blocks from row pb, each with lim = decode_end
// (clamped to [pb, S]).  The TPU kernel walks the list in ONE loop with no
// on-the-fly discovery; its grid is the cores.
//
// Here the grid is the card's: up to one block per SM, the (lane, KV head)
// pairs balanced over the blocks by tiles, as K11c (decode_pair_stream.cuh's
// persistent stream; cores and per_core only say how the list is laid
// out).  Each block first reads every lane's two runs from the list into
// shared memory (read_runs: one pass over the entries by all threads, no
// host sync): the prompt run below the lim of the lane's FIRST entry, and
// the decode run from the off of the one entry whose lim differs from its
// predecessor's (the decode end exceeds the prompt bucket, which bounds the
// prompt length) below that lim.  The stream then walks cdiv(plen, 32)
// prompt tiles from row 0 and cdiv(dend - pb, 32) decode tiles from pb: the
// 32-row tiles of the lane's entries whose first row is below the entry's
// lim, the same tiles in the same order, so the output is bit for bit that
// of a walk over every tile of every entry (masked tiles weigh exactly 0),
// and K11c's on the schedule's lengths.  A lane no FIRST entry names gets
// its fresh row alone.  The runs are clamped into [0, S) and to whole
// tiles, so a malformed list reads no row outside the lane's cache.
//
// Bound on the H100: bytes (the valid rows' K and V, read once).
#include "decode_pair_stream.cuh"

namespace {

constexpr int kBlock = 128;      // rows per entry
constexpr int kMaxLanes = 1024;  // lanes whose runs fit the block's table
constexpr int kFirst = 1;

struct Schedule {
  const int* totals;   // (cores,)
  const int* bl;       // (cores, J), as off, lim and flags
  const int* off;
  const int* lim;
  const int* flags;
  int cores, J, per_core;
};

// Every lane's runs from the schedule's live entries, into runs[0, B); all
// threads of the block.
__device__ __forceinline__ void read_runs(const dstream::Args& a, const Schedule& s,
                                          pstream::LaneRuns* runs) {
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    runs[b] = pstream::LaneRuns{0, a.S, a.S};
  }
  __syncthreads();
  const int n = s.cores * s.J;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / s.J;
    const int j = i - c * s.J;
    const int total = s.totals[c];
    const int bl = s.bl[i];
    const int flags = s.flags[i];
    const int lim = s.lim[i];
    const int prev = s.lim[i - (j > 0)];
    const int off = s.off[i];
    const int b = c * s.per_core + bl;
    if (j >= total || bl < 0 || bl >= s.per_core || b >= a.B) continue;
    if (flags & kFirst) {
      runs[b].plen = min(max(lim, 0), a.S);
    } else if (j > 0 && lim != prev) {
      const int pb = min(max(off, 0), a.S) / dstream::kTile * dstream::kTile;
      runs[b].pb = pb;
      runs[b].dend = min(max(lim, pb), a.S);
    }
  }
  __syncthreads();
}

template <int G>
__global__ void __launch_bounds__(pstream::kBlockThreads)
    decode_sched_kernel(dstream::Args a, Schedule s) {
  __shared__ pstream::LaneRuns runs[kMaxLanes];
  read_runs(a, s, runs);
  pstream::run_stream<G, true, const pstream::LaneRuns*>(a, runs, 1);
}

template <int G>
int launch(const dstream::Args& a, const Schedule& s, int blocks, cudaStream_t stream) {
  static gemm::SmemAllowed smem;
  return pstream::launch(decode_sched_kernel<G>, smem, blocks, stream, a, s);
}

}  // namespace

// q (B, Hq, 128), kall/vall (L, B, Hkv, S, 128), k_new/v_new (B, Hkv, 1,
// 128), out (B, Hq, 128) bf16; the schedule's totals (cores,) and bl, off,
// lim, flags (cores, J) int32, built for this S and per_core lanes a core;
// all contiguous on the device.  S is a multiple of 128; Hq / Hkv is 1, 2
// or 4; B <= 1024; blocks >= 1 (the wrapper's: min(B Hkv, SM count)).
// Returns the launch's cudaError_t.
extern "C" int decode_attention_sched_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* totals, const void* bl, const void* off,
    const void* lim, const void* flags, void* out, int layer, int B, int Hq,
    int Hkv, int S, int cores, int per_core, int J, int blocks, float scale,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || S % kBlock || B > kMaxLanes || cores < 0 || per_core < 1 ||
      J < 0 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, nullptr, out,
                                             layer, B, Hkv, S, 0, scale);
  Schedule s;
  s.totals = static_cast<const int*>(totals);
  s.bl = static_cast<const int*>(bl);
  s.off = static_cast<const int*>(off);
  s.lim = static_cast<const int*>(lim);
  s.flags = static_cast<const int*>(flags);
  s.cores = cores;
  s.J = J;
  s.per_core = per_core;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, s, blocks, st);
    case 2: return launch<2>(a, s, blocks, st);
    case 4: return launch<4>(a, s, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
