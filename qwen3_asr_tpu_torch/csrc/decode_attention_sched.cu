// K11d: one-token decode attention over a precomputed flat block schedule.
//
// Replaces qwen3_asr_tpu/ops/pallas/experiments/decode_attention_sched.py:
// decode_attention_sched (:280; kernel _kernel :146, pallas_call :360).
// Tile loads, online softmax, self-term and numerics: decode_stream.cuh.
//
// The schedule (build_decode_schedule, :70, ported in plain torch) lists for
// each "core" c its 128-row blocks in lane order: entry j < totals[c] is
// lane c * per_core + bl[c, j], cache rows [off, off + 128), valid while
// row < lim, with first/last-of-lane flags.  The TPU kernel walks that list
// in ONE loop with no on-the-fly discovery: prefetch entry j + NBUF - 1, wait
// entry j, one tile update, reset the carry on FIRST, finalize on LAST.
//
// Here one CUDA block owns one (core, KV head) and walks the same list as
// four 32-row tiles per entry through a 6-stage cp.async ring (the TPU ring
// is 6 deep, :61; a stage is a 32-row K + V tile, 16 KB, so 96 KB a block
// and two blocks per SM).  A 32-row tile never straddles two entries, so the
// mask is the single compare row < lim of the tile's entry; the state is
// reset on the FIRST entry's first tile and finalized (self-term, 1 / l) as
// the LAST entry's last tile drains.  A lane never straddles two blocks, so
// there is no combine pass.  How many cores share the list is the wrapper's
// choice for the H100 (enough (core, KV head) blocks to fill the SMs), not
// the TPU's 2.
//
// Bound on the H100: bytes (the valid rows' K and V, read once).  The walk
// also reads the masked tail of each lane's last prompt and decode block.
#include "decode_stream.cuh"

namespace {

constexpr int kStages = 6;
constexpr int kBlock = 128;                               // rows per entry
constexpr int kTilesPerEntry = kBlock / dstream::kTile;   // 4
constexpr int kFirst = 1;
constexpr int kLast = 2;

struct Schedule {
  const int* totals;   // (cores,)
  const int* bl;       // (cores, J), as off, lim and flags
  const int* off;
  const int* lim;
  const int* flags;
  int J, per_core;
};

template <int G>
__global__ void __launch_bounds__(dstream::kThreads)
    decode_sched_kernel(dstream::Args a, Schedule s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ dstream::Shared<G> sh;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto kbuf = [&](int stage) { return ring + stage * 2 * dstream::kTileElems; };
  auto vbuf = [&](int stage) {
    return ring + stage * 2 * dstream::kTileElems + dstream::kTileElems;
  };

  const int core = blockIdx.x / a.Hkv;
  const int hk = blockIdx.x - core * a.Hkv;
  const int64_t e0 = (int64_t)core * s.J;           // this core's row of entries
  const int n_tiles = min(max(s.totals[core], 0), s.J) * kTilesPerEntry;
  auto lane_of = [&](int t) { return core * s.per_core + s.bl[e0 + t / kTilesPerEntry]; };
  auto row_of = [&](int t) {
    return s.off[e0 + t / kTilesPerEntry] + (t % kTilesPerEntry) * dstream::kTile;
  };
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int stage = t % kStages;
      dstream::load_rows(a, lane_of(t), hk, row_of(t), kbuf(stage), vbuf(stage));
    }
    gemm::cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  dstream::State<G> st;
  for (int t = 0; t < n_tiles; ++t) {
    gemm::cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(t + kStages - 1);   // the stage consumed at t - 1: all threads are past it
    const int e = t / kTilesPerEntry;
    const int sub = t - e * kTilesPerEntry;
    const int flags = s.flags[e0 + e];
    const int lim = s.lim[e0 + e];
    dstream::Pair p;
    p.b = lane_of(t);
    p.hk = hk;
    const bool live = p.b >= 0 && p.b < a.B;
    if (sub == 0 && (flags & kFirst) && live) dstream::start_pair<G>(a, p, st);
    const int stage = t % kStages;
    dstream::fold_tile<G>(row_of(t), [&](int row) { return row < lim; }, kbuf(stage),
                          vbuf(stage), st, sh);
    if (sub == kTilesPerEntry - 1 && (flags & kLast) && live) {
      dstream::finish_pair<G>(a, p, st, sh);
    }
  }
  gemm::cp_async_wait<0>();
}

template <int G>
int launch(const dstream::Args& a, const Schedule& s, int cores, cudaStream_t stream) {
  constexpr int bytes = dstream::ring_bytes(kStages);
  static bool smem_ok = false;
  cudaError_t err = gemm::allow_smem(decode_sched_kernel<G>, bytes, smem_ok);
  if (err != cudaSuccess) return (int)err;
  decode_sched_kernel<G><<<cores * a.Hkv, dstream::kThreads, bytes, stream>>>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, 128), kall/vall (L, B, Hkv, S, 128), k_new/v_new (B, Hkv, 1,
// 128), out (B, Hq, 128) bf16; the schedule's totals (cores,) and bl, off,
// lim, flags (cores, J) int32, built for this S and per_core lanes a core;
// all contiguous on the device.  S is a multiple of 128; Hq / Hkv is 1, 2
// or 4.  Lanes no entry names keep whatever out held.  Returns the launch's
// cudaError_t.
extern "C" int decode_attention_sched_bf16(
    const void* q, const void* kall, const void* vall, const void* k_new,
    const void* v_new, const void* totals, const void* bl, const void* off,
    const void* lim, const void* flags, void* out, int layer, int B, int Hq,
    int Hkv, int S, int cores, int per_core, int J, float scale, void* stream) {
  if (B == 0 || cores == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || S % kBlock || cores < 0 || per_core < 1 || J < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dstream::Args a = dstream::make_args(q, kall, vall, k_new, v_new, nullptr, out,
                                             layer, B, Hkv, S, 0, 0, kBlock, scale);
  Schedule s;
  s.totals = static_cast<const int*>(totals);
  s.bl = static_cast<const int*>(bl);
  s.off = static_cast<const int*>(off);
  s.lim = static_cast<const int*>(lim);
  s.flags = static_cast<const int*>(flags);
  s.J = J;
  s.per_core = per_core;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(a, s, cores, st);
    case 2: return launch<2>(a, s, cores, st);
    case 4: return launch<4>(a, s, cores, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
