// K3 and K5: KV-cache row writes, in place.
//
// On the default decode paths K3 and K8 no longer run as kernels of their
// own: the decode attention (K2/K4, K6/K7) stores the fresh rows from its
// fold block (decode_split.cuh, "the fresh rows' store"), with the int8
// rule below, bit for bit.  The standalone K3 serves decode modes "3"/"4",
// whose attention kernels take no write target; K3-int8 and K8 stay as
// the fused stores' oracles.
//
// One bf16 kernel (kv_write_rows_bf16) writes rows[l, b, h, t, :] to
// cache[l, b, h, slots[b] + t, :] for every (l, b, h) and t < T, and drops
// rows whose slot lies outside [0, S).  K3 (T = 1) replaces
// qwen3_asr_tpu/ops/pallas/kv_write.py: kv_write_rows (:260) and
// kv_write_rows_batch (:85): one decode step's fresh K (or V) rows of all
// layers after the layer loop.  Bound on the H100: bytes (459 KB in and out
// at L=28, B=8, T=1), so launch latency.  Design: one thread per 16-byte
// vector (8 bf16), neighbouring threads on neighbouring addresses, so each
// 256-byte target row is stored by 16 neighbouring threads and exactly the
// target rows are touched.  The TPU kernels' read-modify-write tiles (8
// rows for K3, a two-tile window per (layer, lane) for K5) exist only
// because of the TPU's (8, 128) memory tiling and are not carried over.
// The same kernel at T rows is K5's single-cache oracle.
//
// K5 (kv_write_span_pair_bf16) replaces kv_write_span_batch (:156,
// pallas_call :185): the speculative verify pass's T <= 8 rows per lane,
// row t of lane b at slot slots[b] + t, rows outside [0, S) dropped, for
// the K and the V cache in ONE launch (two calls of the TPU kernel).
// Bound: bytes, both caches' landing rows read once and written once (3.7
// MB at L=28, B=8, Hkv=8, T=4: about 1.1 us at the HBM rate), so what
// counts is having all of it in flight at once and one launch, not two.
// Design: one block per (layer, lane) and cache; the block reads its lane's
// slot, computes the rows that land [t0, t1) and returns at once when none
// does (a lane wholly past S reads nothing); each thread then issues
// kSpanVec 16-byte loads of those rows before any of its stores, so a block
// keeps up to 16 KB in flight and the grid's 2 L B blocks are resident
// together.  Every target run (one head's landing rows) is contiguous in
// both the rows and the cache.
//
// The int8 cache (kv_write_rows_q8): the same rows arrive in bf16 and are
// quantized on the way in, with ops/quant_kv.py:quantize_kv's rule per
// 128-wide row (s = max|x| / 127, or 1 for an all-zero row; q =
// clip(round_half_even(x / s), -127, 127), IEEE f32 divide): one launch
// stores the int8 row and its f32 scale, in place of a quantize pass, a
// row write and a scale write.  One half-warp per row: each thread holds 8
// elements, the abs-max is reduced with shuffles inside the half-warp.
//
// K8, the paged pool's writer (kv_write_rows_paged_bf16 and
// kv_write_rows_paged_q8), replaces kv_write.py:kv_write_rows_paged (:219,
// pallas_call :245): row t of lane b lands at pool[l, page[b, t], h,
// off[b, t]] of the page pool (L, n_pages, H, PS, 128), the page clipped to
// [0, n_pages) as the TPU wrapper does (:252), rows whose offset lies
// outside [0, PS) dropped.  The step writes T = 1 row per lane, the
// speculative verify T = gamma + 1 in the same single launch (the TPU
// verify calls its writer T times, decoder.py:1183-1195).  Bound: bytes,
// the same few hundred KB as K3 per step, so launch latency; the design is
// K3's (one thread per 16-byte vector of the target rows; for int8 one
// half-warp per row, quantized on the way in with the same bit-exact rule).
// Several lanes may write the reserved trash page 0 at one offset in one
// launch (idle slots, rows past a slot's table): those stores race, and
// page 0 is never read as a valid row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kVec = 8;                   // bf16 per 16-byte vector
constexpr int kVecPerRow = kD / kVec;     // 16
constexpr int kThreads = 256;

// One thread per 16-byte vector of rows (L, B, H, T, 128), flat in that
// order.
__global__ void kv_write_rows_kernel(__nv_bfloat16* __restrict__ cache,
                                     const __nv_bfloat16* __restrict__ rows,
                                     const int* __restrict__ slots, int B,
                                     int H, int T, int S, int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const int64_t row = i / kVecPerRow;     // flat (l, b, h, t)
  const int v = (int)(i % kVecPerRow);
  const int t = (int)(row % T);
  const int64_t lbh = row / T;            // flat (l, b, h)
  const int b = (int)((lbh / H) % B);
  const int slot = slots[b] + t;
  if (slot < 0 || slot >= S) return;
  const uint4 val = reinterpret_cast<const uint4*>(rows)[i];
  reinterpret_cast<uint4*>(cache + (lbh * S + slot) * kD)[v] = val;
}

__global__ void kv_write_rows_q8_kernel(int8_t* __restrict__ cache_q,
                                        float* __restrict__ cache_s,
                                        const __nv_bfloat16* __restrict__ rows,
                                        const int* __restrict__ slots, int B,
                                        int H, int S, int64_t n_rows) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kVecPerRow;
  if (row >= n_rows) return;      // whole half-warps: n_rows is per 16 lanes
  const int v = threadIdx.x % kVecPerRow;
  const unsigned half_mask = 0xffffu << (threadIdx.x & 16);
  const uint4 raw = reinterpret_cast<const uint4*>(rows)[row * kVecPerRow + v];
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float f[kVec];
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    f[e] = __bfloat162float(x[e]);
    amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int o = kVecPerRow / 2; o >= 1; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(half_mask, amax, o));
  }
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    int q = __float2int_rn(__fdiv_rn(f[e], scale));
    q = max(-127, min(127, q));
    packed[e / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e % 4));
  }
  const int b = (int)((row / H) % B);
  const int slot = slots[b];
  if (slot < 0 || slot >= S) return;
  const int64_t dst = row * S + slot;
  reinterpret_cast<uint2*>(cache_q + dst * kD)[v] = make_uint2(packed[0], packed[1]);
  if (v == 0) cache_s[dst] = scale;
}

// K5: block (l * B + b, cache) copies lane b's landing rows of layer l
// into the K (blockIdx.y == 0) or V cache.
constexpr int kSpanThreads = 128;
constexpr int kSpanVec = 8;   // 16-byte vectors a thread keeps in flight

__global__ void __launch_bounds__(kSpanThreads)
    kv_write_span_kernel(__nv_bfloat16* __restrict__ kcache, __nv_bfloat16* __restrict__ vcache,
                         const __nv_bfloat16* __restrict__ krows,
                         const __nv_bfloat16* __restrict__ vrows,
                         const int* __restrict__ slots, int B, int H, int T, int S) {
  const int lb = blockIdx.x;
  const int64_t slot = slots[lb % B];
  const int64_t lo = slot < 0 ? -slot : 0;
  const int64_t hi = S - slot < T ? S - slot : T;   // rows [lo, hi) land
  if (hi <= lo) return;
  const int t0 = (int)lo, t1 = (int)hi;
  const uint4* src = reinterpret_cast<const uint4*>((blockIdx.y ? vrows : krows) +
                                                    (int64_t)lb * H * T * kD);
  uint4* dst = reinterpret_cast<uint4*>((blockIdx.y ? vcache : kcache) +
                                        ((int64_t)lb * H * S + slot + t0) * kD);
  const int per_head = (t1 - t0) * kVecPerRow;    // one head's landing vectors
  const int n = H * per_head;
  for (int base = 0; base < n; base += kSpanThreads * kSpanVec) {
    uint4 val[kSpanVec];
    int64_t to[kSpanVec];
#pragma unroll
    for (int u = 0; u < kSpanVec; ++u) {
      const int k = base + u * kSpanThreads + threadIdx.x;
      to[u] = -1;
      if (k < n) {
        const int h = k / per_head;
        const int rem = k - h * per_head;
        to[u] = (int64_t)h * S * kVecPerRow + rem;
        val[u] = src[(h * T + t0) * kVecPerRow + rem];
      }
    }
#pragma unroll
    for (int u = 0; u < kSpanVec; ++u) {
      if (to[u] >= 0) dst[to[u]] = val[u];
    }
  }
}

// Rows (L, B, H, T, 128), flat in that order; pages and offs (B, T).
__device__ __forceinline__ int64_t paged_row(int64_t row, int B, int H, int T,
                                             const int* pages, const int* offs,
                                             int n_pages, int PS) {
  const int t = (int)(row % T);
  const int64_t lbh = row / T;
  const int h = (int)(lbh % H);
  const int64_t lb = lbh / H;
  const int b = (int)(lb % B);
  const int64_t l = lb / B;
  const int off = offs[b * T + t];
  if (off < 0 || off >= PS) return -1;
  const int page = min(max(pages[b * T + t], 0), n_pages - 1);
  return ((l * n_pages + page) * H + h) * PS + off;
}

__global__ void kv_write_rows_paged_kernel(__nv_bfloat16* __restrict__ pool,
                                           const __nv_bfloat16* __restrict__ rows,
                                           const int* __restrict__ pages,
                                           const int* __restrict__ offs, int B,
                                           int H, int T, int n_pages, int PS,
                                           int64_t n_vec) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const int64_t dst = paged_row(i / kVecPerRow, B, H, T, pages, offs, n_pages, PS);
  if (dst < 0) return;
  reinterpret_cast<uint4*>(pool + dst * kD)[i % kVecPerRow] =
      reinterpret_cast<const uint4*>(rows)[i];
}

__global__ void kv_write_rows_paged_q8_kernel(int8_t* __restrict__ pool_q,
                                              float* __restrict__ pool_s,
                                              const __nv_bfloat16* __restrict__ rows,
                                              const int* __restrict__ pages,
                                              const int* __restrict__ offs,
                                              int B, int H, int T, int n_pages,
                                              int PS, int64_t n_rows) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kVecPerRow;
  if (row >= n_rows) return;      // whole half-warps: n_rows is per 16 lanes
  const int v = threadIdx.x % kVecPerRow;
  const unsigned half_mask = 0xffffu << (threadIdx.x & 16);
  const uint4 raw = reinterpret_cast<const uint4*>(rows)[row * kVecPerRow + v];
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float f[kVec];
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    f[e] = __bfloat162float(x[e]);
    amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int o = kVecPerRow / 2; o >= 1; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(half_mask, amax, o));
  }
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    int q = __float2int_rn(__fdiv_rn(f[e], scale));
    q = max(-127, min(127, q));
    packed[e / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e % 4));
  }
  const int64_t dst = paged_row(row, B, H, T, pages, offs, n_pages, PS);
  if (dst < 0) return;
  reinterpret_cast<uint2*>(pool_q + dst * kD)[v] = make_uint2(packed[0], packed[1]);
  if (v == 0) pool_s[dst] = scale;
}

}  // namespace

// K8: pool (L, n_pages, H, PS, 128) bf16; rows (L, B, H, T, 128) bf16;
// pages and offs (B, T) int32; all on the device and contiguous.  Returns
// the launch's cudaError_t.
extern "C" int kv_write_rows_paged_bf16(void* pool, const void* rows,
                                        const void* pages, const void* offs,
                                        int L, int B, int H, int T, int n_pages,
                                        int PS, void* stream) {
  const int64_t n_vec = (int64_t)L * B * H * T * kVecPerRow;
  if (n_vec == 0) return (int)cudaSuccess;
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  kv_write_rows_paged_kernel<<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(pool), static_cast<const __nv_bfloat16*>(rows),
      static_cast<const int*>(pages), static_cast<const int*>(offs), B, H, T,
      n_pages, PS, n_vec);
  return (int)cudaGetLastError();
}

// K8 on the int8 pool: pool_q (L, n_pages, H, PS, 128) int8 and pool_s
// (L, n_pages, H, PS) f32; rows, pages and offs as kv_write_rows_paged_bf16.
extern "C" int kv_write_rows_paged_q8(void* pool_q, void* pool_s, const void* rows,
                                      const void* pages, const void* offs, int L,
                                      int B, int H, int T, int n_pages, int PS,
                                      void* stream) {
  const int64_t n_rows = (int64_t)L * B * H * T;
  if (n_rows == 0) return (int)cudaSuccess;
  const int64_t blocks = (n_rows * kVecPerRow + kThreads - 1) / kThreads;
  kv_write_rows_paged_q8_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      static_cast<int8_t*>(pool_q), static_cast<float*>(pool_s),
      static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(pages),
      static_cast<const int*>(offs), B, H, T, n_pages, PS, n_rows);
  return (int)cudaGetLastError();
}

// cache (L, B, H, S, 128) bf16; rows (L, B, H, T, 128) bf16; slots (B,)
// int32 (lane b's first slot); all on the device and contiguous.  Returns
// the launch's cudaError_t.
extern "C" int kv_write_rows_bf16(void* cache, const void* rows,
                                  const void* slots, int L, int B, int H,
                                  int T, int S, void* stream) {
  const int64_t n_vec = (int64_t)L * B * H * T * kVecPerRow;
  if (n_vec == 0) return (int)cudaSuccess;
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  kv_write_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(cache),
      static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(slots),
      B, H, T, S, n_vec);
  return (int)cudaGetLastError();
}

// K5: kcache/vcache (L, B, H, S, 128) bf16; krows/vrows (L, B, H, T, 128)
// bf16; slots (B,) int32 (lane b's first slot); all on the device and
// contiguous.  Returns the launch's cudaError_t.
extern "C" int kv_write_span_pair_bf16(void* kcache, void* vcache, const void* krows,
                                       const void* vrows, const void* slots, int L, int B,
                                       int H, int T, int S, void* stream) {
  if ((int64_t)L * B * H * T == 0) return (int)cudaSuccess;
  kv_write_span_kernel<<<dim3(L * B, 2), kSpanThreads, 0, (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(kcache), static_cast<__nv_bfloat16*>(vcache),
      static_cast<const __nv_bfloat16*>(krows), static_cast<const __nv_bfloat16*>(vrows),
      static_cast<const int*>(slots), B, H, T, S);
  return (int)cudaGetLastError();
}

// cache_q (L, B, H, S, 128) int8 and cache_s (L, B, H, S) f32; rows
// (L, B, H, 1, 128) bf16; slots (B,) int32; all on the device and
// contiguous.  Returns the launch's cudaError_t.
extern "C" int kv_write_rows_q8(void* cache_q, void* cache_s, const void* rows,
                                const void* slots, int L, int B, int H, int S,
                                void* stream) {
  const int64_t n_rows = (int64_t)L * B * H;
  if (n_rows == 0) return (int)cudaSuccess;
  const int64_t blocks = (n_rows * kVecPerRow + kThreads - 1) / kThreads;
  kv_write_rows_q8_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<int8_t*>(cache_q), static_cast<float*>(cache_s),
      static_cast<const __nv_bfloat16*>(rows), static_cast<const int*>(slots),
      B, H, S, n_rows);
  return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the Python wrappers' error messages.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
