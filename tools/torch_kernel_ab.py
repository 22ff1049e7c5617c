#!/usr/bin/env python3
"""A/B of the port's redesigned kernels against an earlier version of their
CUDA sources, on one CUDA GPU, in one process.

    python3 tools/torch_kernel_ab.py --parent DIR [--rounds N]
        [--kernels K1,K11e,K9,K10,K2,K4,K6,K7,K5,K11a,K11b,K11c,K11d]

``DIR`` holds earlier ``flash_attention.cu`` (K1), ``conv_stem.cu`` (K11e),
``quantized_matmul.cu`` (K9), ``w8a8_matmul.cu`` (K10),
``decode_attention.cu`` (K2 and K4), ``decode_attention_paged.cu`` (K6
and K7), ``kv_write.cu`` (K5), ``decode_attention_hbm2.cu`` (K11a),
``decode_attention_hbm3.cu`` (K11b), ``decode_attention_hbm5.cu``
(K11c) and ``decode_attention_sched.cu`` (K11d) with the headers they include, e.g. from
``git show <commit>:qwen3_asr_tpu_torch/csrc/<file>``.
The tool compiles the ones that ``--kernels`` names with the port's nvcc
flags into a library of their own (in ``DIR``), binds their C entry points
with the signatures of :data:`PARENT_SIGNATURES` (K1's and K11e's are the
port's; K2's, K4's, K6's and K7's are those of commit 76a5270, whose decode
attention takes no write target; K5's that of commit f57a6e0; K11a's and
K11b's those of commits f0ebdf1 to df68cd9, whose decode end is an int
argument where the change reads it from a 0-d int32 tensor on the device;
K11c's the port's, as in commit f0ebdf1; K11d's that of commit f0ebdf1,
whose grid was the schedule's cores), and then, on the same
inputs:

  * says whether the two versions' outputs are bit-identical, and holds
    both to the plain PyTorch version (K1: f32 causal attention, atol 2e-2
    + rtol 2e-2; K11e: the f32 tap sum + bias rounded to bf16, then the
    exact GELU, atol 2e-2 + rtol 2e-2; K9: the f32 product of the same int8
    weights, atol 1e-5 max|ref| + rtol 8e-3 (bf16 out) or 1e-5 (f32 out);
    K10: bit-exact);
  * times them in turns, parent, change, change, parent, per round, with
    CUDA events (the mean over 20 calls, 10 for K11e, after a warm-up; K9
    by device time, 20 calls captured in a CUDA graph, with the wrapper's
    host microseconds per call beside),
    beside the library calls (``scaled_dot_product_attention`` causal with
    GQA; cuDNN's ``F.conv2d`` with bias on channels-last data; for K9
    ``torch._weight_int8pack_mm`` and bf16 ``torch.matmul`` of x with the
    dequantized weights; for K10 ``torch._int_mm`` on already quantized
    operands, cuBLAS's int8 product alone, and that bf16 ``torch.matmul``)
    and the bound (bytes over 3.35 TB/s or operations over 989 bf16
    TFLOP/s or 1979 int8 TOP/s, whichever is larger).  K10's times are the
    wrapper's whole device work on both sides: the parent's row scales
    (``activation_scales``) and fused-quantize kernel, the change's
    quantize pass and GEMM.  The parent's K9 and K10 read the (K, N)
    row-major weight, the change the K-major one; both copies are made
    before the timing.  K2 and K4 (decode attention over the bf16 and the
    int8 cache) and K6 and K7 (the paged step and verify, each over the
    bf16 and the int8 pool) are held to their plain versions (atol 2e-2 +
    rtol 2e-2) and to the parent bit for bit, and timed in turns by device
    time on a cold cache (``chip_smoke.attention_ms``: CUDA graphs of calls
    rotated over enough layers of one cache that the calls between two on
    one layer read more than the 50 MB L2), the host-paced ms, the bound and
    the share of the HBM peak beside; medians over the rounds.  The change's
    K2/K4/K6/K7 run with their fused store (``write_slots``, or
    ``write_pages``/``write_offsets``, at ``chip_smoke``'s write targets:
    ``decode_write_slots``, ``paged_case``), the parent's without one, so
    the difference is the store's cost inside the launch; the outputs are
    held bit for bit; the wrappers' host microseconds per call (the
    change's with and without its store, the parent's) are printed beside.
    For K6 and K7 ``torch.profiler`` also counts the kernels a call runs
    on the card, at ``chip_smoke.PAGED_ROW``.  K5: the parent's
    single-cache span writer launched twice (K, then V) against the
    change's one ``kv_write_span_pair`` launch at ``chip_smoke``'s verify
    shape (L=28, B=8, T=4, S=640, an overflow lane and a lane wholly past
    S), both caches held bit for bit to each other and to the plain
    version, device time in CUDA graphs of 20 calls in turns.  K11a and
    K11b: the parent (with its wrapper's arguments) and the change at
    ``chip_smoke``'s ``DECODE_GRID`` and ``STREAM_EXTRA`` on
    ``stream_case`` inputs, bit identity or the max |difference| (and the
    change's K11a against K11b), both held to the plain version (atol 2e-2
    + rtol 2e-2), device time on a cold cache in turns with K2 on the same
    inputs beside, the bound and the HBM share.  K11c: the same at
    ``chip_smoke.LANES_GRID`` (per-lane ends, an idle lane, and one lane at
    S with the rest at the prompt bucket); K11d the same, on a schedule
    built beforehand, with K11c on the same inputs in the same turns and
    the change held to it bit for bit.

Shapes: K1 at B=8 and B=64 (Hq 16, Hkv 8, D 128), T=448, the main path's
largest smoke prefill and the micro-bench's ``prefill64``; K11e at conv2's
and conv3's shapes for the smoke's 256 chunks; K9 at ``chip_smoke``'s
``DECODE_MATMULS`` for M = 1, 8 and 96 and the decoder layer's four
products at M = 448 and 3584; K10 at ``PREFILL_MATMULS``; K2 and K4 at
``chip_smoke``'s ``DECODE_GRID`` (B = 1, 8, 96 x S = 640, 2560, prompt
bucket 512, Hq 16, Hkv 8, random lengths, an idle lane); K6 (T = 1) and K7
(T = 4) at ``chip_smoke``'s ``PAGED_GRID`` (B = 1, 8, 64 x dcount 64, 1024
at PS 256, and B=8 dcount 64 at PS 128; the smoke clips' prompt lengths,
an idle lane, shuffled pages).  The first line
is the card's ``nvidia-smi`` name and power limit; the last line one JSON
object with every reading.  Needs a CUDA device and ``nvcc``; exits
non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLASH_SHAPES = ((8, 448), (64, 448))
HQ, HKV, D = 16, 8, 128


_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signatures of the earlier entry points (K9 and K10: the sources of
#: commit 34480f7, which read (K, N) row-major weights).
PARENT_SIGNATURES = {
    "flash_attention_causal_bf16": None,     # the port's own signature
    "conv_s2_gelu_bf16": None,
    # x, wq (K, N) row-major, s, out, M, N, K, out_f32, stream
    "quantized_matmul_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, sx, wq (K, N) row-major, ws, out, M, N, K, out_f32, stream
    "w8a8_matmul_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # K2/K4 of commit 76a5270 (one launch, no write target): q, kall, vall,
    # k_new, v_new, prompt_len, decode_end, ws, counters, out, layer, B, Hq,
    # Hkv, S, prompt_bucket, splits, scale, stream
    "decode_attention_bf16": (_P,) * 10 + (_I,) * 7 + (ctypes.c_float, _P),
    # q, kall, vall, kscale, vscale, then as decode_attention_bf16
    "decode_attention_q8": (_P,) * 12 + (_I,) * 7 + (ctypes.c_float, _P),
    # K6/K7 of commit 76a5270 (one launch, no write target): q, kpool,
    # vpool, k_new, v_new, table, prompt_len, decode_count, ws, counters,
    # out, layer, B, Hq, Hkv, T, n_pages, PS, max_pages, splits, scale,
    # stream
    "decode_attention_paged_bf16": (_P,) * 11 + (_I,) * 9 + (ctypes.c_float, _P),
    # q, kpool, vpool, kscale, vscale, then as decode_attention_paged_bf16
    "decode_attention_paged_q8": (_P,) * 13 + (_I,) * 9 + (ctypes.c_float, _P),
    # K5 of commit f57a6e0 (one cache a launch): cache, rows, slots, L, B,
    # H, T, S, stream
    "kv_write_rows_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # K11a, K11b of commits f0ebdf1 to df68cd9 (the decode end an int):
    # q, kall, vall, k_new, v_new, prompt_len, out, layer, B, Hq, Hkv, S,
    # prompt_bucket, decode_end, block_k, per, scale, stream
    "decode_attention_hbm2_bf16": (_P,) * 7 + (_I,) * 9 + (ctypes.c_float, _P),
    "decode_attention_hbm3_bf16": (_P,) * 7 + (_I,) * 9 + (ctypes.c_float, _P),
    # K11c: the port's signature (commit f0ebdf1's)
    "decode_attention_hbm5_bf16": None,
    # K11d of commit f0ebdf1 (a block per core and KV head): q, kall, vall,
    # k_new, v_new, totals, bl, off, lim, flags, out, layer, B, Hq, Hkv, S,
    # cores, per_core, J, scale, stream
    "decode_attention_sched_bf16": (_P,) * 11 + (_I,) * 8 + (ctypes.c_float, _P),
}
SOURCES = {"K1": "flash_attention.cu", "K11e": "conv_stem.cu", "K9": "quantized_matmul.cu",
           "K10": "w8a8_matmul.cu", "K2": "decode_attention.cu", "K4": "decode_attention.cu",
           "K6": "decode_attention_paged.cu", "K7": "decode_attention_paged.cu",
           "K5": "kv_write.cu", "K11a": "decode_attention_hbm2.cu",
           "K11b": "decode_attention_hbm3.cu", "K11c": "decode_attention_hbm5.cu",
           "K11d": "decode_attention_sched.cu"}
PAGED_ENTRIES = ("decode_attention_paged_bf16", "decode_attention_paged_q8")
ENTRIES = {"K1": ("flash_attention_causal_bf16",), "K11e": ("conv_s2_gelu_bf16",),
           "K9": ("quantized_matmul_bf16",), "K10": ("w8a8_matmul_bf16",),
           "K2": ("decode_attention_bf16",), "K4": ("decode_attention_q8",),
           "K6": PAGED_ENTRIES, "K7": PAGED_ENTRIES, "K5": ("kv_write_rows_bf16",),
           "K11a": ("decode_attention_hbm2_bf16",), "K11b": ("decode_attention_hbm3_bf16",),
           "K11c": ("decode_attention_hbm5_bf16",), "K11d": ("decode_attention_sched_bf16",)}


def parent_library(parent: Path, kernels: list[str]) -> ctypes.CDLL:
    """Compile the parent's sources of ``kernels`` into ``parent/libparent.so``."""
    from qwen3_asr_tpu_torch.ops.kernels import _build

    sources = sorted({parent / SOURCES[k] for k in kernels})
    for src in sources:
        if not src.is_file():
            raise SystemExit(f"torch_kernel_ab: {src} is missing")
    nvcc = _build._nvcc()
    objects = [src.with_suffix(".o") for src in sources]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                     for s, o in zip(sources, objects)])
    lib_path = parent / "libparent.so"
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                      *map(str, objects)]])
    lib = ctypes.CDLL(str(lib_path))
    for name in {n for k in kernels for n in ENTRIES[k]}:
        fn = getattr(lib, name)
        fn.argtypes = list(PARENT_SIGNATURES[name] or _build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def run_flash(lib, q, k, v):
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    out = torch.empty_like(q)
    err = lib.flash_attention_causal_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1],
        k.shape[1], q.shape[2], float(q.shape[3] ** -0.5), _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"parent flash_attention_causal_bf16: CUDA error {err}")
    return out


def run_conv(lib, x, w, b):
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    N, H, W, C = x.shape
    O = w.shape[-1]
    out = torch.empty((N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, O), dtype=x.dtype,
                      device=x.device)
    err = lib.conv_s2_gelu_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                N, H, W, C, O, _build.stream_ptr(x))
    if err:
        raise RuntimeError(f"parent conv_s2_gelu_bf16: CUDA error {err}")
    return out


def in_turns(parent_fn, change_fn, rounds: int, iters: int, timer=None) -> tuple[list, list]:
    """Times of parent and change, parent, change, change, parent per round
    (``timer(fn, iters=...)``, by default ``chip_smoke.cuda_ms``)."""
    from chip_smoke import cuda_ms

    timer = timer or cuda_ms
    p, c = [], []
    for _ in range(rounds):
        p.append(timer(parent_fn, iters=iters))
        c.append(timer(change_fn, iters=iters))
        c.append(timer(change_fn, iters=iters))
        p.append(timer(parent_fn, iters=iters))
    return p, c


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call of a wrapper whose device work is shorter
    than its host work: wall time of ``iters`` calls, then one sync."""
    import time

    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def ab_flash(lib, gen, rounds: int) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from chip_smoke import PEAK_BF16_TFLOPS, _close, bound, cuda_ms
    from qwen3_asr_tpu_torch.ops.kernels import flash_attention as fa

    rows = []
    for B, T in FLASH_SHAPES:
        q = torch.randn(B, HQ, T, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, HKV, T, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, HKV, T, D, generator=gen, device="cuda").bfloat16()
        ref = fa.flash_attention_causal_plain(q.float(), k.float(), v.float())
        out, pout = fa.flash_attention_causal(q, k, v), run_flash(lib, q, k, v)
        err = _close(f"K1 B={B} T={T}", out, ref, 2e-2, 2e-2)
        perr = _close(f"parent K1 B={B} T={T}", pout, ref, 2e-2, 2e-2)
        same = torch.equal(out, pout)
        del out, pout, ref
        p, c = in_turns(lambda: run_flash(lib, q, k, v),
                        lambda: fa.flash_attention_causal(q, k, v), rounds, 20)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        flops = 4 * B * HQ * D * T * (T + 1) / 2
        b = bound(2 * B * T * D * (2 * HQ + 2 * HKV), flops, PEAK_BF16_TFLOPS * 1e12)
        row = {"kernel": "K1", "B": B, "T": T, "max_abs_err": err, "parent_max_abs_err": perr,
               "bit_identical": same,
               "ms": c, "parent_ms": p, "library_ms": library_ms, **b}
        print(f"K1 B={B} T={T}: change {statistics.median(c):.4f} ms {[round(x, 4) for x in c]}, "
              f"parent {statistics.median(p):.4f} ms {[round(x, 4) for x in p]}, sdpa "
              f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) = "
              f"{b['bound_ms'] / statistics.median(c):.1%} of the change's time; err "
              f"{err:.3e} / parent {perr:.3e}; outputs bit-identical: {same}")
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def ab_conv(lib, gen, rounds: int) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from chip_smoke import PEAK_BF16_TFLOPS, STEM_CONVS, _close, bound, cuda_ms
    from qwen3_asr_tpu_torch.ops.kernels.experiments import conv_stem as cs

    rows = []
    for name, N, H, W, C in STEM_CONVS:
        x = torch.randn(N, H, W, C, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(3, 3, C, C, generator=gen, device="cuda")).bfloat16()
        b = 0.1 * torch.randn(C, generator=gen, device="cuda")
        ref = cs.conv_s2_gelu_plain(x, w, b)
        out, pout = cs.conv_s2_gelu(x, w, b), run_conv(lib, x, w, b)
        err = _close(f"K11e {name}", out, ref, 2e-2, 2e-2)
        perr = _close(f"parent K11e {name}", pout, ref, 2e-2, 2e-2)
        same = torch.equal(out, pout)
        del out, pout, ref
        p, c = in_turns(lambda: run_conv(lib, x, w, b), lambda: cs.conv_s2_gelu(x, w, b),
                        rounds, 10)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.bfloat16()
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, b16, stride=2, padding=1), iters=10)
        Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
        flops = 2 * N * Ho * Wo * C * 9 * C
        bnd = bound(x.numel() * 2 + w.numel() * 2 + C * 4 + N * Ho * Wo * C * 2, flops,
                    PEAK_BF16_TFLOPS * 1e12)
        cm = statistics.median(c)
        print(f"K11e {name} N={N} {H}x{W}x{C}: change {cm:.4f} ms {[round(x_, 4) for x_ in c]}, "
              f"parent {statistics.median(p):.4f} ms {[round(x_, 4) for x_ in p]}, F.conv2d+bias "
              f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
              f"change {flops / (cm * 1e-3) / 1e12 / PEAK_BF16_TFLOPS:.1%} of the bf16 peak; "
              f"err {err:.3e} / parent {perr:.3e}; outputs bit-identical: {same}")
        rows.append({"kernel": "K11e", "conv": name, "N": N, "max_abs_err": err,
                     "bit_identical": same,
                     "parent_max_abs_err": perr, "ms": c, "parent_ms": p,
                     "library_ms": library_ms, **bnd})
        del x, w, x_cl, w_cl
        torch.cuda.empty_cache()
    return rows


def run_parent_qmm(lib, x, wq_rm, s, out_dtype):
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    M, K = x.shape
    N = wq_rm.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = lib.quantized_matmul_bf16(x.data_ptr(), wq_rm.data_ptr(), s.data_ptr(), out.data_ptr(),
                                    M, N, K, int(out_dtype == torch.float32),
                                    _build.stream_ptr(x))
    if err:
        raise RuntimeError(f"parent quantized_matmul_bf16: CUDA error {err}")
    return out


def run_parent_w8a8(lib, x, wq_rm, ws, out_dtype):
    """The parent wrapper's device work: the row scales, then the kernel."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import activation_scales

    M, K = x.shape
    N = wq_rm.shape[1]
    sx = activation_scales(x)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = lib.w8a8_matmul_bf16(x.data_ptr(), sx.data_ptr(), wq_rm.data_ptr(), ws.data_ptr(),
                               out.data_ptr(), M, N, K, int(out_dtype == torch.float32),
                               _build.stream_ptr(x))
    if err:
        raise RuntimeError(f"parent w8a8_matmul_bf16: CUDA error {err}")
    return out


def _ms_list(xs) -> list:
    return [round(x, 4) for x in xs]


def ab_qmm(lib, gen, rounds: int) -> list[dict]:
    import torch

    from chip_smoke import (DECODE_MATMULS, K9_PREFILL_MATMULS, PEAK_BF16_TFLOPS,
                            PEAK_HBM_GBPS, _close, bound, cuda_ms, graph_ms, k_major_int8,
                            weight_int8pack_ms)
    from qwen3_asr_tpu_torch.ops.kernels import quantized_matmul as qm

    shapes = [(name, B, K, N) for B in (1, 8, 96) for name, K, N in DECODE_MATMULS]
    rows = []
    for name, M, K, N in shapes + list(K9_PREFILL_MATMULS):
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        wq = k_major_int8(gen, K, N)
        wq_rm = wq.contiguous()
        s = torch.rand(N, generator=gen, device="cuda") * 1e-3
        ref = x.float() @ (wq.float() * s)
        rtol = 1e-5 if out_dtype == torch.float32 else 8e-3
        atol = 1e-5 * ref.abs().max().item()
        out = qm.quantized_matmul(x, wq, s, out_dtype)
        pout = run_parent_qmm(lib, x, wq_rm, s, out_dtype)
        err = _close(f"K9 {name} M={M}", out, ref, atol, rtol)
        perr = _close(f"parent K9 {name} M={M}", pout, ref, atol, rtol)
        same = torch.equal(out, pout)
        del out, pout, ref
        parent_fn = lambda: run_parent_qmm(lib, x, wq_rm, s, out_dtype)  # noqa: E731
        change_fn = lambda: qm.quantized_matmul(x, wq, s, out_dtype)      # noqa: E731
        # Device time: 20 calls in a CUDA graph (the host-paced reading of a
        # decode product is the wrapper's Python time).
        p, c = in_turns(parent_fn, change_fn, rounds, 20, timer=graph_ms)
        p_host, c_host = host_us(parent_fn), host_us(change_fn)
        pack_ms = weight_int8pack_ms(x, wq, s) if out_dtype == torch.bfloat16 else None
        w16 = (wq.float() * s).bfloat16()
        bf16_ms = cuda_ms(lambda: torch.matmul(x, w16))
        del w16
        nbytes = K * N + M * K * 2 + M * N * (4 if out_dtype == torch.float32 else 2) + N * 4
        b = bound(nbytes, 2 * M * K * N, PEAK_BF16_TFLOPS * 1e12)
        cm, pm = statistics.median(c), statistics.median(p)
        gbps = nbytes / (cm * 1e-3) / 1e9
        tflops = 2 * M * K * N / (cm * 1e-3) / 1e12
        pk = "n/a" if pack_ms is None else f"{pack_ms:.4f} ms"
        print(f"K9 {name} M={M} K={K} N={N}: change {cm:.4f} ms {_ms_list(c)}, parent "
              f"{pm:.4f} ms {_ms_list(p)}, _weight_int8pack_mm {pk}, bf16 matmul "
              f"{bf16_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) = "
              f"{b['bound_ms'] / cm:.1%} of the change's time ({gbps:.0f} GB/s = "
              f"{gbps / PEAK_HBM_GBPS:.1%} of HBM, {tflops:.1f} TFLOP/s = "
              f"{tflops / PEAK_BF16_TFLOPS:.1%} of bf16); host per call {c_host:.1f} us / "
              f"parent {p_host:.1f} us; err {err:.3e} / parent {perr:.3e}; "
              f"bit-identical: {same}")
        rows.append({"kernel": "K9", "product": name, "M": M, "K": K, "N": N,
                     "max_abs_err": err, "parent_max_abs_err": perr, "bit_identical": same,
                     "ms": c, "parent_ms": p, "host_us": c_host, "parent_host_us": p_host,
                     "weight_int8pack_ms": pack_ms,
                     "bf16_matmul_ms": bf16_ms, **b})
        del x, wq, wq_rm
        torch.cuda.empty_cache()
    return rows


def ab_w8a8(lib, gen, rounds: int) -> list[dict]:
    import torch

    from chip_smoke import (PEAK_INT8_TOPS, PREFILL_MATMULS, bound, cuda_ms,
                            int_mm_ms_or_none, k_major_int8)
    from qwen3_asr_tpu_torch.ops.kernels import w8a8_matmul as w8

    rows = []
    for name, M, K, N in PREFILL_MATMULS:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        x[1] = 0
        wq = k_major_int8(gen, K, N)
        wq_rm = wq.contiguous()
        ws = torch.rand(N, generator=gen, device="cuda") * 1e-3
        for dt in (torch.float32, torch.bfloat16):
            ref = w8.w8a8_matmul_plain(x, wq, ws, dt)
            out = w8.w8a8_matmul(x, wq, ws, dt)
            pout = run_parent_w8a8(lib, x, wq_rm, ws, dt)
            if not (torch.equal(out, ref) and torch.equal(pout, ref)):
                raise AssertionError(f"K10 {name} {dt}: change {torch.equal(out, ref)}, "
                                     f"parent {torch.equal(pout, ref)} bit-exact to the plain")
        del out, pout, ref
        p, c = in_turns(lambda: run_parent_w8a8(lib, x, wq_rm, ws, torch.bfloat16),
                        lambda: w8.w8a8_matmul(x, wq, ws, torch.bfloat16), rounds, 20)
        xq, _ = w8.quantize_rows(x)
        int_mm = int_mm_ms_or_none(xq, wq)
        w16 = (wq.float() * ws).bfloat16()
        bf16_ms = cuda_ms(lambda: torch.matmul(x, w16))
        del w16, xq
        b = bound(M * K * 2 + K * N + M * N * 2 + N * 4, 2 * M * N * K, PEAK_INT8_TOPS * 1e12)
        cm, pm = statistics.median(c), statistics.median(p)
        tops = 2 * M * N * K / (cm * 1e-3) / 1e12
        im = "n/a" if int_mm is None else f"{int_mm:.4f} ms"
        print(f"K10 {name} M={M} K={K} N={N}: change {cm:.4f} ms {_ms_list(c)}, parent "
              f"{pm:.4f} ms {_ms_list(p)}, torch._int_mm {im}, bf16 matmul {bf16_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); change {tops:.1f} TOPS = "
              f"{tops / PEAK_INT8_TOPS:.1%} of the int8 peak; bit-exact to the plain version "
              f"and to the parent (f32 and bf16 out)")
        rows.append({"kernel": "K10", "product": name, "M": M, "K": K, "N": N,
                     "max_abs_err": 0.0, "bit_identical": True, "ms": c, "parent_ms": p,
                     "int_mm_ms": int_mm, "bf16_matmul_ms": bf16_ms, **b})
        del x, wq, wq_rm
        torch.cuda.empty_cache()
    return rows


def wrapper_host_us(parent, change, unfused, n_layers: int) -> dict:
    """Host microseconds per call (``host_us``, 200 calls rotated over the
    layers) of the parent's call, the change's with its fused store and the
    change's without a write target, in turns (parent, change, unfused,
    unfused, change, parent); the means of each arm's two readings."""
    import itertools

    arms = {"parent": parent, "change": change, "unfused": unfused}
    got = {k: [] for k in arms}
    for arm in ("parent", "change", "unfused", "unfused", "change", "parent"):
        layers = itertools.cycle(range(n_layers))
        got[arm].append(host_us(lambda: arms[arm](next(layers))))
    return {k: sum(v) / len(v) for k, v in got.items()}


def host_note(host: dict) -> str:
    return (f"wrapper host us per call: change {host['change']:.1f} (without the store "
            f"{host['unfused']:.1f}), parent {host['parent']:.1f}")


def run_parent_decode(lib, c: dict, layer: int):
    """The parent's K2 (K4 on an int8 cache) as its wrapper ran it: the
    input checks, its split workspace and the arrival counters, then its
    kernel."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da

    q = c["q"]
    B, hq, D = q.shape
    q8 = isinstance(c["kall"], dict)
    kq = c["kall"]["q"] if q8 else c["kall"]
    vq = c["vall"]["q"] if q8 else c["vall"]
    da._check(q, kq, vq, c["k_new"], c["v_new"], layer, c["plen"], c["dend"],
              cache_dtype=kq.dtype)
    if q8:
        da._check_scales(c["kall"], c["vall"])
    hkv, S = kq.shape[2], kq.shape[3]
    splits = da.split_count(B, hkv, S, da._sm_count(q.device))
    ws = torch.empty((B, hkv, splits, hq // hkv, D + 2), dtype=torch.float32, device=q.device)
    counters = da.arrival_counters(q.device, B * hkv)
    out = torch.empty_like(q)
    cache = ((kq.data_ptr(), c["vall"]["q"].data_ptr(), c["kall"]["s"].data_ptr(),
              c["vall"]["s"].data_ptr()) if q8 else (kq.data_ptr(), c["vall"].data_ptr()))
    entry = lib.decode_attention_q8 if q8 else lib.decode_attention_bf16
    err = entry(q.data_ptr(), *cache, c["k_new"].data_ptr(), c["v_new"].data_ptr(),
                c["plen"].data_ptr(), c["dend"].data_ptr(), ws.data_ptr(),
                counters.data_ptr(), out.data_ptr(), int(layer), B, hq, hkv, S, c["pb"],
                splits, float(D ** -0.5), _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"parent decode attention: CUDA error {err}")
    return out


def ab_decode(lib, gen, rounds: int, q8: bool) -> list[dict]:
    """K2 (K4) at chip_smoke's ``DECODE_GRID``: parent and change held to the
    plain version and to each other bit for bit, then timed in turns by
    device time on a cold cache (``chip_smoke.attention_ms``: the calls
    rotated over enough layers that those between two on one layer read
    more than the 50 MB L2), the host-paced ms beside."""
    import torch

    from chip_smoke import (DECODE_GRID, PEAK_HBM_GBPS, _close, attention_ms, cold_note,
                            decode_bound, decode_case, decode_reference, decode_write_slots)
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da

    name = "K4" if q8 else "K2"
    fn = da.decode_attention_q8 if q8 else da.decode_attention
    rows = []
    for B, S in DECODE_GRID:
        c = decode_case(gen, B, S, q8)
        slots = decode_write_slots(c)

        def change(layer):
            return fn(c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"], layer, c["plen"],
                      c["dend"], c["pb"], write_slots=slots)

        def parent(layer):
            return run_parent_decode(lib, c, layer)

        layer = c["L"] - 1
        pout = parent(layer)
        ref = decode_reference(c, layer)
        out = change(layer)
        live = slice(0, B - 1) if B > 1 else slice(0, 1)
        err = _close(f"{name} B={B} S={S}", out[live], ref[live], 2e-2, 2e-2)
        perr = _close(f"parent {name} B={B} S={S}", pout[live], ref[live], 2e-2, 2e-2)
        same = torch.equal(out, pout)
        diff = (out.float() - pout.float()).abs().max().item()
        del out, pout, ref
        times = {"parent": ([], []), "change": ([], [])}
        for _ in range(rounds):
            for arm in ("parent", "change", "change", "parent"):
                dev, host = attention_ms(parent if arm == "parent" else change, c["L"])
                times[arm][0].append(dev)
                times[arm][1].append(host)
        (p, ph), (ch, chh) = times["parent"], times["change"]
        host = wrapper_host_us(parent, change, lambda layer: fn(
            c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"], layer, c["plen"], c["dend"],
            c["pb"]), c["L"])
        b = decode_bound(c)
        cm, pm = statistics.median(ch), statistics.median(p)
        print(f"{name} B={B} S={S} ({c['rows']} valid rows; {cold_note(c['L'], c['call_bytes'])}):"
              f" change {cm:.4f} ms {_ms_list(ch)}, parent {pm:.4f} ms {_ms_list(p)} device "
              f"time; host-paced change {statistics.median(chh):.4f} / parent "
              f"{statistics.median(ph):.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
              f"HBM peak share change {c['call_bytes'] / (cm * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%}, "
              f"parent {c['call_bytes'] / (pm * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%}; change/parent "
              f"{cm / pm:.3f}; err {err:.3e} / parent {perr:.3e}; bit-identical: {same} (max "
              f"|diff| {diff:.3e}); {host_note(host)}")
        rows.append({"kernel": name, "B": B, "S": S, "rows": c["rows"], "layers": c["L"],
                     "max_abs_err": err, "parent_max_abs_err": perr, "bit_identical": same,
                     "max_diff_vs_parent": diff, "ms": ch, "parent_ms": p, "host_ms": chh,
                     "parent_host_ms": ph, "wrapper_host_us": host, **b})
        del c
        torch.cuda.empty_cache()
    return rows


def run_parent_paged(lib, c: dict, layer: int):
    """The parent's K6/K7 (bf16 or int8 pool) as its wrapper ran it: the
    input checks, its split workspace and the arrival counters, then its
    kernel; (B, Hq, T, D) as ``chip_smoke.paged_call``."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention_paged as dap

    q = c["q"]
    B, hq, T, D = q.shape
    q8 = isinstance(c["kpool"], dict)
    kq = c["kpool"]["q"] if q8 else c["kpool"]
    vq = c["vpool"]["q"] if q8 else c["vpool"]
    dap._check(q, kq, vq, c["k_new"], c["v_new"], layer, c["table"], c["plen"], c["dcount"],
               kq.dtype)
    _, n_pages, hkv, PS, _ = kq.shape
    max_pages = c["table"].shape[1]
    splits = dap.split_count(B, hkv, max_pages * PS, dap._sm_count(q.device))
    ws = torch.empty((B, hkv, splits, T * hq // hkv, D + 2), dtype=torch.float32,
                     device=q.device)
    counters = dap.arrival_counters(q.device, B * hkv)
    out = torch.empty_like(q)
    pool = ((kq.data_ptr(), vq.data_ptr(), c["kpool"]["s"].data_ptr(),
             c["vpool"]["s"].data_ptr()) if q8 else (kq.data_ptr(), vq.data_ptr()))
    entry = lib.decode_attention_paged_q8 if q8 else lib.decode_attention_paged_bf16
    err = entry(q.data_ptr(), *pool, c["k_new"].data_ptr(), c["v_new"].data_ptr(),
                c["table"].data_ptr(), c["plen"].data_ptr(), c["dcount"].data_ptr(),
                ws.data_ptr(), counters.data_ptr(), out.data_ptr(), int(layer), B, hq, hkv, T,
                n_pages, PS, max_pages, splits, float(D ** -0.5), _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"parent paged decode attention: CUDA error {err}")
    return out


def kernels_per_call(call, n_layers: int, calls: int = 8) -> tuple[float, list[str]]:
    """(kernels a call of ``call(layer)`` runs on the card, their names),
    from ``torch.profiler``'s device events over ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call(0)
    torch.cuda.synchronize()
    for _ in range(2):             # the first session warms the profiler up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                call(i % n_layers)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    short = {n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
             for n in names}
    return len(names) / calls, sorted(short)


def ab_paged(lib, gen, rounds: int, T: int) -> list[dict]:
    """K6 (T = 1) or K7 (T = 4), over the bf16 and the int8 pool, at
    chip_smoke's ``PAGED_GRID``: parent and change held to the plain version
    and to each other bit for bit, timed in turns by device time on a cold
    cache, the host-paced ms beside; kernels per call counted at
    ``PAGED_ROW``."""
    import torch

    from chip_smoke import (PAGED_GRID, PAGED_ROW, PEAK_HBM_GBPS, attention_ms, cold_note,
                            paged_call, paged_case, paged_hold, paged_kernel, paged_plain)

    rows = []
    for q8 in (False, True):
        _, label = paged_kernel(T, q8)
        name = ("K6" if T == 1 else "K7") + (" q8" if q8 else " bf16")
        for B, dcount, PS in PAGED_GRID:
            c = paged_case(gen, B, T, q8, dcount, PS)

            def change(layer):
                return paged_call(c, layer, write=True)

            def parent(layer):
                return run_parent_paged(lib, c, layer)

            layer = c["L"] - 1
            ref = paged_plain(c, layer)         # before the change's store
            pout = parent(layer)
            out = change(layer)
            shape = f"B={B} T={T} PS={PS} dcount={dcount}"
            err = paged_hold(f"{label} {shape}", c, out, ref)
            perr = paged_hold(f"parent {label} {shape}", c, pout, ref)
            same = torch.equal(out, pout)
            diff = (out.float() - pout.float()).abs().max().item()
            del out, pout
            times = {"parent": ([], []), "change": ([], [])}
            for _ in range(rounds):
                for arm in ("parent", "change", "change", "parent"):
                    dev, host = attention_ms(parent if arm == "parent" else change, c["L"])
                    times[arm][0].append(dev)
                    times[arm][1].append(host)
            (p, ph), (ch, chh) = times["parent"], times["change"]
            host = wrapper_host_us(parent, change, lambda layer: paged_call(c, layer), c["L"])
            b = c["bound"]
            cm, pm = statistics.median(ch), statistics.median(p)
            counts = {}
            if (B, dcount, PS) == PAGED_ROW:
                counts = {"kernels_per_call": kernels_per_call(change, c["L"]),
                          "parent_kernels_per_call": kernels_per_call(parent, c["L"])}
            count_note = "".join(
                f"; {arm.replace('_', ' ')} {n:g} ({', '.join(names)})"
                for arm, (n, names) in counts.items())
            print(f"{name} {shape} ({c['rows']} valid rows; "
                  f"{cold_note(c['L'], c['call_bytes'])}): change {cm:.4f} ms {_ms_list(ch)}, "
                  f"parent {pm:.4f} ms {_ms_list(p)} device time; host-paced change "
                  f"{statistics.median(chh):.4f} / parent {statistics.median(ph):.4f} ms; bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); HBM peak share change "
                  f"{c['call_bytes'] / (cm * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%}, parent "
                  f"{c['call_bytes'] / (pm * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%}; change/parent "
                  f"{cm / pm:.3f}; err {err:.3e} / parent {perr:.3e}; bit-identical: {same} "
                  f"(max |diff| {diff:.3e}){count_note}; {host_note(host)}")
            rows.append({"kernel": name, "B": B, "T": T, "PS": PS, "dcount": dcount,
                         "rows": c["rows"], "layers": c["L"], "max_abs_err": err,
                         "parent_max_abs_err": perr, "bit_identical": same,
                         "max_diff_vs_parent": diff, "ms": ch, "parent_ms": p, "host_ms": chh,
                         "parent_host_ms": ph, "wrapper_host_us": host, **counts, **b})
            del c
            torch.cuda.empty_cache()
    return rows


def ab_span(lib, gen, rounds: int) -> list[dict]:
    """K5: the parent's two single-cache launches against the change's one
    two-cache launch, bit for bit, device time in turns."""
    import torch

    from chip_smoke import PEAK_HBM_GBPS, bound, graph_ms
    from qwen3_asr_tpu_torch.ops.kernels import _build
    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    L, B, H, T, S = 28, 8, 8, 4, 640
    caches = [torch.randn(L, B, H, S, D, generator=gen, device="cuda").bfloat16()
              for _ in range(2)]
    rows = [torch.randn(L, B, H, T, D, generator=gen, device="cuda").bfloat16()
            for _ in range(2)]
    slots = torch.tensor([512, 515, 531, 560, 600, 617, S - 2, S + 5],
                         dtype=torch.int32, device="cuda")

    def parent(kc, vc):
        for cache, r in ((kc, rows[0]), (vc, rows[1])):
            err = lib.kv_write_rows_bf16(cache.data_ptr(), r.data_ptr(), slots.data_ptr(),
                                         L, B, H, T, S, _build.stream_ptr(cache))
            if err:
                raise RuntimeError(f"parent kv_write_rows_bf16: CUDA error {err}")
        return kc, vc

    out = kw.kv_write_span_pair(*(c.clone() for c in caches), *rows, slots)
    pout = parent(*(c.clone() for c in caches))
    ref = kw.kv_write_span_pair_plain(*(c.clone() for c in caches), *rows, slots)
    same = all(torch.equal(o, p) for o, p in zip(out, pout))
    exact = all(torch.equal(o, r) for o, r in zip(out, ref))
    if not (same and exact):
        raise AssertionError(f"K5: change == parent {same}, change == plain {exact}")
    del out, pout, ref
    work = [c.clone() for c in caches]
    p, c = in_turns(lambda: parent(*work), lambda: kw.kv_write_span_pair(*work, *rows, slots),
                    rounds, 20, timer=graph_ms)
    n_rows = int(kw.span_indices(slots, T, S)[0].numel())
    nbytes = 2 * 2 * L * H * D * 2 * n_rows
    b = bound(nbytes, 0, 1.0)
    cm, pm = statistics.median(c), statistics.median(p)
    print(f"K5 L={L} B={B} H={H} T={T} S={S} (K and V, {n_rows} landing rows a layer and "
          f"head): change (one launch) {cm:.4f} ms {_ms_list(c)}, parent (two launches) "
          f"{pm:.4f} ms {_ms_list(p)} device time; bound {b['bound_ms']:.4f} ms (bytes) = "
          f"{b['bound_ms'] / cm:.1%} of the change's time, {b['bound_ms'] / pm:.1%} of the "
          f"parent's; {nbytes / (cm * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%} of the HBM peak; "
          f"change/parent {cm / pm:.3f}; both caches bit-identical to the parent and to the "
          f"plain version")
    return [{"kernel": "K5", "L": L, "B": B, "T": T, "S": S, "bit_identical": True,
             "ms": c, "parent_ms": p, **b}]


def run_parent_stream(lib, kernel: str, fresh, plen, out, layer: int, B: int, S: int, pb: int,
                      dend, block: int, per: int) -> None:
    """The parent's kernel of K11a, K11b or K11c into ``out``, with the
    arguments its wrapper gives it (K11a and K11b: ``per`` pairs a block;
    K11c: ``block`` = block_p and ``per`` = its blocks)."""
    from qwen3_asr_tpu_torch.ops.kernels import _build

    hq, hkv = fresh[0].shape[1], fresh[1].shape[2]
    ptrs = [t.data_ptr() for t in fresh]
    scale, st = float(D ** -0.5), _build.stream_ptr(out)
    if kernel in ("K11a", "K11b"):
        fn = lib.decode_attention_hbm2_bf16 if kernel == "K11a" else lib.decode_attention_hbm3_bf16
        err = fn(*ptrs, plen.data_ptr(), out.data_ptr(), layer, B, hq, hkv, S, pb, dend, block,
                 per, scale, st)
    else:
        err = lib.decode_attention_hbm5_bf16(*ptrs, plen.data_ptr(), dend.data_ptr(),
                                             out.data_ptr(), layer, B, hq, hkv, S, pb, block,
                                             per, scale, st)
    if err:
        raise RuntimeError(f"parent {kernel}: CUDA error {err}")


def stream_turns(arms: dict, n_layers: int, rounds: int) -> dict:
    """Device times on a cold cache (``chip_smoke.attention_ms``) of every
    arm, in turns: the arms in order, then in reverse, per round."""
    from chip_smoke import attention_ms

    times = {name: [] for name in arms}
    order = list(arms) + list(arms)[::-1]
    for _ in range(rounds):
        for name in order:
            times[name].append(attention_ms(arms[name], n_layers)[0])
    return times


def ab_stream(lib, gen, rounds: int, kernel: str) -> list[dict]:
    """K11a or K11b at chip_smoke's ``DECODE_GRID`` and ``STREAM_EXTRA``:
    parent and change held to the plain version and compared bit for bit
    (K11a also to K11b), timed in turns by device time on a cold cache,
    with K2 on the same inputs."""
    import torch

    from chip_smoke import (DECODE_GRID, PEAK_HBM_GBPS, STREAM_EXTRA, _close, attention_bound,
                            cold_note, stream_case)
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm2 as h2
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm3 as h3

    fn = h2.decode_attention_hbm2 if kernel == "K11a" else h3.decode_attention_hbm3
    rows = []
    for B, S in DECODE_GRID + STREAM_EXTRA:
        c = stream_case(gen, B, S)
        pb, plen = c["pb"], c["plen"]
        if B > 1:
            plen[-1] = 0
        dend = pb if (B, S) in STREAM_EXTRA else pb + (S - pb) // 2
        block_k = h2.tile_block_k(S, pb, 512)
        fresh = (c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"])
        hq, hkv = c["q"].shape[1], c["kall"].shape[2]
        blocks, per = h2.stream_grid(B * hkv, da._sm_count(c["q"].device))

        def parent(layer):
            out = torch.empty_like(c["q"])
            run_parent_stream(lib, kernel, fresh, plen, out, layer, B, S, pb, dend, block_k,
                              per)
            return out

        ends = torch.full_like(plen, dend)
        end = ends[0]               # the change's one end, read on the device
        arms = {"parent": parent, "change": lambda layer: fn(*fresh, layer, plen, end, pb),
                "k2": lambda layer: da.decode_attention(*fresh, layer, plen, ends, pb)}
        layer = c["L"] - 1
        out, pout = arms["change"](layer), parent(layer)
        k11b = h3.decode_attention_hbm3(*fresh, layer, plen, end, pb)
        ref = h2.scalar_end_plain(c["q"].float(), c["kall"][layer:layer + 1].float(),
                                  c["vall"][layer:layer + 1].float(), c["k_new"].float(),
                                  c["v_new"].float(), 0, plen, end, pb, D ** -0.5)
        err = _close(f"{kernel} B={B} S={S}", out, ref, 2e-2, 2e-2)
        perr = _close(f"parent {kernel} B={B} S={S}", pout, ref, 2e-2, 2e-2)
        same, same_b = torch.equal(out, pout), torch.equal(out, k11b)
        diff = (out.float() - pout.float()).abs().max().item()
        del out, pout, ref, k11b
        times = stream_turns(arms, c["L"], rounds)
        b, call_bytes = attention_bound(B, hq, hkv, int(plen.sum()) + B * (dend - pb), 2 * D)
        cm, pm, km = (statistics.median(times[k]) for k in ("change", "parent", "k2"))

        def share(ms):
            return f"{call_bytes / (ms * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%}"

        print(f"{kernel} B={B} S={S} dend={dend} ({blocks} blocks of {per} pairs; "
              f"{cold_note(c['L'], call_bytes)}): change {cm:.4f} ms {_ms_list(times['change'])}, "
              f"parent {pm:.4f} ms {_ms_list(times['parent'])}, K2 {km:.4f} ms "
              f"{_ms_list(times['k2'])} device time; parent/change {pm / cm:.2f}x, change/K2 "
              f"{cm / km:.2f}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); HBM peak share "
              f"change {share(cm)}, parent {share(pm)}, K2 {share(km)}; err {err:.3e} / parent "
              f"{perr:.3e}; bit-identical to the parent: {same} (max |diff| {diff:.3e}), to "
              f"K11b: {same_b}")
        rows.append({"kernel": kernel, "B": B, "S": S, "dend": dend, "blocks": blocks,
                     "per": per, "layers": c["L"], "max_abs_err": err,
                     "parent_max_abs_err": perr, "bit_identical": same,
                     "bit_identical_to_k11b": same_b, "max_diff_vs_parent": diff,
                     "ms": times["change"], "parent_ms": times["parent"], "k2_ms": times["k2"],
                     **b})
        del c, fresh
        torch.cuda.empty_cache()
    return rows


def run_parent_sched(lib, fresh, sched, out, layer: int, B: int, S: int) -> None:
    """The f0ebdf1 kernel of K11d into ``out``, with its wrapper's
    arguments (a block per core and KV head: no grid argument)."""
    from qwen3_asr_tpu_torch.ops.kernels import _build
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_sched as sc

    hq, hkv = fresh[0].shape[1], fresh[1].shape[2]
    cores, J = sc._check_schedule(sched, out.device, S)
    err = lib.decode_attention_sched_bf16(
        *(t.data_ptr() for t in fresh), *(t.data_ptr() for t in sched), out.data_ptr(),
        layer, B, hq, hkv, S, cores, sc._per_core(sched, S), J, float(D ** -0.5),
        _build.stream_ptr(out))
    if err:
        raise RuntimeError(f"parent K11d: CUDA error {err}")


def ab_lanes(lib, gen, rounds: int, kernel: str) -> list[dict]:
    """K11c or K11d at ``chip_smoke.LANES_GRID`` (per-lane ends, an idle
    lane; the skewed case one lane at S and the rest at the prompt bucket):
    parent and change held to the plain version and compared bit for bit,
    timed in turns by device time on a cold cache, with K2 on the same
    inputs and clamped prompt lengths.  K11d runs its schedule built
    beforehand, as the micro-bench builds it once per pass, with K11c on the
    same inputs in the same turns and held to it bit for bit."""
    import torch

    from chip_smoke import (LANES_GRID, PEAK_HBM_GBPS, _close, attention_bound, cold_note,
                            lanes_case)
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm5 as h5
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_sched as sc

    rows = []
    for B, S, skew in LANES_GRID:
        c, plen, dend = lanes_case(gen, B, S, skew)
        pb = c["pb"]
        clamped = plen.clamp(1, pb)
        fresh = (c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"])
        hq, hkv = c["q"].shape[1], c["kall"].shape[2]
        sms = da._sm_count(c["q"].device)
        if kernel == "K11c":
            block_p = h5.prompt_block(pb, S)
            blocks = min(B * hkv, sms)
            grid = f"{blocks} blocks, {B * hkv / blocks:.2f} pairs a block"

            def parent(layer):
                out = torch.empty_like(c["q"])
                run_parent_stream(lib, "K11c", fresh, plen, out, layer, B, S, pb, dend,
                                  block_p, blocks)
                return out

            def change(layer):
                return h5.decode_attention_hbm5(*fresh, layer, plen, dend, pb)
        else:
            cores, per_core = sc.schedule_geometry(B, hkv, sms)
            sched = sc.build_decode_schedule(plen, dend, pb, S, cores, per_core, B)
            blocks = min(B * hkv, sms)
            grid = (f"cores={cores} per_core={per_core}; change {blocks} blocks, "
                    f"{B * hkv / blocks:.2f} pairs a block")

            def parent(layer):
                out = torch.empty_like(c["q"])
                run_parent_sched(lib, fresh, sched, out, layer, B, S)
                return out

            def change(layer):
                return sc.decode_attention_sched(*fresh, layer, plen, dend, pb,
                                                 schedule=sched)

        arms = {"parent": parent, "change": change,
                "k2": lambda layer: da.decode_attention(*fresh, layer, clamped, dend, pb)}
        if kernel == "K11d":
            arms["k11c"] = lambda layer: h5.decode_attention_hbm5(*fresh, layer, plen, dend, pb)
        layer = c["L"] - 1
        out, pout = change(layer), parent(layer)
        same_c = kernel != "K11d" or torch.equal(out, arms["k11c"](layer))
        ref = da.decode_attention_plain(
            c["q"].float(), c["kall"][layer:layer + 1].float(),
            c["vall"][layer:layer + 1].float(), c["k_new"].float(), c["v_new"].float(), 0,
            clamped, dend, pb, D ** -0.5)
        err = _close(f"{kernel} B={B} S={S}", out, ref, 2e-2, 2e-2)
        perr = _close(f"parent {kernel} B={B} S={S}", pout, ref, 2e-2, 2e-2)
        same = torch.equal(out, pout)
        diff = (out.float() - pout.float()).abs().max().item()
        del out, pout, ref
        times = stream_turns(arms, c["L"], rounds)
        b, call_bytes = attention_bound(B, hq, hkv, int(clamped.sum() + (dend - pb).sum()),
                                        2 * D)
        cm, pm, km = (statistics.median(times[k]) for k in ("change", "parent", "k2"))

        def share(ms):
            return f"{call_bytes / (ms * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%}"

        k11c = ""
        if kernel == "K11d":
            k11c_m = statistics.median(times["k11c"])
            k11c = (f"; K11c {k11c_m:.4f} ms {_ms_list(times['k11c'])}, change/K11c "
                    f"{cm / k11c_m:.2f}, bit-identical to K11c: {same_c}")
        print(f"{kernel} B={B} S={S} {'one lane at S' if skew else 'random ends'} ({grid}; "
              f"{cold_note(c['L'], call_bytes)}): change {cm:.4f} ms {_ms_list(times['change'])}, "
              f"parent {pm:.4f} ms {_ms_list(times['parent'])}, K2 {km:.4f} ms "
              f"{_ms_list(times['k2'])} device time; parent/change {pm / cm:.2f}x, change/K2 "
              f"{cm / km:.2f}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) = "
              f"{b['bound_ms'] / cm:.1%} of the change's time; HBM peak share change "
              f"{share(cm)}, parent {share(pm)}, K2 {share(km)}; err {err:.3e} / parent "
              f"{perr:.3e}; bit-identical to the parent: {same} (max |diff| {diff:.3e}){k11c}")
        rows.append({"kernel": kernel, "B": B, "S": S, "skew": skew, "layers": c["L"],
                     "max_abs_err": err, "parent_max_abs_err": perr, "bit_identical": same,
                     "max_diff_vs_parent": diff, "ms": times["change"],
                     "parent_ms": times["parent"], "k2_ms": times["k2"],
                     "k11c_ms": times.get("k11c"), "bit_identical_to_k11c": same_c, **b})
        del c, fresh
        torch.cuda.empty_cache()
    return rows


AB = {"K1": ab_flash, "K11e": ab_conv, "K9": ab_qmm, "K10": ab_w8a8,
      "K2": lambda lib, gen, rounds: ab_decode(lib, gen, rounds, False),
      "K4": lambda lib, gen, rounds: ab_decode(lib, gen, rounds, True),
      "K6": lambda lib, gen, rounds: ab_paged(lib, gen, rounds, 1),
      "K7": lambda lib, gen, rounds: ab_paged(lib, gen, rounds, 4),
      "K5": ab_span,
      "K11a": lambda lib, gen, rounds: ab_stream(lib, gen, rounds, "K11a"),
      "K11b": lambda lib, gen, rounds: ab_stream(lib, gen, rounds, "K11b"),
      "K11c": lambda lib, gen, rounds: ab_lanes(lib, gen, rounds, "K11c"),
      "K11d": lambda lib, gen, rounds: ab_lanes(lib, gen, rounds, "K11d")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the earlier sources of the kernels compared")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default=",".join(AB),
                    help=f"comma-separated subset of {', '.join(AB)}")
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if any(k not in AB for k in kernels):
        ap.error(f"--kernels takes a subset of {', '.join(AB)}")
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SEED, card_identity
    from qwen3_asr_tpu_torch.ops.kernels import _build

    print(card_identity())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    _build.library()
    lib = parent_library(args.parent.resolve(), kernels)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [r for k in kernels for r in AB[k](lib, gen, args.rounds)]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
