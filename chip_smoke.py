#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``qwen3_asr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and a
CUDA build of PyTorch; it imports nothing of JAX.  Phases, in order (any
failure raises and the script exits non-zero):

  1. card identity (``nvidia-smi`` name and power limit);
  2. build the CUDA kernels from ``qwen3_asr_tpu_torch/csrc`` (seconds);
  3. each kernel against its plain PyTorch version at main-path shapes, on
     the card: max abs error vs the plain version computed in float32
     (K1, K2, K4: atol 2e-2 + rtol 2e-2 of the bf16 kernel; K9: f32
     tolerance, 1e-5 of the largest |value| + rtol 1e-5, against the f32
     product of the same int8 weights; K3, K3 int8, K5 and K10: exact, K5
     with overflow rows dropped; K6 and K7, the paged decode attention and
     verify over bf16 and int8 pools: as K2; K8, the paged row write, bf16
     and int8: exact outside the trash page 0; K11a and K11b, decode
     attention with one decode end for every lane, at K2's shapes: as K2;
     K11e, the stem's conv + bias + GELU at conv2's and conv3's shapes for
     the smoke batch's 256 chunks: atol 2e-2 + rtol 2e-2 of the bf16
     output; K11c and K11d, decode attention with per-lane decode ends and
     an idle lane, at K2's shapes and B=6: as K2, with K2's time beside
     theirs), kernel, plain and
     library-call times from CUDA events, the bound (bytes over 3.35 TB/s
     or operations over the peak of their type, whichever is larger), and
     the share of the published peak; then the ``kernelab`` section of
     ``tools/torch_micro_bench.py`` (K2, K11d and K11c over 28 layers at
     B=64, S=640, three decode depths), the path that launches K11c and
     K11d: each arm 28 launches a pass and held to K2;
  4. small-width reference checks: the decoder's prefill logits, one
     decode step and (bf16) one verify-split forward (T=4, per-lane write
     slots) with the kernels on the GPU against the same weights on the
     CPU with the plain versions -- bf16 against float32 under decode modes
     "auto" (K2), "3" (K11a) and "4" (K11b) in turn, and the int8
     decoder (int8 weights, W8A8 prefill, int8 cache) against the same
     quantized weights in float32; then one paged step and one paged
     verify forward (K6, K7, K8) over shuffled pages, bf16 against float32;
  5. the full-width 1.7B paths from random weights (seed 0), each with the
     launch counters set to 0 just before it and read just after: greedy
     ``transcribe_batch`` of 8 synthetic clips of 4-30 s
     (``max_tokens=64``) twice and one ``transcribe`` under
     ``speculative="off"`` (K1-K3; the bf16 lm head must keep its f32
     accumulator); on the same model ``transcribe_batch`` under decode
     modes "3" (K11a) and "4" (K11b), K2 never launched and the mode's
     kernel 28 x steps, and under the "pallas" stem (K11e twice per encoder
     call), each stream held to the plain one by the near-tie rule below,
     every token of the three streams held to the default modes' logits
     on the same prefix (the default loop forced along the stream),
     the encoder features of the "pallas" stem held to the "conv" stem's
     (5e-2 of max |feature|) and those of "taps", "merged", "c512" and
     "merged512" (the "conv" stem here) equal to them;
     then the same runs on the same weights under the
     default ``"auto"`` (the speculative loop: K5, no K2/K3), each lane's
     stream equal to the plain one or first differing at a near-tie of the
     plain run's penalized logits, and every token of the B=8 stream held
     to the plain step's logits on the same prefix (the plain loop forced
     along the speculative stream), for the n-gram run and for a
     teacher-forced run whose drafts are mostly accepted; sampled ``transcribe_batch`` twice with
     one seed (identical), sampled speculative (``spec_sampling``),
     int8-weights speculative (K5 and K9), long-form 20 s clips in 8 s
     chunks (one clip, and two pooled into one group); the
     ``ContinuousTranscriptionServer(n_slots=8, chunk_steps=16)`` on the
     smoke clips in two waves (the second admitted mid-decode): paged under
     ``spec_engine="off"`` (K6, K8) and the default ``"auto"`` (K7, K8),
     the int8 pool under both (q8 K6/K7, int8 K8), never a contiguous-cache
     kernel, and the flat engine (K2, per-lane K3), every stream held to
     the plain ``transcribe_batch`` stream by the near-tie rule, with ms per
     chunk iteration, engine counters and each request's TTFT; then a
     second 1.7B model with ``RuntimeConfig(quantization="int8",
     act_quant="int8", kv_cache_dtype="int8")``.  Token ids must be <
     vocab, logits never NaN, repeated runs identical, every kernel of a
     path launched;
  6. ``{"kernels": [...]}`` JSON, then the last line
     ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available or when
the package is not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# Published H100 SXM peaks (dense bf16 and int8 tensor cores, HBM3) at a
# 700 W limit.
PEAK_BF16_TFLOPS = 989.0
PEAK_INT8_TOPS = 1979.0
PEAK_HBM_GBPS = 3350.0
INT8_RUNTIME = dict(quantization="int8", act_quant="int8", kv_cache_dtype="int8")

# (name, route, source, TPU kernel it replaces)
KERNELS = {
    "flash_attention_causal": (
        "cuda", "qwen3_asr_tpu_torch/csrc/flash_attention.cu",
        "qwen3_asr_tpu/ops/pallas/flash_attention.py:95",
    ),
    "decode_attention": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:405",
    ),
    "kv_write_rows": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:260",
    ),
    "decode_attention_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:434",
    ),
    "kv_write_rows_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:260",
    ),
    "quantized_matmul": (
        "cuda", "qwen3_asr_tpu_torch/csrc/quantized_matmul.cu",
        "qwen3_asr_tpu/ops/quant.py:129",
    ),
    "w8a8_matmul": (
        "cuda", "qwen3_asr_tpu_torch/csrc/w8a8_matmul.cu",
        "qwen3_asr_tpu/ops/pallas/w8a8_matmul.py:65",
    ),
    "kv_write_span_batch": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:156",
    ),
    "decode_attention_paged": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:472",
    ),
    "decode_attention_paged_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:499",
    ),
    "decode_attention_paged_verify": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:526",
    ),
    "decode_attention_paged_verify_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:560",
    ),
    "kv_write_rows_paged": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:219",
    ),
    "kv_write_rows_paged_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:219",
    ),
    "decode_attention_hbm2": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_hbm2.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm2.py:134",
    ),
    "decode_attention_hbm3": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_hbm3.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:181",
    ),
    "conv_s2_gelu": (
        "cuda", "qwen3_asr_tpu_torch/csrc/conv_stem.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/conv_stem.py:82",
    ),
    "decode_attention_hbm5": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_hbm5.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm5.py:268",
    ),
    "decode_attention_sched": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_sched.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_sched.py:280",
    ),
}
#: The kernels the micro-bench's ``kernelab`` section A/Bs, 28 launches a
#: pass each (the JAX package runs K11c and K11d from no other path).
KERNELAB = ("decode_attention", "decode_attention_sched", "decode_attention_hbm5")
#: The kernels each path must launch, and those it must not.
BF16_PATH = ("flash_attention_causal", "decode_attention", "kv_write_rows")
INT8_PATH = ("flash_attention_causal", "decode_attention_q8", "kv_write_rows_q8",
             "quantized_matmul", "w8a8_matmul")
SPEC_PATH = ("flash_attention_causal", "kv_write_span_batch")
SPEC_NEVER = ("decode_attention", "kv_write_rows")
SPEC_W8_PATH = ("flash_attention_causal", "kv_write_span_batch", "quantized_matmul")
#: The continuous server's paths: the paged engine never launches a
#: contiguous-cache kernel; the flat engine runs K2 and per-lane K3.
CONTIGUOUS = ("decode_attention", "decode_attention_q8", "kv_write_rows", "kv_write_rows_q8",
              "kv_write_span_batch")
PAGED = ("decode_attention_paged", "decode_attention_paged_q8", "decode_attention_paged_verify",
         "decode_attention_paged_verify_q8", "kv_write_rows_paged", "kv_write_rows_paged_q8")
SERVER_PATHS = {
    # (runtime, paged): (kernels the run must launch, kernels it must not)
    "paged, spec_engine off": ({"spec_engine": "off"}, True,
                               ("flash_attention_causal", "decode_attention_paged",
                                "kv_write_rows_paged"), CONTIGUOUS),
    "paged, spec_engine auto": ({}, True,
                                ("flash_attention_causal", "decode_attention_paged_verify",
                                 "kv_write_rows_paged"), CONTIGUOUS),
    "paged int8 pool, spec_engine off": ({"kv_cache_dtype": "int8", "spec_engine": "off"}, True,
                                         ("flash_attention_causal", "decode_attention_paged_q8",
                                          "kv_write_rows_paged_q8"), CONTIGUOUS),
    "paged int8 pool, spec_engine auto": ({"kv_cache_dtype": "int8"}, True,
                                          ("flash_attention_causal",
                                           "decode_attention_paged_verify_q8",
                                           "kv_write_rows_paged_q8"), CONTIGUOUS),
    "flat, spec_engine off": ({"spec_engine": "off"}, False,
                              ("flash_attention_causal", "decode_attention", "kv_write_rows"),
                              PAGED + ("kv_write_span_batch",)),
}
#: bf16 speculative vs plain rows of one prefix at 1.7B: the largest allowed
#: max |difference| over max |logit|, 1.5x what the plain loop's own rows of
#: one lane differ by between B=1 and B=8 (2.7e-2 on an H100 80GB HBM3 from
#: seed 0), and the top-two gap over max |logit| under which the two may
#: choose apart: above the largest gap of such a flip measured there
#: (1.3e-2), below the median gap of the plain run's choices (2.1e-2).
LOGIT_TOL = 4e-2
NEAR_TIE = 1.5e-2


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops_per_s: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the peak rate of their type."""
    t_bytes = nbytes / (PEAK_HBM_GBPS * 1e9) * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sum_bounds(parts: list[dict]) -> dict:
    """The bound of calls run one after another (their bounds summed; the
    label of the larger share)."""
    by_bytes = sum(b["bound_ms"] for b in parts if b["bound_by"] == "bytes")
    total = sum(b["bound_ms"] for b in parts)
    return {"bound_ms": total,
            "bound_by": "bytes" if by_bytes >= total - by_bytes else "operations"}


def _close(name: str, out, ref, atol: float, rtol: float) -> float:
    import torch

    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond atol={atol} rtol={rtol} "
            f"(max abs err {err.max().item():.3e})"
        )
    return err.max().item()


def check_flash(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from qwen3_asr_tpu_torch.ops.kernels import flash_attention as fa

    B, hq, hkv, D = 8, 16, 8, 128
    worst, times = 0.0, []
    for T in (64, 448, 1024, 1088, 77):
        q = torch.randn(B, hq, T, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16()
        out = fa.flash_attention_causal(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_causal_plain(q.float(), k.float(), v.float())
        err = _close(f"K1 T={T}", out, ref, 2e-2, 2e-2)
        ms = cuda_ms(lambda: fa.flash_attention_causal(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_causal_plain(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        # Causal QK^T and PV: 2 products x 2 FLOP per MAC over T(T+1)/2 pairs;
        # q, k, v read and the output written once.
        flops = 4 * B * hq * D * T * (T + 1) / 2
        b = bound(2 * B * T * D * (2 * hq + 2 * hkv), flops, PEAK_BF16_TFLOPS * 1e12)
        tflops = flops / (ms * 1e-3) / 1e12
        print(f"K1 flash_attention_causal B={B} T={T}: max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); {tflops:.1f} TFLOP/s "
              f"= {tflops / PEAK_BF16_TFLOPS:.1%} of the bf16 peak")
        worst = max(worst, err)
        times.append((T, {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}))
    # The record's time is the main path's largest smoke shape (T=448: the
    # 30 s bucket's 64-aligned prefill run).
    return {"max_abs_err": worst, **next(t for T, t in times if T == 448)}


def check_decode(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da

    L, hq, hkv, D, pb, layer = 2, 16, 8, 128, 512, 1
    worst, times = 0.0, []
    for B in (1, 8, 96):
        for S in (640, 2560):
            kall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
            vall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
            q = torch.randn(B, hq, D, generator=gen, device="cuda").bfloat16()
            k_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            v_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            plen = torch.randint(1, pb + 1, (B,), generator=gen, device="cuda").int()
            dend = torch.randint(pb, S + 1, (B,), generator=gen, device="cuda").int()
            if B > 1:                      # one idle lane
                plen[-1] = 0
                dend[-1] = pb
            out = da.decode_attention(q, kall, vall, k_new, v_new, layer, plen, dend, pb)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"K2 B={B} S={S}: non-finite output")
            ref = da.decode_attention_plain(
                q.float(), kall.float(), vall.float(), k_new.float(), v_new.float(),
                layer, plen, dend, pb, D ** -0.5,
            )
            live = slice(0, B - 1) if B > 1 else slice(0, 1)
            err = _close(f"K2 B={B} S={S}", out[live], ref[live], 2e-2, 2e-2)
            ms = cuda_ms(lambda: da.decode_attention(
                q, kall, vall, k_new, v_new, layer, plen, dend, pb))
            plain_ms = cuda_ms(lambda: da.decode_attention_plain(
                q, kall, vall, k_new, v_new, layer, plen, dend, pb, D ** -0.5))
            # The K and V bytes of the valid rows, each read once, plus q,
            # the fresh rows and the output; QK and PV over the valid rows
            # and the self-term.
            rows = int((plen + dend - pb).sum())
            b = bound(rows * hkv * D * 2 * 2 + B * (2 * hq + 2 * hkv) * D * 2,
                      4 * hq * D * (rows + B), PEAK_BF16_TFLOPS * 1e12)
            gbps = rows * hkv * D * 2 * 2 / (ms * 1e-3) / 1e9
            print(f"K2 decode_attention B={B} pb={pb} S={S}: max_abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {rows} valid rows, "
                  f"{gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b}))
            del kall, vall
    # No one PyTorch call computes it: two valid intervals plus the
    # self-term of a row that is not in the cache.
    rec = next(t for B, S, t in times if B == 8 and S == 640)
    return {"max_abs_err": worst, **rec, "library_ms": None}


def check_kv_write(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    L, B, hkv, S, D = 28, 8, 8, 640, 128
    cache = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
    rows = torch.randn(L, B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    slots = torch.randint(512, S, (B,), generator=gen, device="cuda").int()
    for label, run, plain_slots in (
        ("shared slot", lambda c: kw.kv_write_rows(c, rows, 600), torch.full_like(slots, 600)),
        ("per-lane slots", lambda c: kw.kv_write_rows_batch(c, rows, slots), slots),
    ):
        out = run(cache.clone())
        ref = kw.kv_write_rows_plain(cache.clone(), rows, plain_slots)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K3 {label}: differs from the plain version")
        print(f"K3 kv_write_rows {label}: bit-exact")
    work = cache.clone()
    ms = cuda_ms(lambda: kw.kv_write_rows(work, rows, 600))
    plain_ms = cuda_ms(lambda: kw.kv_write_rows_plain(work, rows, torch.full_like(slots, 600)))
    # One index_put_ of the same rows at the same (lane, slot) pairs.
    lane = torch.arange(B, device="cuda")
    slot = torch.full((B,), 600, device="cuda")
    vals = rows[:, :, :, 0].transpose(0, 1).contiguous()          # (B, L, H, D)

    def index_put():
        work[:, lane, :, slot] = vals

    library_ms = cuda_ms(index_put)
    b = bound(2 * L * B * hkv * D * 2, 0, 1.0)
    print(f"K3 kv_write_rows L={L} B={B} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_put_ {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms (bytes)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


def check_decode_q8(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    L, hq, hkv, D, pb, layer = 2, 16, 8, 128, 512, 1
    worst, times = 0.0, []
    for B in (1, 8, 96):
        for S in (640, 2560):
            kall = quantize_kv(torch.randn(L, B, hkv, S, D, generator=gen, device="cuda"))
            vall = quantize_kv(torch.randn(L, B, hkv, S, D, generator=gen, device="cuda"))
            q = torch.randn(B, hq, D, generator=gen, device="cuda").bfloat16()
            k_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            v_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            plen = torch.randint(1, pb + 1, (B,), generator=gen, device="cuda").int()
            dend = torch.randint(pb, S + 1, (B,), generator=gen, device="cuda").int()
            if B > 1:                      # one idle lane
                plen[-1] = 0
                dend[-1] = pb
            out = da.decode_attention_q8(q, kall, vall, k_new, v_new, layer, plen, dend, pb)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"K4 B={B} S={S}: non-finite output")
            ref = da.decode_attention_q8_plain(
                q.float(), kall, vall, k_new.float(), v_new.float(),
                layer, plen, dend, pb, D ** -0.5,
            )
            live = slice(0, B - 1) if B > 1 else slice(0, 1)
            err = _close(f"K4 B={B} S={S}", out[live], ref[live], 2e-2, 2e-2)
            ms = cuda_ms(lambda: da.decode_attention_q8(
                q, kall, vall, k_new, v_new, layer, plen, dend, pb))
            plain_ms = cuda_ms(lambda: da.decode_attention_q8_plain(
                q, kall, vall, k_new, v_new, layer, plen, dend, pb, D ** -0.5))
            # int8 K and V bytes plus one f32 scale each, per valid row.
            rows = int((plen + dend - pb).sum())
            b = bound(rows * hkv * (D + 4) * 2 + B * (2 * hq + 2 * hkv) * D * 2,
                      4 * hq * D * (rows + B), PEAK_BF16_TFLOPS * 1e12)
            gbps = rows * hkv * (D + 4) * 2 / (ms * 1e-3) / 1e9
            print(f"K4 decode_attention_q8 B={B} pb={pb} S={S}: max_abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {rows} valid rows, "
                  f"{gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b}))
            del kall, vall
    # No one PyTorch call: K2's intervals and self-term over int8 rows.
    rec = next(t for B, S, t in times if B == 8 and S == 640)
    return {"max_abs_err": worst, **rec, "library_ms": None}


def check_decode_stream(gen, kind: str) -> dict:
    """K11a (``"hbm2"``) or K11b (``"hbm3"``) at K2's check shapes with one
    decode end for every lane (as the plain loop passes it), against K2's
    plain version in float32 (atol 2e-2 + rtol 2e-2, as K2)."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm2 as h2
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm3 as h3

    fn = h2.decode_attention_hbm2 if kind == "hbm2" else h3.decode_attention_hbm3
    label = "K11a decode_attention_hbm2" if kind == "hbm2" else "K11b decode_attention_hbm3"
    L, hq, hkv, D, pb, layer = 2, 16, 8, 128, 512, 1
    worst, times = 0.0, []
    for B in (1, 8, 96):
        for S in (640, 2560):
            kall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
            vall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
            q = torch.randn(B, hq, D, generator=gen, device="cuda").bfloat16()
            k_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            v_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            plen = torch.randint(1, pb + 1, (B,), generator=gen, device="cuda").int()
            if B > 1:
                plen[-1] = 0               # a lane with no prompt rows
            dend = pb + (S - pb) // 2
            block_k = h2.tile_block_k(S, pb, 512)
            out = fn(q, kall, vall, k_new, v_new, layer, plen, dend, pb)
            torch.cuda.synchronize()
            ref = h2.scalar_end_plain(q.float(), kall.float(), vall.float(), k_new.float(),
                                      v_new.float(), layer, plen, dend, pb, D ** -0.5)
            err = _close(f"{label} B={B} S={S}", out, ref, 2e-2, 2e-2)
            ms = cuda_ms(lambda: fn(q, kall, vall, k_new, v_new, layer, plen, dend, pb))
            plain_ms = cuda_ms(lambda: h2.scalar_end_plain(
                q, kall, vall, k_new, v_new, layer, plen, dend, pb, D ** -0.5))
            k2_ms = cuda_ms(lambda: da.decode_attention(
                q, kall, vall, k_new, v_new, layer, plen, torch.full_like(plen, dend), pb))
            # As K2: the valid rows' K and V, q, the fresh rows and the output.
            rows = int(plen.sum()) + B * (dend - pb)
            b = bound(rows * hkv * D * 2 * 2 + B * (2 * hq + 2 * hkv) * D * 2,
                      4 * hq * D * (rows + B), PEAK_BF16_TFLOPS * 1e12)
            gbps = rows * hkv * D * 2 * 2 / (ms * 1e-3) / 1e9
            print(f"{label} B={B} pb={pb} S={S} dend={dend} block_k={block_k}: "
                  f"max_abs_err={err:.3e} kernel {ms:.4f} ms, K2 {k2_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                  f"{rows} valid rows, {gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b}))
            del kall, vall
    # No one PyTorch call computes it (as K2).
    rec = next(t for B, S, t in times if B == 8 and S == 640)
    return {"max_abs_err": worst, **rec, "library_ms": None}


def check_decode_lanes(gen, kind: str) -> dict:
    """K11c (``"hbm5"``) or K11d (``"sched"``) at K2's check shapes plus a
    batch that is no multiple of K11c's 4-lane group, with per-lane decode
    ends and an idle lane (prompt_len 0, clamped to 1 as the TPU kernels
    do) where B > 1, against the module's plain version in float32 (atol
    2e-2 + rtol 2e-2, as K2).  Times: the kernel (K11d with its schedule
    built beforehand, as the micro-bench builds it once per pass), the plain
    version and K2 on the same inputs and clamped prompt lengths."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm5 as h5
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_sched as sc

    label = {"hbm5": "K11c decode_attention_hbm5", "sched": "K11d decode_attention_sched"}[kind]
    L, hq, hkv, D, pb, layer = 2, 16, 8, 128, 512, 1
    scale = D ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, times = 0.0, []
    for B in (1, 6, 8, 96):
        for S in (640, 2560):
            kall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
            vall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
            q = torch.randn(B, hq, D, generator=gen, device="cuda").bfloat16()
            k_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            v_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
            plen = torch.randint(1, pb + 1, (B,), generator=gen, device="cuda").int()
            dend = torch.randint(pb, S + 1, (B,), generator=gen, device="cuda").int()
            if B > 1:
                plen[-1] = 0               # an idle lane
                dend[-1] = pb
            clamped = plen.clamp(1, pb)
            if kind == "hbm5":
                def kernel():
                    return h5.decode_attention_hbm5(q, kall, vall, k_new, v_new, layer,
                                                    plen, dend, pb)

                def plain(*t):
                    return da.decode_attention_plain(*t, layer, clamped, dend, pb, scale)
                extra = f"block_p={h5.prompt_block(pb, S)}"
            else:
                cores, per_core = sc.schedule_geometry(B, hkv, sms)
                sched = sc.build_decode_schedule(plen, dend, pb, S, cores, per_core, B)

                def kernel():
                    return sc.decode_attention_sched(q, kall, vall, k_new, v_new, layer, plen,
                                                     dend, pb, schedule=sched)

                def plain(*t):
                    return sc.decode_attention_sched_plain(*t, layer, sched, scale)
                build_ms = cuda_ms(lambda: sc.build_decode_schedule(
                    plen, dend, pb, S, cores, per_core, B))
                extra = f"cores={cores} per_core={per_core}, schedule build {build_ms:.4f} ms"
            out = kernel()
            torch.cuda.synchronize()
            ref = plain(q.float(), kall.float(), vall.float(), k_new.float(), v_new.float())
            err = _close(f"{label} B={B} S={S}", out, ref, 2e-2, 2e-2)
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(lambda: plain(q, kall, vall, k_new, v_new))
            k2_ms = cuda_ms(lambda: da.decode_attention(
                q, kall, vall, k_new, v_new, layer, clamped, dend, pb))
            # As K2: the valid rows' K and V, q, the fresh rows and the output.
            rows = int(clamped.sum() + (dend - pb).sum())
            b = bound(rows * hkv * D * 2 * 2 + B * (2 * hq + 2 * hkv) * D * 2,
                      4 * hq * D * (rows + B), PEAK_BF16_TFLOPS * 1e12)
            gbps = rows * hkv * D * 2 * 2 / (ms * 1e-3) / 1e9
            print(f"{label} B={B} pb={pb} S={S} per-lane ends ({extra}): "
                  f"max_abs_err={err:.3e} kernel {ms:.4f} ms, K2 {k2_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                  f"{rows} valid rows, {gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b}))
            del kall, vall
    # No one PyTorch call computes it (as K2).
    rec = next(t for B, S, t in times if B == 8 and S == 640)
    return {"max_abs_err": worst, **rec, "library_ms": None}


def kernelab_step() -> dict:
    """The micro-bench's ``kernelab`` section (K2 against K11d and K11c over
    28 layers, B=64, S=640), imported from ``tools/torch_micro_bench.py``:
    the path that launches K11c and K11d, as the JAX package's micro-bench
    launches K11d.  Every arm must launch 28 times a pass and agree with K2.
    Returns the launch counts of that run."""
    from qwen3_asr_tpu_torch.ops.kernels import _build

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_micro_bench import bench_kernel_ab

    _build.LAUNCHES.clear()
    res = bench_kernel_ab(B=64, S=640, pb=512, L=28, iters=3, warmup=1)
    launches = dict(_build.LAUNCHES)
    for name in KERNELAB:
        if launches.get(name, 0) != 28 * res["passes"]:
            raise AssertionError(f"kernelab: {name} launched {launches.get(name, 0)} times, "
                                 f"not 28 x {res['passes']} passes")
    check_launches("kernelab (tools/torch_micro_bench.py)", launches, KERNELAB)
    return launches


#: The stem convs K11e takes at the smoke batch (8 clips in the 3200-frame
#: bucket = 256 chunks): conv2 (64 x 50 -> 32 x 25) and conv3 (-> 16 x 13).
STEM_CONVS = (("conv2", 256, 64, 50, 480), ("conv3", 256, 32, 25, 480))


def check_conv_stem(gen) -> dict:
    """K11e at conv2's and conv3's shapes against its plain version (f32
    tap sum + bias, rounded to bf16, then the exact GELU): atol 2e-2 + rtol
    2e-2 (one bf16 ulp of the rounded conv output where the two f32 sums
    round apart).  Library call: ``F.conv2d`` with bias on the same
    channels-last data (cuDNN), the GELU being one more call."""
    import torch
    import torch.nn.functional as F

    from qwen3_asr_tpu_torch.ops.kernels.experiments import conv_stem as cs

    worst, parts = 0.0, []
    for name, N, H, W, C in STEM_CONVS:
        x = torch.randn(N, H, W, C, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(3, 3, C, C, generator=gen, device="cuda")).bfloat16()
        b = 0.1 * torch.randn(C, generator=gen, device="cuda")
        out = cs.conv_s2_gelu(x, w, b)
        torch.cuda.synchronize()
        ref = cs.conv_s2_gelu_plain(x, w, b)
        err = _close(f"K11e {name}", out, ref, 2e-2, 2e-2)
        ms = cuda_ms(lambda: cs.conv_s2_gelu(x, w, b), iters=10)
        plain_ms = cuda_ms(lambda: cs.conv_s2_gelu_plain(x, w, b), iters=5)
        x_cl = x.permute(0, 3, 1, 2)               # NCHW view, channels-last strides
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.bfloat16()
        lib = F.conv2d(x_cl, w_cl, b16, stride=2, padding=1)
        lib_err = (lib.permute(0, 2, 3, 1).float()
                   - cs.conv2d_s2_taps_f32(x, w) - b).abs().max().item()
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, b16, stride=2, padding=1), iters=10)
        Ho, Wo = out.shape[1], out.shape[2]
        flops = 2 * N * Ho * Wo * C * 9 * C
        bnd = bound(x.numel() * 2 + w.numel() * 2 + C * 4 + out.numel() * 2, flops,
                    PEAK_BF16_TFLOPS * 1e12)
        tflops = flops / (ms * 1e-3) / 1e12
        print(f"K11e conv_s2_gelu {name} N={N} {H}x{W}x{C} -> {Ho}x{Wo}x{C}: "
              f"max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d+bias "
              f"{library_ms:.4f} ms (layout {'channels-last' if lib.is_contiguous(memory_format=torch.channels_last) else 'NCHW'}, "
              f"max |conv2d - f32 taps| {lib_err:.3e}), bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}); {tflops:.1f} TFLOP/s = {tflops / PEAK_BF16_TFLOPS:.1%} "
              f"of the bf16 peak")
        worst = max(worst, err)
        parts.append((ms, plain_ms, bnd, library_ms))
        del x, out, ref, lib
    # The record: one encoder call's conv2 + conv3.
    return {"max_abs_err": worst, "ms": sum(p[0] for p in parts),
            "plain_ms": sum(p[1] for p in parts), **_sum_bounds([p[2] for p in parts]),
            "library_ms": sum(p[3] for p in parts)}


def check_kv_write_q8(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    L, B, hkv, S, D = 28, 8, 8, 640, 128
    cache = quantize_kv(torch.randn(L, B, hkv, S, D, generator=gen, device="cuda"))
    rows = torch.randn(L, B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    rows[0, 0, 0] = 0                       # an all-zero row: scale 1
    shared = torch.full((B,), 600, dtype=torch.int32, device="cuda")
    per_lane = torch.randint(512, S, (B,), generator=gen, device="cuda").int()
    for label, slots in (("shared slot", shared), ("per-lane slots", per_lane)):
        out = kw.kv_write_rows_q8({k: v.clone() for k, v in cache.items()}, rows, slots)
        ref = kw.kv_write_rows_q8_plain({k: v.clone() for k, v in cache.items()}, rows, slots)
        torch.cuda.synchronize()
        if not (torch.equal(out["q"], ref["q"]) and torch.equal(out["s"], ref["s"])):
            raise AssertionError(f"K3 int8 {label}: differs from the plain version")
        print(f"K3 kv_write_rows_q8 {label}: bit-exact")
    work = {k: v.clone() for k, v in cache.items()}
    ms = cuda_ms(lambda: kw.kv_write_rows_q8(work, rows, shared))
    plain_ms = cuda_ms(lambda: kw.kv_write_rows_q8_plain(work, rows, shared))
    # bf16 rows in; int8 rows and f32 scales out.
    b = bound(L * B * hkv * (D * 2 + D + 4), 0, 1.0)
    print(f"K3 kv_write_rows_q8 L={L} B={B} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms (bytes)")
    # No one PyTorch call quantizes a row and stores it with its scale.
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


#: Decoder (K, N) of every decode-time matmul (1.7B widths): fused QKV, o,
#: fused gate|up, down, and the tied lm head (f32 out).
DECODE_MATMULS = (
    ("wqkv", 2048, 4096), ("wo", 2048, 2048), ("wgu", 2048, 12288),
    ("wd", 6144, 2048), ("lm_head", 2048, 151936),
)
#: (M, K, N) of the W8A8 matmuls at the smoke batch (8 clips, 30 s bucket):
#: decoder prefill M = 8 x 448 rows, encoder M = 8 x 416 tokens.
PREFILL_MATMULS = (
    ("dec wqkv", 3584, 2048, 4096), ("dec wo", 3584, 2048, 2048),
    ("dec wgu", 3584, 2048, 12288), ("dec wd", 3584, 6144, 2048),
    ("enc wq", 3328, 1024, 1024), ("enc fc1", 3328, 1024, 4096),
    ("enc fc2", 3328, 4096, 1024), ("enc conv_out", 3328, 7680, 1024),
    ("enc proj2", 3328, 1024, 2048),
)


def check_quantized_matmul(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import quantized_matmul as qm

    worst, times = 0.0, []
    for B in (1, 8, 96):
        for name, K, N in DECODE_MATMULS:
            out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
            x = torch.randn(B, K, generator=gen, device="cuda").bfloat16()
            wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
            s = torch.rand(N, generator=gen, device="cuda") * 1e-3
            out = qm.quantized_matmul(x, wq, s, out_dtype)
            torch.cuda.synchronize()
            ref = x.float() @ (wq.float() * s)
            rtol = 1e-5 if out_dtype == torch.float32 else 8e-3
            err = _close(f"K9 {name} M={B}", out, ref, 1e-5 * ref.abs().max().item(), rtol)
            ms = cuda_ms(lambda: qm.quantized_matmul(x, wq, s, out_dtype))
            plain_ms = cuda_ms(lambda: qm.quantized_matmul_plain(x, wq, s, out_dtype))
            library_ms = weight_int8pack_ms(x, wq, s) if out_dtype == torch.bfloat16 else None
            nbytes = K * N + B * K * 2 + B * N * out.element_size() + N * 4
            b = bound(nbytes, 2 * B * K * N, PEAK_BF16_TFLOPS * 1e12)
            gbps = nbytes / (ms * 1e-3) / 1e9
            lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"K9 quantized_matmul {name} M={B} K={K} N={N}: max_abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, _weight_int8pack_mm {lib}, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); {gbps:.0f} GB/s = "
                  f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, name, ms, plain_ms, b, library_ms))
            del wq
    # The record: B=8 decode, summed over one layer's four matmuls.
    layer = [t for t in times if t[0] == 8 and t[1] != "lm_head"]
    libs = [t[5] for t in layer]
    return {"max_abs_err": worst, "ms": sum(t[2] for t in layer),
            "plain_ms": sum(t[3] for t in layer), **_sum_bounds([t[4] for t in layer]),
            "library_ms": None if None in libs else sum(libs)}


def check_w8a8_matmul(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import w8a8_matmul as w8

    times = []
    for name, M, K, N in PREFILL_MATMULS:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand(N, generator=gen, device="cuda") * 1e-3
        out = w8.w8a8_matmul(x, wq, ws, torch.float32)
        ref = w8.w8a8_matmul_plain(x, wq, ws, torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = (out - ref).abs().max().item()
            raise AssertionError(f"K10 {name}: not bit-exact (max abs err {err:.3e})")
        ms = cuda_ms(lambda: w8.w8a8_matmul(x, wq, ws))
        plain_ms = cuda_ms(lambda: w8.w8a8_matmul_plain(x, wq, ws, torch.bfloat16))
        b = bound(M * K * 2 + K * N + M * N * 2 + N * 4, 2 * M * N * K, PEAK_INT8_TOPS * 1e12)
        tops = 2 * M * N * K / (ms * 1e-3) / 1e12
        print(f"K10 w8a8_matmul {name} M={M} K={K} N={N}: bit-exact (f32 out); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); {tops:.1f} TOPS = {tops / PEAK_INT8_TOPS:.1%} of the int8 peak")
        times.append((name, ms, plain_ms, b))
        del wq
    # The record: one decoder layer's four prefill matmuls.  No one PyTorch
    # call computes it (torch._int_mm takes int8 operands: the row quantize
    # and the scale epilogue are further calls).
    dec = [t for t in times if t[0].startswith("dec")]
    return {"max_abs_err": 0.0, "ms": sum(t[1] for t in dec), "plain_ms": sum(t[2] for t in dec),
            **_sum_bounds([t[3] for t in dec]), "library_ms": None}


def weight_int8pack_ms(x, wq, s) -> float | None:
    """CUDA-event ms of ``torch._weight_int8pack_mm`` (bf16 x, int8 (N, K)
    weight, per-column scale: K9's function in one PyTorch call), or None
    where the card's torch has no CUDA implementation of it."""
    import torch

    w_nk = wq.t().contiguous()
    scales = s.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w_nk, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, scales))


def check_kv_write_span(gen) -> dict:
    """K5 at the verify pass's shapes: lane b's T=4 rows at per-lane slots,
    one lane with slot + T > S (its overflow rows dropped) and one wholly
    past S; bit-exact against the plain version."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    L, B, hkv, T, S, D = 28, 8, 8, 4, 640, 128
    cache = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
    rows = torch.randn(L, B, hkv, T, D, generator=gen, device="cuda").bfloat16()
    slots = torch.tensor([512, 515, 531, 560, 600, 617, S - 2, S + 5],
                         dtype=torch.int32, device="cuda")
    out = kw.kv_write_span_batch(cache.clone(), rows, slots)
    ref = kw.kv_write_span_batch_plain(cache.clone(), rows, slots)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K5: differs from the plain version")
    if not (torch.equal(out[:, 6, :, : S - 2], cache[:, 6, :, : S - 2])
            and torch.equal(out[:, 7], cache[:, 7])):
        raise AssertionError("K5: rows past the cache end were not dropped")
    print(f"K5 kv_write_span_batch L={L} B={B} T={T} S={S}, slots {slots.tolist()}: "
          f"bit-exact, overflow rows dropped")
    work = cache.clone()
    ms = cuda_ms(lambda: kw.kv_write_span_batch(work, rows, slots))
    plain_ms = cuda_ms(lambda: kw.kv_write_span_batch_plain(work, rows, slots))
    lane, row, slot = kw.span_indices(slots, T, S)
    vals = rows[:, lane, :, row].contiguous()

    def index_put():
        work[:, lane, :, slot] = vals

    library_ms = cuda_ms(index_put)
    # The valid rows, read once and written once.
    nbytes = 2 * L * hkv * D * 2 * int(lane.numel())
    b = bound(nbytes, 0, 1.0)
    gbps = nbytes / (ms * 1e-3) / 1e9
    print(f"K5 kv_write_span_batch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_put_ {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms (bytes); "
          f"{lane.numel()} valid span rows per layer and head, {gbps:.0f} GB/s = "
          f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}


def smoke_prompt_lens() -> list[int]:
    """Prompt lengths of the 8 smoke clips (the model's prompt builder)."""
    from types import SimpleNamespace

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR
    from qwen3_asr_tpu_torch.audio.mel import HOP_LENGTH

    fake = SimpleNamespace(_config=ModelConfig())
    tok = StubTokenizer()
    return [len(tok.build_prompt(Qwen3ASR._n_audio_tokens(fake, len(c) // HOP_LENGTH)))
            for c in smoke_clips()]


def paged_case(gen, T: int, q8: bool, L: int = 2) -> dict:
    """Inputs at the smoke batch's shapes: B=8, 16/8 heads, PS=256, the 8
    clips' prompt lengths, dcount 64, pages shuffled over a pool sized as
    the engine's (1 + 8 x 4 pages)."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    B, hq, hkv, D, PS, max_pages = 8, 16, 8, 128, 256, 4
    plen = np.asarray(smoke_prompt_lens(), np.int32)
    dcount = np.full(B, 64, np.int32)
    n_pages = 1 + B * max_pages
    free = list(np.random.default_rng(SEED).permutation(np.arange(1, n_pages)))
    table = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        need = -(-int(plen[b]) // PS) + -(-int(dcount[b]) // PS)
        table[b, :need] = [free.pop() for _ in range(need)]
    shape = (L, n_pages, hkv, PS, D)
    if q8:
        kpool = quantize_kv(torch.randn(shape, generator=gen, device="cuda"))
        vpool = quantize_kv(torch.randn(shape, generator=gen, device="cuda"))
    else:
        kpool = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        vpool = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    to = lambda x: torch.from_numpy(x).cuda()   # noqa: E731
    return dict(
        q=torch.randn(B, hq, T, D, generator=gen, device="cuda").bfloat16(),
        kpool=kpool, vpool=vpool,
        k_new=torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16(),
        v_new=torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16(),
        table=to(table), plen=to(plen), dcount=to(dcount), rows=int((plen + dcount).sum()),
    )


def check_decode_paged(gen, T: int, q8: bool) -> dict:
    """K6 (T = 1) or K7 (T = 4, 8 query rows per KV head), bf16 or int8
    pool, against the plain version in float32 (atol 2e-2 + rtol 2e-2 of
    the bf16 kernel, as K2)."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention_paged as dap

    c = paged_case(gen, T, q8)
    B, hq, _, D = c["q"].shape
    hkv = c["k_new"].shape[1]
    if T == 1:
        fn = dap.decode_attention_paged_q8 if q8 else dap.decode_attention_paged
        q = c["q"][:, :, 0]
        label = "K6 decode_attention_paged" + ("_q8" if q8 else "")
    else:
        fn = dap.decode_attention_paged_verify_q8 if q8 else dap.decode_attention_paged_verify
        q = c["q"]
        label = "K7 decode_attention_paged_verify" + ("_q8" if q8 else "")
    args = (c["kpool"], c["vpool"], c["k_new"], c["v_new"], 1, c["table"], c["plen"],
            c["dcount"])
    out = fn(q, *args)
    torch.cuda.synchronize()
    plain = dap.paged_attention_q8_plain if q8 else dap.paged_attention_plain
    f32 = (lambda p: p) if q8 else (lambda p: p.float())
    ref = plain(c["q"].float(), f32(c["kpool"]), f32(c["vpool"]), c["k_new"].float(),
                c["v_new"].float(), 1, c["table"], c["plen"], c["dcount"], D ** -0.5)
    err = _close(label, out if T > 1 else out[:, :, None], ref, 2e-2, 2e-2)
    ms = cuda_ms(lambda: fn(q, *args))
    plain_ms = cuda_ms(lambda: plain(c["q"], *args, D ** -0.5))
    # The valid rows' K and V (int8 rows plus one f32 scale each), read once,
    # plus q, the fresh rows and the output; QK and PV over the valid rows
    # and the fresh block.
    row_bytes = (D + 4) if q8 else D * 2
    rows = c["rows"]
    b = bound(rows * hkv * row_bytes * 2 + B * T * (2 * hq + 2 * hkv) * D * 2,
              4 * hq * T * D * (rows + B * T), PEAK_BF16_TFLOPS * 1e12)
    gbps = rows * hkv * row_bytes * 2 / (ms * 1e-3) / 1e9
    print(f"{label} B={B} T={T} PS=256 plen={c['plen'].tolist()} dcount=64: "
          f"max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {rows} valid rows, {gbps:.0f} GB/s = "
          f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
    # No one PyTorch call: a page-table gather, two masked intervals and a
    # fresh (causal) block of rows not in the pool.
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


def check_kv_write_paged(gen, q8: bool) -> dict:
    """K8 at the engine's shapes (L=28, B=8, PS=256, the 33-page pool): the
    step's one row per lane and the verify's 4, one lane on the trash page,
    one past the pool (clipped); bit-exact outside page 0."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    L, B, hkv, PS, D, n_pages = 28, 8, 8, 256, 128, 33
    if q8:
        pool = quantize_kv(torch.randn(L, n_pages, hkv, PS, D, generator=gen, device="cuda"))
        fn, plain, label = kw.kv_write_rows_paged_q8, kw.kv_write_rows_paged_q8_plain, "K8 int8"
    else:
        pool = torch.randn(L, n_pages, hkv, PS, D, generator=gen, device="cuda").bfloat16()
        fn, plain, label = kw.kv_write_rows_paged, kw.kv_write_rows_paged_plain, "K8 bf16"
    clone = (lambda p: {k: v.clone() for k, v in p.items()}) if q8 else (lambda p: p.clone())
    rec = None
    for T in (1, 4):
        rows = torch.randn(L, B, hkv, T, D, generator=gen, device="cuda").bfloat16()
        pages = torch.tensor([5, 9, 0, 17, 22, 30, 2, n_pages + 4], dtype=torch.int32,
                             device="cuda")[:, None].repeat(1, T).contiguous()
        offs = (torch.tensor([64, 100, 7, 0, 255 - T, 128, 31, 90], device="cuda")[:, None]
                + torch.arange(T, device="cuda")).int().contiguous()
        out, ref = fn(clone(pool), rows, pages, offs), plain(clone(pool), rows, pages, offs)
        torch.cuda.synchronize()
        outs = (out["q"], out["s"]) if q8 else (out,)
        refs = (ref["q"], ref["s"]) if q8 else (ref,)
        if not all(torch.equal(o[:, 1:], r[:, 1:]) for o, r in zip(outs, refs)):
            raise AssertionError(f"{label} T={T}: differs from the plain version outside page 0")
        print(f"{label} kv_write_rows_paged T={T}: bit-exact outside the trash page")
        if T == 1:
            work = clone(pool)
            ms = cuda_ms(lambda: fn(work, rows, pages, offs))
            plain_ms = cuda_ms(lambda: plain(work, rows, pages, offs))
            library_ms = None
            if not q8:
                keep, p, o = kw.paged_indices(pages, offs, n_pages, PS)
                vals = rows.permute(1, 3, 0, 2, 4).reshape(B * T, L, hkv, D)[keep].contiguous()

                def index_put():
                    work[:, p, :, o] = vals

                library_ms = cuda_ms(index_put)
            # bf16 rows in; bf16 rows, or int8 rows and f32 scales, out.
            b = bound(L * B * T * hkv * (D * 2 + ((D + 4) if q8 else D * 2)), 0, 1.0)
            lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
            print(f"{label} kv_write_rows_paged L={L} B={B} T=1: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, index_put_ {lib}, bound {b['bound_ms']:.4f} ms (bytes)")
            # int8: no one PyTorch call quantizes a row and stores it with its scale.
            rec = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b,
                   "library_ms": library_ms}
    return rec


def _params_to(tree, device, dtype):
    """A parameter tree on ``device``: float tensors in ``dtype``, int8
    ``{"q", "s"}`` weights with their own dtypes."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return {k: v.to(device) for k, v in tree.items()}
        return {k: _params_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype)


#: The decode modes whose split step runs its own kernel with a shared write
#: slot, and that kernel's launch counter.
DECODE_MODES = (("auto", "decode_attention"), ("3", "decode_attention_hbm2"),
                ("4", "decode_attention_hbm3"))


def reference_check(quantized: bool) -> None:
    """Kernels (GPU) against the plain path (float32, CPU) on one small
    decoder: prefill logits, one split-decode step and, on the bf16 cache,
    one verify-split forward (T=4 per lane at per-lane write slots, one
    lane's span running past the cache end); on the bf16 cache once under
    each of :data:`DECODE_MODES`.  ``quantized``: int8 weights, W8A8 prefill
    and the int8 cache on both sides (no verify: the int8 cache never
    speculates)."""
    import torch

    from qwen3_asr_tpu_torch.config import RuntimeConfig, TextDecoderConfig
    from qwen3_asr_tpu_torch.models import decoder as dec_mod
    from qwen3_asr_tpu_torch.models.decoder import (
        decoder_forward, decoder_logits, embed_tokens, fuse_decoder_params,
        init_decoder_params,
    )
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.ops.quant import quantize_decoder_params
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv_cache
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    cfg = TextDecoderConfig(
        hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, intermediate_size=512,
        vocab_size=1024,
    )
    g = torch.Generator().manual_seed(SEED)
    ref_params = fuse_decoder_params(init_decoder_params(cfg, g, torch.float32, "cpu"))
    runtime = RuntimeConfig()
    if quantized:
        ref_params = quantize_decoder_params(ref_params)
        # 3 x 77 prefill rows pass the W8A8 gate; the 3-row decode step and
        # the lm head stay weight-only.
        runtime = RuntimeConfig(**INT8_RUNTIME, act_quant_min_rows=64)
    gpu_params = _params_to(ref_params, "cuda", torch.bfloat16)
    B, P, Ta, pb, tb = 3, 77, 60, 256, 128
    features = torch.randn(B, Ta, cfg.hidden_size, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    n_audio = torch.tensor([60, 41, 17])
    plen = torch.tensor([77, 58, 34])
    draft = torch.randint(0, cfg.vocab_size, (B, 3), generator=g)   # verify ids 1..3
    ws = torch.tensor([pb + 1, pb + 3, pb + tb - 2], dtype=torch.int32)
    cur = None                       # step token: the f32 run's first argmax

    def run(params, dev):
        nonlocal cur
        gen = Generator(params, cfg, runtime)
        dtype = params["final_norm"].dtype
        with torch.inference_mode():
            kv, logits = gen.prefill(
                features.to(dev, dtype), ids.to(dev), n_audio.to(dev), plen.to(dev),
                pb + tb,
            )
            if quantized:
                kv = quantize_kv_cache(kv)
            if cur is None:
                cur = logits.argmax(-1).cpu()
            embeds = embed_tokens(params, cur.to(dev))[:, None, :]
            pos = plen.to(dev)[:, None]       # prompt_len + count - 1, count 1
            hidden, kv = decoder_forward(
                params, cfg, embeds, pos, kv, write_slots=pb,
                decode_ctx=(plen.to(dev, torch.int32), pb, pb),
            )
            step_logits = decoder_logits(params, cfg, hidden)[:, 0]
            if quantized:
                return logits.float().cpu(), step_logits.float().cpu()
            verify_ids = torch.cat([cur[:, None], draft], dim=1).to(dev)
            w = ws.to(dev)
            pos = plen.to(dev)[:, None] + (w.long() - pb)[:, None] + torch.arange(4, device=dev)
            hidden, kv = decoder_forward(
                params, cfg, embed_tokens(params, verify_ids), pos, kv, write_slots=w,
                decode_ctx=(plen.to(dev, torch.int32), w, pb),
            )
            verify_logits = decoder_logits(params, cfg, hidden)
        return logits.float().cpu(), step_logits.float().cpu(), verify_logits.float().cpu()

    ref = run(ref_params, "cpu")
    labels = ("prefill logits", "decode-step logits", "verify-split logits (T=4)")
    # The bf16 step runs once per decode mode with a shared slot: K2
    # ("auto"), K11a ("3"), K11b ("4"); the f32 CPU reference is one function.
    modes = (("auto", "decode_attention_q8"),) if quantized else DECODE_MODES
    for mode, kernel in modes:
        what = "int8 decoder, GPU kernels vs f32 CPU plain" if quantized else \
            f"bf16 GPU kernels, decode mode {mode!r}, vs f32 CPU plain"
        saved, dec_mod.DECODE_KERNEL_MODE = dec_mod.DECODE_KERNEL_MODE, mode
        before = LAUNCHES[kernel]
        try:
            out = run(gpu_params, "cuda")
        finally:
            dec_mod.DECODE_KERNEL_MODE = saved
        if LAUNCHES[kernel] - before < cfg.num_hidden_layers:
            raise AssertionError(f"reference check, decode mode {mode!r}: {kernel} not launched")
        for i, label in enumerate(labels[: len(ref)]):
            rel = ((out[i] - ref[i]).abs().max() / ref[i].abs().max()).item()
            print(f"reference check ({label}, {what}): "
                  f"max abs err / max |ref| = {rel:.3e}")
            if not rel < 5e-2:
                raise AssertionError(f"{label}: relative error {rel:.3e} >= 5e-2")


def reference_check_paged() -> None:
    """Kernels (GPU, bf16) against the plain path (CPU, float32) on one small
    decoder, through the paged pool: a prefill's rows scattered into
    shuffled pages (PS=128), then one paged step (K6, K8) and one paged
    verify (K7 at T=4, K8) on the rows the step wrote."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.config import TextDecoderConfig
    from qwen3_asr_tpu_torch.models.decoder import (
        decoder_logits, decoder_paged_step, decoder_paged_verify, embed_tokens,
        fuse_decoder_params, init_decoder_params,
    )
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    cfg = TextDecoderConfig(
        hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, intermediate_size=512, vocab_size=1024,
    )
    g = torch.Generator().manual_seed(SEED + 7)
    ref_params = fuse_decoder_params(init_decoder_params(cfg, g, torch.float32, "cpu"))
    gpu_params = _params_to(ref_params, "cuda", torch.bfloat16)
    B, P, Ta, pb, PS = 3, 77, 60, 256, 128
    features = torch.randn(B, Ta, cfg.hidden_size, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    n_audio = torch.tensor([60, 41, 17])
    plen = torch.tensor([77, 58, 34], dtype=torch.int32)
    draft = torch.randint(0, cfg.vocab_size, (B, 3), generator=g)
    npg, max_pages = pb // PS, pb // PS + 1
    n_pages = 1 + B * max_pages
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    table = torch.from_numpy(perm.reshape(B, max_pages).astype(np.int32))
    lanes = torch.arange(B)
    cur = None

    def run(params, dev):
        nonlocal cur
        gen = Generator(params, cfg)
        dtype = params["final_norm"].dtype
        with torch.inference_mode():
            (k, v), logits = gen.prefill(features.to(dev, dtype), ids.to(dev),
                                         n_audio.to(dev), plen.long().to(dev), pb)
            pools = []
            for c in (k, v):
                pool = torch.zeros((cfg.num_hidden_layers, n_pages) + c.shape[2:3] + (PS, 128),
                                   dtype=dtype, device=dev)
                src = c.reshape(c.shape[0], B, c.shape[2], npg, PS, 128).transpose(2, 3)
                pool[:, table[:, :npg].reshape(-1).long().to(dev)] = src.reshape(
                    c.shape[0], B * npg, c.shape[2], PS, 128)
                pools.append(pool)
            if cur is None:                  # the f32 run's first argmax
                cur = logits.argmax(-1).cpu()
            tab, pl = table.to(dev), plen.to(dev)
            pp = (plen.long() + PS - 1) // PS
            # The step: decode row 0 of each lane at its first decode page.
            hidden, pools = decoder_paged_step(
                params, cfg, embed_tokens(params, cur.to(dev))[:, None], pl.long()[:, None],
                tuple(pools), tab, pl, torch.zeros(B, dtype=torch.int32, device=dev),
                table[lanes, pp].to(dev), torch.zeros(B, dtype=torch.int32, device=dev),
            )
            step_logits = decoder_logits(params, cfg, hidden)[:, 0]
            # The verify: decode rows 1..4 after the step's row.
            verify_ids = torch.cat([cur[:, None], draft], dim=1).to(dev)
            pos = pl.long()[:, None] + 1 + torch.arange(4, device=dev)
            rows = 1 + torch.arange(4)
            pages = table[lanes[:, None], pp[:, None] + rows[None, :] // PS].to(dev)
            offs = (rows % PS).int()[None, :].repeat(B, 1).to(dev)
            hidden, _ = decoder_paged_verify(
                params, cfg, embed_tokens(params, verify_ids), pos, pools, tab, pl,
                torch.ones(B, dtype=torch.int32, device=dev), pages, offs,
            )
            verify_logits = decoder_logits(params, cfg, hidden)
        return step_logits.float().cpu(), verify_logits.float().cpu()

    ref = run(ref_params, "cpu")
    out = run(gpu_params, "cuda")
    for label, o, r in zip(("paged step logits (K6, K8)", "paged verify logits (K7 T=4, K8)"),
                           out, ref):
        rel = ((o - r).abs().max() / r.abs().max()).item()
        print(f"reference check ({label}, bf16 GPU kernels vs f32 CPU plain): "
              f"max abs err / max |ref| = {rel:.3e}")
        if not rel < 5e-2:
            raise AssertionError(f"{label}: relative error {rel:.3e} >= 5e-2")


class StubTokenizer:
    """Prompt-structure-preserving tokenizer: no tokenizer files are on the
    card's machine.  ``decode`` writes ids as ``t<id>`` words."""

    def encode(self, text):
        return [sum(map(ord, text)) % 1000 + 100]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{t}" for t in ids)

    def build_prompt(self, n_audio_tokens, language="English"):
        from qwen3_asr_tpu_torch.tokenizer import build_detect_prompt, build_prompt

        if language is None:
            return build_detect_prompt(n_audio_tokens)
        return build_prompt(n_audio_tokens, self.encode(f" {language}"))


def _ids(results) -> list[list[int]]:
    return [[int(w[1:]) for w in r.text.split()] for r in results]


def check_lm_head_f32(model, hidden) -> None:
    """The bf16 lm head's logits equal the f32 upcast product on a few rows
    (f32 accumulator; a bf16-rounded output would be off by up to 1/256 of
    each logit)."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import decoder_logits
    from qwen3_asr_tpu_torch.ops.norms import rms_norm

    params, cfg = model._decoder_params, model._config.text_decoder
    h = hidden[:4].reshape(-1, 1, hidden.shape[-1])
    with torch.inference_mode():
        logits = decoder_logits(params, cfg, h)
        hn = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        ref = hn.float() @ params["embedding"].float().T
    if logits.dtype != torch.float32:
        raise AssertionError(f"lm head logits are {logits.dtype}, not float32")
    err = _close("bf16 lm head vs f32 product", logits, ref,
                 1e-5 * ref.abs().max().item(), 1e-5)
    print(f"bf16 lm head: f32 logits of {h.shape[0]} prefill rows vs the f32 upcast "
          f"product: max_abs_err={err:.3e} (max |logit| {ref.abs().max().item():.3f})")


def smoke_clips():
    """The smoke batch: 8 tone-plus-noise clips of 4-30 s (133 s of audio)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    clips = []
    for d in (4.0, 7.5, 11.0, 14.5, 18.0, 22.0, 26.0, 30.0):
        t = np.arange(int(d * 16000)) / 16000.0
        f = rng.uniform(120.0, 900.0)
        clip = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(len(t))
        clips.append(clip.astype(np.float32))
    return clips


def runtime_tag(runtime: dict | None) -> str:
    return f"RuntimeConfig({', '.join(f'{k}={v!r}' for k, v in (runtime or {}).items())})"


def build_model(runtime: dict | None, base=None):
    """The 1.7B model from random weights (seed 0) on the card, or, given
    ``base``, a model sharing its weights under another runtime (with
    ``quantization="int8"`` the decoder is quantized from them)."""
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig

    t0 = time.perf_counter()
    rt = RuntimeConfig(**(runtime or {}))
    if base is None:
        model = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(), runtime=rt,
                                     dtype=torch.bfloat16, seed=SEED, device="cuda")
        how = f"from_random(ModelConfig(), bf16, seed={SEED})"
    else:
        model = Qwen3ASR(base._config, base._encoder_params, base._decoder_params,
                         base._tokenizer, rt)
        how = "the same weights"
    torch.cuda.synchronize()
    print(f"{how}, {runtime_tag(runtime)} on cuda: {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return model


class Watch:
    """Wraps the decode loop's logits function while active (``module``'s
    ``decoder_logits``: the generator's, or the engine's): one device flag
    for NaN logits (no sync per step) and the first lm-head input."""

    def __init__(self, module=None):
        import torch

        from qwen3_asr_tpu_torch.runtime import generate

        self.generate = module or generate
        self.nan_seen = torch.zeros((), dtype=torch.bool, device="cuda")
        self.first_hidden = []

    def __enter__(self):
        import torch

        real_logits = self.real_logits = self.generate.decoder_logits

        def logits(params, cfg, hidden):
            out = real_logits(params, cfg, hidden)
            self.nan_seen.logical_or_(torch.isnan(out).any())
            if not self.first_hidden:
                self.first_hidden.append(hidden.clone())
            return out

        self.generate.decoder_logits = logits
        return self

    def __exit__(self, *exc):
        self.generate.decoder_logits = self.real_logits


def top_two_gaps(rows):
    """(choices, 2, B) on the host: per recorded token choice, the gap
    between the top two penalized logits and the row's max |logit|."""
    import torch

    out = []
    for r in rows:
        top2 = r.topk(2, dim=-1).values
        out.append(torch.stack([top2[:, 0] - top2[:, 1], r.abs().amax(-1)]))
    return torch.stack(out).cpu()


def check_launches(label: str, launches: dict, path=(), never=()) -> None:
    for name in path:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    for name in never:
        if launches.get(name, 0):
            raise AssertionError(f"{label}: kernel {name} was launched {launches[name]} times")
    print(f"{label} launches: {launches}")


def check_ids(label: str, ids: list[list[int]], vocab: int) -> None:
    flat = [t for seq in ids for t in seq]
    if not flat or min(flat) < 0 or max(flat) >= vocab:
        raise AssertionError(f"{label}: no tokens, or token ids outside [0, vocab)")


def print_stats(label: str, card: str, st) -> None:
    steps = max(st.n_decode_steps, 1)
    decode_ms = st.stages["decode"] * 1e3
    kind = "verify iterations" if st.n_spec_forwards else "steps"
    spec = (f", {st.spec_tokens_per_forward:.3f} tokens per lane-forward"
            if st.n_spec_forwards else "")
    print(
        f"{label} [{card}]: audio {st.audio_seconds:.1f} s, prepare "
        f"{st.stages['prepare'] * 1e3:.1f} ms, mel+encoder+prefill "
        f"{st.stages['prefill'] * 1e3:.1f} ms, decode {decode_ms:.1f} ms over "
        f"{st.n_decode_steps} {kind} = {decode_ms / steps:.2f} ms/iteration, "
        f"{st.n_generated_tokens} tokens = {decode_ms / max(st.n_generated_tokens, 1):.3f} "
        f"ms per emitted token{spec}, RTFx {st.rtfx:.1f}"
    )


def slice_phase(card: str, model, runtime: dict | None, path, never=(),
                lm_head: bool = False, record_gaps: bool = False) -> dict:
    """The 1.7B path through the entry points: a warm-up, then greedy
    ``transcribe_batch`` of the smoke batch (``max_tokens=64``) twice and one
    ``transcribe`` of the 30 s clip, with the launch counters set to 0 just
    before and read just after.  Checks ids, NaN, run-to-run identity and
    the path's launches."""
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    vocab = model._config.text_decoder.vocab_size
    tag = runtime_tag(runtime)
    clips = smoke_clips()
    out = {"gaps": []}
    with Watch() as watch:
        model.warm_up(durations=(4.0,), batch_sizes=(8,), max_tokens=4)
        watch.first_hidden.clear()
        LAUNCHES.clear()
        runs = []
        for i in range(2):
            with Choices() if record_gaps and i == 0 else nullcontext() as rec:
                runs.append((_ids(model.transcribe_batch(clips, max_tokens=64)), model.last_stats))
            if rec is not None:
                out["gaps"].append(top_two_gaps(rec.rows))
        with Choices() if record_gaps else nullcontext() as rec:
            single = model.transcribe(clips[-1], max_tokens=64)
        if rec is not None:
            out["gaps"].append(top_two_gaps(rec.rows))
        del rec
        launches = dict(LAUNCHES)
        if bool(watch.nan_seen):
            raise AssertionError(f"{tag}: NaN logits on the path")
        if lm_head:
            check_lm_head_f32(model, watch.first_hidden[0])
    (ids_a, stats_a), (ids_b, stats_b) = runs
    if ids_a != ids_b:
        raise AssertionError(f"{tag}: two greedy transcribe_batch runs gave different tokens")
    check_ids(tag, ids_a + _ids([single]), vocab)
    check_launches(f"path {tag}", launches, path, never)
    for label, st in (("transcribe_batch B=8 run 1", stats_a),
                      ("transcribe_batch B=8 run 2", stats_b),
                      ("transcribe B=1", model.last_stats)):
        print_stats(f"{label} {tag}", card, st)
    out.update(launches=launches, ids=(ids_a, _ids([single])[0]),
               stats=(stats_a, stats_b, model.last_stats))
    return out


def compare_streams(label: str, plain, spec, gaps) -> None:
    """Each lane's speculative stream equals its plain stream, or first
    differs where the plain run's top two penalized logits lie within
    NEAR_TIE of that row's max |logit| (a bf16 near-tie: the verify
    forward's M = 4B-row products may round otherwise than the step's
    M = B).  ``gaps`` (choices, 2, B): position p of a lane is the plain
    run's p-th token choice.  Prints the median top-two gap of the plain
    run's choices beside the limit."""
    import torch

    rel = gaps[:, 0] / gaps[:, 1]
    live = torch.arange(gaps.shape[0])[:, None] < torch.tensor([len(p) for p in plain])[None, :]
    print(f"{label}: median plain top-two gap {rel[live].median().item():.2e} of max "
          f"|logit| over {int(live.sum())} choices, {(rel[live] <= NEAR_TIE).float().mean():.1%} "
          f"of them within the near-tie limit {NEAR_TIE:g}")
    identical, diverged = 0, []
    for b, (p, s) in enumerate(zip(plain, spec)):
        if p == s:
            identical += 1
            continue
        i = next((j for j, (x, y) in enumerate(zip(p, s)) if x != y), min(len(p), len(s)))
        if i >= gaps.shape[0]:
            raise AssertionError(f"{label} lane {b}: diverges at {i}, past the recorded steps")
        gap, top = float(gaps[i, 0, b]), float(gaps[i, 1, b])
        diverged.append((b, i, gap, top))
        print(f"{label} lane {b}: first divergence at position {i}, plain top-two gap "
              f"{gap:.4e} = {gap / top:.2e} of max |logit| {top:.3f}")
        if gap > NEAR_TIE * top:
            raise AssertionError(f"{label} lane {b}: diverges at {i} where the plain "
                                 f"run's top-two gap is {gap / top:.2e} of max |logit|")
    print(f"{label}: {identical} of {len(plain)} lanes identical in full, "
          f"{len(diverged)} diverge at a near-tie")


class Choices:
    """Records, while active, every greedy token choice of the decode loops
    (its penalized logits row (B, V), on the device), the lanes' counts at
    each verify iteration, and each decode call's token lists.  ``drafts``
    (B, n) replaces the n-gram draft with each lane's next ``gamma`` tokens
    of that stream (teacher forcing); ``forced`` (B, n) makes the loop emit
    that stream whatever its own choice."""

    def __init__(self, drafts=None, forced=None):
        from qwen3_asr_tpu_torch.runtime import generate

        self.generate = generate
        self.drafts, self.forced = drafts, forced
        self.rows, self.counts, self.streams = [], [], []
        self.n_sampled = 0

    def __enter__(self):
        import torch

        g = self.generate
        self.saved = (g.apply_repetition_penalty, g.ngram_draft, g._Request.sample,
                      g.Generator.decode)
        real_penalty, real_draft, real_sample, real_decode = self.saved

        def penalty(lg, recent, pen):
            out = real_penalty(lg, recent, pen)
            self.rows.append(out)
            return out

        def draft(tokens, counts, n, gamma):
            self.counts.append(counts.clone())
            if self.drafts is None:
                return real_draft(tokens, counts, n=n, gamma=gamma)
            stream, lens = self.drafts
            idx = counts.long()[:, None] + torch.arange(gamma, device=counts.device)[None, :]
            return stream.gather(1, idx.clamp(max=stream.shape[1] - 1)), idx < lens[:, None]

        def sample(req, logits, recent, pen):
            out = real_sample(req, logits, recent, pen)
            j, self.n_sampled = self.n_sampled, self.n_sampled + 1
            if self.forced is None or j >= self.forced[0].shape[1]:
                return out
            return self.forced[0][:, j]

        def decode(gen, *args, **kwargs):
            out = real_decode(gen, *args, **kwargs)
            self.streams.append(out)
            return out

        g.apply_repetition_penalty, g.ngram_draft = penalty, draft
        g._Request.sample, g.Generator.decode = sample, decode
        return self

    def __exit__(self, *exc):
        g = self.generate
        (g.apply_repetition_penalty, g.ngram_draft, g._Request.sample,
         g.Generator.decode) = self.saved


def padded(streams):
    """Token lists as a (B, n) int64 tensor on the card and their lengths."""
    import torch

    n = max(len(s) for s in streams)
    out = torch.zeros((len(streams), n), dtype=torch.long)
    for b, s in enumerate(streams):
        out[b, : len(s)] = torch.tensor(s)
    return out.cuda(), torch.tensor([len(s) for s in streams], device="cuda")


def hold_to_plain(label: str, base, model, clips, teacher=None, penalty: float = 1.2):
    """One greedy ``transcribe_batch`` of ``clips`` through the speculative
    loop of ``model`` (n-gram drafts, or with ``teacher`` each lane's next
    tokens of that stream), then the plain loop of ``base`` (same weights,
    ``"off"``) forced to emit the speculative stream.  Both see the same
    prefix at every position, so every token the verify forward emitted is
    held to the plain step's row: the token is the verify row's argmax (the
    accept chain emitted what the verify forward chose), |verify row - plain
    row| <= LOGIT_TOL of max |plain row|, and the token is the plain argmax
    unless the plain top two lie within NEAR_TIE of max |logit|.  Returns
    (stream, the plain rows (choices, B, V))."""
    import torch

    T = model._runtime.spec_gamma + 1
    kw = dict(max_tokens=64, repetition_penalty=penalty)
    with Choices(drafts=teacher) as spec:
        model.transcribe_batch(clips, **kw)
    stream = spec.streams[-1]
    K = len(spec.counts)
    if len(spec.rows) != 1 + T * K:
        raise AssertionError(f"{label}: {len(spec.rows)} choices for {K} verify iterations")
    with Choices(forced=padded(stream)) as plain:
        base.transcribe_batch(clips, **kw)
    if plain.streams[-1] != stream:
        raise AssertionError(f"{label}: the forced plain run left the speculative stream")
    P = torch.stack(plain.rows)               # (choices, B, V): choice i made token i
    B = len(stream)
    lanes = torch.arange(B, device="cuda")
    counts = spec.counts + [torch.tensor([len(s) for s in stream], device="cuda")]
    per = []
    with torch.inference_mode():
        for k in range(K):
            for t in range(T):
                s_row = spec.rows[1 + k * T + t]
                i = counts[k].long() + t
                p_row = P[i.clamp(max=P.shape[0] - 1), lanes]
                top2 = p_row.topk(2, dim=-1).values
                per.append(torch.stack([
                    i.float(), (i < counts[k + 1]).float(),
                    (s_row - p_row).abs().amax(-1), p_row.abs().amax(-1),
                    top2[:, 0] - top2[:, 1], p_row.argmax(-1).float(),
                    s_row.argmax(-1).float(),
                ]))
    per = torch.stack(per).cpu().reshape(K, T, 7, B)
    rels, flips = [], []
    for k in range(K):
        for t in range(T):
            for b in range(B):
                i, emitted, diff, top, gap, p_arg, s_arg = per[k, t, :, b].tolist()
                if not emitted:
                    continue
                i = int(i)
                tok = stream[b][i]
                if tok != int(s_arg):
                    raise AssertionError(f"{label} lane {b} token {i}: not the verify row's argmax")
                rels.append(diff / top)
                if diff > LOGIT_TOL * top:
                    raise AssertionError(f"{label} lane {b} token {i}: verify row differs from "
                                         f"the plain row by {diff / top:.2e} of max |logit|")
                if tok != int(p_arg):
                    flips.append(gap / top)
                    if gap > NEAR_TIE * top:
                        raise AssertionError(
                            f"{label} lane {b} token {i}: the verify forward chose otherwise "
                            f"than the plain step at a top-two gap of {gap / top:.2e} of max |logit|")
    if len(rels) != sum(len(s) - 1 for s in stream):
        raise AssertionError(f"{label}: {len(rels)} tokens held, "
                             f"{sum(len(s) - 1 for s in stream)} emitted")
    # A token emitted at position t >= 1 of an iteration follows t accepted drafts.
    emitted = per[:, :, 1, :] > 0                        # (K, T, B)
    accepted = int(emitted[:, 1:].sum())
    full = int(emitted[:, T - 1].sum())
    rels.sort()
    same = "" if teacher is None else (
        f"; {sum(x == y for x, y in zip(stream, teacher_lists(teacher)))} of {B} lanes "
        f"equal their teacher stream in full")
    print(f"{label}: {len(rels)} tokens after the first over {K} verify iterations x {B} lanes "
          f"({sum(len(s) for s in stream) / (K * B):.3f} tokens per lane-forward, {accepted} "
          f"drafts accepted, {full} lane-iterations accepting all {T - 1}){same}; every token "
          f"held to the forced plain step's row: row diff / max |logit| median "
          f"{rels[len(rels) // 2]:.2e}, p99 {rels[int(len(rels) * 0.99)]:.2e}, max {rels[-1]:.2e} "
          f"(limit {LOGIT_TOL:g}); {len(flips)} choices apart from the plain argmax, at "
          f"top-two gaps up to {max(flips, default=0.0):.2e} of max |logit| (limit {NEAR_TIE:g})")
    return stream, P, accepted, full


def hold_loop_to_plain(label: str, base, clips, rows, stream) -> None:
    """Every token of a plain-loop ``transcribe_batch`` stream that ran
    under a kernel mode (its penalized rows ``rows``) held to the default
    modes' row on the same prefix: the default loop of ``base`` forced
    along the stream, then per token |mode row - default row| <= LOGIT_TOL
    of max |default row|, the token is the mode row's argmax, and the
    default argmax unless the default top two lie within NEAR_TIE of max
    |logit|."""
    import torch

    with Choices(forced=padded(stream)) as plain:
        base.transcribe_batch(clips, max_tokens=64)
    if plain.streams[-1] != stream:
        raise AssertionError(f"{label}: the forced default run left the mode's stream")
    n = max(len(s) for s in stream)
    if min(len(rows), len(plain.rows)) < n:
        raise AssertionError(f"{label}: {len(rows)} / {len(plain.rows)} rows for {n} tokens")
    per = []
    with torch.inference_mode():
        for m_row, p_row in zip(rows[:n], plain.rows[:n]):
            top2 = p_row.topk(2, dim=-1).values
            per.append(torch.stack([
                (m_row - p_row).abs().amax(-1), p_row.abs().amax(-1),
                top2[:, 0] - top2[:, 1], p_row.argmax(-1).float(), m_row.argmax(-1).float(),
            ]))
    per = torch.stack(per).cpu()                       # (n, 5, B)
    rels, flips = [], []
    for b, lane in enumerate(stream):
        for i, tok in enumerate(lane):
            diff, top, gap, p_arg, m_arg = per[i, :, b].tolist()
            if tok != int(m_arg):
                raise AssertionError(f"{label} lane {b} token {i}: not the mode row's argmax")
            rels.append(diff / top)
            if diff > LOGIT_TOL * top:
                raise AssertionError(f"{label} lane {b} token {i}: the mode's row differs from "
                                     f"the default row by {diff / top:.2e} of max |logit|")
            if tok != int(p_arg):
                flips.append(gap / top)
                if gap > NEAR_TIE * top:
                    raise AssertionError(
                        f"{label} lane {b} token {i}: the mode chose otherwise than the "
                        f"default step at a top-two gap of {gap / top:.2e} of max |logit|")
    rels.sort()
    print(f"{label}: {len(rels)} tokens held to the forced default step's row: row diff / max "
          f"|logit| median {rels[len(rels) // 2]:.2e}, p99 {rels[int(len(rels) * 0.99)]:.2e}, "
          f"max {rels[-1]:.2e} (limit {LOGIT_TOL:g}); {len(flips)} choices apart from the "
          f"default argmax, at top-two gaps up to {max(flips, default=0.0):.2e} of max |logit| "
          f"(limit {NEAR_TIE:g})")


def teacher_lists(teacher) -> list[list[int]]:
    stream, lens = teacher
    return [row[:n] for row, n in zip(stream.tolist(), lens.tolist())]


def plain_floor(base, clip, stream, rows8, lane: int) -> None:
    """The bf16 floor of the row check: the plain loop's rows of one lane
    at B=1 (``transcribe`` forced along the lane's stream) against its rows
    at B=8, the same prefixes computed at another batch size."""
    import torch

    with Choices(forced=padded([stream])) as one:
        base.transcribe(clip, max_tokens=64)
    P1 = torch.stack(one.rows)[: len(stream), 0]
    P8 = rows8[: len(stream), lane]
    rel = ((P1 - P8).abs().amax(-1) / P8.abs().amax(-1)).cpu()
    print(f"plain B=1 vs plain B=8 rows of lane {lane} over {len(stream)} choices: row diff / "
          f"max|logit| median {rel.median().item():.2e}, max {rel.max().item():.2e}")


def speculative_phase(card: str, base, off: dict) -> dict:
    """Greedy ``"auto"`` (the default) on the plain run's weights: the same
    runs as the plain path, through the speculative loop (K5; no K2/K3),
    held to the plain streams; then sampled, sampled-speculative,
    int8-weights speculative and long-form runs.  Returns the launches of
    the speculative path."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    vocab = base._config.text_decoder.vocab_size
    model = build_model({}, base)
    spec = slice_phase(card, model, {}, SPEC_PATH, SPEC_NEVER)
    compare_streams("spec vs plain, transcribe_batch B=8", off["ids"][0], spec["ids"][0],
                    off["gaps"][0])
    compare_streams("spec vs plain, transcribe B=1", [off["ids"][1]], [spec["ids"][1]],
                    off["gaps"][1])
    # The whole of every stream, past any divergence: the n-gram run (drafts
    # mostly rejected), then a teacher-forced run whose drafts are the
    # n-gram run's own stream (drafts the verify forward confirms).
    # Every token of the B=8 stream, past any divergence, held to the plain
    # step on the same prefix: the default n-gram run (drafts mostly
    # rejected), the bf16 floor of that check (plain rows at B=1 against
    # B=8), and a teacher-forced run whose drafts are the stream of an
    # n-gram run without repetition penalty (more of them accepted).
    clips = smoke_clips()
    own, rows8, _, _ = hold_to_plain("spec held to plain, n-gram drafts, B=8", base, model, clips)
    plain_floor(base, clips[-1], own[-1], rows8, len(clips) - 1)
    del rows8
    own1, _, _, _ = hold_to_plain("spec held to plain, n-gram drafts, penalty 1.0, B=8", base,
                                  model, clips, penalty=1.0)
    _, _, accepted, full = hold_to_plain(
        "spec held to plain, teacher-forced drafts, penalty 1.0, B=8", base, model, clips,
        teacher=padded(own1), penalty=1.0)
    if not (accepted and full):
        raise AssertionError("teacher-forced run: no iteration accepted all its drafts")
    torch.cuda.empty_cache()
    for (label, p_st, s_st) in zip(("B=8 run 1", "B=8 run 2", "B=1"), off["stats"], spec["stats"]):
        p_ms, s_ms = p_st.stages["decode"] * 1e3, s_st.stages["decode"] * 1e3
        print(f"spec vs plain {label} [{card}]: tokens per lane-forward "
              f"{s_st.spec_tokens_per_forward:.3f} vs 1; ms per iteration "
              f"{s_ms / max(s_st.n_decode_steps, 1):.2f} vs {p_ms / max(p_st.n_decode_steps, 1):.2f}; "
              f"ms per emitted token {s_ms / s_st.n_generated_tokens:.3f} vs "
              f"{p_ms / p_st.n_generated_tokens:.3f}; decode {s_ms:.1f} vs {p_ms:.1f} ms")

    # Sampled, plain loop (spec_sampling is off by default): twice, same seed.
    sample_kw = dict(max_tokens=64, temperature=0.7, top_k=50, top_p=0.9, seed=1)
    LAUNCHES.clear()
    runs = []
    for _ in range(2):
        runs.append(_ids(model.transcribe_batch(clips, **sample_kw)))
        print_stats("sampled transcribe_batch B=8 (T=0.7, top_k=50, top_p=0.9, seed=1)",
                    card, model.last_stats)
    if runs[0] != runs[1]:
        raise AssertionError("sampled runs with one seed gave different tokens")
    check_ids("sampled", runs[0], vocab)
    check_launches("sampled B=8", dict(LAUNCHES), BF16_PATH, ("kv_write_span_batch",))

    # Sampled and speculative (rejection-sampling verification).
    spec_sampling = build_model({"spec_sampling": True}, base)
    LAUNCHES.clear()
    res = spec_sampling.transcribe(clips[-1], **sample_kw)
    print_stats("sampled speculative transcribe B=1", card, spec_sampling.last_stats)
    check_ids("sampled speculative", _ids([res]), vocab)
    check_launches("sampled speculative B=1", dict(LAUNCHES), SPEC_PATH, SPEC_NEVER)

    # Int8 weights with the bf16 cache: the verify forward's products run K9.
    w8 = build_model({"quantization": "int8"}, base)
    LAUNCHES.clear()
    res = w8.transcribe(clips[-1], max_tokens=64)
    print_stats("int8-weights speculative transcribe B=1", card, w8.last_stats)
    check_ids("int8-weights speculative", _ids([res]), vocab)
    check_launches("int8-weights speculative B=1", dict(LAUNCHES), SPEC_W8_PATH, SPEC_NEVER)
    w8.close()
    del w8
    torch.cuda.empty_cache()

    # Long-form: 20 s clips, chunk_duration 8, quiet pockets at 8 s and 16 s
    # (so chunks of about 8 + 8 + 4 s); every chunk decodes up to max(256, 50 s)
    # tokens (the chunked path ignores max_tokens, as in the JAX package).
    rng = np.random.default_rng(SEED + 1)
    long_clips = []
    for f in (230.0, 410.0):
        t = np.arange(20 * 16000) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(len(t))
        for pocket in (8.0, 16.0):
            x[int(pocket * 16000) - 1600 : int(pocket * 16000) + 1600] *= 0.01
        long_clips.append(x.astype(np.float32))
    groups = []
    real = model._run_pipeline_batch

    def recorded(batch, *args):
        groups.append([len(c) / 16000 for c in batch])
        return real(batch, *args)

    model._run_pipeline_batch = recorded
    LAUNCHES.clear()
    try:
        for label, call in (
            ("transcribe, one 20 s clip", lambda: [model.transcribe(long_clips[0], chunk_duration=8.0)]),
            ("transcribe_batch, two 20 s clips", lambda: model.transcribe_batch(long_clips, chunk_duration=8.0)),
        ):
            groups.clear()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            chunks = [d for g in groups for d in g]
            budgets = [max(256, int(d * 50)) for d in chunks]
            st = model.last_stats
            print(f"long-form {label}, chunk_duration 8 [{card}]: {len(chunks)} chunks "
                  f"({', '.join(f'{d:.2f}' for d in chunks)} s) in {len(groups)} group(s) of "
                  f"{[len(g) for g in groups]}, token budgets {budgets}; {wall:.2f} s wall, "
                  f"{sum(len(r.text.split()) for r in res)} tokens, last group "
                  f"{st.n_decode_steps} verify iterations "
                  f"({st.spec_tokens_per_forward:.3f} tokens per lane-forward)")
            check_ids(f"long-form {label}", _ids(res), vocab)
            if any(abs(r.duration - 20.0) > 1e-6 for r in res):
                raise AssertionError(f"long-form {label}: wrong durations")
        if [len(g) for g in groups] != [6]:
            raise AssertionError(f"long-form batch: chunks not pooled into one group: {groups}")
    finally:
        del model._run_pipeline_batch
    check_launches("long-form", dict(LAUNCHES), SPEC_PATH, SPEC_NEVER)
    for m in (spec_sampling, model):
        m.close()
    return spec["launches"]


class EncoderCalls:
    """Records, while active, each ``encoder_forward`` call of the API: its
    mel and valid frames, and the features it returned."""

    def __enter__(self):
        from qwen3_asr_tpu_torch import api

        self.api, self.real, self.calls = api, api.encoder_forward, []

        def forward(params, cfg, mel, n_valid):
            out = self.real(params, cfg, mel, n_valid)
            self.calls.append((mel, n_valid, out[0]))
            return out

        api.encoder_forward = forward
        return self

    def __exit__(self, *exc):
        self.api.encoder_forward = self.real


#: The encoder features of the "pallas" stem against the "conv" stem's, bf16
#: at 1.7B from random weights: the largest allowed max |difference| over
#: max |feature|, the repository's bound for bf16 against f32
#: (reference_check).  K11e rounds conv2/conv3 otherwise (f32 until conv +
#: bias, where cuDNN rounds the conv and the bias add), and 24 layers carry
#: that on.
STEM_TOL = 5e-2


def modes_phase(card: str, base, off: dict) -> dict:
    """The JAX package's kernel modes on the plain run's model (``"off"``):
    ``transcribe_batch`` of the smoke clips under decode modes "3" (K11a)
    and "4" (K11b) -- K2 never launched, the mode's kernel 28 x steps --
    and under the "pallas" stem (K11e twice per encoder call), each stream
    held to the plain ("auto", "conv") stream by the near-tie rule and each
    of its tokens to the default modes' row on the same prefix; then the
    encoder features of every stem mode held to the "conv" stem's.  Returns
    the launches of K11a, K11b and K11e, each from its own run."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dec_mod
    from qwen3_asr_tpu_torch.models import encoder as enc_mod
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    clips = smoke_clips()
    vocab = base._config.text_decoder.vocab_size
    n_layers = base._config.text_decoder.num_hidden_layers
    launches = {}
    runs = (("decode mode 3", dec_mod, "DECODE_KERNEL_MODE", "3", "decode_attention_hbm2"),
            ("decode mode 4", dec_mod, "DECODE_KERNEL_MODE", "4", "decode_attention_hbm3"),
            ("stem pallas", enc_mod, "CONV_STEM_MODE", "pallas", "conv_s2_gelu"))
    pallas_calls = None
    for label, module, attr, mode, kernel in runs:
        saved = getattr(module, attr)
        setattr(module, attr, mode)
        try:
            with Watch() as watch, EncoderCalls() as enc, Choices() as rec:
                LAUNCHES.clear()
                ids = _ids(base.transcribe_batch(clips, max_tokens=64))
                got = dict(LAUNCHES)
                if bool(watch.nan_seen):
                    raise AssertionError(f"{label}: NaN logits")
        finally:
            setattr(module, attr, saved)
        st = base.last_stats
        check_ids(label, ids, vocab)
        if kernel == "conv_s2_gelu":
            want = 2 * len(enc.calls)
            pallas_calls = enc.calls
            check_launches(label, got, ("flash_attention_causal", "decode_attention", kernel))
        else:
            want = n_layers * st.n_decode_steps
            check_launches(label, got, ("flash_attention_causal", "kv_write_rows", kernel),
                           ("decode_attention", "kv_write_span_batch"))
        if got[kernel] != want:
            raise AssertionError(f"{label}: {kernel} launched {got[kernel]} times, want {want}")
        print_stats(f"transcribe_batch B=8 {label}", card, st)
        compare_streams(f"{label} vs auto, transcribe_batch B=8", off["ids"][0], ids,
                        off["gaps"][0])
        hold_loop_to_plain(f"{label} held to the default modes, B=8", base, clips, rec.rows, ids)
        del rec
        launches[kernel] = got[kernel]

    # Encoder features of each stem mode against the "conv" stem on the
    # smoke batch's mel; each stem's own output against the float32 stem
    # (cuDNN's TF32 off); the encoder's device time under "conv" and
    # "pallas" in turns.
    mel, n_valid, pallas_feats = pallas_calls[0]
    params, cfg = base._encoder_params, base._config.audio_encoder
    B, n_mels, T = mel.shape
    n_chunks = T // cfg.chunk_frames
    chunks = mel.reshape(B, n_mels, n_chunks, cfg.chunk_frames).permute(0, 2, 1, 3)
    chunks = chunks.reshape(B * n_chunks, 1, n_mels, cfg.chunk_frames)
    stem_params = {k: v for k, v in params.items() if k != "layers"}
    stem32 = {k: v.float() for k, v in stem_params.items()}

    def in_mode(mode, fn):
        saved, enc_mod.CONV_STEM_MODE = enc_mod.CONV_STEM_MODE, mode
        try:
            return fn()
        finally:
            enc_mod.CONV_STEM_MODE = saved

    tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    try:
        with torch.inference_mode():
            ref, _ = encoder_forward(params, cfg, mel, n_valid)
            top = ref.float().abs().max().item()
            stem_ref = in_mode("conv", lambda: enc_mod.conv_stem(stem32, chunks.float()))
            stem_top = stem_ref.abs().max().item()
            for mode in ("conv", "pallas"):
                stem = in_mode(mode, lambda: enc_mod.conv_stem(stem_params, chunks.bfloat16()))
                diff = (stem.float() - stem_ref).abs()
                print(f"stem {mode!r} output vs the f32 stem [{card}]: max abs diff / max "
                      f"|output| {diff.max().item() / stem_top:.3e}, mean abs diff / mean "
                      f"|output| {diff.mean().item() / stem_ref.abs().mean().item():.3e}")
            rel = (pallas_feats.float() - ref.float()).abs().max().item() / top
            print(f"encoder features, stem 'pallas' vs 'conv' [{card}]: max abs diff / "
                  f"max |feature| = {rel:.3e} (limit {STEM_TOL:g}; {tuple(pallas_feats.shape)})")
            if not (torch.isfinite(pallas_feats).all() and rel < STEM_TOL):
                raise AssertionError(f"stem 'pallas': features differ by {rel:.3e} of max |feature|")
            # The JAX package's TPU layout modes run the "conv" stem here.
            for mode in ("taps", "merged", "c512", "merged512"):
                feats = in_mode(mode, lambda: encoder_forward(params, cfg, mel, n_valid)[0])
                if not torch.equal(feats, ref):
                    raise AssertionError(f"stem {mode!r}: features differ from the 'conv' stem's")
            print("encoder features, stems 'taps', 'merged', 'c512', 'merged512': "
                  "equal to the 'conv' stem's")
            turns = []
            for mode in ("conv", "pallas", "pallas", "conv"):
                turns.append(in_mode(mode, lambda: cuda_ms(
                    lambda: encoder_forward(params, cfg, mel, n_valid), iters=5, warmup=1)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"encoder_forward of the smoke batch ({B} x {T} frames), CUDA-event ms in turns "
          f"conv / pallas / pallas / conv [{card}]: "
          f"{' / '.join(f'{t:.3f}' for t in turns)}")
    return launches


def server_run(card: str, model, label: str, paged: bool, path, never, plain) -> dict:
    """``ContinuousTranscriptionServer(n_slots=8, chunk_steps=16)`` on the
    smoke clips in two waves (the second submitted once the first chunk
    ran), greedy, 64-token budgets; launch counters set to 0 just before the
    first submit and read after the last result.  Each stream is held to
    ``plain`` (ids, gaps) of the same clips by the near-tie rule."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.runtime import engine as engine_mod
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    clips = smoke_clips()
    vocab = model._config.text_decoder.vocab_size
    srv = ContinuousTranscriptionServer(model, n_slots=8, max_duration=30.0,
                                        max_new_tokens=512, chunk_steps=16, paged=paged)
    engine = srv._engine
    step_s = []
    real_step = engine.step

    def timed(k_steps=None):            # a chunk ends in its status fetch
        t0 = time.perf_counter()
        real_step(k_steps)
        step_s.append(time.perf_counter() - t0)

    engine.step = timed
    keys = engine._keys["q"] if isinstance(engine._keys, dict) else engine._keys
    cache_gib = 2 * sum(t.numel() * t.element_size() for t in (
        engine._keys.values() if isinstance(engine._keys, dict) else [engine._keys])) / 2**30
    shape = f"{engine.n_pages} pages of {engine.page_size} rows" if paged else \
        f"{engine.n_slots} slots x {engine.cache_len} rows"
    with Watch(engine_mod) as watch:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with srv:
            futs = [srv.submit(c, max_tokens=64) for c in clips[:4]]
            deadline = time.time() + 300
            while engine.stats.chunks < 1 and time.time() < deadline:
                time.sleep(0.002)
            futs += [srv.submit(c, max_tokens=64) for c in clips[4:]]
            results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        if bool(watch.nan_seen):
            raise AssertionError(f"server {label}: NaN logits")
    ids = _ids(results)
    check_ids(f"server {label}", ids, vocab)
    check_launches(f"server {label}", launches, path, never)
    st = engine.stats
    if st.mid_decode_admissions < 1:
        raise AssertionError(f"server {label}: no mid-decode admission")
    if srv.stats.failures or any(getattr(f, "ttft_s", None) is None for f in futs):
        raise AssertionError(f"server {label}: a request failed or has no ttft_s")
    spec = (f", {st.spec_tokens_per_forward:.3f} spec tokens per lane-forward"
            if st.spec_chunks else "")
    print(f"server {label} [{card}]: {keys.dtype} cache of {shape} ({cache_gib:.2f} GiB "
          f"K+V), {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; {wall:.2f} s "
          f"wall for 8 requests, {st.chunks} chunks, {st.iterations} iterations, "
          f"{sum(step_s) * 1e3 / max(st.iterations, 1):.2f} ms per chunk iteration; mean "
          f"occupancy {st.mean_occupancy:.2f}, {st.mid_decode_admissions} mid-decode "
          f"admissions{spec}; ttft_s {[round(f.ttft_s, 3) for f in futs]}")
    compare_streams(f"server {label} vs plain transcribe_batch B=8", plain[0], ids, plain[1])
    return launches


def server_phase(card: str, base, off: dict) -> dict:
    """The continuous server at 1.7B on the plain run's weights: paged
    (K6, K8), paged speculative (K7, K8), the int8 pool plain and
    speculative (q8 K6/K7, int8 K8), and the flat engine (K2, per-lane K3).
    Returns the launches of the paged kernels, each from its own path."""
    import torch

    launches = {}
    plain = (off["ids"][0], off["gaps"][0])
    int8_plain = None
    for label, (runtime, paged, path, never) in SERVER_PATHS.items():
        model = build_model(runtime, base)
        if runtime.get("kv_cache_dtype") == "int8" and int8_plain is None:
            # The plain loop over the int8 cache is the reference there.
            ref = build_model({"kv_cache_dtype": "int8", "speculative": "off"}, base)
            with Choices() as rec:
                ids = _ids(ref.transcribe_batch(smoke_clips(), max_tokens=64))
            int8_plain = (ids, top_two_gaps(rec.rows))
            del rec, ref
        run = server_run(card, model, label, paged, path, never,
                         int8_plain if runtime.get("kv_cache_dtype") == "int8" else plain)
        for name in path:
            if name in PAGED:
                launches.setdefault(name, run[name])
        del model
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not (ROOT / "qwen3_asr_tpu_torch").is_dir():
        print("chip_smoke.py: qwen3_asr_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = card_identity()
    print(card)              # the nvidia-smi name,power.limit line as it is
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from qwen3_asr_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s; 0 = library already built) -> "
          f"{_build.library_path().relative_to(ROOT)}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    measured = {
        "flash_attention_causal": check_flash(gen),
        "decode_attention": check_decode(gen),
        "kv_write_rows": check_kv_write(gen),
        "decode_attention_q8": check_decode_q8(gen),
        "kv_write_rows_q8": check_kv_write_q8(gen),
        "quantized_matmul": check_quantized_matmul(gen),
        "w8a8_matmul": check_w8a8_matmul(gen),
        "kv_write_span_batch": check_kv_write_span(gen),
        "decode_attention_paged": check_decode_paged(gen, 1, False),
        "decode_attention_paged_q8": check_decode_paged(gen, 1, True),
        "decode_attention_paged_verify": check_decode_paged(gen, 4, False),
        "decode_attention_paged_verify_q8": check_decode_paged(gen, 4, True),
        "kv_write_rows_paged": check_kv_write_paged(gen, False),
        "kv_write_rows_paged_q8": check_kv_write_paged(gen, True),
        "decode_attention_hbm2": check_decode_stream(gen, "hbm2"),
        "decode_attention_hbm3": check_decode_stream(gen, "hbm3"),
        "conv_s2_gelu": check_conv_stem(gen),
        "decode_attention_hbm5": check_decode_lanes(gen, "hbm5"),
        "decode_attention_sched": check_decode_lanes(gen, "sched"),
    }
    torch.cuda.empty_cache()
    kab_launches = kernelab_step()
    torch.cuda.empty_cache()
    reference_check(quantized=False)
    reference_check(quantized=True)
    reference_check_paged()
    # Each kernel's launch count comes from the run of its own path.
    off_rt = {"speculative": "off"}
    base = build_model(off_rt)
    off = slice_phase(card, base, off_rt, BF16_PATH, ("kv_write_span_batch",),
                      lm_head=True, record_gaps=True)
    launches = dict(off["launches"])
    launches.update(modes_phase(card, base, off))
    spec_launches = speculative_phase(card, base, off)
    launches["kv_write_span_batch"] = spec_launches["kv_write_span_batch"]
    launches.update(server_phase(card, base, off))
    base.close()
    del base
    torch.cuda.empty_cache()
    int8 = build_model(INT8_RUNTIME)
    int8_launches = slice_phase(card, int8, INT8_RUNTIME, INT8_PATH)["launches"]
    int8.close()
    launches.update({name: int8_launches[name] for name in INT8_PATH})
    launches.update({name: kab_launches[name] for name in KERNELAB[1:]})

    rows = []
    for name, (route, source, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], **measured[name],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
