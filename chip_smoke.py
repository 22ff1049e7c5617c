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
     product of the same int8 weights; K3, K3 int8 and K10: exact), both
     times from CUDA events, and the share of the published peak (HBM
     bytes for K2, K4, K9; int8 operations for K10);
  4. small-width reference checks: the decoder's prefill logits and one
     decode step with the kernels on the GPU against the same weights on
     the CPU with the plain versions -- bf16 against float32, and the int8
     decoder (int8 weights, W8A8 prefill, int8 cache) against the same
     quantized weights in float32;
  5. the full-width 1.7B slice from random weights (seed 0): greedy
     ``transcribe_batch`` of 8 synthetic clips of 4-30 s (``max_tokens=64``)
     twice and one ``transcribe``; token ids must be < vocab, logits never
     NaN, both batch runs identical, and every kernel of the path launched
     (launch counters are reset right before it).  The bf16 prefill logits
     must equal the f32 product of a few of their rows (the lm head keeps
     its f32 accumulator).  Then the model is freed and the same runs go
     through a second 1.7B model with ``RuntimeConfig(quantization="int8",
     act_quant="int8", kv_cache_dtype="int8")``;
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
}
#: The kernels each main path must launch.
BF16_PATH = ("flash_attention_causal", "decode_attention", "kv_write_rows")
INT8_PATH = ("flash_attention_causal", "decode_attention_q8", "kv_write_rows_q8",
             "quantized_matmul", "w8a8_matmul")


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
        # Causal QK^T and PV: 2 products x 2 FLOP per MAC over T(T+1)/2 pairs.
        tflops = 4 * B * hq * D * T * (T + 1) / 2 / (ms * 1e-3) / 1e12
        print(f"K1 flash_attention_causal B={B} T={T}: max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {tflops:.1f} TFLOP/s "
              f"= {tflops / PEAK_BF16_TFLOPS:.1%} of the bf16 peak")
        worst = max(worst, err)
        times.append((T, ms, plain_ms))
    # The record's time is the main path's largest smoke shape (T=448: the
    # 30 s bucket's 64-aligned prefill run).
    _, ms, plain_ms = next(t for t in times if t[0] == 448)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
            # The K and V bytes of the valid rows, each read once.
            rows = int((plen + dend - pb).sum())
            gbps = rows * hkv * D * 2 * 2 / (ms * 1e-3) / 1e9
            print(f"K2 decode_attention B={B} pb={pb} S={S}: max_abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {rows} valid rows, "
                  f"{gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, S, ms, plain_ms))
            del kall, vall
    _, _, ms, plain_ms = next(t for t in times if t[0] == 8 and t[1] == 640)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    print(f"K3 kv_write_rows L={L} B={B} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


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
            gbps = rows * hkv * (D + 4) * 2 / (ms * 1e-3) / 1e9
            print(f"K4 decode_attention_q8 B={B} pb={pb} S={S}: max_abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {rows} valid rows, "
                  f"{gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, S, ms, plain_ms))
            del kall, vall
    _, _, ms, plain_ms = next(t for t in times if t[0] == 8 and t[1] == 640)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    print(f"K3 kv_write_rows_q8 L={L} B={B} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


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
            nbytes = K * N + B * K * 2 + B * N * out.element_size() + N * 4
            gbps = nbytes / (ms * 1e-3) / 1e9
            print(f"K9 quantized_matmul {name} M={B} K={K} N={N}: max_abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {gbps:.0f} GB/s = "
                  f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
            worst = max(worst, err)
            times.append((B, name, ms, plain_ms))
            del wq
    # The record: B=8 decode, summed over one layer's four matmuls.
    ms = sum(t[2] for t in times if t[0] == 8 and t[1] != "lm_head")
    plain_ms = sum(t[3] for t in times if t[0] == 8 and t[1] != "lm_head")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
        tops = 2 * M * N * K / (ms * 1e-3) / 1e12
        print(f"K10 w8a8_matmul {name} M={M} K={K} N={N}: bit-exact (f32 out); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {tops:.1f} TOPS = "
              f"{tops / PEAK_INT8_TOPS:.1%} of the int8 peak")
        times.append((name, ms, plain_ms))
        del wq
    # The record: one decoder layer's four prefill matmuls.
    ms = sum(t[1] for t in times if t[0].startswith("dec"))
    plain_ms = sum(t[2] for t in times if t[0].startswith("dec"))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


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


def reference_check(quantized: bool) -> None:
    """Kernels (GPU) against the plain path (float32, CPU) on one small
    decoder: prefill logits and one split-decode step.  ``quantized``: int8
    weights, W8A8 prefill and the int8 cache on both sides."""
    import torch

    from qwen3_asr_tpu_torch.config import RuntimeConfig, TextDecoderConfig
    from qwen3_asr_tpu_torch.models.decoder import (
        decoder_forward, decoder_logits, embed_tokens, fuse_decoder_params,
        init_decoder_params,
    )
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
        return logits.float().cpu(), step_logits.float().cpu()

    ref = run(ref_params, "cpu")
    out = run(gpu_params, "cuda")
    what = "int8 decoder, GPU kernels vs f32 CPU plain" if quantized else \
        "bf16 GPU kernels vs f32 CPU plain"
    for i, label in ((0, "prefill logits"), (1, "decode-step logits")):
        rel = ((out[i] - ref[i]).abs().max() / ref[i].abs().max()).item()
        print(f"reference check ({label}, {what}): "
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


def slice_phase(card: str, runtime: dict | None, path: tuple[str, ...]) -> dict:
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.runtime import generate

    cfg = ModelConfig()
    vocab = cfg.text_decoder.vocab_size
    t0 = time.perf_counter()
    model = Qwen3ASR.from_random(
        cfg, tokenizer=StubTokenizer(), runtime=RuntimeConfig(**(runtime or {})),
        dtype=torch.bfloat16, seed=SEED, device="cuda",
    )
    torch.cuda.synchronize()
    tag = f"RuntimeConfig({', '.join(f'{k}={v!r}' for k, v in (runtime or {}).items())})"
    print(f"from_random(ModelConfig(), bf16, seed={SEED}, {tag}) on cuda: "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    rng = np.random.default_rng(SEED)
    durations = (4.0, 7.5, 11.0, 14.5, 18.0, 22.0, 26.0, 30.0)
    clips = []
    for d in durations:
        t = np.arange(int(d * 16000)) / 16000.0
        f = rng.uniform(120.0, 900.0)
        clip = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(len(t))
        clips.append(clip.astype(np.float32))

    # Watch every logits tensor of the main path for NaN (one device flag,
    # no extra sync per step).
    nan_seen = torch.zeros((), dtype=torch.bool, device="cuda")
    real_logits = generate.decoder_logits
    first_hidden = []            # the main path's first (prefill) lm-head input
    armed = [False]

    def watched_logits(params, cfg_, hidden):
        out = real_logits(params, cfg_, hidden)
        nan_seen.logical_or_(torch.isnan(out).any())
        if armed[0] and not first_hidden:
            first_hidden.append(hidden.clone())
        return out

    generate.decoder_logits = watched_logits
    try:
        model.warm_up(durations=(4.0,), batch_sizes=(8,), max_tokens=4)
        LAUNCHES.clear()
        armed[0] = True
        runs = []
        for _ in range(2):
            res = model.transcribe_batch(clips, max_tokens=64)
            runs.append((_ids(res), model.last_stats))
        single = model.transcribe(clips[-1], max_tokens=64)
        single_stats = model.last_stats
        launches = dict(LAUNCHES)
    finally:
        generate.decoder_logits = real_logits

    ids_a, stats = runs[0]
    ids_b, stats_b = runs[1]
    if ids_a != ids_b:
        raise AssertionError("two greedy transcribe_batch runs gave different tokens")
    all_ids = [t for seq in ids_a + _ids([single]) for t in seq]
    if not all_ids or max(all_ids) >= vocab or min(all_ids) < 0:
        raise AssertionError("token ids outside [0, vocab)")
    if stats.n_generated_tokens <= 0 or single_stats.n_generated_tokens <= 0:
        raise AssertionError("no tokens generated")
    if bool(nan_seen):
        raise AssertionError("NaN logits on the main path")
    for name in path:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    print(f"main path launches ({tag}): {launches}")
    if runtime is None:
        check_lm_head_f32(model, first_hidden[0])

    for label, st in (("transcribe_batch B=8 run 1", stats),
                      ("transcribe_batch B=8 run 2", stats_b),
                      ("transcribe B=1", single_stats)):
        steps = max(st.n_decode_steps, 1)
        print(
            f"{label} {tag} [{card}]: audio {st.audio_seconds:.1f} s, prepare "
            f"{st.stages['prepare'] * 1e3:.1f} ms, mel+encoder+prefill "
            f"{st.stages['prefill'] * 1e3:.1f} ms, decode "
            f"{st.stages['decode'] * 1e3:.1f} ms over {st.n_decode_steps} steps = "
            f"{st.stages['decode'] * 1e3 / steps:.2f} ms/step, "
            f"{st.n_generated_tokens} tokens, RTFx {st.rtfx:.1f}"
        )
    model.close()
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
    }
    torch.cuda.empty_cache()
    reference_check(quantized=False)
    reference_check(quantized=True)
    # Each kernel's launch count comes from the run of its own path.
    launches = dict(slice_phase(card, None, BF16_PATH))
    int8_launches = slice_phase(card, INT8_RUNTIME, INT8_PATH)
    launches.update({name: int8_launches[name] for name in INT8_PATH})

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
