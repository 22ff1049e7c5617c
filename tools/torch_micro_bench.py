#!/usr/bin/env python3
"""Micro-benchmarks of the PyTorch port's decode and prefill hot paths on one
CUDA GPU: the port of ``tools/micro_bench.py``, section for section.

    python3 tools/torch_micro_bench.py [section ...]   (default: h2d stream kernel)

Sections (the JAX tool's names and default shapes):

  h2d            pageable host -> device copies of 1, 16 and 61 MB;
  stream         ``torch.sum(x, dtype=float32)`` over a bf16 K and V cache
                 (B=32, S=640, L=28): the HBM-stream yardstick, no kernel of
                 the port;
  kernel         K11b (``decode_attention_hbm3``) at B=32, S=640, pb=512,
                 prompt 408 rows, decode end pb+64: one layer, then 28
                 layers in a loop, GB/s of valid rows;
  kernel64       the same at B=64;
  kernelab       K2 (``decode_attention``) against K11d
                 (``decode_attention_sched``, its schedule built once per
                 28-layer pass) and K11c (``decode_attention_hbm5``) at B=64,
                 S=640, pb=512, prompt 408, decode ends pb+8, +64, +128: ms
                 per pass, us per layer, GB/s of valid rows, each arm held to
                 K2's output (atol 2e-2 + rtol 2e-2);
  kernelab-long  the same at B=8, S=5120, pb=4096;
  steprate       ``Generator.decode`` on zero bf16 1.7B weights at B=64: 16
                 and 128 tokens, 6 times each in turns, (t128 - t16) / 112
                 ms per step, and which loop ran;
  steprate1      the same at B=1;
  prefill64      mel, encoder and decoder prefill at B=64 with 30 s clips,
                 each stage on its own (``-int8``: int8 weights; ``-w8a8``:
                 int8 weights and W8A8 prefill);
  step, step64   greedy ``transcribe_batch`` of 32 (64) 30 s clips, 128
                 tokens: best of 6 and the last run's stats;
  encoder        the full encoder, the conv stem, the 24 layers and their
                 attention alone, at B=64 and 3200 frames.

Device times come from CUDA events (mean over a run of calls after a warm
up); the TPU tool's fetch-one-element barrier and rep-count differencing
are not needed here.  Every section prints ``torch.cuda.max_memory_allocated``.
The first line is the card's ``nvidia-smi`` name and power limit and the
torch/CUDA versions.  Needs a CUDA device and exits non-zero without one;
imports nothing of JAX.  The section functions take ``device`` (default
"cuda") and their shapes, so a test can run them on CPU tensors, where the
kernel wrappers run their plain versions and times are host
``time.perf_counter`` means.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HKV, HQ, D = 8, 16, 128
ATOL = RTOL = 2e-2


def timed_ms(fn, device="cuda", iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call: CUDA events on a CUDA device, the host
    clock otherwise."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def peak(device, label: str) -> None:
    """Print the peak device memory since the last reset (``main`` resets
    it before each section, once the previous section's tensors are gone)."""
    if torch.device(device).type == "cuda":
        gib = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"  [{label}] peak device memory {gib:.2f} GiB (max_memory_allocated)")
    else:
        print(f"  [{label}] peak device memory: not measured (CPU)")


def _cache(L, B, S, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).bfloat16()

    q = randn(B, HQ, D)
    kall, vall = randn(L, B, HKV, S, D), randn(L, B, HKV, S, D)
    k_new = randn(B, HKV, 1, D)
    return q, kall, vall, k_new, k_new


def bench_h2d(device="cuda", sizes_mb=(1, 16, 61)):
    """Pageable host -> device copies at the bench's audio payload sizes."""
    for mb in sizes_mb:
        buf = torch.zeros(mb * (1 << 20) // 4, dtype=torch.float32)
        ms = timed_ms(lambda: buf.to(device), device, iters=8, warmup=2)
        print(f"h2d {mb:4d} MB: {ms:8.3f} ms ({mb / (ms * 1e-3):.0f} MB/s)")
    peak(device, "h2d")


def bench_hbm_stream(device="cuda", B=32, S=640, L=28):
    """The HBM-stream yardstick: a float32 sum over the bf16 K and V cache."""
    kall = torch.zeros(L, B, HKV, S, D, dtype=torch.bfloat16, device=device)
    vall = torch.zeros_like(kall)
    ms = timed_ms(lambda: torch.sum(kall, dtype=torch.float32)
                  + torch.sum(vall, dtype=torch.float32), device)
    gb = 2 * kall.numel() * 2 / 1e9
    print(f"stream {gb:.2f} GB: {ms:.3f} ms ({gb / (ms * 1e-3):.0f} GB/s)")
    peak(device, "stream")


def bench_kernel(device="cuda", B=32, S=640, pb=512, L=28, plen=408, dend_off=64,
                 block_k=512):
    """K11b alone: one layer, then every layer of the cache in a loop
    (``block_k`` halved by the wrappers' tiling rule until it fits)."""
    from qwen3_asr_tpu_torch.ops.kernels.experiments.decode_attention_hbm3 import (
        decode_attention_hbm3,
    )

    q, kall, vall, k_new, v_new = _cache(L, B, S, device)
    plens = torch.full((B,), plen, dtype=torch.int32, device=device)
    dend = pb + dend_off

    def layer(i):
        return decode_attention_hbm3(q, kall, vall, k_new, v_new, i, plens, dend, pb,
                                     block_k=block_k)

    gb = B * HKV * (plen + dend_off) * D * 2 * 2 / 1e9       # valid rows only
    ms = timed_ms(lambda: layer(0), device, iters=30)
    print(f"kernel 1-layer B={B} S={S}: {ms:.4f} ms -> {gb / (ms * 1e-3):.0f} GB/s "
          f"(valid rows)")
    ms = timed_ms(lambda: [layer(i) for i in range(L)], device)
    print(f"kernel {L}-layer loop: {ms:.3f} ms ({ms / L:.4f} ms/layer, "
          f"{gb * L / (ms * 1e-3):.0f} GB/s)")
    peak(device, f"kernel B={B}")


def bench_kernel_ab(device="cuda", B=64, S=640, pb=512, L=28, plen=408,
                    dend_offs=(8, 64, 128), iters=10, warmup=2) -> dict:
    """K2 against K11d and K11c over every layer of the cache.  Returns
    ``{(arm, dend_off): {"ms": ms per pass, "max_abs_err": vs K2}}`` and
    the number of passes each arm ran under ``"passes"``."""
    from qwen3_asr_tpu_torch.ops.kernels.decode_attention import _sm_count, decode_attention
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm5 as h5
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_sched as sc

    q, kall, vall, k_new, v_new = _cache(L, B, S, device)
    plens = torch.full((B,), plen, dtype=torch.int32, device=device)
    sms = _sm_count(torch.device(device)) if torch.device(device).type == "cuda" else sc.H100_SMS
    cores, per_core = sc.schedule_geometry(B, HKV, sms)

    def k2(dend):
        return [decode_attention(q, kall, vall, k_new, v_new, i, plens, dend, pb)
                for i in range(L)]

    def sched(dend):
        s = sc.build_decode_schedule(plens, dend, pb, S, cores, per_core, B)
        return [sc.decode_attention_sched(q, kall, vall, k_new, v_new, i, plens, dend, pb,
                                          schedule=s) for i in range(L)]

    def hbm5(dend):
        return [h5.decode_attention_hbm5(q, kall, vall, k_new, v_new, i, plens, dend, pb)
                for i in range(L)]

    arms = {"K2 decode_attention": k2, "K11d decode_attention_sched": sched,
            "K11c decode_attention_hbm5": hbm5}
    results = {"passes": len(dend_offs) * (1 + iters + warmup)}
    for off in dend_offs:
        dend = torch.full((B,), pb + off, dtype=torch.int32, device=device)
        gb = L * B * HKV * (plen + off) * D * 2 * 2 / 1e9
        ref = None
        for name, arm in arms.items():        # K2 first: its pass is the reference
            out = torch.stack(arm(dend)).float()
            ref = out if ref is None else ref
            if not torch.isfinite(out).all():
                raise AssertionError(f"{name} dend+{off}: non-finite output")
            err = (out - ref).abs()
            if (err > ATOL + RTOL * ref.abs()).any():
                raise AssertionError(f"{name} dend+{off}: beyond atol {ATOL} + rtol {RTOL} "
                                     f"of K2 (max abs err {err.max().item():.3e})")
            ms = timed_ms(lambda: arm(dend), device, iters=iters, warmup=warmup)
            results[(name, off)] = {"ms": ms, "max_abs_err": err.max().item()}
            print(f"{name:28s} B={B} S={S} dend+{off:4d}: {ms:8.3f} ms/{L}-layer pass "
                  f"({ms / L * 1e3:7.1f} us/layer, {gb / (ms * 1e-3):.0f} GB/s valid; "
                  f"max |diff| vs K2 {err.max().item():.2e})")
    peak(device, f"kernelab B={B} S={S}")
    return results


def _zero_model(runtime=None, device="cuda", config=None):
    from chip_smoke import StubTokenizer
    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR

    return Qwen3ASR.from_random(config or ModelConfig(), tokenizer=StubTokenizer(),
                                runtime=runtime, seed=None, device=device)


def bench_steprate(device="cuda", B=64, plen=408, pb=512, tbucket=128, cfg=None,
                   lo=16, hi=128, reps=6):
    """Per-step decode time: the same loop at ``lo`` and ``hi`` tokens, the
    difference over ``hi - lo`` steps."""
    from qwen3_asr_tpu_torch import RuntimeConfig, TextDecoderConfig
    from qwen3_asr_tpu_torch.models.decoder import init_decoder_params, init_kv_cache
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    cfg = cfg or TextDecoderConfig()
    params = init_decoder_params(cfg, None, torch.bfloat16, device)     # zero weights
    gen = Generator(params, cfg, RuntimeConfig())
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((B, cfg.vocab_size)).astype(np.float32)
                              * 0.01).to(device)

    def run(max_new):
        kv = init_kv_cache(cfg, B, pb + tbucket, torch.bfloat16, device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            gen.decode(kv, logits, [plen] * B, [max_new] * B, tbucket,
                       repetition_penalty=1.2, repetition_context_size=100)
        return time.perf_counter() - t0

    run(lo), run(hi)
    t_lo, t_hi = [], []
    for _ in range(reps):
        t_lo.append(run(lo))
        t_hi.append(run(hi))
    loop = (f"speculative, {gen.last_spec_forwards} verify iterations"
            if gen.last_spec_forwards else f"plain, {gen.last_decode_steps} steps")
    print(f"steprate B={B}: {1e3 * (min(t_hi) - min(t_lo)) / (hi - lo):.3f} ms/step "
          f"(lo{lo} {min(t_lo) * 1e3:.1f} ms, hi{hi} {min(t_hi) * 1e3:.1f} ms; {loop})")
    peak(device, f"steprate B={B}")


def bench_prefill(device="cuda", B=64, seconds=30.0, runtime=None, config=None, iters=5):
    """Mel, encoder and decoder prefill of the pipeline at B clips, each
    stage timed on its own."""
    from qwen3_asr_tpu_torch.audio.mel import HOP_LENGTH, N_FFT, host_pad_batch, log_mel_batch
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward

    model = _zero_model(runtime, device, config)
    gen, cfg = model._generator, model._config
    rng = np.random.default_rng(0)
    clip = (rng.standard_normal(int(seconds * 16000)) * 0.05).astype(np.float32)
    bucket = model._mel.bucket_for(len(clip))
    n_valid = [len(clip) // HOP_LENGTH] * B
    n_audio = [model._n_audio_tokens(v) for v in n_valid]
    prompts = [model._tokenizer.build_prompt(n_audio[0], "English")] * B
    plens = [len(p) for p in prompts]
    ac = cfg.audio_encoder
    atb = bucket // ac.chunk_frames * ac.tokens_per_chunk
    pbucket, _, cache_len = gen.plan(atb, plens[0], 128, batch=B)
    run_len = model._runtime.plan_prefill_run(plens[0], pbucket)
    print(f"prefill B={B} ({model._runtime.quantization}/{model._runtime.act_quant}): "
          f"frames {bucket}, prompt {plens[0]}/{pbucket} (run {run_len}), cache {cache_len}")
    padded = torch.from_numpy(host_pad_batch([clip] * B, bucket, N_FFT, HOP_LENGTH)).to(device)
    nv = torch.tensor(n_valid, dtype=torch.long, device=device)
    na = torch.tensor(n_audio, dtype=torch.long, device=device)
    pl = torch.tensor(plens, dtype=torch.long, device=device)
    ids = torch.from_numpy(gen.pack_prompts(prompts, run_len)).to(device)
    with torch.inference_mode():
        mel = log_mel_batch(padded, nv, bucket)
        feats = encoder_forward(model._encoder_params, ac, mel, nv)[0]
        for label, fn in (
            ("mel", lambda: log_mel_batch(padded, nv, bucket)),
            ("encoder", lambda: encoder_forward(model._encoder_params, ac, mel, nv)),
            ("dec-prefill", lambda: gen.prefill(feats, ids, na, pl, cache_len)),
        ):
            ms = timed_ms(fn, device, iters=iters, warmup=2)
            print(f"  {label:12s} device {ms:8.1f} ms")
    model.close()
    peak(device, f"prefill B={B}")


def bench_step(device="cuda", B=32, seconds=30.0, max_tokens=128, config=None, reps=6):
    """Greedy ``transcribe_batch`` through the public API."""
    model = _zero_model(None, device, config)
    rng = np.random.default_rng(0)
    clips = [(rng.standard_normal(int(seconds * 16000)) * 0.05).astype(np.float32)
             for _ in range(B)]
    model.transcribe_batch(clips, max_tokens=max_tokens)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.transcribe_batch(clips, max_tokens=max_tokens)
        times.append(time.perf_counter() - t0)
    print(f"pipeline B={B}: best {min(times):.3f} s  all={[f'{t:.2f}' for t in times]}")
    print(f"  stats: {model.last_stats.as_dict()}")
    model.close()
    peak(device, f"step B={B}")


def bench_encoder(device="cuda", B=64, frames=3200, cfg=None, iters=5):
    """The encoder's parts at full width: stem, layers, attention alone."""
    import torch.nn.functional as F

    from qwen3_asr_tpu_torch import ModelConfig
    from qwen3_asr_tpu_torch.models import encoder as enc

    cfg = cfg or ModelConfig().audio_encoder
    params = enc.init_encoder_params(cfg, None, torch.bfloat16, device)
    g = torch.Generator(device=device).manual_seed(0)
    n_chunks = frames // cfg.chunk_frames
    total = n_chunks * cfg.tokens_per_chunk
    mel = torch.randn(B, cfg.num_mel_bins, frames, generator=g, device=device) * 0.3
    nv = torch.full((B,), frames, dtype=torch.long, device=device)
    chunks = torch.randn(B * n_chunks, 1, cfg.num_mel_bins, cfg.chunk_frames, generator=g,
                         device=device).bfloat16()
    tokens = (torch.randn(B, total, cfg.d_model, generator=g, device=device) * 0.1).bfloat16()
    valid = torch.ones(B, total, dtype=torch.bool, device=device)
    nq, d = cfg.encoder_attention_heads, cfg.d_model
    hd = d // nq

    def heads(t):
        return t.reshape(B, total, nq, hd).transpose(1, 2)

    def attention(h, lp):
        x = enc.layer_norm(h, lp["ln1_w"], lp["ln1_b"], enc._LN_EPS)
        q, k, v = (heads(enc.qlinear(x, lp[w]) + lp[b])
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        a = enc.windowed_self_attention(q, k, v, window=cfg.window_tokens, valid_mask=valid,
                                        scale=hd ** -0.5)
        return h + enc.qlinear(a.transpose(1, 2).reshape(B, total, d), lp["wo"]) + lp["bo"]

    def layers(h):
        for lp in params["layers"]:
            h = attention(h, lp)
            x = enc.layer_norm(h, lp["ln2_w"], lp["ln2_b"], enc._LN_EPS)
            x = F.gelu(enc.qlinear(x, lp["fc1_w"]) + lp["fc1_b"], approximate="none")
            h = h + enc.qlinear(x, lp["fc2_w"]) + lp["fc2_b"]
        return h

    def attn_only(h):
        for lp in params["layers"]:
            h = attention(h, lp)
        return h

    with torch.inference_mode():
        for label, fn in (
            ("full encoder", lambda: enc.encoder_forward(params, cfg, mel, nv)),
            ("conv stem", lambda: enc.conv_stem(params, chunks)),
            (f"{cfg.encoder_layers} layers", lambda: layers(tokens)),
            ("attn-only", lambda: attn_only(tokens)),
        ):
            ms = timed_ms(fn, device, iters=iters, warmup=2)
            print(f"  {label:12s} device {ms:8.1f} ms")
    peak(device, f"encoder B={B}")


def _int8(**kw):
    from qwen3_asr_tpu_torch import RuntimeConfig

    return RuntimeConfig(quantization="int8", **kw)


#: Section name -> what it runs, in the JAX tool's order.
SECTIONS = {
    "h2d": lambda: bench_h2d(),
    "stream": lambda: bench_hbm_stream(),
    "kernel": lambda: bench_kernel(),
    "kernel64": lambda: bench_kernel(B=64),
    "kernelab": lambda: bench_kernel_ab(),
    "kernelab-long": lambda: bench_kernel_ab(B=8, S=4096 + 1024, pb=4096),
    "steprate": lambda: bench_steprate(),
    "steprate1": lambda: bench_steprate(B=1),
    "prefill64": lambda: bench_prefill(),
    "prefill64-int8": lambda: bench_prefill(runtime=_int8()),
    "prefill64-w8a8": lambda: bench_prefill(runtime=_int8(act_quant="int8")),
    "step": lambda: bench_step(),
    "step64": lambda: bench_step(B=64),
    "encoder": lambda: bench_encoder(),
}


def main(argv: list[str]) -> int:
    sections = argv or ["h2d", "stream", "kernel"]
    unknown = [s for s in sections if s not in SECTIONS]
    if unknown:
        print(f"torch_micro_bench.py: unknown sections {unknown}; known: {list(SECTIONS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_micro_bench.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name in SECTIONS:
        if name in sections:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            SECTIONS[name]()
            print(f"  [{name}] {time.perf_counter() - t0:.1f} s wall")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
