#!/usr/bin/env python3
"""Per-operation device-time breakdown of the PyTorch port's prefill (mel ->
encoder -> decoder prefill) on one CUDA GPU, from ``torch.profiler``.

    python3 tools/torch_profile_capture.py [--batches 64 96] [--top 15] [--out DIR]

The counterpart of ``tools/profile_capture.py``, which captures an xprof
trace of the TPU's fused prefill program.  Here each stage of the prefill of
B clips of 30 s runs as the pipeline runs it (``log_mel_batch``,
``encoder_forward``, ``Generator.prefill`` with K1 and the bf16 products),
on random 1.7B bf16 weights (seed 0): once to warm, then once under
``utils.telemetry.profile_trace`` (CPU and CUDA activity), whose Chrome
trace goes to ``--out/B{B}_{stage}/``.  For each stage: the wall ms of the
profiled call, the device time summed over its kernels (memcpy and memset
nodes counted apart), the device's busy share of the wall, and the top
kernels by device time with their launches and share; then the top
kernels of the whole prefill.  Prints the card's ``nvidia-smi`` name and
power limit first.  ``tools/torch_decode_profile.py`` covers the decode.
Needs a CUDA device (exits 1 without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kernel_times(prof) -> tuple[Counter, Counter, float]:
    """(device us by kernel name, launches by name, memcpy/memset us) of a
    profiled block; the ``qwen3_asr/*`` user annotations on the device's
    timeline are not kernels."""
    from torch.autograd import DeviceType

    us, n, copies = Counter(), Counter(), 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith("qwen3_asr/"):
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += e.time_range.elapsed_us()
            continue
        us[e.name] += e.time_range.elapsed_us()
        n[e.name] += 1
    return us, n, copies


def print_top(label: str, us: Counter, n: Counter, top: int) -> None:
    total = sum(us.values())
    print(f"  {label}: top {top} of {len(us)} kernels by device time "
          f"({total / 1e3:.2f} ms in all)")
    for name, t in us.most_common(top):
        print(f"    {t / 1e3:9.3f} ms {t / max(total, 1e-9):6.1%} x{n[name]:5d}  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 96])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_capture"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_capture.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SEED, StubTokenizer, card_identity
    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR
    from qwen3_asr_tpu_torch.audio.mel import HOP_LENGTH, N_FFT, host_pad_batch, log_mel_batch
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.utils.telemetry import profile_trace

    print(card_identity())
    model = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                 dtype=torch.bfloat16, seed=SEED, device="cuda")
    gen, cfg = model._generator, model._config
    ac = cfg.audio_encoder
    clip = (np.random.default_rng(0).standard_normal(int(args.seconds * 16000))
            * 0.05).astype(np.float32)
    bucket = model._mel.bucket_for(len(clip))
    for B in args.batches:
        n_valid = [len(clip) // HOP_LENGTH] * B
        n_audio = [model._n_audio_tokens(v) for v in n_valid]
        prompts = [model._tokenizer.build_prompt(n_audio[0], "English")] * B
        plens = [len(p) for p in prompts]
        pbucket, _, cache_len = gen.plan(bucket // ac.chunk_frames * ac.tokens_per_chunk,
                                         plens[0], 128, batch=B)
        run_len = model._runtime.plan_prefill_run(plens[0], pbucket)
        padded = torch.from_numpy(host_pad_batch([clip] * B, bucket, N_FFT, HOP_LENGTH)).cuda()
        nv = torch.tensor(n_valid, dtype=torch.long, device="cuda")
        na = torch.tensor(n_audio, dtype=torch.long, device="cuda")
        pl = torch.tensor(plens, dtype=torch.long, device="cuda")
        ids = torch.from_numpy(gen.pack_prompts(prompts, run_len)).cuda()
        print(f"prefill B={B}: {args.seconds:g} s clips, {bucket} mel frames, prompt "
              f"{plens[0]} rows (run {run_len}, bucket {pbucket}), cache {cache_len}")
        whole_us, whole_n = Counter(), Counter()
        with torch.inference_mode():
            mel = log_mel_batch(padded, nv, bucket)
            feats = encoder_forward(model._encoder_params, ac, mel, nv)[0]
            for stage, fn in (
                ("mel", lambda: log_mel_batch(padded, nv, bucket)),
                ("encoder", lambda: encoder_forward(model._encoder_params, ac, mel, nv)),
                ("decoder-prefill", lambda: gen.prefill(feats, ids, na, pl, cache_len)),
            ):
                fn()
                torch.cuda.synchronize()
                with profile_trace(Path(args.out) / f"B{B}_{stage}") as prof:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                us, n, copies = kernel_times(prof)
                busy = sum(us.values()) / 1e3
                print(f" {stage} B={B}: wall {wall:.2f} ms (profiled), kernels {busy:.2f} ms "
                      f"({sum(n.values())} launches), memcpy/memset {copies / 1e3:.3f} ms, "
                      f"busy {busy / wall:.1%} of the wall")
                print_top(f"{stage} B={B}", us, n, args.top)
                whole_us.update(us)
                whole_n.update(n)
        print_top(f"whole prefill B={B}", whole_us, whole_n, args.top)
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del padded, mel, feats
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
