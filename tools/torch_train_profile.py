#!/usr/bin/env python3
"""Where a full-width train step of the PyTorch port spends its device time.

    python3 tools/torch_train_profile.py [--dtypes f32,bf16] [--steps 3]

For each dtype: ``ModelConfig()`` from ``random_params(seed=0)`` on the card,
Adam at lr 1e-4 and ``chip_smoke.py``'s full-width batch (``TRAIN_FULL``:
B=2 30 s clips, P=512), as the smoke's ``training_phase`` builds them.  One
warm step, ``--steps`` steps between two CUDA events (ms a step), then one
step under ``torch.profiler``: the device kernels' time summed by name (the
top 25), by kind (GEMMs, convolutions, the optimizer's multi-tensor
kernels, the rest), their sum against the step's wall time (the device's
busy share), and the step's peak memory.  Prints the card's name and power
limit beside the numbers.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import SEED, TRAIN_FULL, TRAIN_LR, card_identity, train_batch  # noqa: E402

KINDS = (
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("convolution", ("conv", "cudnn", "implicit_", "xmma_fprop", "dgrad", "wgrad")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, copies)"


def profile_arm(card: str, dtype, label: str, steps: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_tpu_torch.config import ModelConfig
    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training.train import init_train_state, make_train_step

    cfg = ModelConfig()
    B, frames, valid, n_audio, P = TRAIN_FULL
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, functools.partial(torch.optim.Adam, lr=TRAIN_LR),
                             *random_params(cfg, seed=SEED, dtype=dtype, device="cuda"))
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, "cuda")
    step = make_train_step(cfg)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # User annotations (``Optimizer.step#Adam.step``) also sit on the
        # device timeline; only kernels, copies and fills count.
        if (ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0
                and not getattr(ev, "is_user_annotation", False) and "#" not in ev.name):
            by_name[ev.name][0] += ev.device_time_total / 1e3
            by_name[ev.name][1] += 1
    total = sum(t for t, _ in by_name.values())
    by_kind: dict[str, float] = defaultdict(float)
    for name, (t, _) in by_name.items():
        by_kind[kind_of(name)] += t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: {ms:.1f} ms a step (CUDA events, mean of {steps}); profiled step: "
          f"wall {wall_ms:.1f} ms, kernels {total:.1f} ms ({total / wall_ms:.1%} busy), "
          f"{sum(n for _, n in by_name.values())} kernels; peak memory {peak_gb:.2f} GB ({card})")
    for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {t:.2f} ms ({t / total:.1%})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t:8.2f} ms {n:5d}x  {name[:110]}")
    del state, batch
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtypes", default="f32,bf16")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile.py: no CUDA device", file=sys.stderr)
        return 1
    card = card_identity()
    print(card)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for label in args.dtypes.split(","):
        profile_arm(card, dtypes[label], label, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
