#!/usr/bin/env python3
"""Graph time against recorded kernel time for the parts of a full-width train step.

    python3 tools/torch_train_graph_probe.py [--dtype bf16] [--replays 5]

``ModelConfig()`` from ``random_params(seed=0)`` on the card and
``chip_smoke.py``'s full-width batch (``TRAIN_FULL``: B=2 30 s clips,
P=512), TF32 off.  Each part below is run once on a side stream, captured
as a CUDA graph on its own, replayed ``--replays`` times between two CUDA
events (ms a replay) and once under ``torch.profiler`` (the device events
it records, user annotations left out, and their summed time).  Where a
replay takes longer than the events it records add up to, the device ran
work that the profiler did not record: a busy share read from a profile is
then a lower bound.  Parts:

* single ops on a gradient-sized tensor: a multiply by a Python float and
  by a 0-d tensor on the device;
* over every parameter's gradient: ``torch._foreach_zero_`` (the train
  step's zeroing), ``torch._foreach_div_`` by a Python float and by a list
  of 0-d device tensors (the per-tensor path that ``torch.optim.Adam``'s
  multi-tensor ``capturable`` branch takes twice a step);
* the encoder's forward, without and with its backward;
* ``asr_loss``'s forward, without and with its backward;
* one ``torch.optim.Adam`` step (``capturable=True``): multi-tensor
  (foreach, the default) and fused.

Prints the card's name and power limit beside the numbers.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import SEED, TRAIN_FULL, card_identity, train_batch  # noqa: E402


def graph_and_profile(fn, replays: int) -> tuple[float, int, float]:
    """(ms a replay of ``fn`` captured as a CUDA graph, device events one
    profiled replay records, their summed ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and "#" not in e.name and not getattr(e, "is_user_annotation", False)]
    return ms, len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    parser.add_argument("--replays", type=int, default=5)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_graph_probe.py: no CUDA device", file=sys.stderr)
        return 1
    from qwen3_asr_tpu_torch.config import ModelConfig
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training.train import asr_loss, named_params

    card = card_identity()
    print(card)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    cfg = ModelConfig()
    B, frames, valid, n_audio, P = TRAIN_FULL
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, "cuda")
    enc, dec = random_params(cfg, seed=SEED, dtype=dtype, device="cuda")
    leaves = [t for _, t in named_params(enc, dec)]
    for t in leaves:
        t.requires_grad_(True)
        t.grad = torch.zeros_like(t)
    grads = [t.grad for t in leaves]
    big = max(grads, key=torch.Tensor.numel)
    scalar = torch.full((), 1.0001, device="cuda")

    def encoder(backward: bool):
        def run():
            with torch.set_grad_enabled(backward):
                features, _ = encoder_forward(enc, cfg.audio_encoder, batch.mel,
                                              batch.n_valid_frames)
                if backward:
                    features.float().sum().backward()
        return run

    def loss(backward: bool):
        def run():
            with torch.set_grad_enabled(backward):
                value = asr_loss(enc, dec, cfg, batch)
                if backward:
                    value.backward()
        return run

    parts = [
        (f"multiply {tuple(big.shape)} by a Python float", lambda: big.mul_(1.0001)),
        (f"multiply {tuple(big.shape)} by a 0-d device tensor", lambda: big.mul_(scalar)),
        (f"_foreach_zero_ over {len(grads)} gradients", lambda: torch._foreach_zero_(grads)),
        ("_foreach_div_ by a Python float", lambda: torch._foreach_div_(grads, 1.0001)),
        ("_foreach_div_ by 0-d device tensors", lambda: torch._foreach_div_(grads, [scalar] * len(grads))),
        ("encoder forward", encoder(False)),
        ("encoder forward + backward", encoder(True)),
        ("asr_loss forward", loss(False)),
        ("asr_loss forward + backward", loss(True)),
    ]
    for label, fn in parts:
        ms, n, recorded = graph_and_profile(fn, args.replays)
        print(f"{args.dtype} {label}: {ms:.2f} ms a replay; {n} device events recorded, "
              f"{recorded:.2f} ms; not recorded {ms - recorded:.2f} ms ({card})")
    for label, options in (("foreach", {}), ("fused", {"fused": True})):
        opt = torch.optim.Adam(leaves, lr=1e-4, capturable=True, **options)
        opt.step()
        ms, n, recorded = graph_and_profile(opt.step, args.replays)
        print(f"{args.dtype} Adam step, {label}, capturable: {ms:.2f} ms a replay; {n} device "
              f"events recorded, {recorded:.2f} ms; not recorded {ms - recorded:.2f} ms ({card})")
        del opt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
