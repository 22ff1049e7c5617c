#!/usr/bin/env python3
"""Where a full-width train step of the PyTorch port spends its device time.

    python3 tools/torch_train_profile.py [--dtypes f32,bf16] [--steps 3] [--dp 1 --tp 1]
                                         [--eager] [--fused]

For each dtype: ``ModelConfig()`` from ``random_params(seed=0)`` on the card,
Adam at lr 1e-4 and ``chip_smoke.py``'s full-width batch (``TRAIN_FULL``:
B=2 30 s clips, P=512), as the smoke's ``training_phase`` builds them.  The
step is graphed (``make_train_step``: a CUDA graph per batch shape) unless
``--eager`` asks for ``make_train_step(cfg, eager=True)``; ``--fused`` steps
``torch.optim.Adam(..., fused=True)`` in place of the default multi-tensor
(foreach) Adam.  Two first steps
(graphed: the warm-up, then the capture and its replay; the capture's host
ms is printed), ``--steps`` steps between two CUDA events (ms a step), then
one step under ``torch.profiler``: the device kernels' time summed by name
(the top 25), by kind (GEMMs, convolutions, NCCL collectives, the
optimizer's multi-tensor kernels, the rest), their sum against the step's
wall time (the device's busy share), and the step's peak memory.

With ``--dp``/``--tp`` above 1 the step runs on that mesh: one spawned rank a
card over NCCL when there are enough cards, else the ranks share ``cuda:0``
over gloo (collectives through host memory), as ``chip_smoke.py``'s
``mesh_training_phase`` spawns them; each rank's report is printed, with the
collectives it called and the bytes it handed them a step.  A step whose
busy share is low while its kernels are few is host- or collective-bound
(gloo's collectives are host work, NCCL's show as kernels).  Prints the
card's name and power limit beside the numbers.  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    SEED,
    TRAIN_FULL,
    card_identity,
    mesh_train_state,
    spawn_ranks,
    timed_steps,
    train_batch,
)

KINDS = (
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("convolution", ("conv", "cudnn", "implicit_", "xmma_fprop", "dgrad", "wgrad")),
    ("collective (NCCL)", ("nccl",)),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, copies)"


def profile_arm(dtype, steps: int, mesh=None, device="cuda", eager: bool = False,
                fused: bool = False) -> dict:
    """One dtype's report: ms a step, the profiled step's wall and kernels
    by name, peak memory, collectives and bytes a step, whether the step was
    graphed and its capture's host ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qwen3_asr_tpu_torch.config import ModelConfig
    from qwen3_asr_tpu_torch.training.train import make_train_step

    cfg = ModelConfig()
    B, frames, valid, n_audio, P = TRAIN_FULL
    torch.cuda.reset_peak_memory_stats(device)
    state = mesh_train_state(cfg, dtype, device, mesh, **({"fused": True} if fused else {}))
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, device)
    step = make_train_step(cfg, eager=eager)
    for _ in range(2):
        state, _ = step(state, batch)
    state, _, ms, calls, nbytes = timed_steps(step, state, batch, steps, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # User annotations (``Optimizer.step#Adam.step``) also sit on the
        # device timeline; only kernels, copies and fills count.
        if (ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0
                and not getattr(ev, "is_user_annotation", False) and "#" not in ev.name):
            by_name[ev.name][0] += ev.device_time_total / 1e3
            by_name[ev.name][1] += 1
    graphed, capture_ms = step.graphed(state), step.stats.capture_ms
    step.close()
    del state, batch
    torch.cuda.empty_cache()
    return {"ms": ms, "wall_ms": wall_ms, "by_name": dict(by_name), "steps": steps,
            "graphed": graphed, "capture_ms": capture_ms, "fused": fused,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "calls": calls, "bytes": nbytes}


def print_report(label: str, card: str, rep: dict) -> None:
    by_name = rep["by_name"]
    total = sum(t for t, _ in by_name.values())
    by_kind: dict[str, float] = defaultdict(float)
    for name, (t, _) in by_name.items():
        by_kind[kind_of(name)] += t
    mode = (f"graphed (capture {rep['capture_ms']:.1f} ms host)" if rep["graphed"] else "eager")
    mode += ", fused Adam" if rep["fused"] else ", foreach Adam"
    print(f"{label}, {mode}: {rep['ms']:.1f} ms a step (CUDA events, mean of {rep['steps']}); profiled "
          f"step: wall {rep['wall_ms']:.1f} ms, kernels {total:.1f} ms "
          f"({total / rep['wall_ms']:.1%} busy), {sum(n for _, n in by_name.values())} kernels; "
          f"peak memory {rep['peak_gb']:.2f} GB; {rep['calls']:.0f} collectives a step, "
          f"{rep['bytes'] / 1e9:.3f} GB handed to them ({card})")
    for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {t:.2f} ms ({t / max(total, 1e-9):.1%})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t:8.2f} ms {n:5d}x  {name[:110]}")


def profile_rank(rank: int, dp: int, tp: int, workdir: str, backend: str, dtypes: list,
                 steps: int, eager: bool, fused: bool) -> None:
    """One mesh rank (a spawned process): each dtype's report, saved."""
    sys.path.insert(0, str(ROOT))
    import torch

    from qwen3_asr_tpu_torch import parallel

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(num_processes=dp * tp, process_id=rank, backend=backend,
                        init_method=f"file://{workdir}/init")
    mesh = parallel.make_mesh(dp, tp)
    out = {label: profile_arm(dtype, steps, mesh, device, eager, fused) for label, dtype in dtypes}
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtypes", default="f32,bf16")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--eager", action="store_true",
                        help="run make_train_step(cfg, eager=True), not the graphed step")
    parser.add_argument("--fused", action="store_true",
                        help="step torch.optim.Adam(..., fused=True), not the foreach Adam")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile.py: no CUDA device", file=sys.stderr)
        return 1
    card = card_identity()
    print(card)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = [(label, {"f32": torch.float32, "bf16": torch.bfloat16}[label])
              for label in args.dtypes.split(",")]
    if args.dp * args.tp == 1:
        for label, dtype in dtypes:
            print_report(label, card, profile_arm(dtype, args.steps, eager=args.eager,
                                                  fused=args.fused))
        return 0
    backend = "nccl" if torch.cuda.device_count() >= args.dp * args.tp else "gloo"
    ranks = spawn_ranks(profile_rank, args.dp, args.tp, f"train_profile_{args.dp}x{args.tp}",
                        backend, dtypes, args.steps, args.eager, args.fused)
    for r, rank in enumerate(ranks):
        for label, _ in dtypes:
            print_report(f"(dp={args.dp}, tp={args.tp}) over {backend}, rank {r}, {label}", card,
                         rank[label])
    return 0


if __name__ == "__main__":
    sys.exit(main())
