#!/usr/bin/env python3
"""Device busy share and launches per iteration of the PyTorch port's decode
loops on one CUDA GPU.

    python3 tools/torch_decode_profile.py [--runs 2] [--out DIR]

Builds the 1.7B model from random weights (seed 0, bf16), and for the plain
loop (``speculative="off"``) and the default speculative loop (``"auto"``)
runs greedy ``transcribe_batch`` of the smoke batch (8 clips of 4-30 s,
``max_tokens=64``) and ``transcribe`` of its 30 s clip: once to warm up,
``--runs`` times unprofiled in turns (off, auto, auto, off; decode ms per
iteration and per emitted token), then ``--runs`` times under
``torch.profiler``.  From each Chrome trace it takes the host window of the
``qwen3_asr/decode`` span and the device kernels that start inside it, and
prints per run: decode wall ms, iterations, kernels per iteration, kernel
ms per iteration, busy share (kernel time over the window) and the top
kernels by time.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import StubTokenizer, smoke_clips  # noqa: E402


def decode_window(trace: dict) -> dict:
    """Kernel count, kernel time and busy share inside the decode span."""
    events = trace["traceEvents"]
    span = next(e for e in events
                if e.get("cat") == "user_annotation" and e.get("name") == "qwen3_asr/decode")
    lo, hi = span["ts"], span["ts"] + span["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel" and lo <= e["ts"] < hi]
    by_name = Counter()
    for k in kernels:
        by_name[k["name"][:60]] += k["dur"]
    busy = sum(k["dur"] for k in kernels)
    return {"wall_us": span["dur"], "kernels": len(kernels), "kernel_us": busy,
            "busy": busy / span["dur"], "top": by_name.most_common(5)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile.py: no CUDA device", file=sys.stderr)
        return 1
    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    base = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                runtime=RuntimeConfig(speculative="off"),
                                dtype=torch.bfloat16, seed=0, device="cuda")
    models = {
        "off": base,
        "auto": Qwen3ASR(base._config, base._encoder_params, base._decoder_params,
                         base._tokenizer, RuntimeConfig()),
    }
    clips = smoke_clips()
    calls = {
        "B=8": lambda m: m.transcribe_batch(clips, max_tokens=64),
        "B=1": lambda m: m.transcribe(clips[-1], max_tokens=64),
    }
    for m in models.values():
        for call in calls.values():
            call(m)
    torch.cuda.synchronize()
    # Unprofiled decode times, the loops in turns (off, auto, auto, off).
    for run in range(args.runs):
        for label, call in calls.items():
            for name in ("off", "auto", "auto", "off"):
                m = models[name]
                call(m)
                st = m.last_stats
                ms = st.stages["decode"] * 1e3
                print(f"[{card}] {label} speculative={m._runtime.speculative!r} unprofiled: "
                      f"decode {ms:.1f} ms over {st.n_decode_steps} iterations = "
                      f"{ms / max(st.n_decode_steps, 1):.2f} ms/iteration, "
                      f"{ms / st.n_generated_tokens:.3f} ms per emitted token")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for run in range(args.runs):
        for label, call in calls.items():
            for name, m in models.items():
                with torch.profiler.profile(activities=acts) as prof:
                    call(m)
                    torch.cuda.synchronize()
                path = out / f"{name}_{label}_{run}.json"
                prof.export_chrome_trace(str(path))
                w = decode_window(json.loads(path.read_text()))
                st = m.last_stats
                it = max(st.n_decode_steps, 1)
                print(f"[{card}] {label} speculative={m._runtime.speculative!r} run {run}: "
                      f"decode {w['wall_us'] / 1e3:.1f} ms (profiled) over {st.n_decode_steps} "
                      f"iterations, {st.n_generated_tokens} tokens; {w['kernels'] / it:.0f} "
                      f"kernels and {w['kernel_us'] / 1e3 / it:.3f} kernel-ms per iteration; "
                      f"device busy {w['busy']:.1%}; top kernels (us): "
                      + ", ".join(f"{n} {d:.0f}" for n, d in w["top"]))
                path.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
