#!/usr/bin/env python3
"""Time to the first transcript of a model loaded from disk, with the warm-up
overlapped with the load or after it, on one CUDA GPU.

    python3 tools/torch_warm_probe.py [--arms background serial serial background]
        [--seed 0] [--unbuilt]

Writes random 1.7B bf16 weights made from ``--seed`` (``ModelConfig()``) with
``save_checkpoint`` and ``save_config`` under ``build/warm_probe/``, builds the
kernels once, then runs each arm in a fresh Python process of its own, as a
user's first process after a restart would be (kernels already built on
disk, the checkpoint in the page cache, so the reads are warm); with
``--unbuilt`` the kernel library is deleted before each arm, so the arm's
first kernel launch builds it (``nvcc``), as on a fresh checkout:

* ``background``: ``Qwen3ASR.from_pretrained(dir, warm="background",
  warm_deployment=...)``, then at once ``transcribe_batch`` of the smoke's
  8 clips (64 tokens);
* ``serial``: ``from_pretrained(dir)`` (``warm="off"``), then
  ``warm_up(deployment=...)`` of the same deployment, then the same
  ``transcribe_batch``.

The deployment is the smoke's ``export_phase`` one: 30 s clips, batch 8,
64 tokens.  Each arm prints one JSON line: ``from_pretrained`` wall, the
warm's wall (``serial``: ``warm_up``; ``background``: ``wait_warm`` after
the transcript, 0 when the warm had ended), and the seconds from the call
to the first transcript.  The clock starts after CUDA's context is made,
so both arms exclude it.  Prints the card's ``nvidia-smi`` name and power
limit first; the directory is deleted at the end.  Needs a CUDA device
(exits 1 without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORKDIR = ROOT / "build" / "warm_probe"


def drop_library() -> None:
    """Delete the built kernel library, so that the next process's first
    kernel launch builds it (``nvcc``), as on a fresh checkout."""
    from qwen3_asr_tpu_torch.ops.kernels import _build

    _build.library_path().unlink(missing_ok=True)


def child(arm: str, workdir: Path) -> None:
    import torch

    from chip_smoke import EXPORT_WARM, StubTokenizer, smoke_clips
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig, api

    api.Tokenizer = lambda path: StubTokenizer()
    clips = smoke_clips()
    torch.zeros(1, device="cuda")
    rt = RuntimeConfig(speculative="off")
    t0 = time.perf_counter()
    if arm == "background":
        model = Qwen3ASR.from_pretrained(workdir, runtime=rt, warm="background",
                                         warm_deployment=EXPORT_WARM, device="cuda")
        load_s = time.perf_counter() - t0
        model.transcribe_batch(clips, max_tokens=64)
        first_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        model.wait_warm()
        warm_s = time.perf_counter() - t1
    else:
        model = Qwen3ASR.from_pretrained(workdir, runtime=rt, device="cuda")
        load_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        model.warm_up(deployment=EXPORT_WARM)
        warm_s = time.perf_counter() - t1
        model.transcribe_batch(clips, max_tokens=64)
        first_s = time.perf_counter() - t0
    print(json.dumps({"arm": arm, "from_pretrained_s": round(load_s, 3),
                      "warm_s": round(warm_s, 3), "first_transcript_s": round(first_s, 3),
                      "captures": model._generator.graphs.captures}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", nargs="+", choices=("background", "serial"),
                    default=["background", "serial", "serial", "background"])
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights")
    ap.add_argument("--unbuilt", action="store_true",
                    help="delete the kernel library before each arm")
    ap.add_argument("--child", choices=("background", "serial"), help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_warm_probe.py: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        child(args.child, WORKDIR)
        return 0
    from chip_smoke import card_identity
    from qwen3_asr_tpu_torch import ModelConfig
    from qwen3_asr_tpu_torch.models.params import random_params, save_checkpoint, save_config
    from qwen3_asr_tpu_torch.ops.kernels import _build

    print(card_identity())
    _build.library()
    shutil.rmtree(WORKDIR, ignore_errors=True)
    try:
        cfg = ModelConfig()
        t0 = time.perf_counter()
        enc, dec = random_params(cfg, seed=args.seed, dtype=torch.bfloat16, device="cuda")
        weights = save_checkpoint(WORKDIR, enc, dec)
        save_config(WORKDIR, cfg)
        del enc, dec
        torch.cuda.empty_cache()
        print(f"checkpoint {weights.stat().st_size / 1e9:.3f} GB written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for arm in args.arms:
            if args.unbuilt:
                drop_library()
            p = subprocess.run([sys.executable, __file__, "--child", arm], cwd=ROOT)
            if p.returncode:
                return p.returncode
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
