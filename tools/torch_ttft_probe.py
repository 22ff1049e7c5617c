#!/usr/bin/env python3
"""Time to the first transcript of a fresh process on one CUDA GPU, through
the public API (the port of ``tools/ttft_probe.py``).

    python3 tools/torch_ttft_probe.py [--seconds 30] [--tokens 128] [--unbuilt]

This process is the fresh one: ``Qwen3ASR.from_random(ModelConfig(),
seed=None)`` (the published 1.7B widths, zero weights), then the FIRST
``transcribe`` of a ``--seconds`` clip at ``--tokens`` tokens with its
stage timers (``last_stats``), a second call, ``wait_ready`` (which returns
at once: the port compiles nothing in the background) and a steady-state
call, and one ``SUMMARY`` line.  What the first call pays for beyond the
steady one is reported apart:

  * the kernel library: its load from ``build/torch_kernels/``, or with
    ``--unbuilt`` (the library deleted first, as on a fresh checkout) its
    ``nvcc`` build;
  * the decode loop's CUDA graph captures and the last capture's ms.

The clock starts after CUDA's context is made.  Prints the card's
``nvidia-smi`` name and power limit first.  Needs a CUDA device (exits 1
without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class Tok:
    def build_prompt(self, n, language="English"):
        from qwen3_asr_tpu_torch.tokenizer import build_prompt

        return build_prompt(n, language_name_tokens=[6364])

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def time_first_load(build) -> dict:
    """Wrap ``build.library`` (the kernel wrappers look it up at each
    launch) so that its first call, which loads or builds the library, is
    timed; the seconds land in the returned dict under ``"s"``."""
    load = build.library
    spent: dict = {}

    def library():
        if "s" in spent:
            return load()
        t0 = time.perf_counter()
        lib = load()
        spent["s"] = time.perf_counter() - t0
        return lib

    build.library = library
    return spent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--unbuilt", action="store_true",
                    help="delete the kernel library first: the first call builds it")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ttft_probe.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_identity
    from torch_warm_probe import drop_library

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.ops.kernels import _build

    print(card_identity(), flush=True)
    if args.unbuilt:
        drop_library()
    present = _build.library_path().is_file()
    print(f"[ttft] kernel library {_build.library_path().name}: "
          f"{'present' if present else 'absent (the first launch builds it)'}", flush=True)
    library = time_first_load(_build)
    torch.zeros(1, device="cuda")
    print(f"[ttft] device: {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    model = Qwen3ASR.from_random(ModelConfig(), tokenizer=Tok(), runtime=RuntimeConfig(),
                                 seed=None)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    print(f"[ttft] from_random (load): {t_load:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    clip = (rng.standard_normal(int(args.seconds * 16_000)) * 0.05).astype(np.float32)

    t0 = time.perf_counter()
    res = model.transcribe(clip, max_tokens=args.tokens, temperature=0.0)
    ttft = time.perf_counter() - t0
    st = model.last_stats.as_dict() if model.last_stats else {}
    print(f"[ttft] FIRST transcribe: {ttft:.1f}s stats={st}", flush=True)
    graphs = model._generator.graphs
    captures = graphs.captures if graphs is not None else 0
    capture_ms = graphs.last_capture_ms if graphs is not None else 0.0
    lib_s = library.get("s", 0.0)
    how = (f"built by nvcc in {_build.last_build_seconds:.1f}s"
           if not present and _build.last_build_seconds else "loaded")
    print(f"[ttft] kernel library: {how}, first library() call {lib_s:.2f}s; decode graph "
          f"captures {captures}, last capture {capture_ms:.1f} ms", flush=True)
    print(f"[ttft] tokens: {len(res.text.split())}", flush=True)

    t0 = time.perf_counter()
    model.transcribe(clip, max_tokens=args.tokens, temperature=0.0)
    t2 = time.perf_counter() - t0
    print(f"[ttft] second transcribe: {t2:.2f}s", flush=True)

    t0 = time.perf_counter()
    model.wait_ready()
    print(f"[ttft] wait_ready: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    model.transcribe(clip, max_tokens=args.tokens, temperature=0.0)
    t3 = time.perf_counter() - t0
    graphs = model._generator.graphs
    print(f"[ttft] steady-state transcribe: {t3:.2f}s", flush=True)
    print(
        f"[ttft] SUMMARY load={t_load:.1f}s ttft={ttft:.1f}s second={t2:.2f}s "
        f"steady={t3:.2f}s library={lib_s:.2f}s ({'built' if not present else 'loaded'}) "
        f"captures={graphs.captures if graphs is not None else 0}",
        flush=True,
    )
    model.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
