#!/usr/bin/env python3
"""Incremental-session preview latency against re-transcribing the same
prefix, on one CUDA GPU: the port of ``tools/incremental_bench.py``.

    python3 tools/torch_incremental_bench.py [--max-tokens 128] [--repeats 3]

Builds the 1.7B model (``ModelConfig()``, bf16, random weights from seed
0) with ``RuntimeConfig(speculative="off")``, so that ``transcribe`` runs
the plain graphed loop the previews run and the two differ only in how
they build the prompt's cache.  Captures the decode graphs of every bucket
first (``warm_up``).  Then feeds a 30 s clip in 1 s pieces to ``--repeats``
sessions (``max_duration=30``) at once, and at 5, 10, ..., 30 s times, in
turns, each session's ``preview()`` and a ``transcribe`` of the same prefix
as CUDA-synced wall ms.  Prints per prefix the medians, the advance ms
(every ``Generator.advance`` call of the preview: window commits and
clamp-floor re-advances, the tail window, the suffix), the decode ms per
live iteration, and where a preview's tokens leave the transcript's (bf16:
the advance's plain attention against K1's rounding).  Exits 1 without a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    SEED, StubTokenizer, _ids, card_identity, first_row_note, timed_preview, timed_transcribe,
)


def bench_clip(seconds: float = 30.0):
    """``tools/incremental_bench.py``'s clip: a 220 Hz tone under a 3 Hz
    envelope with a little noise."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * 16_000)) / 16_000
    return (0.1 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


def first_apart(a: list[int], b: list[int]) -> str:
    if a == b:
        return "=="
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return f"!= from token {i} of {len(b)}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-tokens", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_incremental_bench.py: no CUDA device", file=sys.stderr)
        return 1
    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig

    card = card_identity()
    print(card)
    model = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                 runtime=RuntimeConfig(speculative="off"),
                                 dtype=torch.bfloat16, seed=SEED, device="cuda")
    opts = dict(max_tokens=args.max_tokens, language="English")
    checkpoints = (5, 10, 15, 20, 25, 30)
    model.warm_up(durations=tuple(float(c) for c in checkpoints), batch_sizes=(1,),
                  max_tokens=args.max_tokens)
    audio = bench_clip()
    sessions = [model.incremental_session(max_duration=30.0, **opts)
                for _ in range(args.repeats)]
    gen = model._generator
    fed = 0
    for sec in checkpoints:
        while fed < sec * 16_000:
            for s in sessions:
                s.feed(audio[fed : fed + 16_000])
            fed += 16_000
        prev, full, adv, dec, apart, rows = [], [], [], [], set(), []
        for s in sessions:
            p, ms, st = timed_preview(s)
            steps = gen.last_decode_steps
            ref, ref_ms, ref_st = timed_transcribe(model, audio[:fed], opts)
            rows.append(first_row_note(st, ref_st))
            prev.append(ms)
            full.append(ref_ms)
            adv.append((st.advance_ms, st.advances))
            dec.append(st.decode_ms / max(steps, 1))
            apart.add(first_apart(_ids([p])[0], _ids([ref])[0]))
        med_p, med_f = statistics.median(prev), statistics.median(full)
        med_a = statistics.median(a for a, _ in adv)
        print(f"[inc-bench {card}] {sec:3d} s ({sessions[0]._committed} windows committed): "
              f"preview {med_p:8.2f} ms (runs {', '.join(f'{x:.2f}' for x in prev)}), "
              f"transcribe {med_f:8.2f} ms (runs {', '.join(f'{x:.2f}' for x in full)}) = "
              f"{med_f / med_p:.2f}x; advance {med_a:.2f} ms over "
              f"{'/'.join(str(n) for _, n in adv)} calls (runs "
              f"{', '.join(f'{a:.2f}' for a, _ in adv)}), decode "
              f"{statistics.median(dec):.3f} ms per iteration; tokens "
              f"{' / '.join(sorted(apart))}; {rows[0]}", flush=True)
    model.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
