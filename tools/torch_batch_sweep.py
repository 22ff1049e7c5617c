#!/usr/bin/env python3
"""End-to-end batch-size sweep of the PyTorch port on one CUDA GPU: where the
throughput stops growing.

    python3 tools/torch_batch_sweep.py [--batches 8 16 32 64 96] [--repeats 3] [--seed 0]

The counterpart of ``tools/batch_sweep.py``: greedy ``transcribe_batch`` of B
distinct noise clips of 30 s with a budget of 64 tokens each, on random
1.7B bf16 weights made from ``--seed``, through the public API with its
graphed decode loop.  Random weights keep the tensor cores' operands
nonzero and give each lane its own stream; a lane that picks EOS stops
early, which the JSON line's ``tokens`` shows.  ``--speculative off`` (the
default) measures the plain loop at every B; ``auto`` lets B <= 8 take the
speculative loop.  Each B runs once to capture its graphs, then ``--repeats``
times; one JSON line per B: the wall times, the median's RTFx (audio
seconds over wall seconds), ms per decode iteration and per emitted token
(the decode stage over iterations and tokens), the prefill stage's ms, the
loop that ran, and the peak device memory.  Prints the card's
``nvidia-smi`` name and power limit first.  Needs a CUDA device (exits 1
without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

AUDIO_SECONDS = 30.0
DECODE_TOKENS = 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32, 64, 96])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--speculative", choices=("off", "auto"), default="off")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and clips")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_batch_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import StubTokenizer, card_identity
    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig

    print(card_identity())
    model = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                 runtime=RuntimeConfig(speculative=args.speculative),
                                 dtype=torch.bfloat16, seed=args.seed, device="cuda")
    rng = np.random.default_rng(args.seed)
    pool = [(0.1 * rng.standard_normal(int(AUDIO_SECONDS * 16000))).astype(np.float32)
            for _ in range(max(args.batches))]
    for B in args.batches:
        clips = pool[:B]
        torch.cuda.reset_peak_memory_stats()
        model.transcribe_batch(clips, max_tokens=DECODE_TOKENS)       # captures the graphs
        walls, stats = [], []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            model.transcribe_batch(clips, max_tokens=DECODE_TOKENS)
            walls.append(time.perf_counter() - t0)
            stats.append(model.last_stats)
        mid = sorted(range(len(walls)), key=walls.__getitem__)[len(walls) // 2]
        st = stats[mid]
        decode_ms = st.stages["decode"] * 1e3
        print(json.dumps({
            "batch": B,
            "wall_s": round(walls[mid], 4),
            "walls_s": [round(w, 4) for w in walls],
            "rtfx": round(B * AUDIO_SECONDS / walls[mid], 1),
            "prefill_ms": round(st.stages["prefill"] * 1e3, 2),
            "decode_ms": round(decode_ms, 2),
            "ms_per_iteration": round(decode_ms / max(st.n_decode_steps, 1), 3),
            "ms_per_token": round(decode_ms / max(st.n_generated_tokens, 1), 4),
            "iterations": st.n_decode_steps,
            "tokens": st.n_generated_tokens,
            "loop": "speculative" if st.n_spec_forwards else "plain",
            "host_syncs": st.n_host_syncs,
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        }), flush=True)
    model.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
