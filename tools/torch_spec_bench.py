#!/usr/bin/env python3
"""A/B the decode loop of the PyTorch port on one CUDA GPU: plain greedy
against speculative (n-gram draft), the port of ``tools/spec_bench.py``.

    python3 tools/torch_spec_bench.py [--batch 1] [--steps 192] [--gamma 3] [--ngram N]
        [--init random|zero] [--temperature 0.0] [--quant none|int8]

The speculative win factorizes into two measurable pieces:
  * mechanism overhead: ms per verify FORWARD (gamma + 1 positions) against
    ms per plain step.  At B=1 the step is weight-stream bound, so the
    ratio should be near 1.0, whatever the workload;
  * acceptance: tokens emitted per forward.  It depends on how repetitive
    the stream is.  ``--init zero`` makes every argmax the same, so every
    draft is accepted: the UPPER bound (``gamma + 1``).  ``--init random``
    (bf16 weights drawn from a seeded generator) barely repeats: near the
    no-acceptance floor (1.0).

The decoder is ``ModelConfig()``'s (the published 1.7B widths), built with
``init_decoder_params`` (``None`` for zero weights) and
``fuse_decoder_params``, int8-quantized under ``--quant int8``; it runs
through ``Generator.generate_batch`` (prefill, then the decode loop
replayed from CUDA graphs) on zero audio features and a fixed prompt.  The
time per token is the difference of two budgets' walls, ``--steps`` and
``max(8, steps // 4)``, over their difference, the least of 4 pairs;
tokens per forward come from ``Generator.last_spec_forwards`` (verify
iterations).  Prints the card's ``nvidia-smi`` name and power limit first,
then one JSON line per mode (``off``, ``ngram``) with its peak device
memory.  Needs a CUDA device (exits 1 without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

AUDIO_PAD = 151676


def run_one(gen, B, n, audio_tokens=416, temperature=0.0):
    """(wall seconds, tokens emitted) of one ``generate_batch`` of B lanes
    with a budget of ``n`` tokens each, on zero audio features."""
    import torch

    device = gen.params["final_norm"].device
    feats = torch.zeros((B, audio_tokens, gen.cfg.hidden_size), dtype=torch.bfloat16,
                        device=device)
    prompts = [list(range(10)) + [AUDIO_PAD] * audio_tokens + [7] * 5] * B
    t0 = time.time()
    out = gen.generate_batch(
        feats, [audio_tokens] * B, prompts,
        max_tokens=[n] * B, temperature=temperature,
        repetition_penalty=1.0, top_k=0, top_p=1.0,
    )
    return time.time() - t0, sum(len(t) for t in out)


def decoder_params(cfg, init: str, quant: str, device, dtype=None):
    """The fused decoder tree: seeded random weights or (``init="zero"``)
    zero weights, int8-quantized under ``quant="int8"``."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import fuse_decoder_params, init_decoder_params
    from qwen3_asr_tpu_torch.ops.quant import quantize_decoder_params

    generator = None
    if init == "random":
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    params = fuse_decoder_params(init_decoder_params(
        cfg, generator, dtype or torch.bfloat16, device))
    return quantize_decoder_params(params) if quant == "int8" else params


def measure(params, cfg, args, spec: str, device) -> dict:
    """One mode's JSON row: the per-token time (min over 4 budget pairs),
    decode tokens a second, tokens per forward, peak device memory."""
    import torch

    from qwen3_asr_tpu_torch import RuntimeConfig
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    rt_kw = {} if args.ngram is None else {"spec_ngram": args.ngram}
    if args.temperature > 0:
        rt_kw["spec_sampling"] = spec == "ngram"
    rt = RuntimeConfig(speculative=spec, spec_gamma=args.gamma, quantization=args.quant, **rt_kw)
    B, steps, T = args.batch, args.steps, args.temperature
    lo = max(8, steps // 4)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gen = Generator(params, cfg, rt)
    try:
        run_one(gen, B, steps, temperature=T)          # captures + warm
        run_one(gen, B, steps, temperature=T)
        run_one(gen, B, lo, temperature=T)
        per_tok = min(
            (run_one(gen, B, steps, temperature=T)[0] - run_one(gen, B, lo, temperature=T)[0])
            / (steps - lo)
            for _ in range(4)
        )
        _, n_tok = run_one(gen, B, steps, temperature=T)
        fwd = gen.last_spec_forwards if spec == "ngram" else steps
    finally:
        gen.close()
    row = {
        "mode": spec,
        "temperature": T,
        "quant": args.quant,
        "init": args.init,
        "batch": B,
        "gamma": args.gamma if spec == "ngram" else 0,
        "ms_per_token": round(per_tok * 1000, 3),
        "decode_tok_s": round(B / per_tok, 1),
        "tokens_per_forward": round(n_tok / B / max(fwd + 1, 1), 2),
    }
    if cuda:
        row["peak_memory_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--gamma", type=int, default=3)
    ap.add_argument(
        "--ngram", type=int, default=None,
        help="highest draft order (default: RuntimeConfig.spec_ngram; orders fall back "
        "to 2; set 2 to A/B the single-order draft)",
    )
    ap.add_argument(
        "--init", choices=("random", "zero"), default="random",
        help="zero weights make every argmax the same, so every draft accepts: the "
        "full-acceptance UPPER bound; random weights barely repeat: near the floor",
    )
    ap.add_argument(
        "--temperature", type=float, default=0.0,
        help="temperature > 0 A/Bs the SAMPLED loop: plain stochastic decode against "
        "speculative sampling (RuntimeConfig.spec_sampling); floor and ceiling by --init",
    )
    ap.add_argument(
        "--quant", choices=("none", "int8"), default="none",
        help="int8 weight-only quantization (K9 in the verify forward too)",
    )
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_spec_bench.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_identity
    from qwen3_asr_tpu_torch import TextDecoderConfig

    print(card_identity(), flush=True)
    cfg = TextDecoderConfig()
    params = decoder_params(cfg, args.init, args.quant, "cuda")
    for spec in ("off", "ngram"):
        print(json.dumps(measure(params, cfg, args, spec, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
