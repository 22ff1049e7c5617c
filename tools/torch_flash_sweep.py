#!/usr/bin/env python3
"""K1 (``flash_attention_causal``) against ``scaled_dot_product_attention``
on one CUDA GPU, over the prefill shapes where the library call leads.

    python3 tools/torch_flash_sweep.py [--batches 8 64 96] [--lengths 448 1024 2048]

The counterpart of ``tools/flash_sweep.py``, which sweeps the Pallas
kernel's block sizes on the TPU.  K1's tiling is fixed (a 128-row query
tile per block, ``csrc/flash_attention.cu``), so this sweeps the shapes
instead: the decoder's causal GQA prefill (16 query heads, 8 KV heads, head
dim 128, bf16) at every B x T, K1 and SDPA (causal, ``enable_gqa``) timed
by device time (CUDA events, the mean of ``--iters`` calls after a warm
up) in turns K1, SDPA, SDPA, K1, with the bound (the larger of the bytes
over 3.35 TB/s and the causal products' FLOPs over 989 bf16 TFLOP/s), each
one's TFLOP/s and share of the bf16 peak, and K1's output held to SDPA's
(atol 2e-2 + rtol 2e-2, the smoke's K1 tolerance).  Prints the card's
``nvidia-smi`` name and power limit first and one JSON line per shape.
Needs a CUDA device (exits 1 without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

HQ, HKV, D = 16, 8, 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 64, 96])
    ap.add_argument("--lengths", type=int, nargs="+", default=[448, 1024, 2048])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import PEAK_BF16_TFLOPS, bound, card_identity, cuda_ms
    from qwen3_asr_tpu_torch.ops.kernels.flash_attention import flash_attention_causal

    print(card_identity())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in args.batches:
        for T in args.lengths:
            q = torch.randn(B, HQ, T, D, generator=gen, device="cuda").bfloat16()
            k = torch.randn(B, HKV, T, D, generator=gen, device="cuda").bfloat16()
            v = torch.randn(B, HKV, T, D, generator=gen, device="cuda").bfloat16()

            def k1():
                return flash_attention_causal(q, k, v)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

            out, ref = k1(), sdpa()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if not bool((diff <= 2e-2 + 2e-2 * ref.float().abs()).all()):
                raise AssertionError(f"K1 B={B} T={T}: max |K1 - SDPA| {err:.3e} over tolerance")
            turns = [cuda_ms(fn, iters=args.iters) for fn in (k1, sdpa, sdpa, k1)]
            k1_ms, sdpa_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            flops = 4 * B * HQ * D * T * (T + 1) / 2
            b = bound(2 * B * T * D * (2 * HQ + 2 * HKV), flops, PEAK_BF16_TFLOPS * 1e12)
            row = {
                "B": B, "T": T, "k1_ms": round(k1_ms, 4), "sdpa_ms": round(sdpa_ms, 4),
                "turns_ms": [round(t, 4) for t in turns],
                "sdpa_speedup": round(k1_ms / sdpa_ms, 3),
                "bound_ms": round(b["bound_ms"], 4), "bound_by": b["bound_by"],
                "k1_tflops": round(flops / k1_ms / 1e9, 1),
                "sdpa_tflops": round(flops / sdpa_ms / 1e9, 1),
                "k1_peak_share": round(b["bound_ms"] / k1_ms, 3),
                "sdpa_peak_share": round(b["bound_ms"] / sdpa_ms, 3),
                "max_abs_diff_vs_sdpa": err,
            }
            print(json.dumps(row), flush=True)
            del q, k, v, out, ref, diff
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
