#!/usr/bin/env python3
"""Device time of K9 (``quantized_matmul``) against its launch plan, on one
CUDA GPU: the row tile and the number of k ranges that
``ops/kernels/quantized_matmul.py:split_k_plan`` chooses between.

    python3 tools/torch_k9_sweep.py

For each (M, K, N) of the decoder's products at decode (M = 1, 8, 96) and
at the int8-weights prefill (M = 448, 3584), and the lm head at M = 96, it
launches the kernel's C entry point directly with every row tile among
the plan's (the power of two that holds M, its half and its double) and
1-32 k ranges (row tiles up to 64, not the lm head), holds each output to the f32 product of the same int8
weights (the tolerance of ``chip_smoke.py``), and times it by device time
(``chip_smoke.graph_ms``: 20 calls in a CUDA graph).  Each line lists the
eight fastest plans and the time of ``split_k_plan``'s own.  The first
line is the card's ``nvidia-smi`` name and power limit.  Needs a CUDA
device and ``nvcc``; exits 1 without a device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ((1, 2048, 2048), (8, 2048, 2048), (8, 6144, 2048), (8, 2048, 4096),
          (8, 2048, 12288), (96, 2048, 2048), (96, 6144, 2048), (96, 2048, 4096),
          (96, 2048, 12288), (96, 2048, 151936), (448, 2048, 2048), (448, 6144, 2048),
          (448, 2048, 4096), (448, 2048, 12288), (3584, 2048, 2048), (3584, 6144, 2048))


def launch(x, wq, s, out, scratch, nb: int, splits: int, per: int):
    """One kernel launch with the given plan; ``scratch`` is the split-K
    workspace and the zeroed tile counters."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    M, K = x.shape
    N = wq.shape[1]
    partial, counters = scratch
    err = _build.library().quantized_matmul_bf16(
        x.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(), partial.data_ptr(),
        counters.data_ptr(), M, N, K, int(out.dtype == torch.float32), nb, splits, per,
        _build.stream_ptr(x))
    _build.check(err, "quantized_matmul (sweep)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k9_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SEED, _close, card_identity, graph_ms, k_major_int8
    from qwen3_asr_tpu_torch.ops.kernels import quantized_matmul as qm

    print(card_identity())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scratch = (torch.empty(24 << 20, dtype=torch.float32, device="cuda"),
               torch.zeros(1 << 16, dtype=torch.int32, device="cuda"))
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        wq = k_major_int8(gen, K, N)
        s = torch.rand(N, generator=gen, device="cuda") * 1e-3
        out_dtype = torch.float32 if N == 151936 else torch.bfloat16
        rtol = 1e-5 if out_dtype == torch.float32 else 8e-3
        out = torch.empty(M, N, dtype=out_dtype, device="cuda")
        ref = x.float() @ (wq.float() * s)
        plan = qm.split_k_plan(M, N, K, sms)
        full = next(b for b in qm.ROW_TILES if b >= min(M, 256))
        k_blocks = K // qm.K_BLOCK
        times = {}
        for nb in sorted({full, max(8, full // 2), min(256, full * 2)}):
            for want in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32):
                if want > 1 and (nb > 64 or want > k_blocks // 2 or N > 16384):
                    continue
                per = -(-k_blocks // want)
                splits = -(-k_blocks // per)
                launch(x, wq, s, out, scratch, nb, splits, per)
                _close(f"K9 M={M} N={N} nb={nb} splits={splits}", out, ref,
                       1e-5 * ref.abs().max().item(), rtol)
                times[(nb, splits, per)] = graph_ms(
                    lambda: launch(x, wq, s, out, scratch, nb, splits, per))
        best = sorted(times.items(), key=lambda kv: kv[1])[:8]
        print(f"M={M} K={K} N={N}: split_k_plan {plan} "
              f"{times.get(plan, float('nan')) * 1e3:.1f} us; fastest "
              + ", ".join(f"nb{nb}/{sp} ranges {t * 1e3:.1f} us" for (nb, sp, _), t in best))
        del x, wq, ref, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
