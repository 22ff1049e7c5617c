#!/usr/bin/env python3
"""A/B of the port's prefill kernels against an earlier version of their CUDA
sources, on one CUDA GPU, in one process.

    python3 tools/torch_kernel_ab.py --parent DIR [--rounds N]

``DIR`` holds an earlier ``flash_attention.cu`` (K1) and ``conv_stem.cu``
(K11e) with the headers they include, e.g. from
``git show <commit>:qwen3_asr_tpu_torch/csrc/flash_attention.cu``.  The
tool compiles them with the port's nvcc flags into a library of their own
(in ``DIR``), binds the two C entry points, which keep their signatures,
and then, on the same inputs:

  * says whether the two versions' outputs are bit-identical, and holds
    both to the plain PyTorch version (K1: f32 causal
    attention, atol 2e-2 + rtol 2e-2; K11e: the f32 tap sum + bias rounded
    to bf16, then the exact GELU, atol 2e-2 + rtol 2e-2);
  * times them in turns, parent, change, change, parent, per round, with
    CUDA events (the mean over 20 calls, 10 for K11e, after a warm-up),
    beside the library call (``scaled_dot_product_attention`` causal with
    GQA; cuDNN's ``F.conv2d`` with bias on channels-last data) and the
    bound (bytes over 3.35 TB/s or operations over 989 bf16 TFLOP/s,
    whichever is larger).

Shapes: K1 at B=8 and B=64 (Hq 16, Hkv 8, D 128), T=448, the main path's
largest smoke prefill and the micro-bench's ``prefill64``; K11e at conv2's
and conv3's shapes for the smoke's 256 chunks.  The first line is the
card's ``nvidia-smi`` name and power limit; the last line one JSON object
with every reading.  Needs a CUDA device and ``nvcc``; exits non-zero
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLASH_SHAPES = ((8, 448), (64, 448))
HQ, HKV, D = 16, 8, 128


def parent_library(parent: Path) -> ctypes.CDLL:
    """Compile the parent's two sources into ``parent/libparent.so``."""
    from qwen3_asr_tpu_torch.ops.kernels import _build

    sources = [parent / "flash_attention.cu", parent / "conv_stem.cu"]
    for src in sources:
        if not src.is_file():
            raise SystemExit(f"torch_kernel_ab: {src} is missing")
    nvcc = _build._nvcc()
    objects = [src.with_suffix(".o") for src in sources]
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                     for s, o in zip(sources, objects)])
    lib_path = parent / "libparent.so"
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                      *map(str, objects)]])
    lib = ctypes.CDLL(str(lib_path))
    for name in ("flash_attention_causal_bf16", "conv_s2_gelu_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def run_flash(lib, q, k, v):
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    out = torch.empty_like(q)
    err = lib.flash_attention_causal_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1],
        k.shape[1], q.shape[2], float(q.shape[3] ** -0.5), _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"parent flash_attention_causal_bf16: CUDA error {err}")
    return out


def run_conv(lib, x, w, b):
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    N, H, W, C = x.shape
    O = w.shape[-1]
    out = torch.empty((N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, O), dtype=x.dtype,
                      device=x.device)
    err = lib.conv_s2_gelu_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                N, H, W, C, O, _build.stream_ptr(x))
    if err:
        raise RuntimeError(f"parent conv_s2_gelu_bf16: CUDA error {err}")
    return out


def in_turns(parent_fn, change_fn, rounds: int, iters: int) -> tuple[list, list]:
    """Times of parent and change, parent, change, change, parent per round."""
    from chip_smoke import cuda_ms

    p, c = [], []
    for _ in range(rounds):
        p.append(cuda_ms(parent_fn, iters=iters))
        c.append(cuda_ms(change_fn, iters=iters))
        c.append(cuda_ms(change_fn, iters=iters))
        p.append(cuda_ms(parent_fn, iters=iters))
    return p, c


def ab_flash(lib, gen, rounds: int) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from chip_smoke import PEAK_BF16_TFLOPS, _close, bound, cuda_ms
    from qwen3_asr_tpu_torch.ops.kernels import flash_attention as fa

    rows = []
    for B, T in FLASH_SHAPES:
        q = torch.randn(B, HQ, T, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, HKV, T, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, HKV, T, D, generator=gen, device="cuda").bfloat16()
        ref = fa.flash_attention_causal_plain(q.float(), k.float(), v.float())
        out, pout = fa.flash_attention_causal(q, k, v), run_flash(lib, q, k, v)
        err = _close(f"K1 B={B} T={T}", out, ref, 2e-2, 2e-2)
        perr = _close(f"parent K1 B={B} T={T}", pout, ref, 2e-2, 2e-2)
        same = torch.equal(out, pout)
        del out, pout, ref
        p, c = in_turns(lambda: run_flash(lib, q, k, v),
                        lambda: fa.flash_attention_causal(q, k, v), rounds, 20)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        flops = 4 * B * HQ * D * T * (T + 1) / 2
        b = bound(2 * B * T * D * (2 * HQ + 2 * HKV), flops, PEAK_BF16_TFLOPS * 1e12)
        row = {"kernel": "K1", "B": B, "T": T, "max_abs_err": err, "parent_max_abs_err": perr,
               "bit_identical": same,
               "ms": c, "parent_ms": p, "library_ms": library_ms, **b}
        print(f"K1 B={B} T={T}: change {statistics.median(c):.4f} ms {[round(x, 4) for x in c]}, "
              f"parent {statistics.median(p):.4f} ms {[round(x, 4) for x in p]}, sdpa "
              f"{library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) = "
              f"{b['bound_ms'] / statistics.median(c):.1%} of the change's time; err "
              f"{err:.3e} / parent {perr:.3e}; outputs bit-identical: {same}")
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def ab_conv(lib, gen, rounds: int) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from chip_smoke import PEAK_BF16_TFLOPS, STEM_CONVS, _close, bound, cuda_ms
    from qwen3_asr_tpu_torch.ops.kernels.experiments import conv_stem as cs

    rows = []
    for name, N, H, W, C in STEM_CONVS:
        x = torch.randn(N, H, W, C, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(3, 3, C, C, generator=gen, device="cuda")).bfloat16()
        b = 0.1 * torch.randn(C, generator=gen, device="cuda")
        ref = cs.conv_s2_gelu_plain(x, w, b)
        out, pout = cs.conv_s2_gelu(x, w, b), run_conv(lib, x, w, b)
        err = _close(f"K11e {name}", out, ref, 2e-2, 2e-2)
        perr = _close(f"parent K11e {name}", pout, ref, 2e-2, 2e-2)
        same = torch.equal(out, pout)
        del out, pout, ref
        p, c = in_turns(lambda: run_conv(lib, x, w, b), lambda: cs.conv_s2_gelu(x, w, b),
                        rounds, 10)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.bfloat16()
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, b16, stride=2, padding=1), iters=10)
        Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
        flops = 2 * N * Ho * Wo * C * 9 * C
        bnd = bound(x.numel() * 2 + w.numel() * 2 + C * 4 + N * Ho * Wo * C * 2, flops,
                    PEAK_BF16_TFLOPS * 1e12)
        cm = statistics.median(c)
        print(f"K11e {name} N={N} {H}x{W}x{C}: change {cm:.4f} ms {[round(x_, 4) for x_ in c]}, "
              f"parent {statistics.median(p):.4f} ms {[round(x_, 4) for x_ in p]}, F.conv2d+bias "
              f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
              f"change {flops / (cm * 1e-3) / 1e12 / PEAK_BF16_TFLOPS:.1%} of the bf16 peak; "
              f"err {err:.3e} / parent {perr:.3e}; outputs bit-identical: {same}")
        rows.append({"kernel": "K11e", "conv": name, "N": N, "max_abs_err": err,
                     "bit_identical": same,
                     "parent_max_abs_err": perr, "ms": c, "parent_ms": p,
                     "library_ms": library_ms, **bnd})
        del x, w, x_cl, w_cl
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the earlier flash_attention.cu and conv_stem.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SEED, card_identity
    from qwen3_asr_tpu_torch.ops.kernels import _build

    print(card_identity())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    _build.library()
    lib = parent_library(args.parent.resolve())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = ab_flash(lib, gen, args.rounds) + ab_conv(lib, gen, args.rounds)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
