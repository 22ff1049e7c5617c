"""K9: weight-only int8 matmul (W8A16), ``(x @ wq) * s``.

Replaces ``qwen3_asr_tpu/ops/quant.py:quantized_matmul``.  x (M, K) bf16,
wq (K, N) int8 in the (in, out) layout, s (N,) f32 per-output-channel
scales; the result is bf16 or f32.  Bound on the H100: the int8 weight
bytes (at decode M is the batch).  The CUDA kernel
(``csrc/quantized_matmul.cu``) streams int8 weight tiles through a 4-stage
``cp.async`` ring in shared memory, converts them to bf16 there (exact) and
runs ``mma.sync`` m16n8k16 with f32 accumulation; the column scale is
applied to the accumulator.  A decode batch pads to 16 rows inside the
kernel, not by a copy.  It takes K a multiple of 128 and N of 16, any M.

On a CPU tensor the wrapper runs :func:`quantized_matmul_plain`, the JAX
package's non-TPU lowering ``x @ dequantize_weight(w, x.dtype)``
(``quant.py:251``); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "quantized_matmul"
_BK = 128


def quantized_matmul_plain(
    x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ dequantize(wq, s)`` in x's dtype, cast to ``out_dtype``."""
    w = (wq.float() * s[None, :]).to(x.dtype)
    return (x @ w).to(out_dtype)


def _check(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, out_dtype) -> None:
    if x.dim() != 2 or wq.dim() != 2 or s.dim() != 1:
        raise ValueError("x must be (M, K), wq (K, N) and s (N,)")
    M, K = x.shape
    Kw, N = wq.shape
    if Kw != K or s.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, s {tuple(s.shape)}")
    if K % _BK or N % 16:
        raise ValueError(f"K={K} must be a multiple of {_BK} and N={N} of 16")
    if x.dtype != torch.bfloat16 or wq.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"need bf16 x, int8 wq, f32 s; got {x.dtype}, {wq.dtype}, {s.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    for name, t in (("wq", wq), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and wq.is_contiguous() and s.is_contiguous()):
        raise ValueError("x, wq and s must be contiguous")


def quantized_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    s: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(M, K) x (K, N) int8 with (N,) scales -> (M, N) in ``out_dtype``
    (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return quantized_matmul_plain(x, wq, s, out_dtype)
    _check(x, wq, s, out_dtype)
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = _build.library().quantized_matmul_bf16(
        x.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
        int(out_dtype == torch.float32), _build.stream_ptr(x),
    )
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
