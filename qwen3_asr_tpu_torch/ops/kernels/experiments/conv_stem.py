"""K11e: fused 3x3 stride-2 conv + bias + exact GELU over NHWC images.

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/conv_stem.py:conv_s2_gelu``:
x (N, H, W, C) channels-last, w (3, 3, C, O) (HWIO), b (O,); returns
``GELU(conv2d(x, w, stride 2, pad 1) + b)`` as (N, H', W', O) with
H' = (H - 1) // 2 + 1.  The encoder's ``"pallas"`` stem runs it for conv2
and conv3.

Bound on the H100: operations (conv2 of the 1.7B encoder is 3.3 GFLOP per
100-frame chunk on ~2.6 MB).  The CUDA kernel (``csrc/conv_stem.cu``) is an
implicit GEMM for Hopper, M = N * H' * W', N = O, K = 9 * C: 128 x 240
output tiles on ``wgmma`` (bf16 in, f32 accumulate) behind a 4-stage
mbarrier ring, the weights by TMA and each tap's rows gathered by a producer
warpgroup with ``cp.async`` straight from the NHWC input at the stride-2
offsets (no padded or phase-separated copy, and no slicing of N, both of
which the TPU kernel needed), and the bias and the exact GELU in the
epilogue.  It takes C and O multiples of 8.

Numerics follow the TPU kernel: conv + bias accumulate in f32 and round to
x's dtype, then the exact GELU (which the TPU applies outside its kernel)
rounds again.

On a CPU tensor the wrapper runs :func:`conv_s2_gelu_plain` (the nine tap
products of :func:`conv2d_s2_taps_f32` + bias, rounded to x's dtype, then
``F.gelu``); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

NAME = "conv_s2_gelu"


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32 (bf16 operands on the
    GPU keep the f32 accumulator)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def conv2d_s2_taps_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 conv as nine shifted products, in float32:
    ``out[h, w] = sum_{dy, dx} xpad[2h + dy, 2w + dx] @ w[dy, dx]``,
    (N, H, W, C) x (3, 3, C, O) -> f32 (N, H', W', O)."""
    N, H, W, C = x.shape
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy : dy + 2 * (Ho - 1) + 1 : 2, dx : dx + 2 * (Wo - 1) + 1 : 2, :]
            part = _mm_f32(tap.reshape(-1, C), w[dy, dx]).reshape(N, Ho, Wo, -1)
            out = part if out is None else out + part
    return out


def conv_s2_gelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tap sum in f32 plus the bias, rounded to x's dtype, then the
    exact GELU."""
    y = (conv2d_s2_taps_f32(x, w) + b.float()).to(x.dtype)
    return F.gelu(y, approximate="none")


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError("x must be (N, H, W, C), w (3, 3, C, O) and b (O,)")
    N, H, W, C = x.shape
    O = w.shape[-1]
    if tuple(w.shape[:3]) != (3, 3, C) or b.shape[0] != O:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if C % 8 or O % 8:
        raise ValueError(f"C={C} and O={O} must be multiples of 8")
    if N * H * W >= 2**31 or H >= 2**14 or W >= 2**14:
        raise ValueError(f"{N} images of {H}x{W}: too many pixels for one launch")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x.dtype}, {w.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def conv_s2_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GELU(conv2d(x, w, stride 2, pad 1) + b): (N, H, W, C) x (3, 3, C, O)
    + (O,) -> (N, H', W', O) in x's dtype."""
    if not x.is_cuda:
        return conv_s2_gelu_plain(x, w, b)
    _build.refuse_autograd(NAME, x, w, b)
    _check(x, w, b)
    N, H, W, C = x.shape
    O = w.shape[-1]
    out = torch.empty((N, (H - 1) // 2 + 1, (W - 1) // 2 + 1, O), dtype=x.dtype,
                      device=x.device)
    bias = b.to(torch.float32).contiguous()
    err = _build.library().conv_s2_gelu_bf16(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), N, H, W, C, O,
        _build.stream_ptr(x),
    )
    _build.check(err, NAME)
    _build.count(NAME)
    return out
