"""Rotary position embeddings, non-interleaved "half-split" variant
(counterpart of ``qwen3_asr_tpu/ops/rope.py``).

The head dim is split into two contiguous halves [x1 | x2] rotated as
(x1*cos - x2*sin, x1*sin + x2*cos); angles are computed in float32.  The
decoder computes the angles once per forward (:func:`rope_cos_sin`) and
applies them to every layer's q and k (:func:`apply_rope`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=8)
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    return (1.0 / (theta ** exponents)).astype(np.float32)


# Unbounded: captured CUDA graphs read the tensor, which an eviction would free.
@lru_cache(maxsize=None)
def _device_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float = 1_000_000.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (cos, sin) of the angles at integer ``positions`` (...),
    each (..., head_dim // 2)."""
    inv_freq = _device_frequencies(head_dim, float(theta), positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Rotate ``x`` (..., T, head_dim) by angles broadcastable to
    (..., T, head_dim // 2); returns x's dtype, rounded into ``out`` when
    given (the same rounding, in place of a new tensor)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype) if out is None else out.copy_(rotated)


def rope_rotate(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 1_000_000.0
) -> torch.Tensor:
    """Apply RoPE to ``x`` (..., T, head_dim) at integer ``positions``
    broadcastable to (..., T), typically (B, 1, T)."""
    return apply_rope(x, *rope_cos_sin(positions, x.shape[-1], theta))
