"""K1: causal GQA flash attention for the decoder's fresh prefill.

Replaces ``qwen3_asr_tpu/ops/pallas/flash_attention.py:flash_attention_causal``.
Bound on the H100: bytes at the main path's prompts (B=8, T=448), tensor-core
FLOPs (4 * T^2 / 2 * D per query head) from T ~ 1000 on.  The CUDA kernel
(``csrc/flash_attention.cu``) is built for Hopper: persistent blocks walk
(KV head, 64-row query block) items heaviest first; a producer warp keeps
TMA loads of K/V tiles in flight in an mbarrier ring, each tile read once for
the two query heads of a GQA pair (or two query tiles when Hq == Hkv); both
products run on ``wgmma`` (bf16 in, f32 accumulate), P straight from
registers, with an f32 online softmax whose arithmetic is the earlier
``mma.sync`` kernel's (its output is bit-identical).  TMA zero-fills rows past T,
so any T >= 1 works (the TPU kernel's T % 64 / T % 256 tiling rules do not
apply).

On a CPU tensor the wrapper runs :func:`flash_attention_causal_plain`, the
same function in plain PyTorch (sdpa with a causal mask).  On a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..attention import sdpa
from . import _build

NAME = "flash_attention_causal"


def flash_attention_causal_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Causal attention, q (B, Hq, T, D) over k, v (B, Hkv, T, D)."""
    T = q.shape[2]
    ids = torch.arange(T, device=q.device)
    causal = (ids[None, :] <= ids[:, None])[None, None]
    return sdpa(q, k, v, mask=causal, scale=scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, D)")
    B, hq, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != T or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if D != 128:
        raise ValueError(f"head_dim must be 128, got {D}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention_causal(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Causal self-attention (B, Hq, T, D) x (B, Hkv, T, D) -> (B, Hq, T, D);
    query i attends keys j <= i."""
    if not q.is_cuda:
        return flash_attention_causal_plain(q, k, v, scale)
    _build.refuse_autograd(NAME, q, k, v)
    _check(q, k, v)
    B, hq, T, D = q.shape
    if scale is None:
        scale = D ** -0.5
    lib = _build.library()
    out = torch.empty_like(q)
    err = lib.flash_attention_causal_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, hq, k.shape[1], T, float(scale), _build.stream_ptr(q),
    )
    _build.check(err, NAME)
    _build.count(NAME)
    return out
