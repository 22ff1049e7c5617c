"""int8 KV cache: per-row symmetric abs-max quantization.

Counterpart of ``qwen3_asr_tpu/ops/quant_kv.py``.  The quantized cache is a
dict ``{"q": int8 (L, B, Hkv, S, D), "s": f32 (L, B, Hkv, S)}``: one scale
per (layer, lane, head, slot) row, ``s = max|x| / 127`` (1 for an all-zero
row) and ``q = clip(round(x / s), -127, 127)``.  It halves the decode
loop's largest read stream; attention folds the scales into the scores and
probabilities (kernel K4, ``ops/kernels/decode_attention.py``).
"""

from __future__ import annotations

from typing import Any

import torch


def is_quantized_kv(cache: Any) -> bool:
    """True for the ``{"q", "s"}`` quantized cache."""
    return isinstance(cache, dict) and "q" in cache and "s" in cache


def kv_seq_len(cache: Any) -> int:
    """Cache sequence length S of a plain or quantized cache."""
    return (cache["q"] if is_quantized_kv(cache) else cache).shape[3]


def div127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as an IEEE f32 division.  A Python-scalar divisor would
    let PyTorch's CUDA kernel multiply by the reciprocal instead, which can
    differ in the last bit from the JAX package and from the CUDA kernels."""
    return amax / torch.full_like(amax, 127.0)


def quantize_kv(arr: torch.Tensor) -> dict:
    """(..., S, D) float -> ``{"q": int8 (..., S, D), "s": f32 (..., S)}``."""
    x = arr.float()
    amax = x.abs().amax(dim=-1)
    s = torch.where(amax == 0.0, torch.ones_like(amax), div127(amax))
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_kv(cache: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``{"q", "s"}`` -> dense (..., S, D) tensor."""
    return (cache["q"].float() * cache["s"][..., None]).to(dtype)


def quantize_kv_cache(kv: tuple[torch.Tensor, torch.Tensor], out=None) -> tuple[dict, dict]:
    """Quantize a freshly prefilled (keys, values) pair, one layer at a time
    so the f32 temporaries stay one layer large, into new tensors or into
    the ``{"q", "s"}`` pair ``out`` (the decode graphs' arena).  The caller
    drops the bf16 pair afterwards."""
    if out is None:
        out = tuple(
            {"q": torch.empty(c.shape, dtype=torch.int8, device=c.device),
             "s": torch.empty(c.shape[:-1], dtype=torch.float32, device=c.device)}
            for c in kv
        )
    for cache, dst in zip(kv, out):
        for layer in range(cache.shape[0]):
            ql = quantize_kv(cache[layer])
            dst["q"][layer] = ql["q"]
            dst["s"][layer] = ql["s"]
    return out[0], out[1]
