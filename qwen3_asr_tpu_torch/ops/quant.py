"""Int8 weights: representation, the ``qlinear`` dispatch, parameter trees.

Counterpart of ``qwen3_asr_tpu/ops/quant.py``.  A quantized weight is a
dict ``{"q": int8 (in, out), "s": f32 (out,)}``: symmetric per-output-
channel abs-max over the last axis (``s = 1`` for an all-zero column),
rounded half to even and clipped to +-127.  ``q`` holds the JAX package's
values in its (in, out) shape, stored K-major (the transpose of a
contiguous (out, in) tensor), which the GPU kernels read without a copy.

:func:`qlinear` computes ``x @ w`` for plain or quantized weights:

  * plain weights: ``x @ w``;
  * quantized weights inside :func:`act_quant_rows` with at least
    ``min_rows`` flattened rows: W8A8, activations quantized per row and an
    int8 x int8 product (kernel K10, ``ops/kernels/w8a8_matmul.py``);
  * other quantized calls: weight-only int8 (kernel K9,
    ``ops/kernels/quantized_matmul.py``).

Under tensor parallelism (``parallel/``) a row-parallel weight holds a
K-slice of the product: :func:`qlinear_row_parallel` takes each rank's
partial product in float32 (K9 or K10 with f32 output, or a bf16 product
with an f32 accumulator), all-reduces it over the tp group and rounds it
once (a replicated bias is added after it).  Under the W8A8 gate its activation
scales are the whole row's: the rows' abs-maxima are all-reduced (max) over
the group first and K10 quantizes with them.

The JAX package scopes the row gate with a trace-time ``ContextVar``; here
the same context manager sets it for the eager calls made inside it.  The
prefill runs under it when ``quantization == act_quant == "int8"``, so the
prefill's matmuls take W8A8 while the decode steps (M = batch rows) and the
lm head stay weight-only.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any

import torch

from .kernels.quantized_matmul import quantized_matmul
from .kernels.w8a8_matmul import quantize_activations, row_amax, scales_of_amax, w8a8_matmul
from .quant_kv import div127

__all__ = [
    "DECODER_QUANT_KEYS", "ENCODER_QUANT_KEYS", "ENCODER_QUANT_TOP_KEYS",
    "act_quant_rows", "dequantize_weight", "is_quantized", "k_major", "qlinear",
    "qlinear_row_parallel",
    "quantize_activations", "quantize_decoder_params", "quantize_encoder_params",
    "quantize_weight",
]

_ACT_QUANT_MIN_ROWS: ContextVar[int | None] = ContextVar("act_quant_min_rows", default=None)


@contextmanager
def act_quant_rows(min_rows: int | None):
    """Quantized :func:`qlinear` calls made inside this context with at
    least ``min_rows`` flattened rows run W8A8; ``None`` disables."""
    token = _ACT_QUANT_MIN_ROWS.set(min_rows)
    try:
        yield
    finally:
        _ACT_QUANT_MIN_ROWS.reset(token)


def k_major(q: torch.Tensor) -> torch.Tensor:
    """The (in, out) int8 ``q`` stored K-major: the same (in, out) values as
    the transpose of a contiguous (out, in) tensor, the layout the GPU
    kernels K9 and K10 read (integer ``wgmma`` takes its operands K-major).
    One storage of in x out bytes; ``q`` itself if already so."""
    return q if q.t().is_contiguous() else q.t().contiguous().t()


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8 over the last axis of (in, out);
    ``q`` is stored K-major (:func:`k_major`)."""
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, div127(amax), torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return {"q": k_major(q), "s": scale}


def dequantize_weight(wq: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (wq["q"].float() * wq["s"][None, :]).to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qlinear(x: torch.Tensor, w: Any, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` for plain or quantized weights, any leading dims."""
    if not is_quantized(w):
        y = x @ w
        return y.to(out_dtype) if out_dtype is not None else y
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    min_rows = _ACT_QUANT_MIN_ROWS.get()
    if min_rows is not None and x2.shape[0] >= min_rows:
        y = w8a8_matmul(x2, w["q"], w["s"], out_dtype)
    else:
        y = quantized_matmul(x2, w["q"], w["s"], out_dtype)
    return y.reshape(*lead, y.shape[-1])


def _partial_f32(x2: torch.Tensor, w: Any, tp) -> torch.Tensor:
    """A row-parallel shard's (M, N) f32 partial of ``x2 @ w``: summed in
    f32 and not rounded, so the sum over the shards rounds once."""
    if is_quantized(w):
        min_rows = _ACT_QUANT_MIN_ROWS.get()
        if min_rows is not None and x2.shape[0] >= min_rows:
            from ..parallel.collectives import all_reduce_max

            scales = scales_of_amax(all_reduce_max(row_amax(x2), tp))
            return w8a8_matmul(x2, w["q"], w["s"], torch.float32, row_scales=scales)
        return quantized_matmul(x2, w["q"], w["s"], torch.float32)
    records = torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad)
    if x2.is_cuda and x2.dtype == torch.bfloat16 and not records:
        return torch.mm(x2, w, out_dtype=torch.float32)
    # torch.mm's out_dtype form has no derivative: a call that autograd
    # records multiplies f32 copies of the same bf16 operands.
    return x2.float() @ w.float()


def qlinear_row_parallel(x: torch.Tensor, w: Any, tp) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight shard ``w`` (its input rows split
    over ``tp``, a :class:`~..parallel.collectives.TP`; x holds the matching
    K-slice): the f32 partials summed over the group and rounded to x's
    dtype once.  A replicated bias is the caller's to add, once, after it.
    ``tp`` None is the one-device :func:`qlinear`."""
    if tp is None:
        return qlinear(x, w)
    from ..parallel.collectives import reduce_from_tp

    lead, K = x.shape[:-1], x.shape[-1]
    part = _partial_f32(x.reshape(-1, K).contiguous(), w, tp)
    return reduce_from_tp(part, tp).to(x.dtype).reshape(*lead, part.shape[-1])


#: Decoder linear weights that are quantized (both layouts).
DECODER_QUANT_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "wqkv", "wgu")
#: Encoder matmul weights quantized in the W8A8 prefill mode: the layers'
#: projections and MLP, and the top-level conv-flatten and head linears.
#: Conv kernels, biases and norms stay full precision.
ENCODER_QUANT_KEYS = ("wq", "wk", "wv", "wo", "fc1_w", "fc2_w")
ENCODER_QUANT_TOP_KEYS = ("conv_out", "proj1_w", "proj2_w")


def _quantize_layers(layers: list[dict], keys) -> list[dict]:
    return [
        {k: quantize_weight(v) if k in keys else v for k, v in lp.items()}
        for lp in layers
    ]


def quantize_encoder_params(params: dict) -> dict:
    """The encoder's matmul weights to int8 (only with ``act_quant="int8"``,
    whose W8A8 path uses them)."""
    out = dict(params)
    out["layers"] = _quantize_layers(params["layers"], ENCODER_QUANT_KEYS)
    for key in ENCODER_QUANT_TOP_KEYS:
        if key in out:
            out[key] = quantize_weight(out[key])
    return out


def quantize_decoder_params(params: dict) -> dict:
    """The decoder's linear weights and the tied embedding to int8.  The
    embedding is stored transposed, ``{"q": (H, V) int8, "s": (V,)}``, so
    the lm head is a direct (M, H) x (H, V) call and a lookup gathers
    columns."""
    return {
        "embedding": quantize_weight(params["embedding"].T),
        "layers": _quantize_layers(params["layers"], DECODER_QUANT_KEYS),
        "final_norm": params["final_norm"],
    }
