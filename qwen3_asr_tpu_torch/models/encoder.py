"""Qwen3-ASR audio encoder (Whisper-style) in PyTorch.

Counterpart of ``qwen3_asr_tpu/models/encoder.py:118-437``:

  * 3x Conv2D(k=3, s=2, p=1) + exact GELU over (mel=128, time=100) chunks,
    480 channels, then a channel-major flatten to (tokens, ch * freq') and
    Linear(7680 -> 1024, no bias), lowered as :data:`CONV_STEM_MODE` says;
  * per-chunk sinusoidal positions restarting at 0 every chunk;
  * pre-norm LayerNorm (eps 1e-5) transformer layers with block-diagonal
    attention over 104-token windows; invalid (padding) tokens are masked
    as keys and their features zeroed on output;
  * ln_post -> GELU(proj1) -> proj2.

Parameters are a dict: conv weights OIHW (``F.conv2d``'s layout), linear
weights (in, out) so every dense product is ``qlinear(x, w)``, and
``"layers"`` a list of per-layer dicts.  With bf16 weights no kernel of this
repository runs here under the default stem: the conv stem is
``F.conv2d``, dense products ``torch.matmul``, attention plain sdpa
(``ops/attention.py``), as the JAX package leaves them to XLA; the
``"pallas"`` stem runs kernel K11e for conv2 and conv3.  In the W8A8 prefill mode
(``act_quant="int8"``) the dense weights are int8 ``{"q", "s"}`` and the
whole forward runs under the activation-quant gate with at least 256 rows
(JAX ``encoder.py:337``, ``:368-371``), so its products run kernel K10 (K9
below 256 rows); conv kernels, biases and norms stay full precision.

Tensor parallelism (``tp``, a :class:`~..parallel.collectives.TP`; None is
one device and the code above unchanged), by the encoder's rules in
``parallel/sharding.py``: wq/wk/wv with their biases, fc1 and proj1 are
column-parallel (local heads, local FFN columns); wo, fc2 and proj2 are
row-parallel, their f32 partials summed over the group and rounded once,
and their replicated biases (bo, fc2_b, proj2_b) added once, after the
sum.  ``conv_out`` splits its output columns, so its output is gathered
before the position table is added.  Each column-parallel product's
replicated input passes through ``copy_to_tp`` (identity forward), whose
backward all-reduces its gradient, partial on each rank.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioEncoderConfig
from ..ops.attention import windowed_self_attention
from ..ops.kernels.experiments.conv_stem import conv_s2_gelu
from ..ops.norms import layer_norm
from ..ops.quant import act_quant_rows, is_quantized, qlinear, qlinear_row_parallel
from ..parallel.collectives import TP, copy_to_tp, gather_from_tp

EncoderParams = dict[str, Any]

_LN_EPS = 1e-5
#: Row gate of the encoder's W8A8 products (the JAX package's
#: ``_ACT_QUANT_ENC_MIN_ROWS``).
_ACT_QUANT_ENC_MIN_ROWS = 256

#: Per-layer parameter names (the JAX package's stacked keys).
LAYER_KEYS = (
    "ln1_w", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
    "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)


@lru_cache(maxsize=4)
def sinusoidal_positions(max_positions: int, d_model: int) -> np.ndarray:
    """Whisper-style sinusoid table, (max_positions, d_model) = [sin | cos]."""
    half = d_model // 2
    log_timescale = np.log(10_000.0) / (half - 1)
    inv_timescales = np.exp(-np.arange(half, dtype=np.float64) * log_timescale)
    scaled = np.arange(max_positions, dtype=np.float64)[:, None] * inv_timescales
    table = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return table.astype(np.float32)


@lru_cache(maxsize=None)
def _device_positions(max_positions: int, d_model: int, rows: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """The first ``rows`` rows of the sinusoid table on ``device``, copied
    once (a copy from host memory per forward would wait for the device),
    and kept: captured CUDA graphs read it."""
    table = sinusoidal_positions(max_positions, d_model)[:rows]
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def init_encoder_params(
    cfg: AudioEncoderConfig,
    generator: torch.Generator | None,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> EncoderParams:
    """Random (normal, std 0.02) or, with ``generator=None``, zero weights;
    LayerNorm weights are ones and biases zeros, as in the JAX package."""
    d, ch, ffn = cfg.d_model, cfg.downsample_hidden_size, cfg.encoder_ffn_dim

    def make(name, shape):
        if name.endswith("_b") or name.startswith("b"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if "ln" in name and name.endswith("_w"):
            return torch.ones(shape, dtype=dtype, device=device)
        if generator is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (0.02 * w).to(dtype)

    layer_shapes = {
        "ln1_w": (d,), "ln1_b": (d,),
        "wq": (d, d), "bq": (d,), "wk": (d, d), "bk": (d,),
        "wv": (d, d), "bv": (d,), "wo": (d, d), "bo": (d,),
        "ln2_w": (d,), "ln2_b": (d,),
        "fc1_w": (d, ffn), "fc1_b": (ffn,), "fc2_w": (ffn, d), "fc2_b": (d,),
    }
    top_shapes = {
        "conv1_w": (ch, 1, 3, 3), "conv1_b": (ch,),
        "conv2_w": (ch, ch, 3, 3), "conv2_b": (ch,),
        "conv3_w": (ch, ch, 3, 3), "conv3_b": (ch,),
        "conv_out": (ch * cfg.freq_after_conv, d),
        "ln_post_w": (d,), "ln_post_b": (d,),
        "proj1_w": (d, d), "proj1_b": (d,),
        "proj2_w": (d, cfg.output_dim), "proj2_b": (cfg.output_dim,),
    }
    params = {k: make(k, s) for k, s in top_shapes.items()}
    params["layers"] = [
        {k: make(k, s) for k, s in layer_shapes.items()}
        for _ in range(cfg.encoder_layers)
    ]
    return params


def valid_token_count(cfg: AudioEncoderConfig, n_valid_frames: torch.Tensor) -> torch.Tensor:
    """Audio tokens carrying real signal: full 100-frame chunks give
    ``tokens_per_chunk`` each, a trailing partial chunk its conv length."""
    chunk = cfg.chunk_frames
    full = torch.div(n_valid_frames, chunk, rounding_mode="floor")
    rem = n_valid_frames % chunk
    for _ in range(3):
        rem = torch.div(rem - 1, 2, rounding_mode="floor") + 1
    return full * cfg.tokens_per_chunk + rem


#: Conv-stem lowering, read from ``QWEN3_ASR_CONV_STEM`` at import (the JAX
#: package's modes, ``qwen3_asr_tpu/models/encoder.py:135-160``):
#:   "conv"   -- default: ``F.conv2d`` per chunk (NCHW, OIHW weights);
#:   "pallas" -- conv2/conv3 as kernel K11e (``conv_s2_gelu``, NHWC);
#:               conv1 (one input channel) keeps ``F.conv2d``.
#: The JAX package's other modes ("taps", "merged", "c512", "merged512")
#: rewrite the same function for the TPU's layouts (tap slices for the MXU,
#: guard-band merged images, channels padded to the 128-lane multiple 512);
#: they are accepted here and run the "conv" stem.  Unlike the JAX package,
#: which runs "pallas" only on a TPU and otherwise falls back to
#: ``lax.conv``, "pallas" on CUDA tensors launches K11e or raises.
CONV_STEM_MODE = os.environ.get("QWEN3_ASR_CONV_STEM", "conv")


def conv_stem(params: EncoderParams, chunks: torch.Tensor, tp: TP | None = None) -> torch.Tensor:
    """Mode-dispatched conv stem (:data:`CONV_STEM_MODE`): (B * n_chunks, 1,
    mel, chunk) -> (B * n_chunks, tokens_per_chunk, d_model); under ``tp``
    ``conv_out``'s column shards gathered."""
    if CONV_STEM_MODE == "pallas":
        x = _pallas_stem(params, chunks)
    else:
        x = chunks
        for i in (1, 2, 3):
            x = F.conv2d(x, params[f"conv{i}_w"], stride=2, padding=1)
            x = F.gelu(x + params[f"conv{i}_b"][None, :, None, None], approximate="none")
    # (N, ch, freq', time') -> channel-major flatten (N, time', ch * freq').
    n, ch, freq, time = x.shape
    x = x.permute(0, 3, 1, 2).reshape(n, time, ch * freq)
    if tp is not None:
        return gather_from_tp(qlinear(copy_to_tp(x, tp), params["conv_out"]), tp, dim=-1)
    return qlinear(x, params["conv_out"])


def _pallas_stem(params: EncoderParams, chunks: torch.Tensor) -> torch.Tensor:
    """The "pallas" stem -> (N, ch, freq', time') as an NCHW view.  conv2 and
    conv3 run channels-last: conv1's output is laid out NHWC once (asked of
    ``F.conv2d`` through channels-last operands, made contiguous only if it
    did not oblige)."""
    last = torch.channels_last
    w1 = params["conv1_w"].contiguous(memory_format=last)
    x = F.conv2d(chunks.contiguous(memory_format=last), w1, stride=2, padding=1)
    x = F.gelu(x + params["conv1_b"][None, :, None, None], approximate="none")
    x = x.permute(0, 2, 3, 1).contiguous()                  # (N, freq, time, ch)
    for i in (2, 3):
        w = params[f"conv{i}_w"].permute(2, 3, 1, 0).contiguous()   # OIHW -> HWIO
        x = conv_s2_gelu(x, w, params[f"conv{i}_b"])
    return x.permute(0, 3, 1, 2)


def encoder_forward(
    params: EncoderParams,
    cfg: AudioEncoderConfig,
    mel: torch.Tensor,
    n_valid_frames: torch.Tensor,
    tp: TP | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode (B, n_mels, T) log-mel (T a multiple of ``n_window_infer``,
    invalid frames zero) to ``(features (B, T // 100 * 13, output_dim),
    n_valid_tokens (B,))``.  Quantized layer weights run the whole forward
    under the activation-quant gate.  Under ``tp`` the parameters are this
    rank's shards and every rank gets the whole features."""
    if is_quantized(params["layers"][0]["wq"]):
        with act_quant_rows(_ACT_QUANT_ENC_MIN_ROWS):
            return _encoder_forward(params, cfg, mel, n_valid_frames, tp)
    return _encoder_forward(params, cfg, mel, n_valid_frames, tp)


def _encoder_forward(params, cfg, mel, n_valid_frames, tp=None):
    B, n_mels, T = mel.shape
    chunk = cfg.chunk_frames
    if T % cfg.n_window_infer:
        raise ValueError(
            f"mel frames {T} must be a multiple of n_window_infer={cfg.n_window_infer}"
        )
    n_chunks = T // chunk
    tpc = cfg.tokens_per_chunk
    dtype = params["ln_post_w"].dtype

    chunks = mel.reshape(B, n_mels, n_chunks, chunk).permute(0, 2, 1, 3)
    chunks = chunks.reshape(B * n_chunks, 1, n_mels, chunk).to(dtype)
    x = conv_stem(params, chunks, tp)                # (B * n_chunks, tpc, d)
    x = x + _device_positions(cfg.max_source_positions, cfg.d_model, tpc, x.device, dtype)[None]

    total = n_chunks * tpc
    h = x.reshape(B, total, cfg.d_model)
    n_tokens = valid_token_count(cfg, n_valid_frames)
    token_valid = torch.arange(total, device=mel.device)[None, :] < n_tokens[:, None]

    d = cfg.d_model
    hd = d // cfg.encoder_attention_heads
    nq = cfg.encoder_attention_heads if tp is None else tp.shard(
        cfg.encoder_attention_heads, "the encoder's heads")
    scale = hd ** -0.5

    def heads(t):
        return t.reshape(B, total, nq, hd).transpose(1, 2)

    def tp_input(t):
        """A column-parallel product's replicated input: its gradient sums
        over the tp group."""
        return t if tp is None else copy_to_tp(t, tp)

    for lp in params["layers"]:
        x = tp_input(layer_norm(h, lp["ln1_w"], lp["ln1_b"], _LN_EPS))
        q = heads(qlinear(x, lp["wq"]) + lp["bq"])
        k = heads(qlinear(x, lp["wk"]) + lp["bk"])
        v = heads(qlinear(x, lp["wv"]) + lp["bv"])
        attn = windowed_self_attention(
            q, k, v, window=cfg.window_tokens, valid_mask=token_valid, scale=scale
        )
        attn = attn.transpose(1, 2).reshape(B, total, nq * hd)
        h = h + qlinear_row_parallel(attn, lp["wo"], tp) + lp["bo"]
        x = tp_input(layer_norm(h, lp["ln2_w"], lp["ln2_b"], _LN_EPS))
        x = F.gelu(qlinear(x, lp["fc1_w"]) + lp["fc1_b"], approximate="none")
        h = h + qlinear_row_parallel(x, lp["fc2_w"], tp) + lp["fc2_b"]

    h = tp_input(layer_norm(h, params["ln_post_w"], params["ln_post_b"], _LN_EPS))
    h = F.gelu(qlinear(h, params["proj1_w"]) + params["proj1_b"], approximate="none")
    features = qlinear_row_parallel(h, params["proj2_w"], tp) + params["proj2_b"]
    zero = torch.zeros((), dtype=features.dtype, device=features.device)
    features = torch.where(token_valid[:, :, None], features, zero)
    return features, n_tokens
