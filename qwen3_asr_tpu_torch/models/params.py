"""Parameter conversion, checkpoint loading and seeded random init.

Counterpart of ``qwen3_asr_tpu/models/params.py``.  The port's parameters
differ from the JAX package's pytrees in two ways only: per-layer tensors
are a list of dicts instead of a leading (num_layers, ...) stack, and conv
kernels are OIHW (``F.conv2d``) instead of HWIO.  Linear weights stay
(in, out), and the fused ``wqkv``/``wgu`` layout is the same.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.quant import k_major
from .decoder import init_decoder_params
from .encoder import init_encoder_params


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    arr = np.array(x)       # a writable copy (JAX exports read-only views)
    if arr.dtype.name == "bfloat16":      # ml_dtypes, as JAX exports bf16
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def _is_quantized(x) -> bool:
    return isinstance(x, Mapping) and set(x) == {"q", "s"}


def _leaf(x, dtype, device):
    """A tensor, or a quantized ``{"q", "s"}`` weight whose int8 values and
    f32 scales keep their dtypes."""
    if _is_quantized(x):
        return {"q": k_major(_tensor(x["q"], None, device)), "s": _tensor(x["s"], None, device)}
    return _tensor(x, dtype, device)


def _unstack(stacked: Mapping, dtype, device) -> list[dict]:
    first = next(iter(stacked.values()))
    n = len(first["q"] if _is_quantized(first) else first)

    def layer(v, i):
        return {k: a[i] for k, a in v.items()} if _is_quantized(v) else v[i]

    return [
        {k: _leaf(layer(v, i), dtype, device) for k, v in stacked.items()}
        for i in range(n)
    ]


def params_from_jax(enc: Mapping, dec: Mapping, dtype=None, device=None):
    """The JAX package's (encoder, decoder) pytrees, as nested dicts of
    numpy arrays, -> the port's parameters computing the same function.

    Handles layer stacks (L, ...), HWIO conv kernels (-> OIHW), either the
    split (wq/wk/wv, wg/wu) or the fused (wqkv, wgu) decoder layout, and
    int8 ``{"q", "s"}`` weights (a stacked (L, in, out) int8 with (L, out)
    scales becomes one ``{"q", "s"}`` per layer; the transposed (H, V)
    quantized embedding and quantized top-level encoder linears carry over
    with their values; every ``q`` is stored K-major, as
    ``ops/quant.py:k_major``).  ``dtype`` None keeps each array's own dtype; quantized
    weights always keep theirs.
    """
    enc_t: dict = {}
    for k, v in enc.items():
        if k == "layers":
            enc_t[k] = _unstack(v, dtype, device)
        elif k.startswith("conv") and k.endswith("_w"):
            enc_t[k] = _tensor(np.transpose(np.asarray(v), (3, 2, 0, 1)), dtype, device)
        else:
            enc_t[k] = _leaf(v, dtype, device)
    dec_t = {
        "embedding": _leaf(dec["embedding"], dtype, device),
        "final_norm": _tensor(dec["final_norm"], dtype, device),
        "layers": _unstack(dec["layers"], dtype, device),
    }
    return enc_t, dec_t


def _conv_oihw(w: torch.Tensor) -> torch.Tensor:
    """MLX (O, KH, KW, I) or torch (O, I, KH, KW) -> (O, I, KH, KW)."""
    if w.shape[1] == 3 and w.shape[2] == 3:          # MLX
        return w.permute(0, 3, 1, 2).contiguous()
    if w.shape[2] == 3 and w.shape[3] == 3:          # torch
        return w
    raise ValueError(f"unrecognized conv weight shape {tuple(w.shape)}")


def _linear(w: torch.Tensor) -> torch.Tensor:
    """(out, in) -> (in, out)."""
    return w.t().contiguous()


def params_from_tensors(raw: Mapping[str, torch.Tensor], cfg: ModelConfig, dtype, device):
    """Map a checkpoint's ``audio_tower.*`` / ``model.*`` tensors to the
    port's (encoder, decoder) parameters (names and transposes as in
    ``qwen3_asr_tpu/models/params.py``)."""
    def conv(t):
        return t.to(device=device, dtype=dtype)

    def a(key, transform=None):
        t = raw[f"audio_tower.{key}"]
        return conv(transform(t) if transform else t)

    def m(key, transform=None):
        t = raw[f"model.{key}"]
        return conv(transform(t) if transform else t)

    enc_layer_map = {
        "ln1_w": ("self_attn_layer_norm.weight", None),
        "ln1_b": ("self_attn_layer_norm.bias", None),
        "wq": ("self_attn.q_proj.weight", _linear),
        "bq": ("self_attn.q_proj.bias", None),
        "wk": ("self_attn.k_proj.weight", _linear),
        "bk": ("self_attn.k_proj.bias", None),
        "wv": ("self_attn.v_proj.weight", _linear),
        "bv": ("self_attn.v_proj.bias", None),
        "wo": ("self_attn.out_proj.weight", _linear),
        "bo": ("self_attn.out_proj.bias", None),
        "ln2_w": ("final_layer_norm.weight", None),
        "ln2_b": ("final_layer_norm.bias", None),
        "fc1_w": ("fc1.weight", _linear),
        "fc1_b": ("fc1.bias", None),
        "fc2_w": ("fc2.weight", _linear),
        "fc2_b": ("fc2.bias", None),
    }
    enc = {
        "conv1_w": a("conv2d1.weight", _conv_oihw),
        "conv1_b": a("conv2d1.bias"),
        "conv2_w": a("conv2d2.weight", _conv_oihw),
        "conv2_b": a("conv2d2.bias"),
        "conv3_w": a("conv2d3.weight", _conv_oihw),
        "conv3_b": a("conv2d3.bias"),
        "conv_out": a("conv_out.weight", _linear),
        "layers": [
            {k: a(f"layers.{i}.{name}", tf) for k, (name, tf) in enc_layer_map.items()}
            for i in range(cfg.audio_encoder.encoder_layers)
        ],
        "ln_post_w": a("ln_post.weight"),
        "ln_post_b": a("ln_post.bias"),
        "proj1_w": a("proj1.weight", _linear),
        "proj1_b": a("proj1.bias"),
        "proj2_w": a("proj2.weight", _linear),
        "proj2_b": a("proj2.bias"),
    }
    dec_layer_map = {
        "ln1": ("input_layernorm.weight", None),
        "ln2": ("post_attention_layernorm.weight", None),
        "wq": ("self_attn.q_proj.weight", _linear),
        "wk": ("self_attn.k_proj.weight", _linear),
        "wv": ("self_attn.v_proj.weight", _linear),
        "wo": ("self_attn.o_proj.weight", _linear),
        "q_norm": ("self_attn.q_norm.weight", None),
        "k_norm": ("self_attn.k_norm.weight", None),
        "wg": ("mlp.gate_proj.weight", _linear),
        "wu": ("mlp.up_proj.weight", _linear),
        "wd": ("mlp.down_proj.weight", _linear),
    }
    dec = {
        "embedding": m("embed_tokens.weight"),
        "layers": [
            {k: m(f"layers.{i}.{name}", tf) for k, (name, tf) in dec_layer_map.items()}
            for i in range(cfg.text_decoder.num_hidden_layers)
        ],
        "final_norm": m("norm.weight"),
    }
    return enc, dec


def load_checkpoint(
    model_path: str | Path,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
):
    """(encoder, decoder) parameters from ``<model_path>/model.safetensors``."""
    from safetensors.torch import load_file

    weights = Path(model_path) / "model.safetensors"
    if not weights.is_file():
        raise FileNotFoundError(f"missing {weights}")
    return params_from_tensors(load_file(str(weights)), cfg, dtype, device)


def random_params(
    cfg: ModelConfig,
    seed: int | None = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
):
    """Seeded random (encoder, decoder) parameters made on ``device``;
    ``seed=None`` gives zero weights.  The draws come from a
    ``torch.Generator`` and so differ from the JAX package's for one seed."""
    generator = None
    if seed is not None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    enc = init_encoder_params(cfg.audio_encoder, generator, dtype, device)
    dec = init_decoder_params(cfg.text_decoder, generator, dtype, device)
    return enc, dec
