"""Sharding rules: parameter trees -> placements on the (dp, tp) mesh, and
each rank's local slices.

Counterpart of ``qwen3_asr_tpu/parallel/sharding.py``, with the same two
rule tables (keyed by the same paths) and the same int8 rule
(:func:`_quant_specs`):

  * column-parallel (the OUTPUT feature dim split over ``tp``): wq/wk/wv,
    SwiGLU gate/up, encoder fc1/proj1 and their biases, the conv stem's
    output linear ``conv_out``;
  * row-parallel (the INPUT feature dim split over ``tp``): wo, SwiGLU
    down, encoder fc2/proj2; the model all-reduces their partial sums
    (``collectives.reduce_from_tp``) and adds their replicated biases once,
    after the all-reduce;
  * the embedding splits over the vocab: the tied lm head then computes
    vocab-sharded logits, which are gathered before the sampler;
  * KV caches split over the KV heads (and the batch over ``dp``), so
    decode attention is local to each rank;
  * norms, the remaining biases and the conv kernels are replicated.

A rule is a ``PartitionSpec``-like tuple of axis names or None per dim of
the JAX package's leaf, whose layer leaves are stacked (L, ...); the port
keeps a list of per-layer dicts, so a layer leaf's placement drops the
leading layer axis.  A placement is a pair ``(dp placement, tp placement)``
of ``torch.distributed.tensor`` ``Shard(d)`` / ``Replicate()``, one per mesh
axis as a ``DTensor`` takes it.  :func:`shard_params` returns this rank's
local slices as contiguous tensors (an int8 ``q`` K-major, as the kernels
read it), not views.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor.placement_types import Replicate, Shard

from .mesh import Mesh

_DECODER_RULES: dict[str, tuple] = {
    "embedding": ("tp", None),
    "final_norm": (None,),
    "layers/ln1": (None, None),
    "layers/ln2": (None, None),
    "layers/q_norm": (None, None),
    "layers/k_norm": (None, None),
    "layers/wq": (None, None, "tp"),
    "layers/wk": (None, None, "tp"),
    "layers/wv": (None, None, "tp"),
    "layers/wo": (None, "tp", None),
    "layers/wg": (None, None, "tp"),
    "layers/wu": (None, None, "tp"),
    "layers/wd": (None, "tp", None),
}

_ENCODER_RULES: dict[str, tuple] = {
    "conv_out": (None, "tp"),
    "proj1_w": (None, "tp"),
    "proj1_b": ("tp",),
    "proj2_w": ("tp", None),
    "proj2_b": (None,),
    "layers/wq": (None, None, "tp"),
    "layers/bq": (None, "tp"),
    "layers/wk": (None, None, "tp"),
    "layers/bk": (None, "tp"),
    "layers/wv": (None, None, "tp"),
    "layers/bv": (None, "tp"),
    "layers/wo": (None, "tp", None),
    "layers/bo": (None, None),
    "layers/fc1_w": (None, None, "tp"),
    "layers/fc1_b": (None, "tp"),
    "layers/fc2_w": (None, "tp", None),
    "layers/fc2_b": (None, None),
}


def _quant_specs(path: str, spec: tuple) -> dict[str, tuple]:
    """Specs for an int8 ``{"q", "s"}`` leaf pair (``ops/quant.py`` layout),
    from ``spec``, the rule of the ORIGINAL bf16 weight: ``q`` keeps the
    weight's (L, in, out) spec and the per-out-channel scales ``s`` (L, out)
    take (spec[0], spec[2]); a top-level (in, out) linear's ``s`` follows
    its output axis; the quantized embedding is stored TRANSPOSED ((H, V),
    ``quantize_decoder_params``), so its vocab split moves to the last
    axis and ``s`` (V,) splits over the vocab."""
    if path == "embedding":
        return {"q": (spec[1], spec[0]), "s": (spec[0],)}
    if len(spec) == 2:
        return {"q": spec, "s": (spec[1],)}
    return {"q": spec, "s": (spec[0], spec[2])}


def _placements(spec: tuple) -> tuple:
    """(dp, tp) placements of one leaf from its spec."""
    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return tuple(Shard(dims[axis]) if axis in dims else Replicate() for axis in ("dp", "tp"))


def _layer(spec: tuple) -> tuple:
    """A stacked layer leaf's spec without its layer axis."""
    return spec[1:]


def _tree_placements(params: Any, rules: dict[str, tuple]):
    def walk(tree, path: str, in_layer: bool):
        if isinstance(tree, list):
            return [walk(v, path, True) for v in tree]
        if isinstance(tree, dict):
            if set(tree) == {"q", "s"} and not isinstance(tree["q"], dict):
                spec = rules.get(path)
                if spec is None:
                    return {k: (Replicate(), Replicate()) for k in tree}
                qs = _quant_specs(path, spec)
                return {k: _placements(_layer(qs[k]) if in_layer else qs[k]) for k in qs}
            return {k: walk(v, f"{path}/{k}" if path else k, in_layer) for k, v in tree.items()}
        spec = rules.get(path)
        if spec is None:
            return (Replicate(), Replicate())
        return _placements(_layer(spec) if in_layer else spec)

    return walk(params, "", False)


def decoder_param_sharding(params: Any, mesh: Mesh | None = None):
    """Placements of a decoder tree (bf16 or int8, split layout)."""
    return _tree_placements(params, _DECODER_RULES)


def encoder_param_sharding(params: Any, mesh: Mesh | None = None):
    """Placements of an encoder tree (bf16 or int8)."""
    return _tree_placements(params, _ENCODER_RULES)


def kv_cache_sharding(mesh: Mesh | None = None) -> tuple:
    """(L, B, kv_heads, S, D): the batch over dp, the heads over tp."""
    return (Shard(1), Shard(2))


def replicated(mesh: Mesh | None = None) -> tuple:
    return (Replicate(), Replicate())


def _local(t: torch.Tensor, placements: tuple, mesh: Mesh, int8_q: bool) -> torch.Tensor:
    for axis, p in zip(("dp", "tp"), placements):
        if isinstance(p, Shard):
            n = mesh.shape[axis]
            if t.shape[p.dim] % n:
                raise ValueError(f"{axis}={n} does not divide dim {p.dim} of a "
                                 f"{tuple(t.shape)} leaf")
            t = t.chunk(n, dim=p.dim)[mesh.coordinate[axis]]
    if int8_q:                              # K-major: the transpose of a contiguous (N, K)
        return t.t().clone(memory_format=torch.contiguous_format).t()
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, shardings: Any, mesh: Mesh):
    """This rank's local slices of a parameter tree under the matching
    placement tree (:func:`decoder_param_sharding`, ...): contiguous copies
    (a replicated leaf is the tensor itself), an int8 ``q`` stored
    K-major."""
    def walk(tree, placements, int8_q=False):
        if isinstance(tree, list):
            return [walk(v, p) for v, p in zip(tree, placements)]
        if isinstance(tree, dict):
            quantized = set(tree) == {"q", "s"} and not isinstance(tree["q"], dict)
            return {k: walk(v, placements[k], quantized and k == "q") for k, v in tree.items()}
        if all(isinstance(p, Replicate) for p in placements):
            return tree
        return _local(tree, placements, mesh, int8_q)

    return walk(params, shardings)


def check_tp(config, tp: int) -> None:
    """ValueError unless ``tp`` divides every width the rules split: the
    decoder's query and KV heads, FFN width and vocabulary, and the
    encoder's heads, FFN width, width (proj1, conv_out) and output width."""
    dec, enc = config.text_decoder, config.audio_encoder
    widths = {
        "the decoder's query heads": dec.num_attention_heads,
        "the decoder's KV heads": dec.num_key_value_heads,
        "the decoder's FFN width": dec.intermediate_size,
        "the vocabulary": dec.vocab_size,
        "the encoder's heads": enc.encoder_attention_heads,
        "the encoder's FFN width": enc.encoder_ffn_dim,
        "the encoder's width": enc.d_model,
    }
    for what, n in widths.items():
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {what} ({n})")
