"""Qwen3 text decoder (GQA + QK-norm + RoPE + SwiGLU) in PyTorch.

Counterpart of ``qwen3_asr_tpu/models/decoder.py`` for the four paths the
transcription slices run:

  * **fresh prefill** (``write_slots is None``, T > 1): attention over the
    fresh K/V with the causal flash kernel K1, and each layer's K/V rows
    written into the zero-initialized cache's first T slots (the JAX
    package builds the same cache by padding the stacked rows to S,
    ``decoder.py:816-845``); under ``attn_impl="causal"`` (training, or
    ``QWEN3_ASR_PREFILL_FLASH=0``) the plain :func:`~..ops.attention.sdpa`
    instead, differentiable, returning the stacked rows as the JAX package
    does;
  * **split decode** (``decode_ctx`` given, T == 1, ``decoder.py:534-731``):
    attention runs over the PRE-step cache plus the fresh row (kernel K2),
    and the same launch then stores the layer's fresh row at the shared
    slot, or at per-lane slots for the continuous engine's flat cache (K3
    fused into K2's fold).  Under :data:`DECODE_KERNEL_MODE` "3" or "4"
    with a shared slot, K11a or K11b attend; under "0" the plain attention
    (the JAX package's XLA form); in both cases, and under the "xla"
    :data:`KV_WRITER_MODE`, all layers' fresh rows are written by ONE
    post-loop writer call (K3, K3-int8, or the plain writer under "xla").
    Either way a layer's rows land
    after that layer's attention has read the cache, the JAX package's
    order (it writes after the layer loop because an in-loop update made
    XLA copy the whole cache, ``decoder.py:680-684``; the card has no such
    hazard);
  * **verify split** (``decode_ctx`` given, 1 < T <= 8, ``decoder.py:744-814``):
    the speculative loop's T positions per lane against the read-only
    cache plus a T x T causal block of the fresh rows, in plain PyTorch
    products (the JAX package uses XLA einsums here too), and one post-loop
    K5 launch for K and V at the per-lane write slots; each layer's
    projection writes its rows straight into the buffers K5 reads;
  * **cached forward** (``write_slots`` given, no ``decode_ctx``, T >= 1,
    ``decoder.py:455-479``, ``:847-873``): the incremental sessions'
    prefix advance.  Each layer writes its T fresh rows into the cache,
    then attends over the whole cache under ``slot <= position`` with the
    plain :func:`~..ops.attention.sdpa` (XLA's einsums in the JAX package,
    no Pallas kernel there either).

The continuous engine's paged pool (``decoder_paged_step``, JAX
``decoder.py:881-1033``, and ``decoder_paged_verify``, ``:1036-1201``) runs
the same split form through a page table: attention is kernel K6 (or K7
for the T-position verify) under every decode mode, whose launch also
stores the layer's fresh rows (K8 fused into the fold; under the "xla"
writer the plain paged writer after the layer loop).

Per layer: RMSNorm -> fused QKV -> per-head Q/K RMSNorm BEFORE RoPE
(non-interleaved, theta 1e6) -> attention -> o_proj -> RMSNorm -> SwiGLU.
Parameters are a dict: ``embedding`` (vocab, H), ``final_norm`` (H,),
``layers`` a list of per-layer dicts whose linear weights are (in, out);
``fuse_decoder_params`` concatenates Q|K|V and gate|up as the JAX package
does.  The KV cache is a pair of (L, B, Hkv, S, D) tensors updated in place
(JAX returns new arrays; here the caller's cache is the result).

Int8 (``ops/quant.py``): every linear goes through ``qlinear``, so
quantized ``{"q", "s"}`` weights run kernel K9 (or K10 inside the
activation-quant gate); a quantized embedding is stored transposed (H, V),
so the lookup gathers columns and the lm head is ``qlinear`` with f32
output.  The split decode step also takes the int8 cache ``{"q": int8,
"s": f32}`` pair: attention runs K4, whose launch also quantizes the
step's fresh bf16 rows and stores them (K3-int8 fused), under "auto", "5",
"3" and "4"; under "0" the plain attention over the layer dequantized to
the activation dtype (JAX ``:612-627``), then the standalone K3-int8.

Tensor parallelism (``tp``, a :class:`~..parallel.collectives.TP`; None is
one device and the code above unchanged): the parameters are this rank's
shards (``parallel/sharding.py``), so the head counts are local (``Hq/tp``,
``Hkv/tp``) and so is the KV cache.  wq/wk/wv/wg/wu are column-parallel and
need no collective forward; wo and wd are row-parallel, their f32 partials
summed over the group and rounded once (``ops/quant.py:qlinear_row_parallel``).
The embedding is vocab-parallel (:func:`embed_tokens`), and the tied lm
head's vocab-sharded f32 logits are gathered before the sampler
(:func:`decoder_logits`).  Every column-parallel input and the lm head's
input pass through ``copy_to_tp`` (identity forward), as do the replicated
``q_norm``/``k_norm``, which scale this rank's heads only: under autograd
their gradients, partial on each rank, are all-reduced over the group.
The kernels K1, K2, K4, K5, K6, K7, K9 and
K10 run unchanged on the local heads or columns, as the JAX package runs
its Pallas kernels per shard through ``shard_map``; the paged paths
(``decoder_paged_step``/``_verify``, the continuous engine's) reduce at
the same points as the contiguous ones.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from ..config import TextDecoderConfig
from ..ops.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_q8,
    decode_attention_q8_plain,
)
from ..ops.kernels.experiments.decode_attention_hbm2 import decode_attention_hbm2
from ..ops.kernels.experiments.decode_attention_hbm3 import decode_attention_hbm3
from ..ops.kernels.flash_attention import flash_attention_causal, flash_attention_causal_plain
from ..ops.kernels.decode_attention_paged import (
    decode_attention_paged,
    decode_attention_paged_q8,
    decode_attention_paged_verify,
    decode_attention_paged_verify_q8,
)
from ..ops.attention import sdpa
from ..ops.kernels.kv_write import (
    kv_write_rows,
    kv_write_rows_batch,
    kv_write_rows_paged_plain,
    kv_write_rows_paged_q8_plain,
    kv_write_rows_plain,
    kv_write_rows_q8,
    kv_write_span_pair,
    kv_write_span_pair_plain,
)
from ..ops.norms import rms_norm
from ..ops.quant import is_quantized, qlinear, qlinear_row_parallel
from ..ops.quant_kv import is_quantized_kv, kv_seq_len, quantize_kv
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel.collectives import TP, copy_to_tp, gather_from_tp, vocab_parallel_embed

DecoderParams = dict[str, Any]

#: Decode attention of the single-token split step, read from
#: ``QWEN3_ASR_DECODE_KERNEL`` at import (the JAX package's modes,
#: ``qwen3_asr_tpu/models/decoder.py:39-48``, dispatch :489-657): "auto" and
#: "5" run K2 (K4 on the int8 cache), each storing the step's row from the
#: same launch; with a shared write slot (an int ``write_slots``, the decode
#: modes' loop) "3" runs K11a (``decode_attention_hbm2``) and "4" K11b
#: (``decode_attention_hbm3``), both on the largest block of 1024/512/256/128
#: rows that divides the cache length and the prompt bucket (ValueError if
#: none does, where the JAX package raises StopIteration), and per-lane
#: slots (the flat engine) keep K2.  The int8 cache keeps K4 under "3"/"4"
#: too, where the JAX package dequantizes it for its XLA attention (JAX
#: ``:500-508``): the caller asked for a kernel.  "0" runs the plain
#: attention (the JAX package's XLA attention, the int8 cache dequantized
#: to the activation dtype: ``decode_attention_plain``,
#: ``decode_attention_q8_plain``) on every device.  Wherever the attention
#: stores no row, the rows land after the layer loop through the writer
#: :data:`KV_WRITER_MODE` picks.  The paged step and verify run K6/K7 under
#: every mode (JAX ``:920``, ``:1074``), the verify split its plain attention
#: and K5.  Any other value raises ValueError at the first split step
#: (the JAX package runs its XLA attention for it).
DECODE_KERNEL_MODE = os.environ.get("QWEN3_ASR_DECODE_KERNEL", "auto")
DECODE_KERNEL_MODES = ("auto", "5", "4", "3", "0")

#: The KV-cache row writers, read from ``QWEN3_ASR_KV_WRITER`` at import as
#: the JAX package reads it (``qwen3_asr_tpu/models/decoder.py:87-99``):
#: "auto" writes through the kernels (the stores fused into K2/K4/K6/K7, the
#: standalone K3 or K3-int8 where the attention stores nothing, K5 for the
#: verify split's span); "xla" calls K2/K4/K6/K7 without a write target and
#: writes every row with the plain writers on every device, in the JAX
#: package's XLA forms: a shared slot by a slice update whose start is
#: clamped into the cache (``dynamic_update_slice``), per-lane slots, spans
#: and pages by one scatter that drops rows outside the cache or page
#: (:func:`_write_rows_xla`, ``kv_write_span_pair_plain``,
#: ``kv_write_rows_paged_plain``, ``kv_write_rows_paged_q8_plain``; the int8
#: cache takes ``quantize_kv``'s rows and scales).  None of them waits for the
#: device, so the decode loops capture them in their CUDA graphs as they
#: capture the kernels (``runtime/generate.py``).  Any other value raises
#: ValueError.
KV_WRITER_MODE = os.environ.get("QWEN3_ASR_KV_WRITER", "auto")
KV_WRITER_MODES = ("auto", "xla")

#: The fresh prefill's attention under ``attn_impl="auto"``, read from
#: ``QWEN3_ASR_PREFILL_FLASH`` at import as the JAX package reads it
#: (``qwen3_asr_tpu/models/decoder.py:51-55``): on (the default), kernel K1;
#: "0" the plain causal :func:`sdpa` ("causal"), no kernel.
PREFILL_FLASH_ENABLED = os.environ.get("QWEN3_ASR_PREFILL_FLASH", "1") != "0"


def xla_writer() -> bool:
    """Whether :data:`KV_WRITER_MODE` selects the plain writers ("xla");
    ValueError for a value outside :data:`KV_WRITER_MODES`."""
    if KV_WRITER_MODE not in KV_WRITER_MODES:
        raise ValueError(f"QWEN3_ASR_KV_WRITER={KV_WRITER_MODE!r}: expected one of "
                         f"{', '.join(map(repr, KV_WRITER_MODES))}")
    return KV_WRITER_MODE == "xla"


def local_heads(cfg: TextDecoderConfig, tp: TP | None = None) -> tuple[int, int]:
    """(query heads, KV heads) of this rank: the config's, split over
    ``tp``."""
    if tp is None:
        return cfg.num_attention_heads, cfg.num_key_value_heads
    return (tp.shard(cfg.num_attention_heads, "the query heads"),
            tp.shard(cfg.num_key_value_heads, "the KV heads"))


def init_decoder_params(
    cfg: TextDecoderConfig,
    generator: torch.Generator | None,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> DecoderParams:
    """Random (normal, std 0.02) or, with ``generator=None``, zero weights;
    norm weights are ones.  Unfused layout (wq, wk, wv, wg, wu)."""
    H, D = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    inter = cfg.intermediate_size

    def make(name, shape):
        if name.startswith(("ln", "q_norm", "k_norm")) or name == "final_norm":
            return torch.ones(shape, dtype=dtype, device=device)
        if generator is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (0.02 * w).to(dtype)

    layer_shapes = {
        "ln1": (H,), "ln2": (H,),
        "wq": (H, nq * D), "wk": (H, nkv * D), "wv": (H, nkv * D),
        "wo": (nq * D, H),
        "q_norm": (D,), "k_norm": (D,),
        "wg": (H, inter), "wu": (H, inter), "wd": (inter, H),
    }
    return {
        "embedding": make("embedding", (cfg.vocab_size, H)),
        "layers": [
            {k: make(k, s) for k, s in layer_shapes.items()}
            for _ in range(cfg.num_hidden_layers)
        ],
        "final_norm": make("final_norm", (H,)),
    }


def init_kv_cache(
    cfg: TextDecoderConfig,
    batch: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
    tp: TP | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (keys, values), each (L, B, kv_heads, max_len, head_dim), the
    KV heads this rank's under ``tp``."""
    shape = (cfg.num_hidden_layers, batch, local_heads(cfg, tp)[1], max_len, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def fuse_decoder_params(params: DecoderParams) -> DecoderParams:
    """Concatenate Q|K|V and gate|up into single matmuls (pure re-layout)."""
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        lp["wqkv"] = torch.cat([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")], dim=-1)
        lp["wgu"] = torch.cat([lp.pop("wg"), lp.pop("wu")], dim=-1)
        layers.append(lp)
    return {**params, "layers": layers}


def embed_tokens(params: DecoderParams, ids: torch.Tensor, tp: TP | None = None) -> torch.Tensor:
    """Token embedding lookup, (...) -> (..., hidden).  A quantized (H, V)
    embedding gathers columns and rescales them.  Under ``tp`` the table is
    this rank's vocab shard, and the rows are summed over the group
    (:func:`~..parallel.collectives.vocab_parallel_embed`)."""
    emb = params["embedding"]
    ids = ids.long()
    if tp is not None:
        shard = (emb["s"] if is_quantized(emb) else emb).shape[0]
        return vocab_parallel_embed(ids, lambda local: embed_tokens(params, local), shard, tp)
    if is_quantized(emb):
        cols = emb["q"].t().index_select(0, ids.reshape(-1))      # (n, H)
        rows = cols.float() * emb["s"][ids.reshape(-1)][:, None]
        return rows.to(params["final_norm"].dtype).reshape(*ids.shape, -1)
    return emb[ids]


def _project_qkv(h, lp, cfg: TextDecoderConfig, cos, sin, k_out=None, v_out=None, tp=None):
    """ln1 -> fused-or-split QKV -> per-head QK RMSNorm -> RoPE at the
    angles (cos, sin) (B, 1, T, D/2).
    Returns q (B, nq, T, D), k, v (B, nkv, T, D), contiguous.  Given
    contiguous (B, nkv, T, D) ``k_out``/``v_out``, k and v are those: the
    RoPE's rounding and v's transpose copy write them there, the same ops
    with the same results, so no copy into a row buffer follows."""
    B, T, _ = h.shape
    (nq, nkv), D = local_heads(cfg, tp), cfg.head_dim
    eps = cfg.rms_norm_eps
    x = rms_norm(h, lp["ln1"], eps)
    q_norm, k_norm = lp["q_norm"], lp["k_norm"]
    if tp is not None:
        # Column-parallel input; q_norm/k_norm are replicated but scale this
        # rank's heads only, so their gradients too sum over the group.
        x, q_norm, k_norm = (copy_to_tp(t, tp) for t in (x, q_norm, k_norm))
    if "wqkv" in lp:
        q, k, v = torch.split(qlinear(x, lp["wqkv"]), [nq * D, nkv * D, nkv * D], dim=-1)
    else:
        q, k, v = qlinear(x, lp["wq"]), qlinear(x, lp["wk"]), qlinear(x, lp["wv"])
    q = rms_norm(q.reshape(B, T, nq, D), q_norm, eps).transpose(1, 2)
    k = rms_norm(k.reshape(B, T, nkv, D), k_norm, eps).transpose(1, 2)
    v = v.reshape(B, T, nkv, D).transpose(1, 2)
    v = v.contiguous() if v_out is None else v_out.copy_(v)
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin, out=k_out).contiguous()
    return q, k, v


def _mlp_block(h, lp, eps, tp=None):
    """Pre-norm SwiGLU MLP with residual (wd row-parallel under ``tp``)."""
    x = rms_norm(h, lp["ln2"], eps)
    if tp is not None:
        x = copy_to_tp(x, tp)
    if "wgu" in lp:
        gate, up = qlinear(x, lp["wgu"]).chunk(2, dim=-1)
    else:
        gate, up = qlinear(x, lp["wg"]), qlinear(x, lp["wu"])
    return h + qlinear_row_parallel(F.silu(gate) * up, lp["wd"], tp)


def decoder_forward(
    params: DecoderParams,
    cfg: TextDecoderConfig,
    hidden: torch.Tensor,
    positions: torch.Tensor,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    write_slots=None,
    decode_ctx: tuple[torch.Tensor, int, int] | None = None,
    attn_impl: str = "auto",
    tp: TP | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Run the layer stack over input embeddings ``hidden`` (B, T, H) at
    absolute RoPE ``positions`` (B, T); under ``tp`` with this rank's
    parameter shards and KV heads.

    Fresh prefill: ``write_slots`` and ``decode_ctx`` None, T > 1; rows land
    at slots [0, T).  Split decode: ``decode_ctx = (prompt_len (B,) int32,
    decode_end, prompt_bucket int)`` and T == 1; the fresh rows land at
    ``write_slots``; ``decode_end`` and ``write_slots`` are each an int
    shared by every lane (the decode loop) or a (B,) tensor (the continuous
    engine's lanes at their own depths, JAX ``engine.py:446-451``).  Verify split:
    ``decode_ctx = (prompt_len, ws, prompt_bucket)`` with ``ws`` (B,) the
    per-lane write slots (also passed as ``write_slots``) and 1 < T <= 8;
    bf16 or f32 cache only.  Cached forward: ``write_slots`` (an int shared
    by every lane, or a (B,) tensor) and no ``decode_ctx``, T >= 1; the
    rows land at ``write_slots .. write_slots + T`` and attend the cache up
    to their own positions; bf16 or f32 cache only.  Returns the
    pre-final-norm hidden (B, T, H) and the (updated in place) cache.

    ``attn_impl`` chooses the fresh prefill's attention (JAX
    ``decoder.py:351-434``): "flash" is kernel K1 with the rows written into
    ``kv_cache`` in place; "causal" is the plain :func:`sdpa` under a causal
    mask on every device, differentiable, and writes nothing in place: it
    returns the stacked per-layer rows (L, B, Hkv, T, D), padded with zeros
    to ``kv_cache``'s length and dtype when a cache is given (JAX
    ``:862-868``), for any T >= 1; "auto" is "flash" for a fresh prefill of
    T > 1 unless :data:`PREFILL_FLASH_ENABLED` is off, and leaves the other
    paths as above.  Training runs "causal": K1 is a ``ctypes`` call that
    autograd cannot see.
    """
    B, T, _ = hidden.shape
    (nq, nkv), D = local_heads(cfg, tp), cfg.head_dim
    eps = cfg.rms_norm_eps
    scale = D ** -0.5
    fresh = decode_ctx is None and write_slots is None
    if attn_impl == "auto" and fresh and T > 1:
        attn_impl = "flash" if PREFILL_FLASH_ENABLED else "causal"
    if attn_impl not in ("auto", "flash", "causal"):
        raise ValueError(f"attn_impl must be 'auto', 'flash' or 'causal', got {attn_impl!r}")
    if attn_impl != "auto" and not fresh:
        raise ValueError(f"attn_impl={attn_impl!r} is the fresh prefill's (no write_slots, "
                         "no decode_ctx)")
    cos, sin = rope_cos_sin(positions[:, None, :], D, cfg.rope_theta)
    if attn_impl == "causal":
        return _causal_prefill(params, cfg, hidden, cos, sin, kv_cache, tp)
    if kv_cache is None:
        raise ValueError("kv_cache is required except under attn_impl='causal'")
    keys, values = kv_cache
    h = hidden

    if attn_impl == "flash":
        for layer, lp in enumerate(params["layers"]):
            q, k, v = _project_qkv(h, lp, cfg, cos, sin, tp=tp)
            keys[layer, :, :, :T] = k
            values[layer, :, :, :T] = v
            attn = flash_attention_causal(q, k, v, scale=scale)
            h = h + qlinear_row_parallel(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"], tp)
            h = _mlp_block(h, lp, eps, tp)
        return h, (keys, values)

    if decode_ctx is not None and T == 1 and write_slots is not None:
        plen, dend, pbucket = decode_ctx
        device = hidden.device
        attend, dend, fused = _split_step_attention(
            is_quantized_kv(keys), isinstance(write_slots, torch.Tensor), dend, B, device,
            kv_seq_len(keys), pbucket,
        )
        if fused:
            # K2/K4 store each layer's fresh row from the attention's launch.
            slots = _per_lane(write_slots, B, device)
            for layer, lp in enumerate(params["layers"]):
                q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin, tp=tp)
                attn = attend(q[:, :, 0, :], keys, values, k_new, v_new, layer, plen, dend,
                              pbucket, scale=scale, write_slots=slots)
                h = h + qlinear_row_parallel(attn.reshape(B, 1, nq * D), lp["wo"], tp)
                h = _mlp_block(h, lp, eps, tp)
            return h, (keys, values)
        n_layers = len(params["layers"])
        k_rows = torch.empty((n_layers, B, nkv, 1, D), dtype=hidden.dtype, device=device)
        v_rows = torch.empty_like(k_rows)
        for layer, lp in enumerate(params["layers"]):
            q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin, k_rows[layer], v_rows[layer],
                                           tp)
            attn = attend(
                q[:, :, 0, :], keys, values, k_new, v_new, layer, plen, dend,
                pbucket, scale=scale,
            )
            h = h + qlinear_row_parallel(attn.reshape(B, 1, nq * D), lp["wo"], tp)
            h = _mlp_block(h, lp, eps, tp)
        for cache, rows in ((keys, k_rows), (values, v_rows)):
            _write_step_rows(cache, rows, write_slots)
        return h, (keys, values)

    if decode_ctx is not None and 1 < T <= 8 and write_slots is not None:
        if is_quantized_kv(keys):
            raise ValueError("the int8 KV cache takes single-token decode only")
        return _verify_split(params, cfg, h, cos, sin, keys, values, decode_ctx, tp)

    if decode_ctx is None and write_slots is not None:
        if is_quantized_kv(keys):
            raise ValueError("int8 KV caches support single-token decode only")
        return _cached_forward(params, cfg, h, positions, cos, sin, keys, values,
                               write_slots, tp)

    raise NotImplementedError(
        "the PyTorch port runs fresh prefill (T > 1, no write_slots), the "
        "cached forward (write_slots, no decode_ctx), single-token split "
        "decode (decode_ctx, T == 1) and the verify split (decode_ctx, "
        "1 < T <= 8) only"
    )


def _causal_prefill(params, cfg: TextDecoderConfig, h, cos, sin, kv_cache, tp=None):
    """The fresh prefill under ``attn_impl="causal"`` (JAX
    ``decoder.py:816-845``): each layer attends over its own fresh K/V with
    :func:`sdpa` under a causal mask (K1's plain version, on every device),
    so autograd sees the whole forward.  Returns (hidden, (keys, values)): the
    layers' rows stacked (L, B, Hkv, T, D), or with ``kv_cache`` padded to
    its length S in its dtype (a new pair; the given cache is not
    written)."""
    B, T, _ = h.shape
    nq, D = local_heads(cfg, tp)[0], cfg.head_dim
    ks, vs = [], []
    for lp in params["layers"]:
        q, k, v = _project_qkv(h, lp, cfg, cos, sin, tp=tp)
        attn = flash_attention_causal_plain(q, k, v, scale=D ** -0.5)
        h = h + qlinear_row_parallel(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"], tp)
        h = _mlp_block(h, lp, cfg.rms_norm_eps, tp)
        ks.append(k)
        vs.append(v)
    k_stack, v_stack = torch.stack(ks), torch.stack(vs)
    if kv_cache is None:
        return h, (k_stack, v_stack)
    keys, values = kv_cache
    if is_quantized_kv(keys):
        raise ValueError("int8 KV caches support single-token decode only")
    pad = (0, 0, 0, keys.shape[3] - T)
    return h, (F.pad(k_stack.to(keys.dtype), pad), F.pad(v_stack.to(values.dtype), pad))


def _cached_forward(params, cfg: TextDecoderConfig, h, positions, cos, sin, keys, values,
                    write_slots, tp=None):
    """The general cached forward (JAX ``decoder.py:455-479``, ``:847-873``):
    T >= 1 fresh positions per lane appended to an existing cache, as the
    incremental sessions advance their decoder prefix.  Per layer the T
    fresh K/V rows are written first, then the queries attend over the
    layer's whole cache under ``slot <= position``, so each row sees
    itself.  An int ``write_slots`` writes every lane at the same slots by
    one slice copy, its start clamped so the T rows fit (the JAX package's
    ``dynamic_update_slice``); a (B,) tensor writes each lane at its own
    slots, and rows outside [0, S) are dropped (its ``mode="drop"``
    scatter).  The attention is :func:`sdpa` in plain PyTorch on every
    device: the JAX package runs it on XLA, not in a Pallas kernel."""
    B, T, _ = h.shape
    nq, D = local_heads(cfg, tp)[0], cfg.head_dim
    S = keys.shape[3]
    device = h.device
    mask = torch.arange(S, device=device)[None, None, None, :] <= positions[:, None, :, None]
    if isinstance(write_slots, torch.Tensor):
        rows = write_slots.to(device=device, dtype=torch.long).reshape(B, 1) + torch.arange(
            T, device=device)[None, :]                            # (B, T)
        lane, t = ((rows >= 0) & (rows < S)).nonzero(as_tuple=True)
        slot = rows[lane, t]
    else:
        start = min(max(int(write_slots), 0), S - T)
    for layer, lp in enumerate(params["layers"]):
        q, k, v = _project_qkv(h, lp, cfg, cos, sin, tp=tp)
        if isinstance(write_slots, torch.Tensor):
            keys[layer, lane, :, slot] = k[lane, :, t].to(keys.dtype)
            values[layer, lane, :, slot] = v[lane, :, t].to(values.dtype)
        else:
            keys[layer, :, :, start : start + T] = k
            values[layer, :, :, start : start + T] = v
        attn = sdpa(q, keys[layer], values[layer], mask=mask, scale=D ** -0.5)
        h = h + qlinear_row_parallel(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"], tp)
        h = _mlp_block(h, lp, cfg.rms_norm_eps, tp)
    return h, (keys, values)


def _split_step_attention(q8: bool, per_lane: bool, dend, B: int, device, S: int,
                          pbucket: int):
    """(attention, decode end, fused) of the split step under
    :data:`DECODE_KERNEL_MODE`: the plain attention under "0" (a (B,)
    decode end); otherwise K4 on the int8 cache, K2 for per-lane slots and
    under "auto"/"5" (both with a (B,)
    decode end, and ``fused`` unless :data:`KV_WRITER_MODE` is "xla": the
    call takes ``write_slots`` and stores the fresh row), K11a under "3" and
    K11b under "4" (an int decode end; not fused), each with ``block_k`` the
    largest of 1024/512/256/128 that divides S and the prompt bucket (JAX
    ``decoder.py:601-610``).  An unknown mode raises ValueError."""
    mode = DECODE_KERNEL_MODE
    if mode not in DECODE_KERNEL_MODES:
        raise ValueError(f"QWEN3_ASR_DECODE_KERNEL={mode!r}: expected one of "
                         f"{', '.join(map(repr, DECODE_KERNEL_MODES))}")
    store = not xla_writer()
    if mode == "0":
        plain = decode_attention_q8_plain if q8 else decode_attention_plain
        return plain, _per_lane(dend, B, device), False
    if q8:
        return decode_attention_q8, _per_lane(dend, B, device), store
    if per_lane or mode in ("auto", "5"):
        return decode_attention, _per_lane(dend, B, device), store
    block_k = next((bk for bk in (1024, 512, 256, 128)
                    if S % bk == 0 and pbucket % bk == 0), None)
    if block_k is None:
        raise ValueError(
            f"decode mode {mode!r}: no block size of 1024/512/256/128 divides "
            f"both the cache length S={S} and the prompt bucket {pbucket}"
        )
    kernel = decode_attention_hbm2 if mode == "3" else decode_attention_hbm3
    return partial(kernel, block_k=block_k), int(dend), False


def _write_step_rows(cache, rows: torch.Tensor, write_slots) -> None:
    """The split step's rows (L, B, Hkv, 1, D) at ``write_slots`` after the
    layer loop, where the attention stored none: the standalone K3 (K3-int8
    on the int8 cache ``{"q", "s"}``), or under the "xla" writer the JAX
    package's XLA writer (:func:`_write_rows_xla`)."""
    if xla_writer():
        _write_rows_xla(cache, rows, write_slots)
        return
    B = rows.shape[1]
    if is_quantized_kv(cache):
        kv_write_rows_q8(cache, rows, _per_lane(write_slots, B, rows.device))
    elif isinstance(write_slots, torch.Tensor):
        kv_write_rows_batch(cache, rows, _per_lane(write_slots, B, rows.device))
    else:
        kv_write_rows(cache, rows, int(write_slots))


def _write_rows_xla(cache, rows: torch.Tensor, write_slots) -> None:
    """The JAX package's XLA row writer (``decoder.py:698-726``), in place:
    a slot shared by every lane (an int, or any slot at B == 1) by a slice
    update whose start, a negative one counted from the end, is clamped into
    [0, S - 1] (``dynamic_update_slice``),
    per-lane slots by a scatter that drops rows outside [0, S); the int8
    cache takes ``quantize_kv``'s rows and scales the same way."""
    if is_quantized_kv(cache):
        qr = quantize_kv(rows)
        pairs = ((cache["q"], qr["q"]), (cache["s"][..., None], qr["s"][..., None]))
    else:
        pairs = ((cache, rows),)
    for dst, src in pairs:
        B, S = dst.shape[1], dst.shape[3]
        src = src.to(dst.dtype)
        if not isinstance(write_slots, torch.Tensor):
            start = int(write_slots)
            start = min(max(start + S if start < 0 else start, 0), S - 1)
            dst[:, :, :, start : start + 1] = src
        elif B == 1:
            slot = write_slots.to(device=dst.device, dtype=torch.long).reshape(1)
            slot = torch.where(slot < 0, slot + S, slot).clamp(0, S - 1)
            dst.index_copy_(3, slot, src)
        else:
            kv_write_rows_plain(dst, src, _per_lane(write_slots, B, dst.device))


def _per_lane(x, B: int, device) -> torch.Tensor:
    """An int shared by every lane, or a (B,) tensor, as int32 (B,) on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(B).contiguous()
    return torch.full((B,), int(x), dtype=torch.int32, device=device)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with a float32 result accumulated in float32, as the
    JAX einsums' ``preferred_element_type=float32``: bf16 operands on the
    GPU keep the f32 accumulator (``out_dtype``) instead of rounding it."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _verify_split(params, cfg: TextDecoderConfig, h, cos, sin, keys, values, decode_ctx,
                  tp=None):
    """The speculative verify pass (JAX ``decoder.py:744-814``): T fresh
    positions per lane against the read-only cache, one forward.

    Old-cache slots are valid in ``[0, plen) ∪ [pbucket, ws)``, strictly
    before each lane's write slot ``ws`` (B,); the T fresh positions attend
    each other through a T x T causal block; masked scores take the finite
    ``f32.min / 2``.  Scores and P·V accumulate in f32; the cache-side
    probabilities are rounded to the cache dtype before their product, as
    the JAX package does.  Each layer's projection writes its T rows
    straight into the row buffers, and all layers' rows land after the loop
    by one K5 launch for K and V at slots ``ws .. ws + T - 1``."""
    plen, ws, pbucket = decode_ctx
    B, T, _ = h.shape
    (nq, nkv), D = local_heads(cfg, tp), cfg.head_dim
    G = nq // nkv
    S = keys.shape[3]
    scale = D ** -0.5
    device = h.device
    neg = torch.finfo(torch.float32).min / 2
    ws = ws.to(device=device, dtype=torch.int32)
    slot_ids = torch.arange(S, device=device)[None, :]
    cache_ok = (slot_ids < plen.long()[:, None]) | (
        (slot_ids >= pbucket) & (slot_ids < ws.long()[:, None])
    )                                                         # (B, S)
    cache_ok = cache_ok[:, None, None, :]                     # (B, 1, 1, S)
    t_idx = torch.arange(T, device=device)
    self_ok = (t_idx[None, :] <= t_idx[:, None]).repeat(G, 1)  # (G*T, T)

    n_layers = len(params["layers"])
    k_rows = torch.empty((n_layers, B, nkv, T, D), dtype=h.dtype, device=device)
    v_rows = torch.empty_like(k_rows)
    for layer, lp in enumerate(params["layers"]):
        q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin, k_rows[layer], v_rows[layer], tp)
        # Query rows (g, t) of each KV head: (B*nkv, G*T, D).
        qg = q.reshape(B * nkv, G * T, D)
        kc = keys[layer].reshape(B * nkv, S, D)
        vc = values[layer].reshape(B * nkv, S, D)
        scores = _bmm_f32(qg, kc.transpose(1, 2)).reshape(B, nkv, G * T, S) * scale
        scores = torch.where(cache_ok, scores, neg)
        kn = k_new.reshape(B * nkv, T, D)
        self_scores = _bmm_f32(qg, kn.transpose(1, 2)).reshape(B, nkv, G * T, T) * scale
        self_scores = torch.where(self_ok, self_scores, neg)
        w = torch.softmax(torch.cat([scores, self_scores], dim=-1), dim=-1)
        w_cache = w[..., :S].reshape(B * nkv, G * T, S).to(vc.dtype)
        w_self = w[..., S:].reshape(B * nkv, G * T, T)
        out = _bmm_f32(w_cache, vc) + torch.bmm(w_self, v_new.reshape(B * nkv, T, D).float())
        attn = out.reshape(B, nq, T, D).to(h.dtype)
        h = h + qlinear_row_parallel(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"], tp)
        h = _mlp_block(h, lp, cfg.rms_norm_eps, tp)
    writer = kv_write_span_pair_plain if xla_writer() else kv_write_span_pair
    writer(keys, values, k_rows, v_rows, ws)
    return h, (keys, values)


def decoder_paged_step(
    params: DecoderParams,
    cfg: TextDecoderConfig,
    hidden: torch.Tensor,          # (B, 1, H) current-token embeddings
    positions: torch.Tensor,       # (B, 1) absolute RoPE positions
    kv_pages,                      # (keys, values) pools (L, n_pages, Hkv, PS, D)
    page_table: torch.Tensor,      # (B, max_pages) int32 physical pages
    prompt_len: torch.Tensor,      # (B,) valid prompt rows
    decode_count: torch.Tensor,    # (B,) generated rows already in the pool
    write_pages: torch.Tensor,     # (B,) physical page of this step's row
    write_offsets: torch.Tensor,   # (B,) row offset inside that page
    tp: TP | None = None,
):
    """One decode step over the paged pool (JAX ``decoder.py:881-1033``):
    attention over the pre-step pages with the fresh token's self-term (K6,
    or its int8 form on the ``{"q", "s"}`` pool), whose launch then stores
    the layer's row (K8 fused).  The pools are updated in place; under
    ``tp`` they hold this rank's KV heads.  Returns (pre-final-norm hidden
    (B, 1, H), pools)."""
    return _paged_forward(
        params, cfg, hidden, positions, kv_pages, page_table, prompt_len,
        decode_count, write_pages[:, None], write_offsets[:, None], tp,
    )


def decoder_paged_verify(
    params: DecoderParams,
    cfg: TextDecoderConfig,
    hidden: torch.Tensor,          # (B, T, H) current token + gamma drafts
    positions: torch.Tensor,       # (B, T)
    kv_pages,
    page_table: torch.Tensor,
    prompt_len: torch.Tensor,
    decode_count: torch.Tensor,    # (B,) rows in the pool, excluding the T fresh
    write_pages: torch.Tensor,     # (B, T) physical page per fresh row
    write_offsets: torch.Tensor,   # (B, T)
    tp: TP | None = None,
):
    """The speculative verify forward over the paged pool (JAX
    ``decoder.py:1036-1201``): T positions per lane in one forward, history
    through K7 (every position reads each page once), the fresh rows
    causally inside the kernel; the same launch then stores the layer's T
    rows (K8 fused; the JAX package calls its writer T times after the
    layer loop).  Returns (hidden (B, T, H), pools)."""
    return _paged_forward(
        params, cfg, hidden, positions, kv_pages, page_table, prompt_len,
        decode_count, write_pages, write_offsets, tp,
    )


def _paged_forward(params, cfg: TextDecoderConfig, h, positions, kv_pages, page_table,
                   prompt_len, decode_count, write_pages, write_offsets, tp=None):
    """Shared body of :func:`decoder_paged_step` (T = 1) and
    :func:`decoder_paged_verify`; under ``tp`` on this rank's heads, wo and
    wd row-parallel as in :func:`decoder_forward`.  K6/K7 attend under every
    decode mode (JAX ``decoder.py:920``, ``:1074``); under the "xla" writer
    they store nothing and the plain paged writers land the rows after the
    layer loop (JAX ``:1008-1027``, ``:1168-1196``)."""
    keys, values = kv_pages
    B, T, _ = h.shape
    nq, D = local_heads(cfg, tp)[0], cfg.head_dim
    device = h.device
    q8 = is_quantized_kv(keys)
    if T == 1:
        attend = decode_attention_paged_q8 if q8 else decode_attention_paged
    else:
        attend = decode_attention_paged_verify_q8 if q8 else decode_attention_paged_verify
    table = page_table.to(device=device, dtype=torch.int32).contiguous()
    plen = _per_lane(prompt_len, B, device)
    dcount = _per_lane(decode_count, B, device)
    pages = write_pages.to(device=device, dtype=torch.int32).contiguous()
    offsets = write_offsets.to(device=device, dtype=torch.int32).contiguous()
    xla = xla_writer()
    # Under the "xla" writer the attention stores nothing: each layer's
    # projection writes its rows here, and the plain writer lands them all
    # after the layer loop, as the JAX package writes its pools.
    target = {} if xla else dict(write_pages=pages, write_offsets=offsets)
    k_rows = v_rows = None
    if xla:
        k_rows = torch.empty((len(params["layers"]), B, local_heads(cfg, tp)[1], T, D),
                             dtype=h.dtype, device=device)
        v_rows = torch.empty_like(k_rows)
    cos, sin = rope_cos_sin(positions[:, None, :], D, cfg.rope_theta)
    for layer, lp in enumerate(params["layers"]):
        rows = (None, None) if k_rows is None else (k_rows[layer], v_rows[layer])
        q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin, *rows, tp=tp)
        if T == 1:
            attn = attend(q[:, :, 0], keys, values, k_new, v_new, layer, table,
                          plen, dcount, scale=D ** -0.5, **target)[:, :, None]
        else:
            attn = attend(q, keys, values, k_new, v_new, layer, table, plen,
                          dcount, scale=D ** -0.5, **target)
        h = h + qlinear_row_parallel(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"], tp)
        h = _mlp_block(h, lp, cfg.rms_norm_eps, tp)
    if xla:
        writer = kv_write_rows_paged_q8_plain if q8 else kv_write_rows_paged_plain
        writer(keys, k_rows, pages, offsets)
        writer(values, v_rows, pages, offsets)
    return h, (keys, values)


def decoder_logits(params: DecoderParams, cfg: TextDecoderConfig, hidden: torch.Tensor,
                   tp: TP | None = None) -> torch.Tensor:
    """Final RMSNorm + tied lm_head -> float32 logits (B, T, vocab).  Under
    ``tp`` each rank's vocab shard gives (B, T, vocab / tp), gathered over
    the group in rank order, so every rank holds the same whole rows.

    The logits are the f32 accumulator, as in the JAX package
    (``preferred_element_type=float32``): bf16 weights on the GPU go
    through ``torch.mm(..., out_dtype=float32)``, so two logits closer than
    a bf16 ulp keep their order; a quantized (H, V) embedding is K9 with
    f32 output; float32 weights (and the CPU) take the plain product.
    ``torch.mm``'s ``out_dtype`` form has no derivative, so a call that
    autograd records (training) multiplies the same bf16 operands as f32
    tensors instead: the same products, exact in f32, summed in f32."""
    h = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    if tp is not None:
        return gather_from_tp(_lm_head(params, copy_to_tp(h, tp)), tp, dim=-1)
    return _lm_head(params, h)


def _lm_head(params: DecoderParams, h: torch.Tensor) -> torch.Tensor:
    """The tied lm head on the final-normed ``h``: f32 logits over the
    embedding's rows (this rank's vocab shard under tp)."""
    emb = params["embedding"]
    if is_quantized(emb):
        return qlinear(h, emb, out_dtype=torch.float32)
    if h.is_cuda and emb.dtype == torch.bfloat16:
        h2 = h.reshape(-1, h.shape[-1])
        if torch.is_grad_enabled() and (h2.requires_grad or emb.requires_grad):
            logits = h2.float() @ emb.float().T
        else:
            logits = torch.mm(h2, emb.T, out_dtype=torch.float32)
        return logits.reshape(*h.shape[:-1], emb.shape[0])
    return (h @ emb.T).float()
