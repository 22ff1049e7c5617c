"""Qwen3 text decoder (GQA + QK-norm + RoPE + SwiGLU) in PyTorch.

Counterpart of ``qwen3_asr_tpu/models/decoder.py`` for the three paths the
transcription slices run:

  * **fresh prefill** (``write_slots is None``, T > 1): attention over the
    fresh K/V with the causal flash kernel K1, and each layer's K/V rows
    written into the zero-initialized cache's first T slots (the JAX
    package builds the same cache by padding the stacked rows to S,
    ``decoder.py:816-845``);
  * **split decode** (``decode_ctx`` given, T == 1, ``decoder.py:534-731``):
    attention runs over the PRE-step cache plus the fresh row (kernel K2;
    K11a or K11b under :data:`DECODE_KERNEL_MODE` "3" or "4" with a shared
    slot), and all layers' fresh rows are written by ONE post-loop K3 call at the
    shared slot, or at per-lane slots for the continuous engine's flat
    cache;
  * **verify split** (``decode_ctx`` given, 1 < T <= 8, ``decoder.py:744-814``):
    the speculative loop's T positions per lane against the read-only
    cache plus a T x T causal block of the fresh rows, in plain PyTorch
    products (the JAX package uses XLA einsums here too), and one post-loop
    K5 call each for K and V at the per-lane write slots.

The continuous engine's paged pool (``decoder_paged_step``, JAX
``decoder.py:881-1033``, and ``decoder_paged_verify``, ``:1036-1201``) runs
the same split form through a page table: attention is kernel K6 (or K7
for the T-position verify), and all layers' fresh rows land after the loop
in one K8 launch each for K and V.

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
"s": f32}`` pair: attention runs K4 and the step's fresh bf16 rows are
quantized and written by one K3-int8 launch per K and per V.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from ..config import TextDecoderConfig
from ..ops.kernels.decode_attention import decode_attention, decode_attention_q8
from ..ops.kernels.experiments.decode_attention_hbm2 import decode_attention_hbm2
from ..ops.kernels.experiments.decode_attention_hbm3 import decode_attention_hbm3
from ..ops.kernels.flash_attention import flash_attention_causal
from ..ops.kernels.decode_attention_paged import (
    decode_attention_paged,
    decode_attention_paged_q8,
    decode_attention_paged_verify,
    decode_attention_paged_verify_q8,
)
from ..ops.kernels.kv_write import (
    kv_write_rows,
    kv_write_rows_batch,
    kv_write_rows_paged,
    kv_write_rows_paged_q8,
    kv_write_rows_q8,
    kv_write_span_batch,
)
from ..ops.norms import rms_norm
from ..ops.quant import is_quantized, qlinear
from ..ops.quant_kv import is_quantized_kv, kv_seq_len
from ..ops.rope import apply_rope, rope_cos_sin

DecoderParams = dict[str, Any]

#: Decode attention of the single-token split step, read from
#: ``QWEN3_ASR_DECODE_KERNEL`` at import (the JAX package's modes,
#: ``qwen3_asr_tpu/models/decoder.py:39-48``, dispatch :575-614): "auto" and
#: "5" run K2; with a shared write slot (an int ``write_slots``, the plain
#: decode loop) "3" runs K11a (``decode_attention_hbm2``) and "4" K11b
#: (``decode_attention_hbm3``), both on the largest block of 1024/512/256/128
#: rows that divides the cache length and the prompt bucket (ValueError if
#: none does, where the JAX package raises StopIteration).  Per-lane slots
#: (the flat engine) keep K2 and the int8 cache keeps K4 under every mode.
#: "0" (the JAX package's XLA attention) and other modes raise: the port has
#: no plain-path switch yet.
DECODE_KERNEL_MODE = os.environ.get("QWEN3_ASR_DECODE_KERNEL", "auto")
_PLAIN_SWITCHES_ITEM = 'ROADMAP.md Queue 1, "Plain-path switches"'


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (keys, values), each (L, B, kv_heads, max_len, head_dim)."""
    shape = (
        cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim
    )
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


def embed_tokens(params: DecoderParams, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup, (...) -> (..., hidden).  A quantized (H, V)
    embedding gathers columns and rescales them."""
    emb = params["embedding"]
    ids = ids.long()
    if is_quantized(emb):
        cols = emb["q"].index_select(1, ids.reshape(-1)).t()      # (n, H)
        rows = cols.float() * emb["s"][ids.reshape(-1)][:, None]
        return rows.to(params["final_norm"].dtype).reshape(*ids.shape, -1)
    return emb[ids]


def _project_qkv(h, lp, cfg: TextDecoderConfig, cos, sin):
    """ln1 -> fused-or-split QKV -> per-head QK RMSNorm -> RoPE at the
    angles (cos, sin) (B, 1, T, D/2).
    Returns q (B, nq, T, D), k, v (B, nkv, T, D), contiguous."""
    B, T, _ = h.shape
    nq, nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    x = rms_norm(h, lp["ln1"], eps)
    if "wqkv" in lp:
        q, k, v = torch.split(qlinear(x, lp["wqkv"]), [nq * D, nkv * D, nkv * D], dim=-1)
    else:
        q, k, v = qlinear(x, lp["wq"]), qlinear(x, lp["wk"]), qlinear(x, lp["wv"])
    q = rms_norm(q.reshape(B, T, nq, D), lp["q_norm"], eps).transpose(1, 2)
    k = rms_norm(k.reshape(B, T, nkv, D), lp["k_norm"], eps).transpose(1, 2)
    v = v.reshape(B, T, nkv, D).transpose(1, 2).contiguous()
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin).contiguous()
    return q, k, v


def _mlp_block(h, lp, eps):
    """Pre-norm SwiGLU MLP with residual."""
    x = rms_norm(h, lp["ln2"], eps)
    if "wgu" in lp:
        gate, up = qlinear(x, lp["wgu"]).chunk(2, dim=-1)
    else:
        gate, up = qlinear(x, lp["wg"]), qlinear(x, lp["wu"])
    return h + qlinear(F.silu(gate) * up, lp["wd"])


def decoder_forward(
    params: DecoderParams,
    cfg: TextDecoderConfig,
    hidden: torch.Tensor,
    positions: torch.Tensor,
    kv_cache: tuple[torch.Tensor, torch.Tensor],
    write_slots=None,
    decode_ctx: tuple[torch.Tensor, int, int] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Run the layer stack over input embeddings ``hidden`` (B, T, H) at
    absolute RoPE ``positions`` (B, T).

    Fresh prefill: ``write_slots`` and ``decode_ctx`` None, T > 1; rows land
    at slots [0, T).  Split decode: ``decode_ctx = (prompt_len (B,) int32,
    decode_end, prompt_bucket int)`` and T == 1; the fresh rows land at
    ``write_slots``; ``decode_end`` and ``write_slots`` are each an int
    shared by every lane (the decode loop) or a (B,) tensor (the continuous
    engine's lanes at their own depths, JAX ``engine.py:446-451``).  Verify split:
    ``decode_ctx = (prompt_len, ws, prompt_bucket)`` with ``ws`` (B,) the
    per-lane write slots (also passed as ``write_slots``) and 1 < T <= 8;
    bf16 or f32 cache only.  Returns the pre-final-norm hidden (B, T, H) and
    the (updated in place) cache.
    """
    B, T, _ = hidden.shape
    nq, nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    scale = D ** -0.5
    keys, values = kv_cache
    cos, sin = rope_cos_sin(positions[:, None, :], D, cfg.rope_theta)
    h = hidden

    if decode_ctx is None and write_slots is None and T > 1:
        for layer, lp in enumerate(params["layers"]):
            q, k, v = _project_qkv(h, lp, cfg, cos, sin)
            keys[layer, :, :, :T] = k
            values[layer, :, :, :T] = v
            attn = flash_attention_causal(q, k, v, scale=scale)
            h = h + qlinear(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"])
            h = _mlp_block(h, lp, eps)
        return h, (keys, values)

    if decode_ctx is not None and T == 1 and write_slots is not None:
        plen, dend, pbucket = decode_ctx
        q8 = is_quantized_kv(keys)
        device = hidden.device
        attend, dend = _split_step_attention(
            q8, isinstance(write_slots, torch.Tensor), dend, B, device,
            kv_seq_len(keys), pbucket,
        )
        n_layers = len(params["layers"])
        k_rows = torch.empty((n_layers, B, nkv, 1, D), dtype=hidden.dtype, device=device)
        v_rows = torch.empty_like(k_rows)
        for layer, lp in enumerate(params["layers"]):
            q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin)
            attn = attend(
                q[:, :, 0, :], keys, values, k_new, v_new, layer, plen, dend,
                pbucket, scale=scale,
            )
            k_rows[layer] = k_new
            v_rows[layer] = v_new
            h = h + qlinear(attn.reshape(B, 1, nq * D), lp["wo"])
            h = _mlp_block(h, lp, eps)
        if q8:
            slots = _per_lane(write_slots, B, device)
            kv_write_rows_q8(keys, k_rows, slots)
            kv_write_rows_q8(values, v_rows, slots)
        elif isinstance(write_slots, torch.Tensor):
            slots = _per_lane(write_slots, B, device)
            kv_write_rows_batch(keys, k_rows, slots)
            kv_write_rows_batch(values, v_rows, slots)
        else:
            kv_write_rows(keys, k_rows, write_slots)
            kv_write_rows(values, v_rows, write_slots)
        return h, (keys, values)

    if decode_ctx is not None and 1 < T <= 8 and write_slots is not None:
        if is_quantized_kv(keys):
            raise ValueError("the int8 KV cache takes single-token decode only")
        return _verify_split(params, cfg, h, cos, sin, keys, values, decode_ctx)

    raise NotImplementedError(
        "the PyTorch port runs fresh prefill (T > 1, no write_slots), "
        "single-token split decode (decode_ctx, T == 1) and the verify split "
        "(decode_ctx, 1 < T <= 8) only"
    )


def _split_step_attention(q8: bool, per_lane: bool, dend, B: int, device, S: int,
                          pbucket: int):
    """The split step's attention under :data:`DECODE_KERNEL_MODE` and the
    decode end in the form it takes: K4 on the int8 cache, K2 for per-lane
    slots and under "auto"/"5" (both with a (B,) decode end), K11a under "3"
    and K11b under "4" (an int decode end), each with ``block_k`` the largest
    of 1024/512/256/128 that divides S and the prompt bucket (JAX
    ``decoder.py:601-610``)."""
    mode = DECODE_KERNEL_MODE
    if mode not in ("auto", "3", "4", "5"):
        raise NotImplementedError(
            f"QWEN3_ASR_DECODE_KERNEL={mode!r}: the port runs decode modes "
            f"'auto', '3', '4' and '5' only; the plain (XLA) attention path "
            f"is {_PLAIN_SWITCHES_ITEM}"
        )
    if q8:
        return decode_attention_q8, _per_lane(dend, B, device)
    if per_lane or mode in ("auto", "5"):
        return decode_attention, _per_lane(dend, B, device)
    block_k = next((bk for bk in (1024, 512, 256, 128)
                    if S % bk == 0 and pbucket % bk == 0), None)
    if block_k is None:
        raise ValueError(
            f"decode mode {mode!r}: no block size of 1024/512/256/128 divides "
            f"both the cache length S={S} and the prompt bucket {pbucket}"
        )
    kernel = decode_attention_hbm2 if mode == "3" else decode_attention_hbm3
    return partial(kernel, block_k=block_k), int(dend)


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


def _verify_split(params, cfg: TextDecoderConfig, h, cos, sin, keys, values, decode_ctx):
    """The speculative verify pass (JAX ``decoder.py:744-814``): T fresh
    positions per lane against the read-only cache, one forward.

    Old-cache slots are valid in ``[0, plen) ∪ [pbucket, ws)``, strictly
    before each lane's write slot ``ws`` (B,); the T fresh positions attend
    each other through a T x T causal block; masked scores take the finite
    ``f32.min / 2``.  Scores and P·V accumulate in f32; the cache-side
    probabilities are rounded to the cache dtype before their product, as
    the JAX package does.  All layers' T rows are written after the loop by
    one K5 launch for K and one for V at slots ``ws .. ws + T - 1``."""
    plen, ws, pbucket = decode_ctx
    B, T, _ = h.shape
    nq, nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
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
        q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin)
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
        k_rows[layer] = k_new
        v_rows[layer] = v_new
        h = h + qlinear(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"])
        h = _mlp_block(h, lp, cfg.rms_norm_eps)
    kv_write_span_batch(keys, k_rows, ws)
    kv_write_span_batch(values, v_rows, ws)
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
):
    """One decode step over the paged pool (JAX ``decoder.py:881-1033``):
    attention over the read-only pre-step pages with the fresh token's
    self-term (K6, or its int8 form on the ``{"q", "s"}`` pool), then all
    layers' rows written by one K8 launch each for K and V.  The pools are
    updated in place.  Returns (pre-final-norm hidden (B, 1, H), pools)."""
    return _paged_forward(
        params, cfg, hidden, positions, kv_pages, page_table, prompt_len,
        decode_count, write_pages[:, None], write_offsets[:, None],
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
):
    """The speculative verify forward over the paged pool (JAX
    ``decoder.py:1036-1201``): T positions per lane in one forward, history
    through K7 (every position reads each page once), the fresh rows
    causally inside the kernel; all T rows of every layer land in one K8
    launch each for K and V (the JAX package calls its writer T times).
    Returns (hidden (B, T, H), pools)."""
    return _paged_forward(
        params, cfg, hidden, positions, kv_pages, page_table, prompt_len,
        decode_count, write_pages, write_offsets,
    )


def _paged_forward(params, cfg: TextDecoderConfig, h, positions, kv_pages, page_table,
                   prompt_len, decode_count, write_pages, write_offsets):
    """Shared body of :func:`decoder_paged_step` (T = 1) and
    :func:`decoder_paged_verify`."""
    keys, values = kv_pages
    B, T, _ = h.shape
    nq, nkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    device = h.device
    q8 = is_quantized_kv(keys)
    if T == 1:
        attend = decode_attention_paged_q8 if q8 else decode_attention_paged
    else:
        attend = decode_attention_paged_verify_q8 if q8 else decode_attention_paged_verify
    write = kv_write_rows_paged_q8 if q8 else kv_write_rows_paged
    table = page_table.to(device=device, dtype=torch.int32).contiguous()
    plen = _per_lane(prompt_len, B, device)
    dcount = _per_lane(decode_count, B, device)
    cos, sin = rope_cos_sin(positions[:, None, :], D, cfg.rope_theta)
    n_layers = len(params["layers"])
    k_rows = torch.empty((n_layers, B, nkv, T, D), dtype=h.dtype, device=device)
    v_rows = torch.empty_like(k_rows)
    for layer, lp in enumerate(params["layers"]):
        q, k_new, v_new = _project_qkv(h, lp, cfg, cos, sin)
        if T == 1:
            attn = attend(q[:, :, 0], keys, values, k_new, v_new, layer, table,
                          plen, dcount, scale=D ** -0.5)[:, :, None]
        else:
            attn = attend(q, keys, values, k_new, v_new, layer, table, plen,
                          dcount, scale=D ** -0.5)
        k_rows[layer] = k_new
        v_rows[layer] = v_new
        h = h + qlinear(attn.transpose(1, 2).reshape(B, T, nq * D), lp["wo"])
        h = _mlp_block(h, lp, cfg.rms_norm_eps)
    pages = write_pages.to(device=device, dtype=torch.int32).contiguous()
    offsets = write_offsets.to(device=device, dtype=torch.int32).contiguous()
    write(keys, k_rows, pages, offsets)
    write(values, v_rows, pages, offsets)
    return h, (keys, values)


def decoder_logits(params: DecoderParams, cfg: TextDecoderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm + tied lm_head -> float32 logits (B, T, vocab).

    The logits are the f32 accumulator, as in the JAX package
    (``preferred_element_type=float32``): bf16 weights on the GPU go
    through ``torch.mm(..., out_dtype=float32)``, so two logits closer than
    a bf16 ulp keep their order; a quantized (H, V) embedding is K9 with
    f32 output; float32 weights (and the CPU) take the plain product."""
    h = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    emb = params["embedding"]
    if is_quantized(emb):
        return qlinear(h, emb, out_dtype=torch.float32)
    if h.is_cuda and emb.dtype == torch.bfloat16:
        h2 = h.reshape(-1, h.shape[-1])
        logits = torch.mm(h2, emb.T, out_dtype=torch.float32)
        return logits.reshape(*h.shape[:-1], emb.shape[0])
    return (h @ emb.T).float()
