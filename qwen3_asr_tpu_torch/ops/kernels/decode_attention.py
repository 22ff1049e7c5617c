"""K2: one-token decode attention over the layer-stacked KV cache.

Replaces ``qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:
decode_attention_hbm4``.  Cache row s of lane b is valid when
``s < prompt_len[b]`` or ``prompt_bucket <= s < decode_end[b]`` (the cache
is ``[prompt 0..pb) | decode pb..S)``); the step's fresh ``k_new``/``v_new``
row is folded in as a self-term: it is not in the cache yet.

With ``write_slots`` (an int shared by every lane, or (B,) int32) the call
also stores that fresh row into the layer's cache at lane b's slot, a slot
outside ``[0, S)`` dropped: K3's work (``kv_write_rows``,
``kv_write_rows_batch``, ``kv_write_rows_q8``) fused into the same launch,
after the attention has read the cache, as the JAX decode loop orders them.
The decoder's split step passes it, so a decode iteration runs neither the
standalone writer nor the copies that staged its rows.

Bound on the H100: bytes (every valid K/V row is read once per step, at
about one FMA per byte).  The CUDA kernel (``csrc/decode_attention.cu``)
reads only the valid rows, never the padded middle of the cache, and reads
each row once for the whole GQA group, in one launch: blocks spread a
lane's rows over ``splits`` chunks so that small batches fill the card, a
producer thread streams each chunk by 1-D bulk copies into an ``mbarrier``
ring in shared memory, and the last block of each (lane, KV head) to finish
folds the partial softmaxes and the self-term, then stores the fresh row
when given a write slot (``csrc/decode_split.cuh``).  The wrapper picks the
split count, allocates the f32 workspace and hands over the device's zeroed
arrival counters (:func:`arrival_counters`).  Any ``prompt_bucket`` and S
work (no block-size divisibility); the int8 cache needs S % 4 == 0
(:func:`check_bulk_copies`).

On a CPU tensor the wrapper runs :func:`decode_attention_plain`, the masked
two-interval softmax of ``qwen3_asr_tpu/models/decoder.py:534-657``, then,
with a write slot, :func:`~.kv_write.kv_write_rows_plain` on the layer's
slice; on a CUDA tensor it launches the kernel or raises.  A launch with a
write slot also counts under :data:`NAME_WRITE` (:data:`NAME_Q8_WRITE`).

K4, :func:`decode_attention_q8`, replaces ``decode_attention_hbm4_q8``: the
same kernel over the int8 cache ``{"q": int8 (L, B, Hkv, S, D), "s": f32
(L, B, Hkv, S)}``, reading 128-byte rows plus one scale each (each run of
scales copied as its 16-byte aligned superset) and folding the scales into
the scores and probabilities.  Its plain version is the
JAX decoder's XLA fallback (``decoder.py:616-657``): dequantize the layer
to q's dtype, then the same two-interval softmax; with a write slot, then
:func:`~.kv_write.kv_write_rows_q8_plain` on the layer's slice (the kernel
quantizes the fresh row by the same rule, bit for bit).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..attention import NEG_INF
from ..quant_kv import dequantize_kv
from . import _build
from .kv_write import kv_write_rows_plain, kv_write_rows_q8_plain

NAME = "decode_attention"
NAME_Q8 = "decode_attention_q8"
#: Launches that also stored the fresh row (K3 and K3-int8, fused).
NAME_WRITE = "kv_write_rows_fused"
NAME_Q8_WRITE = "kv_write_rows_q8_fused"


def decode_attention_plain(
    q: torch.Tensor,            # (B, Hq, D)
    kall: torch.Tensor,         # (L, B, Hkv, S, D)
    vall: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,   # (B,)
    decode_end: torch.Tensor,   # (B,)
    prompt_bucket: int,
    scale: float,
) -> torch.Tensor:
    S = kall.shape[3]
    slot = torch.arange(S, device=q.device)
    mask = (slot[None, :] < prompt_len[:, None]) | (
        (slot[None, :] >= prompt_bucket) & (slot[None, :] < decode_end[:, None])
    )                                                           # (B, S)
    return masked_attention_plain(q, kall[layer], vall[layer], k_new, v_new, mask, scale)


def masked_attention_plain(
    q: torch.Tensor,            # (B, Hq, D)
    kcache: torch.Tensor,       # (B, Hkv, S, D): one layer of the cache
    vcache: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    mask: torch.Tensor,         # (B, S) bool: the cache rows each lane attends
    scale: float,
) -> torch.Tensor:
    """K2's plain math under any row mask: softmax over the masked scores
    and the fresh row's self-term, in float32."""
    B, hq, D = q.shape
    hkv, S = kcache.shape[1], kcache.shape[2]
    group = hq // hkv
    qg = q.reshape(B, hkv, group, D).float()
    logits = torch.einsum("bkgd,bkld->bkgl", qg, kcache.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    k_self = k_new[:, :, 0].float()[:, :, None, :]             # (B, Hkv, 1, D)
    self_logit = (qg * k_self).sum(-1, keepdim=True) * scale    # (B, Hkv, G, 1)
    w = torch.softmax(torch.cat([logits, self_logit], dim=-1), dim=-1)
    out = torch.einsum(
        "bkgl,bkld->bkgd", w[..., :S].to(vcache.dtype).float(), vcache.float()
    ) + w[..., S:] * v_new[:, :, 0].float()[:, :, None, :]
    return out.reshape(B, hq, D).to(q.dtype)


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``, one per (lane,
    KV head), which the kernel leaves at zero: the same buffer for every
    call of the scratch owner (``_build.scratch``) that fits in it."""
    bufs = _build.scratch(device).setdefault("arrival_counters", [])
    if not bufs or bufs[-1].numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention: the arrival counters for this batch are made on the "
                "first call; make one call outside CUDA-graph capture first"
            )
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=device))
    return bufs[-1]


def check_bulk_copies(cache_len: int, q8: bool, ptrs: tuple[int, ...]) -> None:
    """Raise unless the kernel's bulk copies can read the cache: every cache
    pointer (K and V, and the int8 cache's scales) 16-byte aligned, and for
    the int8 cache ``cache_len % 4 == 0`` (a run of f32 scales is copied as
    its 16-byte aligned superset, which stays inside the lane's S scales,
    or the page's PS for K6/K7, only then)."""
    if any(p % 16 for p in ptrs):
        raise ValueError("the cache's tensors must be 16-byte aligned for the kernel's bulk copies")
    if q8 and cache_len % 4:
        raise ValueError(
            f"the int8 cache's rows per lane or page ({cache_len}) must be a multiple of 4: "
            "the kernel copies each run of f32 scales as its 16-byte aligned superset"
        )


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_count(batch: int, hkv: int, cache_len: int, sm_count: int) -> int:
    """Blocks per (lane, kv head): enough for about two blocks per SM,
    at least 64 cache rows per block, at most 64."""
    per = max(batch * hkv, 1)
    return max(1, min(-(-2 * sm_count // per), -(-cache_len // 64), 64))


def decode_attention_q8_plain(
    q: torch.Tensor,
    kall: dict,
    vall: dict,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,
    decode_end: torch.Tensor,
    prompt_bucket: int,
    scale: float,
) -> torch.Tensor:
    """:func:`decode_attention_plain` over layer ``layer`` of the int8
    cache, dequantized to q's dtype."""
    kc = dequantize_kv({"q": kall["q"][layer], "s": kall["s"][layer]}, q.dtype)
    vc = dequantize_kv({"q": vall["q"][layer], "s": vall["s"][layer]}, q.dtype)
    return decode_attention_plain(
        q, kc[None], vc[None], k_new, v_new, 0, prompt_len, decode_end,
        prompt_bucket, scale,
    )


def write_slot_tensor(write_slots, B: int, device) -> torch.Tensor:
    """``write_slots`` as int32 (B,) on ``device``: an int is every lane's
    slot; a tensor must already be int32 (B,), contiguous, on ``device``."""
    if not isinstance(write_slots, torch.Tensor):
        return torch.full((B,), int(write_slots), dtype=torch.int32, device=device)
    if write_slots.dtype != torch.int32 or tuple(write_slots.shape) != (B,):
        raise ValueError(f"write_slots must be int32 ({B},)")
    if write_slots.device != device or not write_slots.is_contiguous():
        raise ValueError(f"write_slots must be contiguous on {device}")
    return write_slots


def _write_plain(cache, rows, layer: int, slots: torch.Tensor) -> None:
    """The plain writer of the layer's slice (bf16 cache, or the int8
    ``{"q", "s"}`` one): ``rows`` (B, Hkv, 1, D) at ``slots``."""
    if isinstance(cache, dict):
        layer_cache = {k: v[layer : layer + 1] for k, v in cache.items()}
        kv_write_rows_q8_plain(layer_cache, rows[None], slots)
    else:
        kv_write_rows_plain(cache[layer : layer + 1], rows[None], slots)


def _check(q, kall, vall, k_new, v_new, layer, prompt_len, decode_end,
           cache_dtype=torch.bfloat16) -> None:
    if q.dim() != 3 or kall.dim() != 5:
        raise ValueError("q must be (B, Hq, D) and kall (L, B, Hkv, S, D)")
    B, hq, D = q.shape
    L, Bc, hkv, S, Dc = kall.shape
    if D != 128 or Dc != 128:
        raise ValueError(f"head_dim must be 128, got {D}/{Dc}")
    if Bc != B or vall.shape != kall.shape:
        raise ValueError("cache batch/shape mismatch")
    if hq % hkv or hq // hkv not in (1, 2, 4):
        raise ValueError(f"GQA group {hq}/{hkv} not supported (1, 2 or 4)")
    if tuple(k_new.shape) != (B, hkv, 1, D) or v_new.shape != k_new.shape:
        raise ValueError("k_new/v_new must be (B, Hkv, 1, D)")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    for name, t, want in (("q", q, torch.bfloat16), ("kall", kall, cache_dtype),
                          ("vall", vall, cache_dtype), ("k_new", k_new, torch.bfloat16),
                          ("v_new", v_new, torch.bfloat16)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    for name, t in (("prompt_len", prompt_len), ("decode_end", decode_end)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be int32 (B,)")
    for name, t in (("kall", kall), ("vall", vall), ("k_new", k_new),
                    ("v_new", v_new), ("prompt_len", prompt_len),
                    ("decode_end", decode_end)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("kall", kall), ("vall", vall), ("k_new", k_new),
                    ("v_new", v_new), ("prompt_len", prompt_len),
                    ("decode_end", decode_end)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention(
    q: torch.Tensor,
    kall: torch.Tensor,
    vall: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,
    decode_end: torch.Tensor,
    prompt_bucket: int,
    scale: float | None = None,
    write_slots: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """One-token attention of q (B, Hq, D) over layer ``layer`` of the
    stacked cache plus the fresh row; ``prompt_len`` and ``decode_end`` are
    (B,) int32.  With ``write_slots`` (an int, or (B,) int32) the fresh row
    then lands in layer ``layer`` of the cache at lane b's slot (dropped
    outside [0, S)), in place.  Returns (B, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    slots = None if write_slots is None else write_slot_tensor(write_slots, q.shape[0], q.device)
    if not q.is_cuda:
        out = decode_attention_plain(
            q, kall, vall, k_new, v_new, layer, prompt_len, decode_end,
            prompt_bucket, scale,
        )
        if slots is not None:
            _write_plain(kall, k_new, layer, slots)
            _write_plain(vall, v_new, layer, slots)
        return out
    _check(q, kall, vall, k_new, v_new, layer, prompt_len, decode_end)
    return _launch(
        NAME, "decode_attention_bf16", q, kall.shape,
        (kall.data_ptr(), vall.data_ptr()), k_new, v_new, layer, prompt_len,
        decode_end, prompt_bucket, scale, slots,
    )


def _launch(name, entry, q, cache_shape, cache_ptrs, k_new, v_new, layer,
            prompt_len, decode_end, prompt_bucket, scale, slots) -> torch.Tensor:
    """Allocate the split workspace and the output, and launch the C entry
    point ``entry`` (K2 or K4) on the cache pointers ``cache_ptrs``, with
    the fresh row's store when ``slots`` is given."""
    B, hq, D = q.shape
    hkv, S = cache_shape[2], cache_shape[3]
    check_bulk_copies(S, name == NAME_Q8, cache_ptrs)
    splits = split_count(B, hkv, S, _sm_count(q.device))
    ws = torch.empty(
        (B, hkv, splits, hq // hkv, D + 2), dtype=torch.float32, device=q.device
    )
    counters = arrival_counters(q.device, B * hkv)
    out = torch.empty_like(q)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), *cache_ptrs, k_new.data_ptr(), v_new.data_ptr(),
        prompt_len.data_ptr(), decode_end.data_ptr(),
        None if slots is None else slots.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), out.data_ptr(), int(layer), B, hq, hkv, S,
        int(prompt_bucket), splits, float(scale), _build.stream_ptr(q),
    )
    _build.check(err, name)
    _build.count(name)
    if slots is not None:
        _build.count(NAME_Q8_WRITE if name == NAME_Q8 else NAME_WRITE)
    return out


def _check_scales(kall: dict, vall: dict) -> None:
    for name, c in (("kall", kall), ("vall", vall)):
        sc = c["s"]
        if tuple(sc.shape) != tuple(c["q"].shape[:-1]) or sc.dtype != torch.float32:
            raise ValueError(f"{name}['s'] must be f32 {tuple(c['q'].shape[:-1])}")
        if sc.device != c["q"].device or not sc.is_contiguous():
            raise ValueError(f"{name}['s'] must be contiguous on {c['q'].device}")


def decode_attention_q8(
    q: torch.Tensor,
    kall: dict,
    vall: dict,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,
    decode_end: torch.Tensor,
    prompt_bucket: int,
    scale: float | None = None,
    write_slots: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`decode_attention` over the int8 cache ``{"q", "s"}``; the
    fresh ``k_new``/``v_new`` rows stay bf16, and with ``write_slots`` they
    are quantized per row into the cache.  Returns (B, Hq, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    slots = None if write_slots is None else write_slot_tensor(write_slots, q.shape[0], q.device)
    if not q.is_cuda:
        out = decode_attention_q8_plain(
            q, kall, vall, k_new, v_new, layer, prompt_len, decode_end,
            prompt_bucket, scale,
        )
        if slots is not None:
            _write_plain(kall, k_new, layer, slots)
            _write_plain(vall, v_new, layer, slots)
        return out
    _check(q, kall["q"], vall["q"], k_new, v_new, layer, prompt_len, decode_end,
           cache_dtype=torch.int8)
    _check_scales(kall, vall)
    ptrs = (kall["q"].data_ptr(), vall["q"].data_ptr(), kall["s"].data_ptr(),
            vall["s"].data_ptr())
    return _launch(
        NAME_Q8, "decode_attention_q8", q, kall["q"].shape, ptrs, k_new, v_new,
        layer, prompt_len, decode_end, prompt_bucket, scale, slots,
    )
