"""K6 and K7: decode attention over the paged KV pool, through a page table.

Replaces ``qwen3_asr_tpu/ops/pallas/decode_attention_paged.py``:
``decode_attention_paged`` and ``decode_attention_paged_q8`` (K6, the
continuous engine's single-token step) and ``decode_attention_paged_verify``
and ``decode_attention_paged_verify_q8`` (K7, its speculative verify at T
positions per lane).  The pool is (L, n_pages, Hkv, PS, D), bf16 or the int8
``{"q", "s"}`` pair; lane b's rows resolve through ``table[b]``: its prompt
rows ``[0, plen)`` on the first ``pp = ceil(plen / PS)`` entries, its decode
rows ``[0, dcount)`` from entry ``pp`` on (compact masking: no prompt-bucket
arithmetic), table entries clipped into the pool.  ``dcount`` excludes the
fresh rows ``k_new``/``v_new`` (B, Hkv, T, D), which every query position t
attends causally (fresh column u iff u <= t).

With ``write_pages`` and ``write_offsets`` ((B, T) int32, or (B,) for
T = 1) the call also stores fresh row t of lane b into the layer's pool at
``(clip(write_pages[b, t], 0, n_pages - 1), write_offsets[b, t])``, rows
whose offset lies outside ``[0, PS)`` dropped: K8's work
(``kv_write_rows_paged``, ``kv_write_rows_paged_q8``) fused into the same
launch, after the attention has read the pool, as the JAX decoder orders
them.  The decoder's paged step and verify pass it.

Bound on the H100: bytes (each valid K and V row read once per layer).  The
CUDA kernel (``csrc/decode_attention_paged.cu``) is K2's one-launch design
(``csrc/decode_split.cuh``) with page addressing: each lane's densely
numbered valid rows are cut into ``splits`` chunks, taken by as many blocks
as fit on the card at once, a producer warp reads the lane's table row once
and streams each 32-row tile as runs of pool rows (one per page and
interval, at most three) by 1-D bulk copies into an ``mbarrier`` ring, all
T x group query rows of a KV head read each row once, and the last block of
each (lane, KV head) to finish folds the partials and the causal fresh
block, then stores the fresh rows when given a write target.  The wrapper
picks the split count (K2's :func:`~.decode_attention.split_count`),
allocates the f32 workspace and hands over K2's zeroed arrival counters; the
pool must suit the bulk copies (:func:`check_pool`).  Its largest T x group is
:data:`MAX_QUERY_ROWS` (8, the JAX kernel's sublane pad); the engine's
speculative gate reads this constant.

On a CPU tensor each wrapper runs :func:`paged_attention_plain`, the JAX
decoder's gather-and-mask path (``decoder.py:924-989``, ``:1078-1149``): the
lane's pages gathered into one compact view, the two masked intervals, the
causal fresh block, one softmax; the int8 pool is dequantized to q's dtype
first; with a write target, then :func:`~.kv_write.kv_write_rows_paged_plain`
(``_q8_plain``) on the layer's slice.  On a CUDA tensor it launches the
kernel or raises.  A launch with a write target also counts under
:data:`NAME_WRITE` (:data:`NAME_Q8_WRITE` on the int8 pool).
"""

from __future__ import annotations

import torch

from ..attention import NEG_INF
from . import _build
from .decode_attention import _sm_count, arrival_counters, check_bulk_copies, split_count
from .kv_write import kv_write_rows_paged_plain, kv_write_rows_paged_q8_plain

NAME = "decode_attention_paged"
NAME_Q8 = "decode_attention_paged_q8"
NAME_VERIFY = "decode_attention_paged_verify"
NAME_VERIFY_Q8 = "decode_attention_paged_verify_q8"
#: Launches (K6 or K7) that also stored the fresh rows (K8, fused).
NAME_WRITE = "kv_write_rows_paged_fused"
NAME_Q8_WRITE = "kv_write_rows_paged_q8_fused"

#: The most query rows (T x GQA group) per KV head that K7 takes.
MAX_QUERY_ROWS = 8
#: Rows of one tile of the kernel's ring.
TILE_ROWS = 32


def _gather(pool: torch.Tensor, layer: int, table: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, max_pages * PS, D): lane b's table pages of layer ``layer``
    in table order."""
    pages = pool[layer][table.long().clamp(0, pool.shape[1] - 1)]   # (B, mp, H, PS, D)
    B, mp, H, PS, D = pages.shape
    return pages.transpose(1, 2).reshape(B, H, mp * PS, D)


def compact_mask(table: torch.Tensor, page_size: int, prompt_len, decode_count) -> torch.Tensor:
    """(B, max_pages * PS) validity of the gathered view: prompt rows
    ``< plen``, then decode rows ``< dcount`` from the first decode page."""
    cols = torch.arange(table.shape[1] * page_size, device=table.device)[None, :]
    dstart = ((prompt_len.long() + page_size - 1) // page_size * page_size)[:, None]
    return (cols < prompt_len.long()[:, None]) | (
        (cols >= dstart) & (cols < dstart + decode_count.long()[:, None])
    )


def paged_attention_plain(
    q: torch.Tensor,            # (B, Hq, T, D)
    kpool: torch.Tensor,        # (L, n_pages, Hkv, PS, D)
    vpool: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, T, D)
    v_new: torch.Tensor,
    layer: int,
    table: torch.Tensor,        # (B, max_pages)
    prompt_len: torch.Tensor,   # (B,)
    decode_count: torch.Tensor,  # (B,)
    scale: float,
) -> torch.Tensor:
    """Masked softmax over the gathered pages plus the causal fresh block,
    f32 scores; the cache-side probabilities are rounded to the pool's dtype
    before their product, as in the JAX decoder.  Returns (B, Hq, T, D)."""
    B, hq, T, D = q.shape
    hkv, PS = kpool.shape[2], kpool.shape[3]
    G = hq // hkv
    kc, vc = _gather(kpool, layer, table), _gather(vpool, layer, table)
    Sc = kc.shape[2]
    mask = compact_mask(table, PS, prompt_len, decode_count)
    qg = q.reshape(B, hkv, G, T, D).float()
    logits = torch.einsum("bkgtd,bkld->bkgtl", qg, kc.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    fresh = torch.einsum("bkgtd,bkud->bkgtu", qg, k_new.float()) * scale
    t_idx = torch.arange(T, device=q.device)
    fresh = fresh.masked_fill(t_idx[None, :] > t_idx[:, None], NEG_INF)
    w = torch.softmax(torch.cat([logits, fresh], dim=-1), dim=-1)
    out = torch.einsum(
        "bkgtl,bkld->bkgtd", w[..., :Sc].to(vc.dtype).float(), vc.float()
    ) + torch.einsum("bkgtu,bkud->bkgtd", w[..., Sc:], v_new.float())
    return out.reshape(B, hq, T, D).to(q.dtype)


def paged_attention_q8_plain(q, kpool: dict, vpool: dict, k_new, v_new, layer, table,
                             prompt_len, decode_count, scale) -> torch.Tensor:
    """:func:`paged_attention_plain` over layer ``layer`` of the int8 pool,
    dequantized to q's dtype (the JAX decoder's ``gather_pages``)."""
    def deq(pool):
        return (pool["q"][layer].float() * pool["s"][layer][..., None]).to(q.dtype)[None]

    return paged_attention_plain(
        q, deq(kpool), deq(vpool), k_new, v_new, 0, table, prompt_len,
        decode_count, scale,
    )


def _check(q, kpool, vpool, k_new, v_new, layer, table, prompt_len, decode_count,
           pool_dtype) -> None:
    if q.dim() != 4 or kpool.dim() != 5:
        raise ValueError("q must be (B, Hq, T, D) and the pool (L, n_pages, Hkv, PS, D)")
    B, hq, T, D = q.shape
    L, _, hkv, _, Dc = kpool.shape
    if D != 128 or Dc != 128:
        raise ValueError(f"head_dim must be 128, got {D}/{Dc}")
    if vpool.shape != kpool.shape:
        raise ValueError("pool shape mismatch")
    if hq % hkv or T * (hq // hkv) > MAX_QUERY_ROWS:
        raise ValueError(
            f"T={T} x group {hq}/{hkv} exceeds {MAX_QUERY_ROWS} query rows per KV head"
        )
    if tuple(k_new.shape) != (B, hkv, T, D) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be {(B, hkv, T, D)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    for name, t, want in (("q", q, torch.bfloat16), ("kpool", kpool, pool_dtype),
                          ("vpool", vpool, pool_dtype), ("k_new", k_new, torch.bfloat16),
                          ("v_new", v_new, torch.bfloat16), ("table", table, torch.int32),
                          ("prompt_len", prompt_len, torch.int32),
                          ("decode_count", decode_count, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1:
        raise ValueError("table must be (B, max_pages), max_pages >= 1")
    for name, t in (("prompt_len", prompt_len), ("decode_count", decode_count)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be (B,)")


def check_pool(page_size: int, q8: bool, ptrs: tuple[int, ...]) -> None:
    """Raise unless the kernel's bulk copies can read the pool
    (:func:`~.decode_attention.check_bulk_copies` with the page as the
    lane's rows: 16-byte aligned pointers, ``page_size % 4 == 0`` for the
    int8 pool) and a tile spans at most three runs of pool rows: pages of
    at least :data:`TILE_ROWS` rows."""
    check_bulk_copies(page_size, q8, ptrs)
    if page_size < TILE_ROWS:
        raise ValueError(
            f"page_size={page_size} must be at least {TILE_ROWS}: a tile of the kernel's "
            "ring spans at most three runs of pool rows only then"
        )


def _launch(name, entry, q, pool_shape, pool_ptrs, k_new, v_new, layer, table,
            prompt_len, decode_count, scale, target) -> torch.Tensor:
    """Allocate the split workspace and the output; launch ``entry``, with
    the fresh rows' store when ``target`` (pages, offsets) is given."""
    B, hq, T, D = q.shape
    _, n_pages, hkv, PS, _ = pool_shape
    check_pool(PS, entry == "decode_attention_paged_q8", pool_ptrs)
    max_pages = table.shape[1]
    splits = split_count(B, hkv, max_pages * PS, _sm_count(q.device))
    ws = torch.empty(
        (B, hkv, splits, T * hq // hkv, D + 2), dtype=torch.float32, device=q.device
    )
    counters = arrival_counters(q.device, B * hkv)
    out = torch.empty_like(q)
    pages, offsets = (None, None) if target is None else (t.data_ptr() for t in target)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), *pool_ptrs, k_new.data_ptr(), v_new.data_ptr(),
        table.data_ptr(), prompt_len.data_ptr(), decode_count.data_ptr(), pages, offsets,
        ws.data_ptr(), counters.data_ptr(), out.data_ptr(), int(layer), B, hq, hkv, T,
        n_pages, PS, max_pages, splits, float(scale), _build.stream_ptr(q),
    )
    _build.check(err, name)
    _build.count(name)
    if target is not None:
        _build.count(NAME_Q8_WRITE if entry.endswith("q8") else NAME_WRITE)
    return out


def write_target(write_pages, write_offsets, B: int, T: int, device):
    """(pages, offsets) as int32 (B, T) on ``device``, or None when both are
    None; (B,) tensors are taken as (B, 1).  Raises on anything else."""
    if write_pages is None and write_offsets is None:
        return None
    out = []
    for name, t in (("write_pages", write_pages), ("write_offsets", write_offsets)):
        if not isinstance(t, torch.Tensor) or t.numel() != B * T or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 tensor of {B} x {T}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
        out.append(t.reshape(B, T))
    return tuple(out)


def _write_plain(pool, rows, layer, target) -> None:
    """The plain writer of the layer's slice: ``rows`` (B, Hkv, T, D)."""
    if isinstance(pool, dict):
        layer_pool = {k: v[layer : layer + 1] for k, v in pool.items()}
        kv_write_rows_paged_q8_plain(layer_pool, rows[None], *target)
    else:
        kv_write_rows_paged_plain(pool[layer : layer + 1], rows[None], *target)


def _attend(name, q, kpool, vpool, k_new, v_new, layer, table, prompt_len,
            decode_count, scale, write_pages, write_offsets):
    """Shared body of the four wrappers; ``q`` is (B, Hq, T, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q8 = isinstance(kpool, dict)
    target = write_target(write_pages, write_offsets, q.shape[0], q.shape[2], q.device)
    if not q.is_cuda:
        plain = paged_attention_q8_plain if q8 else paged_attention_plain
        out = plain(q, kpool, vpool, k_new, v_new, layer, table, prompt_len,
                    decode_count, scale)
        if target is not None:
            _write_plain(kpool, k_new, layer, target)
            _write_plain(vpool, v_new, layer, target)
        return out
    if q8:
        _check(q, kpool["q"], vpool["q"], k_new, v_new, layer, table, prompt_len,
               decode_count, torch.int8)
        for pool in (kpool, vpool):
            sc = pool["s"]
            if tuple(sc.shape) != tuple(pool["q"].shape[:-1]) or sc.dtype != torch.float32:
                raise TypeError(f"pool['s'] must be f32 {tuple(pool['q'].shape[:-1])}")
            if sc.device != q.device or not sc.is_contiguous():
                raise ValueError(f"pool['s'] must be contiguous on {q.device}")
        ptrs = (kpool["q"].data_ptr(), vpool["q"].data_ptr(), kpool["s"].data_ptr(),
                vpool["s"].data_ptr())
        return _launch(name, "decode_attention_paged_q8", q, kpool["q"].shape, ptrs,
                       k_new, v_new, layer, table, prompt_len, decode_count, scale, target)
    _check(q, kpool, vpool, k_new, v_new, layer, table, prompt_len, decode_count,
           torch.bfloat16)
    return _launch(name, "decode_attention_paged_bf16", q, kpool.shape,
                   (kpool.data_ptr(), vpool.data_ptr()), k_new, v_new, layer, table,
                   prompt_len, decode_count, scale, target)


def decode_attention_paged(q, kpool, vpool, k_new, v_new, layer, table, prompt_len,
                           decode_count, scale=None, write_pages=None,
                           write_offsets=None) -> torch.Tensor:
    """K6: one-token attention of q (B, Hq, D) over layer ``layer`` of the
    bf16 pool plus the fresh row k_new/v_new (B, Hkv, 1, D); ``table``
    (B, max_pages), ``prompt_len`` and ``decode_count`` (B,) int32.  With
    ``write_pages``/``write_offsets`` (B,) int32 the fresh row then lands in
    the layer's pool there, in place.  Returns (B, Hq, D)."""
    return _attend(NAME, q[:, :, None], kpool, vpool, k_new, v_new, layer, table,
                   prompt_len, decode_count, scale, write_pages, write_offsets)[:, :, 0]


def decode_attention_paged_q8(q, kpool: dict, vpool: dict, k_new, v_new, layer, table,
                              prompt_len, decode_count, scale=None, write_pages=None,
                              write_offsets=None) -> torch.Tensor:
    """K6 over the int8 pool ``{"q", "s"}``; the fresh rows stay bf16 and
    are quantized per row when written."""
    return _attend(NAME_Q8, q[:, :, None], kpool, vpool, k_new, v_new, layer, table,
                   prompt_len, decode_count, scale, write_pages, write_offsets)[:, :, 0]


def decode_attention_paged_verify(q, kpool, vpool, k_new, v_new, layer, table,
                                  prompt_len, decode_count, scale=None, write_pages=None,
                                  write_offsets=None) -> torch.Tensor:
    """K7: T positions per lane, q (B, Hq, T, D), k_new/v_new (B, Hkv, T, D),
    T x group <= :data:`MAX_QUERY_ROWS`; every position attends the same
    history (``decode_count`` excludes the T fresh rows) and the fresh rows
    causally; with ``write_pages``/``write_offsets`` (B, T) int32 the fresh
    rows then land in the layer's pool there.  Returns (B, Hq, T, D)."""
    return _attend(NAME_VERIFY, q, kpool, vpool, k_new, v_new, layer, table,
                   prompt_len, decode_count, scale, write_pages, write_offsets)


def decode_attention_paged_verify_q8(q, kpool: dict, vpool: dict, k_new, v_new, layer,
                                     table, prompt_len, decode_count, scale=None,
                                     write_pages=None, write_offsets=None) -> torch.Tensor:
    """K7 over the int8 pool ``{"q", "s"}``."""
    return _attend(NAME_VERIFY_Q8, q, kpool, vpool, k_new, v_new, layer, table,
                   prompt_len, decode_count, scale, write_pages, write_offsets)
