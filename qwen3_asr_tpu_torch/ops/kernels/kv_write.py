"""K3 and K5: in-place KV-cache row writes.

Replaces ``qwen3_asr_tpu/ops/pallas/kv_write.py``: ``kv_write_rows`` (one
slot shared by every lane, the decode loop's case),
``kv_write_rows_batch`` (a slot per lane) and, as K5,
``kv_write_span_batch`` (the speculative verify pass's T <= 8 rows per lane
at ``slots[b] .. slots[b] + T - 1``, rows past the cache end dropped, as
the JAX package's ``mode="drop"`` scatter).  Bound on the H100: bytes, and
at these sizes (459 KB per step at B=8) launch latency.  K3's CUDA kernel
(``csrc/kv_write.cu``) stores exactly rows ``[l, b, :, slots[b] + t, :]``
with one thread per 16-byte vector (the shared-slot wrapper broadcasts its
slot to every lane).  The TPU kernels' read-modify-write tiles exist only
for the TPU's memory tiling and are not carried over.

The verify pass writes its K and V spans with :func:`kv_write_span_pair`:
one launch for both caches, each thread several 16-byte vectors in flight,
lanes and rows that land nowhere skipped on the device.  The single-cache
:func:`kv_write_span_batch` (K3's kernel at T rows) stays as its oracle on
the card; both count under ``kv_write_span_batch``.

On a CPU tensor the wrappers run the plain versions (one ``index_put_``
each, rows whose slot lies outside ``[0, S)`` dropped as the kernel drops
them); on a CUDA tensor they launch the kernel or raise.  All update
``cache`` in place and return it.  The plain versions never wait for the
device, so a CUDA graph can hold them (the decoder's "xla" KV writer runs
them on the card): a dropped row's index is clamped into the cache, and it
writes there the value that place ends with -- the row that lands there,
or what the cache held -- so no index of the one ``index_put_`` takes two
different values.

The decoder's default decode paths no longer call K3 or K8: K2/K4 and
K6/K7 store the fresh rows from the same launch (``write_slots``,
``write_pages``/``write_offsets`` of ``decode_attention*``), and their plain
versions call the plain writers here on the layer's slice.  The standalone
kernels stay as those stores' oracles on the card; ``kv_write_rows``
serves the decode modes "0", "3" and "4", whose attention takes no write
target, and ``kv_write_rows_q8`` mode "0" on the int8 cache.

The int8 cache ``{"q", "s"}`` takes the step's bf16 rows through
:func:`kv_write_rows_q8`: one launch quantizes each 128-wide row with
``ops/quant_kv.py:quantize_kv``'s rule and stores the int8 row and its f32
scale; its plain version is ``quantize_kv`` + :func:`kv_write_rows_plain` +
the scale write, and the kernel matches it bit for bit.

K8, :func:`kv_write_rows_paged` and :func:`kv_write_rows_paged_q8`,
replaces ``kv_write.py:kv_write_rows_paged``: the paged pool's writer.
Row t of lane b lands at ``pool[l, pages[b, t], h, offsets[b, t]]`` of the
pool (L, n_pages, Hkv, PS, D), the page clipped to ``[0, n_pages)`` as the
JAX wrapper does, rows whose offset lies outside ``[0, PS)`` dropped.  T
rows per lane go in one launch (1 for the step, ``gamma + 1`` for the
verify).  The plain version is one ``index_put_``; where several rows land
on one (page, offset), which happens only on the trash page 0, which of
them stays is unspecified in both versions.
"""

from __future__ import annotations

import torch

from ..quant_kv import quantize_kv
from . import _build

NAME = "kv_write_rows"
NAME_Q8 = "kv_write_rows_q8"
NAME_SPAN = "kv_write_span_batch"


def kv_write_rows_plain(
    cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor
) -> torch.Tensor:
    """cache[:, b, :, slots[b], :] = rows[:, b, :, 0, :] for every lane b
    whose slot lies in [0, S); the others are dropped."""
    return kv_write_span_batch_plain(cache, rows, slots)


def _check(
    cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, T: int = 1
) -> None:
    if cache.dim() != 5:
        raise ValueError("cache must be (L, B, Hkv, S, D)")
    L, B, H, S, D = cache.shape
    if tuple(rows.shape) != (L, B, H, T, D):
        raise ValueError(f"rows shape {tuple(rows.shape)} != {(L, B, H, T, D)}")
    if D != 128:
        raise ValueError(f"head_dim must be 128, got {D}")
    if cache.dtype != torch.bfloat16 or rows.dtype != torch.bfloat16:
        raise TypeError("cache and rows must be bfloat16")
    if slots.dtype != torch.int32 or tuple(slots.shape) != (B,):
        raise ValueError("slots must be int32 (B,)")
    for name, t in (("rows", rows), ("slots", slots)):
        if t.device != cache.device:
            raise ValueError(f"{name} is on {t.device}, cache on {cache.device}")
    if not (cache.is_contiguous() and rows.is_contiguous() and slots.is_contiguous()):
        raise ValueError("cache, rows and slots must be contiguous")


def _launch(
    name: str, cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor, T: int
) -> torch.Tensor:
    """Launch the bf16 row-write kernel for ``rows`` (L, B, Hkv, T, D) and
    count it under ``name``."""
    _check(cache, rows, slots, T)
    L, B, H, S, _ = cache.shape
    err = _build.library().kv_write_rows_bf16(
        cache.data_ptr(), rows.data_ptr(), slots.data_ptr(), L, B, H, T, S,
        _build.stream_ptr(cache),
    )
    _build.check(err, name)
    _build.count(name)
    return cache


def _write(cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if not cache.is_cuda:
        return kv_write_rows_plain(cache, rows, slots)
    return _launch(NAME, cache, rows, slots, 1)


def kv_write_rows(cache: torch.Tensor, rows: torch.Tensor, slot: int) -> torch.Tensor:
    """Write ``rows`` (L, B, Hkv, 1, D) into ``cache`` (L, B, Hkv, S, D) at
    one ``slot`` shared by every lane."""
    slots = torch.full((cache.shape[1],), slot, dtype=torch.int32, device=cache.device)
    return _write(cache, rows, slots)


def kv_write_rows_batch(
    cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor
) -> torch.Tensor:
    """Per-lane variant: lane b's rows land at ``slots[b]`` (int32, (B,))."""
    return _write(cache, rows, slots)


def span_indices(
    slots: torch.Tensor, T: int, S: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lane, row, slot) index vectors of the span rows that land inside
    the cache: row t of lane b goes to ``slots[b] + t`` unless that is
    outside [0, S).  Syncs with the device (the count is data-dependent);
    the byte counts of the card checks use it, the writers do not."""
    target = slots.long()[:, None] + torch.arange(T, device=slots.device)[None, :]
    lane, row = torch.nonzero((target >= 0) & (target < S), as_tuple=True)
    return lane, row, target[lane, row]


def kv_write_span_batch_plain(
    cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor
) -> torch.Tensor:
    """cache[:, b, :, slots[b] + t, :] = rows[:, b, :, t, :] for every lane b
    and span row t whose slot lies in [0, S) (one ``index_put_``); the rest
    are dropped.  No device sync: a row outside the cache writes at its
    slot clamped into [0, S) the row that lands there, if one does, else
    the cache's own value."""
    B, T, S = rows.shape[1], rows.shape[3], cache.shape[3]
    start = slots.to(device=cache.device, dtype=torch.long)[:, None]
    slot = (start + torch.arange(T, device=cache.device)).clamp(0, S - 1)      # (B, T)
    src = slot - start                        # the span row that lands on `slot`, if any
    lands = ((src >= 0) & (src < T))[..., None, None, None]
    lane = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    new = rows[:, lane, :, src.clamp(0, T - 1)].to(cache.dtype)             # (B, T, L, H, D)
    cache[:, lane, :, slot] = torch.where(lands, new, cache[:, lane, :, slot])
    return cache


def kv_write_span_batch(
    cache: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor
) -> torch.Tensor:
    """K5 on one cache, the TPU kernel's signature (the decoder writes both
    caches with :func:`kv_write_span_pair`): lane b's ``T`` <= 8 rows
    ``rows`` (L, B, Hkv, T, D) into ``cache`` (L, B, Hkv, S, D) at
    ``slots[b] .. slots[b] + T - 1`` (int32 ``slots`` (B,)), dropping rows
    past the cache end; in place, returns ``cache``."""
    T = rows.shape[3]
    if T > 8:
        raise ValueError(f"span writer takes at most 8 rows, got {T}")
    if not cache.is_cuda:
        return kv_write_span_batch_plain(cache, rows, slots)
    return _launch(NAME_SPAN, cache, rows, slots, T)


def kv_write_span_pair_plain(
    keys: torch.Tensor, values: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
    slots: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`kv_write_span_batch_plain` of the K rows into ``keys``, then of
    the V rows into ``values``."""
    return (kv_write_span_batch_plain(keys, k_rows, slots),
            kv_write_span_batch_plain(values, v_rows, slots))


def kv_write_span_pair(
    keys: torch.Tensor, values: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
    slots: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 for both caches in one launch: lane b's ``T`` <= 8 rows of
    ``k_rows`` and ``v_rows`` (L, B, Hkv, T, D) into ``keys`` and ``values``
    (L, B, Hkv, S, D) at ``slots[b] .. slots[b] + T - 1`` (int32 (B,)),
    dropping rows outside [0, S); in place, returns (keys, values)."""
    T = k_rows.shape[3]
    if T > 8:
        raise ValueError(f"span writer takes at most 8 rows, got {T}")
    if not keys.is_cuda:
        return kv_write_span_pair_plain(keys, values, k_rows, v_rows, slots)
    if values.shape != keys.shape:
        raise ValueError(f"values {tuple(values.shape)} and keys {tuple(keys.shape)} differ")
    _check(keys, k_rows, slots, T)
    _check(values, v_rows, slots, T)
    L, B, H, S, _ = keys.shape
    err = _build.library().kv_write_span_pair_bf16(
        keys.data_ptr(), values.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
        slots.data_ptr(), L, B, H, T, S, _build.stream_ptr(keys),
    )
    _build.check(err, NAME_SPAN)
    _build.count(NAME_SPAN)
    return keys, values


def kv_write_rows_q8_plain(cache: dict, rows: torch.Tensor, slots: torch.Tensor) -> dict:
    """Quantize ``rows`` per row and write ``q`` and ``s`` at ``slots[b]``."""
    qr = quantize_kv(rows)
    kv_write_rows_plain(cache["q"], qr["q"], slots)
    kv_write_rows_plain(cache["s"][..., None], qr["s"][..., None], slots)
    return cache


def _check_q8(cache: dict, rows: torch.Tensor, slots: torch.Tensor) -> None:
    cq, cs = cache["q"], cache["s"]
    if cq.dim() != 5 or cq.dtype != torch.int8:
        raise TypeError("cache['q'] must be int8 (L, B, Hkv, S, D)")
    L, B, H, S, D = cq.shape
    if tuple(cs.shape) != (L, B, H, S) or cs.dtype != torch.float32:
        raise TypeError(f"cache['s'] must be f32 {(L, B, H, S)}")
    if tuple(rows.shape) != (L, B, H, 1, D) or rows.dtype != torch.bfloat16:
        raise ValueError(f"rows must be bf16 {(L, B, H, 1, D)}")
    if D != 128:
        raise ValueError(f"head_dim must be 128, got {D}")
    if slots.dtype != torch.int32 or tuple(slots.shape) != (B,):
        raise ValueError("slots must be int32 (B,)")
    for name, t in (("cache['s']", cs), ("rows", rows), ("slots", slots)):
        if t.device != cq.device:
            raise ValueError(f"{name} is on {t.device}, cache on {cq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not cq.is_contiguous():
        raise ValueError("cache['q'] must be contiguous")


def kv_write_rows_q8(cache: dict, rows: torch.Tensor, slots: torch.Tensor) -> dict:
    """Quantize the bf16 ``rows`` (L, B, Hkv, 1, D) per row and store them
    in the int8 cache ``{"q", "s"}`` at lane b's ``slots[b]`` (int32, (B,));
    in place, returns ``cache``."""
    if not cache["q"].is_cuda:
        return kv_write_rows_q8_plain(cache, rows, slots)
    _check_q8(cache, rows, slots)
    L, B, H, S, _ = cache["q"].shape
    err = _build.library().kv_write_rows_q8(
        cache["q"].data_ptr(), cache["s"].data_ptr(), rows.data_ptr(),
        slots.data_ptr(), L, B, H, S, _build.stream_ptr(rows),
    )
    _build.check(err, NAME_Q8)
    _build.count(NAME_Q8)
    return cache


NAME_PAGED = "kv_write_rows_paged"
NAME_PAGED_Q8 = "kv_write_rows_paged_q8"


def paged_indices(
    pages: torch.Tensor, offsets: torch.Tensor, n_pages: int, page_size: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat row, page, offset) of the rows that land: row ``b * T + t``
    goes to ``clip(pages[b, t], 0, n_pages - 1)`` at ``offsets[b, t]`` unless
    the offset lies outside [0, page_size).  Syncs with the device; the
    byte counts of the card checks use it, the writers do not."""
    p = pages.reshape(-1).long().clamp(0, n_pages - 1)
    o = offsets.reshape(-1).long()
    (keep,) = torch.nonzero((o >= 0) & (o < page_size), as_tuple=True)
    return keep, p[keep], o[keep]


def kv_write_rows_paged_plain(
    pool: torch.Tensor, rows: torch.Tensor, pages: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """pool[:, pages[b, t], :, offsets[b, t], :] = rows[:, b, :, t, :] (pages
    clipped, out-of-page offsets dropped) as one ``index_put_``.  No device
    sync: a dropped row repeats the first kept row's write, or, when no row
    is kept, writes the pool's own value at its offset clamped into the
    page."""
    L, B, H, T, D = rows.shape
    n = B * T
    p = pages.reshape(-1).to(device=pool.device, dtype=torch.long).clamp(0, pool.shape[1] - 1)
    o = offsets.reshape(-1).to(device=pool.device, dtype=torch.long)
    keep = (o >= 0) & (o < pool.shape[3])
    some = keep.any()
    own = torch.arange(n, device=pool.device)
    src = torch.where(keep | ~some, own, keep.to(torch.uint8).argmax())
    p, o = p[src], o[src].clamp(0, pool.shape[3] - 1)
    flat = rows.permute(1, 3, 0, 2, 4).reshape(n, L, H, D)[src].to(pool.dtype)
    pool[:, p, :, o] = torch.where((keep | some)[:, None, None, None], flat, pool[:, p, :, o])
    return pool


def _paged_shape(pool: torch.Tensor, rows: torch.Tensor, pages, offsets, pool_dtype) -> int:
    if pool.dim() != 5 or pool.dtype != pool_dtype:
        raise TypeError(f"pool must be {pool_dtype} (L, n_pages, Hkv, PS, D)")
    L, _, H, _, D = pool.shape
    if rows.dim() != 5 or (rows.shape[0], rows.shape[2], rows.shape[4]) != (L, H, D):
        raise ValueError(f"rows shape {tuple(rows.shape)} is not ({L}, B, {H}, T, {D})")
    B, T = rows.shape[1], rows.shape[3]
    if rows.dtype != torch.bfloat16:
        raise TypeError("rows must be bfloat16")
    if D != 128:
        raise ValueError(f"head_dim must be 128, got {D}")
    for name, t in (("pages", pages), ("offsets", offsets)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, T):
            raise ValueError(f"{name} must be int32 {(B, T)}")
    for name, t in (("rows", rows), ("pages", pages), ("offsets", offsets)):
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on {pool.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    return T


def _as_bt(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B,) per-lane pages or offsets of a one-row write as (B, 1)."""
    return x.reshape(rows.shape[1], rows.shape[3])


def kv_write_rows_paged(
    pool: torch.Tensor, rows: torch.Tensor, pages: torch.Tensor, offsets: torch.Tensor
) -> torch.Tensor:
    """K8: write ``rows`` (L, B, Hkv, T, D) into the page pool ``pool`` (L,
    n_pages, Hkv, PS, D) at ``pages``/``offsets`` (int32 (B, T), or (B,) for
    T = 1); in place, returns ``pool``."""
    pages, offsets = _as_bt(pages, rows), _as_bt(offsets, rows)
    if not pool.is_cuda:
        return kv_write_rows_paged_plain(pool, rows, pages, offsets)
    T = _paged_shape(pool, rows, pages, offsets, torch.bfloat16)
    L, n_pages, H, PS, _ = pool.shape
    err = _build.library().kv_write_rows_paged_bf16(
        pool.data_ptr(), rows.data_ptr(), pages.data_ptr(), offsets.data_ptr(),
        L, rows.shape[1], H, T, n_pages, PS, _build.stream_ptr(pool),
    )
    _build.check(err, NAME_PAGED)
    _build.count(NAME_PAGED)
    return pool


def kv_write_rows_paged_q8_plain(
    pool: dict, rows: torch.Tensor, pages: torch.Tensor, offsets: torch.Tensor
) -> dict:
    """``quantize_kv`` of the rows, then :func:`kv_write_rows_paged_plain`
    of the int8 rows and of their scales."""
    qr = quantize_kv(rows)
    kv_write_rows_paged_plain(pool["q"], qr["q"], pages, offsets)
    kv_write_rows_paged_plain(pool["s"][..., None], qr["s"][..., None], pages, offsets)
    return pool


def kv_write_rows_paged_q8(
    pool: dict, rows: torch.Tensor, pages: torch.Tensor, offsets: torch.Tensor
) -> dict:
    """K8 on the int8 pool ``{"q": int8 (L, n_pages, Hkv, PS, D), "s": f32
    (L, n_pages, Hkv, PS)}``: quantize each bf16 row of ``rows`` and store
    the int8 row and its scale, one launch; in place, returns ``pool``."""
    pages, offsets = _as_bt(pages, rows), _as_bt(offsets, rows)
    if not pool["q"].is_cuda:
        return kv_write_rows_paged_q8_plain(pool, rows, pages, offsets)
    pq, ps = pool["q"], pool["s"]
    T = _paged_shape(pq, rows, pages, offsets, torch.int8)
    L, n_pages, H, PS, _ = pq.shape
    if tuple(ps.shape) != (L, n_pages, H, PS) or ps.dtype != torch.float32:
        raise TypeError(f"pool['s'] must be f32 {(L, n_pages, H, PS)}")
    if ps.device != pq.device or not ps.is_contiguous():
        raise ValueError(f"pool['s'] must be contiguous on {pq.device}")
    err = _build.library().kv_write_rows_paged_q8(
        pq.data_ptr(), ps.data_ptr(), rows.data_ptr(), pages.data_ptr(),
        offsets.data_ptr(), L, rows.shape[1], H, T, n_pages, PS, _build.stream_ptr(pq),
    )
    _build.check(err, NAME_PAGED_Q8)
    _build.count(NAME_PAGED_Q8)
    return pool
