"""K11d: one-token decode attention over a precomputed block schedule.

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/decode_attention_sched.py:
decode_attention_sched`` and its schedule function ``build_decode_schedule``.
K2's function with per-lane decode ends: cache row s of lane b is valid when
``s < prompt_len[b]`` or ``prompt_bucket <= s < decode_end[b]``, and the
step's fresh ``k_new``/``v_new`` row is folded in as a self-term.  Both
cache regions must tile by 128 rows.

:func:`build_decode_schedule` turns the lanes' geometry into a flat list of
128-row blocks per "core", in lane order: the owning lane, the row offset,
the mask limit (prompt blocks: ``prompt_len``; decode blocks: the decode
end) and first/last-of-lane flags.  It is a handful of tensor ops on the
(B,) vectors, built on the device once per decode step and shared by every
layer (pass it as ``schedule=``; when None the wrapper builds it inline).

Idle lanes: ``prompt_len`` is clamped to ``[1, prompt_bucket]`` (as the JAX
schedule function does, :101, so that every live lane owns a block), so a lane with
``prompt_len`` 0 attends cache row 0 as well as its fresh row.  K2 and
K11a/K11b give such a lane its fresh row alone; the kernel, the plain
version and the Pallas kernel here agree with each other.

Bound on the H100: bytes.  The CUDA kernel (``csrc/decode_attention_sched.cu``
over ``csrc/decode_pair_stream.cuh``) runs K11c's persistent stream, up to
one block per SM with the (lane, KV head) pairs balanced over the blocks by
tiles, and takes each lane's geometry from the schedule alone: every block
first reads each lane's two runs from the live entries (prompt rows below
the lim of its first entry, decode rows from the off of the entry whose lim
differs from its predecessor's, below that lim), then walks their 32-row
tiles, which are the tiles of the lane's entries whose first row is below
the entry's lim.  So the output is K11c's, bit for bit, on the schedule's
lengths.  ``cores`` and ``per_core`` (:func:`schedule_geometry`) say how the
list is laid out, not the grid; the kernel's table of runs holds
:data:`MAX_LANES` lanes.

The plain version rebuilds each lane's validity mask from the schedule's
live entries (rows ``[off, off + 128)`` of lane ``bl``, valid while ``row <
lim``) and applies K2's plain math under it, so a schedule fault shows on
the CPU too.  On a CUDA tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode_attention import _sm_count, masked_attention_plain
from .decode_attention_hbm2 import check

NAME = "decode_attention_sched"
#: Rows per schedule entry: both cache regions must be multiples.
BLOCK = 128
#: Flag bits of the schedule's ``flags``.
F_FIRST = 1
F_LAST = 2
#: SMs assumed for the schedule geometry of a CPU tensor (an H100's).
H100_SMS = 132
#: Lanes the CUDA kernel's shared table of runs holds.
MAX_LANES = 1024


def schedule_geometry(B: int, hkv: int, sm_count: int) -> tuple[int, int]:
    """(cores, per_core) for the H100: as many cores as keep one (core, KV
    head) block per SM, at most one per lane -- ``min(B, max(1, SMs //
    Hkv))`` -- with ``per_core = cdiv(B, cores)`` lanes each; cores left
    with no lane by that rounding are dropped."""
    cores = min(B, max(1, sm_count // hkv))
    per_core = -(-B // cores)
    return -(-B // per_core), per_core


def lane_ends(decode_end, B: int, device) -> torch.Tensor:
    """``decode_end`` (an int, a 0-d or a (B,) tensor) as a (B,) tensor on
    ``device``."""
    if isinstance(decode_end, torch.Tensor):
        return decode_end.to(device).expand(B).contiguous()
    return torch.full((B,), int(decode_end), dtype=torch.int32, device=device)


def build_decode_schedule(
    prompt_len: torch.Tensor,   # (B,) int32
    decode_end,                 # int, 0-d or (B,) int32
    prompt_bucket: int,
    S: int,
    cores: int,
    per_core: int,
    B: int,
    block: int = BLOCK,
) -> tuple[torch.Tensor, ...]:
    """Flat per-core block schedules, equal to the JAX function's.

    Returns ``(totals (cores,), bl, off, lim, flags)``, the latter four
    ``(cores, J)`` int32 with ``J = per_core * (prompt_bucket // block +
    (S - prompt_bucket) // block)``, on ``prompt_len``'s device.  Entry j of
    core c: lane ``bl[c, j]`` (index within the core), rows ``[off, off +
    block)``, valid while ``row < lim``, plus first/last-of-lane flags.
    Lanes padded past B own no block; dead entries are zero."""
    device = prompt_len.device
    i32 = torch.int32
    b_pad = cores * per_core
    n_pb = prompt_bucket // block
    n_db = (S - prompt_bucket) // block
    J = per_core * (n_pb + n_db)

    plen = prompt_len.to(i32).clamp(1, prompt_bucket)
    plen = torch.cat([plen, torch.zeros(b_pad - B, dtype=i32, device=device)])
    dend = lane_ends(decode_end, B, device).to(i32)
    dend = torch.cat([dend, torch.full((b_pad - B,), prompt_bucket, dtype=i32, device=device)])

    n_p = (plen + block - 1) // block                              # (b_pad,)
    n_d = ((dend - prompt_bucket).clamp(0, S - prompt_bucket) + block - 1) // block
    tot = (n_p + n_d).reshape(cores, per_core)
    starts = torch.cumsum(tot, dim=1) - tot                        # exclusive
    totals = tot.sum(dim=1)

    j = torch.arange(J, device=device)
    # Owning lane: the last one whose start <= j (skips empty lanes, which
    # share their successor's start).
    bl = (starts[:, None, :] <= j[None, :, None]).sum(-1) - 1      # (cores, J)
    bl = bl.clamp(0, per_core - 1)

    def gather(a2):   # (cores, per_core) -> (cores, J) by lane
        return torch.gather(a2, 1, bl)

    i = j[None, :] - gather(starts)                                # local block index
    n_p2 = n_p.reshape(cores, per_core).long()
    is_p = i < gather(n_p2)
    off = torch.where(is_p, i * block, prompt_bucket + (i - gather(n_p2)) * block)
    lim = torch.where(is_p, gather(plen.reshape(cores, per_core).long()),
                      gather(dend.reshape(cores, per_core).long()))
    flags = torch.where(i == 0, F_FIRST, 0) | torch.where(i == gather(tot) - 1, F_LAST, 0)
    live = j[None, :] < totals[:, None]
    return (
        totals.to(i32),
        *(torch.where(live, x, 0).to(i32) for x in (bl, off, lim, flags)),
    )


def _per_core(schedule, S: int, block: int = BLOCK) -> int:
    """Lanes per core of a schedule built for cache length S."""
    J = schedule[1].shape[1]
    if S % block or J % (S // block):
        raise ValueError(f"schedule of {J} entries a core does not fit S={S}")
    return J // (S // block)


def schedule_mask(schedule, B: int, S: int, block: int = BLOCK) -> torch.Tensor:
    """(B, S) bool: the cache rows the schedule's live entries make valid
    (rows ``[off, off + block)`` of lane ``bl``, while ``row < lim``)."""
    totals, bl, off, lim, _ = schedule
    cores, J = bl.shape
    per_core = _per_core(schedule, S, block)
    device = bl.device
    rows = off.long()[..., None] + torch.arange(block, device=device)   # (cores, J, block)
    live = torch.arange(J, device=device)[None, :] < totals[:, None].long()
    valid = (rows < lim.long()[..., None]) & live[..., None]
    lane = torch.arange(cores, device=device)[:, None] * per_core + bl.long()
    hits = torch.zeros(cores * per_core, S, dtype=torch.int32, device=device)
    hits.index_put_((lane[..., None].expand_as(rows), rows.clamp(0, S - 1)),
                    valid.to(torch.int32), accumulate=True)
    return hits[:B] > 0


def decode_attention_sched_plain(q, kall, vall, k_new, v_new, layer: int, schedule,
                                 scale: float) -> torch.Tensor:
    """K2's plain math under the schedule's mask."""
    mask = schedule_mask(schedule, q.shape[0], kall.shape[3])
    return masked_attention_plain(q, kall[layer], vall[layer], k_new, v_new, mask, scale)


def _check_schedule(schedule, device, S: int) -> tuple[int, int]:
    """(cores, J) of a schedule the kernel can read: five int32 tensors,
    totals (cores,) and four (cores, J), contiguous on ``device``."""
    if len(schedule) != 5:
        raise ValueError("schedule must be (totals, bl, off, lim, flags)")
    totals = schedule[0]
    if totals.dim() != 1:
        raise ValueError("schedule totals must be (cores,)")
    cores = totals.shape[0]
    J = schedule[1].shape[-1] if schedule[1].dim() == 2 else -1
    for name, t, shape in zip(("totals", "bl", "off", "lim", "flags"), schedule,
                              [(cores,)] + [(cores, J)] * 4):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"schedule {name} must be int32 {shape}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"schedule {name} must be contiguous on {device}")
    _per_core(schedule, S)
    return cores, J


def check_ends(decode_end: torch.Tensor, q: torch.Tensor) -> None:
    """Per-lane decode ends as the kernels read them: int32 (B,), contiguous
    on q's device."""
    if decode_end.dtype != torch.int32 or tuple(decode_end.shape) != (q.shape[0],):
        raise ValueError("decode_end must be int32 (B,)")
    if decode_end.device != q.device or not decode_end.is_contiguous():
        raise ValueError(f"decode_end must be contiguous on {q.device}")


def decode_attention_sched(
    q: torch.Tensor,            # (B, Hq, D)
    kall: torch.Tensor,         # (L, B, Hkv, S, D)
    vall: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,   # (B,) int32
    decode_end,                 # int, or (B,) int32: per-lane decode end
    prompt_bucket: int,
    scale: float | None = None,
    schedule=None,
) -> torch.Tensor:
    """One-token attention of q over layer ``layer`` of the stacked cache plus
    the fresh row, walked as the schedule lists it.  Returns (B, Hq, D)."""
    B, _, D = q.shape
    hkv, S = kall.shape[2], kall.shape[3]
    if prompt_bucket % BLOCK or (S - prompt_bucket) % BLOCK:
        raise ValueError(
            f"cache regions ({prompt_bucket}, {S - prompt_bucket}) not tileable by {BLOCK}"
        )
    if scale is None:
        scale = D ** -0.5
    if q.is_cuda:
        check(q, kall, vall, k_new, v_new, layer, prompt_len, BLOCK)
        if B > MAX_LANES:
            raise ValueError(f"batch {B} exceeds the kernel's {MAX_LANES} lanes")
    if schedule is None:
        sms = _sm_count(q.device) if q.is_cuda else H100_SMS
        cores, per_core = schedule_geometry(B, hkv, sms)
        schedule = build_decode_schedule(prompt_len, decode_end, prompt_bucket, S,
                                         cores, per_core, B)
    if not q.is_cuda:
        return decode_attention_sched_plain(q, kall, vall, k_new, v_new, layer, schedule,
                                            scale)
    cores, J = _check_schedule(schedule, q.device, S)
    per_core = _per_core(schedule, S)
    if cores * per_core < B:
        raise ValueError(f"schedule covers {cores * per_core} lanes, batch is {B}")
    out = torch.empty_like(q)
    err = _build.library().decode_attention_sched_bf16(
        q.data_ptr(), kall.data_ptr(), vall.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), *(t.data_ptr() for t in schedule), out.data_ptr(),
        int(layer), B, q.shape[1], hkv, S, cores, per_core, J,
        min(B * hkv, _sm_count(q.device)), float(scale), _build.stream_ptr(q),
    )
    _build.check(err, NAME)
    _build.count(NAME)
    return out
