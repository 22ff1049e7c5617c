"""The tensor-parallel collectives (Megatron), called explicitly.

In the JAX package GSPMD inserts these from the sharding annotations
(``qwen3_asr_tpu/parallel/sharding.py``); here each rank calls them:

  * :func:`copy_to_tp` -- identity forward, all-reduce backward: the input
    of a column-parallel product, whose gradient sums over the shards;
  * :func:`reduce_from_tp` -- all-reduce forward, identity backward: the
    output of a row-parallel product (partial sums over K-slices);
  * :func:`gather_from_tp` -- all-gather along a dim forward, this rank's
    slice backward: vocab-sharded logits, a column-split output that the
    next op needs whole;
  * :func:`vocab_parallel_embed` -- the lookup into a vocab-sharded table:
    ids outside this shard look up zeros, and the sum over the shards is
    the row;
  * :func:`all_reduce_max` -- the row abs-max of a row-parallel W8A8
    product, so its activation scales are the whole row's.

Each of the first three is a ``torch.autograd.Function``, so a training step
can run through them (``torch.distributed.nn.functional.all_reduce`` would
all-reduce the gradient of a forward all-reduce too, which is wrong for a
row-parallel product).  Under gloo a CUDA tensor goes through host memory
(f32 for 16-bit floats), so ranks that share one card can run a mesh.
Under NCCL every collective runs on the device (:func:`on_device`), so a
CUDA graph can capture it (``runtime/graphs.py``): the wrappers wait for
nothing on the host, and :func:`all_gather` writes one buffer.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TP:
    """A tensor-parallel group seen from one rank: ``size`` ranks, this
    one's ``rank`` among them, the process ``group``.  Models take it as
    ``tp``; ``None`` means one device and today's code unchanged."""

    size: int
    rank: int
    group: object

    def shard(self, n: int, what: str) -> int:
        """``n / size``, or ValueError naming ``what`` when tp does not
        divide it."""
        if n % self.size:
            raise ValueError(f"tp={self.size} does not divide {what} ({n})")
        return n // self.size


#: The collectives this process has called and the bytes it handed them:
#: ``"all_reduce"``/``"all_gather"``/``"broadcast"`` calls and
#: ``"<kind> bytes"``.  A plain count (no device sync); readers reset it
#: with ``clear()``.  A CUDA-graph replay calls no wrapper: the graph adds
#: what its capture counted (:func:`diverted`, :func:`add_traffic`).
TRAFFIC: collections.Counter = collections.Counter()

_sink = threading.local()
#: Diverting counters by CUDA stream handle (:func:`diverted`'s ``stream``).
_stream_sinks: dict[int, collections.Counter] = {}
_traffic_lock = threading.Lock()


def _count(kind: str, t: torch.Tensor) -> None:
    counted = {kind: 1, f"{kind} bytes": t.numel() * t.element_size()}
    sink = getattr(_sink, "counter", None)
    if sink is None and _stream_sinks and t.is_cuda:
        sink = _stream_sinks.get(torch.cuda.current_stream(t.device).cuda_stream)
    if sink is not None:
        sink.update(counted)
        return
    add_traffic(counted)


def diverted(fn, stream: torch.cuda.Stream | None = None) -> collections.Counter:
    """Run ``fn`` and return the traffic this thread's collectives counted
    meanwhile, which :data:`TRAFFIC` does not see (a CUDA-graph capture,
    during which nothing runs), and with ``stream`` also what any thread
    counted on that stream (autograd runs a capture's backward, and its
    collectives, on a device thread of its own).  Other threads count as
    usual."""
    prev = getattr(_sink, "counter", None)
    _sink.counter = counted = collections.Counter()
    if stream is not None:
        _stream_sinks[stream.cuda_stream] = counted
    try:
        fn()
    finally:
        _sink.counter = prev
        if stream is not None:
            _stream_sinks.pop(stream.cuda_stream, None)
    return counted


def add_traffic(counted) -> None:
    """Add ``counted`` to :data:`TRAFFIC` (a graph replay's collectives)."""
    with _traffic_lock:
        TRAFFIC.update(counted)


def on_device(group) -> bool:
    """Whether ``group``'s collectives run on the device (NCCL), where a
    CUDA graph can capture them; gloo's go through host memory."""
    return dist.get_backend(group) == "nccl"


def _host_path(t: torch.Tensor, group) -> bool:
    return t.is_cuda and not on_device(group)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` for gloo (16-bit floats widened to f32)."""
    wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
    return t.to("cpu", wide)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over ``group`` and return it."""
    _count("all_reduce", t)
    if _host_path(t, group):
        host = _staged(t)
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of the first rank of ``group``, in place in every rank's
    ``t``; returns it."""
    _count("broadcast", t)
    src = dist.get_global_rank(group, 0)
    if _host_path(t, group):
        host = _staged(t)
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in rank
    order."""
    _count("all_gather", t)
    size = dist.get_world_size(group)
    t = t.contiguous()
    if on_device(group):
        out = torch.empty((size, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return torch.cat(out.unbind(0), dim=dim)
    host = _staged(t) if t.is_cuda else t
    parts = [torch.empty_like(host) for _ in range(size)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim=dim).to(t.device, t.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_(x.clone(), tp.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather(x, tp.group, dim)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        return grad.chunk(tp.size, dim=ctx.dim)[tp.rank].contiguous(), None, None


def copy_to_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: TP, dim: int = -1) -> torch.Tensor:
    return _GatherFromTP.apply(x, tp, dim % x.dim())


def vocab_parallel_embed(ids: torch.Tensor, lookup, vocab_shard: int, tp: TP) -> torch.Tensor:
    """Rows of a vocab-sharded table: ``lookup(local_ids)`` (..., H) on this
    shard's rows ``[rank * vocab_shard, (rank + 1) * vocab_shard)``, zeros
    for the ids outside it, summed over the shards (one shard holds each
    id, so the sum is exact)."""
    lo = tp.rank * vocab_shard
    mine = (ids >= lo) & (ids < lo + vocab_shard)
    rows = lookup(torch.where(mine, ids - lo, torch.zeros_like(ids)))
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    return reduce_from_tp(rows, tp)


def all_reduce_max(t: torch.Tensor, tp: TP) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the tp group, in place."""
    return all_reduce_(t, tp.group, dist.ReduceOp.MAX)
