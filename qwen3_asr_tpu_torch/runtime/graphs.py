"""CUDA graphs of the offline decode loops: the counterpart of the JAX
package's ``jax.jit`` program cache (``qwen3_asr_tpu/runtime/generate.py``
:59-141, one compiled ``lax.while_loop`` per bucket, sampling parameters
traced).

A decode step, or a verify iteration of the speculative loop, is captured
once per bucket as a CUDA graph (:class:`DecodeGraphs`), and the host then
replays that graph in blocks of :data:`BLOCK` steps, looking at the lanes'
``done`` flags once per block (:func:`run_blocks`) where the eager loop
waits for the device once per token.  A bucket is (B, S, token_bucket,
mode, rep_window, k_subset, cache dtype, spec (gamma, n) or None, decode
kernel mode, KV writer: a graph captured under mode "0" holds the plain
attention, one under the "xla" writer the plain writers); the
sampling values are device tensors that the graph reads, so changing them
reuses the bucket's graph.

A graph bakes in the pointers it was captured with.  Everything a step
reads therefore lives in buffers that outlive it: the step's state and the
request's values are static tensors of the bucket's entry, which each call
fills before its first replay, and the KV cache is a view at the base of
the arena (:meth:`DecodeGraphs.view`, one flat buffer per cache tensor),
whatever the bucket, so every graph sees the same cache pointers.  The
prefill and the int8 cache's quantization write into those views.  Growing
a buffer of the arena drops every captured graph (any may hold its
pointers); adding a buffer of a new name drops none (none can), so the
live sessions' advance (``Generator.advance``, views of names of its own)
and the decode loop keep each other's graphs.

Kernel launches are counted on the host when a wrapper runs
(``ops/kernels/_build.py`` ``LAUNCHES``), and so are the tp collectives
(``parallel/collectives.py`` ``TRAFFIC``).  During a capture nothing runs
and during a replay no wrapper runs, so what the capturing thread's
wrappers count goes aside (``_build.diverted``, ``collectives.diverted``;
the collectives of any thread on the capture stream too, such as the
autograd thread that runs a captured train step's backward; other threads,
such as a second replica's on the same card, count as usual) and each
replay adds it (:class:`StepGraph`).  A replay runs its
kernels whether or not a lane is still live: the steps after every lane is
done are no-ops on the visible state (the JAX package's fixed-K programs
rely on the same, ``generate.py:628-633``), and their launches and
collectives are counted.

No fallback: a failed capture or replay raises.

On a tensor-parallel group (``Generator(..., tp=...)``) whose backend is
NCCL, each rank captures the same steps with the group's collectives
inside them, the counterpart of the JAX package's one SPMD program with
its collectives (``qwen3_asr_tpu/api.py:141-149``).  The ranks stay in
lockstep because every host decision reads values that are bit-identical
in every rank: the logits are gathered whole before any token is chosen,
each sampled call seeds every rank's generator alike, so the ``done``
flags agree and every rank captures the same buckets in the same order and
replays the same blocks.  A rank that decided otherwise would wait in a
collective for ever; nothing here can detect it.  The capture's warm-up
step runs the collectives for real, so every rank reaches it together.  A
gloo group runs the same step eagerly in the same blocks
(``Generator._capturable``): its collectives stage through host memory,
which a capture cannot hold.  Under dp alone nothing crosses ranks inside
a decode, and the graphs are one device's.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from collections.abc import Callable
from math import prod

import torch

from ..ops.kernels import _build
from ..parallel import collectives

#: Replays of the step graph between two looks at ``done``.  Measured on an
#: H100 at 1, 4, 8 and 16 (``tools/torch_decode_profile.py --blocks``,
#: PERF.md): a replay costs the same at every block size, since the host
#: stays one block ahead, so the no-op steps of the last blocks decide (1,
#: 5, 9 and 17 on a 63-step decode).  4 keeps a look per block, not per
#: step, and four steps queued ahead of a host thread that may wake late,
#: for 6% more than 1 on a 64-token decode.
BLOCK = 4


#: One lock per device index: captures on one device run one at a time.
#: ``torch.cuda.graph`` synchronizes the device as it begins, which would
#: break a capture that another thread (a second replica on the same card)
#: has under way; the other thread's kernels and replays run on meanwhile.
_capture_locks: dict[int | None, threading.Lock] = {}
_capture_locks_lock = threading.Lock()


def _capture_lock(device: torch.device) -> threading.Lock:
    with _capture_locks_lock:
        return _capture_locks.setdefault(device.index, threading.Lock())


def run_blocks(step: Callable[[int], None], done: torch.Tensor, block: int,
               ahead: bool = False, cap: int | None = None) -> tuple[int, int]:
    """Call ``step(i)`` for i = 0, 1, ... in blocks of ``block`` until every
    lane of ``done`` is set, looking at ``done`` once before the first block
    and once per block, or until ``cap`` steps have run (the last block cut
    short to end there, with no look after it).  With ``ahead`` (CUDA), each
    block's ``done`` is copied to pinned host memory without waiting, and
    the copy of the block before is read while the block runs, so the host
    stays one block ahead of the device.  Returns (steps run, looks at
    ``done``)."""
    looks = 1
    if bool(done.all()):
        return 0, looks
    limit = cap if cap is not None else float("inf")
    n = 0
    if not ahead:
        while True:
            for _ in range(min(block, limit - n)):
                step(n)
                n += 1
            if n >= limit:
                return n, looks
            looks += 1
            if bool(done.all()):
                return n, looks
    host = [torch.empty(done.shape, dtype=torch.bool, pin_memory=True) for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    prev = None
    while True:
        for _ in range(min(block, limit - n)):
            step(n)
            n += 1
        if n >= limit:
            return n, looks
        cur = (n // block) % 2
        host[cur].copy_(done, non_blocking=True)
        copied[cur].record()
        if prev is not None:
            copied[prev].synchronize()
            looks += 1
            if bool(host[prev].all()):
                return n, looks
        prev = cur


def record_launches(capture: Callable[[], None]) -> Counter:
    """Run ``capture`` and return the kernel launches its wrappers counted,
    which ``LAUNCHES`` does not see: nothing ran."""
    return _build.diverted(capture)


def record(capture: Callable[[], None],
           stream: torch.cuda.Stream | None = None) -> tuple[Counter, Counter]:
    """Run ``capture`` and return (kernel launches, collectives) that its
    wrappers counted, which neither ``LAUNCHES`` nor ``TRAFFIC`` sees; the
    collectives also of any thread on the capture ``stream`` (a backward's,
    ``collectives.diverted``)."""
    launches = Counter()

    def run():
        launches.update(record_launches(capture))

    return launches, collectives.diverted(run, stream)


class StepGraph:
    """A captured step: :meth:`replay` launches it and adds the launches
    and the collectives its capture counted."""

    def __init__(self, graph, launches: Counter, traffic: Counter | None = None) -> None:
        self.graph = graph
        self.launches = launches
        self.traffic = traffic or Counter()

    def replay(self, _i: int = 0) -> None:
        self.graph.replay()
        _build.add_launches(self.launches)
        collectives.add_traffic(self.traffic)


class DecodeGraphs:
    """The captured decode steps of one :class:`~.generate.Generator` on one
    device, by bucket, with the arena their KV caches live in and the one
    memory pool every capture shares (the graphs replay one at a time on
    the device's current stream).  A :class:`~.engine.DecodeEngine` keeps
    its chunk iterations here and ``training.train.TrainStep`` its train
    steps, one entry per batch shape, without the arena."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        #: bucket key -> (the entry's static tensors, :class:`StepGraph`).
        self.entries: dict[tuple, tuple[object, StepGraph]] = {}
        #: Arena buffers by name (flat uint8), grown on demand.
        self.buffers: dict[str, torch.Tensor] = {}
        #: Graphs captured, and the milliseconds the last capture took (its
        #: warm-up step excluded).
        self.captures = 0
        self.last_capture_ms = 0.0
        #: Times a buffer of the arena grew (each drops every graph; a
        #: buffer of a new name is no growth).
        self.growths = 0
        self._pool = None
        self._stream: torch.cuda.Stream | None = None

    def view(self, name: str, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """A contiguous ``dtype`` tensor of ``shape`` at the base of the arena
        buffer ``name``, made at first use and grown (dropping every graph,
        which may hold its old pointers) when too small."""
        nbytes = prod(shape) * dtype.itemsize
        buf = self.buffers.get(name)
        if buf is None or buf.numel() < nbytes:
            if buf is not None:
                self.entries.clear()
                self.growths += 1
                del self.buffers[name]
                del buf
            self.buffers[name] = buf = torch.empty(nbytes, dtype=torch.uint8,
                                                   device=self.device)
        return buf[:nbytes].view(dtype).view(shape)

    def get(self, key: tuple):
        """(static tensors, :class:`StepGraph`) of bucket ``key``, or None."""
        return self.entries.get(key)

    def _side(self) -> torch.cuda.Stream:
        """The side stream captures run on, made with the shared pool."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def warm(self, step: Callable[[], None]) -> None:
        """Run ``step`` once on the side stream that captures run on, after
        the current stream's work and before its next (PyTorch's rule for a
        step that is to be captured: the allocator, cuBLAS and the kernels'
        lazily made buffers settle off the capture)."""
        stream = self._side()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream(self.device).wait_stream(stream)

    def capture(self, key: tuple, statics, step: Callable[[], None],
                generator: torch.Generator | None = None, warm: bool = True) -> StepGraph:
        """Warm ``step`` up once (:meth:`warm`; ``warm=False``: the caller
        ran its warm-up step already), then capture it as bucket ``key``'s
        graph, with ``generator`` registered so that each replay draws fresh
        numbers.  ``statics`` are the tensors the step reads and writes; the
        warm-up step changes them, and the caller fills them anew.  On a tp
        group the warm-up step's collectives run, and count, in every rank;
        the capture's are counted per replay."""
        if warm:
            self.warm(step)
        stream = self._side()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)

        def capture():
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                step()

        with _capture_lock(self.device):
            t0 = time.perf_counter()
            launches, traffic = record(capture, stream)
            # The capture stream, not the device (see _capture_locks).
            stream.synchronize()
        self.last_capture_ms = (time.perf_counter() - t0) * 1e3
        self.captures += 1
        entry = StepGraph(graph, launches, traffic)
        self.entries[key] = (statics, entry)
        return entry

    def close(self) -> None:
        """Free the graphs, their memory pool and the arena."""
        self.entries.clear()
        self.buffers.clear()
        self._pool = self._stream = None
