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
a buffer of the arena drops every captured graph.

Kernel launches are counted on the host when a wrapper runs
(``ops/kernels/_build.py`` ``LAUNCHES``).  During a capture nothing runs
and during a replay no wrapper runs, so what the capturing thread's
wrappers count goes aside (``_build.diverted``; other threads, such as a
second replica's on the same card, count as usual) and each replay adds it
(:class:`StepGraph`).  A replay runs its kernels whether or not a lane is
still live: the steps after every lane is done are no-ops on the visible
state (the JAX package's fixed-K programs rely on the same,
``generate.py:628-633``), and their launches are counted.

No fallback: a failed capture or replay raises.

A generator on a tensor-parallel group (``Generator(..., tp=...)``) builds
no :class:`DecodeGraphs`: its steps call collectives, which a capture cannot
hold under gloo, and capturing NCCL's is later work (ROADMAP.md Queue 1,
item 5 (c)); its loop runs the same step eagerly in the same blocks.  Under
dp alone nothing crosses ranks inside a decode, and the graphs stay.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from collections.abc import Callable
from math import prod

import torch

from ..ops.kernels import _build

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
               ahead: bool = False) -> tuple[int, int]:
    """Call ``step(i)`` for i = 0, 1, ... in blocks of ``block`` until every
    lane of ``done`` is set, looking at ``done`` once before the first block
    and once per block.  With ``ahead`` (CUDA), each block's ``done`` is
    copied to pinned host memory without waiting, and the copy of the
    block before is read while the block runs, so the host stays one block
    ahead of the device.  Returns (steps run, looks at ``done``)."""
    looks = 1
    if bool(done.all()):
        return 0, looks
    n = 0
    if not ahead:
        while True:
            for _ in range(block):
                step(n)
                n += 1
            looks += 1
            if bool(done.all()):
                return n, looks
    host = [torch.empty(done.shape, dtype=torch.bool, pin_memory=True) for _ in range(2)]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    prev = None
    while True:
        for _ in range(block):
            step(n)
            n += 1
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


class StepGraph:
    """A captured step: :meth:`replay` launches it and adds the launches
    its capture counted."""

    def __init__(self, graph, launches: Counter) -> None:
        self.graph = graph
        self.launches = launches

    def replay(self, _i: int = 0) -> None:
        self.graph.replay()
        _build.add_launches(self.launches)


class DecodeGraphs:
    """The captured decode steps of one :class:`~.generate.Generator` on one
    device, by bucket, with the arena their KV caches live in and the one
    memory pool every capture shares (the graphs replay one at a time on
    the device's current stream)."""

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
        #: Times a buffer of the arena grew (each drops every graph).
        self.growths = 0
        self._pool = None
        self._stream: torch.cuda.Stream | None = None

    def view(self, name: str, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """A contiguous ``dtype`` tensor of ``shape`` at the base of the arena
        buffer ``name``, which grows (dropping every graph) when too small."""
        nbytes = prod(shape) * dtype.itemsize
        buf = self.buffers.get(name)
        if buf is None or buf.numel() < nbytes:
            self.entries.clear()
            self.buffers.pop(name, None)
            del buf
            self.buffers[name] = buf = torch.empty(nbytes, dtype=torch.uint8,
                                                   device=self.device)
            self.growths += 1
        return buf[:nbytes].view(dtype).view(shape)

    def get(self, key: tuple):
        """(static tensors, :class:`StepGraph`) of bucket ``key``, or None."""
        return self.entries.get(key)

    def capture(self, key: tuple, statics, step: Callable[[], None],
                generator: torch.Generator | None = None) -> StepGraph:
        """Warm ``step`` up once on a side stream (allocator, cuBLAS, the
        kernels' lazily made buffers), then capture it as bucket ``key``'s
        graph, with ``generator`` registered so that each replay draws fresh
        numbers.  ``statics`` are the tensors the step reads and writes; the
        warm-up step changes them, and the caller fills them anew."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)

        def capture():
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                step()

        with _capture_lock(self.device):
            t0 = time.perf_counter()
            launches = record_launches(capture)
            # The capture stream, not the device (see _capture_locks).
            stream.synchronize()
        self.last_capture_ms = (time.perf_counter() - t0) * 1e3
        self.captures += 1
        entry = StepGraph(graph, launches)
        self.entries[key] = (statics, entry)
        return entry

    def close(self) -> None:
        """Free the graphs, their memory pool and the arena."""
        self.entries.clear()
        self.buffers.clear()
        self._pool = self._stream = None
