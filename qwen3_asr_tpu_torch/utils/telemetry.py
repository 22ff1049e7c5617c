"""Per-request timing record and logging.

Counterpart of ``qwen3_asr_tpu/utils/telemetry.py`` without JAX:
``RequestStats`` and ``logger`` are the same; ``stage_timer`` wraps each
stage in ``torch.profiler.record_function`` so the same span names appear
on a ``torch.profiler`` timeline, which :func:`profile_trace` records (the
JAX package's records an XLA trace).  Stage times are host wall clock: a stage
that ends in a device sync (the decode loop's per-step ``done`` read, the
final token copy) includes its device work, an asynchronous one does not.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

logger = logging.getLogger("qwen3_asr_tpu_torch")


@dataclass
class RequestStats:
    """Timing/throughput record for one transcription request."""

    audio_seconds: float = 0.0
    n_prompt_tokens: int = 0
    n_generated_tokens: int = 0
    #: Decode-loop iterations (forward passes of the whole batch; verify
    #: iterations in the speculative loop).
    n_decode_steps: int = 0
    #: Decode steps run, the no-op steps after the last lane finished
    #: included (graph replays on CUDA), and the looks at the lanes' done
    #: flags (host syncs) of the decode loop.
    n_decode_replays: int = 0
    n_host_syncs: int = 0
    #: Verify lane-forwards of the speculative loop (0 = plain decode):
    #: iterations x real lanes, since the batch runs in lockstep.  tokens /
    #: forwards is the realized tokens per lane-forward (ceiling gamma+1).
    n_spec_forwards: int = 0
    stages: dict[str, float] = field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return sum(self.stages.values())

    @property
    def rtfx(self) -> float:
        """Real-time factor: audio seconds processed per wall second."""
        t = self.total_seconds
        return self.audio_seconds / t if t > 0 else 0.0

    @property
    def decode_tokens_per_second(self) -> float:
        t = self.stages.get("decode", 0.0)
        return self.n_generated_tokens / t if t > 0 else 0.0

    @property
    def spec_tokens_per_forward(self) -> float:
        """Realized speculative acceptance (tokens per verify lane-forward)."""
        return (
            self.n_generated_tokens / self.n_spec_forwards
            if self.n_spec_forwards
            else 0.0
        )

    def as_dict(self) -> dict:
        out = {
            "audio_seconds": round(self.audio_seconds, 4),
            "n_prompt_tokens": self.n_prompt_tokens,
            "n_generated_tokens": self.n_generated_tokens,
            "n_decode_steps": self.n_decode_steps,
            "n_decode_replays": self.n_decode_replays,
            "n_host_syncs": self.n_host_syncs,
            "total_seconds": round(self.total_seconds, 4),
            "rtfx": round(self.rtfx, 2),
            "decode_tokens_per_second": round(self.decode_tokens_per_second, 1),
            **{f"stage_{k}_seconds": round(v, 4) for k, v in self.stages.items()},
        }
        if self.n_spec_forwards:
            out["n_spec_forwards"] = self.n_spec_forwards
            out["spec_tokens_per_forward"] = round(self.spec_tokens_per_forward, 2)
        return out


@contextlib.contextmanager
def stage_timer(stats: RequestStats | None, name: str):
    """Accumulate wall time for a named stage + profiler span."""
    with torch.profiler.record_function(f"qwen3_asr/{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if stats is not None:
                stats.stages[name] = stats.stages.get(name, 0.0) + (
                    time.perf_counter() - t0
                )


@contextlib.contextmanager
def profile_trace(log_dir: str | Path):
    """Record a ``torch.profiler`` trace of the enclosed block: CPU activity
    and, where a CUDA device is present, the device's kernels and copies,
    with the ``qwen3_asr/<stage>`` spans of :func:`stage_timer`.  On exit
    the trace is written under ``log_dir`` (made if missing) as a Chrome
    trace, ``trace_<pid>_<time>.json``, for ``chrome://tracing`` or
    Perfetto.  Yields the profiler, whose ``key_averages()`` summarises the
    block by operation."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities, record_shapes=False)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        logger.info("profile trace written to %s", path)
