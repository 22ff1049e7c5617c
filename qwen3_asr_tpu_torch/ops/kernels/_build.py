"""Build and load the hand-written CUDA kernels (``qwen3_asr_tpu_torch/csrc``).

The ``.cu`` sources have a plain C interface (no PyTorch headers).  Each is
compiled by its own ``nvcc`` process, all started together, and one more
``nvcc`` links the objects into a shared library; seconds in all::

    nvcc -O3 -std=c++17 -Xcompiler -fPIC \\
         -gencode arch=compute_90a,code=sm_90a -c -o <name>.o csrc/<name>.cu
    nvcc -shared -o <lib>.so *.o

The library lands in ``build/torch_kernels/`` at the repository root, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file.  It is built at first use (the first
CUDA tensor that reaches a kernel wrapper), never at import: importing the
package needs neither ``nvcc`` nor a GPU.  Without ``nvcc`` that first use
raises.

Functions are bound with ``ctypes``; every pointer and the CUDA stream are
``c_void_p`` (a bare Python int would be passed as a 32-bit int).  Each C
entry point returns the ``cudaError_t`` of its launch, and
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-gencode", "arch=compute_90a,code=sm_90a",
)

#: Kernel launches per wrapper name.  Each wrapper adds one where it
#: launches its kernel (:func:`count`) and nowhere else; the plain (CPU) path
#: never counts.
LAUNCHES: Counter = Counter()
_count_lock = threading.Lock()
_sink = threading.local()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point (all return int = cudaError_t).
_SIGNATURES = {
    # q, k, v, out, B, Hq, Hkv, T, scale, stream
    "flash_attention_causal_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, kall, vall, k_new, v_new, prompt_len, decode_end, write_slots (or
    # null), workspace, counters, out, layer, B, Hq, Hkv, S, prompt_bucket,
    # splits, scale, stream
    "decode_attention_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kall, vall, kscale, vscale, k_new, v_new, prompt_len, decode_end,
    # write_slots, workspace, counters, out, layer, B, Hq, Hkv, S,
    # prompt_bucket, splits, scale, stream
    "decode_attention_q8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # cache, rows, slots, L, B, H, T, S, stream
    "kv_write_rows_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # kcache, vcache, krows, vrows, slots, L, B, H, T, S, stream
    "kv_write_span_pair_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cache_q, cache_s, rows, slots, L, B, H, S, stream
    "kv_write_rows_q8": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # pool, rows, pages, offs, L, B, H, T, n_pages, PS, stream
    "kv_write_rows_paged_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # pool_q, pool_s, rows, pages, offs, L, B, H, T, n_pages, PS, stream
    "kv_write_rows_paged_q8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, kpool, vpool, k_new, v_new, table, prompt_len, decode_count,
    # write_pages, write_offsets (both null: no store), workspace, counters,
    # out, layer, B, Hq, Hkv, T, n_pages, PS, max_pages, splits, scale, stream
    "decode_attention_paged_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kpool, vpool, kscale, vscale, k_new, v_new, table, prompt_len,
    # decode_count, write_pages, write_offsets, workspace, counters, out,
    # then as decode_attention_paged_bf16
    "decode_attention_paged_q8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # x, wq, s, out, partial, counters, M, N, K, out_f32, nb, splits, per,
    # stream
    "quantized_matmul_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, xq, sx, wq, ws, out, M, N, K, out_f32, stream
    "w8a8_matmul_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, xq, sx, M, K, stream
    "quantize_rows_bf16": (_P, _P, _P, _I, _I, _P),
    # x, sx (given), xq, wq, ws, out, M, N, K, out_f32, stream
    "w8a8_matmul_scaled_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, sx (given), xq, M, K, stream
    "quantize_rows_scaled_bf16": (_P, _P, _P, _I, _I, _P),
    # x, w, b, out, N, H, W, C, O, stream
    "conv_s2_gelu_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, kall, vall, k_new, v_new, prompt_len, out, layer, B, Hq, Hkv, S,
    # prompt_bucket, decode_end (one int32 on the device), block_k, per
    # (pairs per block), scale, stream
    "decode_attention_hbm2_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _F, _P,
    ),
    # as decode_attention_hbm2_bf16
    "decode_attention_hbm3_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _F, _P,
    ),
    # q, kall, vall, k_new, v_new, prompt_len, decode_end, out, layer, B, Hq,
    # Hkv, S, prompt_bucket, block_p, blocks, scale, stream
    "decode_attention_hbm5_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kall, vall, k_new, v_new, totals, bl, off, lim, flags, out, layer, B,
    # Hq, Hkv, S, cores, per_core, J, blocks, scale, stream
    "decode_attention_sched_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds the last nvcc build in this process took (0.0: none ran).
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "qwen3_asr_tpu_torch are compiled at first use and need the CUDA "
        "toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqwen3_asr_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outputs = [p.communicate() for p in procs]
    for cmd, p, (stdout, stderr) in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}"
            )


def build() -> Path:
    """Compile the sources unless a library for their hash exists: one
    ``nvcc`` per source, all at once, then one link."""
    global last_build_seconds
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    try:
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)
        ])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def count(name: str) -> None:
    """Add one launch of ``name``: to :data:`LAUNCHES`, or, while this thread
    runs :func:`diverted`, to that call's counter.  Several threads may
    launch at once (one model replica per device, two on one card)."""
    counter = getattr(_sink, "counter", None)
    if counter is not None:
        counter[name] += 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def diverted(fn) -> Counter:
    """Run ``fn`` and return the launches this thread's wrappers counted
    meanwhile, which :data:`LAUNCHES` does not see (a CUDA-graph capture,
    during which nothing runs).  Other threads count as usual."""
    prev = getattr(_sink, "counter", None)
    _sink.counter = counted = Counter()
    try:
        fn()
    finally:
        _sink.counter = prev
    return counted


def add_launches(counted: Counter) -> None:
    """Add ``counted`` to :data:`LAUNCHES` (a graph replay's launches)."""
    with _count_lock:
        LAUNCHES.update(counted)


class Scratch:
    """Device buffers that kernels need to themselves while they run (the
    arrival counters of K2/K4/K6/K7, K9's split-K partials and the plans
    that hold their pointers), per device, for one owner.

    An owner's launches run one at a time: a
    :class:`~qwen3_asr_tpu_torch.runtime.generate.Generator` (its prefill,
    its decode loop and the CUDA graphs it captures, and its model's
    encoder, all under the model's lock) or a
    :class:`~qwen3_asr_tpu_torch.runtime.engine.DecodeEngine`.  A graph
    keeps the buffers of the owner that captured it, whichever thread
    replays it, and two owners (two model replicas, on one card or two)
    never share.  The owner frees them (:meth:`clear`) with its graphs.
    Grown and never freed before that, since a captured graph keeps the
    pointers it was given."""

    def __init__(self) -> None:
        self._pools: dict[int | None, dict] = {}

    def pool(self, device) -> dict:
        """This owner's buffers on ``device``, by name."""
        return self._pools.setdefault(device.index, {})

    def clear(self) -> None:
        self._pools.clear()


#: The buffers of launches made outside every owner's scope (a direct
#: wrapper call), one pool per device: such calls share them, in order, as
#: one thread's calls do.
SHARED_SCRATCH = Scratch()
_scope = threading.local()


@contextmanager
def scratch_scope(scratch: Scratch):
    """Make ``scratch`` the owner of this thread's launches meanwhile."""
    prev = getattr(_scope, "scratch", None)
    _scope.scratch = scratch
    try:
        yield scratch
    finally:
        _scope.scratch = prev


def owned(method):
    """Decorate a method so that its launches use its object's ``scratch``
    (:func:`scratch_scope`)."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with scratch_scope(self.scratch):
            return method(self, *args, **kwargs)

    return run


def scratch(device) -> dict:
    """The scratch pool a launch on ``device`` uses: the owner's whose scope
    this thread is in (:func:`scratch_scope`), else :data:`SHARED_SCRATCH`'s."""
    owner = getattr(_scope, "scratch", None)
    return (owner or SHARED_SCRATCH).pool(device)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        text = library().cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({text})")


def check_device_int(name: str, value, device) -> None:
    """Raise unless ``value`` is one int32 on ``device``, 0-d or (1,): the
    shared decode end or write slot that a kernel reads on the device (as
    the TPU kernels read theirs by scalar prefetch), so that a CUDA graph
    replays the launch with whatever value the tensor then holds.  A host
    int, a per-lane (B,) tensor or another dtype is refused."""
    import torch

    if not isinstance(value, torch.Tensor):
        raise TypeError(f"{name} must be a 0-d int32 tensor on {device}, got "
                        f"{type(value).__name__}")
    if value.dtype != torch.int32 or value.dim() > 1 or value.numel() != 1:
        raise ValueError(f"{name} must be one int32 (0-d or (1,)), got {value.dtype} "
                         f"{tuple(value.shape)}")
    if value.device != device:
        raise ValueError(f"{name} is on {value.device}, expected {device}")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if autograd would record this launch: a kernel bound with
    ``ctypes`` returns a tensor with no ``grad_fn``, so a backward pass
    through it would leave the inputs' gradients silently zero.  Wrappers
    call this before launching on CUDA tensors; inference runs under
    ``torch.inference_mode()``/``no_grad()`` or on tensors that need no
    gradient, and training takes the plain routes (the decoder's
    ``attn_impl="causal"``, split float weights, the "conv" stem)."""
    import torch

    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name}: a hand-written CUDA kernel has no backward; call it under "
            "torch.no_grad() or with inputs that do not require grad"
        )


def stream_ptr(tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
