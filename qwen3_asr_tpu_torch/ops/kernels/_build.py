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
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-gencode", "arch=compute_90a,code=sm_90a",
)

#: Kernel launches per wrapper name.  Each wrapper adds one where it
#: launches its kernel and nowhere else; the plain (CPU) path never counts.
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point (all return int = cudaError_t).
_SIGNATURES = {
    # q, k, v, out, B, Hq, Hkv, T, scale, stream
    "flash_attention_causal_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, kall, vall, k_new, v_new, prompt_len, decode_end, workspace, out,
    # layer, B, Hq, Hkv, S, prompt_bucket, splits, scale, stream
    "decode_attention_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kall, vall, kscale, vscale, k_new, v_new, prompt_len, decode_end,
    # workspace, out, layer, B, Hq, Hkv, S, prompt_bucket, splits, scale,
    # stream
    "decode_attention_q8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # cache, rows, slots, L, B, H, T, S, stream
    "kv_write_rows_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cache_q, cache_s, rows, slots, L, B, H, S, stream
    "kv_write_rows_q8": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # pool, rows, pages, offs, L, B, H, T, n_pages, PS, stream
    "kv_write_rows_paged_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # pool_q, pool_s, rows, pages, offs, L, B, H, T, n_pages, PS, stream
    "kv_write_rows_paged_q8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, kpool, vpool, k_new, v_new, table, prompt_len, decode_count,
    # workspace, out, layer, B, Hq, Hkv, T, n_pages, PS, max_pages, splits,
    # scale, stream
    "decode_attention_paged_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kpool, vpool, kscale, vscale, k_new, v_new, table, prompt_len,
    # decode_count, workspace, out, then as decode_attention_paged_bf16
    "decode_attention_paged_q8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # x, wq, s, out, M, N, K, out_f32, stream
    "quantized_matmul_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, sx, wq, ws, out, M, N, K, out_f32, stream
    "w8a8_matmul_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w, b, out, N, H, W, C, O, stream
    "conv_s2_gelu_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, kall, vall, k_new, v_new, prompt_len, out, layer, B, Hq, Hkv, S,
    # prompt_bucket, decode_end, block_k, scale, stream
    "decode_attention_hbm2_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # as decode_attention_hbm2_bf16, with n_blocks after block_k
    "decode_attention_hbm3_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kall, vall, k_new, v_new, prompt_len, decode_end, out, layer, B, Hq,
    # Hkv, S, prompt_bucket, block_p, scale, stream
    "decode_attention_hbm5_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, kall, vall, k_new, v_new, totals, bl, off, lim, flags, out, layer, B,
    # Hq, Hkv, S, cores, per_core, J, scale, stream
    "decode_attention_sched_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
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


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        text = library().cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({text})")


def stream_ptr(tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)
