"""ctypes bindings to the port's native C++ audio library
(``libqwen3audio_torch.so``).

Counterpart of ``qwen3_asr_tpu/audio/native.py``, with a library of its own
built from this package's copy of the source: ``make -C
qwen3_asr_tpu_torch/audio/csrc``.  Without the shared object,
:func:`available` is False and ``io.load_audio`` decodes WAV files with the
numpy decoder in ``io.py``, whose results the library's match bit for bit
(``tests/test_torch_native_audio.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

LIB_NAME = "libqwen3audio_torch.so"
_lib = None
_load_attempted = False

_F32P = ctypes.POINTER(ctypes.c_float)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the library's C ABI (``csrc/audio.cc``) on ``lib``."""
    lib.qa_decode_wav.restype = ctypes.c_int64
    lib.qa_decode_wav.argtypes = [
        ctypes.c_char_p,                  # path
        _F32P,                            # out buffer (or NULL to query size)
        ctypes.c_int64,                   # out buffer capacity (samples)
        ctypes.POINTER(ctypes.c_int32),   # out sample rate
    ]
    lib.qa_resample_linear.restype = ctypes.c_int64
    lib.qa_resample_linear.argtypes = [_F32P, ctypes.c_int64, _F32P, ctypes.c_int64]
    lib.qa_frame_rms.restype = ctypes.c_int64
    lib.qa_frame_rms.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int64, _F32P]
    return lib


def library_path() -> Path:
    return Path(__file__).parent / "csrc" / LIB_NAME


def _load():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    so = library_path()
    if not so.is_file():
        return None
    try:
        _lib = bind(ctypes.CDLL(str(so)))
    except OSError:
        return None
    return _lib


def available() -> bool:
    return _load() is not None


def _need(lib=None) -> ctypes.CDLL:
    lib = lib or _load()
    if lib is None:
        raise RuntimeError(f"native audio library not built (make -C {library_path().parent})")
    return lib


def decode_wav_file(path, lib=None) -> tuple[np.ndarray, int]:
    """Decode a WAV file via the native library -> (mono f32 samples, rate).
    ``lib`` is another build of the same ABI (:func:`bind`), else this
    package's library."""
    lib = _need(lib)
    cpath = str(path).encode()
    rate = ctypes.c_int32(0)
    n = lib.qa_decode_wav(cpath, None, 0, ctypes.byref(rate))
    if n < 0:
        raise ValueError(f"native WAV decode failed (code {n}) for {path}")
    out = np.empty(n, dtype=np.float32)
    got = lib.qa_decode_wav(cpath, out.ctypes.data_as(_F32P), n, ctypes.byref(rate))
    if got != n:
        raise ValueError(f"native WAV decode short read ({got} != {n})")
    return out, int(rate.value)


def resample_linear(x: np.ndarray, sr: int, target_sr: int, lib=None) -> np.ndarray:
    lib = _need(lib)
    x = np.ascontiguousarray(x, dtype=np.float32)
    target_len = int(len(x) * target_sr / sr)
    out = np.empty(target_len, dtype=np.float32)
    lib.qa_resample_linear(x.ctypes.data_as(_F32P), len(x), out.ctypes.data_as(_F32P),
                           target_len)
    return out


def frame_rms(x: np.ndarray, frame_samples: int = 480, lib=None) -> np.ndarray:
    lib = _need(lib)
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(len(x) // frame_samples, dtype=np.float32)
    lib.qa_frame_rms(x.ctypes.data_as(_F32P), len(x), frame_samples, out.ctypes.data_as(_F32P))
    return out
