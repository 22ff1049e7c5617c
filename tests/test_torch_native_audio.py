"""The port's native C++ audio library (``qwen3_asr_tpu_torch/audio/native.py``,
``audio/csrc``) against the JAX package's library and the port's numpy
decoder, on the cases of ``tests/test_native_audio.py``: float32, PCM16 and
stereo WAV decode, the linear resampler and ``frame_rms``.  Both libraries
are built with ``make``: the port's in its own ``csrc``, the JAX package's
from its sources in a temporary directory (the JAX tests build theirs in
place), and loaded through the port's ``native.bind``.  Then
``load_audio`` takes the native route when the library is built.
"""

from __future__ import annotations

import ctypes
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest

from qwen3_asr_tpu_torch.audio import io as audio_io
from qwen3_asr_tpu_torch.audio import native

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the port's library, the JAX package's library), both built here."""
    subprocess.run(["make", "-C", str(native.library_path().parent)], check=True,
                   capture_output=True)
    native._load_attempted, native._lib = False, None
    assert native.available()
    jax_src = tmp_path_factory.mktemp("jax_audio")
    for name in ("audio.cc", "Makefile"):
        shutil.copy(REPO / "qwen3_asr_tpu" / "audio" / "csrc" / name, jax_src / name)
    subprocess.run(["make", "-C", str(jax_src)], check=True, capture_output=True)
    return native._load(), native.bind(ctypes.CDLL(str(jax_src / "libqwen3audio.so")))


def _write_wav(path, samples, sr=16000, fmt="pcm16", channels=1):
    if fmt == "pcm16":
        payload = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
        tag, bits = 1, 16
    else:
        payload = samples.astype("<f4").tobytes()
        tag, bits = 3, 32
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    data = b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    data += b"data" + struct.pack("<I", len(payload)) + payload
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(data)) + b"WAVE" + data)


def _stereo():
    mono = np.sin(np.linspace(0, 20, 4000)).astype(np.float32) * 0.5
    return np.repeat(mono[:, None], 2, axis=1).reshape(-1)


WAVS = {
    "f32": (lambda: (np.random.default_rng(0).standard_normal(16000) * 0.3).astype(np.float32),
            "f32", 1),
    "pcm16": (lambda: (np.random.default_rng(3).standard_normal(8000) * 0.2).astype(np.float32),
              "pcm16", 1),
    "pcm16 stereo": (_stereo, "pcm16", 2),
}


@pytest.mark.parametrize("case", list(WAVS))
def test_decode_matches_jax_library_and_numpy(libs, tmp_path, case):
    ours, theirs = libs
    make, fmt, channels = WAVS[case]
    p = tmp_path / "x.wav"
    _write_wav(p, make(), fmt=fmt, channels=channels)
    got, sr = native.decode_wav_file(p, ours)
    jax_out, jax_sr = native.decode_wav_file(p, theirs)
    ref, ref_sr = audio_io._decode_wav(p.read_bytes())
    assert sr == jax_sr == ref_sr == 16000
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, ref)


def test_resample_matches_jax_library_and_numpy(libs):
    ours, theirs = libs
    x = np.random.default_rng(1).standard_normal(8000).astype(np.float32)
    got = native.resample_linear(x, 8000, 16000, ours)
    np.testing.assert_array_equal(got, native.resample_linear(x, 8000, 16000, theirs))
    ref = audio_io.resample_linear(x, 8000, 16000)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_frame_rms_matches_jax_library_and_numpy(libs):
    ours, theirs = libs
    x = np.random.default_rng(2).standard_normal(480 * 10 + 100).astype(np.float32)
    got = native.frame_rms(x, 480, ours)
    np.testing.assert_array_equal(got, native.frame_rms(x, 480, theirs))
    np.testing.assert_allclose(got, audio_io.frame_rms(x, 480), atol=1e-6)


def test_load_audio_takes_the_native_route(libs, tmp_path, monkeypatch):
    p = tmp_path / "x.wav"
    _write_wav(p, WAVS["pcm16"][0](), fmt="pcm16", sr=8000)
    calls = []
    real = native.decode_wav_file
    monkeypatch.setattr(native, "decode_wav_file", lambda path: calls.append(path) or real(path))
    got = audio_io.load_audio(p)
    assert calls == [p]
    samples, sr = audio_io._decode_wav(p.read_bytes())
    np.testing.assert_array_equal(got, audio_io.resample_linear(samples, sr, 16000))
