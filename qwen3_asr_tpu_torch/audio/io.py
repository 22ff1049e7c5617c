"""Audio file IO: RIFF/WAV decoding and resampling (numpy).

Counterpart of ``qwen3_asr_tpu/audio/io.py``: the same numpy WAV decoder,
``soundfile`` fallback, linear-interpolation resampler and long-form
split-point search.  The native C++ decoder (``qwen3_asr_tpu/audio/native.py``)
is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SAMPLE_RATE = 16_000

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
# WAVE_FORMAT_EXTENSIBLE wraps the real format in a GUID sub-chunk.
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory RIFF/WAVE byte string to (mono float32, rate).

    Supports PCM16, PCM32 and IEEE float32, any channel count (channels are
    mean-downmixed).  Raises ValueError for anything else.
    """
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE stream")

    fmt_tag = n_channels = rate = bits = None
    payload = None

    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt_tag = int.from_bytes(body[0:2], "little")
            n_channels = int.from_bytes(body[2:4], "little")
            rate = int.from_bytes(body[4:8], "little")
            bits = int.from_bytes(body[14:16], "little")
            if fmt_tag == _WAVE_FORMAT_EXTENSIBLE and size >= 26:
                # SubFormat GUID starts at byte 24; first 2 bytes are the tag.
                fmt_tag = int.from_bytes(body[24:26], "little")
        elif cid == b"data":
            payload = body
        # Chunks are word-aligned.
        pos += 8 + size + (size & 1)

    if fmt_tag is None or payload is None:
        raise ValueError("missing fmt or data chunk")

    if fmt_tag == _WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
    elif fmt_tag == _WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
    elif fmt_tag == _WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        x = np.frombuffer(payload, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV encoding: fmt={fmt_tag} bits={bits}")

    if n_channels and n_channels > 1:
        usable = (len(x) // n_channels) * n_channels
        x = x[:usable].reshape(-1, n_channels).mean(axis=1).astype(np.float32)

    return x, int(rate)


def resample_linear(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear-interpolation resample (matches np.interp semantics)."""
    if sr == target_sr:
        return x.astype(np.float32, copy=False)
    target_len = int(len(x) * target_sr / sr)
    positions = np.linspace(0.0, len(x) - 1, target_len)
    return np.interp(positions, np.arange(len(x)), x).astype(np.float32)


def load_audio(path: str | Path, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load an audio file as mono float32 at ``target_sr``.

    WAV files go through the numpy decoder; other formats (and WAV
    encodings it does not read) go through ``soundfile`` when installed.
    """
    path = Path(path)
    samples = None
    sr = None

    if path.suffix.lower() == ".wav":
        try:
            samples, sr = _decode_wav(path.read_bytes())
        except ValueError:
            samples = None

    if samples is None:
        try:
            import soundfile as sf
        except ImportError as e:
            raise RuntimeError(
                f"cannot decode {path}: not a supported WAV and the optional "
                "'soundfile' dependency is not installed"
            ) from e
        samples, sr = sf.read(str(path), dtype="float32", always_2d=False)
        if samples.ndim == 2:
            samples = samples.mean(axis=1)

    return resample_linear(np.asarray(samples, dtype=np.float32), int(sr), target_sr)


def frame_rms(samples: np.ndarray, frame_samples: int = 480) -> np.ndarray:
    """Per-frame RMS energy over non-overlapping ~30 ms frames."""
    n_frames = len(samples) // frame_samples
    if n_frames == 0:
        return np.zeros((0,), dtype=np.float32)
    framed = samples[: n_frames * frame_samples].reshape(n_frames, frame_samples)
    return np.sqrt(np.mean(framed.astype(np.float64) ** 2, axis=1)).astype(np.float32)


def find_split_points(
    samples: np.ndarray,
    chunk_samples: int,
    search_samples: int,
    frame_samples: int = 480,
) -> list[int]:
    """Low-energy split points for long-form audio: every multiple of
    ``chunk_samples`` snaps to the minimum-RMS frame within +/-
    ``search_samples`` (ties toward the earliest frame)."""
    total = len(samples)
    energy = frame_rms(samples, frame_samples)
    n_frames = len(energy)
    if n_frames == 0:
        return []

    search_frames = search_samples // frame_samples
    points: list[int] = []
    boundary = chunk_samples
    while boundary < total:
        center = boundary // frame_samples
        lo = max(0, center - search_frames)
        hi = min(n_frames - 1, center + search_frames)
        if lo >= hi:
            points.append(boundary)
        else:
            best = int(np.argmin(energy[lo : hi + 1])) + lo
            points.append(best * frame_samples)
        boundary += chunk_samples
    return points
