"""Log-mel spectrogram frontend (Qwen3-ASR spec) in PyTorch.

Counterpart of ``qwen3_asr_tpu/audio/mel.py`` (``_mel_core`` and the host
padding it is fed by), with the same numerics contract:

  1. STFT: n_fft=400, hop=160, symmetric Hann (``np.hanning``), reflect pad
     n_fft//2 (librosa center=True), final STFT frame dropped.
  2. Power spectrum -> Slaney-area-normalized 128-bin mel filterbank built
     from the HTK mel formula, fmin=0, fmax=8000.
  3. log10(max(mel, 1e-10)); clamp to (per-clip max over valid frames - 8);
     (x + 4) / 4; invalid (padding) frames zeroed.

The JAX package computes the STFT as one strided convolution at
``Precision.HIGHEST``.  Here it is a framed matmul: ``unfold`` cuts the
padded signal into (frames, 400) windows and one float32 GEMM against the
Hann-windowed DFT basis gives real and imaginary parts.  A float32 matmul
runs in full float32 on CUDA unless the process enables TF32
(``torch.backends.cuda.matmul.allow_tf32``, off by default); a float32
``conv1d`` would go through cuDNN in TF32 by default, which is why the
conv form is not used.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 128
F_MIN = 0.0
F_MAX = 8_000.0

_LOG_FLOOR = 1e-10


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    sample_rate: int = SAMPLE_RATE,
    f_min: float = F_MIN,
    f_max: float = F_MAX,
) -> np.ndarray:
    """Slaney-area-normalized triangular mel filterbank, (n_mels, n_fft//2+1)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))

    left = hz_pts[:-2, None]       # (n_mels, 1)
    center = hz_pts[1:-1, None]
    right = hz_pts[2:, None]
    rising = (fft_freqs[None, :] - left) / (center - left)
    falling = (right - fft_freqs[None, :]) / (right - center)
    fb = np.maximum(0.0, np.minimum(rising, falling))

    width = (right - left).squeeze(-1)
    fb[width > 0] /= width[width > 0, None]
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def _dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """Hann-windowed real-DFT basis, (2*(n_fft//2+1), n_fft): rows of
    ``hann * cos(2 pi k n / n_fft)`` then ``-hann * sin(...)``."""
    n_freqs = n_fft // 2 + 1
    window = np.hanning(n_fft).astype(np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=0) * window[None, :]
    return basis.astype(np.float32)


@lru_cache(maxsize=8)
def _device_constants(n_fft: int, n_mels: int, device: torch.device):
    basis = torch.from_numpy(_dft_basis(n_fft)).to(device)
    fb = torch.from_numpy(mel_filterbank(n_fft, n_mels)).to(device)
    return basis, fb


def log_mel_batch(
    padded: torch.Tensor,
    n_valid: torch.Tensor,
    n_frames: int,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
    n_mels: int = N_MELS,
) -> torch.Tensor:
    """Mel pipeline over a (B, L) batch of pre-reflected signal buffers.

    ``padded`` rows have length ``(n_frames - 1) * hop + n_fft`` (float32,
    or int16 PCM scaled by 1/32768 here); ``n_valid`` (B,) counts the
    frames carrying real audio.  Returns (B, n_mels, n_frames) float32 with
    invalid frames zeroed; the dynamic-range clamp maxes over valid frames
    only, per clip.
    """
    if padded.dtype == torch.int16:
        padded = padded.to(torch.float32) * (1.0 / 32768.0)
    basis, fb = _device_constants(n_fft, n_mels, padded.device)
    frames = padded.unfold(-1, n_fft, hop)            # (B, n_frames, n_fft)
    spec = frames @ basis.T                            # (B, n_frames, 2F)
    n_freqs = n_fft // 2 + 1
    real, imag = spec[..., :n_freqs], spec[..., n_freqs:]
    power = real * real + imag * imag                  # (B, n_frames, F)
    mel = (power @ fb.T).transpose(1, 2)               # (B, n_mels, n_frames)
    log_spec = torch.log10(torch.clamp(mel, min=_LOG_FLOOR))

    frame_idx = torch.arange(n_frames, device=padded.device)
    valid = (frame_idx[None, :] < n_valid[:, None])[:, None, :]   # (B, 1, T)
    neg_inf = torch.tensor(float("-inf"), device=padded.device)
    global_max = torch.where(valid, log_spec, neg_inf).amax(dim=(1, 2))
    out = (torch.maximum(log_spec, global_max[:, None, None] - 8.0) + 4.0) / 4.0
    return torch.where(valid, out, torch.zeros((), device=padded.device))


def _host_pad_into(buf: np.ndarray, audio: np.ndarray, n_fft: int) -> None:
    """Fill ``buf`` with ``[reflect(pad) | audio | reflect | zeros]`` in place
    (same layout as the JAX package's host padding)."""
    pad = n_fft // 2
    buf_len = len(buf)
    n = len(audio)
    if n == 0:
        return
    if n == 1:
        buf[pad] = audio[0]
        return
    if n <= pad:
        # Tiny clip: np.pad wraps the reflection multiple times; defer to it.
        reflected = np.pad(audio, pad, mode="reflect")
        take = min(len(reflected), buf_len)
        buf[:take] = reflected[:take]
        return
    head = min(pad, n - 1)
    buf[pad - head : pad] = audio[1 : head + 1][::-1]
    body_take = min(n, buf_len - pad)
    buf[pad : pad + body_take] = audio[:body_take]
    tail_start = pad + n
    tail_len = min(buf_len - tail_start, n - 1, pad)
    if tail_len > 0:
        buf[tail_start : tail_start + tail_len] = audio[n - 1 - tail_len : n - 1][::-1]


def host_pad_batch(
    audios: list[np.ndarray], n_frames: int, n_fft: int, hop: int
) -> np.ndarray:
    """(B, L) padded batch; every valid frame reads the same samples as
    ``np.pad(audio, n_fft // 2, mode="reflect")``.  All clips share a dtype
    (the caller normalizes mixed batches)."""
    buf_len = (n_frames - 1) * hop + n_fft
    dtype = audios[0].dtype if audios[0].dtype in (np.int16, np.float32) else np.float32
    out = np.zeros((len(audios), buf_len), dtype=dtype)
    for row, a in zip(out, audios):
        _host_pad_into(row, a, n_fft)
    return out


class MelFrontend:
    """Frame-bucket table of the mel frontend (bucket lookup only; the
    batched transform is :func:`log_mel_batch`)."""

    def __init__(self, frame_buckets: tuple[int, ...] | None = None) -> None:
        from ..config import DEFAULT_FRAME_BUCKETS

        self.frame_buckets = tuple(frame_buckets or DEFAULT_FRAME_BUCKETS)

    def bucket_for(self, n_samples: int) -> int:
        n_frames = n_samples // HOP_LENGTH
        for b in self.frame_buckets:
            if n_frames <= b:
                return b
        return self.frame_buckets[-1]


def log_mel_spectrogram(audio: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """Unbucketed mel of one clip on ``device``, (n_mels, len(audio) // hop)
    float32 (at least one frame): the JAX package's API-parity convenience;
    the pipeline uses :class:`MelFrontend`'s buckets and :func:`log_mel_batch`.
    Float samples, or int16 PCM (scaled by 1/32768)."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32)
    n_frames = max(1, len(audio) // HOP_LENGTH)
    padded = torch.from_numpy(host_pad_batch([audio], n_frames, N_FFT, HOP_LENGTH)).to(device)
    n_valid = torch.full((1,), n_frames, dtype=torch.long, device=padded.device)
    return log_mel_batch(padded, n_valid, n_frames)[0]


def log_mel_spectrogram_np(audio: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle of the reference pipeline (vectorized rFFT), the
    JAX package's golden-test reference, (n_mels, frames) float32."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    audio = audio.astype(np.float32)
    window = np.hanning(N_FFT).astype(np.float32)
    pad = N_FFT // 2
    x = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP_LENGTH
    idx = np.arange(n_frames)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :]
    frames = x[idx] * window[None, :]
    spec = np.fft.rfft(frames.astype(np.float32), n=N_FFT, axis=1).T  # (freq, T)
    power = (np.abs(spec[:, :-1]) ** 2).astype(np.float32)
    mel = mel_filterbank() @ power
    log_spec = np.log10(np.maximum(mel, _LOG_FLOOR))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
