"""Audio frontend: file IO and the log-mel spectrogram."""

from .io import SAMPLE_RATE, find_split_points, load_audio
from .mel import (
    HOP_LENGTH,
    N_FFT,
    N_MELS,
    MelFrontend,
    host_pad_batch,
    log_mel_batch,
    log_mel_spectrogram,
    log_mel_spectrogram_np,
)

__all__ = [
    "HOP_LENGTH",
    "N_FFT",
    "N_MELS",
    "SAMPLE_RATE",
    "MelFrontend",
    "find_split_points",
    "host_pad_batch",
    "load_audio",
    "log_mel_batch",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
]
