"""qwen3_asr_tpu_torch — the PyTorch/CUDA port of ``qwen3_asr_tpu``.

Transcription on an NVIDIA H100 (``Qwen3ASR``), the continuous-batching
engine and its servers (``runtime/engine.py``, ``serving``), with
hand-written CUDA kernels for the decoder's hot path (``ops/kernels``,
sources in ``csrc``).  Imports ``torch`` and
never ``jax``; importing needs no GPU and no ``nvcc`` (kernels are built at
first use on a CUDA tensor).
"""

from .api import LANGUAGE_MAP, Qwen3ASR, TranscriptionResult
from .config import AudioEncoderConfig, ModelConfig, RuntimeConfig, TextDecoderConfig

__all__ = [
    "LANGUAGE_MAP",
    "AudioEncoderConfig",
    "ModelConfig",
    "Qwen3ASR",
    "RuntimeConfig",
    "TextDecoderConfig",
    "TranscriptionResult",
]

__version__ = "0.1.0"
