"""qwen3_asr_tpu_torch — the PyTorch/CUDA port of ``qwen3_asr_tpu``.

Transcription on an NVIDIA H100 (``Qwen3ASR``), the continuous-batching
engine and its servers (``runtime/engine.py``, ``serving``), live streams
(``IncrementalSession``, ``StreamingTranscriber``) and the command line
(``python -m qwen3_asr_tpu_torch``), one model replica per device
(``ReplicatedTranscriptionServer``) and (dp, tp) meshes over
``torch.distributed`` for offline transcription (``parallel``), with
hand-written CUDA kernels for the decoder's hot path (``ops/kernels``,
sources in ``csrc``).  Imports ``torch`` and
never ``jax``; importing needs no GPU and no ``nvcc`` (kernels are built at
first use on a CUDA tensor).  The root exports the JAX package's public
names.
"""

__version__ = "0.1.0"

from .api import LANGUAGE_MAP, Qwen3ASR, TranscriptionResult
from .audio.io import find_split_points, load_audio
from .audio.mel import MelFrontend, log_mel_spectrogram, log_mel_spectrogram_np
from .config import AudioEncoderConfig, ModelConfig, RuntimeConfig, TextDecoderConfig
from .models.decoder import (
    decoder_forward,
    decoder_logits,
    embed_tokens,
    init_decoder_params,
    init_kv_cache,
)
from .models.encoder import encoder_forward, init_encoder_params
from .models.params import load_checkpoint
from .ops.sampling import sample_logits
from .runtime.generate import Generator
from .serving.server import (
    ContinuousTranscriptionServer,
    ReplicatedTranscriptionServer,
    TranscriptionServer,
)
from .incremental import IncrementalSession
from .streaming import StreamingTranscriber, StreamSegment
from .tokenizer import Tokenizer, build_detect_prompt, build_prompt, parse_output
from .utils.telemetry import RequestStats

__all__ = [
    "__version__",
    "LANGUAGE_MAP",
    "Qwen3ASR",
    "TranscriptionResult",
    "load_audio",
    "find_split_points",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
    "MelFrontend",
    "AudioEncoderConfig",
    "TextDecoderConfig",
    "ModelConfig",
    "RuntimeConfig",
    "decoder_forward",
    "decoder_logits",
    "embed_tokens",
    "init_decoder_params",
    "init_kv_cache",
    "encoder_forward",
    "init_encoder_params",
    "load_checkpoint",
    "sample_logits",
    "Generator",
    "TranscriptionServer",
    "ContinuousTranscriptionServer",
    "ReplicatedTranscriptionServer",
    "IncrementalSession",
    "StreamingTranscriber",
    "StreamSegment",
    "RequestStats",
    "Tokenizer",
    "build_prompt",
    "build_detect_prompt",
    "parse_output",
]
