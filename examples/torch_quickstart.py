"""Quickstart: transcribe files with the PyTorch port on an NVIDIA GPU.

    python examples/torch_quickstart.py /path/to/Qwen3-ASR-1.7B clip1.wav clip2.wav

The counterpart of ``examples/quickstart.py`` for ``qwen3_asr_tpu_torch``:
the same calls.  ``from_pretrained`` loads onto the card (``device="cuda"``
by default) and ``warm_up`` builds the CUDA kernels and captures the
default cell's decode graph, where the JAX package compiles its programs.
"""

import sys

from qwen3_asr_tpu_torch import Qwen3ASR

model_path, *clips = sys.argv[1:]
model = Qwen3ASR.from_pretrained(model_path)
model.warm_up()

# Single clips (greedy + the reference's default repetition penalty):
for clip in clips:
    result = model.transcribe(clip)
    print(f"{clip} [{result.language}, {result.duration:.1f}s]: {result.text}")
    print(f"  stats: {model.last_stats.as_dict()}")

# Or all clips in one batch:
if len(clips) > 1:
    for clip, result in zip(clips, model.transcribe_batch(clips)):
        print(f"batched {clip}: {result.text}")
