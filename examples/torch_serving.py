"""Batching server: concurrent callers share device batches (PyTorch port).

    python examples/torch_serving.py /path/to/Qwen3-ASR-1.7B *.wav

The counterpart of ``examples/serving.py`` for ``qwen3_asr_tpu_torch``, with
the same arguments; the model runs on the card.
"""

import sys

from qwen3_asr_tpu_torch import Qwen3ASR, TranscriptionServer

model_path, *clips = sys.argv[1:]
model = Qwen3ASR.from_pretrained(model_path)
model.warm_up()

with TranscriptionServer(model, max_batch_size=8, batch_window_ms=20) as server:
    futures = [server.submit(clip) for clip in clips]
    for clip, fut in zip(clips, futures):
        print(f"{clip}: {fut.result().text}")
    print(f"served {server.stats.requests} requests in {server.stats.batches} "
          f"batches (mean batch {server.stats.mean_batch_size:.1f})")
