"""In-flight continuous batching: requests join a RUNNING decode (PyTorch port).

    python examples/torch_continuous_serving.py /path/to/Qwen3-ASR-1.7B *.wav

The counterpart of ``examples/continuous_serving.py`` for
``qwen3_asr_tpu_torch``: a request submitted while a long transcription
decodes is admitted at the next chunk boundary instead of waiting for the
whole batch.  Where it differs: the JAX example passes ``warm=True`` to
compile every admission group's programs before serving; the port has no
programs to compile, so this example calls ``model.warm_up()`` (the CUDA
kernels' build) and leaves ``warm`` at its default.
"""

import sys

from qwen3_asr_tpu_torch import ContinuousTranscriptionServer, Qwen3ASR

model_path, *clips = sys.argv[1:]
model = Qwen3ASR.from_pretrained(model_path)
model.warm_up()

with ContinuousTranscriptionServer(
    model,
    n_slots=16,            # concurrent decodes sharing the paged KV pool
    max_duration=30.0,     # per-clip cap (long-form goes to transcribe())
    chunk_steps=32,        # admission latency bound, in decode steps
) as server:
    futures = [server.submit(clip) for clip in clips]
    for clip, fut in zip(clips, futures):
        print(f"{clip}: {fut.result().text}")
    es = server.engine_stats
    print(
        f"{es.admitted} admitted ({es.mid_decode_admissions} mid-decode), "
        f"{es.chunks} chunks, mean occupancy {es.mean_occupancy:.1f}"
    )
