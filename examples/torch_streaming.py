"""Streaming session: feed live audio, segments finalize as they complete
(PyTorch port).

    python examples/torch_streaming.py /path/to/Qwen3-ASR-1.7B long_recording.wav

The counterpart of ``examples/streaming.py`` for ``qwen3_asr_tpu_torch``:
simulates a live stream by feeding the file in 5-second pieces; each
finalized segment prints as soon as its low-energy boundary is known.  The
model runs on the card.
"""

import sys

from qwen3_asr_tpu_torch import Qwen3ASR, StreamingTranscriber, load_audio

model_path, path = sys.argv[1:3]
model = Qwen3ASR.from_pretrained(model_path)

audio = load_audio(path)
piece = 5 * 16000

with StreamingTranscriber(model, segment_duration=30.0) as session:
    for i in range(0, len(audio), piece):
        for seg in session.feed(audio[i : i + piece]):
            print(f"[{seg.start:7.1f}s - {seg.end:7.1f}s] {seg.text}")
    # a preview of the not-yet-final tail:
    print(f"(partial) {session.partial().text}")
# context exit flushed the remainder
print("full transcript:", session.text)
