"""Live captions: incremental previews on a growing stream (PyTorch port).

    python examples/torch_live_captions.py /path/to/Qwen3-ASR-1.7B recording.wav

The counterpart of ``examples/live_captions.py`` for ``qwen3_asr_tpu_torch``:
feeds the file in 1-second pieces and prints a refreshed caption after
each.  Previews ride an :class:`IncrementalSession`: every completed 8 s
encoder window is encoded and advanced into a persistent decoder-prefix
KV cache once, so each refresh costs one tail-window pass plus the decode
loop, and the caption is token-identical to transcribing the same prefix
offline.  The model runs on the card.
"""

import sys

from qwen3_asr_tpu_torch import Qwen3ASR, load_audio

model_path, path = sys.argv[1:3]
model = Qwen3ASR.from_pretrained(model_path)
model.warm_up()

audio = load_audio(path)
piece = 16_000  # 1 second

session = model.incremental_session(max_duration=30.0, language="English")
for i in range(0, len(audio), piece):
    session.feed(audio[i : i + piece])
    caption = session.preview()
    print(f"[{session.duration:5.1f}s] {caption.text}", flush=True)
