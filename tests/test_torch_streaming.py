"""The port's ``StreamingTranscriber`` against the JAX package's, float32 on
the CPU: the cases of ``tests/test_streaming.py`` (and the streaming case
of ``tests/test_incremental.py``) on the tiny model of
``tests/torch_parity.py``, each segment's text, start and end held to the
JAX session's on the same weights and audio where the case produces a
transcript, and to the port's own offline ``transcribe`` of the span.
"""

from __future__ import annotations

import numpy as np
import pytest

from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig, StreamingTranscriber
from qwen3_asr_tpu_torch.audio.io import SAMPLE_RATE
from torch_parity import models

#: tests/test_streaming.py's runtime: one 8 s frame bucket.
RT = dict(frame_buckets=(800,), token_buckets=(16,))
#: tests/test_incremental.py's runtime, for the incremental previews.
RT_INC = dict(frame_buckets=(800, 1600, 3200), token_buckets=(32, 64))
#: Weights whose greedy tokens follow the audio (tests/test_torch_incremental.py).
WEIGHTS_SEED = 3


@pytest.fixture(scope="module")
def pair():
    return models(seed=WEIGHTS_SEED, runtime=RT)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def sine(duration_s, freq=440.0):
    t = np.arange(int(duration_s * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def tone_with_gaps(total_sec, gap_every=2.0, gap_len=0.3):
    """Sine with periodic silences so low-energy splits land in gaps."""
    out = sine(total_sec, 440.0).copy()
    gap = int(gap_len * SAMPLE_RATE)
    step = int(gap_every * SAMPLE_RATE)
    for start in range(step, len(out), step):
        out[start : start + gap] = 0.0
    return out


def _jax_segments(pair, audio, piece=None, **kw):
    """The JAX session's segments on the same audio, fed in ``piece``s."""
    from qwen3_asr_tpu.streaming import StreamingTranscriber as JaxStream

    s = JaxStream(pair[0], **kw)
    piece = piece or len(audio)
    segs = []
    for i in range(0, len(audio), piece):
        segs += s.feed(audio[i : i + piece])
    return [(g.text, g.start, g.end) for g in segs + s.flush()]


def _spans(segs):
    return [(g.text, g.start, g.end) for g in segs]


def test_progressive_finalization(pair, model):
    """Segments finalize as audio arrives, before the stream ends."""
    audio = tone_with_gaps(7.0)
    kw = dict(segment_duration=2.0, search_duration=0.5, max_tokens=4)
    s = StreamingTranscriber(model, **kw)
    early = []
    piece = SAMPLE_RATE  # 1 s at a time
    for i in range(0, len(audio), piece):
        early += s.feed(audio[i : i + piece])
    assert len(early) >= 2, "no segment finalized before end of stream"
    final = s.flush()
    segs = s.segments
    assert segs == early + final
    assert all(g.final for g in segs)
    assert segs[0].start == 0.0
    for a, b in zip(segs, segs[1:]):
        assert abs(a.end - b.start) < 1e-6
    assert abs(segs[-1].end - len(audio) / SAMPLE_RATE) < 1e-6
    assert s.text == " ".join(g.text for g in segs if g.text).strip()
    assert _spans(segs) == _jax_segments(pair, audio, piece, **kw)


def test_matches_offline_per_segment_transcription(pair, model):
    """Each finalized segment's text == offline transcribe of that span, and
    == the JAX session's segment."""
    audio = tone_with_gaps(5.0)
    kw = dict(segment_duration=2.0, search_duration=0.5, max_tokens=4)
    s = StreamingTranscriber(model, **kw)
    s.feed(audio)
    s.flush()
    assert len({g.text for g in s.segments}) > 1
    for seg in s.segments:
        lo = int(round(seg.start * SAMPLE_RATE))
        hi = int(round(seg.end * SAMPLE_RATE))
        assert seg.text == model.transcribe(audio[lo:hi], max_tokens=4).text
    assert _spans(s.segments) == _jax_segments(pair, audio, **kw)


def test_split_lands_in_silence(pair, model):
    """The boundary snaps to the low-energy gap (the argmin-RMS rule)."""
    audio = tone_with_gaps(4.0, gap_every=2.1, gap_len=0.3)
    kw = dict(segment_duration=2.0, search_duration=0.5, max_tokens=4)
    s = StreamingTranscriber(model, **kw)
    s.feed(audio)
    seg = s.segments[0]
    boundary = int(seg.end * SAMPLE_RATE)
    gap_start = int(2.1 * SAMPLE_RATE)
    assert gap_start - 480 <= boundary <= gap_start + int(0.3 * SAMPLE_RATE) + 480
    assert _spans(s.segments + s.flush()) == _jax_segments(pair, audio, **kw)


def test_partial_preview_and_close(pair, model):
    from qwen3_asr_tpu.streaming import StreamingTranscriber as JaxStream

    audio = tone_with_gaps(3.0)
    kw = dict(segment_duration=2.0, search_duration=0.5, max_tokens=4)
    ref = JaxStream(pair[0], **kw)
    ref.feed(audio[:SAMPLE_RATE])
    with StreamingTranscriber(model, **kw) as s:
        assert s._inc is not None
        s.feed(audio[:SAMPLE_RATE])
        p = s.partial()
        assert not p.final
        assert p.end > p.start
        assert p.text == ref.partial().text
        assert p.text == model.transcribe(audio[:SAMPLE_RATE], max_tokens=4).text
        n_before = len(s.segments)
        assert s.partial().text == p.text   # previews never mutate session state
        assert len(s.segments) == n_before
        s.feed(audio[SAMPLE_RATE:])
    assert s._closed
    assert s.segments[-1].final
    with pytest.raises(RuntimeError):
        s.feed(audio[:100])


def test_int16_feed(pair, model):
    audio = (tone_with_gaps(2.0) * 32767).astype(np.int16)
    kw = dict(segment_duration=3.0, search_duration=0.5, max_tokens=4)
    s = StreamingTranscriber(model, **kw)
    s.feed(audio)
    out = s.flush()
    assert len(out) == 1 and out[0].final
    assert _spans(out) == _jax_segments(pair, audio, **kw)


def test_segment_must_fit_bucket(model):
    """segment + search beyond the largest frame bucket is refused up front."""
    with pytest.raises(ValueError, match="largest frame bucket"):
        StreamingTranscriber(model, segment_duration=7.5, search_duration=1.5)


def test_split_clamped_to_bucket(pair, model):
    """Decreasing energy pulls the argmin to the window's far edge; the
    chunk must still fit the 8 s bucket."""
    t = np.arange(16000 * 12) / 16000
    audio = (np.sin(2 * np.pi * 440 * t) * np.linspace(1.0, 0.01, len(t))).astype(np.float32)
    kw = dict(segment_duration=6.0, search_duration=1.5, max_tokens=4)
    s = StreamingTranscriber(model, **kw)
    s.feed(audio)
    s.flush()
    for seg in s.segments:
        assert seg.end - seg.start <= 8.0 + 1e-6
    assert _spans(s.segments) == _jax_segments(pair, audio, **kw)


def test_server_backed_session_matches_model_path(model):
    """A server= session gives the segments of the model-lock path."""
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    audio = tone_with_gaps(5.0)
    kw = dict(segment_duration=2.0, search_duration=0.5, max_tokens=4)
    ref = StreamingTranscriber(model, **kw)
    ref_segs = ref.feed(audio) + ref.flush()
    with ContinuousTranscriptionServer(
        model, n_slots=4, max_duration=3.0, max_new_tokens=16, chunk_steps=2
    ) as srv:
        s = StreamingTranscriber(model, server=srv, **kw)
        assert s._inc is None
        segs = s.feed(audio) + s.flush()
    assert _spans(segs) == _spans(ref_segs)


def test_concurrent_streams_share_engine(model):
    """Two live sessions and batch traffic on ONE continuous server: every
    segment's text matches the offline transcription of its span."""
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    audio_a = tone_with_gaps(5.0)
    audio_b = tone_with_gaps(5.0, gap_every=1.7)
    kw = dict(segment_duration=2.0, search_duration=0.5, max_tokens=4)
    with ContinuousTranscriptionServer(
        model, n_slots=4, max_duration=3.0, max_new_tokens=16, chunk_steps=2
    ) as srv:
        sa = StreamingTranscriber(model, server=srv, **kw)
        sb = StreamingTranscriber(model, server=srv, **kw)
        futs_a, futs_b = [], []
        for i in range(0, max(len(audio_a), len(audio_b)), SAMPLE_RATE):
            futs_a += sa.feed_nowait(audio_a[i : i + SAMPLE_RATE])
            futs_b += sb.feed_nowait(audio_b[i : i + SAMPLE_RATE])
        extra = srv.submit(sine(1.0, 520.0), max_tokens=4)
        futs_a += sa.flush_nowait()
        futs_b += sb.flush_nowait()
        segs_a = [f.result(timeout=300) for f in futs_a]
        segs_b = [f.result(timeout=300) for f in futs_b]
        assert extra.result(timeout=300).text
    for audio, segs, sess in ((audio_a, segs_a, sa), (audio_b, segs_b, sb)):
        assert len(segs) >= 2
        assert segs[-1].end * SAMPLE_RATE == pytest.approx(len(audio), abs=1)
        for g in segs:
            lo, hi = int(g.start * SAMPLE_RATE), int(g.end * SAMPLE_RATE)
            assert g.text == model.transcribe(audio[lo:hi], max_tokens=4).text
        # The placeholders in .segments resolved in place.
        assert [g.text for g in sess.segments] == [g.text for g in segs]


def test_feed_nowait_requires_server(model):
    s = StreamingTranscriber(model, segment_duration=2.0, search_duration=0.5)
    with pytest.raises(RuntimeError, match="server"):
        s.feed_nowait(np.zeros(100, np.float32))


def test_session_rejects_segment_beyond_server_budget(model):
    class FakeServer:
        _max_duration = 1.0

        def submit(self, *a, **k):
            raise AssertionError("should not submit")

    with pytest.raises(ValueError, match="max_duration"):
        StreamingTranscriber(model, segment_duration=2.0, search_duration=0.5,
                             server=FakeServer())


def _speech_like(seconds, seed=0, amp=0.05):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16_000)
    t = np.arange(n) / 16_000
    sig = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (amp * (sig + 0.1 * rng.standard_normal(n))).astype(np.float32)


def test_partial_uses_incremental_and_matches():
    """tests/test_incremental.py's streaming case: incremental and
    re-transcribing previews, and their segments, are identical, and equal
    to the JAX session's."""
    from qwen3_asr_tpu.streaming import StreamingTranscriber as JaxStream

    jax_model, port = models(seed=WEIGHTS_SEED, runtime=RT_INC)
    audio = _speech_like(26.0, seed=6)
    kw = dict(segment_duration=10.0, search_duration=2.0, max_tokens=6, language="English")
    inc = StreamingTranscriber(port, **kw)
    ref = StreamingTranscriber(port, incremental=False, **kw)
    jref = JaxStream(jax_model, **kw)
    assert inc._inc is not None and ref._inc is None
    step = int(4.0 * 16_000)
    for lo in range(0, len(audio), step):
        piece = audio[lo : lo + step]
        segs = [inc.feed(piece), ref.feed(piece), jref.feed(piece)]
        assert [s.text for s in segs[0]] == [s.text for s in segs[1]] == [s.text for s in segs[2]]
        assert inc.partial().text == ref.partial().text == jref.partial().text
    flushed = [[s.text for s in x.flush()] for x in (inc, ref, jref)]
    assert flushed[0] == flushed[1] == flushed[2]
    assert inc.text == ref.text == jref.text


def test_int8_cache_model_previews_by_retranscription(model):
    """The session refuses the int8 cache, so the stream previews by
    re-transcribing its tail (the reference's configuration rule)."""
    m = Qwen3ASR(model._config, model._encoder_params, model._decoder_params,
                 model._tokenizer, RuntimeConfig(**RT, kv_cache_dtype="int8"))
    audio = tone_with_gaps(1.5)
    s = StreamingTranscriber(m, segment_duration=2.0, search_duration=0.5, max_tokens=4)
    assert s._inc is None
    s.feed(audio)
    assert s.partial().text == m.transcribe(audio, max_tokens=4).text
