"""Incremental (streaming) transcription sessions.

Counterpart of ``qwen3_asr_tpu/streaming.py``.  Long-form transcription
splits at low-energy boundaries, transcribes each span and stitches the
texts; a live session picks each split as soon as enough audio has
arrived, rather than after the whole recording exists.

``StreamingTranscriber`` accepts 16 kHz mono float32/int16 audio in pieces
of any size.  Whenever the un-finalized buffer covers a full
``segment_duration`` plus the split-search window, the boundary snaps to
the minimum-RMS frame (the long-form split rule, ``audio/io.py``
``find_split_points``) and the completed segment is transcribed through
the offline pipeline, or submitted to a ``ContinuousTranscriptionServer``
given as ``server=``.  Segments fall in the model's frame buckets, so a
session reuses the decode graphs of offline calls.  ``partial()`` previews
the live tail through an :class:`~.incremental.IncrementalSession` and
never changes the session's segments.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from .audio.io import SAMPLE_RATE, frame_rms
from .audio.mel import HOP_LENGTH

#: The options an incremental preview session takes from a stream's.
_SESSION_OPTIONS = (
    "language", "max_tokens", "temperature", "top_p", "top_k",
    "repetition_penalty", "repetition_context_size", "seed",
)


@dataclass
class StreamSegment:
    """One finalized (or previewed) span of the stream."""

    text: str
    start: float          # seconds from session start
    end: float
    final: bool
    language: str = "Unknown"


def _mono(samples) -> np.ndarray:
    """1-D float32 samples (int16 PCM scaled by 1/32768)."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        samples = samples.astype(np.float32) / 32768.0
    if samples.ndim != 1:
        raise ValueError("streaming audio must be 1-D mono")
    return samples.astype(np.float32)


class StreamingTranscriber:
    """Incremental transcription over a live audio stream.

    Parameters
    ----------
    model:
        A :class:`~qwen3_asr_tpu_torch.api.Qwen3ASR`.
    segment_duration:
        Target seconds per finalized segment (long-form chunking uses
        1200 s; live sessions want 10-60 s).
    search_duration:
        Half-width of the low-energy split search window around each
        segment boundary.
    server:
        Optional :class:`~qwen3_asr_tpu_torch.serving.ContinuousTranscriptionServer`
        (or anything with ``submit(audio, **options) -> Future``).  When
        given, finalized segments are SUBMITTED to the shared continuous
        engine instead of calling ``model.transcribe`` under the model's
        lock: several live streams then share decode slots with each other
        and with batch traffic.  ``feed``/``flush`` still return resolved
        segments; ``feed_nowait``/``flush_nowait`` return a future per
        segment.
    incremental:
        Preview through an :class:`~.incremental.IncrementalSession`
        (default: only without a server).  A runtime the session refuses
        (int8 cache, ``speculative="ngram"``, oversized segments) previews
        by re-transcription instead.
    options:
        Forwarded to ``model.transcribe`` / ``server.submit`` for every
        segment (language, temperature, max_tokens, ...).
    """

    def __init__(
        self,
        model,
        segment_duration: float = 30.0,
        search_duration: float = 5.0,
        server=None,
        incremental: bool | None = None,
        **options,
    ) -> None:
        if segment_duration <= search_duration:
            raise ValueError(
                "segment_duration must exceed search_duration "
                f"({segment_duration} <= {search_duration})"
            )
        self._model = model
        self._segment = int(segment_duration * SAMPLE_RATE)
        self._search = int(search_duration * SAMPLE_RATE)
        # A segment must fit one frame bucket: the split search can reach
        # ``search`` past the boundary.
        max_chunk = model._runtime.frame_buckets[-1] * HOP_LENGTH
        if self._segment + self._search > max_chunk:
            raise ValueError(
                f"segment_duration + search_duration "
                f"({segment_duration + search_duration:.0f}s) must fit the "
                f"model's largest frame bucket "
                f"({max_chunk / SAMPLE_RATE:.0f}s) so every segment runs "
                "as one pass"
            )
        self._max_chunk = max_chunk
        self._server = server
        if server is not None:
            max_dur = getattr(server, "_max_duration", None)
            if max_dur is not None and segment_duration + search_duration > max_dur:
                raise ValueError(
                    f"segment_duration + search_duration "
                    f"({segment_duration + search_duration:.0f}s) exceeds "
                    f"the server's max_duration ({max_dur:.0f}s)"
                )
        self._options = options
        self._buffer = np.zeros(0, np.float32)
        self._consumed = 0          # samples finalized so far
        self._segments: list[StreamSegment] = []
        self._closed = False
        # The incremental preview pins a per-stream KV cache on the local
        # model, which would bypass a shared engine's slots and contend
        # for its memory: on by default only without a server.  The
        # session refuses runtimes it cannot serve (ValueError), and the
        # previews then re-transcribe the tail, as the JAX package does.
        if incremental is None:
            incremental = server is None
        self._inc = None
        if incremental:
            try:
                self._inc = model.incremental_session(
                    max_duration=(self._segment + self._search) / SAMPLE_RATE + 1.0,
                    **{k: v for k, v in options.items() if k in _SESSION_OPTIONS},
                )
            except ValueError:
                self._inc = None

    # -- session API -------------------------------------------------------

    def feed(self, samples: np.ndarray) -> list[StreamSegment]:
        """Append audio; returns any newly finalized segments."""
        if self._closed:
            raise RuntimeError("session is closed")
        delta = _mono(samples)
        self._buffer = np.concatenate([self._buffer, delta])
        out: list[StreamSegment] = []
        # Finalize while the buffer covers a boundary plus its full search
        # window (later audio cannot move the split then).
        while len(self._buffer) >= self._segment + self._search:
            out.append(self._finalize(self._next_split()))
        self._sync_inc(delta, finalized=bool(out))
        return out

    def feed_nowait(self, samples: np.ndarray) -> list:
        """Append audio; returns a ``Future[StreamSegment]`` per newly
        finalized segment (requires ``server=``).

        The pipelined form of :meth:`feed`: segments are submitted to the
        shared continuous engine and the session keeps accepting audio
        while they decode, so one thread can drive many sessions.  A
        segment's audio is consumed at submit time, so a failed decode
        surfaces on its future (the retry with an intact buffer of
        :meth:`feed` does not apply).
        """
        if self._server is None:
            raise RuntimeError("feed_nowait requires a server= session")
        if self._closed:
            raise RuntimeError("session is closed")
        delta = _mono(samples)
        self._buffer = np.concatenate([self._buffer, delta])
        out = []
        while len(self._buffer) >= self._segment + self._search:
            out.append(self._submit_segment(self._next_split()))
        self._sync_inc(delta, finalized=bool(out))
        return out

    def flush(self) -> list[StreamSegment]:
        """Finalize all remaining audio (end of stream)."""
        if self._closed:
            return []
        out = []
        while len(self._buffer) >= self._segment + self._search:
            out.append(self._finalize(self._next_split()))
        if len(self._buffer) > 0:
            out.append(self._finalize(len(self._buffer)))
        self._closed = True
        return out

    def flush_nowait(self) -> list:
        """Asynchronous flush: a ``Future[StreamSegment]`` per remaining
        segment."""
        if self._server is None:
            raise RuntimeError("flush_nowait requires a server= session")
        if self._closed:
            return []
        out = []
        while len(self._buffer) >= self._segment + self._search:
            out.append(self._submit_segment(self._next_split()))
        if len(self._buffer) > 0:
            out.append(self._submit_segment(len(self._buffer)))
        self._closed = True
        return out

    def _sync_inc(self, delta: np.ndarray, finalized: bool) -> None:
        """Keep the preview session aligned with the un-finalized buffer:
        a plain feed extends it with the delta; a finalization consumed
        audio from the front, so the session restarts from the remaining
        buffer (once per segment)."""
        if self._inc is None:
            return
        if finalized:
            self._inc.reset()
            if len(self._buffer):
                self._inc.feed(self._buffer)
        elif len(delta):
            self._inc.feed(delta)

    def partial(self) -> StreamSegment:
        """Preview transcript of the un-finalized tail (state untouched).

        With the (default) incremental session, completed 8 s encoder
        windows of the tail are encoded and advanced into its decoder
        prefix once, so each call pays the incomplete tail window, a short
        cached advance and the decode; token-identical to re-transcribing
        the tail in float32 (``tests/test_torch_incremental.py``)."""
        start = self._consumed / SAMPLE_RATE
        if len(self._buffer) == 0:
            return StreamSegment("", start, start, final=False)
        if self._inc is not None:
            res = self._inc.preview()
        else:
            res = self._transcribe_segment(self._buffer)
        return StreamSegment(
            res.text, start, start + len(self._buffer) / SAMPLE_RATE,
            final=False, language=res.language,
        )

    @property
    def segments(self) -> list[StreamSegment]:
        return list(self._segments)

    @property
    def text(self) -> str:
        """All finalized text so far, joined by single spaces."""
        return " ".join(s.text for s in self._segments if s.text).strip()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._closed:
            self.flush()

    # -- internals ---------------------------------------------------------

    def _next_split(self) -> int:
        """Low-energy boundary for the next segment: the argmin-RMS frame
        within +/- the search window of the segment length, clamped so the
        segment fits the largest frame bucket."""
        frame = 480
        energy = frame_rms(self._buffer, frame)
        center = self._segment // frame
        lo = max(0, center - self._search // frame)
        hi = min(
            len(energy) - 1,
            center + self._search // frame,
            self._max_chunk // frame - 1,
        )
        if lo >= hi:
            return min(self._segment, self._max_chunk)
        best = int(np.argmin(energy[lo : hi + 1])) + lo
        return max(best * frame, frame)

    def _transcribe_segment(self, audio: np.ndarray):
        """One segment through the shared engine (when attached) or the
        model's offline path."""
        if self._server is not None:
            return self._server.submit(audio, **self._options).result()
        return self._model.transcribe(audio, **self._options)

    def _finalize(self, split: int) -> StreamSegment:
        # Transcribe BEFORE changing session state: a transient failure then
        # leaves the buffer intact and the caller can retry, where
        # consuming first would drop the segment's audio.
        start = self._consumed / SAMPLE_RATE
        res = self._transcribe_segment(self._buffer[:split])
        self._buffer = self._buffer[split:]
        self._consumed += split
        seg = StreamSegment(
            res.text, start, self._consumed / SAMPLE_RATE,
            final=True, language=res.language,
        )
        self._segments.append(seg)
        return seg

    def _submit_segment(self, split: int) -> Future:
        """Submit one finalized segment to the engine and consume its audio
        at once, so the next boundary can be found while it decodes.  The
        placeholder in :attr:`segments` is filled in when the decode
        completes."""
        start = self._consumed / SAMPLE_RATE
        audio = self._buffer[:split]
        self._buffer = self._buffer[split:]
        self._consumed += split
        seg = StreamSegment("", start, self._consumed / SAMPLE_RATE, final=True)
        self._segments.append(seg)
        out: Future = Future()
        inner = self._server.submit(audio, **self._options)

        def _done(f, seg=seg, out=out):
            try:
                res = f.result()
            except BaseException as exc:  # noqa: BLE001 -- surfaced on the future
                out.set_exception(exc)
                return
            # In place, so the placeholder already in .segments resolves
            # (attribute stores are atomic under the GIL).
            seg.text = res.text
            seg.language = res.language
            out.set_result(seg)

        inner.add_done_callback(_done)
        return out
