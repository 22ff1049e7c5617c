"""Incremental prefix encoding for live streams (true streaming ASR).

Counterpart of ``qwen3_asr_tpu/incremental.py``.  Re-running the whole
un-finalized tail through mel -> encoder -> prefill at every preview is
unnecessary, for two reasons the model's structure gives:

  * the encoder's attention is block-diagonal over 104-token windows of
    800 mel frames (8 s), so a completed window's features are final as
    soon as its frames exist;
  * the decoder is causal, so the K/V rows of audio already encoded never
    change when more audio arrives: the decoder prefix advances one window
    at a time with the cached multi-token forward
    (:meth:`~.runtime.generate.Generator.advance`).

One exactness trap: the mel dynamic-range clamp is GLOBAL per clip
(``max(log_mel, clip_max - 8)``), so a louder sound later in the stream
lifts the clamp floor and changes earlier frames' sub-floor bins.  The
session therefore keeps each window's UNCLAMPED log-mel (``audio/mel.py``
``_mel_raw``) with its min and max, tracks the running clip max, and
re-encodes (and re-advances the decoder from) any window whose features
the new floor would change (``min_raw < floor``).  With that, each
``preview()`` is token-identical to ``model.transcribe`` of the same audio
prefix in float32 (``tests/test_torch_incremental.py``); in bf16 on the
card the cached advance's plain attention and the prefill's K1 differ
within bf16 rounding.

Per preview the device runs: mel + encoder of the ONE incomplete tail
window, a <= 104-token cached advance, a 16-token suffix advance, and the
plain decode loop (K2 with K3 fused); on the card each advance and the
decode replay CUDA graphs.

The session's prefix lives in a KV cache of its own, outside the decode
graphs' arena: an offline ``prefill(arena=True)`` (any ``transcribe``
between two previews) zeroes the arena, and the graphed decode copies the
session's cache into the arena once per preview.  The graphed advance
copies it into views of its own in the same arena and back around each
replay (``Generator.advance``), so every session of one (B, S, T) bucket
replays one captured graph.  Each preview holds the
model's lock across its advances and its decode, as ``transcribe`` does,
since the arena and the captured graphs are shared.  The session runs on
the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .audio.mel import HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE, _mel_finalize, _mel_raw
from .models.decoder import init_kv_cache
from .models.encoder import encoder_forward

#: Encoder attention window: 800 mel frames = 8 s = 104 audio tokens.
WINDOW_FRAMES = 800
WINDOW_SAMPLES = WINDOW_FRAMES * HOP_LENGTH
#: Suffix-advance length (covers the chat-template suffix and any language
#: name's tokens; checked per session).
SUFFIX_PAD = 16
#: Prefix-advance length (the chat prefix is 9 ids).
PREFIX_PAD = 16


class IncrementalSession:
    """Decoder-prefix-cached live transcription over a growing stream.

    ``feed`` buffers samples and computes the raw log-mel of each completed
    8 s encoder window once; ``preview`` encodes and advances the windows
    not yet in the decoder prefix (and any the clamp floor changed),
    encodes only the incomplete tail window, advances the prompt suffix,
    and decodes, returning the transcript of everything fed so far.

    Restrictions (falling back is the caller's job): the bf16 cache (the
    model's dtype, not int8), not ``speculative="ngram"``, one device, and
    audio up to ``max_duration`` within a frame bucket that is a multiple
    of 800 frames.
    """

    def __init__(
        self,
        model,
        max_duration: float = 30.0,
        language=None,
        max_tokens: int | None = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        repetition_penalty: float = 1.2,
        repetition_context_size: int = 100,
        seed: int = 0,
    ) -> None:
        gen = model._generator
        rt = gen.runtime
        if rt.kv_cache_dtype != "bf16" or rt.speculative == "ngram":
            raise ValueError(
                "incremental sessions require the bf16 cache and "
                "non-speculative decoding"
            )
        if rt.dp * rt.tp > 1:
            raise ValueError(
                "incremental sessions are single-device (the per-session "
                "prefix cache is unsharded); use the continuous server"
            )
        self._model = model
        self._gen = gen
        self._cfg = model._config
        self._device = model._device
        self._dtype = gen.params["final_norm"].dtype
        want_frames = int(max_duration * SAMPLE_RATE) // HOP_LENGTH
        bucket = model._mel.bucket_for(int(max_duration * SAMPLE_RATE))
        if want_frames > bucket:
            # bucket_for clamps to the largest bucket; failing here beats a
            # surprise ValueError from feed() mid-stream.
            raise ValueError(
                f"max_duration {max_duration:.0f}s exceeds the largest "
                f"frame bucket ({bucket / 100:.0f}s)"
            )
        if bucket % WINDOW_FRAMES:
            raise ValueError("frame buckets must be multiples of 800")
        self._max_frames = bucket
        enc = self._cfg.audio_encoder
        #: Audio tokens per full 800-frame window (104 for the real model).
        self._wtok = WINDOW_FRAMES // enc.chunk_frames * enc.tokens_per_chunk
        atb = bucket // enc.chunk_frames * enc.tokens_per_chunk
        plan_budget = max_tokens if max_tokens is not None else max(256, int(max_duration * 50))
        self._prompt_bucket, self._token_bucket, self._cache_len = gen.plan(
            atb, atb + 2 * SUFFIX_PAD, plan_budget
        )
        self._max_tokens = max_tokens
        self._opts = dict(
            temperature=temperature, top_p=top_p, top_k=top_k,
            repetition_penalty=repetition_penalty,
            repetition_context_size=repetition_context_size, seed=seed,
        )
        lang_name = model._resolve_language(language)
        full = model._tokenizer.build_prompt(0, lang_name)
        self._prefix_ids = full[:9]
        self._suffix_ids = full[9:]
        self._lang_name = lang_name
        if len(self._suffix_ids) > SUFFIX_PAD:
            raise ValueError("prompt suffix exceeds the advance bucket")

        self._kv = self._prefix_cache()
        self._samples = np.zeros(0, np.float32)
        # Per window: raw mel on the device, min over its valid bins, and
        # the clamp floor its features and K/V rows were last built with.
        self._win_raw: list[torch.Tensor] = []
        self._win_min: list[float] = []
        self._win_floor: list[float] = []
        self._global_max = -np.inf
        self._committed = 0          # windows advanced into the cache
        self._invalid = False        # poisoned by a failed preview

    def _prefix_cache(self):
        """A zeroed cache of the session's length holding the chat prefix:
        the 9 prefix ids advanced as a 16-token span (rows 9..15 are
        scratch, overwritten by the first window or tail advance before
        anything attends them)."""
        gen = self._gen
        ids = np.zeros((1, PREFIX_PAD), np.int64)
        ids[0, :9] = self._prefix_ids
        with self._model._held(), torch.inference_mode():
            kv = init_kv_cache(gen.cfg, 1, self._cache_len, self._dtype, self._device)
            kv, _ = gen.advance(kv, gen.embed_ids(ids), np.arange(PREFIX_PAD)[None], 0, 8)
        return kv

    def _check_valid(self) -> None:
        if self._invalid:
            raise RuntimeError(
                "session invalidated by a failed preview (its KV cache may be "
                "half-updated); call reset() to start over"
            )

    # -- audio ingestion ----------------------------------------------------

    def feed(self, samples: np.ndarray) -> None:
        self._check_valid()
        samples = np.asarray(samples)
        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) / 32768.0
        if samples.ndim != 1:
            raise ValueError("audio must be 1-D mono")
        self._samples = np.concatenate([self._samples, samples.astype(np.float32)])
        if len(self._samples) // HOP_LENGTH > self._max_frames:
            raise ValueError("session audio exceeds max_duration; finalize and reset")
        # Window w is final once its last frame has its full 400-sample
        # STFT context in real samples (frame i spans [i*hop - 200,
        # i*hop + 200)): (w+1)*WINDOW_SAMPLES + 40 samples exist.
        while (
            len(self._samples)
            >= (len(self._win_raw) + 1) * WINDOW_SAMPLES + (N_FFT // 2 - HOP_LENGTH)
        ):
            self._ingest_window(len(self._win_raw))

    def _window_buffer(self, w: int) -> np.ndarray:
        """Exact-context sample buffer for window ``w``'s 800 frames.

        buffer[j] = reflect_padded_signal[w*WINDOW_SAMPLES + j]: real
        samples inside the stream, the offline reflect at its edges, zeros
        past the reflection (read only by invalid frames).  Built from a
        LOCAL slice (plus up to 200 reflected edge samples), not by
        reflect-padding the whole history, so previews and commits stay
        O(window), not O(stream).
        """
        pad = N_FFT // 2
        buf_len = (WINDOW_FRAMES - 1) * HOP_LENGTH + N_FFT
        sig = self._samples
        n = len(sig)
        lo = w * WINDOW_SAMPLES - pad          # signal coords of buf[0]
        buf = np.zeros(buf_len, np.float32)
        # Real samples.
        s0, s1 = max(lo, 0), min(lo + buf_len, n)
        if s1 > s0:
            buf[s0 - lo : s1 - lo] = sig[s0:s1]
        # Left reflect (first window only): signal[-i] = signal[i].
        if lo < 0 and n >= 2:
            k = -lo                             # samples needed before 0
            if n <= pad:
                # Tiny stream: the offline rule wraps the reflection
                # several times (np.pad semantics, audio.mel._host_pad_into).
                refl = np.pad(sig, pad, mode="reflect")
                m = min(buf_len, len(refl))
                buf[:m] = refl[:m]
                return buf
            take = min(k, n - 1)
            buf[k - take : k] = sig[1 : take + 1][::-1]
        # Right reflect: up to ``pad`` mirrored samples past the end, then
        # zeros (the offline rule, audio.mel._host_pad_into).
        t0 = n - lo
        if n >= 2 and 0 <= t0 < buf_len:
            tail_len = min(buf_len - t0, n - 1, pad)
            if tail_len > 0:
                # Forward slice then reverse: the negative-step form is
                # empty when tail_len == n - 1 (stop == -1 means "end" to
                # numpy), which a stream of exactly pad + 1 = 201 samples
                # hits.
                buf[t0 : t0 + tail_len] = sig[n - 1 - tail_len : n - 1][::-1]
        return buf

    def _window_raw(self, w: int, n_valid: int) -> tuple[torch.Tensor, float, float]:
        """Window ``w``'s UNCLAMPED log-mel (n_mels, 800) on the device and
        its max and min over the first ``n_valid`` frames."""
        with torch.inference_mode():
            buf = torch.from_numpy(self._window_buffer(w)).to(self._device)
            raw = _mel_raw(buf[None], N_FFT, HOP_LENGTH, N_MELS)[0]
            valid = raw[:, :n_valid]
            vmax, vmin = torch.stack([valid.amax(), valid.amin()]).tolist()
        return raw, vmax, vmin

    def _ingest_window(self, w: int) -> None:
        raw, vmax, vmin = self._window_raw(w, WINDOW_FRAMES)
        self._win_raw.append(raw)
        self._win_min.append(vmin)
        self._win_floor.append(np.nan)       # not yet advanced
        self._global_max = max(self._global_max, vmax)

    # -- decoder prefix maintenance ------------------------------------------

    def _features(self, raw: torch.Tensor, n_valid: int, global_max: float) -> torch.Tensor:
        """The encoder's (1, 104, H) features of one raw window clamped at
        ``global_max`` - 8, in the cache's dtype."""
        n = torch.tensor([n_valid], dtype=torch.long, device=self._device)
        gmax = torch.tensor([global_max], dtype=torch.float32, device=self._device)
        mel = _mel_finalize(raw[None], n, gmax)
        feats, _ = encoder_forward(self._model._encoder_params, self._cfg.audio_encoder, mel, n)
        return feats.to(self._dtype)

    def _advance_audio(self, feats: torch.Tensor, slot: int) -> None:
        """One window's 104 feature rows into the cache at ``slot``."""
        positions = (slot + np.arange(self._wtok))[None]
        self._kv, _ = self._gen.advance(self._kv, feats, positions, slot, self._wtok - 1)

    def _advance_window(self, w: int, floor: float) -> None:
        feats = self._features(self._win_raw[w], WINDOW_FRAMES, floor + 8.0)
        self._advance_audio(feats, 9 + w * self._wtok)
        self._win_floor[w] = floor

    def _reconcile(self, floor: float) -> None:
        """Advance new windows and re-advance any whose cached features the
        current clamp floor changes (min_raw < floor and the floor rose),
        with every window after it."""
        start = self._committed
        for w in range(self._committed):
            if self._win_min[w] < floor and floor > self._win_floor[w] + 1e-12:
                start = w
                break
        for w in range(start, len(self._win_raw)):
            self._advance_window(w, floor)
        self._committed = len(self._win_raw)

    # -- transcription --------------------------------------------------------

    def preview(self):
        """Transcript of all audio fed so far (session state kept;
        token-identical to ``model.transcribe`` of the same prefix in
        float32)."""
        from .api import TranscriptionResult

        self._check_valid()
        n_total_frames = len(self._samples) // HOP_LENGTH
        if n_total_frames == 0:
            return TranscriptionResult(text="", language="Unknown", duration=self.duration)
        try:
            with self._model._held(), torch.inference_mode():
                return self._preview_impl(n_total_frames)
        except BaseException:
            # A failure mid-preview (out of memory, an interrupt, a kernel
            # error) may leave the cache and the window floors half
            # updated: poison the session so later calls fail with a clear
            # message; reset() rebuilds the cache.
            self._invalid = True
            raise

    def _preview_impl(self, n_total_frames: int):
        from .api import TranscriptionResult

        W = len(self._win_raw)
        tail_frames = n_total_frames - W * WINDOW_FRAMES
        gmax = self._global_max
        tail_raw = None
        if tail_frames > 0:
            tail_raw, tmax, _ = self._window_raw(W, tail_frames)
            gmax = max(gmax, tmax)
        self._reconcile(gmax - 8.0)

        n_audio = W * self._wtok
        gen = self._gen
        if tail_raw is not None:
            # The whole window's 104 rows: those past the tail's tokens are
            # scratch that the suffix advance overwrites or no row attends.
            self._advance_audio(self._features(tail_raw, tail_frames, gmax), 9 + n_audio)
            n_audio += self._model._n_audio_tokens(tail_frames)

        # Suffix advance (its scratch rows sit at slots >= prompt_len, which
        # the decode never attends).
        sfx = np.zeros((1, SUFFIX_PAD), np.int64)
        sfx[0, : len(self._suffix_ids)] = self._suffix_ids
        slot = 9 + n_audio
        positions = (slot + np.arange(SUFFIX_PAD))[None]
        self._kv, first_logits = gen.advance(
            self._kv, gen.embed_ids(sfx), positions, slot, len(self._suffix_ids) - 1
        )
        prompt_len = slot + len(self._suffix_ids)

        duration = self.duration
        # The offline budget rule per prefix length.
        want = self._max_tokens if self._max_tokens is not None else max(256, int(duration * 50))
        budget = min(want, self._token_bucket)
        # The plain loop writes only decode slots (>= the prompt bucket), on
        # the CPU into this cache and on the card into the arena's copy of
        # it, so the committed prefix stays for the next preview.
        tokens = gen.decode(
            self._kv, first_logits, [prompt_len], [budget], self._token_bucket,
            plain=True, **self._opts,
        )[0]
        text, language = self._model._finalize_output(tokens, self._lang_name)
        return TranscriptionResult(text=text, language=language, duration=duration)

    @property
    def duration(self) -> float:
        return len(self._samples) / SAMPLE_RATE

    def reset(self) -> None:
        """Drop all audio and cached state (the KV cache is reused, unless a
        failed preview invalidated it: then it is rebuilt)."""
        self._samples = np.zeros(0, np.float32)
        self._win_raw.clear()
        self._win_min.clear()
        self._win_floor.clear()
        self._global_max = -np.inf
        self._committed = 0
        if self._invalid:
            self._kv = self._prefix_cache()
            self._invalid = False
