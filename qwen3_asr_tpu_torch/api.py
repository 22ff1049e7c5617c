"""Public API: ``Qwen3ASR`` — load, transcribe, warm up, close (PyTorch).

Counterpart of ``qwen3_asr_tpu/api.py`` for offline transcription:
``from_pretrained``/``from_random`` (with an explicit ``device``),
``transcribe``, ``transcribe_batch``, ``warm_up``, ``close``, the context
manager, ``TranscriptionResult`` and ``LANGUAGE_MAP``.  One request runs
mel -> encoder -> prefill (K1) -> decode as in the JAX package's
``_run_pipeline_batch``, with the same batch, frame, prompt and token
buckets, so both packages emit the same greedy token ids.  The decode is
the JAX package's default dispatch: under ``speculative="auto"`` greedy
requests of at most ``spec_auto_max_batch`` (padded) clips run the n-gram
speculative loop (verify forward + kernel K5), larger batches and
``"off"`` the plain loop (K2 with K3 fused); ``temperature > 0`` samples (top-k,
top-p, seeded ``torch.Generator``), speculatively only with
``spec_sampling``.  Clips longer than ``chunk_duration`` split at
low-energy points into chunks that run in pooled batches sized by the KV
budget, and their texts are stitched; as in the JAX package, the chunked
path ignores ``max_tokens`` (each chunk's budget is ``max(256, 50 s)``).

Int8 runs as in the JAX package, in every combination it allows:
``RuntimeConfig(quantization="int8")`` quantizes the decoder's weights
(decode matmuls and the lm head run kernel K9), ``act_quant="int8"`` on top
of it also quantizes the encoder and runs the prefill and encoder matmuls
as W8A8 (kernel K10), and ``kv_cache_dtype="int8"`` keeps the decode loop's
cache in int8 (kernel K4 with K3-int8 fused).  On CPU tensors every kernel
wrapper runs its plain PyTorch version.

The continuous-batching hooks ``make_engine`` (flat or paged
``DecodeEngine``) and ``prefill_group`` feed ``serving/server.py``'s
``ContinuousTranscriptionServer``; ``incremental_session`` opens a live
stream's ``IncrementalSession`` (``incremental.py``).

Meshes (``RuntimeConfig(dp, tp)``, ``dp * tp > 1``): one process per rank
over ``torch.distributed`` (``parallel/``).  Call
``parallel.initialize(...)`` in every rank, build the model in every rank
(each keeps its tp shards of the parameters, quantized first), and call
``transcribe``/``transcribe_batch`` with the same clips in every rank: the
clips split into ``dp`` contiguous slices, each tp group decodes its slice
with the tp collectives, and every rank gets the whole result list back
(``all_gather_object``), in input order.  On an NCCL tp group the decode
loops run as CUDA graphs with the collectives captured, as on one device
(on a gloo group eagerly, ``runtime/generate.py``); ``make_engine`` and
``prefill_group`` run on the group's shards (every rank applies the same
engine operations, as ``serving/server.py`` drives them), and
``incremental_session`` refuses meshes.  While a server drives a mesh model from its worker thread, the
model's other entry points refuse calls from any other thread
(``RuntimeError``): their collectives would interleave with the
server's.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .audio.io import SAMPLE_RATE, find_split_points, load_audio
from .audio.mel import HOP_LENGTH, N_FFT, MelFrontend, host_pad_batch, log_mel_batch
from .config import ModelConfig, RuntimeConfig
from .models.decoder import fuse_decoder_params, local_heads
from .models.encoder import encoder_forward
from .models.params import load_checkpoint, random_params
from .ops.kernels import _build
from .ops.quant import is_quantized, quantize_decoder_params, quantize_encoder_params
from .runtime.generate import Generator
from .tokenizer import EOS_TOKEN_IDS, Tokenizer
from .utils.telemetry import RequestStats, logger, stage_timer

# ISO 639-1 -> full language name (same table as the JAX package).
LANGUAGE_MAP: dict[str, str] = {
    "af": "Afrikaans", "ar": "Arabic", "az": "Azerbaijani", "be": "Belarusian",
    "bg": "Bulgarian", "bn": "Bengali", "bs": "Bosnian", "ca": "Catalan",
    "cs": "Czech", "cy": "Welsh", "da": "Danish", "de": "German",
    "el": "Greek", "en": "English", "es": "Spanish", "et": "Estonian",
    "fa": "Persian", "fi": "Finnish", "fr": "French", "gl": "Galician",
    "gu": "Gujarati", "he": "Hebrew", "hi": "Hindi", "hr": "Croatian",
    "hu": "Hungarian", "hy": "Armenian", "id": "Indonesian", "is": "Icelandic",
    "it": "Italian", "ja": "Japanese", "ka": "Georgian", "kk": "Kazakh",
    "kn": "Kannada", "ko": "Korean", "lt": "Lithuanian", "lv": "Latvian",
    "mk": "Macedonian", "ml": "Malayalam", "mn": "Mongolian", "mr": "Marathi",
    "ms": "Malay", "my": "Burmese", "ne": "Nepali", "nl": "Dutch",
    "no": "Norwegian", "pa": "Punjabi", "pl": "Polish", "pt": "Portuguese",
    "ro": "Romanian", "ru": "Russian", "si": "Sinhala", "sk": "Slovak",
    "sl": "Slovenian", "sq": "Albanian", "sr": "Serbian", "sv": "Swedish",
    "sw": "Swahili", "ta": "Tamil", "te": "Telugu", "th": "Thai",
    "tl": "Filipino", "tr": "Turkish", "uk": "Ukrainian", "ur": "Urdu",
    "uz": "Uzbek", "vi": "Vietnamese", "zh": "Chinese",
}


@dataclass
class TranscriptionResult:
    """Result of a transcription call."""

    text: str
    language: str
    duration: float


def _validate_samples(audio) -> np.ndarray:
    """1-D mono samples: float32, or int16 PCM (scaled by 1/32768 in the
    mel frontend)."""
    arr = np.asarray(audio)
    if arr.dtype != np.int16:
        arr = arr.astype(np.float32)
    if arr.ndim != 1:
        raise ValueError(f"Audio array must be 1-D (mono), got shape {arr.shape}")
    return arr


def _mesh_of(runtime: RuntimeConfig, config: ModelConfig):
    """(the (dp, tp) mesh, this rank's tp group or None) of ``runtime``;
    (None, None) for one device.  ValueError unless the process group holds
    exactly ``dp * tp`` ranks, or when tp does not divide a split width."""
    if runtime.dp * runtime.tp == 1:
        return None, None
    from .parallel import check_tp, make_mesh

    check_tp(config, runtime.tp)
    mesh = make_mesh(runtime.dp, runtime.tp)
    return mesh, mesh.tp_group()


class Qwen3ASR:
    """Qwen3-ASR speech-to-text in PyTorch.

    >>> model = Qwen3ASR.from_pretrained("/path/to/Qwen3-ASR-1.7B", device="cuda")
    >>> print(model.transcribe("audio.wav").text)
    """

    def __init__(
        self,
        config: ModelConfig,
        encoder_params,
        decoder_params,
        tokenizer: Tokenizer,
        runtime: RuntimeConfig | None = None,
    ) -> None:
        self._config = config
        self._runtime = runtime or RuntimeConfig()
        self._mesh, self._tp = _mesh_of(self._runtime, config)
        encoder_params, decoder_params = self._transform_params(
            encoder_params, decoder_params
        )
        self._encoder_params = encoder_params
        self._decoder_params = decoder_params
        self._device = decoder_params["final_norm"].device
        self._tokenizer = tokenizer
        self._lock = threading.Lock()
        #: The thread of a server that drives this mesh model's collectives
        #: (``serving/server.py``), or None: :meth:`_check_caller`.
        self._served_by: threading.Thread | None = None
        #: Timing/throughput record of the most recent transcription.
        self.last_stats: RequestStats | None = None
        self._mel = MelFrontend(self._runtime.frame_buckets)
        self._generator = Generator(decoder_params, config.text_decoder, self._runtime,
                                    tp=self._tp)

    @contextlib.contextmanager
    def _held(self):
        """The model's lock, with its generator's kernel scratch
        (``_build.Scratch``) the owner of every launch meanwhile: the
        encoder's as well as the decoder's."""
        with self._lock, _build.scratch_scope(self._generator.scratch):
            yield

    def _check_caller(self, what: str) -> None:
        """RuntimeError when a server drives this model's mesh collectives
        from another thread: a call from here would issue collectives
        between the server's, in an order the other ranks do not follow."""
        owner = self._served_by
        if owner is not None and owner is not threading.current_thread():
            raise RuntimeError(
                f"{what}: a server drives this model's mesh collectives from its worker "
                f"thread; submit to the server, or close it first")

    def _transform_params(self, encoder_params, decoder_params):
        """Storage-layout transforms of freshly loaded parameters, as JAX
        ``api.py:180-225``: fuse QKV and gate|up (on one tp rank only: the
        rules split wq/wk/wv and wg/wu), then quantize the decoder with
        ``quantization="int8"``, and the encoder only when
        ``act_quant="int8"`` as well (its W8A8 path is what uses them), then
        keep this rank's tp shards."""
        rt = self._runtime
        layer0 = decoder_params["layers"][0]
        if rt.tp > 1 and "wqkv" in layer0:
            raise ValueError("tp > 1 takes the split decoder layout (wq/wk/wv, wg/wu), "
                             "not fused wqkv/wgu")
        if rt.fuse_qkv and rt.tp == 1 and "wq" in layer0 and not is_quantized(layer0["wq"]):
            decoder_params = fuse_decoder_params(decoder_params)
        if rt.quantization == "int8":
            if not is_quantized(decoder_params["embedding"]):
                decoder_params = quantize_decoder_params(decoder_params)
            if rt.act_quant == "int8" and not is_quantized(
                encoder_params["layers"][0]["wq"]
            ):
                encoder_params = quantize_encoder_params(encoder_params)
        if rt.tp > 1:
            from .parallel import decoder_param_sharding, encoder_param_sharding, shard_params

            decoder_params = shard_params(
                decoder_params, decoder_param_sharding(decoder_params), self._mesh)
            encoder_params = shard_params(
                encoder_params, encoder_param_sharding(encoder_params), self._mesh)
        return encoder_params, decoder_params

    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        model_path: str | Path,
        runtime: RuntimeConfig | None = None,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
        **kwargs,
    ) -> "Qwen3ASR":
        """Load ``config.json``, the tokenizer and ``model.safetensors`` from a
        local checkpoint directory, or from a Hugging Face Hub repo id when
        ``model_path`` is not a directory (``huggingface_hub.snapshot_download``
        with ``kwargs``, as the JAX package's ``from_pretrained``), onto
        ``device``."""
        path = Path(model_path)
        if not path.is_dir():
            from huggingface_hub import snapshot_download

            path = Path(snapshot_download(repo_id=str(model_path), **kwargs))
        config = ModelConfig.from_pretrained(path)
        tokenizer = Tokenizer(path)
        enc, dec = load_checkpoint(path, config, dtype=dtype, device=device)
        return cls(config, enc, dec, tokenizer, runtime)

    @classmethod
    def from_random(
        cls,
        config: ModelConfig | None = None,
        tokenizer: Tokenizer | None = None,
        runtime: RuntimeConfig | None = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int | None = 0,
        device: torch.device | str = "cuda",
    ) -> "Qwen3ASR":
        """Randomly initialized model on ``device`` (benchmarks, tests);
        ``seed=None`` gives zero weights."""
        config = config or ModelConfig()
        enc, dec = random_params(config, seed=seed, dtype=dtype, device=device)
        return cls(config, enc, dec, tokenizer, runtime)

    # ------------------------------------------------------------------

    def transcribe(
        self,
        audio: str | Path | np.ndarray,
        language: Optional[str] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        repetition_penalty: float = 1.2,
        max_tokens: Optional[int] = None,
        repetition_context_size: int = 100,
        chunk_duration: float = 1200.0,
        seed: int = 0,
    ) -> TranscriptionResult:
        """Transcribe one clip (a file path or 1-D float32 16 kHz samples);
        a clip longer than ``chunk_duration`` takes the long-form path.  On
        a mesh with ``dp > 1``, every rank calls it with the same clip: the
        first dp slice decodes it (``transcribe_batch``)."""
        self._check_caller("transcribe")
        if self._runtime.dp > 1:
            return self.transcribe_batch(
                [audio], language=language, temperature=temperature, top_p=top_p,
                top_k=top_k, repetition_penalty=repetition_penalty, max_tokens=max_tokens,
                repetition_context_size=repetition_context_size,
                chunk_duration=chunk_duration, seed=seed,
            )[0]
        with self._held():
            samples = (
                load_audio(audio) if isinstance(audio, (str, Path))
                else _validate_samples(audio)
            )
            if len(samples) == 0:
                return TranscriptionResult(text="", language="Unknown", duration=0.0)
            duration = len(samples) / SAMPLE_RATE
            if max_tokens is None:
                max_tokens = max(256, int(duration * 50))
            chunk_duration = self._clamp_chunk_duration(chunk_duration)
            if duration > chunk_duration:
                return self._transcribe_chunked(
                    samples, duration, language, temperature, top_p, top_k,
                    repetition_penalty, repetition_context_size, chunk_duration,
                    seed,
                )
            lang_name = self._resolve_language(language)
            token_lists, self.last_stats = self._run_pipeline_batch(
                [samples], lang_name, temperature, top_p, top_k,
                repetition_penalty, [max_tokens], repetition_context_size, seed,
            )
            text, out_lang = self._finalize_output(token_lists[0], lang_name)
            return TranscriptionResult(text=text, language=out_lang, duration=duration)

    def transcribe_batch(
        self,
        audios: list,
        language: Optional[str] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        repetition_penalty: float = 1.2,
        max_tokens: Optional[int] = None,
        repetition_context_size: int = 100,
        chunk_duration: float = 1200.0,
        seed: int = 0,
    ) -> list[TranscriptionResult]:
        """Transcribe several clips in one batched mel/encoder/prefill pass
        and one decode loop (per-clip EOS and token budgets).  Clips longer
        than ``chunk_duration`` take the long-form path, all their chunks
        pooled into shared groups; the rest still run as one batch.

        On a mesh with ``dp > 1`` every rank calls it with the same clips:
        dp coordinate d takes the d-th of ``dp`` contiguous slices (the
        first ``len % dp`` one clip longer), its tp group transcribes that
        slice as above (a coordinate with no clip decodes nothing), and the
        slices' results come back to every rank through
        ``all_gather_object`` over the world, in input order."""
        self._check_caller("transcribe_batch")
        options = dict(
            language=language, temperature=temperature, top_p=top_p, top_k=top_k,
            repetition_penalty=repetition_penalty, max_tokens=max_tokens,
            repetition_context_size=repetition_context_size,
            chunk_duration=chunk_duration, seed=seed,
        )
        if self._runtime.dp > 1:
            return self._transcribe_batch_dp(list(audios), options)
        return self._transcribe_batch_local(audios, **options)

    def _transcribe_batch_dp(self, audios: list, options: dict) -> list[TranscriptionResult]:
        import torch.distributed as dist

        dp, tp = self._runtime.dp, self._runtime.tp
        per, extra = divmod(len(audios), dp)
        d = self._mesh.coordinate["dp"]
        lo = d * per + min(d, extra)
        mine = audios[lo : lo + per + (d < extra)]
        local = self._transcribe_batch_local(mine, **options) if mine else []
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local)
        return [r for rank in range(0, dp * tp, tp) for r in gathered[rank]]

    def _transcribe_batch_local(
        self, audios, language=None, temperature=0.0, top_p=1.0, top_k=0,
        repetition_penalty=1.2, max_tokens=None, repetition_context_size=100,
        chunk_duration=1200.0, seed=0,
    ) -> list[TranscriptionResult]:
        """:meth:`transcribe_batch` of this rank's clips (all of them off a
        dp mesh)."""
        with self._held():
            lang_name = self._resolve_language(language)
            samples_list = [
                load_audio(a) if isinstance(a, (str, Path)) else _validate_samples(a)
                for a in audios
            ]
            results = [
                TranscriptionResult(text="", language="Unknown", duration=0.0)
                for _ in samples_list
            ]
            live = [i for i, s in enumerate(samples_list) if len(s) > 0]
            if not live:
                return results
            chunk_duration = self._clamp_chunk_duration(chunk_duration)
            chunk_samples = int(chunk_duration * SAMPLE_RATE)
            short_live = [i for i in live if len(samples_list[i]) <= chunk_samples]
            long_live = [i for i in live if len(samples_list[i]) > chunk_samples]
            if short_live:
                batch = [samples_list[i] for i in short_live]
                durations = [len(s) / SAMPLE_RATE for s in batch]
                budgets = [
                    max_tokens if max_tokens is not None else max(256, int(d * 50))
                    for d in durations
                ]
                token_lists, self.last_stats = self._run_pipeline_batch(
                    batch, lang_name, temperature, top_p, top_k,
                    repetition_penalty, budgets, repetition_context_size, seed,
                )
                for i, toks, dur in zip(short_live, token_lists, durations):
                    text, out_lang = self._finalize_output(toks, lang_name)
                    results[i] = TranscriptionResult(
                        text=text, language=out_lang, duration=dur
                    )
            if long_live:
                # Every long clip's chunks share groups; outputs keep their
                # order, so ownership is positional.
                all_chunks: list = []
                owners: list[int] = []
                for i in long_live:
                    cs = self._split_long_chunks(samples_list[i], chunk_duration)
                    all_chunks.extend(cs)
                    owners.extend([i] * len(cs))
                texts, detected = self._run_chunks_grouped(
                    all_chunks, lang_name, temperature, top_p, top_k,
                    repetition_penalty, repetition_context_size, seed,
                )
                per: dict[int, list[tuple[str, str]]] = {i: [] for i in long_live}
                for own, text, lang in zip(owners, texts, detected):
                    if text:
                        per[own].append((text, lang))
                for i in long_live:
                    keep = per[i]
                    language_out = lang_name if lang_name is not None else (
                        keep[0][1] if keep else "Unknown"
                    )
                    results[i] = TranscriptionResult(
                        text=" ".join(t for t, _ in keep),
                        language=language_out,
                        duration=len(samples_list[i]) / SAMPLE_RATE,
                    )
            return results

    def warm_up(
        self,
        durations: tuple[float, ...] = (0.5,),
        batch_sizes: tuple[int, ...] = (1,),
        max_tokens: int | tuple[int, ...] = 2,
        deployment: dict | None = None,
    ) -> None:
        """Run silent clips through every (batch, duration, token budget)
        cell of a deployment once: builds the CUDA kernels, warms PyTorch's
        allocator and library handles for the shapes it will see, and on
        CUDA captures each cell's greedy decode graph and sizes the graphs'
        cache arena for the largest cell (when a later cell grows the
        arena, which drops the graphs, the cells run once more), so a first
        request pays no capture.  Pass the grid directly or as one
        ``deployment`` dict, as in the JAX package:

            model.warm_up(deployment={
                "durations": (10.0, 30.0),
                "batch_sizes": (1, 8, 48),
                "max_tokens": (128, 1024),
            })

        Each cell is logged as it starts.  The JAX package ends with
        ``wait_ready()`` for its background TPU compile, which is not
        ported: here every cell has run when this returns.  On a mesh every
        rank warms every cell itself (no dp split; a tp group together).
        """
        self._check_caller("warm_up")
        if deployment is not None:
            durations = tuple(deployment.get("durations", durations))
            batch_sizes = tuple(deployment.get("batch_sizes", batch_sizes))
            max_tokens = deployment.get("max_tokens", max_tokens)
        budgets = (max_tokens,) if isinstance(max_tokens, int) else tuple(max_tokens)
        cells = [(b, d, m) for b in batch_sizes for d in durations for m in budgets]

        def growths() -> int:
            graphs = self._generator.graphs
            return graphs.growths if graphs is not None else 0

        for _ in range(2):
            before = growths()
            for i, (b, d, m) in enumerate(cells):
                logger.info("warm_up %d/%d: batch=%d duration=%.1fs max_tokens=%d",
                            i + 1, len(cells), b, d, m)
                clips = [np.zeros(max(1, int(d * SAMPLE_RATE)), dtype=np.float32)] * b
                if self._runtime.dp == 1:
                    self.transcribe_batch(clips, max_tokens=m)
                else:
                    self._transcribe_batch_local(clips, max_tokens=m)
                if i == 0:
                    before = growths()
            if growths() == before:
                break
        logger.info("warm_up complete: %d program shapes compiled", len(cells))

    def close(self) -> None:
        """Release parameters, the decode graphs and their cache arena (and
        cached device memory)."""
        self._encoder_params = None
        self._decoder_params = None
        if self._generator is not None:
            self._generator.close()
            self._generator.params = None
        self._generator = None
        gc.collect()
        if self._device.type == "cuda":
            torch.cuda.empty_cache()

    def __enter__(self) -> "Qwen3ASR":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------

    def _split_long_chunks(self, samples, chunk_duration: float) -> list:
        """Slice a long clip at low-energy boundaries; the search window is
        5 s where the bucket table affords it, else half the slack left, so
        every chunk fits the largest frame bucket (JAX ``api.py:1092``)."""
        max_bucket_s = self._runtime.frame_buckets[-1] * HOP_LENGTH / SAMPLE_RATE
        search_s = max(0.0, min(5.0, (max_bucket_s - chunk_duration) / 2))
        chunk_samples = int(chunk_duration * SAMPLE_RATE)
        split_points = find_split_points(
            samples, chunk_samples, int(search_s * SAMPLE_RATE)
        )
        chunks, prev = [], 0
        for sp in split_points + [len(samples)]:
            if sp > prev:
                chunks.append(samples[prev:sp])
            prev = sp
        return chunks

    def _transcribe_chunked(
        self, samples, duration, language, temperature, top_p, top_k,
        repetition_penalty, repetition_context_size, chunk_duration, seed,
    ) -> TranscriptionResult:
        """Long-form path: split at low-energy boundaries, stitch texts."""
        lang_name = self._resolve_language(language)
        chunks = self._split_long_chunks(samples, chunk_duration)
        texts, detected = self._run_chunks_grouped(
            chunks, lang_name, temperature, top_p, top_k,
            repetition_penalty, repetition_context_size, seed,
        )
        keep = [(t, lg) for t, lg in zip(texts, detected) if t]
        language_out = lang_name if lang_name is not None else (
            keep[0][1] if keep else "Unknown"
        )
        return TranscriptionResult(
            text=" ".join(t for t, _ in keep), language=language_out, duration=duration,
        )

    def _run_chunks_grouped(
        self, chunks, lang_name, temperature, top_p, top_k,
        repetition_penalty, repetition_context_size, seed,
    ) -> tuple[list[str], list[str]]:
        """Per-chunk texts and detected languages, in order (empty texts
        included), from groups of at most ``max_batch_size`` chunks, fewer
        where the KV budget (``kv_cache_budget_gb``) cannot hold that many
        caches of the longest chunk.  Each chunk's token budget is
        ``max(256, 50 * seconds)``: the caller's ``max_tokens`` is ignored,
        as in the JAX package (``api.py:1134-1181``)."""
        group_size = max(1, self._runtime.max_batch_size)
        if chunks:
            tc = self._config.text_decoder
            ac = self._config.audio_encoder
            frames_bucket = self._mel.bucket_for(max(len(c) for c in chunks))
            slots = (
                frames_bucket // ac.chunk_frames * ac.tokens_per_chunk
                + 32
                + self._runtime.max_decode_slots
            )
            per_seq_bytes = (
                tc.num_hidden_layers * local_heads(tc, self._tp)[1] * slots * tc.head_dim * 2 * 2
            )
            budget = int(self._runtime.kv_cache_budget_gb * 2**30)
            group_size = max(1, min(group_size, budget // max(per_seq_bytes, 1)))
        texts: list[str] = []
        detected: list[str] = []
        for start in range(0, len(chunks), group_size):
            group = chunks[start : start + group_size]
            budgets = [max(256, int(len(c) / SAMPLE_RATE * 50)) for c in group]
            token_lists, self.last_stats = self._run_pipeline_batch(
                group, lang_name, temperature, top_p, top_k,
                repetition_penalty, budgets, repetition_context_size, seed,
            )
            for toks in token_lists:
                text, out_lang = self._finalize_output(toks, lang_name)
                texts.append(text)
                detected.append(out_lang)
        return texts, detected

    def _run_pipeline_batch(
        self, samples_list, lang_name, temperature, top_p, top_k,
        repetition_penalty, max_tokens_list, repetition_context_size, seed,
    ):
        """Shared batched core: (token lists, RequestStats for the batch)."""
        gen = self._generator
        device = self._device
        B = len(samples_list)
        stats = RequestStats(audio_seconds=sum(len(s) for s in samples_list) / SAMPLE_RATE)
        # Batch bucketing as in the JAX package: padding lanes are
        # one-token-budget silence.
        B_pad = self._batch_bucket(B)
        if B_pad > B:
            pad_dtype = (
                np.int16 if all(s.dtype == np.int16 for s in samples_list)
                else np.float32
            )
            samples_list = list(samples_list) + [np.zeros(N_FFT, pad_dtype)] * (B_pad - B)
            max_tokens_list = list(max_tokens_list) + [1] * (B_pad - B)
        n_real, B = B, B_pad

        with stage_timer(stats, "prepare"):
            if all(s.dtype == np.int16 for s in samples_list):
                transport = samples_list
            else:
                transport = [
                    s.astype(np.float32) / 32768.0 if s.dtype == np.int16 else s
                    for s in samples_list
                ]
            bucket = max(self._mel.bucket_for(len(s)) for s in samples_list)
            n_valid = [len(s) // HOP_LENGTH for s in samples_list]
            n_audio = [self._n_audio_tokens(v) for v in n_valid]
            prompts = [self._tokenizer.build_prompt(n, lang_name) for n in n_audio]
            prompt_lens = [len(p) for p in prompts]
            stats.n_prompt_tokens = sum(prompt_lens)
            ac = self._config.audio_encoder
            audio_token_bucket = bucket // ac.chunk_frames * ac.tokens_per_chunk
            prompt_bucket, token_bucket, cache_len = gen.plan(
                audio_token_bucket, max(prompt_lens), max(max_tokens_list), batch=B
            )
            run_len = self._runtime.plan_prefill_run(max(prompt_lens), prompt_bucket)
            ids = gen.pack_prompts(prompts, run_len)
            padded = host_pad_batch(transport, bucket, N_FFT, HOP_LENGTH)

        with torch.inference_mode():
            with stage_timer(stats, "prefill"):
                n_valid_t = torch.tensor(n_valid, dtype=torch.long, device=device)
                mel = log_mel_batch(torch.from_numpy(padded).to(device), n_valid_t, bucket)
                features, _ = encoder_forward(
                    self._encoder_params, self._config.audio_encoder, mel, n_valid_t,
                    tp=self._tp,
                )
                kv, first_logits = gen.prefill(
                    features,
                    torch.from_numpy(ids).to(device),
                    torch.tensor(n_audio, dtype=torch.long, device=device),
                    torch.tensor(prompt_lens, dtype=torch.long, device=device),
                    cache_len, arena=True,
                )
                if device.type == "cuda":
                    # Stage times then hold the device work; the decode
                    # loop's first step would wait here anyway.  The
                    # stream, not the device: a device-wide sync would break
                    # another replica's graph capture on this card.
                    torch.cuda.current_stream(device).synchronize()
            with stage_timer(stats, "decode"):
                token_lists = gen.decode(
                    kv, first_logits, prompt_lens, list(max_tokens_list), token_bucket,
                    temperature=temperature, top_p=top_p, top_k=top_k,
                    repetition_penalty=repetition_penalty,
                    repetition_context_size=repetition_context_size, seed=seed,
                )
        token_lists = token_lists[:n_real]
        stats.n_generated_tokens = sum(len(t) for t in token_lists)
        stats.n_decode_steps = gen.last_decode_steps
        stats.n_decode_replays = gen.last_replays
        stats.n_host_syncs = gen.last_host_syncs
        # Lane-forwards: every verify iteration computes one row per lane.
        stats.n_spec_forwards = gen.last_spec_forwards * n_real
        logger.debug("transcribe stats (batch=%d): %s", B, stats.as_dict())
        return token_lists, stats

    # -- live streams and continuous-batching engine hooks ---------------

    def incremental_session(self, **kwargs):
        """Open an :class:`~qwen3_asr_tpu_torch.incremental.IncrementalSession`
        on the model's device (JAX ``api.py:885-896``): live-stream
        transcription whose completed 8 s encoder windows are encoded and
        advanced into a decoder-prefix KV cache of the session's own once,
        so ``preview()`` costs one tail-window encode, a short cached
        advance and the decode loop instead of a prefill of the whole tail.
        Each preview is token-identical to ``transcribe`` of the same
        prefix in float32 (``incremental.py``)."""
        from .incremental import IncrementalSession

        return IncrementalSession(self, **kwargs)

    def make_engine(
        self,
        n_slots: int = 8,
        max_duration: float = 30.0,
        max_new_tokens: int = 512,
        chunk_steps: int = 32,
        paged: bool = False,
        page_size: int = 256,
        kv_pool_gb: float | None = None,
        eager: bool = False,
    ):
        """A :class:`~qwen3_asr_tpu_torch.runtime.engine.DecodeEngine` sized
        for clips up to ``max_duration`` seconds and transcripts up to
        ``max_new_tokens`` tokens (both rounded up to buckets), on the
        model's device (JAX ``api.py:898-956``).  ``paged=True`` backs it
        with a page pool of ``kv_pool_gb`` (default ``kv_cache_budget_gb``),
        at most every slot's worst case: slots then hold pages for their
        actual prompt and transcript lengths.  ``eager=True`` makes an
        engine whose chunks run eagerly on the card too (the oracle of its
        captured chunks).

        On a tp group every rank makes the engine with the same arguments:
        the page count comes from the global KV heads, so it equals one
        device's engine's, and each rank's pool holds its own heads, ``1/tp``
        of the bytes.  The ranks must then apply the same engine operations
        (``prefill_group`` + ``admit``, ``step``, ``retire``) in the same
        order, as ``ContinuousTranscriptionServer`` has the group's first
        rank drive them (``parallel/lockstep.py``)."""
        from .runtime.engine import DecodeEngine

        gen = self._generator
        bucket = self._mel.bucket_for(int(max_duration * SAMPLE_RATE))
        ac = self._config.audio_encoder
        atb = bucket // ac.chunk_frames * ac.tokens_per_chunk
        prompt_bucket, token_bucket, _ = gen.plan(atb, atb + 20, max_new_tokens)
        token_bucket = max(128, token_bucket)
        n_pages = None
        if paged:
            tc = self._config.text_decoder
            # Bytes per cached row: bf16 2 * D; int8 D + 4 (the f32 scale).
            row_bytes = (
                tc.head_dim + 4 if self._runtime.kv_cache_dtype == "int8"
                else tc.head_dim * 2
            )
            # The global KV heads: one device's page count on any tp group.
            page_bytes = tc.num_hidden_layers * tc.num_key_value_heads * page_size * row_bytes * 2
            budget_gb = kv_pool_gb if kv_pool_gb is not None else self._runtime.kv_cache_budget_gb
            n_pages = max(4, int(budget_gb * 2**30) // page_bytes)
            full = 1 + n_slots * (-(-prompt_bucket // page_size) - (-token_bucket // page_size))
            n_pages = min(n_pages, full)
        return DecodeEngine(
            gen, prompt_bucket, token_bucket, n_slots=n_slots, chunk_steps=chunk_steps,
            paged=paged, page_size=page_size, n_pages=n_pages, eager=eager,
        )

    def prefill_group(self, samples_list, lang_names):
        """Prefill an admission group for the continuous engine (JAX
        ``api.py:958-1019``): returns ``(kv, first_logits, prompts)``, ``kv``
        covering only the prompt region (cache length = the group's prompt
        bucket).  ``lang_names`` are resolved full names (None: detect), one
        per clip.  The group's batch is padded to a power of two with silent
        clips and sliced back, as in the JAX package.  On a tp group every
        rank calls it with the same clips: the encoder and the prefill run
        with the group's collectives, and ``kv`` holds this rank's KV
        heads."""
        self._check_caller("prefill_group")
        gen = self._generator
        device = self._device
        n_real = len(samples_list)
        bg_pad = 1 << (n_real - 1).bit_length() if n_real > 1 else 1
        if all(s.dtype == np.int16 for s in samples_list):
            transport = list(samples_list)
            pad_clip = np.zeros(N_FFT, np.int16)
        else:
            transport = [
                s.astype(np.float32) / 32768.0 if s.dtype == np.int16 else s
                for s in samples_list
            ]
            pad_clip = np.zeros(N_FFT, np.float32)
        transport += [pad_clip] * (bg_pad - n_real)
        bucket = max(self._mel.bucket_for(len(s)) for s in samples_list)
        n_valid = [len(s) // HOP_LENGTH for s in transport]
        n_audio = [self._n_audio_tokens(v) for v in n_valid]
        prompts = [
            self._tokenizer.build_prompt(n, lang) for n, lang in zip(n_audio, lang_names)
        ] + [self._tokenizer.build_prompt(n, "English") for n in n_audio[n_real:]]
        prompt_lens = [len(p) for p in prompts]
        ac = self._config.audio_encoder
        atb = bucket // ac.chunk_frames * ac.tokens_per_chunk
        pb_g = gen.plan(atb, max(prompt_lens), 1)[0]
        run_g = self._runtime.plan_prefill_run(max(prompt_lens), pb_g)
        ids = gen.pack_prompts(prompts, run_g)
        padded = host_pad_batch(transport, bucket, N_FFT, HOP_LENGTH)
        with self._held(), torch.inference_mode():
            n_valid_t = torch.tensor(n_valid, dtype=torch.long, device=device)
            mel = log_mel_batch(torch.from_numpy(padded).to(device), n_valid_t, bucket)
            features, _ = encoder_forward(
                self._encoder_params, self._config.audio_encoder, mel, n_valid_t,
                tp=self._tp,
            )
            kv, first_logits = gen.prefill(
                features,
                torch.from_numpy(ids).to(device),
                torch.tensor(n_audio, dtype=torch.long, device=device),
                torch.tensor(prompt_lens, dtype=torch.long, device=device),
                pb_g,
            )
        if bg_pad > n_real:
            kv = (kv[0][:, :n_real], kv[1][:, :n_real])
            first_logits = first_logits[:n_real]
        return kv, first_logits, prompts[:n_real]

    def _batch_bucket(self, B: int) -> int:
        """Powers of two below 8, multiples of 8 above (identity when
        ``batch_bucketing`` is off or B is a multiple of 8)."""
        if not self._runtime.batch_bucketing or B % 8 == 0:
            return B
        if B < 8:
            return 1 << (B - 1).bit_length()
        return -(-B // 8) * 8

    def _n_audio_tokens(self, n_valid_frames: int) -> int:
        """Host-side audio-token count (mirror of ``valid_token_count``)."""
        cfg = self._config.audio_encoder
        full, rem = divmod(n_valid_frames, cfg.chunk_frames)
        rem_tokens = rem
        for _ in range(3):
            rem_tokens = (rem_tokens - 1) // 2 + 1 if rem_tokens > 0 else 0
        return full * cfg.tokens_per_chunk + rem_tokens

    def _resolve_language(self, language: Optional[str]) -> Optional[str]:
        """Hint -> full name; "detect" -> None (model-side detection)."""
        if language is not None and language.lower() == "detect":
            return None
        if language is None or language.lower() in ("auto", ""):
            return "English"
        return LANGUAGE_MAP.get(language.lower(), language)

    def _decode_output(self, tokens: list[int]) -> str:
        while tokens and tokens[-1] in EOS_TOKEN_IDS:
            tokens = tokens[:-1]
        return self._tokenizer.decode(tokens, skip_special_tokens=True).strip()

    def _finalize_output(self, tokens: list[int], lang_name: Optional[str]) -> tuple[str, str]:
        """(text, language) from generated ids; detect mode parses the
        ``language X<asr_text>transcript`` output."""
        if lang_name is not None:
            return self._decode_output(tokens), lang_name
        from .tokenizer import parse_language, parse_output

        while tokens and tokens[-1] in EOS_TOKEN_IDS:
            tokens = tokens[:-1]
        raw = self._tokenizer.decode(tokens, skip_special_tokens=False)
        return parse_output(raw), parse_language(raw) or "Unknown"

    def _clamp_chunk_duration(self, chunk_duration: float) -> float:
        """The JAX package's cap: the largest frame bucket minus up to 10 s
        of slack, since both ends of an interior chunk may snap outward by
        the 5 s search window."""
        max_bucket_s = self._runtime.frame_buckets[-1] * HOP_LENGTH / SAMPLE_RATE
        slack = min(10.0, max_bucket_s / 2)
        return max(min(chunk_duration, max_bucket_s - slack), 1.0)
