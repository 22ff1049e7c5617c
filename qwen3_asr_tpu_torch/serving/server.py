"""Transcription servers (counterpart of ``qwen3_asr_tpu/serving/server.py``).

Concurrent callers submit clips and get futures back:

  caller threads --submit()--> queue --worker thread--> model -> futures

* :class:`TranscriptionServer` batches at admission: the worker drains the
  queue up to ``max_batch_size`` requests of one batch key (sampling options
  and mel frame bucket), waiting at most ``batch_window_ms`` after the first,
  and runs them as one ``transcribe_batch``; if the batch raises, each
  request is retried alone so one bad clip fails only its own future.
* :class:`ContinuousTranscriptionServer` drives a persistent
  :class:`~qwen3_asr_tpu_torch.runtime.engine.DecodeEngine` (paged by
  default): the worker alternates decode chunks with admission and
  retirement, so a request submitted mid-decode starts after at most one
  chunk and finished sequences free their slots without stopping the batch.
  An admitted request's future carries ``ttft_s``, the seconds from submit
  to the end of its prefill.
* :class:`ReplicatedTranscriptionServer` scales out by data parallelism in
  one process: one whole model replica per device, one worker thread per
  replica, all draining one shared queue as :class:`TranscriptionServer`'s
  worker drains its own.  No collective crosses replicas.

The worker threads enter ``torch.inference_mode()`` themselves (PyTorch's
grad mode is per thread).  On a tp mesh (``RuntimeConfig(tp > 1)``, one
process per rank) every rank would have to admit and step in lockstep,
which is a design of its own: the drain and continuous servers raise
``NotImplementedError`` there, and the drain server also on a dp mesh,
whose ``transcribe_batch`` is a collective over every rank.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import torch


def _refuse_tp(model, what: str) -> None:
    if model._runtime.tp > 1:
        from ..api import MESH_LATER

        raise NotImplementedError(f"{what}: {MESH_LATER}")


@dataclass
class _Request:
    audio: object
    options: dict
    future: Future
    #: Client-side enqueue time (``time.time()``); ``future.ttft_s`` is
    #: stamped from it when the request's prefill completes.
    submit_ts: float = 0.0

    def batch_key(self, frame_buckets=None) -> tuple:
        """Requests batch together only with the same sampling options and
        the same mel frame bucket of the serving model's table (a 1 s clip
        batched with a 10-minute clip would pad to the long bucket)."""
        try:
            from ..config import DEFAULT_FRAME_BUCKETS

            buckets = frame_buckets or DEFAULT_FRAME_BUCKETS
            n = len(self.audio) if not isinstance(self.audio, (str,)) else -1
            if n >= 0:
                frames = int(n) // 160
                bucket = next((b for b in buckets if frames <= b), buckets[-1])
            else:
                bucket = -1  # file paths: length unknown without decoding
        except Exception:  # noqa: BLE001
            bucket = -1
        return (bucket, tuple(sorted(self.options.items())))


@dataclass
class ServerStats:
    """Aggregate serving counters, updated from the submitting threads and
    the worker through :meth:`bump` and :meth:`record_batch`."""

    requests: int = 0
    batches: int = 0
    failures: int = 0
    batched_requests: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def bump(self, field_name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field_name, getattr(self, field_name) + by)

    def record_batch(self, size: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += size

    @property
    def mean_batch_size(self) -> float:
        with self._lock:
            if not self.batches:
                return 0.0
            return self.batched_requests / self.batches


def _deliver(fut: Future, result=None, exc=None) -> None:
    """Resolve a future; a future the caller cancelled is left alone (its
    ``set_result`` would raise and kill the worker)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:  # noqa: BLE001 -- cancelled or already resolved
        pass


def _collect_batch(
    q: "queue.Queue[_Request | None]", max_batch: int, window_s: float,
    frame_buckets=None,
) -> "list[_Request] | None":
    """Up to ``max_batch`` requests of the first one's batch key, waiting at
    most ``window_s`` after it; ``None`` is the shutdown sentinel (re-posted
    after any deferred requests when seen mid-batch)."""
    first = q.get()
    if first is None:
        return None
    batch = [first]
    key = first.batch_key(frame_buckets)
    deferred: list[_Request] = []
    saw_sentinel = False
    deadline = time.monotonic() + window_s
    while len(batch) < max_batch:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            req = q.get(timeout=remaining)
        except queue.Empty:
            break
        if req is None:
            saw_sentinel = True
            break
        if req.batch_key(frame_buckets) == key:
            batch.append(req)
        else:
            deferred.append(req)
    for req in deferred:  # other options -> a later batch
        q.put(req)
    if saw_sentinel:
        q.put(None)
    return batch


class TranscriptionServer:
    """Batch-at-admission serving around a :class:`Qwen3ASR` model."""

    def __init__(self, model, max_batch_size: int = 8, batch_window_ms: float = 15.0) -> None:
        _refuse_tp(model, "TranscriptionServer")
        if model._runtime.dp > 1:
            raise NotImplementedError(
                "TranscriptionServer on a dp mesh: its transcribe_batch is a collective over "
                "every rank; serve one replica per device with ReplicatedTranscriptionServer")
        self._model = model
        self._max_batch = max_batch_size
        self._window_s = batch_window_ms / 1000.0
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self.stats = ServerStats()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, audio, **options) -> Future:
        """Enqueue one clip; returns a Future[TranscriptionResult]."""
        if self._closed:
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._queue.put(_Request(audio, options, fut, time.time()))
        self.stats.bump("requests")
        return fut

    def transcribe(self, audio, **options):
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(audio, **options).result()

    def close(self) -> None:
        """Drain and stop the worker."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self) -> None:
        with torch.inference_mode():
            while True:
                batch = _collect_batch(
                    self._queue, self._max_batch, self._window_s,
                    self._model._runtime.frame_buckets,
                )
                if batch is None:
                    return
                self.stats.record_batch(len(batch))
                try:
                    results = self._model.transcribe_batch(
                        [r.audio for r in batch], **batch[0].options
                    )
                    for req, res in zip(batch, results):
                        _deliver(req.future, res)
                except Exception:
                    # Isolate: retry each clip alone; per-request errors.
                    for req in batch:
                        try:
                            _deliver(req.future, self._model.transcribe(req.audio, **req.options))
                        except Exception as exc:  # noqa: BLE001
                            self.stats.bump("failures")
                            _deliver(req.future, exc=exc)


class ContinuousTranscriptionServer:
    """In-flight continuous batching: requests join a running decode.

    Builds ``model.make_engine(...)`` (paged by default) and serves it from
    one worker thread.  Clips longer than ``max_duration`` are rejected on
    their future (``model.transcribe`` takes long-form audio).  At most
    ``admit_batch`` (default ``n_slots``) requests are prefilled per
    admission.  ``warm=True`` (or a tuple of durations) runs one prefill,
    admit, chunk and retire cycle per admission-group size before serving.
    """

    def __init__(
        self,
        model,
        n_slots: int = 8,
        max_duration: float = 30.0,
        max_new_tokens: int = 512,
        chunk_steps: int = 32,
        admit_batch: int = 0,
        paged: bool = True,
        page_size: int = 256,
        kv_pool_gb: float | None = None,
        warm: bool | tuple[float, ...] = False,
    ) -> None:
        _refuse_tp(model, "ContinuousTranscriptionServer")
        self._model = model
        self._engine = model.make_engine(
            n_slots=n_slots, max_duration=max_duration, max_new_tokens=max_new_tokens,
            chunk_steps=chunk_steps, paged=paged, page_size=page_size,
            kv_pool_gb=kv_pool_gb,
        )
        self._max_duration = max_duration
        self._admit_batch = admit_batch or n_slots
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self.stats = ServerStats()
        self._closed = False
        if warm:
            self._warm_up(warm if isinstance(warm, (tuple, list)) else (max_duration,))
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _warm_requests(self, clip, prompts):
        from ..runtime.engine import SlotRequest

        return [
            SlotRequest(samples=clip, prompt=p, max_new=2, temperature=0.0, top_k=0,
                        top_p=1.0, repetition_penalty=1.2, repetition_context_size=100,
                        seed=0, meta=None)
            for p in prompts
        ]

    def _warm_up(self, durations: tuple[float, ...]) -> None:
        """One prefill + admit + chunk + retire cycle at every admission-group
        size up to ``min(n_slots, admit_batch)`` for each duration, before the
        worker starts; then, with admissions capped below ``n_slots``, every
        slot filled through capped admissions and one full-width chunk.  On
        the card this builds the kernels and warms PyTorch's allocator and
        library handles at the serving shapes."""
        import numpy as np

        from ..audio.io import SAMPLE_RATE
        from ..utils.telemetry import logger

        engine = self._engine
        sizes = list(range(1, min(engine.n_slots, self._admit_batch) + 1))
        cells = [(d, bg) for d in durations for bg in sizes]
        for i, (dur, bg) in enumerate(cells):
            logger.info("continuous-server warm_up %d/%d: %.0fs group size %d",
                        i + 1, len(cells), dur, bg)
            clip = np.zeros(int(dur * SAMPLE_RATE), np.float32)
            try:
                kv, first_logits, prompts = self._model.prefill_group(
                    [clip] * bg, ["English"] * bg
                )
            except torch.cuda.OutOfMemoryError as exc:
                raise RuntimeError(
                    f"continuous-server warm_up ran out of device memory at "
                    f"admission-group size {bg} (padded prefill width "
                    f"{1 << (bg - 1).bit_length() if bg > 1 else 1}) with "
                    f"n_slots={engine.n_slots}.  The KV page pool plus the widest "
                    f"admission prefill must fit the device together; options: "
                    f"lower admit_batch= (caps prefill width without reducing "
                    f"slots), RuntimeConfig(kv_cache_dtype='int8') (halves the "
                    f"pool), kv_pool_gb= (bounds the pool and oversubscribes), "
                    f"or fewer n_slots."
                ) from exc
            engine.admit(kv, first_logits, engine.free_slots(), self._warm_requests(clip, prompts))
            engine.step()
            engine.retire()
        if self._admit_batch < engine.n_slots:
            logger.info("continuous-server warm_up: full-width chunk (%d slots, "
                        "admissions capped at %d)", engine.n_slots, self._admit_batch)
            for dur in durations:
                clip = np.zeros(int(dur * SAMPLE_RATE), np.float32)
                while True:
                    free = engine.free_slots()
                    if not free:
                        break
                    bg = min(len(free), self._admit_batch)
                    kv, first_logits, prompts = self._model.prefill_group(
                        [clip] * bg, ["English"] * bg
                    )
                    if engine.admit(kv, first_logits, free[:bg],
                                    self._warm_requests(clip, prompts)):
                        # The pool holds fewer slots at this length: warm
                        # the reachable width (nothing retires during the fill).
                        break
                engine.step()
                while engine.n_live() > 0:
                    engine.retire()
                    if engine.n_live() > 0:
                        engine.step()
        logger.info("continuous-server warm_up done (%d cells)", len(cells))

    @property
    def engine_stats(self):
        return self._engine.stats

    # -- client API ----------------------------------------------------------

    def submit(self, audio, **options) -> Future:
        if self._closed:
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._queue.put(_Request(audio, options, fut, time.time()))
        self.stats.bump("requests")
        return fut

    def transcribe(self, audio, **options):
        return self.submit(audio, **options).result()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker --------------------------------------------------------------

    def _drain_new(self, block: bool) -> list[_Request] | None:
        """Pending requests up to the free-slot count; ``None`` = shutdown."""
        want = min(len(self._engine.free_slots()), self._admit_batch)
        out: list[_Request] = []
        while len(out) < want:
            try:
                req = self._queue.get(block=block and not out, timeout=None)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)
                return out or None
            out.append(req)
            block = False
        return out

    def _admit(self, reqs: list[_Request]) -> list[_Request]:
        """Admit up to the engine's free slots and ``admit_batch``; returns
        the requests deferred (page pool exhausted, or over the cap) for a
        retry after retirements."""
        from ..api import TranscriptionResult, _validate_samples
        from ..audio.io import SAMPLE_RATE, load_audio
        from ..runtime.engine import SlotRequest

        # Never prefill more than the free slots or the admission cap (the
        # deferred retry concatenates deferred and fresh requests).
        cap = min(len(self._engine.free_slots()), self._admit_batch)
        reqs, overflow = reqs[:cap], reqs[cap:]
        ready = []
        for req in reqs:
            try:
                if isinstance(req.audio, str) or hasattr(req.audio, "__fspath__"):
                    samples = load_audio(req.audio)
                else:
                    samples = _validate_samples(req.audio)
                duration = len(samples) / SAMPLE_RATE
                if len(samples) == 0:
                    _deliver(req.future, TranscriptionResult(text="", language="Unknown",
                                                             duration=0.0))
                    continue
                if duration > self._max_duration:
                    raise ValueError(
                        f"clip of {duration:.0f}s exceeds this server's "
                        f"max_duration={self._max_duration:.0f}s; use "
                        "model.transcribe() for long-form audio"
                    )
                lang = self._model._resolve_language(req.options.get("language"))
                ready.append((req, samples, lang, duration))
            except Exception as exc:  # noqa: BLE001
                self.stats.bump("failures")
                _deliver(req.future, exc=exc)
        if not ready:
            return overflow
        try:
            kv, first_logits, prompts = self._model.prefill_group(
                [r[1] for r in ready], [r[2] for r in ready]
            )
            slot_reqs = []
            for (req, samples, lang, duration), prompt in zip(ready, prompts):
                opts = req.options
                slot_reqs.append(SlotRequest(
                    samples=samples,
                    prompt=prompt,
                    max_new=opts.get("max_tokens") or max(256, int(duration * 50)),
                    temperature=opts.get("temperature", 0.0),
                    top_k=opts.get("top_k", 0),
                    top_p=opts.get("top_p", 1.0),
                    repetition_penalty=opts.get("repetition_penalty", 1.2),
                    repetition_context_size=opts.get("repetition_context_size", 100),
                    seed=opts.get("seed", 0),
                    meta=(req.future, lang, duration),
                ))
            by_slotreq = {id(sr): r[0] for sr, r in zip(slot_reqs, ready)}
            rejected = self._engine.admit(
                kv, first_logits, self._engine.free_slots(), slot_reqs
            )
            rejected_ids = {id(sr) for sr in rejected}
            if len(slot_reqs) > len(rejected):
                self.stats.record_batch(len(slot_reqs) - len(rejected))
                # TTFT: the admitted requests' prefill is done and their
                # first tokens exist as of now.
                now = time.time()
                for sr in slot_reqs:
                    if id(sr) not in rejected_ids:
                        req = by_slotreq[id(sr)]
                        req.future.ttft_s = now - req.submit_ts
            return [by_slotreq[id(sr)] for sr in rejected] + overflow
        except Exception as exc:  # noqa: BLE001
            for req, *_ in ready:
                self.stats.bump("failures")
                _deliver(req.future, exc=exc)
        return overflow

    def _retire(self) -> int:
        from ..api import TranscriptionResult

        retired = 0
        for slot_req, toks in self._engine.retire():
            retired += 1
            future, lang, duration = slot_req.meta
            try:
                text, out_lang = self._model._finalize_output(toks, lang)
                _deliver(future, TranscriptionResult(text=text, language=out_lang,
                                                     duration=duration))
            except Exception as exc:  # noqa: BLE001
                self.stats.bump("failures")
                _deliver(future, exc=exc)
        return retired

    def _run(self) -> None:
        with torch.inference_mode():
            self._serve()

    def _serve(self) -> None:
        deferred: list[_Request] = []
        retry_deferred = True
        engine = self._engine
        while True:
            # Idle only when no slot holds a request: a request whose first
            # token was EOS is live and done, and is retired promptly.
            idle = engine.n_live() == 0 and not deferred
            reqs = self._drain_new(block=idle)
            if reqs is None:
                # Shutdown: finish in-flight work first.
                while engine.n_live() > 0 or deferred:
                    if deferred:
                        deferred = self._admit(deferred)
                    engine.step()
                    if self._retire():
                        retry_deferred = True
                    if engine.n_active() == 0 and deferred:
                        self._fail_deferred(deferred)
                        deferred = []
                return
            todo = (deferred if retry_deferred else []) + (reqs or [])
            if todo:
                if retry_deferred:
                    deferred = []
                still = self._admit(todo)
                if still and engine.n_active() == 0:
                    # The engine is empty yet admission failed: the request
                    # can never fit this pool.
                    self._fail_deferred(still)
                    still = []
                deferred.extend(still)
                retry_deferred = not deferred
                # Requests finished at admission (first token EOS, budget
                # <= 1) never enter a chunk: harvest now.
                if self._retire():
                    retry_deferred = True
            if engine.n_active() > 0:
                engine.step()
                if self._retire():
                    retry_deferred = True
            elif engine.n_live() > 0:
                if self._retire():
                    retry_deferred = True

    def _fail_deferred(self, reqs: list[_Request]) -> None:
        for req in reqs:
            self.stats.bump("failures")
            _deliver(req.future, exc=RuntimeError(
                "request cannot be admitted: its prompt alone exceeds the "
                "engine's KV page pool; raise kv_pool_gb"
            ))


class ReplicatedTranscriptionServer:
    """dp scale-out serving: one whole model replica per device, in one
    process (JAX ``serving/server.py:625-740``).

    At 1.7B the whole parameter set fits one card, so throughput scales
    without collectives: ``model_factory`` is called once per device, under
    ``torch.cuda.device(d)`` for a CUDA device (the counterpart of
    ``jax.default_device``), and its replica is served by a worker thread of
    its own, which sets its current CUDA device to ``d`` first (the current
    device is per thread, and the kernels launch on the current stream of
    their tensors' device).  The workers drain ONE shared queue, each
    batching as :class:`TranscriptionServer` does; a replica busy with a
    long batch simply does not poll while its siblings drain.  A failed
    batch is retried request by request on the same replica, as in the JAX
    package.

    ``devices`` defaults to every visible CUDA device; with none and no
    ``devices`` given, ``ValueError`` (never CPU replicas unasked).  Any
    device list is taken, two replicas on one card included: each replica
    has its own decode graphs, captured on a side stream of its own, one
    capture a card at a time (``runtime/graphs.py``), and the kernels'
    scratch buffers are kept per thread, so one replica's capture and
    another's kernels can overlap.
    """

    def __init__(
        self,
        model_factory,
        devices=None,
        max_batch_size: int = 8,
        batch_window_ms: float = 15.0,
    ) -> None:
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self._devices = [torch.device(d) for d in devices]
        if not self._devices:
            raise ValueError("no devices for replicas")
        self._max_batch = max_batch_size
        self._window_s = batch_window_ms / 1000.0
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self.stats = ServerStats()
        #: Batches each replica has served, by replica index.
        self.replica_batches = [0] * len(self._devices)
        self._closed = False
        self._models = []
        for d in self._devices:
            with _on_device(d):
                self._models.append(model_factory())
        self._workers = [
            threading.Thread(target=self._run_replica, args=(i, m, d), daemon=True)
            for i, (m, d) in enumerate(zip(self._models, self._devices))
        ]
        for w in self._workers:
            w.start()

    @property
    def n_replicas(self) -> int:
        return len(self._models)

    @property
    def models(self) -> list:
        """The replicas, in device order."""
        return list(self._models)

    # -- client API --------------------------------------------------------

    def submit(self, audio, **options) -> Future:
        if self._closed:
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._queue.put(_Request(audio, options, fut, time.time()))
        self.stats.bump("requests")
        return fut

    def transcribe(self, audio, **options):
        return self.submit(audio, **options).result()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            self._queue.put(None)
        for w in self._workers:
            w.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- workers -----------------------------------------------------------

    def _run_replica(self, index: int, model, device: torch.device) -> None:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.inference_mode():
            while True:
                batch = _collect_batch(
                    self._queue, self._max_batch, self._window_s,
                    model._runtime.frame_buckets,
                )
                if batch is None:
                    return
                self.stats.record_batch(len(batch))
                self.replica_batches[index] += 1
                try:
                    results = model.transcribe_batch(
                        [r.audio for r in batch], **batch[0].options
                    )
                    for req, res in zip(batch, results):
                        _deliver(req.future, res)
                except Exception:
                    for req in batch:
                        try:
                            _deliver(req.future, model.transcribe(req.audio, **req.options))
                        except Exception as exc:  # noqa: BLE001
                            self.stats.bump("failures")
                            _deliver(req.future, exc=exc)


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
