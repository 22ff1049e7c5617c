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
grad mode is per thread) and the model's CUDA device (the current device is
per thread too).

On a mesh (``RuntimeConfig(dp, tp)``, one process per rank) the servers
run SPMD (``parallel/lockstep.py``): every rank constructs the server with
the same arguments; the driving rank owns the queue, the clock, batching
and futures, and broadcasts each operation to its followers, which apply
it to their own shards in the same order.  ``submit`` on a follower raises
``RuntimeError`` naming the driving rank; results are delivered on the
driving rank only, and a follower's ``close()`` returns once the driving
rank has closed the server.

* :class:`ContinuousTranscriptionServer` on a tp group: the group's first
  rank drives; each ``prefill_group`` + ``admit``, ``step`` and ``retire``
  (warm-up's too) runs on every rank of the group, and ends in a status
  exchange.  If any rank raises inside one, the server stops on every rank
  and every pending future gets the error.  On dp > 1 each tp group runs
  an engine of its own, driven by its own first rank.
* :class:`TranscriptionServer` on any (dp, tp) mesh: global rank 0 drives;
  each batch, and each one-by-one retry after a failed batch, runs as
  ``transcribe_batch`` or ``transcribe`` on every rank (collectives over
  the mesh).

The driving rank reads and validates each clip (``load_audio``, shape,
empty, ``max_duration``) before it broadcasts anything, so a bad clip fails
its own future and costs no operation.  While a server drives a mesh
model, the model's entry points refuse calls from other threads
(``Qwen3ASR._check_caller``): their collectives would interleave with the
server's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from pathlib import Path

import torch

from ..parallel.lockstep import STOP, RankFault


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


def _samples(audio):
    """A request's clip as samples: a file path read, an array checked
    (1-D float32 or int16 PCM)."""
    from ..api import _validate_samples
    from ..audio.io import load_audio

    if isinstance(audio, (str, Path)) or hasattr(audio, "__fspath__"):
        return load_audio(audio)
    return _validate_samples(audio)


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


def engine_op(model, engine, op: str, args: dict):
    """One continuous-engine operation on this rank, as a lockstep channel
    carries it: ``admit`` (``prefill_group`` of ``args["reqs"]``' samples in
    ``args["langs"]``, each request's prompt set, then ``engine.admit`` into
    ``args["slots"]``; the requests not admitted), ``step`` (one chunk) or
    ``retire`` (the finished requests and their tokens)."""
    if op == "admit":
        reqs = args["reqs"]
        kv, first_logits, prompts = model.prefill_group([r.samples for r in reqs], args["langs"])
        for r, prompt in zip(reqs, prompts):
            r.prompt = prompt
        return engine.admit(kv, first_logits, args["slots"], reqs)
    if op == "step":
        return engine.step()
    if op == "retire":
        return engine.retire()
    raise ValueError(f"unknown engine operation {op!r}")


class _Served:
    """What the two servers share: the queue, the futures still pending,
    the control channel and the worker (the driving rank's server loop, or
    a follower's loop over the posted operations).  Off a mesh the channel
    is None and every operation runs here alone."""

    _name = "server"
    #: Seconds the driving rank's ``close()`` waits for the worker.
    _join_s = 60

    def _setup(self, model, channel) -> None:
        self._model = model
        self._channel = channel
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self.stats = ServerStats()
        self._closed = False
        self._fault: BaseException | None = None
        self._close_requested = False
        self._pending: set[Future] = set()
        self._pending_lock = threading.Lock()
        target = self._run if self.driving else self._follow
        self._worker = threading.Thread(target=self._in_worker, args=(target,), daemon=True)

    @property
    def driving(self) -> bool:
        """Whether this rank takes requests: always off a mesh."""
        return self._channel is None or self._channel.driving

    def _start(self) -> None:
        if self._channel is not None:
            self._model._served_by = self._worker
        self._worker.start()

    def _in_worker(self, target) -> None:
        try:
            with torch.inference_mode(), _on_device(self._model._device):
                target()
        finally:
            if self._channel is not None and self._model._served_by is self._worker:
                self._model._served_by = None

    def _op(self, op: str, args: dict, wire: dict | None = None):
        """Run ``op`` on every rank of the channel (here alone off a mesh);
        the result of this rank's :meth:`_apply`."""
        if self._channel is None:
            return self._apply(op, args)
        return self._channel.lead(op, self._apply, args, wire)

    def _follow(self) -> None:
        try:
            self._channel.follow(self._apply)
        except Exception as exc:  # noqa: BLE001 -- RankFault, or a broken channel
            self._fault = exc
        self._closed = True

    def _post_stop(self) -> None:
        if self._channel is not None:
            try:
                self._channel.post(STOP)
            except Exception:  # noqa: BLE001 -- the group is gone already
                pass

    # -- client API ----------------------------------------------------------

    def submit(self, audio, **options) -> Future:
        """Enqueue one clip; returns a Future[TranscriptionResult]."""
        if not self.driving:
            raise RuntimeError(
                f"{self._name}.submit on rank {torch.distributed.get_rank()}, a follower: "
                f"requests go to the driving rank, global rank {self._channel.driving_rank}")
        with self._pending_lock:
            if self._closed:
                raise RuntimeError(f"{self._name} is closed") from self._fault
            fut: Future = Future()
            self._pending.add(fut)
        fut.add_done_callback(self._resolved)
        self._queue.put(_Request(audio, options, fut, time.time()))
        self.stats.bump("requests")
        return fut

    def _resolved(self, fut: Future) -> None:
        with self._pending_lock:
            self._pending.discard(fut)

    def transcribe(self, audio, **options):
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(audio, **options).result()

    def _stop(self, exc: BaseException) -> None:
        """A fault: the server takes no more requests, and every pending
        future gets ``exc``."""
        with self._pending_lock:
            self._closed = True
            self._fault = exc
            pending = list(self._pending)
        for fut in pending:
            self.stats.bump("failures")
            _deliver(fut, exc=exc)

    def close(self) -> None:
        """Driving rank: finish the work in flight and stop the worker (and
        the followers), waiting at most ``_join_s``.  Follower: wait until
        the driving rank has."""
        if self.driving and not self._close_requested:
            self._close_requested = True
            with self._pending_lock:
                self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=self._join_s if self.driving else None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TranscriptionServer(_Served):
    """Batch-at-admission serving around a :class:`Qwen3ASR` model; on a
    (dp, tp) mesh driven by global rank 0 (module docstring)."""

    _name = "TranscriptionServer"
    _join_s = 30

    def __init__(self, model, max_batch_size: int = 8, batch_window_ms: float = 15.0) -> None:
        rt = model._runtime
        self._setup(model, model._mesh.channel("world") if rt.dp * rt.tp > 1 else None)
        self._max_batch = max_batch_size
        self._window_s = batch_window_ms / 1000.0
        self._start()

    def _apply(self, op: str, args: dict):
        if op == "batch":
            return self._model.transcribe_batch(args["clips"], **args["options"])
        if op == "one":
            return self._model.transcribe(args["clip"], **args["options"])
        raise ValueError(f"unknown operation {op!r}")

    def _follow(self) -> None:
        # A failed batch is retried clip by clip: a fault ends no follower.
        while True:
            try:
                self._channel.follow(self._apply)
                return
            except RankFault:
                continue
            except Exception as exc:  # noqa: BLE001 -- a broken channel
                self._fault = exc
                return

    def _run(self) -> None:
        try:
            self._serve()
        except Exception as exc:  # noqa: BLE001 -- a broken channel
            self._stop(exc)
        finally:
            self._post_stop()

    def _serve(self) -> None:
        while True:
            batch = _collect_batch(
                self._queue, self._max_batch, self._window_s,
                self._model._runtime.frame_buckets,
            )
            if batch is None:
                return
            self.stats.record_batch(len(batch))
            ready = []
            for req in batch:
                try:
                    # Checked here, before any rank runs the batch: a dp
                    # slice that raised alone would leave the others in a
                    # collective.
                    self._model._resolve_language(req.options.get("language"))
                    ready.append((req, _samples(req.audio)))
                except Exception as exc:  # noqa: BLE001
                    self.stats.bump("failures")
                    _deliver(req.future, exc=exc)
            if not ready:
                continue
            try:
                results = self._op("batch", {"clips": [s for _, s in ready],
                                             "options": ready[0][0].options})
                for (req, _), res in zip(ready, results):
                    _deliver(req.future, res)
            except Exception:  # noqa: BLE001
                # Isolate: retry each clip alone; per-request errors.
                for req, samples in ready:
                    try:
                        _deliver(req.future, self._op("one", {"clip": samples,
                                                              "options": req.options}))
                    except Exception as exc:  # noqa: BLE001
                        self.stats.bump("failures")
                        _deliver(req.future, exc=exc)


class ContinuousTranscriptionServer(_Served):
    """In-flight continuous batching: requests join a running decode.

    Builds ``model.make_engine(...)`` (paged by default) and serves it from
    one worker thread.  Clips longer than ``max_duration`` are rejected on
    their future (``model.transcribe`` takes long-form audio).  At most
    ``admit_batch`` (default ``n_slots``) requests are prefilled per
    admission.  ``warm=True`` (or a tuple of durations) runs one prefill,
    admit, chunk and retire cycle per admission-group size before serving.
    On a tp group the group's first rank drives (module docstring).
    """

    _name = "ContinuousTranscriptionServer"

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
        self._setup(model, model._mesh.channel("tp") if model._runtime.tp > 1 else None)
        self._engine = model.make_engine(
            n_slots=n_slots, max_duration=max_duration, max_new_tokens=max_new_tokens,
            chunk_steps=chunk_steps, paged=paged, page_size=page_size,
            kv_pool_gb=kv_pool_gb,
        )
        self._max_duration = max_duration
        self._admit_batch = admit_batch or n_slots
        if warm and self.driving:
            # The followers' workers, started in their constructors, apply
            # the warm-up's operations.
            if self._channel is not None:
                model._served_by = threading.current_thread()
            try:
                self._warm_up(warm if isinstance(warm, (tuple, list)) else (max_duration,))
            except BaseException as exc:
                if self._channel is not None:
                    model._served_by = None
                if not isinstance(exc, RankFault) and not isinstance(exc.__cause__, RankFault):
                    self._post_stop()   # a RankFault stopped the followers already
                raise
        self._start()

    def _apply(self, op: str, args: dict):
        return engine_op(self._model, self._engine, op, args)

    def _engine_admit(self, reqs, langs: list) -> list:
        """``prefill_group`` + ``admit`` of ``reqs`` (SlotRequests without
        prompts) into the free slots, on every rank; the requests that
        were not admitted."""
        args = {"reqs": reqs, "langs": langs, "slots": self._engine.free_slots()}
        wire = dict(args, reqs=[dataclasses.replace(r, meta=None) for r in reqs])
        return self._op("admit", args, wire)

    def _warm_requests(self, clip, n: int):
        from ..runtime.engine import SlotRequest

        return [
            SlotRequest(samples=clip, prompt=[], max_new=2, temperature=0.0, top_k=0,
                        top_p=1.0, repetition_penalty=1.2, repetition_context_size=100,
                        seed=0, meta=None)
            for _ in range(n)
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
                self._engine_admit(self._warm_requests(clip, bg), ["English"] * bg)
            except Exception as exc:
                if not _out_of_memory(exc):
                    raise
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
            self._op("step", {})
            self._op("retire", {})
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
                    if self._engine_admit(self._warm_requests(clip, bg), ["English"] * bg):
                        # The pool holds fewer slots at this length: warm
                        # the reachable width (nothing retires during the fill).
                        break
                self._op("step", {})
                while engine.n_live() > 0:
                    self._op("retire", {})
                    if engine.n_live() > 0:
                        self._op("step", {})
        logger.info("continuous-server warm_up done (%d cells)", len(cells))

    @property
    def engine_stats(self):
        return self._engine.stats

    def close(self) -> None:
        """As :meth:`_Served.close`, then free the engine's captured chunks
        and kernel scratch once the worker has stopped."""
        super().close()
        if not self._worker.is_alive():
            self._engine.close()

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
        from ..api import TranscriptionResult
        from ..audio.io import SAMPLE_RATE
        from ..runtime.engine import SlotRequest

        # Never prefill more than the free slots or the admission cap (the
        # deferred retry concatenates deferred and fresh requests).
        cap = min(len(self._engine.free_slots()), self._admit_batch)
        reqs, overflow = reqs[:cap], reqs[cap:]
        ready = []
        for req in reqs:
            try:
                samples = _samples(req.audio)
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
            slot_reqs = []
            for req, samples, lang, duration in ready:
                opts = req.options
                slot_reqs.append(SlotRequest(
                    samples=samples,
                    prompt=[],
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
            rejected = self._engine_admit(slot_reqs, [r[2] for r in ready])
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
        except RankFault:
            raise
        except Exception as exc:  # noqa: BLE001
            for req, *_ in ready:
                self.stats.bump("failures")
                _deliver(req.future, exc=exc)
        return overflow

    def _retire(self) -> int:
        from ..api import TranscriptionResult

        retired = 0
        for slot_req, toks in self._op("retire", {}):
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
        try:
            self._serve()
        except RankFault as exc:
            self._stop(exc)         # every follower stopped at the same exchange
            return
        except Exception as exc:  # noqa: BLE001 -- fail the futures, not silently
            self._stop(exc)
        self._post_stop()

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
                    self._op("step", {})
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
                self._op("step", {})
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


def _out_of_memory(exc: BaseException) -> bool:
    """Whether ``exc`` is the device running out of memory: here, or on any
    rank of a lockstep operation."""
    if isinstance(exc, RankFault):
        return any(m.startswith("OutOfMemoryError") for m in exc.errors.values())
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
