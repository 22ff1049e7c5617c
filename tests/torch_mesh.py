"""Runs the port on a (dp, tp) mesh of CPU processes, for the port's tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_train_mesh.py``).

:func:`run_mesh` starts ``dp * tp`` processes of this file, one per rank,
which join one gloo process group through ``init_method=file://`` in the
test's temporary directory (no TCP port, so parallel test workers never
collide), run the job below on the payload the test saved, and save each
rank's result there.  Every process has one intra-op thread and must end
within :data:`TIMEOUT` seconds; a rank that fails or outlives it fails the
test with its output.  A rank imports neither JAX nor the JAX package (it
checks, and fails otherwise): the test compares with them in its own
process.

The job (:func:`_transcribe`): for each case of the payload, the port's
``Qwen3ASR`` on the payload's tiny float32 weights under the case's
runtime (dp and tp set to the mesh), ``transcribe_batch`` or
``transcribe`` of the case's clips, the result ids, languages and each
decode call's first logits (the prefill's); on a tp group, when the
payload asks, ``grads`` (the tp collectives' forward and backward on a
column -> row pair of linears) and ``refusals`` (what a tp group still
refuses: the incremental session).  The serving job (:func:`_serving`,
payload key ``serving``): the servers on the mesh, every rank constructing
them and the driving rank submitting (``ContinuousTranscriptionServer`` on
a tp group, paged and flat, greedy and sampled, with a mid-decode
admission; ``TranscriptionServer`` on any mesh, its batch once failing on
every rank; a ``StreamingTranscriber`` through the tp server; an injected
fault), each rank's engine state after every operation, and the engine
driven by hand through the control channel on :func:`engine_schedule`.
The training job (:func:`_train`, payload key
``train``, ``tests/test_torch_train_mesh.py``): AdamW steps of the mesh
train step on the payload's batch, each step's loss and local parameters,
the first step's local gradients, a sharded snapshot (saved, resumed, or
restored from other meshes' snapshots) and the dp refusal.  The graphed tp
job (:func:`_tp_graphs`, payload key ``tp_graphs``,
``tests/test_torch_tp_graphs.py``, on the card): the decode loops graphed
and eager on an NCCL group (payload key ``backend``, gloo by default), one
card a rank.

Run by hand: ``python tests/torch_mesh.py RANK DP TP WORKDIR``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
#: Seconds each rank may take.
TIMEOUT = 120


def run_mesh(dp: int, tp: int, workdir: Path, payload: dict) -> list[dict]:
    """Run the job on ``payload`` in ``dp * tp`` ranks; each rank's result."""
    return wait_mesh(start_mesh(dp, tp, workdir, payload))


def start_mesh(dp: int, tp: int, workdir: Path, payload: dict) -> tuple:
    """Start the ``dp * tp`` ranks of the job on ``payload`` and return at
    once; :func:`wait_mesh` of the handle waits for their results."""
    import torch

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(payload, workdir / "payload.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]))
    procs, logs = [], []
    for rank in range(dp * tp):
        log = open(workdir / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(rank), str(dp), str(tp), str(workdir)],
            env=env, cwd=str(workdir), stdout=log, stderr=subprocess.STDOUT,
        ))
    return dp, tp, workdir, procs, logs


def wait_mesh(handle: tuple) -> list[dict]:
    """Each rank's result of a :func:`start_mesh` job; a rank that fails
    or outlives :data:`TIMEOUT` fails the test with its output."""
    import torch

    dp, tp, workdir, procs, logs = handle
    failed = []
    try:
        for rank, p in enumerate(procs):
            try:
                rc = p.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed:
        text = "\n".join(
            f"--- rank {r} ({rc}):\n{(workdir / f'rank{r}.log').read_text()[-4000:]}"
            for r, rc in failed)
        raise AssertionError(f"mesh job at (dp={dp}, tp={tp}) failed:\n{text}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(dp * tp)]


# -- in a rank ---------------------------------------------------------------------------


def _model(payload: dict, runtime: dict):
    from torch_parity import StubTokenizer, port_config

    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig

    enc, dec = payload["params"]
    return Qwen3ASR(port_config(), enc, dec, StubTokenizer(), RuntimeConfig(**runtime))


def _first_logits(model) -> list:
    """Wrap the model's decode so each call's first logits are kept."""
    seen = []
    real = model._generator.decode

    def decode(kv, first_logits, *args, **kwargs):
        seen.append(first_logits.float().cpu().clone())
        return real(kv, first_logits, *args, **kwargs)

    model._generator.decode = decode
    return seen


def _transcribe(payload: dict, dp: int, tp: int) -> dict:
    from torch_parity import ids_of

    out = {}
    for case in payload.get("cases", []):
        model = _model(payload, dict(case.get("runtime", {}), dp=dp, tp=tp))
        logits = _first_logits(model)
        if case.get("single"):
            results = [model.transcribe(case["clips"][0], **case.get("kwargs", {}))]
        else:
            results = model.transcribe_batch(case["clips"], **case.get("kwargs", {}))
        out[case["name"]] = {
            "ids": ids_of(results),
            "languages": [r.language for r in results],
            "durations": [r.duration for r in results],
            "logits": logits,
            "decoded": len(logits) > 0,
        }
        model.close()
    if payload.get("grads") and tp > 1:
        from qwen3_asr_tpu_torch.parallel import make_mesh

        out["grads"] = _grads(payload["grads"], make_mesh(dp, tp).tp_group())
    if payload.get("refusals") and tp > 1:
        out["refusals"] = _refusals(payload)
    return out


def _tp_graphs(job: dict, dp: int, tp: int) -> dict:
    """For each arm of ``job`` (name -> (runtime, ``transcribe_batch``
    keywords)), the tiny model in bf16 on this rank's card (random weights,
    seed 0; ``job["encoder"]``/``job["decoder"]`` override its widths)
    transcribes ``job["clips"]`` three times: graphed (the first call
    captures), graphed again, and eagerly (``decode(eager=True)``).
    Per run: the ids, the collectives counted from the decode call's start
    (``TRAFFIC``), its steps run and live steps; per arm the captures.  On
    one rank (dp = tp = 1) the generator gets a ``TP`` over the world group
    by hand (a mesh of one makes no group), so every collective is a real
    one-rank call."""
    import functools

    import torch
    import torch.distributed as dist
    from torch_parity import TINY_DECODER, TINY_ENCODER, StubTokenizer, ids_of

    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch import config as tc
    from qwen3_asr_tpu_torch.parallel import collectives

    cfg = tc.ModelConfig(
        audio_encoder=tc.AudioEncoderConfig(**dict(TINY_ENCODER, **job.get("encoder", {}))),
        text_decoder=tc.TextDecoderConfig(**dict(TINY_DECODER, **job.get("decoder", {}))),
    )

    def counted(real, eager, *args, **kwargs):
        collectives.TRAFFIC.clear()
        return real(*args, eager=eager, **kwargs)

    out = {}
    for name, (runtime, kwargs) in job["arms"].items():
        model = Qwen3ASR.from_random(
            cfg, tokenizer=StubTokenizer(),
            runtime=RuntimeConfig(**runtime, dp=dp, tp=tp), dtype=torch.bfloat16, seed=0,
            device=torch.device("cuda", torch.cuda.current_device()))
        gen = model._generator
        if dp * tp == 1:
            gen.tp = collectives.TP(1, 0, dist.group.WORLD)
        real, runs = gen.decode, []
        for eager in (False, False, True):
            gen.decode = functools.partial(counted, real, eager)
            ids = ids_of(model.transcribe_batch(job["clips"], **kwargs))
            runs.append(dict(ids=ids, traffic=dict(collectives.TRAFFIC),
                             replays=gen.last_replays, steps=gen.last_decode_steps))
        del gen.decode
        out[name] = dict(runs=runs, captures=gen.graphs.captures if gen.graphs else 0)
        model.close()
    return out


# -- serving on the mesh ------------------------------------------------------------------

#: The continuous server's size in the serving job (the JAX test's:
#: ``tests/test_parallel.py:162-193``).
SERVER = dict(n_slots=4, max_duration=8.0, max_new_tokens=128, chunk_steps=4)


def engine_state(engine) -> dict:
    """A copy of an engine's slot state: device tokens, counts, flags and
    current tokens, the host mirrors and (paged) the page accounting."""
    out = {name: getattr(engine, name).clone() for name in
           ("_tokens", "_counts_d", "_done_d", "_cur_d")}
    out.update({name: getattr(engine, name).copy() for name in
                ("_live", "_done", "_counts", "_prompt_len")})
    if engine.paged:
        out.update(table=engine._page_table.copy(), paused=engine._paused.copy(),
                   free=list(engine._free_pages))
    return out


def engine_schedule(engine, run, clips) -> None:
    """A fixed schedule of engine operations, ``run(op, args)`` each: two
    requests admitted, a chunk, a third admitted mid-decode (deferred while
    the pool cannot take its prompt), then chunks and retirements until the
    engine is empty."""
    from qwen3_asr_tpu_torch.runtime.engine import SlotRequest

    def admit(items):
        reqs = [SlotRequest(samples=c, prompt=[], max_new=m, meta=None) for c, m in items]
        rejected = run("admit", {"reqs": reqs, "langs": ["English"] * len(reqs),
                                 "slots": engine.free_slots()})
        return [item for item, r in zip(items, reqs) if any(r is x for x in rejected)]

    waiting = admit([(clips[0], 150), (clips[1], 40)])
    run("step", {})
    waiting += admit([(clips[2], 20)])
    for _ in range(200):
        if waiting and engine.free_slots():
            waiting = admit(waiting)
        if engine.n_live() == 0 and not waiting:
            return
        run("step", {})
        run("retire", {})
    raise AssertionError("the schedule did not drain the engine")


def _recording(states: list, retired: list):
    """A patch of ``serving.server.engine_op`` that keeps the engine state
    after every operation and each retirement's token lists."""
    from qwen3_asr_tpu_torch.serving import server

    real = server.engine_op

    def op(model, engine, name, args):
        result = real(model, engine, name, args)
        states.append((name, engine_state(engine)))
        if name == "retire":
            retired.append([toks for _, toks in result])
        return result

    return real, op


def _wait(cond, seconds: float = 60) -> None:
    import time

    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)


def _continuous(payload: dict, job: dict, dp: int, tp: int, runtime: dict, paged: bool,
                options: dict | None = None) -> dict:
    """The JAX test's three clips through a continuous server on the mesh,
    then a long request and a short one admitted while it decodes; on the
    driving rank the results' ids, a direct ``model.transcribe``'s refusal
    and the stats, on a follower ``submit``'s refusal."""
    import dataclasses

    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer
    from qwen3_asr_tpu_torch.serving import server as server_mod

    from torch_parity import ids_of

    model = _model(payload, dict(runtime, dp=dp, tp=tp))
    states, retired = [], []
    real, server_mod.engine_op = _recording(states, retired)
    out = {}
    try:
        srv = ContinuousTranscriptionServer(model, paged=paged, **SERVER)
        kw = dict(options or {}, max_tokens=5)
        if srv.driving:
            results = [f.result(timeout=60) for f in
                       [srv.submit(c, **kw) for c in job["clips"]]]
            long_f = srv.submit(job["long"], **dict(kw, max_tokens=40))
            _wait(lambda: srv.engine_stats.admitted >= len(job["clips"]) + 1)
            short_f = srv.submit(job["short"], **dict(kw, max_tokens=4))
            try:
                model.transcribe(job["short"], max_tokens=4)
                out["direct"] = None
            except RuntimeError as exc:
                out["direct"] = str(exc)
            results += [short_f.result(timeout=60), long_f.result(timeout=60)]
            out["ids"] = ids_of(results)
        else:
            try:
                srv.submit(job["short"])
                out["submit"] = None
            except RuntimeError as exc:
                out["submit"] = str(exc)
        srv.close()
        out["stats"] = dataclasses.asdict(srv.engine_stats)
        out["fault"] = repr(srv._fault)
    finally:
        server_mod.engine_op = real
    out.update(states=states, retired=retired)
    model.close()
    return out


def _schedule(payload: dict, job: dict, dp: int, tp: int) -> dict:
    """:func:`engine_schedule` on an oversubscribed paged engine, driven
    by hand through the tp group's control channel: the engine state after
    every operation, the retirements' tokens, the stats and the page
    count."""
    import dataclasses

    from qwen3_asr_tpu_torch.parallel.lockstep import STOP
    from qwen3_asr_tpu_torch.serving.server import engine_op

    model = _model(payload, dict(job["runtime"], dp=dp, tp=tp))
    engine = model.make_engine(paged=True, **job["engine"])
    channel = model._mesh.channel("tp")
    states, retired = [], []

    def apply(op, args):
        result = engine_op(model, engine, op, args)
        states.append((op, engine_state(engine)))
        if op == "retire":
            retired.append([toks for _, toks in result])
        return result

    if channel.driving:
        engine_schedule(engine, lambda op, args: channel.lead(op, apply, args), job["clips"])
        channel.post(STOP)
    else:
        channel.follow(apply)
    out = dict(states=states, retired=retired, stats=dataclasses.asdict(engine.stats),
               n_pages=engine.n_pages, pool=tuple(engine._keys.shape))
    model.close()
    return out


def _drain(payload: dict, job: dict, dp: int, tp: int) -> dict:
    """The drain server on the mesh, twice: the clips and a malformed one
    (refused on the driving rank), then the clips again with the first
    batch raising on every rank (each clip retried alone)."""
    from qwen3_asr_tpu_torch.serving import TranscriptionServer

    from torch_parity import ids_of

    model = _model(payload, dict(job["runtime"], dp=dp, tp=tp))
    out = {"ids": [], "errors": [], "batches": []}
    real = model._run_pipeline_batch
    for rnd in range(2):
        calls = []

        def once(*args, **kwargs):
            calls.append(1)
            if rnd == 1 and len(calls) == 1:
                raise RuntimeError("injected batch fault")
            return real(*args, **kwargs)

        model._run_pipeline_batch = once
        srv = TranscriptionServer(model, max_batch_size=4, batch_window_ms=500)
        if srv.driving:
            futs = [srv.submit(c, max_tokens=5) for c in job["clips"]]
            bad = srv.submit(job["clips"][0][None, :], max_tokens=5)
            out["ids"].append(ids_of([f.result(timeout=60) for f in futs]))
            out["errors"].append(type(bad.exception(timeout=60)).__name__)
        else:
            try:
                srv.submit(job["clips"][0])
            except RuntimeError as exc:
                out["submit"] = str(exc)
        srv.close()
        out["batches"].append(srv.stats.batches)
    model.close()
    return out


def _stream(payload: dict, job: dict, dp: int, tp: int) -> dict:
    """A ``StreamingTranscriber`` on the driving rank submitting its
    segments to the tp group's continuous server (``feed_nowait`` in
    pieces, ``flush_nowait``): each segment's span and ids."""
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer
    from qwen3_asr_tpu_torch.streaming import StreamingTranscriber

    from torch_parity import ids_of

    model = _model(payload, dict(job["runtime"], dp=dp, tp=tp))
    srv = ContinuousTranscriptionServer(model, **SERVER)
    out = {}
    if srv.driving:
        stream = StreamingTranscriber(model, segment_duration=1.0, search_duration=0.25,
                                      server=srv, max_tokens=5)
        audio, futs = job["stream"], []
        for lo in range(0, len(audio), 4000):
            futs += stream.feed_nowait(audio[lo:lo + 4000])
        futs += stream.flush_nowait()
        segs = [f.result(timeout=60) for f in futs]
        out["segments"] = [(s.start, s.end) for s in segs]
        out["ids"] = ids_of(segs)
    srv.close()
    model.close()
    return out


def _fault(payload: dict, job: dict, dp: int, tp: int) -> dict:
    """A continuous server whose follower raises once inside an admission
    (``engine.admit``, after the prefill's collectives): what each rank saw.
    Then a warmed server whose follower runs out of device memory in
    warm-up's first admission: the driving rank's constructor error."""
    import time

    import torch

    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    model = _model(payload, dict(job["runtime"], dp=dp, tp=tp))
    srv = ContinuousTranscriptionServer(model, **SERVER)
    if not srv.driving:
        real, calls = srv._engine.admit, []

        def admit(*args, **kwargs):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected fault")
            return real(*args, **kwargs)

        srv._engine.admit = admit
    out = {}
    t0 = time.monotonic()
    if srv.driving:
        first = srv.submit(job["long"], max_tokens=40)
        _wait(lambda: srv.engine_stats.admitted >= 1)
        second = srv.submit(job["short"], max_tokens=4)
        out["errors"] = [repr(f.exception(timeout=60)) for f in (first, second)]
        try:
            srv.submit(job["short"])
            out["after"] = None
        except RuntimeError as exc:
            out["after"] = str(exc)
    srv.close()
    out.update(seconds=time.monotonic() - t0, fault=repr(srv._fault),
               alive=srv._worker.is_alive())
    if not srv.driving:
        make = model.make_engine

        def make_engine(**kwargs):
            engine = make(**kwargs)

            def admit(*args, **kw):
                raise torch.cuda.OutOfMemoryError("injected: out of device memory")

            engine.admit = admit
            return engine

        model.make_engine = make_engine
    try:
        warmed = ContinuousTranscriptionServer(model, warm=True, **SERVER)
        out["oom"] = None
        warmed.close()
        out["oom_fault"] = repr(warmed._fault)
    except RuntimeError as exc:
        out["oom"] = str(exc)
    model.close()
    return out


def _serving(payload: dict, dp: int, tp: int) -> dict:
    job = payload["serving"]
    out = {}
    for name in job["runs"]:
        if name == "continuous":
            for label, (runtime, paged) in job["continuous"].items():
                out[label] = _continuous(payload, job, dp, tp, dict(job["runtime"], **runtime),
                                         paged)
        elif name == "sampled":
            out["sampled"] = [_continuous(payload, job, dp, tp, job["runtime"], True,
                                          job["sampling"]) for _ in range(2)]
        else:
            out[name] = {"schedule": _schedule, "drain": _drain, "stream": _stream,
                         "fault": _fault}[name](payload, job, dp, tp)
    return out


def _grads(g: dict, tp) -> dict:
    """The collectives on a column -> row pair: y = reduce(tanh(copy(x) @ W1)
    @ W2) plus a term through the gather of the column output; x and this
    rank's W1 columns and W2 rows get gradients."""
    import torch

    from qwen3_asr_tpu_torch.parallel import copy_to_tp, gather_from_tp, reduce_from_tp

    x = g["x"].clone().requires_grad_(True)
    w1 = g["w1"].chunk(tp.size, dim=1)[tp.rank].clone().requires_grad_(True)
    w2 = g["w2"].chunk(tp.size, dim=0)[tp.rank].clone().requires_grad_(True)
    h = torch.tanh(copy_to_tp(x, tp) @ w1)
    y = reduce_from_tp(h @ w2, tp)
    z = gather_from_tp(h, tp, dim=-1)
    loss = (y * g["cy"]).sum() + (z * g["cz"]).sum()
    loss.backward()
    return {"y": y.detach(), "z": z.detach(), "loss": loss.detach(), "x": x.grad,
            "w1": w1.grad, "w2": w2.grad}


def local_state(state) -> dict:
    """Copies of a TrainState's local leaves and optimizer state by name."""
    from qwen3_asr_tpu_torch.training.train import named_params

    named = named_params(state.encoder, state.decoder)
    opt = state.optimizer.state_dict()["state"]
    return {"params": {n: t.detach().clone() for n, t in named},
            "moments": {n: {k: v.clone() for k, v in opt[i].items()}
                        for i, (n, _) in enumerate(named) if i in opt},
            "step": state.step}


def _train(job: dict, dp: int, tp: int) -> dict:
    """The mesh train step on ``job``'s batch: ``job["steps"]`` AdamW(1e-4)
    steps from ``job["params"]`` (whole float32 trees; tp rank 1 shifts its
    gradient of the replicated ``encoder.conv1_b`` by 1e-6), each step's loss
    and local parameters, the first step's local gradients (dp-summed);
    with ``job["save"]``, a snapshot of step 1 there, restored into a fresh
    state and resumed to the last step (bit-equal to the uninterrupted
    run?); each snapshot of ``job["restore"]`` restored into a fresh state;
    whether the step was graphed and its counters; ``job["odd_batch"]``'s
    dp refusal."""
    import copy
    import dataclasses
    import functools

    import torch

    from qwen3_asr_tpu_torch.parallel import make_mesh
    from qwen3_asr_tpu_torch.training import checkpoint as ckpt
    from qwen3_asr_tpu_torch.training.dryrun import tiny_config
    from qwen3_asr_tpu_torch.training.train import (
        Batch,
        init_train_state,
        make_train_step,
        named_params,
        shard_batch,
    )

    mesh = make_mesh(dp, tp)
    cfg = tiny_config()
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)

    def fresh():
        state = init_train_state(cfg, adamw, *copy.deepcopy(job["params"]), mesh)
        if mesh.coordinate["tp"] == 1:
            # A replicated leaf's gradient rounded apart on one rank, as a
            # kernel that adds with atomics may round it on the card.
            state.encoder["conv1_b"].register_hook(lambda g: g + 1e-6)
        return state

    step, batch = make_train_step(cfg), Batch(**job["batch"])
    out = {"losses": [], "params": [], "coordinate": dict(mesh.coordinate)}
    state, saved = fresh(), None
    for k in range(job["steps"]):
        state, loss = step(state, batch)
        out["losses"].append(loss.item())
        out["params"].append({n: t.detach().clone()
                              for n, t in named_params(state.encoder, state.decoder)})
        if k == 0:
            out["grads"] = {n: t.grad.clone() for n, t in named_params(state.encoder,
                                                                         state.decoder)}
            if job.get("save"):
                ckpt.save_train_state(job["save"], state)
                saved = out["saved"] = local_state(state)
    if saved is not None:
        run = ckpt.restore_train_state(job["save"], fresh())
        restored = local_state(run)
        losses = []
        for _ in range(job["steps"] - 1):
            run, loss = step(run, batch)
            losses.append(loss.item())
        final, resumed = local_state(state), local_state(run)
        out["resume"] = dict(
            restored_step=restored["step"],
            restored_equal=_same(restored, saved),
            losses=losses,
            equal=_same(resumed, final) and resumed["step"] == final["step"],
        )
    out["restored"] = {path: local_state(ckpt.restore_train_state(path, fresh()))
                       for path in job.get("restore", [])}
    out["step"] = dict(graphed=step.graphed(state), **dataclasses.asdict(step.stats))
    try:
        shard_batch(Batch(**job["odd_batch"]), mesh)
        out["odd"] = None
    except ValueError as exc:
        out["odd"] = str(exc)
    return out


def _same(a: dict, b: dict) -> bool:
    """Bit-equal local leaves and optimizer state."""
    import torch

    return (a["params"].keys() == b["params"].keys()
            and all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
            and a["moments"].keys() == b["moments"].keys()
            and all(torch.equal(a["moments"][n][k], b["moments"][n][k])
                    for n in a["moments"] for k in a["moments"][n]))


def _refusals(payload: dict) -> dict:
    """The message of each call a tp group refuses (None if it did not):
    ``make_engine`` runs there (then its pool's shape), the incremental
    session does not."""
    model = _model(payload, {"dp": 1, "tp": 2})
    out = {}
    for name, call in (("make_engine", lambda: model.make_engine(paged=True)._keys.shape),
                       ("incremental_session", lambda: model.incremental_session())):
        try:
            out[name] = None
            out[f"{name} result"] = call()
        except (NotImplementedError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def main(argv: list[str]) -> int:
    rank, dp, tp, workdir = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from qwen3_asr_tpu_torch import parallel

    payload = torch.load(workdir / "payload.pt", weights_only=False)
    parallel.initialize(num_processes=dp * tp, process_id=rank,
                        backend=payload.get("backend", "gloo"),
                        init_method=f"file://{workdir / 'init'}")
    out = _transcribe(payload, dp, tp)
    if payload.get("tp_graphs"):
        out["tp_graphs"] = _tp_graphs(payload["tp_graphs"], dp, tp)
    if payload.get("serving"):
        out["serving"] = _serving(payload, dp, tp)
    if payload.get("train"):
        out["train"] = _train(payload["train"], dp, tp)
    out["topology"] = parallel.topology()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "orbax", "qwen3_asr_tpu")]
    if bad:
        raise AssertionError(f"a rank imported {bad[:5]}")
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
