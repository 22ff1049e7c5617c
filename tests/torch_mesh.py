"""Runs the port on a (dp, tp) mesh of CPU processes, for the port's tests
(``tests/test_torch_parallel.py``).

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
column -> row pair of linears) and ``refusals`` (what a tp group refuses:
the engine, the servers).

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
    for case in payload["cases"]:
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
        from qwen3_asr_tpu_torch.parallel import TP, make_mesh

        mesh = make_mesh(dp, tp)
        out["grads"] = _grads(payload["grads"], TP(tp, mesh.coordinate["tp"], mesh.group("tp")))
    if payload.get("refusals") and tp > 1:
        out["refusals"] = _refusals(payload)
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


def _refusals(payload: dict) -> dict:
    """The message of each call a tp group refuses (None if it did not)."""
    from qwen3_asr_tpu_torch.serving.server import (
        ContinuousTranscriptionServer,
        TranscriptionServer,
    )

    model = _model(payload, {"dp": 1, "tp": 2})
    out = {}
    for name, call in (("make_engine", lambda: model.make_engine()),
                       ("ContinuousTranscriptionServer",
                        lambda: ContinuousTranscriptionServer(model)),
                       ("TranscriptionServer", lambda: TranscriptionServer(model)),
                       ("incremental_session", lambda: model.incremental_session())):
        try:
            call()
            out[name] = None
        except (NotImplementedError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def main(argv: list[str]) -> int:
    rank, dp, tp, workdir = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from qwen3_asr_tpu_torch import parallel

    parallel.initialize(num_processes=dp * tp, process_id=rank, backend="gloo",
                        init_method=f"file://{workdir / 'init'}")
    payload = torch.load(workdir / "payload.pt", weights_only=False)
    out = _transcribe(payload, dp, tp)
    out["topology"] = parallel.topology()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "orbax", "qwen3_asr_tpu")]
    if bad:
        raise AssertionError(f"a rank imported {bad[:5]}")
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
