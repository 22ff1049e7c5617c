"""The port's train step on (dp, tp) meshes of CPU processes against the JAX
package's jitted train step on JAX meshes of the same shapes, and its
sharded train-state checkpoints.

Model: the multichip dry run's tiny float32 config
(``qwen3_asr_tpu_torch/training/dryrun.py``, ``__graft_entry__.py:147-167``)
with ``torch_parity.numpy_params``' weights; AdamW(1e-4), optax's default
decay 1e-4 on both sides.  Batch: B = 4 seeded clips whose label masks
hold 39, 20, 0 and 0 positions, so the dp = 2 meshes' second slice holds
no label: the loss is the masked mean over the whole batch, not a mean of
the slices' means.  The port's meshes run in processes of their own
(``tests/torch_mesh.py``'s ``_train``: gloo, one spawn per mesh shape for
all of its cases); JAX runs in this process on the virtual CPU devices of
``tests/conftest.py``, ``jax.jit(make_train_step(cfg, optax.adamw(1e-4)))``
with the parameters placed by ``qwen3_asr_tpu.parallel.sharding`` and the
batch on ``P("dp")``, compiled once per mesh while the ranks run.

Tolerances: each step's loss 1e-5 relative; each rank's first-step
gradient shard within ``1e-4 * max|g_leaf| + 1e-7`` of JAX's
``value_and_grad`` of ``asr_loss``, sliced by the port's placements;
parameters after each of three steps within 1e-6 absolute wherever JAX's
gradient at every step so far exceeds 1e-5 x the largest |g| of any leaf
(elsewhere Adam's early steps move a parameter by about lr x sign(g), and
the sign of a gradient at rounding level is noise, as for the encoder's
key biases, whose exact gradient is 0: there within 2 x lr per step).
Across ranks
replicated leaves, and a sharded leaf's copies on one tp coordinate, are
bit-identical, also where tp rank 1 rounds a replicated leaf's gradient
apart (the step takes the tp group's first rank's).  Checkpoints: a (2, 2) snapshot restores onto (2, 2), (1,
2), (2, 1) and one device bit for bit, resumes bit for bit, and a
one-device snapshot restores onto (1, 2).
"""

from __future__ import annotations

import copy
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.training import checkpoint as ckpt
from qwen3_asr_tpu_torch.training.dryrun import (
    TINY_DECODER,
    TINY_ENCODER,
    dryrun_multichip,
    tiny_config,
)
from qwen3_asr_tpu_torch.training.train import (
    Batch,
    init_train_state,
    make_train_step,
    named_params,
    tp_dims,
)

from torch_mesh import local_state, start_mesh, wait_mesh
from torch_parity import numpy_params

MESHES = [(2, 2), (1, 2), (2, 1)]
DP2 = [(2, 2), (2, 1)]
LR = 1e-4
STEPS = 3
B, FRAMES, P = 4, 800, 144
#: Each clip's valid frames, audio tokens and labelled positions.
VALID, N_AUDIO, LABELS = (800, 700, 800, 800), (104, 91, 104, 104), (39, 20, 0, 0)


def _batch_np(batch: int = B) -> dict:
    rng = np.random.default_rng(3)
    mel = (rng.standard_normal((batch, 128, FRAMES)) * 0.1).astype(np.float32)
    mask = np.zeros((batch, P), bool)
    for b in range(batch):
        mel[b, :, VALID[b % B]:] = 0.0
        lo = 9 + N_AUDIO[b % B]
        mask[b, lo : lo + LABELS[b % B]] = True
    return dict(mel=mel, n_valid_frames=np.asarray(VALID * 2, np.int32)[:batch],
                input_ids=rng.integers(0, 512, (batch, P)).astype(np.int32),
                n_audio=np.asarray(N_AUDIO * 2, np.int32)[:batch],
                labels=rng.integers(0, 512, (batch, P)).astype(np.int32), label_mask=mask)


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


ADAMW = functools.partial(torch.optim.AdamW, lr=LR, weight_decay=1e-4)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, numpy encoder, numpy decoder, port (encoder, decoder))."""
    from qwen3_asr_tpu import config as jc

    jcfg = jc.ModelConfig(audio_encoder=jc.AudioEncoderConfig(**TINY_ENCODER),
                          text_decoder=jc.TextDecoderConfig(**TINY_DECODER))
    enc, dec = numpy_params(jcfg, seed=0)
    return jcfg, enc, dec, params_from_jax(enc, dec)


def _one_device(port, mesh=None):
    return init_train_state(tiny_config(), ADAMW, *copy.deepcopy(port), mesh)


def _jax_runs(jcfg, enc, dec, batch) -> dict:
    """Per mesh shape: the jitted JAX step's losses and parameters (port
    layout, by name) after each step, and its gradient (JAX
    ``value_and_grad`` of ``asr_loss`` on the same state) before each.
    Every mesh's functions compile in threads, at once."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from qwen3_asr_tpu.parallel.mesh import make_mesh
    from qwen3_asr_tpu.parallel.sharding import (
        decoder_param_sharding,
        encoder_param_sharding,
        shard_params,
    )
    from qwen3_asr_tpu.training import train as jtrain

    tx = optax.adamw(LR)

    def loss_fn(params, b):
        return jtrain.asr_loss(*params, jcfg, b)

    def placed(shape):
        mesh = make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
        e = shard_params(jax.tree_util.tree_map(jnp.asarray, enc),
                         encoder_param_sharding(enc, mesh))
        d = shard_params(jax.tree_util.tree_map(jnp.asarray, dec),
                         decoder_param_sharding(dec, mesh))
        state = jtrain.init_train_state(jcfg, tx, e, d)
        # One sharding per leaf, kept over the steps, so each function
        # compiles once (the step's outputs come back in other layouts).
        rep = NamedSharding(mesh, PS())
        shardings = jax.tree_util.tree_map(
            lambda x: x.sharding if isinstance(x.sharding, NamedSharding) else rep, state)
        state = jax.device_put(state, shardings)
        on_dp = NamedSharding(mesh, PS("dp"))
        b = jtrain.Batch(**{k: jax.device_put(v, on_dp) for k, v in batch.items()})
        return state, shardings, b

    def compiled(shape):
        state, shardings, b = placed(shape)
        step = jax.jit(jtrain.make_train_step(jcfg, tx)).lower(state, b).compile()
        grads = jax.jit(jax.value_and_grad(loss_fn)).lower((state.encoder, state.decoder),
                                                           b).compile()
        return state, shardings, b, step, grads

    def named(tree) -> dict:
        host = jax.tree_util.tree_map(np.asarray, tree)
        return {n: t for n, t in named_params(*params_from_jax(*host))}

    with ThreadPoolExecutor(len(MESHES)) as pool:
        built = dict(zip(MESHES, pool.map(compiled, MESHES)))
    out = {}
    for shape, (state, shardings, b, step, grads) in built.items():
        run = {"losses": [], "params": [], "grads": []}
        for _ in range(STEPS):
            run["grads"].append(named(grads((state.encoder, state.decoder), b)[1]))
            state, loss = step(state, b)
            state = jax.device_put(state, shardings)
            run["losses"].append(float(loss))
            run["params"].append(named((state.encoder, state.decoder)))
        out[shape] = run
    return out


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The port's ranks per mesh shape and the JAX runs.  (2, 2) saves its
    step-1 snapshot; (1, 2) and (2, 1) then restore it, and (1, 2) also a
    one-device snapshot; JAX compiles and runs while the ranks run."""
    jcfg, enc, dec, port = weights
    root = tmp_path_factory.mktemp("train_mesh")
    one = _one_device(port)
    one, _ = make_train_step(tiny_config())(one, Batch(**_torch(_batch_np())))
    ckpt.save_train_state(root / "one", one)
    job = dict(params=port, batch=_torch(_batch_np()), odd_batch=_torch(_batch_np(3)),
               steps=STEPS)
    first = start_mesh(2, 2, root / "m22", dict(train=dict(job, save=str(root / "ckpt22"))))
    try:
        jax_runs = _jax_runs(jcfg, enc, dec, _batch_np())
    finally:
        ranks = {(2, 2): wait_mesh(first)}
    later = {(1, 2): [str(root / "ckpt22"), str(root / "one")], (2, 1): [str(root / "ckpt22")]}
    handles = {s: start_mesh(*s, root / f"m{s[0]}{s[1]}", dict(train=dict(job, restore=r)))
               for s, r in later.items()}
    for s, h in handles.items():
        ranks[s] = wait_mesh(h)
    return dict(ranks={s: [r["train"] for r in rs] for s, rs in ranks.items()},
                jax=jax_runs, root=root, one=one)


def _tp_dims(port) -> dict:
    return {n: d for (n, _), d in zip(named_params(*port), tp_dims(*port))}


def _slice(t, dim, tp: int, coord: int):
    t = torch.as_tensor(np.asarray(t))
    return t if dim is None else t.chunk(tp, dim=dim)[coord]


@pytest.mark.parametrize("shape", MESHES)
def test_loss_matches_jax(runs, shape):
    want = runs["jax"][shape]["losses"]
    losses = [r["losses"] for r in runs["ranks"][shape]]
    assert all(got == losses[0] for got in losses), "the ranks' losses differ"
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)
    assert losses[0][-1] < losses[0][0]


@pytest.mark.parametrize("shape", MESHES)
def test_gradient_shards_match_jax(runs, weights, shape):
    dims, tp = _tp_dims(weights[3]), shape[1]
    want = runs["jax"][shape]["grads"][0]
    for rank in runs["ranks"][shape]:
        assert rank["grads"].keys() == want.keys()
        for name, g in rank["grads"].items():
            ref = _slice(want[name], dims[name], tp, rank["coordinate"]["tp"])
            assert g.shape == ref.shape, name
            tol = 1e-4 * np.abs(np.asarray(want[name])).max() + 1e-7
            err = (g - ref).abs().max().item()
            assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
    # Sharded: 10 a encoder layer, conv_out, proj1_w/b, proj2_w; 7 a decoder
    # layer and the embedding.
    assert sum(d is not None for d in dims.values()) == 2 * 10 + 4 + 2 * 7 + 1


@pytest.mark.parametrize("shape", MESHES)
def test_parameters_match_jax_over_three_steps(runs, weights, shape):
    dims, tp = _tp_dims(weights[3]), shape[1]
    jax_run = runs["jax"][shape]
    scales = [max(np.abs(np.asarray(g)).max() for g in grads.values())
              for grads in jax_run["grads"]]
    for rank in runs["ranks"][shape]:
        coord = rank["coordinate"]["tp"]
        for k in range(STEPS):
            for name, p in rank["params"][k].items():
                ref = _slice(jax_run["params"][k][name], dims[name], tp, coord)
                err = (p - ref).abs()
                # Where JAX's gradient at any step so far is at rounding
                # level, Adam's step direction is noise.
                sure = torch.ones_like(err, dtype=torch.bool)
                for j in range(k + 1):
                    g = np.abs(np.asarray(jax_run["grads"][j][name]))
                    sure &= _slice(g > 1e-5 * scales[j], dims[name], tp, coord)
                if sure.any():
                    assert err[sure].max().item() <= 1e-6, f"{name} step {k + 1}"
                assert err.max().item() <= 2 * LR * (k + 1) + 1e-6, f"{name} step {k + 1}"


@pytest.mark.parametrize("shape", MESHES)
def test_replicated_leaves_bit_identical_across_ranks(runs, weights, shape):
    dims = _tp_dims(weights[3])
    ranks = runs["ranks"][shape]
    for k in range(STEPS):
        for name, d in dims.items():
            for rank in ranks:
                if d is None or rank["coordinate"]["tp"] == ranks[0]["coordinate"]["tp"]:
                    assert torch.equal(rank["params"][k][name], ranks[0]["params"][k][name]), \
                        f"{name} step {k + 1}"


@pytest.mark.parametrize("shape", MESHES)
def test_gloo_mesh_step_runs_its_body_eagerly(runs, shape):
    """A gloo group's collectives stage through host memory: the step is
    not graphed, and every call (the resumed run's on (2, 2) too) runs the
    body eagerly."""
    resumed = STEPS - 1 if shape == (2, 2) else 0
    for rank in runs["ranks"][shape]:
        assert rank["step"] == dict(graphed=False, captures=0, replays=0,
                                    eager_steps=STEPS + resumed, drops=0, capture_ms=0.0)


@pytest.mark.parametrize("shape", DP2)
def test_global_masked_mean_over_unequal_slices(runs, weights, shape):
    """dp slice 1 holds no label: the mesh's loss is the whole batch's masked
    mean (one device's), not the mean of the two slices' means."""
    from qwen3_asr_tpu_torch.training import asr_loss

    port = weights[3]
    whole = asr_loss(*port, tiny_config(), Batch(**_torch(_batch_np()))).item()
    first = asr_loss(*port, tiny_config(), Batch(**_torch(
        {k: v[:2] for k, v in _batch_np().items()}))).item()
    got = runs["ranks"][shape][0]["losses"][0]
    assert abs(got - whole) <= 1e-5 * whole
    assert abs(got - first / 2) > 0.1 * whole


@pytest.mark.parametrize("shape", DP2)
def test_dp_that_does_not_divide_the_batch_is_refused(runs, shape):
    for rank in runs["ranks"][shape]:
        assert rank["odd"] == "dp=2 does not divide the batch (3)"


# -- sharded checkpoints ----------------------------------------------------------------


def _gather(ranks: list[dict], pick, dims: dict) -> dict:
    """The whole leaves and moments of the ranks' local states
    ``pick(rank)`` (dp coordinate 0's ranks, in tp order)."""
    row = sorted((r for r in ranks if r["coordinate"]["dp"] == 0),
                 key=lambda r: r["coordinate"]["tp"])
    states = [pick(r) for r in row]
    params, moments = {}, {}
    for name, d in dims.items():
        parts = [s["params"][name] for s in states]
        params[name] = parts[0] if d is None else torch.cat(parts, dim=d)
        moments[name] = {}
        for k, v in states[0]["moments"][name].items():
            sharded = d is not None and v.shape == parts[0].shape
            moments[name][k] = torch.cat([s["moments"][name][k] for s in states], dim=d) \
                if sharded else v
    return {"params": params, "moments": moments}


def _assert_same(got: dict, want: dict) -> None:
    for name in want["params"]:
        assert torch.equal(got["params"][name], want["params"][name]), name
        assert got["moments"][name].keys() == want["moments"][name].keys(), name
        for k in want["moments"][name]:
            assert torch.equal(got["moments"][name][k], want["moments"][name][k]), (name, k)


@pytest.mark.parametrize("target", ["(2, 2)", "(1, 2)", "(2, 1)", "one device"])
def test_mesh_snapshot_restores_onto_any_mesh(runs, weights, target):
    dims = _tp_dims(weights[3])
    saved = _gather(runs["ranks"][(2, 2)], lambda r: r["saved"], dims)
    path = str(runs["root"] / "ckpt22")
    manifest = runs["root"] / "ckpt22" / "step_00000001" / ckpt.MANIFEST
    assert manifest.exists() and sorted(p.name for p in manifest.parent.iterdir()) == [
        ckpt.MANIFEST, "shard_tp0.pt", "shard_tp1.pt"]
    if target == "one device":
        restored = ckpt.restore_train_state(path, _one_device(weights[3]))
        assert restored.step == 1
        _assert_same(local_state(restored), saved)
        return
    shape = {"(2, 2)": (2, 2), "(1, 2)": (1, 2), "(2, 1)": (2, 1)}[target]
    ranks = runs["ranks"][shape]
    if shape == (2, 2):       # restored in the ranks, held to their saved state there
        assert all(r["resume"]["restored_equal"] and r["resume"]["restored_step"] == 1
                   for r in ranks)
        return
    restored = [r["restored"][path] for r in ranks]
    assert all(r["step"] == 1 for r in restored)
    _assert_same(_gather(ranks, lambda r: r["restored"][path], dims), saved)


def test_mesh_resume_is_bit_identical(runs):
    for rank in runs["ranks"][(2, 2)]:
        assert rank["resume"]["equal"], rank["coordinate"]
        assert rank["resume"]["losses"] == rank["losses"][1:]


def test_one_device_snapshot_restores_onto_tp2(runs, weights):
    dims = _tp_dims(weights[3])
    path = str(runs["root"] / "one")
    want = local_state(runs["one"])
    assert sorted(p.name for p in (runs["root"] / "one" / "step_00000001").iterdir()) == [
        ckpt.STATE_FILE]
    ranks = runs["ranks"][(1, 2)]
    assert all(r["restored"][path]["step"] == 1 for r in ranks)
    _assert_same(_gather(ranks, lambda r: r["restored"][path], dims), want)


def test_mesh_snapshot_refuses_other_layout(runs, weights):
    enc, dec = copy.deepcopy(weights[3])
    dec["layers"] = dec["layers"][:1]
    template = init_train_state(tiny_config(), ADAMW, enc, dec)
    with pytest.raises(ValueError, match="layout"):
        ckpt.restore_train_state(runs["root"] / "ckpt22", template)


# -- the dry run ------------------------------------------------------------------------


def test_dryrun_multichip_on_cpu(capfd):
    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh=(dp=2, tp=2) loss=" in out
    assert "tp-equivalence max|Δ|=" in out


def test_dryrun_multichip_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


# -- on the card -------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_bf16_row_parallel_backward(tmp_path):
    """``qlinear_row_parallel`` on bf16 CUDA tensors in a one-rank group:
    under autograd its backward equals the f32 route's (an f32 product of
    the same bf16 operands); without it, the partial is bit-identical to
    ``torch.mm(out_dtype=float32)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import torch.distributed as dist

    from qwen3_asr_tpu_torch.ops.quant import qlinear_row_parallel
    from qwen3_asr_tpu_torch.parallel import TP

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0)
    try:
        tp = TP(1, 0, dist.group.WORLD)
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(64, 1024, generator=g, device="cuda").bfloat16()
        w = (0.03 * torch.randn(1024, 2048, generator=g, device="cuda")).bfloat16()
        up = torch.randn(64, 2048, generator=g, device="cuda").bfloat16()
        with torch.no_grad():
            y = qlinear_row_parallel(x, w, tp)
            assert torch.equal(y, torch.mm(x, w, out_dtype=torch.float32).to(torch.bfloat16))
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ya = qlinear_row_parallel(xa, wa, tp)
        (ya.float() * up.float()).sum().backward()
        xf, wf = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yf = (xf.float() @ wf.float()).to(torch.bfloat16)
        (yf.float() * up.float()).sum().backward()
        assert torch.equal(ya, yf)
        assert torch.equal(xa.grad, xf.grad) and torch.equal(wa.grad, wf.grad)
    finally:
        dist.destroy_process_group()
