"""The port's ``parallel/`` against the JAX package's, and its meshes on the
CPU against one device and against the JAX package's tp = 2 model.

Rules and shards are compared in this process: the port's rule tables and
int8 specs equal the JAX package's, and each tp rank's local slice (bf16
layout and int8 ``{"q", "s"}``) equals the JAX leaf's
``addressable_shards[rank].data`` on the virtual tp = 2 CPU mesh
(``tests/conftest.py``).  Meshes run in processes of their own
(``tests/torch_mesh.py``: gloo, ``file://`` rendezvous), each shape spawned
once for the module, on the tiny float32 checkpoint of
``tests/torch_parity.py``:

  * (dp, tp) = (1, 2): greedy tokens of ``transcribe_batch`` (default and
    ``speculative="off"``) and ``transcribe`` identical to the port's one
    device and to the JAX package's tp = 2 model; the prefill logits within
    1e-4 of one device (the multichip dryrun's tolerance,
    ``__graft_entry__.py:225``); int8 weights and W8A8
    (``act_quant_min_rows=1``) token-identical to one device; sampled
    tokens equal in both ranks; the tp collectives' gradients on a column ->
    row pair of linears within 1e-6 of one device; what a tp group refuses;
  * (2, 1): each dp slice bit-identical to one device's ``transcribe_batch``
    of the same slice (greedy, long-form chunks, language detection), the
    whole list in every rank, a dp coordinate with no clip decoding
    nothing;
  * (2, 2): greedy tokens identical to one device and to JAX's tp = 2.

The same spawns serve (``tests/torch_mesh.py``'s serving job, every rank
constructing each server and the driving rank submitting):

  * (1, 2): the continuous server, paged under ``spec_engine="off"`` and
    ``"auto"`` and flat, on the JAX test's three clips
    (``tests/test_parallel.py:162-193``) and then a request admitted
    mid-decode: ids equal to the port's one-device ``transcribe`` and to
    the JAX tp = 2 model's, every rank's engine state equal after every
    operation; sampled requests equal across ranks and on a second run;
    the engine driven by hand through the control channel on a fixed
    schedule over an oversubscribed pool, its counters, pages and tokens
    equal to one device's on the same schedule; a ``StreamingTranscriber``
    through the server; a follower's ``submit`` and a direct call beside a
    running server refused; a follower raising once inside an admission
    ends the server on both ranks, the error on every pending future;
  * (1, 2), (2, 1), (2, 2): the drain server equal to ``transcribe_batch``
    of the same clips, and, with its first batch raising on every rank,
    to ``transcribe`` of each clip retried alone; (2, 2) also runs a
    continuous server in each tp group.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh import run_mesh
from torch_parity import (
    RUNTIME,
    StubTokenizer,
    clips,
    configs,
    ids_of,
    jax_model,
    numpy_params,
    port_config,
)

SEED = 0
KW = dict(max_tokens=12)
BATCH = clips((1.0, 2.3, 5.1), seed=1)
SINGLE = clips((3.7,), seed=2)[0]
SINGLE_KW = dict(max_tokens=20, language="de")
SAMPLED = dict(max_tokens=12, temperature=0.7, top_k=50, top_p=0.9, seed=1)
W8A8 = dict(quantization="int8", act_quant="int8", act_quant_min_rows=1)
LONG = clips((5.1,), seed=4)[0]
LONG_KW = dict(chunk_duration=2.0)
PCM = [(a * 30000).astype(np.int16) for a in clips((1.5, 0.4, 0.9), seed=3)]
DETECT_KW = dict(max_tokens=6, language="detect")


def _sine(seconds, freq):
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


#: The JAX package's tp serving test's clips (``tests/test_parallel.py:178``).
SERVE_CLIPS = [_sine(1.0, 350.0), _sine(0.5, 500.0), _sine(1.5, 260.0)]
LONG_CLIP, SHORT_CLIP = clips((2.0, 0.6), seed=5)
STREAM = clips((2.6,), seed=6)[0]
SERVE_SAMPLED = dict(temperature=0.7, top_k=50, top_p=0.9, seed=1)
#: The continuous servers of the (1, 2) serving job: (runtime, paged).
SERVE_CONTINUOUS = {"paged off": ({"spec_engine": "off"}, True), "paged auto": ({}, True),
                    "flat": ({}, False)}
#: The hand-driven engine: 3 slots over 5 usable pages of 128 rows.
SCHEDULE_ENGINE = dict(n_slots=3, max_duration=8.0, max_new_tokens=256, chunk_steps=4,
                       page_size=128, kv_pool_gb=6 * 2 * 2 * 128 * 256 * 2 / 2**30)


@pytest.fixture(scope="module")
def numpy_tree():
    jcfg, _ = configs()
    return numpy_params(jcfg, SEED)


@pytest.fixture(scope="module")
def port_params(numpy_tree):
    from qwen3_asr_tpu_torch.models.params import params_from_jax

    return params_from_jax(*numpy_tree)


def _port(port_params, **runtime):
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig

    return Qwen3ASR(port_config(), *port_params, StubTokenizer(),
                    RuntimeConfig(**dict(RUNTIME, **runtime)))


def _case(name, batch=BATCH, kwargs=KW, single=False, **runtime):
    return dict(name=name, runtime=dict(RUNTIME, **runtime), clips=batch, kwargs=kwargs,
                single=single)


def _single_device(port_params, case) -> tuple[list, list]:
    """(ids, first logits) of one device on a case."""
    model = _port(port_params, **{k: v for k, v in case["runtime"].items() if k not in RUNTIME})
    seen = []
    real = model._generator.decode
    model._generator.decode = lambda kv, fl, *a, **k: seen.append(fl.clone()) or real(kv, fl, *a, **k)
    if case["single"]:
        out = [model.transcribe(case["clips"][0], **case["kwargs"])]
    else:
        out = model.transcribe_batch(case["clips"], **case["kwargs"])
    return ids_of(out), seen


# -- rules and shards ---------------------------------------------------------------


def _as_tuple(spec) -> tuple:
    return tuple(spec)


def test_rule_tables_match_jax():
    from qwen3_asr_tpu.parallel import sharding as jsh

    from qwen3_asr_tpu_torch.parallel import sharding as tsh

    for jrules, trules in ((jsh._DECODER_RULES, tsh._DECODER_RULES),
                           (jsh._ENCODER_RULES, tsh._ENCODER_RULES)):
        assert {k: _as_tuple(v) for k, v in jrules.items()} == trules
        for path, spec in jrules.items():
            if len(spec) < 2:
                continue                  # a vector: never a quantized weight
            jq = {k: _as_tuple(v) for k, v in jsh._quant_specs(path, spec).items()}
            assert jq == tsh._quant_specs(path, _as_tuple(spec)), path


def test_parallel_exports_cover_jax():
    import qwen3_asr_tpu.parallel as jpar

    import qwen3_asr_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(hasattr(tpar, n) for n in tpar.__all__)


def _jax_shards(tree, shardings_fn):
    """JAX leaves placed on the virtual tp = 2 mesh: path -> [rank 0 data,
    rank 1 data] (numpy), layer leaves stacked."""
    import jax

    from qwen3_asr_tpu.parallel.mesh import make_mesh
    from qwen3_asr_tpu.parallel.sharding import shard_params

    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    placed = shard_params(tree, shardings_fn(tree, mesh))
    devices = list(mesh.devices.reshape(-1))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        key = "/".join(p.key for p in path)
        by_device = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        out[key] = [by_device[d] for d in devices]
    return out


def _port_shards(tree, shardings_fn):
    from qwen3_asr_tpu_torch.parallel import Mesh, shard_params

    return [shard_params(tree, shardings_fn(tree), Mesh({"dp": 1, "tp": 2}, {"dp": 0, "tp": r}))
            for r in range(2)]


def _hold_shards(jax_tree, port_tree, jax_fn, port_fn) -> int:
    """Every leaf's rank slices equal JAX's; returns how many leaves split."""
    jax_shards = _jax_shards(jax_tree, jax_fn)
    port_shards = _port_shards(port_tree, port_fn)
    split = 0
    for key, per_rank in jax_shards.items():
        if key.startswith("conv") and not key.startswith("conv_out"):
            continue          # conv kernels: replicated, and OIHW in the port
        layered = key.startswith("layers/")
        for rank in range(2):
            if layered:
                got = [_full(lp, key[len("layers/"):]) for lp in port_shards[rank]["layers"]]
                want = per_rank[rank]
            else:
                got, want = [_full(port_shards[rank], key)], per_rank[rank][None]
            for layer, t in enumerate(got):
                np.testing.assert_array_equal(t.numpy(), want[layer], err_msg=f"{key} rank {rank}")
                if t.dtype == torch.int8:
                    assert t.t().is_contiguous(), f"{key}: q not K-major"
                else:
                    assert t.is_contiguous(), key
        split += per_rank[0].shape != np.shape(_full(jax_tree, key))
    return split


def _full(tree, key):
    for p in key.split("/"):
        tree = tree[p]
    return tree


def test_shards_equal_jax_bf16_layout(numpy_tree, port_params):
    from qwen3_asr_tpu.parallel import sharding as jsh

    from qwen3_asr_tpu_torch.parallel import sharding as tsh

    enc, dec = numpy_tree
    enc_t, dec_t = port_params
    assert _hold_shards(dec, dec_t, jsh.decoder_param_sharding, tsh.decoder_param_sharding) == 8
    assert _hold_shards(enc, enc_t, jsh.encoder_param_sharding, tsh.encoder_param_sharding) == 14
    # Shards are copies, not views of the whole.
    local = _port_shards(dec_t, tsh.decoder_param_sharding)[1]
    assert local["embedding"].untyped_storage().data_ptr() != \
        dec_t["embedding"].untyped_storage().data_ptr()


def test_shards_equal_jax_int8(numpy_tree):
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.quant import quantize_decoder_params, quantize_encoder_params
    from qwen3_asr_tpu.parallel import sharding as jsh

    from qwen3_asr_tpu_torch.models.params import params_from_jax
    from qwen3_asr_tpu_torch.parallel import sharding as tsh

    enc, dec = numpy_tree
    jdec = quantize_decoder_params(jax.tree_util.tree_map(jnp.asarray, dec))
    jenc = quantize_encoder_params(jax.tree_util.tree_map(jnp.asarray, enc))
    np_dec = jax.tree_util.tree_map(np.asarray, jdec)
    np_enc = jax.tree_util.tree_map(np.asarray, jenc)
    enc_t, dec_t = params_from_jax(np_enc, np_dec)
    assert dec_t["embedding"]["q"].shape == (64, 512)       # (H, V), transposed
    assert _hold_shards(jdec, dec_t, jsh.decoder_param_sharding, tsh.decoder_param_sharding) == 14
    assert _hold_shards(jenc, enc_t, jsh.encoder_param_sharding, tsh.encoder_param_sharding) == 20


def test_placements():
    from torch.distributed.tensor.placement_types import Replicate, Shard

    from qwen3_asr_tpu_torch.parallel import (
        decoder_param_sharding,
        kv_cache_sharding,
        replicated,
    )

    assert kv_cache_sharding() == (Shard(1), Shard(2))
    assert replicated() == (Replicate(), Replicate())
    dec = {"embedding": torch.zeros(8, 4), "final_norm": torch.zeros(4),
           "layers": [{"wq": torch.zeros(4, 8), "wo": torch.zeros(8, 4), "ln1": torch.zeros(4),
                       "wd": {"q": torch.zeros(8, 4, dtype=torch.int8), "s": torch.zeros(4)}}]}
    p = decoder_param_sharding(dec)
    assert p["embedding"] == (Replicate(), Shard(0))
    assert p["final_norm"] == (Replicate(), Replicate())
    assert p["layers"][0]["wq"] == (Replicate(), Shard(1))
    assert p["layers"][0]["wo"] == (Replicate(), Shard(0))
    assert p["layers"][0]["wd"] == {"q": (Replicate(), Shard(0)), "s": (Replicate(), Replicate())}


def test_tp_that_does_not_divide_is_refused():
    from qwen3_asr_tpu_torch.parallel import check_tp

    cfg = port_config()
    check_tp(cfg, 2)
    with pytest.raises(ValueError, match="KV heads"):
        check_tp(cfg, 4)
    with pytest.raises(ValueError, match="query heads"):
        check_tp(cfg, 3)


def test_mesh_needs_a_process_group(port_params):
    from qwen3_asr_tpu_torch.parallel import local_mesh, make_mesh, topology

    assert local_mesh().shape == {"dp": 1, "tp": 1}
    assert make_mesh(1, 1).shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="parallel.initialize"):
        make_mesh(4, 2)
    top = topology()
    assert (top.process_index, top.process_count, top.global_devices) == (0, 1, 1)
    with pytest.raises(ValueError, match="parallel.initialize"):
        _port(port_params, tp=2)


# -- meshes ----------------------------------------------------------------------------


def _grad_payload():
    rng = np.random.default_rng(7)
    t = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in (("x", (3, 8)), ("w1", (8, 6)), ("w2", (6, 8)), ("cy", (3, 8)),
                      ("cz", (3, 6)))}
    return t


TP2_CASES = [
    _case("default"),
    _case("off", speculative="off"),
    _case("single", batch=[SINGLE], kwargs=SINGLE_KW, single=True),
    _case("int8", quantization="int8"),
    _case("w8a8", **W8A8),
    _case("sampled", kwargs=SAMPLED),
]
DP2_CASES = [
    _case("default"),
    _case("off", speculative="off"),
    _case("single", batch=[SINGLE], kwargs=SINGLE_KW, single=True),
    _case("long", batch=[LONG, BATCH[0]], kwargs=dict(LONG_KW, max_tokens=8)),
    _case("detect", batch=PCM, kwargs=DETECT_KW),
]
DP2TP2_CASES = [_case("default"), _case("off", speculative="off")]


def _serving(*runs, **extra):
    return dict(dict(runs=runs, runtime=RUNTIME, clips=SERVE_CLIPS, long=LONG_CLIP,
                     short=SHORT_CLIP, stream=STREAM, sampling=SERVE_SAMPLED,
                     continuous=SERVE_CONTINUOUS, engine=SCHEDULE_ENGINE), **extra)


@pytest.fixture(scope="module")
def tp2(port_params, tmp_path_factory):
    payload = dict(params=port_params, cases=TP2_CASES, grads=_grad_payload(), refusals=True,
                   serving=_serving("continuous", "sampled", "schedule", "drain", "stream",
                                    "fault"))
    return run_mesh(1, 2, tmp_path_factory.mktemp("tp2"), payload)


@pytest.fixture(scope="module")
def dp2(port_params, tmp_path_factory):
    payload = dict(params=port_params, cases=DP2_CASES, serving=_serving("drain"))
    return run_mesh(2, 1, tmp_path_factory.mktemp("dp2"), payload)


@pytest.fixture(scope="module")
def dp2tp2(port_params, tmp_path_factory):
    payload = dict(params=port_params, cases=DP2TP2_CASES,
                   serving=_serving("drain", "continuous",
                                    continuous={"paged off": SERVE_CONTINUOUS["paged off"]}))
    return run_mesh(2, 2, tmp_path_factory.mktemp("dp2tp2"), payload)


@pytest.fixture(scope="module")
def jax_tp2():
    return jax_model(SEED, runtime={"dp": 1, "tp": 2})


@pytest.fixture(scope="module")
def reference(port_params):
    """One device's (ids, first logits) of every case, by name."""
    return {c["name"]: _single_device(port_params, c) for c in TP2_CASES}


def _same_in_every_rank(ranks, name):
    ids = [r[name]["ids"] for r in ranks]
    assert all(i == ids[0] for i in ids), name
    return ids[0]


@pytest.mark.parametrize("name", ["default", "off", "single"])
def test_tp2_greedy_matches_one_device_and_jax(tp2, reference, jax_tp2, name):
    got = _same_in_every_rank(tp2, name)
    assert got == reference[name][0]
    case = next(c for c in TP2_CASES if c["name"] == name)
    if case["single"]:
        ref = [jax_tp2.transcribe(case["clips"][0], **case["kwargs"])]
    else:
        ref = jax_tp2.transcribe_batch(case["clips"], **case["kwargs"])
    assert got == ids_of(ref)
    assert len({t for seq in got for t in seq}) > 1


def test_tp2_logits_within_dryrun_tolerance(tp2, reference):
    for name in ("default", "off", "single"):
        ref = reference[name][1]
        for rank in tp2:
            got = rank[name]["logits"]
            assert len(got) == len(ref) > 0
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["int8", "w8a8"])
def test_tp2_int8_token_identical(tp2, reference, name):
    assert _same_in_every_rank(tp2, name) == reference[name][0]


def test_tp2_sampled_equal_across_ranks(tp2):
    ids = _same_in_every_rank(tp2, "sampled")
    assert all(len(seq) > 0 for seq in ids)
    assert len({t for seq in ids for t in seq}) > 3


def test_tp2_collective_gradients(tp2):
    g = _grad_payload()
    x = g["x"].clone().requires_grad_(True)
    w1 = g["w1"].clone().requires_grad_(True)
    w2 = g["w2"].clone().requires_grad_(True)
    h = torch.tanh(x @ w1)
    y = h @ w2
    loss = (y * g["cy"]).sum() + (h * g["cz"]).sum()
    loss.backward()
    for rank, out in enumerate(r["grads"] for r in tp2):
        np.testing.assert_allclose(out["y"], y.detach(), atol=1e-6)
        np.testing.assert_allclose(out["z"], h.detach(), atol=1e-6)
        np.testing.assert_allclose(out["x"], x.grad, atol=1e-6)
        np.testing.assert_allclose(out["w1"], w1.grad.chunk(2, dim=1)[rank], atol=1e-6)
        np.testing.assert_allclose(out["w2"], w2.grad.chunk(2, dim=0)[rank], atol=1e-6)


def test_tp2_refusals(tp2):
    """A tp group refuses the incremental session (the JAX package refuses
    meshes there too) and makes the engine, its pool on the local heads."""
    for rank in tp2:
        out = rank["refusals"]
        assert out["make_engine"] is None
        L, n_pages, heads, PS, D = out["make_engine result"]
        assert (L, heads, PS, D) == (2, 1, 256, 128)
        assert out["incremental_session"].startswith("ValueError")
    assert [r["topology"].process_index for r in tp2] == [0, 1]
    assert all(r["topology"].process_count == 2 for r in tp2)


def _slices(batch, dp=2):
    per, extra = divmod(len(batch), dp)
    out, lo = [], 0
    for d in range(dp):
        n = per + (d < extra)
        out.append(batch[lo : lo + n])
        lo += n
    return out


@pytest.mark.parametrize("name", ["default", "off", "long", "detect"])
def test_dp2_equals_one_device_on_each_slice(dp2, port_params, name):
    case = next(c for c in DP2_CASES if c["name"] == name)
    model = _port(port_params, **{k: v for k, v in case["runtime"].items() if k not in RUNTIME})
    want, langs = [], []
    for part in _slices(case["clips"]):
        res = model.transcribe_batch(part, **case["kwargs"])
        want += ids_of(res)
        langs += [r.language for r in res]
    assert _same_in_every_rank(dp2, name) == want
    assert all(r[name]["languages"] == langs for r in dp2)
    assert [r[name]["decoded"] for r in dp2] == [True, True]


def test_dp2_single_clip_decodes_on_the_first_slice(dp2, reference):
    assert _same_in_every_rank(dp2, "single") == reference["single"][0]
    assert [r["single"]["decoded"] for r in dp2] == [True, False]


@pytest.mark.parametrize("name", ["default", "off"])
def test_dp2_tp2_matches_one_device_and_jax(dp2tp2, reference, jax_tp2, name):
    got = _same_in_every_rank(dp2tp2, name)
    assert got == reference[name][0]
    case = next(c for c in DP2TP2_CASES if c["name"] == name)
    assert got == ids_of(jax_tp2.transcribe_batch(case["clips"], **case["kwargs"]))
    assert [r[name]["decoded"] for r in dp2tp2] == [True] * 4


# -- serving on the meshes ---------------------------------------------------------------

#: The continuous job's requests in result order, and their budgets.
SERVE_ORDER = SERVE_CLIPS + [SHORT_CLIP, LONG_CLIP]
SERVE_BUDGETS = [5, 5, 5, 4, 40]


@pytest.fixture(scope="module")
def serve_reference(port_params):
    """One device's ``transcribe`` ids of the continuous job's requests."""
    model = _port(port_params)
    return [ids_of([model.transcribe(c, max_tokens=m)])[0]
            for c, m in zip(SERVE_ORDER, SERVE_BUDGETS)]


def _hold_states(a, b) -> None:
    """Two runs' engine states (``torch_mesh.engine_state`` after every
    operation) equal, operation by operation."""
    assert [op for op, _ in a] == [op for op, _ in b]
    for i, ((op, x), (_, y)) in enumerate(zip(a, b)):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], torch.Tensor):
                assert torch.equal(x[k], y[k]), (i, op, k)
            else:
                assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), (i, op, k)


@pytest.mark.parametrize("label", list(SERVE_CONTINUOUS))
def test_tp2_continuous_server_matches_one_device_and_jax(tp2, serve_reference, jax_tp2,
                                                          label):
    lead, follower = (r["serving"][label] for r in tp2)
    assert lead["ids"] == serve_reference
    assert lead["ids"] == [ids_of([jax_tp2.transcribe(c, max_tokens=m)])[0]
                             for c, m in zip(SERVE_ORDER, SERVE_BUDGETS)]
    assert lead["stats"]["mid_decode_admissions"] >= 1
    assert lead["stats"] == follower["stats"]
    assert lead["retired"] == follower["retired"]
    assert lead["fault"] == follower["fault"] == "None"


@pytest.mark.parametrize("label", list(SERVE_CONTINUOUS))
def test_tp2_continuous_ranks_in_lockstep(tp2, label):
    lead, follower = (r["serving"][label] for r in tp2)
    _hold_states(lead["states"], follower["states"])
    assert len(lead["states"]) > 10
    assert (lead["stats"]["spec_chunks"] > 0) == (label != "paged off")


def test_tp2_engine_schedule_matches_one_device(tp2, port_params):
    import dataclasses

    from torch_mesh import engine_schedule, engine_state

    from qwen3_asr_tpu_torch.serving.server import engine_op

    model = _port(port_params)
    engine = model.make_engine(paged=True, **SCHEDULE_ENGINE)
    states, retired = [], []

    def run(op, args):
        result = engine_op(model, engine, op, args)
        states.append((op, engine_state(engine)))
        if op == "retire":
            retired.append([toks for _, toks in result])
        return result

    engine_schedule(engine, run, SERVE_CLIPS)
    assert engine.n_pages == 6 and engine._keys.shape[2] == 2
    assert any(s["paused"].any() for _, s in states)          # the pool ran out
    assert engine.stats.mid_decode_admissions >= 1
    for rank in tp2:
        got = rank["serving"]["schedule"]
        assert got["n_pages"] == engine.n_pages and got["pool"][2] == 1
        assert got["stats"] == dataclasses.asdict(engine.stats)
        assert got["retired"] == retired
        _hold_states(got["states"], states)


def test_tp2_sampled_server_equal_across_ranks_and_runs(tp2):
    lead, follower = (r["serving"]["sampled"] for r in tp2)
    for run in range(2):
        assert lead[run]["retired"] == follower[run]["retired"]
        _hold_states(lead[run]["states"], follower[run]["states"])
    assert lead[0]["ids"] == lead[1]["ids"]
    assert len({t for seq in lead[0]["ids"] for t in seq}) > 3


@pytest.mark.parametrize("mesh", ["tp2", "dp2", "dp2tp2"])
def test_mesh_drain_server_matches_transcribe_batch(request, port_params, mesh):
    ranks = request.getfixturevalue(mesh)
    model = _port(port_params)
    dp = 1 if mesh == "tp2" else 2
    batch = [ids for part in _slices(SERVE_CLIPS, dp)
             for ids in ids_of(model.transcribe_batch(part, max_tokens=5))]
    alone = [ids_of([model.transcribe(c, max_tokens=5)])[0] for c in SERVE_CLIPS]
    lead = ranks[0]["serving"]["drain"]
    assert lead["ids"] == [batch, alone]
    assert lead["errors"] == ["ValueError", "ValueError"]
    assert lead["batches"] == [1, 1]
    for rank in ranks[1:]:
        assert "driving rank, global rank 0" in rank["serving"]["drain"]["submit"]


def test_tp2_streaming_through_the_server(tp2, port_params):
    got = tp2[0]["serving"]["stream"]
    model = _port(port_params)
    want = [ids_of([model.transcribe(STREAM[round(a * 16000):round(b * 16000)],
                                     max_tokens=5)])[0] for a, b in got["segments"]]
    assert got["ids"] == want and len(got["segments"]) >= 2
    assert got["segments"][-1][1] == pytest.approx(len(STREAM) / 16000)


def test_tp2_follower_submit_and_direct_calls_refused(tp2):
    for label in SERVE_CONTINUOUS:
        assert "driving rank, global rank 0" in tp2[1]["serving"][label]["submit"]
        assert "submit to the server" in tp2[0]["serving"][label]["direct"]


def test_tp2_server_fault_stops_every_rank(tp2):
    lead, follower = (r["serving"]["fault"] for r in tp2)
    assert len(lead["errors"]) == 2
    assert all("RankFault" in e and "rank 1: RuntimeError: injected fault" in e
               for e in lead["errors"])
    assert "is closed" in lead["after"]
    for side in (lead, follower):
        assert "RankFault" in side["fault"] and not side["alive"]
    assert lead["seconds"] < 60


def test_tp2_warm_up_out_of_memory_on_a_follower_gives_sizing_advice(tp2):
    lead, follower = (r["serving"]["fault"] for r in tp2)
    assert "ran out of device memory at admission-group size 1" in lead["oom"]
    assert "kv_pool_gb=" in lead["oom"]
    assert follower["oom"] is None
    assert "RankFault" in follower["oom_fault"] and "OutOfMemoryError" in follower["oom_fault"]


def test_dp2tp2_continuous_server_in_each_tp_group(dp2tp2, serve_reference):
    for d in (0, 1):
        lead, follower = (dp2tp2[2 * d + r]["serving"]["paged off"] for r in (0, 1))
        assert lead["ids"] == serve_reference
        assert lead["retired"] == follower["retired"]
        _hold_states(lead["states"], follower["states"])
