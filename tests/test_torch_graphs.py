"""The port's stepped decode loop (the plain version of the CUDA-graphed
loop, ``runtime/graphs.py``) against the JAX package, float32 on the CPU.

On CPU tensors ``Generator.decode`` runs the same step function that the
card captures as a graph, eagerly, in blocks of ``graphs.BLOCK`` steps with
one look at ``done`` per block.  At blocks of 1, 3 and 8 (3 and 8 leave
no-op steps after the last lane is done):

* greedy plain, plain over the int8 KV cache and greedy speculative
  ``transcribe_batch`` are token-identical to the JAX package's
  ``Generator.decode`` on the tiny checkpoint, with the same decode steps
  (verify iterations), and the block arithmetic (steps run, looks) holds;
* the sampled plain and sampled speculative loops are token-identical to
  the port's eager loop (``decode(eager=True)``, one step per look) at one
  seed, and one sampled step's draws (many lanes at one prefix) pass the
  chi-squared test of ``tests/test_torch_sampling.py`` against the exact
  distribution of the JAX package's sampler;
* steps taken after every lane is done change no token, count, flag or
  step counter;
* new values of ``temperature``, ``top_p``, ``top_k``,
  ``repetition_penalty`` and ``repetition_context_size`` keep the bucket
  key of the graph cache (only greedy/sampled changes it);
* ``record_launches``/``StepGraph`` take a capture's launches back out of
  ``LAUNCHES`` and add them once per replay (a stub graph);
* the arena: a buffer of a new name keeps the captured graphs, a grown one
  drops them all.

``cuda``-marked (skipped without a GPU): on the tiny decoder in bf16 on the
card, the graphed loop (plain, int8 cache, speculative, sampled) is
token-identical to the eager loop from one prefill, ``LAUNCHES`` after it
is the eager count plus the no-op replays' launches, and new sampling
values reuse the bucket's graph (no new capture).
"""

from __future__ import annotations

from collections import Counter
from functools import partialmethod

import numpy as np
import pytest
import torch

from test_torch_sampling import _chi2_ok, _plain_sample_dist
from torch_parity import clips, configs, ids_of, models

from qwen3_asr_tpu_torch.ops.kernels import _build
from qwen3_asr_tpu_torch.runtime import generate, graphs
from qwen3_asr_tpu_torch.runtime.generate import Generator

BLOCKS = (1, 3, 8)

#: Greedy settings held to the JAX package.
GREEDY = {
    "plain": dict(speculative="off"),
    "plain_int8_cache": dict(speculative="off", kv_cache_dtype="int8"),
    "speculative": dict(speculative="ngram"),
}


def _audio():
    return clips((1.0, 2.3, 5.1), seed=1)


def _eager_run(port, **kw) -> tuple[list[list[int]], int]:
    """Token ids and live steps of the port's eager loop (one step per look
    at ``done``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Generator, "decode", partialmethod(Generator.decode, eager=True))
        ids = ids_of(port.transcribe_batch(_audio(), **kw))
    gen = port._generator
    assert gen.last_host_syncs == gen.last_replays + 1 == gen.last_decode_steps + 1
    return ids, gen.last_decode_steps


@pytest.fixture(scope="module", params=list(GREEDY))
def greedy(request):
    """(setting, port model, JAX token ids, JAX verify lane-forwards, the
    eager loop's live steps)."""
    jax_model, port = models(seed=0, runtime=GREEDY[request.param])
    ref = ids_of(jax_model.transcribe_batch(_audio(), max_tokens=30))
    eager, steps = _eager_run(port, max_tokens=30)
    assert eager == ref
    return request.param, port, ref, jax_model.last_stats.n_spec_forwards, steps


def _check_blocks(gen: Generator, block: int) -> None:
    """Steps run are whole blocks, fewer than one block past the live
    steps, with one look before the first block and one after each."""
    steps, replays = gen.last_decode_steps, gen.last_replays
    assert replays % block == 0
    assert steps <= replays < steps + block
    assert gen.last_host_syncs == replays // block + 1


@pytest.mark.parametrize("block", BLOCKS)
def test_stepped_loop_token_identical_to_jax(greedy, block, monkeypatch):
    name, port, ref, jax_forwards, steps = greedy
    monkeypatch.setattr(graphs, "BLOCK", block)
    out = ids_of(port.transcribe_batch(_audio(), max_tokens=30))
    assert out == ref
    gen = port._generator
    assert gen.last_decode_steps == port.last_stats.n_decode_steps == steps
    assert port.last_stats.n_decode_replays == gen.last_replays
    assert port.last_stats.n_host_syncs == gen.last_host_syncs
    assert port.last_stats.n_spec_forwards == jax_forwards
    assert (jax_forwards > 0) == (name == "speculative")
    _check_blocks(gen, block)


SAMPLED = {"sampled": {}, "sampled_speculative": dict(spec_sampling=True)}
SAMPLING = dict(max_tokens=20, temperature=0.9, top_k=50, top_p=0.95, seed=3)


@pytest.fixture(scope="module", params=list(SAMPLED))
def sampled(request):
    """(setting, port model, the eager loop's token ids at one seed)."""
    _, port = models(seed=0, runtime=SAMPLED[request.param])
    return request.param, port, _eager_run(port, **SAMPLING)[0]


@pytest.mark.parametrize("block", BLOCKS)
def test_sampled_stepped_loop_equals_eager_loop(sampled, block, monkeypatch):
    name, port, eager = sampled
    monkeypatch.setattr(graphs, "BLOCK", block)
    assert ids_of(port.transcribe_batch(_audio(), **SAMPLING)) == eager
    assert (port._generator.last_spec_forwards > 0) == (name == "sampled_speculative")
    _check_blocks(port._generator, block)


def _spy_decode(monkeypatch) -> dict:
    """Records the arguments of every ``Generator.decode`` call."""
    seen = {}
    real = Generator.decode

    def spy(self, *args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(Generator, "decode", spy)
    return seen


def test_sampled_step_draws_match_the_jax_distribution(monkeypatch):
    """64 lanes at one prefix (prompt + the same first token) take one
    sampled plain step 80 times from the same state: 5120 draws of the
    filtered distribution of that step's penalized logits."""
    _, port = models(seed=0)
    seen = _spy_decode(monkeypatch)
    kw = dict(temperature=0.8, top_k=8, top_p=0.9, repetition_penalty=1.3)
    port.transcribe_batch(clips((2.3,), seed=4) * 64, max_tokens=3, seed=2, **kw)
    kv, first_logits, prompt_lens, max_tokens, tb = seen["args"]
    gen = port._generator
    statics = gen.plan_statics(tb, kw["temperature"], kw["top_k"], kw["repetition_penalty"], 100)
    req = gen._request(statics, tb, torch.Generator().manual_seed(7), prompt_lens,
                       [tb] * len(prompt_lens), kw["temperature"], kw["top_p"],
                       kw["top_k"], kw["repetition_penalty"], 100, first_logits.device)
    state0 = gen._first_state(req, first_logits, seed=7)
    first = int(state0.tokens[0, 0])
    state0.tokens[:, 0] = first
    state0.cur.fill_(first)
    state0.done.zero_()
    rows = []
    real_logits = generate.decoder_logits
    monkeypatch.setattr(generate, "decoder_logits",
                        lambda *a, **k: rows.append(real_logits(*a, **k)) or rows[-1])
    st = generate._clone(state0)
    draws = []
    with torch.inference_mode():
        for _ in range(80):
            generate._load(st, state0)
            gen._plain_step(kv, req, st)
            draws.append(st.tokens[:, 1].clone())
    logits = rows[0][0, 0].numpy()
    torch.testing.assert_close(rows[0][:, 0], rows[0][:1, 0].expand_as(rows[0][:, 0]))
    p = _plain_sample_dist(logits, [first], kw["repetition_penalty"], kw["temperature"],
                           kw["top_k"], kw["top_p"])
    _chi2_ok(torch.cat(draws).numpy(), p)


@pytest.mark.parametrize("setting", ["plain", "speculative"])
def test_steps_after_done_change_nothing(setting, monkeypatch):
    _, port = models(seed=0, runtime=GREEDY[setting])
    captured = {}
    real_step = Generator._step

    def spy_step(self, kv, req, state, spec):
        fn = real_step(self, kv, req, state, spec)
        captured.update(state=state, fn=fn)
        return fn

    monkeypatch.setattr(Generator, "_step", spy_step)
    port.transcribe_batch(_audio(), max_tokens=12)
    st = captured["state"]
    assert bool(st.done.all()) and int(st.steps) > 0
    before = [t.clone() for t in (st.tokens, st.counts, st.done, st.cur, st.steps)]
    with torch.inference_mode():
        for i in range(3):
            captured["fn"](int(st.steps) + i)
    after = (st.tokens, st.counts, st.done, st.cur, st.steps)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_sampling_values_keep_the_bucket():
    _, port = models(seed=0, runtime=dict(speculative="off"))
    audio = _audio()
    gen = port._generator
    keys = []
    for kw in (dict(temperature=0.7, top_p=0.9, top_k=20, repetition_penalty=1.1,
                    repetition_context_size=50),
               dict(temperature=1.1, top_p=0.8, top_k=40, repetition_penalty=1.3,
                    repetition_context_size=80),
               dict(temperature=0.0, repetition_penalty=1.2, repetition_context_size=100),
               dict(temperature=0.0, top_p=0.5, top_k=7, repetition_penalty=1.05,
                    repetition_context_size=30)):
        port.transcribe_batch(audio, max_tokens=6, **kw)
        keys.append(gen.last_bucket)
    assert keys[0] == keys[1] and keys[2] == keys[3]
    assert keys[0][3] == "sample" and keys[2][3] == "greedy"
    assert keys[0][:3] == keys[2][:3]


@pytest.mark.parametrize("block,live", [(1, 5), (3, 5), (8, 5), (4, 0), (3, 9)])
def test_run_blocks_counts_whole_blocks(block, live):
    """Every lane is done after ``live`` steps: the loop runs whole blocks
    covering them and looks once before the first block and once after
    each."""
    done = torch.full((2,), live == 0)
    calls = []

    def step(i):
        calls.append(i)
        done.fill_(len(calls) >= live)

    n, looks = graphs.run_blocks(step, done, block)
    want = -(-live // block) * block
    assert n == want and calls == list(range(want))
    assert looks == want // block + 1


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_recorded_launches(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", Counter({"kept": 2}))
    counted = graphs.record_launches(
        lambda: [_build.count(n) for n in ("decode_attention", "kv_write_rows_fused") * 3])
    assert counted == Counter({"decode_attention": 3, "kv_write_rows_fused": 3})
    assert _build.LAUNCHES == Counter({"kept": 2})
    stub = _StubGraph()
    step = graphs.StepGraph(stub, counted)
    for i in range(4):
        step.replay(i)
    assert stub.replays == 4
    assert _build.LAUNCHES == Counter({"kept": 2, "decode_attention": 12,
                                       "kv_write_rows_fused": 12})
    with pytest.raises(ZeroDivisionError):
        graphs.record_launches(lambda: _build.count("x") or 1 / 0)
    assert "x" not in +_build.LAUNCHES


def test_arena_growth_drops_graphs_a_new_buffer_none():
    """A buffer of a new name (the advance's views beside the decode
    loop's cache) keeps every captured graph; growing a buffer drops them
    all, since any may hold its old pointers; a smaller view reuses it."""
    dg = graphs.DecodeGraphs(torch.device("cpu"))
    dg.entries["advance"] = ("statics", "graph")
    a = dg.view("advance_k", (2, 3), torch.float32)
    dg.entries["decode"] = ("statics", "graph")
    dg.view("k", (4, 8), torch.bfloat16)
    assert set(dg.entries) == {"advance", "decode"} and dg.growths == 0
    assert dg.view("advance_k", (3,), torch.float32).data_ptr() == a.data_ptr()
    assert len(dg.entries) == 2
    dg.view("k", (4, 9), torch.bfloat16)
    assert dg.entries == {} and dg.growths == 1


# -- on the card: the graphed loop against the eager loop ---------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _tiny_generator(cuda, runtime: dict) -> Generator:
    """The tiny decoder in bf16 on the card (random weights, seed 0)."""
    from qwen3_asr_tpu_torch import RuntimeConfig
    from qwen3_asr_tpu_torch.models.decoder import fuse_decoder_params, init_decoder_params
    from qwen3_asr_tpu_torch.ops.quant import quantize_decoder_params

    tc = configs()[1].text_decoder
    params = fuse_decoder_params(init_decoder_params(
        tc, torch.Generator(device=cuda).manual_seed(0), torch.bfloat16, cuda))
    rt = RuntimeConfig(**runtime)
    if rt.quantization == "int8":
        params = quantize_decoder_params(params)
    return Generator(params, tc, rt)


def _prefill(gen: Generator, cuda, B: int):
    rng = np.random.default_rng(B)
    tc = gen.cfg
    P = 256
    plen = rng.integers(40, P, B)
    ids = torch.from_numpy(rng.integers(1, tc.vocab_size, (B, P))).to(cuda)
    feats = torch.from_numpy(rng.standard_normal((B, 64, tc.hidden_size)).astype(np.float32))
    kv, logits = gen.prefill(feats.to(cuda, torch.bfloat16), ids,
                             torch.full((B,), 30, device=cuda),
                             torch.from_numpy(plen).to(cuda), P + 64, arena=True)
    return kv, logits, plen.tolist()


CUDA_ARMS = {
    "plain": (dict(speculative="off"), {}),
    "int8_cache": (dict(speculative="off", kv_cache_dtype="int8"), {}),
    "speculative": (dict(speculative="ngram"), {}),
    "sampled": (dict(speculative="off"), dict(temperature=0.9, top_k=40, top_p=0.9)),
    "sampled_speculative": (dict(spec_sampling=True),
                            dict(temperature=0.9, top_k=40, top_p=0.9)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(CUDA_ARMS))
def test_graphed_loop_equals_eager_loop_on_the_card(cuda, arm):
    runtime, sampling = CUDA_ARMS[arm]
    gen = _tiny_generator(cuda, runtime)
    B = 4
    kv, logits, plen = _prefill(gen, cuda, B)
    kw = dict(repetition_penalty=1.1, seed=5, **sampling)
    _build.LAUNCHES.clear()
    eager = gen.decode(kv, logits, plen, [40] * B, 64, eager=True, **kw)
    eager_launches, eager_steps = Counter(_build.LAUNCHES), gen.last_decode_steps
    graphed = gen.decode(kv, logits, plen, [40] * B, 64, **kw)       # captures
    assert gen.graphs.captures == 1
    _build.LAUNCHES.clear()
    again = gen.decode(kv, logits, plen, [40] * B, 64, **kw)
    assert graphed == again == eager
    assert gen.last_decode_steps == eager_steps
    per = gen.graphs.get(gen.last_bucket)[1].launches
    extra = gen.last_replays - gen.last_decode_steps
    assert +_build.LAUNCHES == +(eager_launches + Counter({k: v * extra for k, v in per.items()}))
    if sampling:
        gen.decode(kv, logits, plen, [40] * B, 64, **dict(kw, temperature=0.5, top_k=7,
                                                            top_p=0.8, seed=6))
        assert gen.graphs.captures == 1
    gen.close()
