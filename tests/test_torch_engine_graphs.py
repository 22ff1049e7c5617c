"""The continuous engine's stepped chunk (the plain version of its CUDA-graphed
chunk, ``runtime/engine.py``) against the JAX engine, float32 on the CPU.

On CPU tensors ``DecodeEngine.step`` runs the same iteration function that
the card captures as a graph, eagerly, in blocks of ``graphs.BLOCK`` with
one look at the lanes a block, stopping at the chunk's ``k_steps``.  With
chunks of 5 iterations and blocks of 1, 3 and 8 (3 leaves the chunk's last
block short, 8 is cut at the chunk's end, and both leave no-op iterations
after the last lane is done):

* greedy chunks are token-identical to the JAX ``DecodeEngine`` chunk by
  chunk, with the same counters, for flat and paged engines, f32 and int8
  caches, plain and speculative chunks, with a mid-decode admission; the
  live iterations counted on the device equal the one-iteration-a-look
  run's;
* ``graphs.run_blocks`` stops at the chunk's cap, its last block cut short
  there with no look after it;
* a sampled request's stream (counter streams keyed by its seed and token
  index) is the same alone, beside other requests and after a pause for
  pages, at blocks 1 and 8; the counter stream's draws pass the
  chi-squared test of ``tests/test_torch_sampling.py`` against the exact
  filtered distribution, over seeds and over token indices;
* a mixed chunk picks one candidate pool for every lane from the largest
  ``top_k`` of its live lanes, as the JAX engine does (``engine.py``
  :1112-1117), so a ``top_k=0`` lane beside a ``top_k=40`` one samples
  from the JAX engine's pool;
* iterations run after every lane is done change no token, count, flag or
  counter;
* every tensor a chunk reads or writes keeps its ``data_ptr()`` across
  admissions, chunks, page events, retirements and compaction.

``cuda``-marked (skipped without a GPU): on the tiny model in bf16 on the
card, graphed chunks are token-identical to ``eager=True`` chunks from the
same admissions, with equal counters, and the launches are the eager
count plus the no-op replays' launches.

The tiny model never emits a real EOS id (vocab 512), so every sequence
runs to its budget.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_engine import _drive, _stats
from test_torch_sampling import _chi2_ok, _plain_sample_dist
from torch_parity import clips, models

from qwen3_asr_tpu_torch.ops import sampling as tsamp
from qwen3_asr_tpu_torch.runtime import engine as teng
from qwen3_asr_tpu_torch.runtime import graphs
from qwen3_asr_tpu_torch.runtime.engine import DecodeEngine, SlotRequest

BLOCKS = (1, 3, 8)
CHUNK = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: its tiny steps are a few
    microseconds of work each, and beside the other test workers more
    threads only wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return models(seed=0, runtime=dict(token_buckets=(16, 128, 256)))


# -- greedy chunks against the JAX engine ---------------------------------------------


_JAX_RUNS: dict = {}
_BLOCK1: dict = {}


def _engine_run(model, cls, paged: bool, kv: str, spec: str):
    rt = model._generator.runtime
    saved = (rt.spec_engine, rt.kv_cache_dtype)
    rt.spec_engine, rt.kv_cache_dtype = spec, kv
    try:
        engine = model.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                                   chunk_steps=CHUNK, paged=paged)
        audio = clips((1.0, 2.3, 5.1), seed=3)
        results, trace = _drive(model, engine, cls, audio, [9, 14, 6])
        return results, trace, engine.stats
    finally:
        rt.spec_engine, rt.kv_cache_dtype = saved


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("spec", ["off", "on"])
@pytest.mark.parametrize("kv", ["bf16", "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_stepped_chunks_token_identical_to_jax(pair, paged, kv, spec, block, monkeypatch):
    """Tokens chunk by chunk and counters equal to the JAX engine's; live
    iterations equal at every block size; the blocks' arithmetic.  (The
    flat int8 engine never speculates; the f32 model's "bf16" cache holds
    f32 rows.)"""
    from qwen3_asr_tpu.runtime.engine import SlotRequest as JaxSlot

    jax_model, port = pair
    cfg = (paged, kv, spec)
    # The flat int8 engine never speculates: "on" is held to JAX's "off" run.
    jax_cfg = (paged, kv, "off") if (not paged and kv == "int8") else cfg
    if jax_cfg not in _JAX_RUNS:
        results, trace, st = _engine_run(jax_model, JaxSlot, *jax_cfg)
        _JAX_RUNS[jax_cfg] = (results, trace, _stats(st))
    monkeypatch.setattr(graphs, "BLOCK", block)
    results, trace, st = _engine_run(port, SlotRequest, *cfg)
    assert (results, trace, _stats(st)) == _JAX_RUNS[jax_cfg]
    assert st.mid_decode_admissions == 1
    assert (st.spec_chunks > 0) == (spec == "on" and (paged or kv == "bf16"))
    if block == 1:
        _BLOCK1[cfg] = st.iterations
        assert st.replays == st.iterations
    elif cfg in _BLOCK1:
        assert st.iterations == _BLOCK1[cfg]
    assert st.iterations <= st.replays <= st.iterations + (block - 1) * st.chunks
    assert st.chunks <= st.looks <= 2 * st.chunks + st.replays // block


@pytest.mark.parametrize("block,live,cap,want", [
    (3, 10, 5, (5, 2)), (8, 10, 5, (5, 1)), (4, 2, 16, (4, 2)), (1, 5, 5, (5, 5)),
    (3, 4, 9, (6, 3)),
])
def test_run_blocks_stops_at_the_cap(block, live, cap, want):
    """Every lane is done after ``live`` steps; a chunk of ``cap`` steps:
    whole blocks until the cap, the last one cut short there with no look
    after it, or the block that finishes the lanes and its look."""
    done = torch.zeros(2, dtype=torch.bool)
    calls = []

    def step(i):
        calls.append(i)
        done.fill_(len(calls) >= live)

    assert graphs.run_blocks(step, done, block, cap=cap) == want
    assert calls == list(range(want[0]))


# -- sampled streams -------------------------------------------------------------------


SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.95, repetition_penalty=1.1)


def _sampled_reqs(audio, prompts, metas, seeds, budget):
    return [SlotRequest(samples=a, prompt=p, max_new=budget, meta=m,
                        **(dict(SAMPLED, seed=s) if s is not None else {}))
            for a, p, m, s in zip(audio, prompts, metas, seeds)]


def _run_engine(engine, n_results, trace=None, max_chunks=80):
    results = {}
    for _ in range(max_chunks):
        engine.step()
        if trace is not None:
            trace.append(list(engine._paused))
        for req, toks in engine.retire():
            results[req.meta] = [int(t) for t in toks]
        if len(results) == n_results:
            break
    return results


@pytest.mark.parametrize("block", [1, 8])
def test_sampled_stream_same_alone_beside_others_and_after_a_pause(pair, block,
                                                                   monkeypatch):
    """Request 0 (seed 7) alone in a roomy pool; beside a greedy request
    and a sampled one of seed 3 in other slots; and second in line in a
    pool of 3 pages where it waits for the first request's pages (paused,
    then resumed in slot 0 after compaction): one stream, at blocks 1 and
    8."""
    _, port = pair
    monkeypatch.setattr(graphs, "BLOCK", block)
    audio = clips((1.5, 1.5, 1.5), seed=11)
    gen = port._generator

    def engine(n_pages=None):
        return DecodeEngine(gen, prompt_bucket=256, token_bucket=128, n_slots=4,
                            chunk_steps=4, paged=True, page_size=256, n_pages=n_pages)

    kv, lg, prompts = port.prefill_group(audio, ["English"] * 3)
    alone = engine()
    kv0 = (kv[0][:, :1], kv[1][:, :1])
    alone.admit(kv0, lg[:1], [0], _sampled_reqs(audio[:1], prompts[:1], [0], [7], 12))
    ref = _run_engine(alone, 1)[0]
    assert len(set(ref)) > 1

    beside = engine()
    order = [2, 1, 0]
    sel = torch.tensor(order)
    beside.admit((kv[0][:, sel], kv[1][:, sel]), lg[sel], [0, 1, 2],
                 _sampled_reqs([audio[i] for i in order], [prompts[i] for i in order],
                               order, [None, 3, 7], 12))
    assert _run_engine(beside, 3)[0] == ref

    tight = engine(n_pages=4)
    first, second = (1, 0)
    sel = torch.tensor([first, second])
    rejected = tight.admit((kv[0][:, sel], kv[1][:, sel]), lg[sel], [0, 1],
                           _sampled_reqs([audio[first], audio[second]],
                                         [prompts[first], prompts[second]],
                                         [first, second], [3, 7], 12))
    assert not rejected
    paused = []
    got = _run_engine(tight, 2, paused)
    assert any(p[1] for p in paused), "the second request never waited for pages"
    assert got[0] == ref


def test_sampled_request_beside_a_wider_top_k_keeps_its_stream(pair, monkeypatch):
    """A ``top_k=40`` request's stream is the same beside a ``top_k=2000``
    one that widens the chunk's candidate pool: its draws are keyed by
    vocabulary id, so its filtered set and its noise do not move."""
    _, port = pair
    monkeypatch.setattr(port._generator.runtime, "top_k_subset_buckets", (64, 512))
    audio = clips((1.5, 1.5), seed=11)
    kv, lg, prompts = port.prefill_group(audio, ["English"] * 2)
    streams = []
    for wide in (False, True):
        engine = port.make_engine(n_slots=2, max_duration=4.0, max_new_tokens=128,
                                  chunk_steps=8, paged=True)
        reqs = _sampled_reqs(audio, prompts, [0, 1], [7, 3], 16)
        reqs[1] = dataclasses.replace(reqs[1], top_k=2000 if wide else 40)
        n = 2 if wide else 1
        engine.admit((kv[0][:, :n], kv[1][:, :n]), lg[:n], [0, 1][:n], reqs[:n])
        engine.step()
        streams.append(_run_engine(engine, n)[0])
        if wide:
            assert engine.last_bucket[4] == 512
    assert streams[0] == streams[1]


@pytest.mark.parametrize("over", ["seeds", "token_index"])
def test_counter_stream_draws_match_the_jax_distribution(over):
    """20000 draws of one penalized row through ``sample_streams``: over
    20000 seeds at token index 5, or over token indices 0..19999 of seed
    11; chi squared against the exact filtered distribution (alpha 1e-3).
    ``top_p`` lies midway between two exclusive cumulative probabilities,
    so float32 and float64 keep the same tokens."""
    rng = np.random.default_rng(21)
    vocab, n = 512, 20000
    row = (2.0 * rng.standard_normal(vocab)).astype(np.float32)
    recent = [3, 17, int(np.argmax(row))]
    temp, top_k, pen = 0.8, 24, 1.3
    probs = np.sort(_plain_sample_dist(row, recent, pen, temp, 0, 1.0))[::-1]
    exclusive = np.cumsum(probs) - probs
    top_p = float(exclusive[11] + exclusive[12]) / 2
    if over == "seeds":
        seed, idx = torch.arange(n) * 7919 - 10**12, torch.full((n,), 5)
    else:
        seed, idx = torch.full((n,), 11), torch.arange(n)
    out = tsamp.sample_streams(
        torch.from_numpy(row).expand(n, vocab), torch.full((n,), temp),
        torch.full((n,), top_k), torch.full((n,), top_p), torch.full((n,), pen),
        torch.tensor(recent).expand(n, 3), 64, seed, idx)
    p = _plain_sample_dist(row, recent, pen, temp, top_k, top_p)
    assert (p > 0).sum() == 12
    _chi2_ok(out.numpy(), p)


def test_counter_uniform_limbs_and_greedy_lanes():
    """The hash runs in 32-bit limbs held in int64: every intermediate
    stays below 2**63, uniforms lie in (0, 1), distinct (seed, index, id)
    give distinct draws, and a lane at temperature 0 takes the penalized
    argmax."""
    big = torch.tensor([2**63 - 1, -(2**63), 0, -1])
    u = tsamp.counter_uniform(big, big, torch.arange(1024).expand(4, 1024))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert len({tuple(r) for r in u[:, :16].tolist()}) == 4
    x = torch.tensor([2**32 - 1])
    assert int(tsamp._mul32(x, 0xFFFFFFFF)) == (2**32 - 1) ** 2 % 2**32
    assert int(tsamp._mix32(x)) < 2**32
    logits = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    temp = torch.tensor([0.0, 1.0, 0.0])
    recent = torch.tensor([[int(logits[0].argmax())], [0], [1]])
    out = tsamp.sample_streams(logits, temp, torch.zeros(3, dtype=torch.long),
                               torch.ones(3), torch.full((3,), 2.0), recent, 64,
                               torch.arange(3), torch.zeros(3, dtype=torch.long))
    pen = tsamp.apply_repetition_penalty(logits, recent, torch.full((3,), 2.0))
    assert int(out[0]) == int(pen[0].argmax()) != int(logits[0].argmax())
    assert int(out[2]) == int(pen[2].argmax())


def test_mixed_chunk_picks_the_jax_candidate_pool(pair, monkeypatch):
    """Candidate pools of 64 and 512 (vocab 512).  In one chunk a sampled
    ``top_k=0`` lane and a sampled ``top_k=40`` lane at ``top_p`` 0.97,
    with the lm head's logits pinned to one flat row: the JAX engine picks
    one pool for the chunk from the largest live ``top_k`` (64), so the
    ``top_k=0`` lane's draws come from the top 64 candidates only.  The
    port's chunks pick the JAX engine's pool, and the lane's draws pass the
    chi-squared test against that distribution."""
    from qwen3_asr_tpu.runtime.engine import SlotRequest as JaxSlot

    jax_model, port = pair
    vocab = port._config.text_decoder.vocab_size
    row = torch.from_numpy(
        (0.3 * np.random.default_rng(12).standard_normal(vocab)).astype(np.float32))
    audio = clips((1.0,) * 8, seed=13)
    temp, top_p = 1.0, 0.97
    pools = {}
    for name, model, cls in (("jax", jax_model, JaxSlot), ("port", port, SlotRequest)):
        monkeypatch.setattr(model._generator.runtime, "top_k_subset_buckets", (64, 512))
        engine = model.make_engine(n_slots=8, max_duration=4.0, max_new_tokens=256,
                                   chunk_steps=64, paged=True)
        if name == "jax":
            real_jit = engine._step_chunk_jit

            def spy(*args, _real=real_jit, **kwargs):
                pools.setdefault(name, []).append(kwargs["k_subset"])
                return _real(*args, **kwargs)

            engine._step_chunk_jit = spy
            kv, lg, prompts = model.prefill_group(audio[:2], ["English"] * 2)
            engine.admit(kv, lg, engine.free_slots(), [
                cls(samples=a, prompt=p, max_new=3, meta=i, temperature=temp,
                    top_k=(0, 40)[i], top_p=top_p, repetition_penalty=1.0, seed=i)
                for i, (a, p) in enumerate(zip(audio, prompts))])
            engine.step()
            continue
        real = teng.decoder_logits

        def pinned(params, cfg, hidden, tp=None):
            return row.expand_as(real(params, cfg, hidden, tp=tp)).clone()

        monkeypatch.setattr(teng, "decoder_logits", pinned)
        kv, lg, prompts = model.prefill_group(audio, ["English"] * 8)
        engine.admit(kv, lg, engine.free_slots(), [
            cls(samples=a, prompt=p, max_new=256, meta=i, temperature=temp,
                top_k=40 if i in (1, 5) else 0, top_p=top_p, repetition_penalty=1.0,
                seed=50 + i)
            for i, (a, p) in enumerate(zip(audio, prompts))])
        engine.step()
        pools[name] = [engine.last_bucket[4]]
        results = _run_engine(engine, 8)
    assert pools["port"] == pools["jax"] == [64]
    draws = np.concatenate([np.asarray(results[i][1:]) for i in (0, 2, 3, 4, 6, 7)])
    _chi2_ok(draws, _plain_sample_dist(row.numpy(), [], 1.0, temp, 64, top_p))


# -- no-op iterations and static tensors ------------------------------------------------


def _chunk_tensors(engine):
    ctl = [engine._ctl_d[k] for k in sorted(engine._ctl_d)]
    cache = [t for c in (engine._keys, engine._values)
             for t in (c.values() if isinstance(c, dict) else [c])]
    return [engine._tokens, engine._counts_d, engine._done_d, engine._cur_d, engine._fwd_d,
            engine._iters_d, engine._halt_d, *ctl, *cache]


@pytest.mark.parametrize("case", ["paged_plain", "flat_spec", "paged_sampled"])
def test_iterations_after_done_change_nothing(pair, case, monkeypatch):
    _, port = pair
    monkeypatch.setattr(port._generator.runtime, "spec_engine",
                        "on" if case == "flat_spec" else "off")
    engine = port.make_engine(n_slots=4, max_duration=4.0, max_new_tokens=128,
                              chunk_steps=32, paged=case != "flat_spec")
    audio = clips((1.0, 1.7), seed=5)
    kv, lg, prompts = port.prefill_group(audio, ["English"] * 2)
    sampled = case == "paged_sampled"
    engine.admit(kv, lg, engine.free_slots(),
                 _sampled_reqs(audio, prompts, [0, 1], [4, None] if sampled else [None] * 2, 7))
    engine.step()
    assert engine._done[:2].all() and engine.stats.iterations > 0
    key = engine.last_bucket
    step = engine._chunk_step(key[0], key[1], key[3], key[4], key[2])
    state = _chunk_tensors(engine)[:7]
    before = [t.clone() for t in state]
    with torch.inference_mode():
        for _ in range(3):
            step()
    assert all(torch.equal(a, b) for a, b in zip(before, state))


def test_chunk_tensors_keep_their_pointers(pair, monkeypatch):
    """Admissions, chunks (plain, speculative and sampled), page pauses
    and resumptions, retirements and compaction update every tensor a
    chunk reads in place."""
    _, port = pair
    monkeypatch.setattr(port._generator.runtime, "spec_engine", "on")
    engine = DecodeEngine(port._generator, prompt_bucket=256, token_bucket=128, n_slots=4,
                          chunk_steps=4, paged=True, page_size=256, n_pages=5)
    ptrs = [t.data_ptr() for t in _chunk_tensors(engine)]
    audio = clips((1.0, 1.2, 0.8), seed=4)
    kv, lg, prompts = port.prefill_group(audio, ["English"] * 3)
    reqs = _sampled_reqs(audio, prompts, [0, 1, 2], [9, None, None], 6)
    assert not engine.admit(kv, lg, engine.free_slots(), reqs)
    paused, results = [], {}
    for _ in range(20):
        engine.step()
        paused.append(engine._paused.copy())
        for req, toks in engine.retire():
            results[req.meta] = toks
        assert [t.data_ptr() for t in _chunk_tensors(engine)] == ptrs
        if len(results) == 3:
            break
    assert len(results) == 3 and any(p.any() for p in paused)
    assert engine.stats.spec_chunks > 0 and engine.stats.retired == 3


# -- on the card: graphed chunks against eager chunks ----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


CUDA_ARMS = {
    "paged_plain": (True, dict(spec_engine="off"), False),
    "paged_spec": (True, dict(spec_engine="on"), False),
    "paged_int8": (True, dict(spec_engine="off", kv_cache_dtype="int8"), False),
    "flat_plain": (False, dict(spec_engine="off"), False),
    "flat_spec": (False, dict(spec_engine="on"), False),
    "paged_sampled": (True, dict(spec_engine="off"), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(CUDA_ARMS))
def test_graphed_chunks_equal_eager_chunks_on_the_card(cuda, arm):
    from torch_parity import RUNTIME, StubTokenizer, port_config

    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.ops.kernels import _build

    paged, runtime, sampled = CUDA_ARMS[arm]
    model = Qwen3ASR.from_random(port_config(), tokenizer=StubTokenizer(),
                                 runtime=RuntimeConfig(**dict(RUNTIME, **runtime)),
                                 dtype=torch.bfloat16, seed=0, device=cuda)
    audio = clips((1.0, 2.3, 5.1, 1.6), seed=3)
    out = {}
    for eager in (True, False):
        engine = model.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                                   chunk_steps=CHUNK, paged=paged, eager=eager)
        kv, lg, prompts = model.prefill_group(audio[:2], ["English"] * 2)
        metas = [0, 1]
        engine.admit(kv, lg, engine.free_slots(), _sampled_reqs(
            audio[:2], prompts, metas, [5, None] if sampled else [None] * 2, 20))
        _build.LAUNCHES.clear()
        engine.step()
        kv, lg, prompts = model.prefill_group(audio[2:], ["English"] * 2)
        engine.admit(kv, lg, engine.free_slots(), _sampled_reqs(
            audio[2:], prompts, [2, 3], [None, 8] if sampled else [None] * 2, 17))
        results = _run_engine(engine, 4)
        out[eager] = (results, _stats(engine.stats), engine.stats.iterations,
                      Counter(_build.LAUNCHES), engine)
    (r_e, s_e, it_e, l_e, eng_e), (r_g, s_g, it_g, l_g, eng_g) = out[True], out[False]
    assert r_g == r_e and s_g == s_e and it_g == it_e
    assert eng_g.graphs.captures >= 1 and eng_e.graphs is None
    extra = eng_g.stats.replays - eng_g.stats.iterations
    # Every bucket's graph launches the same kernels a step, whatever its width.
    per = {frozenset(g.launches.items()) for _, g in eng_g.graphs.entries.values()}
    assert len(per) == 1
    per = Counter(dict(per.pop()))
    assert +l_g == +(l_e + Counter({k: v * extra for k, v in per.items()}))
    for eng in (eng_e, eng_g):
        eng.close()
    model.close()
