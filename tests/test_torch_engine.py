"""The port's continuous-batching engine against the JAX package, float32 on
the CPU.

* ``decoder_paged_step`` / ``decoder_paged_verify`` (bf16-layout pools in
  float32, and int8 pools) and the flat engine's per-lane split decode match
  the JAX decoder: hidden states at atol 1e-5 + rtol 1e-5, pools at the
  same tolerance (int8 pools: every row within one quantization step, the
  scales at rtol 1e-5);
* ``DecodeEngine`` emits the JAX engine's tokens on one tiny checkpoint with
  the same counters, for flat and paged engines, bf16 and int8 caches, plain
  and speculative chunks, with a mid-decode admission; an oversubscribed
  pool pauses, resumes and force-finishes in the same chunks as the JAX
  engine;
* the JAX engine's contracts (``tests/test_engine.py``): heterogeneous
  depths, compaction and width buckets, speculative rows at a full page
  table, the speculative downgrade when the pool is tight, speculative
  gating; a sampled request gives the same tokens alone and beside other
  requests, and sampled chunks draw from the exact filtered distribution
  (chi squared, as ``tests/test_torch_sampling.py``).

The tiny model never emits a real EOS id (vocab 512), so every sequence
runs to its budget.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import clips, configs, models, numpy_params

from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.runtime import engine as teng
from qwen3_asr_tpu_torch.runtime.engine import DecodeEngine, SlotRequest

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- decoder: the paged step and verify, the per-lane split decode ------------------


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    _, dec = numpy_params(jcfg, seed=5)
    _, tdec_p = params_from_jax({}, dec)
    return jcfg.text_decoder, tcfg.text_decoder, jax.tree_util.tree_map(jnp.asarray, dec), tdec_p


def _paged_inputs(cfg, T, seed, q8):
    rng = np.random.default_rng(seed)
    PS, n_pages = 128, 12
    plen = np.array([130, 60, 200, 1], np.int32)
    dcount = np.array([5, 0, 126, 0], np.int32)
    table = np.array([[3, 7, 2, 0, 0], [5, 1, 0, 0, 0], [9, 4, 8, 6, 0], [0, 0, 0, 0, 0]],
                     np.int32)
    shape = (cfg.num_hidden_layers, n_pages, cfg.num_key_value_heads, PS, cfg.head_dim)

    def pool():
        x = rng.standard_normal(shape).astype(np.float32)
        if not q8:
            return x
        from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

        qd = quantize_kv(_t(x))
        return {"q": qd["q"].numpy(), "s": qd["s"].numpy()}

    rows = dcount[:, None] + np.arange(T)[None, :]
    pp = -(-plen // PS)
    pages = table[np.arange(4)[:, None], np.minimum(pp[:, None] + rows // PS, 4)]
    pages[3] = 0
    return dict(
        x=rng.standard_normal((4, T, cfg.hidden_size)).astype(np.float32),
        pos=((plen + dcount)[:, None] + np.arange(T)[None, :]).astype(np.int32),
        keys=pool(), values=pool(), table=table, plen=plen, dcount=dcount,
        pages=pages.astype(np.int32), offs=(rows % PS).astype(np.int32),
    )


def _to(tree, fn):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _pools_close(out, ref, q8):
    if not q8:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        return
    rq, rs = np.asarray(ref["q"]), np.asarray(ref["s"])
    np.testing.assert_allclose(out["s"].numpy(), rs, rtol=1e-5, atol=0)
    diff = np.abs(out["q"].numpy().astype(np.int32) - rq.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_paged_decoder_matches_jax(tiny, T, q8):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod

    jc, tc, jdec, tdec_p = tiny
    d = _paged_inputs(jc, T, seed=T + 10 * q8, q8=q8)
    jfn = jdec_mod.decoder_paged_step if T == 1 else jdec_mod.decoder_paged_verify
    tfn = tdec.decoder_paged_step if T == 1 else tdec.decoder_paged_verify
    pages, offs = (d["pages"][:, 0], d["offs"][:, 0]) if T == 1 else (d["pages"], d["offs"])
    ref_h, (ref_k, ref_v) = jfn(
        jdec, jc, jnp.asarray(d["x"]), jnp.asarray(d["pos"]),
        (_to(d["keys"], jnp.asarray), _to(d["values"], jnp.asarray)), jnp.asarray(d["table"]),
        jnp.asarray(d["plen"]), jnp.asarray(d["dcount"]), jnp.asarray(pages), jnp.asarray(offs),
    )
    for params in (tdec_p, tdec.fuse_decoder_params(tdec_p)):
        kv = (_to(d["keys"], lambda a: _t(a.copy())), _to(d["values"], lambda a: _t(a.copy())))
        h, (k, v) = tfn(params, tc, _t(d["x"]), _t(d["pos"]).long(), kv, _t(d["table"]),
                        _t(d["plen"]), _t(d["dcount"]), _t(pages), _t(offs))
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
        for got, ref in ((k, ref_k), (v, ref_v)):
            if q8:
                got = {"q": got["q"][:, 1:], "s": got["s"][:, 1:]}
                ref = {"q": np.asarray(ref["q"])[:, 1:], "s": np.asarray(ref["s"])[:, 1:]}
            else:
                got, ref = got[:, 1:], np.asarray(ref)[:, 1:]
            _pools_close(got, ref, q8)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_flat_per_lane_split_decode_matches_jax(tiny, q8):
    """The flat engine's step: per-lane write slots and decode ends (JAX
    ``engine.py:446-451``)."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod
    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jq

    jc, tc, jdec, tdec_p = tiny
    rng = np.random.default_rng(40 + q8)
    B, pb, S = 3, 128, 256
    shape = (jc.num_hidden_layers, B, jc.num_key_value_heads, S, jc.head_dim)
    keys = rng.standard_normal(shape).astype(np.float32)
    values = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, jc.hidden_size)).astype(np.float32)
    plen = np.array([100, 128, 5], np.int32)
    ws = (pb + np.array([0, 17, 100])).astype(np.int32)
    pos = (plen + ws - pb)[:, None].astype(np.int32)
    jkv = (jnp.asarray(keys), jnp.asarray(values))
    if q8:
        jkv = (jq(jkv[0]), jq(jkv[1]))
    ref_h, (ref_k, ref_v) = jdec_mod.decoder_forward(
        jdec, jc, jnp.asarray(x), jnp.asarray(pos), jkv, write_slots=jnp.asarray(ws),
        uniform_write=False, decode_ctx=(jnp.asarray(plen), jnp.asarray(ws), pb),
    )
    kv = tuple(
        {"q": _t(np.asarray(c["q"]).copy()), "s": _t(np.asarray(c["s"]).copy())} if q8
        else _t(np.asarray(c).copy()) for c in jkv
    )
    h, (k, v) = tdec.decoder_forward(tdec_p, tc, _t(x), _t(pos).long(), kv,
                                     write_slots=_t(ws), decode_ctx=(_t(plen), _t(ws), pb))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    _pools_close(k, ref_k, q8)
    _pools_close(v, ref_v, q8)


# -- the engine against the JAX engine ------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return models(seed=0, runtime=dict(token_buckets=(16, 128, 256)))


def _reqs(prompts, budgets, audio, cls, **kw):
    return [cls(samples=c, prompt=p, max_new=b, meta=i, **kw)
            for i, (c, p, b) in enumerate(zip(audio, prompts, budgets))]


def _drive(model, engine, cls, audio, budgets, first=2, max_chunks=80):
    """Admit clips[:first], one chunk, then the rest mid-decode; run to the
    end.  Returns ({meta: tokens}, per-chunk [(counts, done)])."""
    kv, lg, prompts = model.prefill_group(audio[:first], ["English"] * first)
    engine.admit(kv, lg, engine.free_slots(), _reqs(prompts, budgets[:first], audio, cls))
    engine.step()
    trace = [(list(engine._counts), list(engine._done))]
    if len(audio) > first:
        kv, lg, prompts = model.prefill_group(audio[first:], ["English"] * (len(audio) - first))
        rest = _reqs(prompts, budgets[first:], audio[first:], cls)
        for j, r in enumerate(rest):
            r.meta = first + j
        engine.admit(kv, lg, engine.free_slots(), rest)
    results = {}
    for _ in range(max_chunks):
        if len(results) == len(audio):
            break
        engine.step()
        trace.append((list(engine._counts), list(engine._done)))
        for req, toks in engine.retire():
            results[req.meta] = [int(t) for t in toks]
    return results, trace


def _stats(st):
    return (st.admitted, st.retired, st.chunks, st.steps, st.mid_decode_admissions,
            st.occupancy_sum, st.spec_chunks, st.spec_lane_steps, st.spec_lane_tokens)


@pytest.mark.parametrize("paged,kv,spec", [
    (False, "bf16", "off"), (False, "bf16", "on"), (False, "int8", "on"),
    (True, "bf16", "off"), (True, "bf16", "on"), (True, "int8", "on"),
])
def test_engine_token_identical_to_jax(pair, paged, kv, spec):
    """Flat and paged engines, both caches, plain and speculative chunks, a
    mid-decode admission: the JAX engine's tokens, chunk by chunk, and its
    counters.  (The flat int8 engine never speculates.)"""
    from qwen3_asr_tpu.runtime.engine import SlotRequest as JaxSlot

    jax_model, port = pair
    audio = clips((1.0, 2.3, 5.1), seed=3)
    budgets = [9, 14, 6]
    out = {}
    for name, model, cls in (("jax", jax_model, JaxSlot), ("port", port, SlotRequest)):
        rt = model._generator.runtime
        saved = (rt.spec_engine, rt.kv_cache_dtype)
        rt.spec_engine, rt.kv_cache_dtype = spec, kv
        try:
            engine = model.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                                       chunk_steps=4, paged=paged)
            out[name] = (*_drive(model, engine, cls, audio, budgets), _stats(engine.stats))
        finally:
            rt.spec_engine, rt.kv_cache_dtype = saved
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    assert out["port"][2][4] == 1                      # one mid-decode admission
    assert (out["port"][2][6] > 0) == (spec == "on" and (paged or kv == "bf16"))


def _oversubscribed(model, cls, engine_cls, clip_list, budget, spec, **engine_kw):
    """The JAX test's loop (tests/test_engine.py:199-246): one request
    prefilled per round, deferred ones retried; per-chunk (counts, done,
    paused) trace, tokens and counters."""
    rt = model._generator.runtime
    saved = rt.spec_engine
    rt.spec_engine = spec
    try:
        engine = engine_cls(model._generator, **engine_kw)
        pending = list(range(len(clip_list)))
        results, deferred, trace = {}, [], []
        for _ in range(200):
            if pending or deferred:
                reqs = deferred
                deferred = []
                if pending:
                    i = pending.pop(0)
                    _, _, prompts = model.prefill_group([clip_list[i]], ["English"])
                    reqs = reqs + [cls(samples=clip_list[i], prompt=prompts[0],
                                       max_new=budget, meta=i)]
                if reqs:
                    kv, lg, _ = model.prefill_group([r.samples for r in reqs],
                                                    ["English"] * len(reqs))
                    deferred = engine.admit(kv, lg, engine.free_slots(), reqs)
            engine.step()
            trace.append((list(engine._counts), list(engine._done), list(engine._paused)))
            for req, toks in engine.retire():
                results[req.meta] = [int(t) for t in toks]
            if len(results) == len(clip_list) and not pending and not deferred:
                break
        return results, trace, _stats(engine.stats)
    finally:
        rt.spec_engine = saved


@pytest.mark.parametrize("spec", ["off", "on"])
def test_oversubscribed_pool_pauses_as_jax(pair, spec):
    """3 pages + trash for 4 requests of one prompt page and one decode page
    each: admissions defer, slots pause and resume through retirements, in
    the same chunks as the JAX engine (plain and speculative)."""
    from qwen3_asr_tpu.runtime.engine import DecodeEngine as JaxEngine
    from qwen3_asr_tpu.runtime.engine import SlotRequest as JaxSlot

    jax_model, port = pair
    audio = clips((1.0, 1.2, 0.8, 1.1), seed=4)
    kw = dict(prompt_bucket=256, token_bucket=128, n_slots=4, chunk_steps=8, paged=True,
              page_size=256, n_pages=4)
    ref = _oversubscribed(jax_model, JaxSlot, JaxEngine, audio, 6, spec, **kw)
    got = _oversubscribed(port, SlotRequest, DecodeEngine, audio, 6, spec, **kw)
    assert got == ref
    assert any(any(p) for _, _, p in got[1]) or got[2][1] == 4


def test_force_finish_and_spec_downgrade_as_jax(pair):
    """One free decode page for two slots under spec planning (JAX
    tests/test_engine.py:598): the chunk downgrades to plain-sized planning,
    each slot emits at least a page of tokens, and the deepest is
    force-finished when the pool runs dry -- at the JAX engine's chunk."""
    from qwen3_asr_tpu.runtime.engine import DecodeEngine as JaxEngine
    from qwen3_asr_tpu.runtime.engine import SlotRequest as JaxSlot

    jax_model, port = pair
    audio = clips((1.0, 0.7), seed=6)
    out = {}
    for name, model, cls, eng in (("jax", jax_model, JaxSlot, JaxEngine),
                                  ("port", port, SlotRequest, DecodeEngine)):
        rt = model._generator.runtime
        saved = rt.spec_engine
        rt.spec_engine = "on"
        try:
            engine = eng(model._generator, prompt_bucket=256, token_bucket=256, n_slots=2,
                         chunk_steps=128, paged=True, page_size=128, n_pages=6)
            kv, lg, prompts = model.prefill_group(audio, ["English"] * 2)
            engine.admit(kv, lg, engine.free_slots(), _reqs(prompts, [256, 256], audio, cls))
            results, trace = {}, []
            for _ in range(60):
                engine.step()
                trace.append((list(engine._counts), list(engine._done), list(engine._paused)))
                for req, toks in engine.retire():
                    results[req.meta] = [int(t) for t in toks]
                if len(results) == 2:
                    break
            out[name] = (results, trace, _stats(engine.stats))
        finally:
            rt.spec_engine = saved
    assert out["port"] == out["jax"]
    lens = [len(t) for t in out["port"][0].values()]
    assert min(lens) >= 128 and max(lens) >= 128


# -- the JAX engine's contracts, on the port ------------------------------------------


def _run(engine, results_n, max_chunks=80):
    results = {}
    for _ in range(max_chunks):
        engine.step()
        for req, toks in engine.retire():
            results[req.meta] = toks
        if len(results) == results_n:
            break
    return results


def _direct_ids(port, clip_list, budgets):
    return [port.transcribe_batch([c], max_tokens=b)[0].text for c, b in zip(clip_list, budgets)]


def test_heterogeneous_depths_and_compaction(pair):
    """Slots admitted at different times decode at their own depths; the
    middle slot retires first, live slots are compacted into a prefix, and
    the narrowed decode continues with the direct tokens (JAX
    tests/test_engine.py:70, :343)."""
    _, port = pair
    audio = clips((1.0, 2.0, 0.5), seed=8)
    budgets = [10, 3, 12]
    direct = _direct_ids(port, audio, budgets)
    engine = port.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                              chunk_steps=2, paged=True)
    kv, lg, prompts = port.prefill_group(audio[:2], ["English"] * 2)
    engine.admit(kv, lg, engine.free_slots(), _reqs(prompts, budgets[:2], audio, SlotRequest))
    engine.step()
    kv, lg, prompts = port.prefill_group(audio[2:], ["English"])
    engine.admit(kv, lg, engine.free_slots(),
                 [SlotRequest(samples=audio[2], prompt=prompts[0], max_new=12, meta=2)])
    assert engine.stats.mid_decode_admissions == 1
    results, compacted = {}, False
    for _ in range(30):
        engine.step()
        for req, toks in engine.retire():
            results[req.meta] = toks
        if 1 in results and engine.n_active() == 2:
            assert list(engine._live) == [True, True, False, False]
            compacted = True
        if len(results) == 3:
            break
    assert compacted
    assert [port._finalize_output(results[i], "English")[0] for i in range(3)] == direct
    assert len(engine._free_pages) == engine.n_pages - 1


def test_spec_rows_at_a_full_table_land_on_the_trash_page(pair, monkeypatch):
    """With the page table exactly full (prompt_bucket = token_bucket =
    page_size), verify rows past the last page go to page 0, never onto the
    slot's last real page (JAX tests/test_engine.py:531): garbage drafts
    force rejections, the slot's first decode row is never rewritten, and
    the stream equals the plain one."""
    from qwen3_asr_tpu_torch.ops import speculative as spec_mod

    _, port = pair
    real_draft = spec_mod.ngram_draft

    def garbage_draft(tokens, counts, n=2, gamma=3):
        d, v = real_draft(tokens, counts, n=n, gamma=gamma)
        return torch.full_like(d, 499), torch.ones_like(v)

    clip = clips((1.0,), seed=9)[0]

    def run(mode, draft_fn):
        monkeypatch.setattr(spec_mod, "ngram_draft", draft_fn)
        monkeypatch.setattr(port._generator.runtime, "spec_engine", mode)
        engine = DecodeEngine(port._generator, prompt_bucket=256, token_bucket=256,
                              n_slots=2, chunk_steps=8, paged=True, page_size=256)
        kv, lg, prompts = port.prefill_group([clip], ["English"])
        engine.admit(kv, lg, [0], [SlotRequest(samples=clip, prompt=prompts[0],
                                               max_new=256, meta=0)])
        snap = toks = None
        for _ in range(80):
            engine.step()
            if snap is None and engine._counts[0] >= 100:
                dp_page = int(engine._page_table[0, 1])
                assert dp_page != 0
                snap = engine._keys[:, dp_page, :, 0].clone()
            got = engine.retire()
            if got:
                toks = got[0][1]
                break
        assert toks is not None and snap is not None
        return toks, snap, engine._keys[:, dp_page, :, 0]

    plain, _, _ = run("off", real_draft)
    spec, snap, after = run("on", garbage_draft)
    assert len(plain) > 200
    assert torch.equal(snap, after)
    assert spec == plain


def test_spec_gating(pair, monkeypatch):
    """"auto" speculates on all-greedy chunks of narrow flat bf16 engines
    and of paged engines within their own ceiling; never on sampled chunks,
    the flat int8 cache or a verify wider than K7's query rows (JAX
    tests/test_engine.py:717)."""
    _, port = pair
    rt = port._generator.runtime
    monkeypatch.setattr(rt, "spec_engine", "auto")
    eng = port.make_engine(n_slots=4, max_duration=4.0, max_new_tokens=64)
    assert eng._plan_chunk_spec(True) == (rt.spec_gamma, rt.spec_ngram)
    assert eng._plan_chunk_spec(False) is None
    monkeypatch.setattr(rt, "spec_engine_max_slots", 2)
    assert eng._plan_chunk_spec(True) is None
    monkeypatch.setattr(rt, "spec_engine", "on")
    assert eng._plan_chunk_spec(True) == (rt.spec_gamma, rt.spec_ngram)
    monkeypatch.setattr(rt, "spec_engine", "off")
    assert eng._plan_chunk_spec(True) is None
    paged = port.make_engine(n_slots=4, max_duration=4.0, max_new_tokens=64, paged=True)
    monkeypatch.setattr(rt, "spec_engine", "on")
    assert paged._plan_chunk_spec(True) == (rt.spec_gamma, rt.spec_ngram)
    monkeypatch.setattr(rt, "spec_gamma", 4)            # 5 x group 2 > 8 query rows
    assert paged._plan_chunk_spec(True) is None
    monkeypatch.setattr(rt, "spec_gamma", 3)
    monkeypatch.setattr(rt, "spec_engine", "auto")
    paged16 = port.make_engine(n_slots=16, max_duration=4.0, max_new_tokens=64, paged=True)
    assert paged16._plan_chunk_spec(True) == (rt.spec_gamma, rt.spec_ngram)
    monkeypatch.setattr(rt, "spec_engine_max_slots_paged", 8)
    assert paged16._plan_chunk_spec(True) is None
    monkeypatch.setattr(rt, "kv_cache_dtype", "int8")
    assert port.make_engine(n_slots=4, max_duration=4.0,
                            max_new_tokens=64)._plan_chunk_spec(True) is None
    paged8 = port.make_engine(n_slots=4, max_duration=4.0, max_new_tokens=64, paged=True)
    assert paged8._plan_chunk_spec(True) == (rt.spec_gamma, rt.spec_ngram)


def test_make_engine_sizes_the_pool_as_jax(pair):
    """Page-pool sizing (row bytes 2 * D bf16, D + 4 int8, capped at every
    slot's worst case) and buckets equal the JAX package's."""
    jax_model, port = pair
    for kv in ("bf16", "int8"):
        for budget in (0.001, 0.01, 6.0):
            got = []
            for model in (jax_model, port):
                rt = model._generator.runtime
                saved = rt.kv_cache_dtype
                rt.kv_cache_dtype = kv
                try:
                    e = model.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                                          paged=True, page_size=128, kv_pool_gb=budget)
                finally:
                    rt.kv_cache_dtype = saved
                got.append((e.prompt_bucket, e.token_bucket, e.max_pages, e.n_pages))
            assert got[0] == got[1]
    with pytest.raises(ValueError, match="page_size"):
        port.make_engine(n_slots=2, max_duration=4.0, max_new_tokens=128, paged=True,
                         page_size=384)


# -- sampled chunks ------------------------------------------------------------------


def test_sampled_request_same_alone_and_beside_others(pair):
    """A sampled request's stream depends on its own seed only: alone, or
    admitted beside a greedy and another sampled request in another slot."""
    _, port = pair
    audio = clips((1.5, 1.5, 1.5), seed=11)
    kw = dict(temperature=0.9, top_k=40, top_p=0.95, repetition_penalty=1.1)

    def run(idx, slots):
        engine = port.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                                  chunk_steps=4, paged=True)
        group = [audio[i] for i in idx]
        kv, lg, prompts = port.prefill_group(group, ["English"] * len(group))
        reqs = []
        for i, p in zip(idx, prompts):
            extra = dict(kw, seed=7) if i == 0 else (
                dict(kw, seed=3) if i == 1 else {})
            reqs.append(SlotRequest(samples=audio[i], prompt=p, max_new=20, meta=i, **extra))
        engine.admit(kv, lg, slots, reqs)
        return _run(engine, len(idx))[0]

    alone = run([0], [0])
    beside = run([2, 1, 0], [0, 1, 2])
    assert alone == beside
    assert len(set(alone)) > 1


def test_sampled_chunks_draw_from_the_filtered_distribution(pair, monkeypatch):
    """With the lm head's logits pinned to one row, every sampled token past
    the first is a draw from the filtered distribution of that row (no
    repetition penalty): chi squared over 8 slots' streams, alpha 1e-3; a
    greedy slot in the same chunks keeps the argmax."""
    from scipy.stats import chi2
    from test_torch_sampling import _plain_sample_dist

    _, port = pair
    vocab = port._config.text_decoder.vocab_size
    row = torch.from_numpy(np.random.default_rng(12).standard_normal(vocab).astype(np.float32))
    real = teng.decoder_logits

    def pinned(params, cfg, hidden, tp=None):
        out = real(params, cfg, hidden, tp=tp)
        return row.expand_as(out).clone()

    monkeypatch.setattr(teng, "decoder_logits", pinned)
    temp, top_k, top_p = 0.8, 20, 0.9
    engine = port.make_engine(n_slots=8, max_duration=8.0, max_new_tokens=256,
                              chunk_steps=64, paged=True)
    audio = clips((1.0,) * 8, seed=13)
    kv, lg, prompts = port.prefill_group(audio, ["English"] * 8)
    reqs = [SlotRequest(samples=a, prompt=p, max_new=256, meta=i,
                        temperature=0.0 if i == 7 else temp, top_k=top_k, top_p=top_p,
                        repetition_penalty=1.0, seed=100 + i)
            for i, (a, p) in enumerate(zip(audio, prompts))]
    engine.admit(kv, lg, engine.free_slots(), reqs)
    results = _run(engine, 8)
    greedy = results.pop(7)
    assert set(greedy[1:]) == {int(row.argmax())}
    draws = np.concatenate([np.asarray(t[1:]) for t in results.values()])
    p = _plain_sample_dist(row.numpy(), [], 1.0, temp, top_k, top_p)
    counts = np.bincount(draws, minlength=vocab).astype(np.float64)
    support = p > 0
    assert counts[~support].sum() == 0
    expected = len(draws) * p[support]
    stat = ((counts[support] - expected) ** 2 / expected).sum()
    assert stat < chi2.ppf(1 - 1e-3, int(support.sum()) - 1)
