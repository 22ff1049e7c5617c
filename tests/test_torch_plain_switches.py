"""The plain-path switches of the PyTorch port, on the CPU:
``QWEN3_ASR_DECODE_KERNEL=0`` (``models/decoder.py:DECODE_KERNEL_MODE``) and
``QWEN3_ASR_KV_WRITER=xla`` (``KV_WRITER_MODE``).  The tests set the module
globals, as the other mode tests do; the environment variables are read at
import.

* Token identity with the JAX package on the tiny float32 model, whose CPU
  run always takes its XLA forms, so its default is the reference: greedy
  ``transcribe_batch`` through the plain loop, the default speculative loop
  and the int8 cache under "0", under the "xla" writer and under both;
  the int8 cache under modes "3"/"4" too (K4 with its fused store, where
  the JAX package dequantizes for its XLA attention); the flat and paged
  continuous engines, bf16 and int8, plain and speculative chunks, with a
  mid-decode admission, their tokens chunk by chunk and their counters.
* A spy on the decoder's wrappers: under "0" no K2/K4 wrapper runs (the
  plain attention does) and the standalone K3 / K3-int8 writes after the
  layer loop, while the int8 cache under "3"/"4" keeps K4 and its store;
  under "xla" K2/K4/K6/K7 run without a write target and no standalone
  writer or K5 runs, the plain writers do.
* The plain writers never wait for the device: against a loop over the
  rows at random slots, pages and offsets, rows outside the cache or page
  included, and a rows' place whose written value no dropped row changes.
* The cache end: the "xla" writer of a shared slot clamps its start into
  the cache as JAX's ``dynamic_update_slice`` does (at S - 1 and past it,
  bf16-layout and int8 caches, an int slot and a B == 1 tensor), and
  per-lane slots past S are dropped as JAX's scatter drops them; one
  decoder step against the JAX decoder at those slots.
* Unknown values of either switch raise ValueError; the decode graphs'
  bucket key carries the decode mode and the KV writer.

Tests marked ``cuda`` check on the card that "0" and "xla" capture their
decode loops as CUDA graphs (the plain attention and the standalone
writers, or K2 and the plain writers), that the plain writers give the
same cache in a graph as eagerly, and that a step that waits for the
device inside a capture raises; they skip without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_engine import _drive, _pools_close, _stats
from test_torch_kv_fused import Spy, _split_step, _verify_pass
from torch_parity import clips, configs, ids_of, models, numpy_params

from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv
from qwen3_asr_tpu_torch.runtime.engine import SlotRequest

#: (decode mode, writer) of each switched run; "auto"/"auto" is the default.
SWITCHES = {"0": ("0", "auto"), "xla": ("auto", "xla"), "0+xla": ("0", "xla")}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _switch(monkeypatch, mode: str, writer: str) -> None:
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    monkeypatch.setattr(tdec, "KV_WRITER_MODE", writer)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: its tiny steps are a few
    microseconds of work each, and beside the other test workers more
    threads only wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- token identity with the JAX package ----------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return models(seed=0, runtime=dict(token_buckets=(16, 128, 256)))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's results, one per configuration, made on first use."""
    return {}


def _with_runtime(model, **changes):
    """Set ``changes`` on the model's runtime; returns the old values."""
    rt = model._generator.runtime
    saved = {k: getattr(rt, k) for k in changes}
    for k, v in changes.items():
        setattr(rt, k, v)
    return saved


def _transcribe(model, runtime: dict):
    saved = _with_runtime(model, **runtime)
    try:
        return ids_of(model.transcribe_batch(clips((1.0, 2.3, 5.1), seed=1), max_tokens=12))
    finally:
        _with_runtime(model, **saved)


LOOPS = {
    "plain": dict(speculative="off"),
    "speculative": dict(speculative="auto"),
    "int8 cache": dict(speculative="off", kv_cache_dtype="int8"),
}
TRANSCRIBE_CASES = [(loop, sw) for loop in LOOPS for sw in SWITCHES] + [
    ("int8 cache", "3"), ("int8 cache", "4")]


@pytest.mark.parametrize("loop,switch", TRANSCRIBE_CASES)
def test_transcribe_batch_token_identical(pair, jax_refs, monkeypatch, loop, switch):
    jax_model, port = pair
    if loop not in jax_refs:
        jax_refs[loop] = _transcribe(jax_model, LOOPS[loop])
    _switch(monkeypatch, *SWITCHES.get(switch, (switch, "auto")))
    out = _transcribe(port, LOOPS[loop])
    assert out == jax_refs[loop]
    assert len({t for seq in out for t in seq}) > 3


ENGINES = {
    "flat bf16": (False, "bf16", "off"),
    "flat bf16 spec": (False, "bf16", "on"),
    "flat int8": (False, "int8", "off"),
    "paged bf16 spec": (True, "bf16", "on"),
    "paged int8": (True, "int8", "off"),
}


def _engine_run(model, cls, paged, kv, spec):
    saved = _with_runtime(model, spec_engine=spec, kv_cache_dtype=kv)
    try:
        engine = model.make_engine(n_slots=4, max_duration=8.0, max_new_tokens=128,
                                   chunk_steps=4, paged=paged)
        return (*_drive(model, engine, cls, clips((1.0, 2.3, 5.1), seed=3), [9, 14, 6]),
                _stats(engine.stats))
    finally:
        _with_runtime(model, **saved)


@pytest.mark.parametrize("switch", ["0", "xla"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_token_identical(pair, jax_refs, monkeypatch, engine, switch):
    """The engines' chunks take the decoder's dispatch: under "0" the flat
    engine's step runs the plain attention and K3 (the paged one keeps
    K6/K7), under "xla" every engine writes with the plain writers."""
    from qwen3_asr_tpu.runtime.engine import SlotRequest as JaxSlot

    jax_model, port = pair
    key = ("engine", engine)
    if key not in jax_refs:
        jax_refs[key] = _engine_run(jax_model, JaxSlot, *ENGINES[engine])
    _switch(monkeypatch, *SWITCHES[switch])
    out = _engine_run(port, SlotRequest, *ENGINES[engine])
    assert out == jax_refs[key]
    assert out[2][4] == 1                               # one mid-decode admission


# -- which wrappers a step calls ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    _, dec = numpy_params(jcfg, seed=7)
    _, tdec_p = params_from_jax({}, dec)
    return jcfg.text_decoder, tcfg.text_decoder, jax.tree_util.tree_map(jnp.asarray, dec), tdec_p


PLAINS = ("decode_attention_plain", "decode_attention_q8_plain", "kv_write_rows_plain",
          "kv_write_span_pair_plain", "kv_write_rows_paged_plain",
          "kv_write_rows_paged_q8_plain")


class PlainSpy(Spy):
    """:class:`~test_torch_kv_fused.Spy`, and the plain attention and
    writers the decoder calls (``plain``)."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        self.plain = []
        for name in PLAINS:
            monkeypatch.setattr(tdec, name, self._plain(name, getattr(tdec, name)))

    def _plain(self, name, real):
        def call(*a, **k):
            self.plain.append(name)
            return real(*a, **k)
        return call


@pytest.mark.parametrize("slots", ["shared", "per_lane"])
@pytest.mark.parametrize("mode,q8", [("0", False), ("0", True), ("3", True), ("4", True)],
                         ids=["0-f32", "0-int8", "3-int8", "4-int8"])
def test_plain_attention_and_standalone_writer(tiny, monkeypatch, mode, q8, slots):
    """Under "0" no K2/K4 wrapper runs: the plain attention does, and the
    standalone K3 (K3-int8) writes K and V after the layer loop.  The int8
    cache under "3"/"4" keeps K4 with its fused store and runs nothing
    plain.  (A bf16-layout cache under "3"/"4" runs K11a/K11b or K2:
    tests/test_torch_decode_modes.py.)"""
    _, tc, _, params = tiny
    _switch(monkeypatch, mode, "auto")
    spy = PlainSpy(monkeypatch)
    ws = 132 if slots == "shared" else _t(np.array([130, 140, 200], np.int32))
    _split_step(tc, params, np.random.default_rng(3), q8, ws)
    if mode != "0":
        assert spy.attention == [("decode_attention_q8", True)] * tc.num_hidden_layers
        assert spy.plain == [] and spy.writes == []
        return
    attention = "decode_attention_q8_plain" if q8 else "decode_attention_plain"
    assert spy.attention == []
    assert spy.plain == [attention] * tc.num_hidden_layers
    writer = ("kv_write_rows_q8" if q8 else
              "kv_write_rows" if slots == "shared" else "kv_write_rows_batch")
    assert spy.writes == [writer, writer]


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("slots", ["shared", "per_lane"])
@pytest.mark.parametrize("mode", ["auto", "0"])
def test_xla_writer_stores_nothing_in_a_kernel(tiny, monkeypatch, mode, slots, q8):
    """Under "xla" K2/K4 run without a write target (none at all under
    "0"), no standalone writer runs, and the rows land through the JAX
    package's XLA writer after the layer loop."""
    _, tc, _, params = tiny
    _switch(monkeypatch, mode, "xla")
    spy = PlainSpy(monkeypatch)
    xla = []
    real = tdec._write_rows_xla
    monkeypatch.setattr(tdec, "_write_rows_xla", lambda *a: xla.append(a[2]) or real(*a))
    ws = 132 if slots == "shared" else _t(np.array([130, 140, 200], np.int32))
    _split_step(tc, params, np.random.default_rng(3), q8, ws)
    kernel = "decode_attention_q8" if q8 else "decode_attention"
    want = [] if mode == "0" else [(kernel, False)] * tc.num_hidden_layers
    assert spy.attention == want
    assert spy.writes == []
    assert len(xla) == 2 and all(s is ws for s in xla)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_xla_writer_paged(tiny, monkeypatch, T, q8):
    """The paged step and verify under "xla" (and decode mode "0", which
    they ignore): K6/K7 without a write target, then the plain paged writer
    once for K and once for V; the hidden state and pools equal the default
    path's."""
    from test_torch_engine import _paged_inputs

    jc, tc, _, params = tiny
    d = _paged_inputs(jc, T, seed=T + 20 * q8, q8=q8)
    fn = tdec.decoder_paged_step if T == 1 else tdec.decoder_paged_verify
    pages, offs = (d["pages"][:, 0], d["offs"][:, 0]) if T == 1 else (d["pages"], d["offs"])

    def run():
        kv = tuple({k: _t(v).clone() for k, v in c.items()} if q8 else _t(c).clone()
                   for c in (d["keys"], d["values"]))
        return fn(params, tc, _t(d["x"]), _t(d["pos"]).long(), kv, _t(d["table"]),
                  _t(d["plen"]), _t(d["dcount"]), _t(pages), _t(offs))

    ref_h, ref_kv = run()
    _switch(monkeypatch, "0", "xla")
    spy = PlainSpy(monkeypatch)
    h, kv = run()
    name = "decode_attention_paged" + ("" if T == 1 else "_verify") + ("_q8" if q8 else "")
    assert spy.attention == [(name, False)] * tc.num_hidden_layers
    assert spy.writes == []
    writer = "kv_write_rows_paged_q8_plain" if q8 else "kv_write_rows_paged_plain"
    assert spy.plain.count(writer) == 2
    assert torch.equal(h, ref_h)
    for got, want in zip(kv, ref_kv):
        for part in ("q", "s") if q8 else (None,):
            a, b = (got, want) if part is None else (got[part], want[part])
            # Rows landing on one trash-page slot may keep either value.
            assert torch.equal(a[:, 1:], b[:, 1:])


def test_xla_writer_verify_split(tiny, monkeypatch):
    """The verify split writes its span with the plain pair writer, not K5,
    under "xla"; the result equals the K5 path's."""
    _, tc, _, params = tiny
    ref = _verify_pass(tc, params, np.random.default_rng(6))
    _switch(monkeypatch, "0", "xla")
    spy = PlainSpy(monkeypatch)
    got = _verify_pass(tc, params, np.random.default_rng(6))
    assert spy.writes == []
    assert spy.plain == ["kv_write_span_pair_plain"]
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))


def test_unknown_switch_values_raise(tiny, monkeypatch):
    _, tc, _, params = tiny
    for mode, writer, match in (("1", "auto", "QWEN3_ASR_DECODE_KERNEL='1'"),
                                ("auto", "pallas", "QWEN3_ASR_KV_WRITER='pallas'")):
        _switch(monkeypatch, mode, writer)
        with pytest.raises(ValueError, match=match):
            _split_step(tc, params, np.random.default_rng(3), False, 132)


# -- the cache end: JAX's clamped slice update ----------------------------------------


def _jax_write(cache, rows, slots, uniform):
    """The JAX decoder's XLA writer (``decoder.py:698-726``) on numpy
    arrays: ``dynamic_update_slice`` at ``slots[0]`` when ``uniform``, else
    the scatter (out-of-range rows dropped)."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jq

    def dense(c, r, tail):
        c, r = jnp.asarray(c), jnp.asarray(r)
        if uniform:
            return np.asarray(jax.lax.dynamic_update_slice(c, r, (0, 0, 0, int(slots[0])) + tail))
        b = jnp.arange(c.shape[1])
        moved = jnp.moveaxis(r[:, :, :, 0], 1, 0)
        return np.asarray(c.at[:, b, :, jnp.asarray(slots)].set(moved))

    if isinstance(cache, dict):
        qr = jq(jnp.asarray(rows))
        return {"q": dense(cache["q"], qr["q"], (0,)), "s": dense(cache["s"], qr["s"], ())}
    return dense(cache, rows, (0,))


#: (slot form, slot): JAX's scatter wraps a negative per-lane slot, which no
#: caller passes, so per-lane slots go only past the end.
END_CASES = [(form, slot) for form in ("int", "B=1 tensor") for slot in ("S-1", "S", "S+5", "-2")
             ] + [("per-lane", slot) for slot in ("S-1", "S", "S+5")]


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("form,slot", END_CASES)
def test_xla_writer_at_the_cache_end_matches_jax(q8, form, slot):
    """A shared slot (an int, or the one lane's at B == 1) lands where
    ``dynamic_update_slice`` puts it, its start clamped into [0, S - 1];
    per-lane slots outside [0, S) are dropped, as JAX's scatter drops them."""
    rng = np.random.default_rng(31)
    L, H, S, D = 2, 2, 16, 128
    B = 1 if form == "B=1 tensor" else 3
    s = {"S-1": S - 1, "S": S, "S+5": S + 5, "-2": -2}[slot]
    slots = np.full((B,), s, np.int32)
    if form == "per-lane":
        slots[1] = 4                                     # one lane inside the cache
    cache = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
    rows = rng.standard_normal((L, B, H, 1, D)).astype(np.float32)
    if q8:
        qc = quantize_kv(_t(cache))
        cache = {"q": qc["q"].numpy(), "s": qc["s"].numpy()}
    ref = _jax_write(cache, rows, slots, uniform=form != "per-lane")
    port_cache = ({k: _t(v).clone() for k, v in cache.items()} if q8 else _t(cache).clone())
    port_slots = int(s) if form == "int" else _t(slots)
    tdec._write_rows_xla(port_cache, _t(rows), port_slots)
    _pools_close(port_cache, ref, q8)
    if not q8:
        np.testing.assert_array_equal(port_cache.numpy(), ref)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("slot", ["S-1", "S+3"])
def test_xla_step_at_the_cache_end_matches_jax(tiny, monkeypatch, q8, slot):
    """One split step of the tiny float32 decoder under "xla" with a
    shared slot at S - 1 and past S, against the JAX decoder
    (``uniform_write=True``): the same hidden state, tokens and cache."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod
    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jq

    jc, tc, jdec, tdec_p = tiny
    rng = np.random.default_rng(60 + q8)
    B, pb, S = 3, 128, 256
    ws = {"S-1": S - 1, "S+3": S + 3}[slot]
    shape = (jc.num_hidden_layers, B, jc.num_key_value_heads, S, jc.head_dim)
    keys = rng.standard_normal(shape).astype(np.float32)
    values = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, jc.hidden_size)).astype(np.float32)
    plen = np.array([100, 128, 5], np.int32)
    pos = (plen + S - 1 - pb)[:, None].astype(np.int32)
    jkv = (jnp.asarray(keys), jnp.asarray(values))
    if q8:
        jkv = (jq(jkv[0]), jq(jkv[1]))
    ref_h, (ref_k, ref_v) = jdec_mod.decoder_forward(
        jdec, jc, jnp.asarray(x), jnp.asarray(pos), jkv,
        write_slots=jnp.full((B,), ws, jnp.int32), uniform_write=True,
        decode_ctx=(jnp.asarray(plen), jnp.int32(S), pb),
    )
    kv = tuple(
        {"q": _t(np.asarray(c["q"]).copy()), "s": _t(np.asarray(c["s"]).copy())} if q8
        else _t(np.asarray(c).copy()) for c in jkv
    )
    _switch(monkeypatch, "auto", "xla")
    h, (k, v) = tdec.decoder_forward(tdec_p, tc, _t(x), _t(pos).long(), kv, write_slots=ws,
                                     decode_ctx=(_t(plen), S, pb))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        tdec.decoder_logits(tdec_p, tc, h).argmax(-1).numpy(),
        np.asarray(jdec_mod.decoder_logits(jdec, jc, ref_h)).argmax(-1))
    _pools_close(k, ref_k, q8)
    _pools_close(v, ref_v, q8)


def test_plain_loop_slots_stay_inside_the_cache(pair, monkeypatch):
    """The plain loop's shared slot is ``min(pb + step, S - 1)``: a decode
    of a whole 16-token bucket passes no slot past S - 1 to the writer, so
    the default writers' dropping and JAX's clamp never differ on its
    path."""
    _, port = pair
    _switch(monkeypatch, "auto", "xla")
    seen = []
    real = tdec._write_rows_xla

    def spy(cache, rows, slots):
        seen.append(int(slots.max()) - (cache["q"] if isinstance(cache, dict) else cache).shape[3])
        return real(cache, rows, slots)

    monkeypatch.setattr(tdec, "_write_rows_xla", spy)
    saved = _with_runtime(port, speculative="off")
    try:
        port.transcribe_batch(clips((1.0,), seed=2), max_tokens=16)
    finally:
        _with_runtime(port, **saved)
    assert seen and max(seen) <= -1


def test_bucket_key_carries_the_decode_mode(pair, monkeypatch):
    """The decode graphs' key ends with the decode mode and the KV writer,
    so a graph captured under one switch never replays under another."""
    _, port = pair
    saved = _with_runtime(port, speculative="off")
    keys = []
    try:
        for switch in (("auto", "auto"), ("0", "auto"), ("auto", "xla")):
            _switch(monkeypatch, *switch)
            port.transcribe_batch(clips((1.0,), seed=2), max_tokens=4)
            keys.append(port._generator.last_bucket)
    finally:
        _with_runtime(port, **saved)
    assert [k[-2:] for k in keys] == [("auto", "auto"), ("0", "auto"), ("auto", "xla")]
    assert keys[0][:-2] == keys[1][:-2] == keys[2][:-2]


# -- the plain writers without a device sync -----------------------------------------


def _loop_span(cache, rows, slots):
    """Row t of lane b at ``slots[b] + t`` where that lies in [0, S)."""
    out = cache.clone()
    for b, start in enumerate(slots.tolist()):
        for t in range(rows.shape[3]):
            if 0 <= start + t < cache.shape[3]:
                out[:, b, :, start + t] = rows[:, b, :, t]
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("T", [1, 4])
def test_plain_span_writer_matches_a_loop(seed, T):
    """``kv_write_span_batch_plain`` (and ``kv_write_rows_plain`` at T = 1)
    equals the loop at slots before, inside, across and past the cache:
    a dropped row clamped onto a row that lands changes nothing."""
    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    rng = np.random.default_rng(70 + seed)
    L, B, H, S, D = 2, 5, 2, 8, 16
    cache = _t(rng.standard_normal((L, B, H, S, D)).astype(np.float32))
    rows = _t(rng.standard_normal((L, B, H, T, D)).astype(np.float32))
    slots = _t(np.array([S - 2, -2, S, 3, rng.integers(-6, S + 3)], np.int32))
    want = _loop_span(cache, rows, slots)
    writer = kw.kv_write_rows_plain if T == 1 else kw.kv_write_span_batch_plain
    assert torch.equal(writer(cache.clone(), rows, slots), want)


@pytest.mark.parametrize("seed", range(4))
def test_plain_paged_writer_matches_a_loop(seed):
    """``kv_write_rows_paged_plain`` equals the loop (pages clipped, rows at
    offsets outside the page dropped) with dropped rows among kept ones,
    and with every row dropped; distinct kept places, so no two kept rows
    race."""
    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    rng = np.random.default_rng(80 + seed)
    L, B, H, T, P, PS, D = 2, 3, 2, 2, 7, 4, 16
    rows = _t(rng.standard_normal((L, B, H, T, D)).astype(np.float32))
    pool = _t(rng.standard_normal((L, P, H, PS, D)).astype(np.float32))
    place = rng.permutation(P * PS)[: B * T].reshape(B, T)
    pages, offsets = place // PS, place % PS
    pages[0, 0] = P + 3                                   # clipped onto the last page
    offsets[1] = (-1, PS)                                 # lane 1 dropped
    if seed == 3:
        offsets[:] = PS + 2                               # every row dropped
    want = pool.clone()
    for b in range(B):
        for t in range(T):
            if 0 <= offsets[b, t] < PS:
                want[:, min(pages[b, t], P - 1), :, offsets[b, t]] = rows[:, b, :, t]
    got = kw.kv_write_rows_paged_plain(pool.clone(), rows, _t(pages.astype(np.int32)),
                                       _t(offsets.astype(np.int32)))
    assert torch.equal(got, want)


# -- on the card: what each switch captures ----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["0", "xla"])
def test_cuda_switch_capture_decision(monkeypatch, switch):
    """Tiny bf16 decoder on the card: each switch captures its own plain
    loop graph (one capture more, one look at ``done`` a block of steps):
    under "0" K2 never launches and K3 twice a step, under "xla" K2 a layer
    a step and no standalone or fused store; both give the default loop's
    tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch_parity import StubTokenizer, port_config

    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.runtime import graphs

    rt = RuntimeConfig(frame_buckets=(800, 1600, 3200), token_buckets=(16, 256),
                       speculative="off")
    model = Qwen3ASR.from_random(port_config(), tokenizer=StubTokenizer(), runtime=rt,
                                 dtype=torch.bfloat16, seed=3, device="cuda")
    audio = clips((1.0, 2.3), seed=1)
    ref = ids_of(model.transcribe_batch(audio, max_tokens=12))
    _switch(monkeypatch, *SWITCHES[switch])
    captures = model._generator.graphs.captures
    first = ids_of(model.transcribe_batch(audio, max_tokens=12))   # the switch captures here
    LAUNCHES.clear()
    out = ids_of(model.transcribe_batch(audio, max_tokens=12))
    st = model.last_stats
    got = dict(LAUNCHES)
    n_layers = port_config().text_decoder.num_hidden_layers
    assert model._generator.graphs.captures == captures + 1
    assert st.n_host_syncs == st.n_decode_replays // graphs.BLOCK    # one block ahead
    assert got.get("decode_attention", 0) == (
        0 if switch == "0" else n_layers * st.n_decode_replays)
    assert not any(got.get(n, 0) for n in ("kv_write_rows_fused", "kv_write_span_batch"))
    assert got.get("kv_write_rows", 0) == (2 * st.n_decode_replays if switch == "0" else 0)
    assert out == first == ref
    model.close()


@pytest.mark.cuda
def test_cuda_plain_writers_capture():
    """The plain writers wait for nothing on the device: a CUDA graph holds
    them, and its replay leaves the cache and the pool the eager calls
    leave, rows outside the cache and page dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    gen = torch.Generator(device="cuda").manual_seed(5)
    cache = torch.randn((2, 3, 2, 16, 128), generator=gen, device="cuda").bfloat16()
    rows = torch.randn((2, 3, 2, 4, 128), generator=gen, device="cuda").bfloat16()
    slots = torch.tensor([1, 14, 20], dtype=torch.int32, device="cuda")
    pool = torch.randn((2, 6, 2, 4, 128), generator=gen, device="cuda").bfloat16()
    pages = torch.tensor([[1, 2], [3, 3], [9, 4]], dtype=torch.int32, device="cuda")
    offs = torch.tensor([[0, 1], [2, 4], [3, -1]], dtype=torch.int32, device="cuda")
    want = (kw.kv_write_span_batch_plain(cache.clone(), rows, slots),
            kw.kv_write_rows_paged_plain(pool.clone(), rows[:, :, :, :2], pages, offs))
    got = (cache.clone(), pool.clone())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kw.kv_write_span_batch_plain(got[0], rows, slots)
        kw.kv_write_rows_paged_plain(got[1], rows[:, :, :, :2].contiguous(), pages, offs)
    got[0].copy_(cache)
    got[1].copy_(pool)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_sync_inside_capture_raises(monkeypatch):
    """A decode step that waits for the device inside the capture raises
    out of ``transcribe_batch``: the loop does not turn eager for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from torch_parity import StubTokenizer, port_config

    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig

    rt = RuntimeConfig(frame_buckets=(800, 1600, 3200), token_buckets=(16, 256),
                       speculative="off")
    model = Qwen3ASR.from_random(port_config(), tokenizer=StubTokenizer(), runtime=rt,
                                 dtype=torch.bfloat16, seed=3, device="cuda")
    real = tdec._write_rows_xla

    def waits(cache, rows, slots):
        if isinstance(slots, torch.Tensor):
            int(slots.max())                              # a host sync
        return real(cache, rows, slots)

    _switch(monkeypatch, "auto", "xla")
    monkeypatch.setattr(tdec, "_write_rows_xla", waits)
    with pytest.raises(RuntimeError):
        model.transcribe_batch(clips((1.0,), seed=1), max_tokens=12)
    model.close()
