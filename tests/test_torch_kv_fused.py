"""The fresh rows' store fused into the decode attention (K3 into K2/K4, K8
into K6/K7), on the CPU.

* Each fused wrapper's plain version is the plain attention over the
  pre-step cache or pool followed by the plain writer on the layer's slice:
  bf16-layout and int8 caches, an int shared slot, (B,) per-lane slots,
  slots outside [0, S) dropped, and the clamp case (every lane's decode end
  at S, the write slot S - 1 inside [prompt_bucket, S), so the attention
  must read the row the store replaces); the paged pair at T = 1 and 4 over
  bf16-layout and int8 pools, idle lanes on the trash page 0, offsets out
  of range.  The references index the cache with numpy-made targets, not
  through the writers.
* A spy on the decoder: under decode mode "auto" and on the int8 cache the
  split step and the paged step and verify pass a write target to the
  attention and call no standalone writer; under "3"/"4" the step calls
  ``kv_write_rows`` after the layer loop.  The speculative verify calls
  K5's two-cache ``kv_write_span_pair`` once, and there and under "3"/"4"
  each layer's projection writes its K and V rows straight into the
  buffers the writer reads: no copy of the projected rows follows (an
  ``aten.copy_`` log); ``_project_qkv`` into those buffers gives the same
  bits as without them, f32 and bf16.
* One decode step of the tiny float32 model in the clamp case, against the
  JAX decoder (as ``tests/test_torch_engine.py`` runs it): the same
  greedy tokens and the same cache.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import configs, numpy_params

from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
from qwen3_asr_tpu_torch.ops.kernels import decode_attention_paged as dap
from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw
from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

TOL = dict(atol=1e-5, rtol=1e-5)
D = 128


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _clone(c):
    return {k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone()


def _cache(rng, shape, q8):
    x = _t(rng.standard_normal(shape).astype(np.float32))
    return quantize_kv(x) if q8 else x.bfloat16()


def _equal(a, b):
    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in ("q", "s"))
    return torch.equal(a, b)


def _store(cache, index, rows):
    """cache[index] = rows (bf16 rows; int8 caches quantize them first)."""
    if isinstance(cache, dict):
        qr = quantize_kv(rows)
        cache["q"][index] = qr["q"]
        cache["s"][index] = qr["s"]
    else:
        cache[index] = rows


# -- the contiguous cache: K2/K4 with write_slots -------------------------------------

SLOT_CASES = ("shared", "per_lane", "out_of_range", "clamp")


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", SLOT_CASES)
def test_decode_fused_plain_is_attention_then_write(case, q8):
    rng = np.random.default_rng(SLOT_CASES.index(case) + 10 * q8)
    L, B, hq, hkv, pb, S, layer = 3, 4, 4, 2, 32, 48, 1
    kall, vall = (_cache(rng, (L, B, hkv, S, D), q8) for _ in range(2))
    q = _t(rng.standard_normal((B, hq, D)).astype(np.float32)).bfloat16()
    k_new, v_new = (_t(rng.standard_normal((B, hkv, 1, D)).astype(np.float32)).bfloat16()
                    for _ in range(2))
    k_new[1, 0] = 0                              # an all-zero row: scale 1 on int8
    plen = _t(np.array([5, 32, 0, 17], np.int32))
    dend = _t(np.array([40, 33, 32, 48], np.int32))
    slots = {"shared": 41, "per_lane": _t(np.array([40, 33, 32, 47], np.int32)),
             "out_of_range": _t(np.array([-1, 33, 48, 100], np.int32)), "clamp": S - 1}[case]
    if case == "clamp":
        dend = torch.full((B,), S, dtype=torch.int32)
    fn = da.decode_attention_q8 if q8 else da.decode_attention
    plain = da.decode_attention_q8_plain if q8 else da.decode_attention_plain

    ref = plain(q, _clone(kall), _clone(vall), k_new, v_new, layer, plen, dend, pb, D ** -0.5)
    ref_k, ref_v = _clone(kall), _clone(vall)
    lane_slots = np.broadcast_to(np.asarray(slots), (B,))
    for b, s in enumerate(lane_slots):
        if 0 <= s < S:
            _store(ref_k, (layer, b, slice(None), int(s)), k_new[b, :, 0])
            _store(ref_v, (layer, b, slice(None), int(s)), v_new[b, :, 0])

    orig_k, orig_v = _clone(kall), _clone(vall)
    out = fn(q, kall, vall, k_new, v_new, layer, plen, dend, pb, write_slots=slots)
    assert torch.equal(out, ref)
    assert _equal(kall, ref_k) and _equal(vall, ref_v)
    if case == "clamp":              # the store replaced rows that the attention read
        rows = (lambda c: c["q"][layer, :, :, S - 1]) if q8 else (lambda c: c[layer, :, :, S - 1])
        assert not torch.equal(rows(kall), rows(orig_k))
    # The same call without a write target leaves the cache as it is.
    kc, vc = _clone(orig_k), _clone(orig_v)
    assert torch.equal(fn(q, kc, vc, k_new, v_new, layer, plen, dend, pb), ref)
    assert _equal(kc, orig_k) and _equal(vc, orig_v)


def test_write_slots_are_checked():
    q = torch.zeros(2, 4, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        da.write_slot_tensor(torch.zeros(2, dtype=torch.int64), 2, q.device)
    with pytest.raises(ValueError, match="int32"):
        da.write_slot_tensor(torch.zeros(3, dtype=torch.int32), 2, q.device)
    assert da.write_slot_tensor(7, 2, q.device).tolist() == [7, 7]


# -- the paged pool: K6/K7 with write_pages / write_offsets ------------------------------


def _paged_case(rng, T, q8):
    L, B, hq, hkv, PS, n_pages, layer = 2, 5, 4, 2, 32, 14, 1
    kpool, vpool = (_cache(rng, (L, n_pages, hkv, PS, D), q8) for _ in range(2))
    q = _t(rng.standard_normal((B, hq, T, D)).astype(np.float32)).bfloat16()
    k_new, v_new = (_t(rng.standard_normal((B, hkv, T, D)).astype(np.float32)).bfloat16()
                    for _ in range(2))
    table = np.array([[3, 7, 2, 0], [5, 1, 0, 0], [9, 4, 8, 6], [0, 0, 0, 0], [0, 0, 0, 0]],
                     np.int32)
    plen = np.array([40, 20, 64, 0, 0], np.int32)
    dcount = np.array([5, 12, 31, 0, 0], np.int32)           # lanes 3, 4 idle
    pp = -(-plen // PS)
    rows = dcount[:, None] + np.arange(T)[None, :]
    pages = table[np.arange(B)[:, None], np.minimum(pp[:, None] + rows // PS, 3)]
    offs = (rows % PS).astype(np.int32)
    offs[1, -1] = PS + 3                                     # dropped
    pages[0, -1] = 40                                        # clipped to the last page
    return dict(L=L, B=B, PS=PS, layer=layer, kpool=kpool, vpool=vpool, q=q, k_new=k_new,
                v_new=v_new, table=_t(table), plen=_t(plen), dcount=_t(dcount),
                pages=pages.astype(np.int32), offs=offs, n_pages=n_pages)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_paged_fused_plain_is_attention_then_write(T, q8):
    c = _paged_case(np.random.default_rng(T + 10 * q8), T, q8)
    if T == 1:
        fn = dap.decode_attention_paged_q8 if q8 else dap.decode_attention_paged
    else:
        fn = dap.decode_attention_paged_verify_q8 if q8 else dap.decode_attention_paged_verify
    plain = dap.paged_attention_q8_plain if q8 else dap.paged_attention_plain
    layer, PS = c["layer"], c["PS"]
    args = (c["table"], c["plen"], c["dcount"])
    ref = plain(c["q"], _clone(c["kpool"]), _clone(c["vpool"]), c["k_new"], c["v_new"], layer,
                *args, D ** -0.5)
    ref_k, ref_v = _clone(c["kpool"]), _clone(c["vpool"])
    for b in range(c["B"]):
        for t in range(T):
            off = int(c["offs"][b, t])
            if 0 <= off < PS:
                page = min(max(int(c["pages"][b, t]), 0), c["n_pages"] - 1)
                _store(ref_k, (layer, page, slice(None), off), c["k_new"][b, :, t])
                _store(ref_v, (layer, page, slice(None), off), c["v_new"][b, :, t])

    pages, offs = _t(c["pages"]), _t(c["offs"])
    if T == 1:
        out = fn(c["q"][:, :, 0], c["kpool"], c["vpool"], c["k_new"], c["v_new"], layer, *args,
                 write_pages=pages[:, 0].contiguous(), write_offsets=offs[:, 0].contiguous())
        ref = ref[:, :, 0]
    else:
        out = fn(c["q"], c["kpool"], c["vpool"], c["k_new"], c["v_new"], layer, *args,
                 write_pages=pages, write_offsets=offs)
    assert torch.equal(out, ref)
    # Outside the trash page 0, where the idle lanes' stores race.
    for got, want in ((c["kpool"], ref_k), (c["vpool"], ref_v)):
        if q8:
            assert all(torch.equal(got[k][:, 1:], want[k][:, 1:]) for k in ("q", "s"))
        else:
            assert torch.equal(got[:, 1:], want[:, 1:])


def test_write_target_is_checked():
    pages = torch.zeros(3, 4, dtype=torch.int32)
    assert dap.write_target(None, None, 3, 4, pages.device) is None
    with pytest.raises(ValueError, match="int32"):
        dap.write_target(pages, None, 3, 4, pages.device)
    with pytest.raises(ValueError, match="int32"):
        dap.write_target(pages, pages.long(), 3, 4, pages.device)
    with pytest.raises(ValueError, match="int32"):
        dap.write_target(pages, pages, 3, 2, pages.device)
    got = dap.write_target(pages[:, 0].contiguous(), pages[:, 0].contiguous(), 3, 1,
                           pages.device)
    assert [tuple(t.shape) for t in got] == [(3, 1), (3, 1)]


# -- the decoder: which kernels a step calls ----------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    _, dec = numpy_params(jcfg, seed=7)
    _, tdec_p = params_from_jax({}, dec)
    return jcfg.text_decoder, tcfg.text_decoder, jax.tree_util.tree_map(jnp.asarray, dec), tdec_p


WRITERS = ("kv_write_rows", "kv_write_rows_batch", "kv_write_rows_q8", "kv_write_rows_paged",
           "kv_write_rows_paged_q8", "kv_write_span_pair")


class Spy:
    """Wraps the decoder's attention wrappers (recording the write target
    each call passed) and every standalone writer (recording its calls)."""

    ATTENTION = ("decode_attention", "decode_attention_q8", "decode_attention_paged",
                 "decode_attention_paged_q8", "decode_attention_paged_verify",
                 "decode_attention_paged_verify_q8")

    def __init__(self, monkeypatch):
        self.attention, self.writes, self.write_args = [], [], []
        for name in self.ATTENTION:
            real = getattr(tdec, name)
            monkeypatch.setattr(tdec, name, self._attend(name, real))
        for name in WRITERS:
            wrapped = self._write(name, getattr(kw, name))
            monkeypatch.setattr(kw, name, wrapped)
            if hasattr(tdec, name):
                monkeypatch.setattr(tdec, name, wrapped)

    def _attend(self, name, real):
        def call(*a, **k):
            target = k.get("write_slots", k.get("write_pages"))
            self.attention.append((name, target is not None))
            return real(*a, **k)
        return call

    def _write(self, name, real):
        def call(*a, **k):
            self.writes.append(name)
            self.write_args.append(a)
            return real(*a, **k)
        return call


def _split_step(tc, params, rng, q8, slots, B=3, pb=128, S=256):
    shape = (tc.num_hidden_layers, B, tc.num_key_value_heads, S, tc.head_dim)
    kv = tuple(quantize_kv(c) if q8 else c
               for c in (_t(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)))
    x = _t(rng.standard_normal((B, 1, tc.hidden_size)).astype(np.float32))
    plen = _t(np.array([100, 128, 5], np.int32))
    dend = slots if isinstance(slots, torch.Tensor) else pb + 4
    pos = (plen.long() + 4)[:, None]
    return tdec.decoder_forward(params, tc, x, pos, kv, write_slots=slots,
                                decode_ctx=(plen, dend, pb))


@pytest.mark.parametrize("q8,slots", [(False, "shared"), (False, "per_lane"),
                                      (True, "shared"), (True, "per_lane")])
def test_split_step_stores_from_the_attention(tiny, monkeypatch, q8, slots):
    _, tc, _, params = tiny
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", "auto")
    spy = Spy(monkeypatch)
    ws = 132 if slots == "shared" else _t(np.array([130, 140, 200], np.int32))
    _split_step(tc, params, np.random.default_rng(3), q8, ws)
    want = "decode_attention_q8" if q8 else "decode_attention"
    assert spy.attention == [(want, True)] * tc.num_hidden_layers
    assert spy.writes == []


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_paged_forward_stores_from_the_attention(tiny, monkeypatch, T, q8):
    from test_torch_engine import _paged_inputs

    jc, tc, _, params = tiny
    spy = Spy(monkeypatch)
    d = _paged_inputs(jc, T, seed=T + 20 * q8, q8=q8)
    fn = tdec.decoder_paged_step if T == 1 else tdec.decoder_paged_verify
    pages, offs = (d["pages"][:, 0], d["offs"][:, 0]) if T == 1 else (d["pages"], d["offs"])
    kv = tuple({k: _t(v) for k, v in c.items()} if q8 else _t(c)
               for c in (d["keys"], d["values"]))
    fn(params, tc, _t(d["x"]), _t(d["pos"]).long(), kv, _t(d["table"]), _t(d["plen"]),
       _t(d["dcount"]), _t(pages), _t(offs))
    name = "decode_attention_paged" + ("" if T == 1 else "_verify") + ("_q8" if q8 else "")
    assert spy.attention == [(name, True)] * tc.num_hidden_layers
    assert spy.writes == []


@pytest.mark.parametrize("mode", ["3", "4"])
def test_stream_modes_keep_the_standalone_writer(tiny, monkeypatch, mode):
    _, tc, _, params = tiny
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    spy = Spy(monkeypatch)
    _split_step(tc, params, np.random.default_rng(4), False, 132)
    assert spy.attention == []
    assert spy.writes == ["kv_write_rows", "kv_write_rows"]


class CopySources(TorchDispatchMode):
    """Records the source pointer of every ``aten.copy_`` while active."""

    def __init__(self):
        super().__init__()
        self.sources = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.copy_.default:
            self.sources.append(args[1].data_ptr())
        return func(*args, **(kwargs or {}))


def _verify_pass(tc, params, rng, B=3, T=4, pb=128, S=160):
    shape = (tc.num_hidden_layers, B, tc.num_key_value_heads, S, tc.head_dim)
    kv = tuple(_t(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    x = _t(rng.standard_normal((B, T, tc.hidden_size)).astype(np.float32))
    plen = _t(np.array([100, 128, 5], np.int32))
    ws = _t(np.array([pb + 3, pb + 19, S - 2], np.int32))   # lane 2 overflows S
    pos = (plen.long() + 3)[:, None] + torch.arange(T)[None, :]
    return tdec.decoder_forward(params, tc, x, pos, kv, write_slots=ws,
                                decode_ctx=(plen, ws, pb))


@pytest.mark.parametrize("path", ["verify", "3", "4"])
def test_rows_land_in_the_writer_buffers_from_the_projection(tiny, monkeypatch, path):
    """One K5 launch a verify pass (two K3 calls a mode "3"/"4" step), each
    layer's projected K and V rows already in the buffers those writers read,
    and no copy of them into a staging buffer."""
    _, tc, _, params = tiny
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", "auto" if path == "verify" else path)
    spy = Spy(monkeypatch)
    projected = []
    real = tdec._project_qkv

    def project(*a, **k):
        q, k_new, v_new = real(*a, **k)
        projected.append((k_new, v_new))
        return q, k_new, v_new

    monkeypatch.setattr(tdec, "_project_qkv", project)
    with CopySources() as log:
        if path == "verify":
            _verify_pass(tc, params, np.random.default_rng(6))
        else:
            _split_step(tc, params, np.random.default_rng(6), False, 132)
    if path == "verify":
        assert spy.writes == ["kv_write_span_pair"]
        k_rows, v_rows = spy.write_args[0][2:4]
    else:
        assert spy.writes == ["kv_write_rows", "kv_write_rows"]
        k_rows, v_rows = (a[1] for a in spy.write_args)
    assert len(projected) == tc.num_hidden_layers
    for layer, (k_new, v_new) in enumerate(projected):
        assert k_new.data_ptr() == k_rows[layer].data_ptr()
        assert v_new.data_ptr() == v_rows[layer].data_ptr()
    rows = {t.data_ptr() for pair in projected for t in pair}
    assert not rows & set(log.sources)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_project_qkv_into_buffers_is_bit_identical(tiny, dtype):
    from qwen3_asr_tpu_torch.ops.rope import rope_cos_sin

    _, tc, _, params = tiny
    lp = {k: v.to(dtype) for k, v in params["layers"][1].items()}
    rng = np.random.default_rng(8)
    B, T, nkv = 3, 4, tc.num_key_value_heads
    h = _t(rng.standard_normal((B, T, tc.hidden_size)).astype(np.float32)).to(dtype)
    pos = torch.arange(T)[None, :] + torch.tensor([[5], [40], [77]])
    cos, sin = rope_cos_sin(pos[:, None, :], tc.head_dim, tc.rope_theta)
    q, k, v = tdec._project_qkv(h, lp, tc, cos, sin)
    bufs = [torch.full((2, B, nkv, T, tc.head_dim), float("nan"), dtype=dtype) for _ in range(2)]
    q2, k2, v2 = tdec._project_qkv(h, lp, tc, cos, sin, bufs[0][1], bufs[1][1])
    assert k2.data_ptr() == bufs[0][1].data_ptr() and v2.data_ptr() == bufs[1][1].data_ptr()
    assert k2.dtype == dtype and v2.dtype == dtype
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a, b)
    assert torch.isnan(bufs[0][0]).all() and torch.isnan(bufs[1][0]).all()


# -- the clamp case against the JAX decoder -------------------------------------------------


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
def test_clamp_step_matches_jax(tiny, q8):
    """The plain loop's last slot: write slot S - 1, decode end S; the
    fresh row replaces a row that the same layer's attention reads."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod
    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jq
    from test_torch_engine import _pools_close

    jc, tc, jdec, tdec_p = tiny
    rng = np.random.default_rng(50 + q8)
    B, pb, S = 3, 128, 256
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
        write_slots=jnp.full((B,), S - 1, jnp.int32), uniform_write=True,
        decode_ctx=(jnp.asarray(plen), jnp.int32(S), pb),
    )
    ref_tok = np.asarray(jdec_mod.decoder_logits(jdec, jc, ref_h)).argmax(-1)
    kv = tuple(
        {"q": _t(np.asarray(c["q"]).copy()), "s": _t(np.asarray(c["s"]).copy())} if q8
        else _t(np.asarray(c).copy()) for c in jkv
    )
    before = _clone(kv[0])
    h, (k, v) = tdec.decoder_forward(tdec_p, tc, _t(x), _t(pos).long(), kv, write_slots=S - 1,
                                     decode_ctx=(_t(plen), S, pb))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    tok = tdec.decoder_logits(tdec_p, tc, h).argmax(-1).numpy()
    np.testing.assert_array_equal(tok, ref_tok)
    _pools_close(k, ref_k, q8)
    _pools_close(v, ref_v, q8)
    # The slot the step read held another row before it.
    old = before["q"] if q8 else before
    new = k["q"] if q8 else k
    assert not torch.equal(old[:, :, :, S - 1], new[:, :, :, S - 1])


# -- on the GPU: the fused store against the attention, then the standalone writer ---------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _layer(cache, layer):
    if isinstance(cache, dict):
        return {k: v[layer : layer + 1] for k, v in cache.items()}
    return cache[layer : layer + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", SLOT_CASES)
@pytest.mark.parametrize("B,S", [(3, 96), (8, 640)])
def test_cuda_decode_fused_matches_attention_then_writer(cuda, B, S, case, q8):
    """K2/K4 with write_slots: the output bit-identical to the call without
    them, the cache to that call followed by K3 (K3-int8) on the layer."""
    g = torch.Generator(device=cuda).manual_seed(B * S + SLOT_CASES.index(case))
    L, hq, hkv, pb, layer = 2, 16, 8, S - 64, 1

    def cache():
        x = torch.randn(L, B, hkv, S, D, generator=g, device=cuda)
        return quantize_kv(x) if q8 else x.bfloat16()

    kall, vall = cache(), cache()
    q = torch.randn(B, hq, D, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, hkv, 1, D, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, hkv, 1, D, generator=g, device=cuda).bfloat16()
    k_new[0, 1] = 0                                # an all-zero row
    plen = torch.randint(0, pb + 1, (B,), generator=g, device=cuda).int()
    dend = torch.randint(pb, S + 1, (B,), generator=g, device=cuda).int()
    if case == "clamp":
        dend.fill_(S)
    slots = {"shared": torch.full((B,), pb + 5, dtype=torch.int32, device=cuda),
             "per_lane": dend.clamp(max=S - 1),
             "out_of_range": torch.tensor([-1, S] + [pb + 1] * (B - 2), dtype=torch.int32,
                                          device=cuda),
             "clamp": torch.full((B,), S - 1, dtype=torch.int32, device=cuda)}[case]
    fn = da.decode_attention_q8 if q8 else da.decode_attention
    write = kw.kv_write_rows_q8 if q8 else kw.kv_write_rows_batch
    ref_k, ref_v = _clone(kall), _clone(vall)
    ref = fn(q, ref_k, ref_v, k_new, v_new, layer, plen, dend, pb)
    write(_layer(ref_k, layer), k_new[None], slots)
    write(_layer(ref_v, layer), v_new[None], slots)
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    before = LAUNCHES[da.NAME_Q8_WRITE if q8 else da.NAME_WRITE]
    out = fn(q, kall, vall, k_new, v_new, layer, plen, dend, pb, write_slots=slots)
    torch.cuda.synchronize()
    assert LAUNCHES[da.NAME_Q8_WRITE if q8 else da.NAME_WRITE] == before + 1
    assert torch.equal(out, ref)
    assert _equal(kall, ref_k) and _equal(vall, ref_v)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_paged_fused_matches_attention_then_writer(cuda, T, q8):
    """K6/K7 with write_pages/write_offsets: the output bit-identical to the
    call without them, the pool outside the trash page 0 to that call
    followed by K8 on the layer."""
    c = _paged_case(np.random.default_rng(30 + T + q8), T, q8)
    to = lambda x: _to_cuda(x, cuda)   # noqa: E731
    kpool, vpool = to(c["kpool"]), to(c["vpool"])
    q, k_new, v_new = to(c["q"]), to(c["k_new"]), to(c["v_new"])
    args = (to(c["table"]), to(c["plen"]), to(c["dcount"]))
    pages, offs = to(_t(c["pages"])), to(_t(c["offs"]))
    layer = c["layer"]
    if T == 1:
        fn = dap.decode_attention_paged_q8 if q8 else dap.decode_attention_paged
        q = q[:, :, 0]
    else:
        fn = dap.decode_attention_paged_verify_q8 if q8 else dap.decode_attention_paged_verify
    write = kw.kv_write_rows_paged_q8 if q8 else kw.kv_write_rows_paged
    ref_k, ref_v = _clone(kpool), _clone(vpool)
    ref = fn(q, ref_k, ref_v, k_new, v_new, layer, *args)
    write(_layer(ref_k, layer), k_new[None], pages, offs)
    write(_layer(ref_v, layer), v_new[None], pages, offs)
    out = fn(q, kpool, vpool, k_new, v_new, layer, *args, write_pages=pages,
             write_offsets=offs)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for got, want in ((kpool, ref_k), (vpool, ref_v)):
        if q8:
            assert all(torch.equal(got[k][:, 1:], want[k][:, 1:]) for k in ("q", "s"))
        else:
            assert torch.equal(got[:, 1:], want[:, 1:])


def _to_cuda(x, device):
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return x.to(device)
