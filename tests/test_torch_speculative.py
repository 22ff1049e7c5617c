"""The port's speculative slice against the JAX package, float32 on the CPU.

* ``ngram_draft`` equals the JAX draft exactly (drafts and validity) on
  random, repetitive and constant token buffers, for several (n, gamma);
* K5's plain version (``kv_write_span_batch`` on CPU tensors) is bit-exact
  against the Pallas kernel in interpret mode, dropped overflow rows
  included, and so is the two-cache ``kv_write_span_pair`` against two
  calls of it (K and V) at T = 2, 4, 8;
* the verify-split ``decoder_forward`` matches the JAX verify path within
  atol 1e-5 + rtol 1e-5 (hidden states and the written cache), and matches
  T sequential split-decode steps of the port itself;
* greedy ``transcribe`` / ``transcribe_batch`` under ``"auto"`` and
  ``"ngram"`` are token-identical to the JAX package with the same
  ``n_spec_forwards``, also with int8 weights; with the int8 cache
  ``"ngram"`` runs the plain loop (no K5 call), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import clips, configs, ids_of, models, numpy_params

from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops.kernels.kv_write import kv_write_span_batch, kv_write_span_pair
from qwen3_asr_tpu_torch.ops.speculative import ngram_draft


def _t(x):
    return torch.from_numpy(np.array(x))


# -- n-gram draft -------------------------------------------------------------


def _buffers(seed: int, B: int = 6, tb: int = 48) -> list[tuple[np.ndarray, np.ndarray]]:
    """(tokens, counts) pairs: random over a small vocab (many matches),
    periodic with noise, and constant streams; counts from 0 to full."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 1, 3, 17, tb - 1, tb][:B], np.int32)
    rand = rng.integers(0, 5, (B, tb)).astype(np.int32)
    period = np.tile(np.arange(7, dtype=np.int32), tb // 7 + 1)[:tb]
    rep = np.broadcast_to(period, (B, tb)).copy()
    rep[rng.random((B, tb)) < 0.1] = 9
    const = np.full((B, tb), 4, np.int32)
    return [(rand, counts), (rep, counts), (const, counts)]


@pytest.mark.parametrize("n,gamma", [(2, 3), (3, 3), (4, 2), (3, 7)])
def test_ngram_draft_matches_jax(n, gamma):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.speculative import ngram_draft as jax_draft

    for tokens, counts in _buffers(n * 10 + gamma):
        ref_d, ref_v = jax_draft(jnp.asarray(tokens), jnp.asarray(counts), n=n, gamma=gamma)
        d, v = ngram_draft(_t(tokens), _t(counts), n=n, gamma=gamma)
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    # The constant stream predicts itself wherever history allows.
    d, v = ngram_draft(_t(_buffers(0)[2][0]), _t(np.array([n + 1 + gamma] * 6)), n=n, gamma=gamma)
    assert v.all() and d.eq(4).all()


# -- K5: span write -------------------------------------------------------------


@pytest.mark.parametrize("slots,T,pair", [
    pytest.param([0, 9, 30], 4, False, id="slots0"),
    pytest.param([61, 62, 63], 4, False, id="slots1"),
    pytest.param([60, 64, 100], 4, False, id="slots2"),
    # Both caches in one call: a lane inside, one whose span overflows S by
    # one row, one wholly past S.
    pytest.param([5, 62, 100], 2, True, id="pair-T2"),
    pytest.param([5, 61, 100], 4, True, id="pair-T4"),
    pytest.param([5, 57, 100], 8, True, id="pair-T8"),
])
def test_kv_write_span_bit_exact_vs_pallas(slots, T, pair):
    """T rows per lane, including lanes whose span runs past S = 64 (rows
    there are dropped) and a lane wholly past the end; the pair writes K and
    V as two calls of the Pallas kernel do."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.kv_write import kv_write_span_batch as pallas_span

    rng = np.random.default_rng(sum(slots) + T)
    caches = [rng.standard_normal((2, 3, 2, 64, 128)).astype(np.float32) for _ in range(2)]
    rows = [rng.standard_normal((2, 3, 2, T, 128)).astype(np.float32) for _ in range(2)]
    slots = np.array(slots, np.int32)
    refs = [np.asarray(pallas_span(jnp.asarray(c), jnp.asarray(r), jnp.asarray(slots),
                                   interpret=True)) for c, r in zip(caches, rows)]
    work = [torch.from_numpy(c.copy()) for c in caches]
    if pair:
        outs = kv_write_span_pair(*work, *map(torch.from_numpy, rows), torch.from_numpy(slots))
    else:
        outs = (kv_write_span_batch(work[0], torch.from_numpy(rows[0]),
                                    torch.from_numpy(slots)),)
    for out, w, ref, cache in zip(outs, work, refs, caches):
        assert out is w
        np.testing.assert_array_equal(out.numpy(), ref)
        written = (out.numpy() != cache).any(axis=(0, 2, 4))        # (B, S)
        for b, s in enumerate(slots):
            want = np.zeros(64, bool)
            want[s : min(s + T, 64)] = True
            np.testing.assert_array_equal(written[b], want)


def test_kv_write_span_rejects_long_spans():
    with pytest.raises(ValueError):
        kv_write_span_batch(torch.zeros(1, 1, 1, 16, 128), torch.zeros(1, 1, 1, 9, 128),
                            torch.zeros(1, dtype=torch.int32))


# -- verify split ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    _, dec = numpy_params(jcfg, seed=13)
    _, tdec_p = params_from_jax({}, dec)
    return jcfg.text_decoder, tcfg.text_decoder, jax.tree_util.tree_map(jnp.asarray, dec), tdec_p


def _cache(c, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (c.num_hidden_layers, B, c.num_key_value_heads, S, c.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_verify_split_matches_jax(tiny):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod

    jc, tc, jdec, tdec_p = tiny
    B, T, pb, S = 3, 4, 128, 160
    keys, values = _cache(jc, B, S, 21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((B, T, jc.hidden_size)).astype(np.float32)
    plen = np.array([100, 128, 5], np.int32)
    counts = np.array([4, 20, 31], np.int32)      # lane 2 spans past S: rows dropped
    ws = (pb + counts - 1).astype(np.int32)
    pos = ((plen + counts - 1)[:, None] + np.arange(T)[None, :]).astype(np.int32)
    ref_h, (ref_k, ref_v) = jdec_mod.decoder_forward(
        jdec, jc, jnp.asarray(x), jnp.asarray(pos), (jnp.asarray(keys), jnp.asarray(values)),
        write_slots=jnp.asarray(ws), uniform_write=False,
        decode_ctx=(jnp.asarray(plen), jnp.asarray(ws), pb),
    )
    for params in (tdec_p, tdec.fuse_decoder_params(tdec_p)):
        kv = (_t(keys.copy()), _t(values.copy()))
        h, (k, v) = tdec.decoder_forward(
            params, tc, _t(x), _t(pos).long(), kv,
            write_slots=_t(ws), decode_ctx=(_t(plen), _t(ws), pb),
        )
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(k.numpy(), np.asarray(ref_k), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-5, rtol=1e-5)
        logits = tdec.decoder_logits(params, tc, h)
        ref_logits = jdec_mod.decoder_logits(jdec, jc, ref_h)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5, rtol=1e-5)


def test_verify_split_matches_sequential_decode_steps(tiny):
    """One verify forward over T positions equals T single-token split
    decode steps at the same slots (a shared write slot, so the step path
    applies), hidden states and cache alike."""
    _, tc, _, tdec_p = tiny
    B, T, pb, S = 3, 4, 128, 192
    keys, values = _cache(tc, B, S, 31)
    rng = np.random.default_rng(32)
    x = _t(rng.standard_normal((B, T, tc.hidden_size)).astype(np.float32))
    plen = _t(np.array([77, 128, 9], np.int32))
    ws0 = pb + 11
    pos = (plen.long() + 11)[:, None] + torch.arange(T)[None, :]
    ws = torch.full((B,), ws0, dtype=torch.int32)
    kv = (_t(keys.copy()), _t(values.copy()))
    h, (k, v) = tdec.decoder_forward(tdec_p, tc, x, pos, kv, write_slots=ws,
                                     decode_ctx=(plen, ws, pb))
    kv_seq = (_t(keys.copy()), _t(values.copy()))
    for t in range(T):
        h_t, kv_seq = tdec.decoder_forward(
            tdec_p, tc, x[:, t : t + 1], pos[:, t : t + 1], kv_seq,
            write_slots=ws0 + t, decode_ctx=(plen, ws0 + t, pb),
        )
        np.testing.assert_allclose(h[:, t : t + 1].numpy(), h_t.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(k.numpy(), kv_seq[0].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), kv_seq[1].numpy(), atol=1e-5, rtol=1e-5)


def test_verify_split_rejects_the_int8_cache(tiny):
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv_cache

    _, tc, _, tdec_p = tiny
    kv = quantize_kv_cache(tdec.init_kv_cache(tc, 1, 16, torch.float32))
    ws = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        tdec.decoder_forward(tdec_p, tc, torch.zeros(1, 2, tc.hidden_size),
                             torch.zeros(1, 2).long(), kv, write_slots=ws,
                             decode_ctx=(torch.ones(1, dtype=torch.int32), ws, 8))


# -- the slice: speculative transcription against the JAX package ---------------------

#: Runtime settings of the speculative slice.  ``spec_auto_max_batch=2``
#: turns "auto" off at the 3-clip batch (padded to 4) while "ngram" still
#: speculates there.
SPEC_SETTINGS = {
    "auto": {},
    "auto_gated": dict(spec_auto_max_batch=2),
    "ngram": dict(speculative="ngram"),
    "ngram_w8": dict(speculative="ngram", quantization="int8"),
}


@pytest.fixture(scope="module", params=list(SPEC_SETTINGS))
def spec_pair(request):
    return request.param, models(seed=0, runtime=SPEC_SETTINGS[request.param])


def test_spec_transcribe_batch_token_identical(spec_pair):
    name, (jax_model, port) = spec_pair
    audio = clips((1.0, 2.3, 5.1), seed=1)
    ref = jax_model.transcribe_batch(audio, max_tokens=30, repetition_penalty=1.0)
    out = port.transcribe_batch(audio, max_tokens=30, repetition_penalty=1.0)
    assert ids_of(out) == ids_of(ref)
    forwards = jax_model.last_stats.n_spec_forwards
    assert port.last_stats.n_spec_forwards == forwards
    if name == "auto_gated":
        assert forwards == 0 and port.last_stats.n_decode_steps == 29
    else:
        # Repetitive tiny-model streams: the drafts are accepted often.
        assert 0 < forwards < 3 * 29
        assert port.last_stats.spec_tokens_per_forward > 1.0


def test_spec_transcribe_token_identical(spec_pair):
    _, (jax_model, port) = spec_pair
    audio = clips((3.7,), seed=2)[0]
    ref = jax_model.transcribe(audio, max_tokens=24, language="de")
    out = port.transcribe(audio, max_tokens=24, language="de")
    assert ids_of([out]) == ids_of([ref])
    assert port.last_stats.n_spec_forwards == jax_model.last_stats.n_spec_forwards > 0


def test_five_clips_pad_to_eight_and_speculate():
    """``_plan_spec`` sees the padded batch: 5 clips pad to 8 lanes, which
    "auto" still speculates on; 9 clips pad to 16 and run the plain loop."""
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    jcfg, tcfg = configs()
    gen = Generator(None, tcfg.text_decoder)
    assert gen._plan_spec("greedy", 8) == (3, 3)
    assert gen._plan_spec("greedy", 16) is None
    assert gen._plan_spec("sample", 1) is None
    from qwen3_asr_tpu_torch import RuntimeConfig

    gen.runtime = RuntimeConfig(spec_sampling=True, speculative="ngram", spec_gamma=2)
    assert gen._plan_spec("sample", 64) == (2, 3)
    gen.runtime = RuntimeConfig(speculative="off")
    assert gen._plan_spec("greedy", 1) is None


def test_int8_cache_ngram_runs_the_plain_loop(monkeypatch):
    """The int8 cache never composes with speculation: "ngram" decodes with
    the plain loop, calls no K5, and matches the JAX package."""
    jax_model, port = models(seed=0, runtime=dict(speculative="ngram", kv_cache_dtype="int8"))
    calls = []
    real = tdec.kv_write_span_pair
    monkeypatch.setattr(tdec, "kv_write_span_pair",
                        lambda *a: calls.append(1) or real(*a))
    audio = clips((1.0, 2.3), seed=5)
    ref = jax_model.transcribe_batch(audio, max_tokens=10)
    out = port.transcribe_batch(audio, max_tokens=10)
    assert ids_of(out) == ids_of(ref)
    assert not calls
    assert port.last_stats.n_spec_forwards == jax_model.last_stats.n_spec_forwards == 0
    assert port.last_stats.n_decode_steps == 9
