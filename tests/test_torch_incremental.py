"""The port's live-stream path against the JAX package, float32 on the CPU.

Per module, on the same inputs made with numpy from a seed:

* the mel frontend's raw and finalize stages (``_mel_raw``,
  ``_mel_finalize``) against the JAX package's, atol 1e-5, and
  ``log_mel_batch`` bit-identical to the one-pass composition it replaced;
* ``IncrementalSession._window_buffer`` exactly equal to the JAX session's
  (window 0 and later windows, streams of at most 200 samples, exactly 201
  samples, a tail past the end);
* the decoder's general cached forward (``write_slots``, no
  ``decode_ctx``) against JAX ``decoder_forward``: hidden and cache, atol
  1e-5, uniform and per-lane slots, slots running past S, T = 1, 16 and
  104; the int8 cache raises;
* ``Generator.advance`` logits and cache against JAX ``Generator.advance``,
  also with the slot and last index as 0-d tensors at the sessions' slots
  and the clamp edges;
* the advance's graph bucket on the CPU (its capture a stand-in that runs
  the step): one capture per (B, S, T, dtype, ...) for every session, the
  graphed advance bit-identical to the eager one, two sessions previewing
  in turns giving their solo texts.

The whole slice: previews token-identical to the JAX ``IncrementalSession``
and to the port's own ``transcribe`` at the cut points of
``tests/test_incremental.py`` and through its clamp-floor rise, in float32
and with int8 weights on the float32 cache; the refusals, ``reset``,
previews after a decode, and poisoning after a preview made to fail.

``cuda``-marked (skipped without a GPU): the advance on the card (bf16)
against the CPU float32 advance, within the smoke's reference tolerance
(5e-2 of max |logit|), a graphed preview (decode and advances) equal to an
eager one, the graphed advance bit-identical to the eager one, and two
sessions in turns giving their solo texts.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
from qwen3_asr_tpu_torch.audio import mel as tmel
from qwen3_asr_tpu_torch.incremental import PREFIX_PAD, WINDOW_SAMPLES, IncrementalSession
from qwen3_asr_tpu_torch.models.params import params_from_jax
from torch_parity import clips, configs, models, numpy_params

#: The JAX session tests' runtime (tests/test_incremental.py).
RT = dict(frame_buckets=(800, 1600, 3200), token_buckets=(32, 64))
ATOL = 1e-5
#: Weights whose greedy tokens follow the audio at the cut points below
#: (other seeds repeat one token for most prefixes).
WEIGHTS_SEED = 3
#: The session's first-token logits against the offline prefill's: float32
#: sums over the same terms in another order (one window's encoder and mel
#: products against the whole clip's, the plain attention against K1's).
LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return models(seed=WEIGHTS_SEED, runtime=RT)


@pytest.fixture(scope="module")
def pair_int8():
    return models(seed=WEIGHTS_SEED, runtime=dict(RT, quantization="int8"))


def _speech_like(seconds, seed=0, amp=0.05):
    """tests/test_incremental.py's signal."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16_000)
    t = np.arange(n) / 16_000
    sig = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (amp * (sig + 0.1 * rng.standard_normal(n))).astype(np.float32)


# -- the mel frontend's two stages ------------------------------------------


def test_mel_raw_and_finalize_match_jax():
    from qwen3_asr_tpu.audio import mel as jmel

    audio = [clips((9.0,), seed=3)[0][:128000], 1e-4 * clips((3.1,), seed=4)[0]]
    padded = tmel.host_pad_batch(audio, 800, tmel.N_FFT, tmel.HOP_LENGTH)
    raw = tmel._mel_raw(torch.from_numpy(padded))
    n_valid = np.array([800, len(audio[1]) // tmel.HOP_LENGTH])
    gmax = np.array([1.5, -3.25], np.float32)
    out = tmel._mel_finalize(raw, torch.from_numpy(n_valid), torch.from_numpy(gmax))
    for b in range(2):
        ref_raw = jmel._mel_raw(jnp.asarray(padded[b]), tmel.N_FFT, tmel.HOP_LENGTH,
                                tmel.N_MELS)
        np.testing.assert_allclose(raw[b].numpy(), np.asarray(ref_raw), atol=ATOL, rtol=0)
        ref = jmel._mel_finalize(jnp.asarray(raw[b].numpy()), jnp.int32(n_valid[b]),
                                 jnp.float32(gmax[b]))
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _log_mel_one_pass(padded, n_valid, n_frames):
    """``log_mel_batch`` as one function, before its split into stages."""
    if padded.dtype == torch.int16:
        padded = padded.to(torch.float32) * (1.0 / 32768.0)
    basis, fb = tmel._device_constants(tmel.N_FFT, tmel.N_MELS, padded.device)
    frames = padded.unfold(-1, tmel.N_FFT, tmel.HOP_LENGTH)
    spec = frames @ basis.T
    n_freqs = tmel.N_FFT // 2 + 1
    real, imag = spec[..., :n_freqs], spec[..., n_freqs:]
    power = real * real + imag * imag
    mel = (power @ fb.T).transpose(1, 2)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    frame_idx = torch.arange(n_frames, device=padded.device)
    valid = (frame_idx[None, :] < n_valid[:, None])[:, None, :]
    neg_inf = torch.tensor(float("-inf"), device=padded.device)
    global_max = torch.where(valid, log_spec, neg_inf).amax(dim=(1, 2))
    out = (torch.maximum(log_spec, global_max[:, None, None] - 8.0) + 4.0) / 4.0
    return torch.where(valid, out, torch.zeros((), device=padded.device))


@pytest.mark.parametrize("pcm", [False, True])
def test_log_mel_batch_bit_identical_to_one_pass(pcm):
    audio = clips((5.3, 1.2, 7.9), seed=5)
    if pcm:
        audio = [(a * 30000).astype(np.int16) for a in audio]
    padded = torch.from_numpy(tmel.host_pad_batch(audio, 800, tmel.N_FFT, tmel.HOP_LENGTH))
    n_valid = torch.tensor([len(a) // tmel.HOP_LENGTH for a in audio])
    assert torch.equal(tmel.log_mel_batch(padded, n_valid, 800),
                       _log_mel_one_pass(padded, n_valid, 800))


# -- the exact-context window buffer -----------------------------------------


@pytest.mark.parametrize("n,windows", [
    (176, (0,)),                                  # <= 200 samples: np.pad wraps
    (201, (0,)),                                  # tail_len == n - 1
    (5000, (0,)),                                 # the right reflect inside window 0
    (2 * WINDOW_SAMPLES + 40, (0, 1, 2)),         # later windows, a tail past the end
    (int(21.3 * 16_000), (0, 1, 2)),
])
def test_window_buffer_equals_jax(n, windows):
    from qwen3_asr_tpu.incremental import IncrementalSession as JaxSession

    state = SimpleNamespace(_samples=_speech_like(n / 16_000 + 1, seed=n)[:n])
    for w in windows:
        np.testing.assert_array_equal(IncrementalSession._window_buffer(state, w),
                                      JaxSession._window_buffer(state, w))


# -- the decoder's cached forward ------------------------------------------------


@pytest.fixture(scope="module")
def decoder_pair():
    """(JAX decoder params, port decoder params, JAX cfg, port cfg)."""
    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed=7)
    jparams = _tree(dec, jnp.asarray)
    return jparams, params_from_jax(enc, dec)[1], jcfg.text_decoder, tcfg.text_decoder


def _tree(tree, fn):
    return {k: _tree(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


#: (B, T, write slots: an int shared by every lane or per-lane slots), S = 160.
CACHED_CASES = [
    (1, 1, 20), (2, 16, 30), (2, 104, 9), (1, 104, 40),
    (2, 16, 150),                        # an int past S: the start clamps to S - T
    (2, 16, [5, 150]),                   # lane 1 runs past S: its last 6 rows drop
    (3, 1, [0, 159, 170]),               # one lane at the last slot, one past S
    (2, 104, [9, 70]),
]


@pytest.mark.parametrize("B,T,slots", CACHED_CASES)
def test_cached_forward_matches_jax(decoder_pair, B, T, slots):
    from qwen3_asr_tpu.models.decoder import decoder_forward as jax_forward

    from qwen3_asr_tpu_torch.models.decoder import decoder_forward

    jparams, tparams, jcfg, tcfg = decoder_pair
    S, H = 160, tcfg.hidden_size
    rng = np.random.default_rng(B * 1000 + T)
    shape = (tcfg.num_hidden_layers, B, tcfg.num_key_value_heads, S, tcfg.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    hidden = rng.standard_normal((B, T, H)).astype(np.float32)
    ws = np.broadcast_to(np.asarray(slots), (B,)).astype(np.int32)
    positions = (ws[:, None] + np.arange(T)[None, :]).astype(np.int32)

    uniform = isinstance(slots, int)
    ref_h, (ref_k, ref_v) = jax_forward(
        jparams, jcfg, jnp.asarray(hidden), jnp.asarray(positions),
        (jnp.asarray(kv[0]), jnp.asarray(kv[1])), write_slots=jnp.asarray(ws),
        uniform_write=uniform, attn_impl="cache",
    )
    t_slots = slots if uniform else torch.from_numpy(ws)
    out_h, (out_k, out_v) = decoder_forward(
        tparams, tcfg, torch.from_numpy(hidden), torch.from_numpy(positions).long(),
        (torch.from_numpy(kv[0].copy()), torch.from_numpy(kv[1].copy())),
        write_slots=t_slots,
    )
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_k.numpy(), np.asarray(ref_k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_v.numpy(), np.asarray(ref_v), atol=ATOL, rtol=0)


def test_cached_forward_refuses_int8_cache(decoder_pair):
    from qwen3_asr_tpu_torch.models.decoder import decoder_forward, init_kv_cache
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv_cache

    _, tparams, _, tcfg = decoder_pair
    kv = quantize_kv_cache(init_kv_cache(tcfg, 1, 64, torch.float32))
    with pytest.raises(ValueError, match="int8"):
        decoder_forward(tparams, tcfg, torch.zeros(1, 4, tcfg.hidden_size),
                        torch.arange(4)[None], kv, write_slots=9)


def test_advance_matches_jax(pair):
    """The prefix advance (16 ids at slot 0) then a window's 104 feature rows
    at slot 9, as a session makes them: logits and cache within 1e-5."""
    from qwen3_asr_tpu.models.decoder import init_kv_cache as jax_cache

    from qwen3_asr_tpu_torch.models.decoder import init_kv_cache

    jax_model, port = pair
    jgen, tgen = jax_model._generator, port._generator
    cfg = port._config.text_decoder
    rng = np.random.default_rng(11)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :9] = rng.integers(1, cfg.vocab_size, 9)
    feats = rng.standard_normal((1, 104, cfg.hidden_size)).astype(np.float32)
    jkv = jax_cache(jax_model._config.text_decoder, 1, 288, jnp.float32)
    tkv = init_kv_cache(cfg, 1, 288, torch.float32)
    for embeds, pos, slot, last in (
        ((jgen.embed_ids(ids), tgen.embed_ids(ids)), np.arange(16)[None], 0, 8),
        ((jnp.asarray(feats), torch.from_numpy(feats)), (9 + np.arange(104))[None], 9, 103),
    ):
        jkv, jlogits = jgen.advance(jkv, embeds[0], pos, slot, last)
        tkv, tlogits = tgen.advance(tkv, embeds[1], pos, slot, last)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
        for t, j in zip(tkv, jkv):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


#: (write slot, T) of the device-scalar advance, S = 288: the slots a session
#: uses (the prefix at 0, a window at 9, the suffix after a window) and the
#: clamp edges (S - T, S - T + 5 clamped to S - T, a window at 0).
ADVANCE_CASES = [(0, 16), (9, 104), (113, 16), (272, 16), (277, 16), (0, 104), (184, 104)]


@pytest.mark.parametrize("slot,T", ADVANCE_CASES)
def test_advance_device_scalars_match_jax(pair, slot, T):
    """``advance`` with the write slot and the last index as 0-d tensors
    (as its graph reads them) on a random cache, against the JAX
    ``_advance_impl`` (jitted, the slot and index traced): logits and cache
    within 1e-5, and bit-identical to the same call with ints."""
    jax_model, port = pair
    jgen, tgen = jax_model._generator, port._generator
    cfg = port._config.text_decoder
    S = 288
    rng = np.random.default_rng(slot * 7 + T)
    shape = (cfg.num_hidden_layers, 1, cfg.num_key_value_heads, S, cfg.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    feats = rng.standard_normal((1, T, cfg.hidden_size)).astype(np.float32)
    pos = (slot + np.arange(T))[None]
    last = T - 1 - (slot % 5)
    jkv, jlogits = jgen.advance((jnp.asarray(kv[0]), jnp.asarray(kv[1])), jnp.asarray(feats),
                                pos, slot, last)
    tkv, tlogits = tgen.advance(tuple(torch.from_numpy(c.copy()) for c in kv),
                                torch.from_numpy(feats), pos,
                                torch.tensor(slot, dtype=torch.int32), torch.tensor(last))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    for t, j in zip(tkv, jkv):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)
    ikv, ilogits = tgen.advance(tuple(torch.from_numpy(c.copy()) for c in kv),
                                torch.from_numpy(feats), pos, slot, last)
    assert torch.equal(ilogits, tlogits)
    assert all(torch.equal(a, b) for a, b in zip(ikv, tkv))


class _Replay:
    """A captured graph's stand-in on the CPU: a replay runs the step."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


def _cpu_capture(self, key, statics, step, generator=None, warm=True):
    """``DecodeGraphs.capture`` on the CPU: the warm-up step, then an entry
    whose replays run the step on the same buffers."""
    from collections import Counter

    from qwen3_asr_tpu_torch.runtime import graphs

    if warm:
        step()
    entry = graphs.StepGraph(_Replay(step), Counter())
    self.captures += 1
    self.entries[key] = (statics, entry)
    return entry


@pytest.fixture
def graphed_advance(pair, monkeypatch):
    """A model on the pair's weights whose ``advance`` takes its graphed
    path on CPU tensors (``_capturable`` patched true, a capture that
    replays by running the step), the decode loop kept eager."""
    from qwen3_asr_tpu_torch.runtime import graphs
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    monkeypatch.setattr(Generator, "_capturable", lambda self, device: True)
    monkeypatch.setattr(graphs.DecodeGraphs, "capture", _cpu_capture)
    real = Generator.decode
    monkeypatch.setattr(Generator, "decode",
                        lambda self, *a, **k: real(self, *a, **dict(k, eager=True)))
    port = pair[1]
    return Qwen3ASR(port._config, port._encoder_params, port._decoder_params, port._tokenizer,
                    RuntimeConfig(**RT))


def _advance_keys(gen) -> list[tuple]:
    return [k for k in gen.graphs.entries if k[0] == "advance"]


def test_advance_bucket_captured_once_across_sessions(graphed_advance):
    """The advance's bucket key is (B, S, T, cache dtype, ...): the first
    session's prefix advance captures it, a second session of the same
    bucket captures nothing, a window's T = 104 is a bucket of its own; the
    graphed advance (the arena copy in and out) is bit-identical to the
    eager one on the session's cache."""
    model = graphed_advance
    gen = model._generator
    a = model.incremental_session(max_tokens=6, language="English")
    (key,) = _advance_keys(gen)
    assert key[1:5] == (1, a._cache_len, PREFIX_PAD, torch.float32)
    assert gen.graphs.captures == 1
    b = model.incremental_session(max_tokens=6, language="English")
    assert gen.graphs.captures == 1 and _advance_keys(gen) == [key]
    assert all(torch.equal(x, y) for x, y in zip(a._kv, b._kv))
    cfg = model._config.text_decoder
    feats = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 104, cfg.hidden_size)).astype(np.float32))
    pos = (9 + np.arange(104))[None]
    with torch.inference_mode():             # as the sessions call it
        eager_kv = tuple(c.clone() for c in a._kv)
        eager_kv, eager_logits = gen.advance(eager_kv, feats, pos, 9, 103, eager=True)
        kv, logits = gen.advance(a._kv, feats, pos, 9, 103)
        assert gen.graphs.captures == 2 and len(_advance_keys(gen)) == 2
        assert torch.equal(logits, eager_logits)
        assert all(torch.equal(x, y) for x, y in zip(kv, eager_kv))
        assert kv[0] is a._kv[0]              # the session's own cache, updated in place
        gen.advance(b._kv, feats, pos, 9, 103)
    assert gen.graphs.captures == 2
    assert all(torch.equal(x, y) for x, y in zip(a._kv, b._kv))



def test_interleaved_sessions_give_their_solo_texts(graphed_advance):
    """Two sessions on one model share the advance's buckets and arena:
    previews taken in turns give each session's texts alone (and the
    offline transcript of each prefix)."""
    model = graphed_advance
    kw = dict(max_tokens=6, language="English")
    streams = (_speech_like(12.0, seed=21), _speech_like(10.0, seed=22, amp=0.2))
    cuts = (int(3.2 * 16_000), WINDOW_SAMPLES + 40, int(9.9 * 16_000))

    def previews(sess, audio, cut, fed):
        sess.feed(audio[fed:cut])
        return sess.preview().text

    solo = []
    for audio in streams:
        sess, fed, texts = model.incremental_session(**kw), 0, []
        for cut in cuts:
            texts.append(previews(sess, audio, cut, fed))
            fed = cut
        solo.append(texts)
    sessions = [model.incremental_session(**kw) for _ in streams]
    fed = 0
    for i, cut in enumerate(cuts):
        for k, (sess, audio) in enumerate(zip(sessions, streams)):
            assert previews(sess, audio, cut, fed) == solo[k][i]
        fed = cut
    for k, audio in enumerate(streams):
        assert solo[k][-1] == model.transcribe(audio[: cuts[-1]], **kw).text
    assert len({tuple(t) for t in solo}) == 2


# -- the whole slice -------------------------------------------------------------


def _sessions(pair, **kw):
    jax_model, port = pair
    return jax_model.incremental_session(**kw), port.incremental_session(**kw)


def _hold(pair, jsess, tsess, audio, **kw):
    """Port preview == JAX preview == port transcribe of the same prefix,
    and the preview's first-token logits (the suffix advance's) within
    LOGITS_ATOL of the offline prefill's."""
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    first = []
    real = Generator.decode

    def spy(self, kv, first_logits, *a, **k):
        first.append(first_logits.clone())
        return real(self, kv, first_logits, *a, **k)

    Generator.decode = spy
    try:
        got = tsess.preview()
        off = pair[1].transcribe(audio, **kw)
    finally:
        Generator.decode = real
    assert got.text == jsess.preview().text
    assert got.text == off.text
    np.testing.assert_allclose(first[0].numpy(), first[1].numpy(), atol=LOGITS_ATOL, rtol=0)
    return got


@pytest.mark.parametrize("which", ["f32", "int8 weights"])
def test_preview_matches_jax_and_offline_at_many_points(pair, pair_int8, which):
    """Irregular pieces; previews at prefix lengths below, at and beyond
    window boundaries (tests/test_incremental.py's cuts)."""
    pp = pair if which == "f32" else pair_int8
    audio = _speech_like(21.0, seed=1)
    kw = dict(max_tokens=6, language="English")
    jsess, tsess = _sessions(pp, **kw)
    cuts = [int(3.2 * 16_000), WINDOW_SAMPLES + 40, int(9.7 * 16_000),
            2 * WINDOW_SAMPLES + 40, int(21.0 * 16_000)]
    fed = 0
    for cut in cuts:
        jsess.feed(audio[fed:cut])
        tsess.feed(audio[fed:cut])
        fed = cut
        _hold(pp, jsess, tsess, audio[:cut], **kw)
    # Completed windows were advanced once each, not re-run per call.
    assert tsess._committed == jsess._committed == 2


def test_preview_handles_clamp_floor_rise(pair):
    """A near-silent first window, then loud audio: the rising clamp floor
    re-advances the quiet window, and the preview stays identical."""
    quiet = _speech_like(9.0, seed=2, amp=1e-4)
    loud = _speech_like(8.0, seed=3, amp=0.5)
    kw = dict(max_tokens=6, language="English")
    jsess, tsess = _sessions(pair, **kw)
    for s in (jsess, tsess):
        s.feed(quiet)
    _hold(pair, jsess, tsess, quiet, **kw)
    floor_before = list(tsess._win_floor)
    for s in (jsess, tsess):
        s.feed(loud)
    _hold(pair, jsess, tsess, np.concatenate([quiet, loud]), **kw)
    assert tsess._win_floor[0] > floor_before[0]
    np.testing.assert_allclose(tsess._win_floor, jsess._win_floor, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,language,max_tokens", [
    (176, "English", 4),                 # sub-200-sample stream: the multi-wrap reflect
    (201, "English", 4),                 # exactly N_FFT // 2 + 1 samples
    (5 * 16_000, "detect", 8),           # unprimed suffix, parsed language
])
def test_preview_edge_streams_match_jax(pair, n, language, max_tokens):
    audio = _speech_like(n / 16_000 + 0.01, seed=8)[:n]
    kw = dict(max_tokens=max_tokens, language=language)
    jsess, tsess = _sessions(pair, **kw)
    jsess.feed(audio)
    tsess.feed(audio)
    got, ref = tsess.preview(), jsess.preview()
    assert (got.text, got.language) == (ref.text, ref.language)
    off = pair[1].transcribe(audio, **kw)
    assert (got.text, got.language) == (off.text, off.language)


def test_back_to_back_previews_identical(pair):
    """The decode writes only decode slots: the committed prefix survives it."""
    sess = pair[1].incremental_session(max_tokens=6, language="English")
    sess.feed(_speech_like(10.0, seed=4))
    assert sess.preview().text == sess.preview().text


def test_empty_and_reset(pair):
    sess = pair[1].incremental_session(max_tokens=6)
    assert sess.preview().text == ""
    sess.feed(_speech_like(2.0, seed=5))
    sess.preview()
    sess.reset()
    assert sess.duration == 0.0
    assert sess.preview().text == ""


@pytest.mark.parametrize("runtime", [dict(kv_cache_dtype="int8"), dict(speculative="ngram")])
def test_session_refusals(pair, runtime):
    port = pair[1]
    model = Qwen3ASR(port._config, port._encoder_params, port._decoder_params,
                     port._tokenizer, RuntimeConfig(**RT, **runtime))
    with pytest.raises(ValueError):
        model.incremental_session()


def test_session_refuses_duration_past_the_largest_bucket(pair):
    with pytest.raises(ValueError, match="largest frame bucket"):
        pair[1].incremental_session(max_duration=40.0)


def test_failed_preview_invalidates_session(pair, monkeypatch):
    """A failure inside preview() poisons the session with a clear error;
    reset() rebuilds the prefix cache and the session works again."""
    audio = _speech_like(3.0, seed=10)
    sess = pair[1].incremental_session(max_tokens=4, language="English")
    sess.feed(audio)
    baseline = sess.preview().text

    def exploding_advance(*a, **k):
        raise RuntimeError("injected advance failure")

    monkeypatch.setattr(sess._gen, "advance", exploding_advance)
    with pytest.raises(RuntimeError, match="injected"):
        sess.preview()
    monkeypatch.undo()
    assert not pair[1]._lock.locked()
    for call in (sess.preview, lambda: sess.feed(audio)):
        with pytest.raises(RuntimeError, match="reset"):
            call()
    sess.reset()
    sess.feed(audio)
    assert sess.preview().text == baseline


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _card_model(pair, device, dtype):
    port = pair[1]

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v) for v in tree]
        return tree.to(device, dtype)

    return Qwen3ASR(port._config, move(port._encoder_params), move(port._decoder_params),
                    port._tokenizer, RuntimeConfig(**RT))


@pytest.mark.cuda
def test_advance_on_the_card_matches_cpu(pair, cuda):
    """bf16 advance (the cached forward's plain attention, cuBLAS products)
    against the CPU float32 advance: the logits within 5e-2 of max |logit|,
    the smoke's reference tolerance."""
    from qwen3_asr_tpu_torch.models.decoder import init_kv_cache

    port = pair[1]
    card = _card_model(pair, cuda, torch.bfloat16)
    cfg = port._config.text_decoder
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((1, 104, cfg.hidden_size)).astype(np.float32)
    out = []
    for gen, dev, dtype in ((port._generator, "cpu", torch.float32),
                            (card._generator, cuda, torch.bfloat16)):
        with torch.inference_mode():
            kv = init_kv_cache(cfg, 1, 288, dtype, dev)
            kv, _ = gen.advance(kv, gen.embed_ids(np.arange(16)[None] + 1),
                                np.arange(16)[None], 0, 8)
            kv, logits = gen.advance(kv, torch.from_numpy(feats).to(dev, dtype),
                                     (9 + np.arange(104))[None], 9, 103)
        out.append(logits.float().cpu())
    rel = ((out[1] - out[0]).abs().max() / out[0].abs().max()).item()
    assert rel < 5e-2, rel


@pytest.mark.cuda
def test_graphed_preview_equals_eager_preview(pair, cuda, monkeypatch):
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    card = _card_model(pair, cuda, torch.bfloat16)
    sess = card.incremental_session(max_tokens=16, language="English")
    sess.feed(_speech_like(12.0, seed=13))
    graphed = sess.preview().text
    gen = card._generator
    # One decode bucket; the advance's buckets: T = 16 (prefix, suffix) and 104.
    assert len(gen.graphs.entries) - len(_advance_keys(gen)) == 1
    assert gen.graphs.captures == 1 + len(_advance_keys(gen)) == 3
    for name in ("decode", "advance"):
        real = getattr(Generator, name)
        monkeypatch.setattr(Generator, name,
                            lambda self, *a, _real=real, **k: _real(self, *a, **dict(k, eager=True)))
    assert sess.preview().text == graphed


@pytest.mark.cuda
def test_graphed_advance_bit_identical_on_the_card(pair, cuda):
    """The captured advance (bf16, the arena copies included) against
    ``advance(eager=True)`` on the same cache: logits and cache bit for
    bit, at two slots of one bucket (one capture)."""
    from qwen3_asr_tpu_torch.models.decoder import init_kv_cache

    card = _card_model(pair, cuda, torch.bfloat16)
    gen = card._generator
    cfg = card._config.text_decoder
    rng = np.random.default_rng(14)
    with torch.inference_mode():
        kv = init_kv_cache(cfg, 1, 288, torch.bfloat16, cuda)
        for c in kv:
            c.copy_(torch.from_numpy(rng.standard_normal(c.shape).astype(np.float32)))
        for slot in (9, 113):
            feats = torch.from_numpy(rng.standard_normal(
                (1, 104, cfg.hidden_size)).astype(np.float32)).to(cuda, torch.bfloat16)
            pos = (slot + np.arange(104))[None]
            ref_kv, ref = gen.advance(tuple(c.clone() for c in kv), feats, pos, slot, 103,
                                      eager=True)
            kv, logits = gen.advance(kv, feats, pos, slot, 103)
            assert torch.equal(logits, ref)
            assert all(torch.equal(a, b) for a, b in zip(kv, ref_kv))
    assert gen.graphs.captures == 1
    card.close()


@pytest.mark.cuda
def test_interleaved_sessions_on_the_card(pair, cuda):
    """Two bf16 sessions previewing in turns on one card model give the
    texts each gives alone."""
    card = _card_model(pair, cuda, torch.bfloat16)
    kw = dict(max_tokens=12, language="English")
    streams = (_speech_like(12.0, seed=23), _speech_like(10.0, seed=24, amp=0.2))
    cuts = (int(3.2 * 16_000), WINDOW_SAMPLES + 40, int(9.9 * 16_000))
    solo = []
    for audio in streams:
        sess, fed, texts = card.incremental_session(**kw), 0, []
        for cut in cuts:
            sess.feed(audio[fed:cut])
            fed = cut
            texts.append(sess.preview().text)
        solo.append(texts)
    sessions = [card.incremental_session(**kw) for _ in streams]
    fed = 0
    for i, cut in enumerate(cuts):
        for k, (sess, audio) in enumerate(zip(sessions, streams)):
            sess.feed(audio[fed:cut])
            assert sess.preview().text == solo[k][i]
        fed = cut
    card.close()
