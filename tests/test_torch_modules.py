"""Module-level parity of the PyTorch port against the JAX package.

Same numpy inputs through both, float32 on the CPU.  Tolerances: mel 1e-4
(against ``_mel_core`` and the numpy reference ``log_mel_spectrogram_np``);
norms, RoPE and sdpa 1e-5; encoder features, decoder prefill hidden states
and cache, and one split-decode step with ``decode_ctx`` 1e-4 (float32
sums in another order, through a few layers).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import RUNTIME, clips, configs, numpy_params

from qwen3_asr_tpu_torch.audio import mel as tmel
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models import encoder as tenc
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops import attention as tatt
from qwen3_asr_tpu_torch.ops import norms as tnorms
from qwen3_asr_tpu_torch.ops import rope as trope
from qwen3_asr_tpu_torch.ops import sampling as tsamp


def _t(x):
    return torch.from_numpy(np.array(x))


# -- mel --------------------------------------------------------------------


@pytest.mark.parametrize("pcm16", [False, True])
def test_mel_matches_jax_mel_core(pcm16):
    import jax.numpy as jnp

    from qwen3_asr_tpu.audio import mel as jmel

    audios = clips((0.7, 3.0, 7.9), seed=3)
    if pcm16:
        audios = [(a * 32767).astype(np.int16) for a in audios]
    bucket = 800
    padded = tmel.host_pad_batch(audios, bucket, tmel.N_FFT, tmel.HOP_LENGTH)
    np.testing.assert_array_equal(
        padded, jmel.host_pad_batch(audios, bucket, jmel.N_FFT, jmel.HOP_LENGTH)
    )
    n_valid = np.array([len(a) // tmel.HOP_LENGTH for a in audios], np.int32)
    ref = np.asarray(jmel._mel_batch_from_padded(jnp.asarray(padded), jnp.asarray(n_valid), bucket))
    out = tmel.log_mel_batch(_t(padded), _t(n_valid).long(), bucket)
    assert out.shape == (3, 128, bucket)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_mel_matches_numpy_reference():
    from qwen3_asr_tpu.audio.mel import log_mel_spectrogram_np

    audio = clips((2.45,), seed=5)[0]
    n = len(audio) // tmel.HOP_LENGTH
    padded = tmel.host_pad_batch([audio], 800, tmel.N_FFT, tmel.HOP_LENGTH)
    out = tmel.log_mel_batch(_t(padded), torch.tensor([n]), 800)[0].numpy()
    ref = log_mel_spectrogram_np(audio)
    assert ref.shape == (128, n)
    np.testing.assert_allclose(out[:, :n], ref, atol=1e-4, rtol=0)
    assert not out[:, n:].any()


def test_mel_bucket_and_filterbank_match():
    from qwen3_asr_tpu.audio import mel as jmel

    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    fe_t, fe_j = tmel.MelFrontend((800, 1600)), jmel.MelFrontend((800, 1600))
    for n in (1, 128_000, 128_160, 256_000, 999_999):
        assert fe_t.bucket_for(n) == fe_j.bucket_for(n)


# -- ops --------------------------------------------------------------------


def test_norms_match_jax():
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops import norms as jn

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), atol=1e-5, rtol=0,
    )
    np.testing.assert_allclose(
        tnorms.layer_norm(_t(x), _t(w), _t(b), 1e-5).numpy(),
        np.asarray(jn.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)),
        atol=1e-5, rtol=0,
    )


def test_rope_matches_jax():
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.rope import rope_rotate

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 128)).astype(np.float32)
    pos = np.array([[0, 1, 2, 300, 4095, 20000], [5, 6, 7, 8, 9, 10]], np.int32)
    ref = np.asarray(rope_rotate(jnp.asarray(x), jnp.asarray(pos)[:, None, :], 1e6))
    out = trope.rope_rotate(_t(x), _t(pos)[:, None, :], 1e6).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_sdpa_and_windowed_attention_match_jax():
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops import attention as ja

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 16, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 16, 32)).astype(np.float32)
    mask = rng.random((2, 1, 16, 16)) > 0.3
    mask[..., 0] = True
    ref = np.asarray(ja.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)))
    out = tatt.sdpa(_t(q), _t(k), _t(v), mask=_t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)

    kq = rng.standard_normal((2, 4, 24, 32)).astype(np.float32)
    valid = np.arange(24)[None, :] < np.array([[20], [9]])
    ref = np.asarray(ja.windowed_self_attention(
        jnp.asarray(kq), jnp.asarray(kq), jnp.asarray(kq), 8, jnp.asarray(valid)))
    out = tatt.windowed_self_attention(_t(kq), _t(kq), _t(kq), 8, _t(valid)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_repetition_penalty_and_window_match_jax():
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops import sampling as js

    rng = np.random.default_rng(3)
    B, V, W, TB = 3, 50, 8, 16
    logits = rng.standard_normal((B, V)).astype(np.float32) * 4
    tokens = rng.integers(0, V, (B, TB)).astype(np.int32)
    counts = np.array([1, 5, 16], np.int32)
    for ctx in (0, 3, 100):
        ref_win = np.asarray(js.recent_token_window(
            jnp.asarray(tokens), jnp.asarray(counts), jnp.int32(ctx), W, TB))
        win = tsamp.recent_token_window(_t(tokens).long(), _t(counts).long(), ctx, W, TB)
        np.testing.assert_array_equal(win.numpy(), ref_win)
        ref = np.asarray(jax.vmap(lambda l, r: js.apply_repetition_penalty(l, r, 1.3))(
            jnp.asarray(logits), jnp.asarray(ref_win)))
        out = tsamp.apply_repetition_penalty(_t(logits), win, 1.3).numpy()
        np.testing.assert_array_equal(out, ref)
    assert tsamp.RECENT_PAD_ID == js.RECENT_PAD_ID


# -- models -----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed=11)
    jenc = jax.tree_util.tree_map(jnp.asarray, enc)
    jdec = jax.tree_util.tree_map(jnp.asarray, dec)
    tenc_p, tdec_p = params_from_jax(enc, dec)
    return jcfg, tcfg, jenc, jdec, tenc_p, tdec_p


def test_encoder_features_match_jax(tiny):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.encoder import encoder_forward

    jcfg, tcfg, jenc, _, tenc_p, _ = tiny
    rng = np.random.default_rng(4)
    T = 1600
    nvf = np.array([1600, 731, 5], np.int32)
    mel = rng.standard_normal((3, 128, T)).astype(np.float32)
    mel = np.where(np.arange(T)[None, None, :] < nvf[:, None, None], mel, 0.0).astype(np.float32)
    ref, ref_n = encoder_forward(jenc, jcfg.audio_encoder, jnp.asarray(mel), jnp.asarray(nvf))
    out, n = tenc.encoder_forward(tenc_p, tcfg.audio_encoder, _t(mel), _t(nvf).long())
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def _decoder_inputs(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)


def test_decoder_prefill_matches_jax(tiny):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod

    jcfg, tcfg, _, jdec, _, tdec_p = tiny
    c = jcfg.text_decoder
    B, T, S = 2, 70, 256
    x = _decoder_inputs(c, B, T, 5)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    ref_h, (ref_k, ref_v) = jdec_mod.decoder_forward(
        jdec, c, jnp.asarray(x), jnp.asarray(pos),
        jdec_mod.init_kv_cache(c, B, S, jnp.float32),
    )
    kv = tdec.init_kv_cache(tcfg.text_decoder, B, S, torch.float32)
    h, (k, v) = tdec.decoder_forward(
        tdec.fuse_decoder_params(tdec_p), tcfg.text_decoder, _t(x), _t(pos).long(), kv,
    )
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(ref_k), atol=1e-4, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-4, rtol=0)


def test_decoder_decode_step_matches_jax(tiny):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod

    jcfg, tcfg, _, jdec, _, tdec_p = tiny
    c = jcfg.text_decoder
    B, pb, S = 3, 128, 256
    rng = np.random.default_rng(6)
    shape = (c.num_hidden_layers, B, c.num_key_value_heads, S, c.head_dim)
    keys = rng.standard_normal(shape).astype(np.float32)
    values = rng.standard_normal(shape).astype(np.float32)
    x = _decoder_inputs(c, B, 1, 7)
    plen = np.array([100, 128, 3], np.int32)
    step = 9
    counts = np.array([10, 4, 7], np.int32)
    pos = (plen + counts - 1)[:, None]
    ref_h, (ref_k, ref_v) = jdec_mod.decoder_forward(
        jdec, c, jnp.asarray(x), jnp.asarray(pos), (jnp.asarray(keys), jnp.asarray(values)),
        write_slots=jnp.full((B,), pb + step, jnp.int32), uniform_write=True,
        decode_ctx=(jnp.asarray(plen), jnp.int32(pb + step), pb),
    )
    kv = (_t(keys.copy()), _t(values.copy()))
    h, (k, v) = tdec.decoder_forward(
        tdec_p, tcfg.text_decoder, _t(x), _t(pos).long(), kv,
        write_slots=pb + step, decode_ctx=(_t(plen), pb + step, pb),
    )
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(ref_k), atol=1e-4, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-4, rtol=0)
    ref_logits = jdec_mod.decoder_logits(jdec, c, ref_h)
    logits = tdec.decoder_logits(tdec_p, tcfg.text_decoder, h)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)


def test_decoder_rejects_unported_paths(tiny):
    """A decode_ctx forward of more than the verify's 8 positions has no
    port (the cached forward, write_slots without decode_ctx, is
    tests/test_torch_incremental.py's)."""
    _, tcfg, _, _, _, tdec_p = tiny
    kv = tdec.init_kv_cache(tcfg.text_decoder, 1, 16, torch.float32)
    x = torch.zeros(1, 9, tcfg.text_decoder.hidden_size)
    plen = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tdec.decoder_forward(tdec_p, tcfg.text_decoder, x, torch.zeros(1, 9).long(), kv,
                             write_slots=torch.tensor([5]), decode_ctx=(plen, 5, 4))


def test_generator_plan_matches_jax():
    from qwen3_asr_tpu.config import RuntimeConfig as JRT
    from qwen3_asr_tpu.runtime.generate import Generator as JGen

    from qwen3_asr_tpu_torch.config import RuntimeConfig
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    jcfg, tcfg = configs()
    for rt in ({}, RUNTIME, {"kv_cache_budget_gb": 0.001}):
        jg = JGen(None, jcfg.text_decoder, JRT(**rt))
        tg = Generator(None, tcfg.text_decoder, RuntimeConfig(**rt))
        for atb, plen, new, batch in ((104, 120, 256, 1), (416, 430, 64, 8),
                                      (1664, 1690, 4000, 96), (104, 40, 10, 3)):
            assert tg.plan(atb, plen, new, batch) == jg.plan(atb, plen, new, batch)
            run = RuntimeConfig(**rt).plan_prefill_run(plen, tg.plan(atb, plen, new, batch)[0])
            assert run == JRT(**rt).plan_prefill_run(plen, jg.plan(atb, plen, new, batch)[0])
        # (mode, rep_window, k_subset), greedy and sampled (top-k subset
        # buckets, including a top_k past the largest bucket).
        for args in ((128, 0.0, 0, 1.2, 100), (128, 0.7, 0, 1.2, 100),
                     (4096, 0.7, 2000, 1.0, 3000), (128, 1.0, 10**6, 1.2, 100)):
            assert tg.plan_statics(*args) == jg.plan_statics(*args)


# -- the lm head hands the argmax f32 logits ---------------------------------------


def _near_tie_lm_head(device):
    """bf16 tied embedding whose rows 5 and 9 score 20.0 and 20.046875 on an
    all-ones hidden state: closer than a bf16 ulp (0.125 between 16 and 32),
    so a product rounded to bf16 ties them and argmax takes row 5, while
    the f32 accumulator (the JAX package's logits) picks row 9."""
    from torch_parity import TINY_DECODER

    from qwen3_asr_tpu_torch.config import TextDecoderConfig

    cfg = TextDecoderConfig(**TINY_DECODER)
    emb = torch.zeros(cfg.vocab_size, cfg.hidden_size)
    emb[5, :2] = torch.tensor([16.0, 4.0])
    emb[9, :3] = torch.tensor([16.0, 4.0, 0.046875])
    params = {
        "embedding": emb.to(device, torch.bfloat16),
        "final_norm": torch.ones(cfg.hidden_size, dtype=torch.bfloat16, device=device),
        "layers": [],
    }
    hidden = torch.ones(2, 1, cfg.hidden_size, dtype=torch.bfloat16, device=device)
    return cfg, params, hidden


def test_lm_head_logits_f32_contract():
    cfg, params, hidden = _near_tie_lm_head("cpu")
    logits = tdec.decoder_logits(params, cfg, hidden)
    assert logits.dtype == torch.float32 and logits.shape == (2, 1, cfg.vocab_size)
    h = tnorms.rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    emb = params["embedding"]
    f32 = h.float() @ emb.float().T
    assert f32[0, 0, 9] - f32[0, 0, 5] == 0.046875
    assert (f32.argmax(-1) == 9).all()                       # the reference pick
    assert ((h @ emb.T).float().argmax(-1) == 5).all()       # the bf16-rounded fault


@pytest.mark.cuda
def test_cuda_lm_head_keeps_the_f32_accumulator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg, params, hidden = _near_tie_lm_head("cuda")
    logits = tdec.decoder_logits(params, cfg, hidden)
    assert logits.dtype == torch.float32
    assert (logits.argmax(-1) == 9).all()
    assert (logits[..., 9] - logits[..., 5]).eq(0.046875).all()
