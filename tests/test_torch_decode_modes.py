"""The decoder's decode-kernel modes in the PyTorch port, and kernels K11a
(``decode_attention_hbm2``, mode "3") and K11b (``decode_attention_hbm3``,
mode "4").

On the CPU:
  * each wrapper's plain version (K2's, with the scalar decode end) against
    the JAX package's Pallas kernel in interpret mode at
    tests/test_pallas.py:112-199's shapes, B=1 included: the Pallas kernel
    runs on the float32 inputs and rounds q * scale, K, V and the softmax
    weights to bf16 inside, so the plain version runs on the bf16-rounded
    inputs and the two agree to atol 5e-3 (the bound tests/test_pallas.py
    holds the kernel to against that oracle);
  * the tiling rule's ValueError (as the JAX wrappers raise it) and an idle
    lane's output (the self-term alone: v_new);
  * K11b's grid rule (``stream_grid``): up to one block per SM, each a
    contiguous run of (lane, KV head) pairs, at B = 1, 8, 40, 96;
  * one split decode step under modes "3" and "4" against the JAX decoder
    (which runs its XLA attention on the CPU), 1e-4 as
    tests/test_torch_modules.py; per-lane write slots keep K2 under both
    modes; "0" raises NotImplementedError and a shape no block size tiles
    ValueError;
  * greedy ``transcribe_batch(speculative="off")`` token-identical to the
    JAX package under modes "3" and "4".

Tests marked ``cuda`` hold each kernel against its plain version on the GPU
(bf16 against the plain version in float32 over the same bf16 inputs: atol
2e-2 + rtol 2e-2, K2's bound; the kernels round q * scale, p and the
self-term products to bf16 where the plain version keeps f32) and K11a to
K11b bit for bit (one stream under two names), and skip without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import clips, configs, ids_of, models, numpy_params

from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
from qwen3_asr_tpu_torch.ops.kernels.experiments.decode_attention_hbm2 import (
    decode_attention_hbm2,
    stream_grid,
    tile_block_k,
)
from qwen3_asr_tpu_torch.ops.kernels.experiments.decode_attention_hbm3 import (
    decode_attention_hbm3,
)

PORT = {"hbm2": decode_attention_hbm2, "hbm3": decode_attention_hbm3}
#: tests/test_pallas.py:112-199: (L, B, hq, hkv, S, Pb, prompt lengths,
#: decode end - Pb, layer, seed).
CASES = {
    "B=2": (3, 2, 16, 8, 512, 256, [100, 250], 37, 1, 0),
    "B=3": (3, 3, 16, 8, 512, 256, [100, 250, 37], 37, 1, 0),
    "B=1": (2, 1, 4, 2, 256, 128, [90], 0, 0, 7),
}


def _pallas(kind):
    if kind == "hbm2":
        from qwen3_asr_tpu.ops.pallas.experiments.decode_attention_hbm2 import (
            decode_attention_hbm2 as fn,
        )
    else:
        from qwen3_asr_tpu.ops.pallas.experiments.decode_attention_hbm3 import (
            decode_attention_hbm3 as fn,
        )
    return fn


def _inputs(L, B, hq, hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, hq, D)).astype(np.float32),
        rng.standard_normal((L, B, hkv, S, D)).astype(np.float32),
        rng.standard_normal((L, B, hkv, S, D)).astype(np.float32),
        rng.standard_normal((B, hkv, 1, D)).astype(np.float32),
        rng.standard_normal((B, hkv, 1, D)).astype(np.float32),
    )


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).bfloat16().float()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_plain_matches_pallas(kind, case):
    import jax.numpy as jnp

    L, B, hq, hkv, S, pb, plen, doff, layer, seed = CASES[case]
    arrays = _inputs(L, B, hq, hkv, S, 128, seed)
    plen = np.asarray(plen, np.int32)
    ref = np.asarray(_pallas(kind)(
        *arrays, jnp.int32(layer), jnp.asarray(plen), jnp.int32(pb + doff), pb,
        block_k=128, interpret=True,
    ))
    before = LAUNCHES[f"decode_attention_{kind}"]
    out = PORT[kind](*map(_bf16, arrays), layer, torch.from_numpy(plen), pb + doff, pb,
                     block_k=128)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-3, rtol=0)
    assert LAUNCHES[f"decode_attention_{kind}"] == before     # plain: not counted


@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_idle_lane_is_the_self_term(kind):
    import jax.numpy as jnp

    pb = 128
    arrays = _inputs(2, 2, 4, 2, 256, 128, 5)
    plen = np.array([0, 60], np.int32)
    ref = np.asarray(_pallas(kind)(
        *arrays, jnp.int32(1), jnp.asarray(plen), jnp.int32(pb), pb, interpret=True,
    ))
    out = PORT[kind](*map(torch.from_numpy, arrays), 1, torch.from_numpy(plen), pb, pb).numpy()
    v_new = np.repeat(arrays[4][0, :, 0], 2, axis=0)
    np.testing.assert_allclose(out[0], v_new, atol=1e-6)
    np.testing.assert_allclose(ref[0], v_new, atol=1e-6)


@pytest.mark.parametrize("S,pb,block_k,want", [
    (640, 512, 512, 128), (2560, 512, 512, 512), (1024, 512, 1024, 512),
    (256, 128, 512, 128), (64, 0, 512, 64),
])
def test_tile_block_k(S, pb, block_k, want):
    assert tile_block_k(S, pb, block_k) == want


@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_untileable_shape_raises_as_jax(kind):
    import jax.numpy as jnp

    S, pb = 200, 128
    arrays = _inputs(1, 1, 4, 2, S, 128, 1)
    plen = np.array([50], np.int32)
    with pytest.raises(ValueError, match="not tileable"):
        _pallas(kind)(*arrays, jnp.int32(0), jnp.asarray(plen), jnp.int32(pb), pb,
                      interpret=True)
    with pytest.raises(ValueError, match="not tileable"):
        PORT[kind](*map(torch.from_numpy, arrays), 0, torch.from_numpy(plen), pb, pb)


def _check_inputs(B=2, hq=4, hkv=2, S=256):
    bf = torch.bfloat16
    return dict(q=torch.zeros(B, hq, 128, dtype=bf),
                kall=torch.zeros(2, B, hkv, S, 128, dtype=bf),
                vall=torch.zeros(2, B, hkv, S, 128, dtype=bf),
                k_new=torch.zeros(B, hkv, 1, 128, dtype=bf),
                v_new=torch.zeros(B, hkv, 1, 128, dtype=bf),
                layer=1, prompt_len=torch.zeros(B, dtype=torch.int32), block_k=128)


@pytest.mark.parametrize("bad,err", [
    (dict(q=torch.zeros(2, 4, 128)), TypeError),                          # f32 q
    (dict(layer=2), ValueError),                                          # layer out of range
    (dict(prompt_len=torch.zeros(2, dtype=torch.int64)), ValueError),
    (dict(q=torch.zeros(2, 6, 128, dtype=torch.bfloat16)), ValueError),   # GQA group 3
    (dict(kall=torch.zeros(2, 2, 2, 128, 256, dtype=torch.bfloat16).transpose(3, 4)),
     ValueError),                                                         # not contiguous
    (dict(block_k=144), ValueError),                                      # not 32-row tiles
])
def test_stream_kernel_check_rejects_bad_inputs(bad, err):
    from qwen3_asr_tpu_torch.ops.kernels.experiments.decode_attention_hbm2 import check

    check(**_check_inputs())
    with pytest.raises(err):
        check(**{**_check_inputs(), **bad})


# -- the split decode step under each mode ------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed=11)
    _, tdec_p = params_from_jax(enc, dec)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, dec), tdec_p


def _step_inputs(cfg, B, S, seed=6):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_hidden_layers, B, cfg.num_key_value_heads, S, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32))


@pytest.mark.parametrize("mode", ["3", "4"])
def test_decode_step_matches_jax_per_mode(tiny, monkeypatch, mode):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod

    jcfg, tcfg, jdec, tdec_p = tiny
    c = jcfg.text_decoder
    B, pb, S, step = 3, 128, 256, 9
    keys, values, x = _step_inputs(c, B, S)
    plen = np.array([100, 128, 3], np.int32)
    pos = (plen + np.array([10, 4, 7], np.int32) - 1)[:, None]
    ref_h, (ref_k, ref_v) = jdec_mod.decoder_forward(
        jdec, c, jnp.asarray(x), jnp.asarray(pos), (jnp.asarray(keys), jnp.asarray(values)),
        write_slots=jnp.full((B,), pb + step, jnp.int32), uniform_write=True,
        decode_ctx=(jnp.asarray(plen), jnp.int32(pb + step), pb),
    )
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    called = []
    fn = "decode_attention_hbm2" if mode == "3" else "decode_attention_hbm3"
    real = getattr(tdec, fn)
    monkeypatch.setattr(tdec, fn, lambda *a, **k: called.append(k) or real(*a, **k))
    h, (k, v) = tdec.decoder_forward(
        tdec_p, tcfg.text_decoder, torch.from_numpy(x), torch.from_numpy(pos).long(),
        (torch.from_numpy(keys.copy()), torch.from_numpy(values.copy())),
        write_slots=pb + step, decode_ctx=(torch.from_numpy(plen), pb + step, pb),
    )
    assert len(called) == c.num_hidden_layers
    assert all(kw["block_k"] == 128 for kw in called)     # the largest that fits
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(ref_k), atol=1e-4, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["3", "4"])
def test_per_lane_slots_keep_k2(tiny, monkeypatch, mode):
    """The flat engine's per-lane write slots run K2 under every mode."""
    _, tcfg, _, tdec_p = tiny
    c = tcfg.text_decoder
    B, pb, S = 3, 128, 256
    keys, values, x = _step_inputs(c, B, S, seed=8)
    plen = torch.tensor([100, 128, 3], dtype=torch.int32)
    ws = torch.tensor([pb + 3, pb + 9, pb], dtype=torch.int32)
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    calls = {"k2": 0}
    real = tdec.decode_attention

    def k2(*a, **k):
        calls["k2"] += 1
        return real(*a, **k)

    def never(*a, **k):
        raise AssertionError("a scalar-decode-end kernel ran for per-lane slots")

    monkeypatch.setattr(tdec, "decode_attention", k2)
    monkeypatch.setattr(tdec, "decode_attention_hbm2", never)
    monkeypatch.setattr(tdec, "decode_attention_hbm3", never)
    tdec.decoder_forward(
        tdec_p, c, torch.from_numpy(x), (plen.long() + 4)[:, None],
        (torch.from_numpy(keys), torch.from_numpy(values)),
        write_slots=ws, decode_ctx=(plen, ws, pb),
    )
    assert calls["k2"] == c.num_hidden_layers


def test_unported_and_untileable_modes_raise(tiny, monkeypatch):
    _, tcfg, _, tdec_p = tiny
    c = tcfg.text_decoder
    B, pb = 2, 128
    plen = torch.tensor([100, 20], dtype=torch.int32)

    def step(S):
        keys, values, x = _step_inputs(c, B, S, seed=9)
        return tdec.decoder_forward(
            tdec_p, c, torch.from_numpy(x), (plen.long() + 1)[:, None],
            (torch.from_numpy(keys), torch.from_numpy(values)),
            write_slots=pb, decode_ctx=(plen, pb, pb),
        )

    for mode in ("0", "1"):
        monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step(256)
    for mode in ("3", "4"):
        monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
        with pytest.raises(ValueError, match="S=144"):
            step(pb + 16)


@pytest.mark.parametrize("mode", ["3", "4"])
def test_transcribe_batch_token_identical_per_mode(monkeypatch, mode):
    """128-row token buckets, so that every cache length is a multiple of
    128 (the modes' tiles); the JAX package runs its XLA attention on the
    CPU whatever the mode."""
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    jax_model, port = models(seed=0, runtime={"speculative": "off",
                                              "token_buckets": (128, 256)})
    audio = clips((1.0, 2.3, 5.1), seed=1)
    ref = ids_of(jax_model.transcribe_batch(audio, max_tokens=12))
    out = ids_of(port.transcribe_batch(audio, max_tokens=12))
    assert out == ref
    assert len({t for seq in out for t in seq}) > 3


@pytest.mark.parametrize("B,want", [(1, (8, 1)), (8, (64, 1)), (40, (107, 3)), (96, (128, 6))])
def test_stream_grid_uses_every_sm(B, want):
    """Hkv = 8 on a 132-SM card: a block per pair up to the SM count, then
    contiguous runs of ``per`` pairs that cover every pair once."""
    pairs, sms = 8 * B, 132
    blocks, per = stream_grid(pairs, sms)
    assert (blocks, per) == want
    assert blocks <= sms and (blocks - 1) * per < pairs <= blocks * per
    assert stream_grid(pairs, 2 * pairs) == (pairs, 1)


# -- on the GPU: K11a and K11b against their plain version ----------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
@pytest.mark.parametrize("B,S,pb,dend_off,block_k,G", [
    (1, 640, 512, 1, 512, 2),        # block_k halves to 128
    (8, 640, 512, 64, 128, 2),       # the smoke's decode shape; K11b: 64 blocks of 1 pair
    (40, 2560, 512, 700, 512, 2),    # 320 pairs: K11b's 107 blocks of 3 pairs
    (5, 1024, 512, 0, 256, 2),       # no decode row yet
    (96, 2560, 512, 1024, 512, 1),   # 768 pairs: K11b's 128 blocks of 6 pairs
    (96, 2560, 512, 1024, 512, 2),
    (96, 2560, 512, 1024, 512, 4),
])
def test_cuda_matches_plain(cuda, kind, B, S, pb, dend_off, block_k, G):
    g = torch.Generator(device=cuda).manual_seed(B * S + dend_off + G)
    kall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    vall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    q = torch.randn(B, 8 * G, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=g, device=cuda).int()
    if B > 1:
        plen[-1] = 0                # an idle lane when dend_off == 0
    dend = pb + dend_off
    name = f"decode_attention_{kind}"
    before = LAUNCHES[name]
    out = PORT[kind](q, kall, vall, k_new, v_new, 1, plen, dend, pb, block_k=block_k)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    ref = da.decode_attention_plain(
        q.float(), kall.float(), vall.float(), k_new.float(), v_new.float(), 1, plen,
        torch.full_like(plen, dend), pb, 128 ** -0.5,
    )
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,dend_off,G", [
    (1, 640, 64, 2), (6, 640, 0, 2), (8, 640, 64, 2), (8, 2560, 1024, 4),
    (96, 2560, 1024, 1), (96, 640, 64, 2),
])
def test_cuda_hbm2_equals_hbm3(cuda, B, S, dend_off, G):
    """K11a and K11b run one stream under two kernel names: bit-identical,
    an idle lane (prompt_len 0 at dend_off 0) included."""
    pb = 512
    g = torch.Generator(device=cuda).manual_seed(B + S + G)
    kall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    vall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    q = torch.randn(B, 8 * G, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=g, device=cuda).int()
    if B > 1:
        plen[-1] = 0
    args = (q, kall, vall, k_new, v_new, 1, plen, pb + dend_off, pb)
    a, b = decode_attention_hbm2(*args), decode_attention_hbm3(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
