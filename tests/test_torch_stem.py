"""The encoder's conv-stem modes in the PyTorch port, and kernel K11e.

On the CPU:
  * K11e's plain version (``conv_s2_gelu`` on CPU tensors) against the JAX
    package's Pallas ``conv_s2_gelu`` in interpret mode at
    tests/test_pallas.py:702's shapes, atol/rtol 1e-4 (float32 on both
    sides; sums in another order), and K11e's plain tap sum against JAX
    ``_conv2d_s2_taps`` at the same bound;
  * ``encoder_forward`` under each of the six stem modes against the JAX
    encoder under the same mode, features 2e-4 (the bound of
    tests/test_encoder.py:214), valid-token counts exact; on the CPU the JAX
    package runs "pallas" as ``lax.conv``, so that mode holds K11e's plain
    version to the reference conv;
  * the four TPU layout modes run the "conv" stem here, and under the
    merged modes a chunk's stem output still depends on that chunk alone;
  * greedy ``transcribe_batch(speculative="off")`` token-identical to the
    JAX package under each stem mode.

Tests marked ``cuda`` hold the kernel against its plain version on the GPU
(bf16 against the plain version over the same bf16 inputs: atol 2e-2 +
rtol 2e-2, the kernel's f32 sums in another order plus at most one bf16
ulp of the rounded conv output before the GELU) and skip without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import clips, configs, ids_of, models, numpy_params

from qwen3_asr_tpu_torch.models import encoder as tenc
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
from qwen3_asr_tpu_torch.ops.kernels.experiments import conv_stem as cs

STEM_MODES = ["conv", "taps", "pallas", "merged", "c512", "merged512"]
#: tests/test_pallas.py:702's (H, W, C, O).
PALLAS_SHAPES = [(64, 50, 16, 8), (32, 25, 8, 16), (10, 9, 4, 4)]


def _conv_inputs(H, W, C, O, seed=11):
    rng = np.random.default_rng(seed + H)
    x = rng.standard_normal((3, H, W, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, C, O))).astype(np.float32)
    b = (0.1 * rng.standard_normal((O,))).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("H,W,C,O", PALLAS_SHAPES)
def test_conv_s2_gelu_plain_matches_pallas(H, W, C, O):
    from qwen3_asr_tpu.ops.pallas.experiments.conv_stem import conv_s2_gelu as pallas_conv

    x, w, b = _conv_inputs(H, W, C, O)
    ref = np.asarray(pallas_conv(x, w, b, interpret=True))
    before = LAUNCHES["conv_s2_gelu"]
    out = cs.conv_s2_gelu(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert out.shape == ref.shape == (3, (H - 1) // 2 + 1, (W - 1) // 2 + 1, O)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    assert LAUNCHES["conv_s2_gelu"] == before      # the plain path never counts


@pytest.mark.parametrize("H,W,C,O", PALLAS_SHAPES)
def test_taps_match_jax_taps(H, W, C, O):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.encoder import _conv2d_s2_taps as jax_taps

    x, w, _ = _conv_inputs(H, W, C, O, seed=3)
    ref = np.asarray(jax_taps(jnp.asarray(x), jnp.asarray(w)))
    out = cs.conv2d_s2_taps_f32(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed=12)
    tparams, _ = params_from_jax(enc, dec)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, enc), tparams


@pytest.mark.parametrize("mode", STEM_MODES)
def test_encoder_forward_matches_jax_per_stem_mode(tiny, monkeypatch, mode):
    """Two clips of 8 chunks, one ending mid-chunk: the guard bands, the
    junk-position slicing and the partial chunk's valid count."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import encoder as jenc

    jcfg, tcfg, jparams, tparams = tiny
    rng = np.random.default_rng(2)
    T = 800
    nvf = np.array([800, 430], np.int32)
    mel = (0.3 * rng.standard_normal((2, 128, T))).astype(np.float32)
    mel = np.where(np.arange(T)[None, None, :] < nvf[:, None, None], mel, 0.0).astype(np.float32)
    monkeypatch.setattr(jenc, "CONV_STEM_MODE", mode)
    monkeypatch.setattr(tenc, "CONV_STEM_MODE", mode)
    ref, ref_n = jenc.encoder_forward(jparams, jcfg.audio_encoder, jnp.asarray(mel),
                                      jnp.asarray(nvf))
    out, n = tenc.encoder_forward(tparams, tcfg.audio_encoder, torch.from_numpy(mel),
                                  torch.from_numpy(nvf).long())
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mode", ["merged", "merged512"])
def test_merged_stem_no_cross_chunk_leakage(tiny, monkeypatch, mode):
    """Changing chunk 3's mel changes no other chunk's stem output."""
    _, tcfg, _, tparams = tiny
    monkeypatch.setattr(tenc, "CONV_STEM_MODE", mode)
    rng = np.random.default_rng(3)
    M = 8
    chunks = torch.from_numpy(
        (0.3 * rng.standard_normal((M, 1, 128, tcfg.audio_encoder.chunk_frames))).astype(np.float32)
    )
    base = tenc.conv_stem(tparams, chunks)
    poked = chunks.clone()
    poked[3] += 1.0
    changed = (tenc.conv_stem(tparams, poked) - base).abs().amax(dim=(1, 2))
    assert changed[3] > 1e-6
    assert torch.cat([changed[:3], changed[4:]]).max() == 0.0


@pytest.mark.parametrize("mode", ["taps", "merged", "c512", "merged512"])
def test_tpu_layout_stem_modes_run_the_conv_stem(tiny, monkeypatch, mode):
    """The JAX package's TPU layout rewrites are accepted and give exactly
    the "conv" stem's output, launching no kernel."""
    _, tcfg, _, tparams = tiny
    rng = np.random.default_rng(4)
    chunks = torch.from_numpy(
        (0.3 * rng.standard_normal((4, 1, 128, tcfg.audio_encoder.chunk_frames))).astype(np.float32)
    )
    ref = tenc.conv_stem(tparams, chunks)
    monkeypatch.setattr(tenc, "CONV_STEM_MODE", mode)
    before = LAUNCHES["conv_s2_gelu"]
    assert torch.equal(tenc.conv_stem(tparams, chunks), ref)
    assert LAUNCHES["conv_s2_gelu"] == before


@pytest.mark.parametrize("mode", STEM_MODES)
def test_transcribe_batch_token_identical_per_stem_mode(monkeypatch, mode):
    import jax

    from qwen3_asr_tpu.models import encoder as jenc

    monkeypatch.setattr(jenc, "CONV_STEM_MODE", mode)
    monkeypatch.setattr(tenc, "CONV_STEM_MODE", mode)
    jax.clear_caches()            # the JAX stem mode is read while tracing
    jax_model, port = models(seed=0, runtime={"speculative": "off"})
    audio = clips((1.0, 2.3, 5.1), seed=1)
    ref = ids_of(jax_model.transcribe_batch(audio, max_tokens=12))
    out = ids_of(port.transcribe_batch(audio, max_tokens=12))
    assert out == ref
    assert len({t for seq in out for t in seq}) > 3


# -- on the GPU: K11e against its plain version ---------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,O", [
    (3, 64, 50, 480, 480),        # conv2 of the 1.7B stem, N not a tile multiple
    (5, 32, 25, 480, 480),        # conv3: W = 25 -> 13
    (2, 10, 9, 64, 72),           # odd sizes, O not a multiple of the 240 tile
    (1, 7, 5, 8, 8),              # C = 8: one 16-byte chunk per tap
    (2, 11, 13, 480, 96),         # O = 96: one partial column tile; odd H, W
    (1, 15, 9, 480, 480),         # M = 40: one partial pixel tile
    (7, 33, 27, 96, 480),         # M = 7 * 17 * 14 = 1666, not a multiple of 128
])
def test_cuda_conv_s2_gelu_matches_plain(cuda, N, H, W, C, O):
    g = torch.Generator(device=cuda).manual_seed(N * H + W)
    x = torch.randn(N, H, W, C, generator=g, device=cuda).bfloat16()
    w = (0.05 * torch.randn(3, 3, C, O, generator=g, device=cuda)).bfloat16()
    b = 0.1 * torch.randn(O, generator=g, device=cuda)
    before = LAUNCHES["conv_s2_gelu"]
    out = cs.conv_s2_gelu(x, w, b)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_s2_gelu"] == before + 1
    ref = cs.conv_s2_gelu_plain(x, w, b)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_conv_s2_gelu_check_rejects_bad_inputs():
    """The kernel's input limits: C and O multiples of 8, bf16, 16-byte
    aligned, and pixel counts and image sides its int32 offsets and 16-bit
    packed window corners hold."""
    bf = torch.bfloat16
    x = torch.zeros(1, 6, 5, 16, dtype=bf)
    w = torch.zeros(3, 3, 16, 8, dtype=bf)
    b = torch.zeros(8)
    cs._check(x, w, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        cs._check(x[..., :12].contiguous(), w[:, :, :12].contiguous(), b)
    with pytest.raises(ValueError, match="multiples of 8"):
        cs._check(x, w[..., :4].contiguous(), b[:4])
    with pytest.raises(TypeError):
        cs._check(x.float(), w, b)
    with pytest.raises(ValueError, match="too many pixels"):
        cs._check(torch.zeros(1, 2**14, 1, 8, dtype=bf), w[:, :, :8].contiguous(), b)
    with pytest.raises(ValueError, match="too many pixels"):
        cs._check(torch.zeros(1, 1, 2**14, 8, dtype=bf), w[:, :, :8].contiguous(), b)
    flat = torch.zeros(6 * 5 * 16 + 8, dtype=bf)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cs._check(flat[1:1 + 6 * 5 * 16].view(1, 6, 5, 16), w, b)


@pytest.mark.cuda
def test_cuda_pallas_stem_matches_conv_stem(cuda, monkeypatch):
    """The "pallas" stem (K11e for conv2/conv3) against the "conv" stem
    (cuDNN) at the 1.7B widths, bf16: within bf16 rounding of the features."""
    from qwen3_asr_tpu_torch.config import AudioEncoderConfig

    cfg = AudioEncoderConfig()
    g = torch.Generator().manual_seed(0)
    params = {k: v.to(cuda) for k, v in
              tenc.init_encoder_params(cfg, g, torch.bfloat16).items() if k != "layers"}
    chunks = torch.randn(6, 1, 128, cfg.chunk_frames, generator=g).bfloat16().to(cuda)
    ref = tenc.conv_stem(params, chunks)
    monkeypatch.setattr(tenc, "CONV_STEM_MODE", "pallas")
    before = LAUNCHES["conv_s2_gelu"]
    out = tenc.conv_stem(params, chunks)
    assert LAUNCHES["conv_s2_gelu"] == before + 2
    rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel < 2e-2
