"""Weights of the PyTorch port: ``params_from_jax``, ``load_checkpoint`` on a
checkpoint written by the JAX package's ``save_checkpoint`` (exact
equality), seeded random init, and int8 weights: the port's quantizers on
converted weights equal the JAX quantizers' trees converted, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import configs, numpy_params

from qwen3_asr_tpu_torch.models.decoder import fuse_decoder_params
from qwen3_asr_tpu_torch.models.params import (
    load_checkpoint,
    params_from_jax,
    random_params,
)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed=21)
    return jcfg, tcfg, enc, dec


def test_params_from_jax_layout(jax_params):
    _, tcfg, enc, dec = jax_params
    enc_t, dec_t = params_from_jax(enc, dec)
    L = tcfg.audio_encoder.encoder_layers
    assert len(enc_t["layers"]) == L
    for i in range(L):
        for k, v in enc["layers"].items():
            np.testing.assert_array_equal(enc_t["layers"][i][k].numpy(), v[i])
    for i in (1, 2, 3):
        # HWIO (freq, time, in, out) -> OIHW (out, in, freq, time)
        np.testing.assert_array_equal(
            enc_t[f"conv{i}_w"].numpy(), np.transpose(enc[f"conv{i}_w"], (3, 2, 0, 1))
        )
    for k in ("conv_out", "proj1_w", "proj2_b", "ln_post_w"):
        np.testing.assert_array_equal(enc_t[k].numpy(), enc[k])
    np.testing.assert_array_equal(dec_t["embedding"].numpy(), dec["embedding"])
    for i in range(tcfg.text_decoder.num_hidden_layers):
        for k, v in dec["layers"].items():
            np.testing.assert_array_equal(dec_t["layers"][i][k].numpy(), v[i])


def test_params_from_jax_fused_layout_matches_port_fusion(jax_params):
    from qwen3_asr_tpu.models.decoder import fuse_decoder_params as jax_fuse

    _, _, enc, dec = jax_params
    fused_np = {k: (np.asarray(v) if not isinstance(v, dict) else v) for k, v in dec.items()}
    fused_np["layers"] = {
        k: np.asarray(v) for k, v in jax_fuse(dec)["layers"].items()
    }
    _, from_fused = params_from_jax(enc, fused_np)
    _, unfused = params_from_jax(enc, dec)
    ported = fuse_decoder_params(unfused)
    for a, b in zip(from_fused["layers"], ported["layers"]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_params_from_jax_bf16_and_dtype(jax_params):
    import jax.numpy as jnp

    _, _, enc, dec = jax_params
    dec_bf16 = {
        "embedding": np.asarray(jnp.asarray(dec["embedding"], jnp.bfloat16)),
        "final_norm": dec["final_norm"],
        "layers": dec["layers"],
    }
    _, dec_t = params_from_jax(enc, dec_bf16)
    assert dec_t["embedding"].dtype == torch.bfloat16
    expect = torch.from_numpy(dec["embedding"]).bfloat16()
    assert torch.equal(dec_t["embedding"], expect)
    enc_t, _ = params_from_jax(enc, dec, dtype=torch.bfloat16)
    assert enc_t["layers"][0]["wq"].dtype == torch.bfloat16


def test_load_checkpoint_from_jax_save_checkpoint(jax_params, tmp_path):
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.params import save_checkpoint

    _, tcfg, enc, dec = jax_params
    save_checkpoint(
        tmp_path,
        jax.tree_util.tree_map(jnp.asarray, enc),
        jax.tree_util.tree_map(jnp.asarray, dec),
    )
    enc_l, dec_l = load_checkpoint(tmp_path, tcfg, dtype=torch.float32)
    enc_t, dec_t = params_from_jax(enc, dec)
    for a, b in ((enc_l, enc_t), (dec_l, dec_t)):
        assert set(a) == set(b)
        for k in a:
            if k == "layers":
                for la, lb in zip(a[k], b[k]):
                    assert set(la) == set(lb)
                    for name in la:
                        assert torch.equal(la[name], lb[name]), name
            else:
                assert torch.equal(a[k], b[k]), k


def test_load_checkpoint_missing_file(tmp_path):
    _, tcfg = configs()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path, tcfg)


def test_random_params_seeded_and_shaped(jax_params):
    _, tcfg, enc, dec = jax_params
    e1, d1 = random_params(tcfg, seed=3, dtype=torch.float32)
    e2, d2 = random_params(tcfg, seed=3, dtype=torch.float32)
    e0, d0 = random_params(tcfg, seed=None, dtype=torch.float32)
    enc_t, dec_t = params_from_jax(enc, dec)
    assert torch.equal(d1["embedding"], d2["embedding"])
    assert not torch.equal(d1["layers"][0]["wq"], d1["layers"][1]["wq"])
    assert d0["embedding"].abs().sum() == 0
    assert torch.equal(d0["final_norm"], torch.ones_like(d0["final_norm"]))
    for ref, got in ((enc_t, e1), (dec_t, d1)):
        for k, v in ref.items():
            if k == "layers":
                for lr, lg in zip(v, got[k]):
                    assert {n: t.shape for n, t in lr.items()} == {n: t.shape for n, t in lg.items()}
            else:
                assert v.shape == got[k].shape, k
    std = d1["layers"][0]["wq"].std().item()
    assert 0.015 < std < 0.025


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("fused", [False, True])
def test_quantize_decoder_params_matches_jax(jax_params, fused):
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.decoder import fuse_decoder_params as jax_fuse
    from qwen3_asr_tpu.ops.quant import quantize_decoder_params as jax_quantize

    from qwen3_asr_tpu_torch.ops.quant import quantize_decoder_params

    _, _, enc, dec = jax_params
    dec_j = jax.tree_util.tree_map(jnp.asarray, dec)
    if fused:
        dec_j = jax_fuse(dec_j)
    ref = jax.tree_util.tree_map(np.asarray, jax_quantize(dec_j))
    _, dec_t = params_from_jax(enc, dec)
    if fused:
        dec_t = fuse_decoder_params(dec_t)
    port = quantize_decoder_params(dec_t)
    _, from_jax = params_from_jax(enc, ref)
    _assert_trees_equal(port, from_jax)
    assert port["embedding"]["q"].shape == (dec["embedding"].shape[1], dec["embedding"].shape[0])
    assert port["layers"][0]["ln1"].dtype == torch.float32


def test_quantize_encoder_params_matches_jax(jax_params):
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.quant import quantize_encoder_params as jax_quantize

    from qwen3_asr_tpu_torch.ops.quant import is_quantized, quantize_encoder_params

    _, _, enc, dec = jax_params
    ref = jax.tree_util.tree_map(np.asarray, jax_quantize(jax.tree_util.tree_map(jnp.asarray, enc)))
    enc_t, _ = params_from_jax(enc, dec)
    port = quantize_encoder_params(enc_t)
    from_jax, _ = params_from_jax(ref, dec)
    _assert_trees_equal(port, from_jax)
    for k in ("conv_out", "proj1_w", "proj2_w"):
        assert is_quantized(port[k])
    assert not is_quantized(port["conv1_w"]) and not is_quantized(port["layers"][0]["bq"])


def _quantized_leaves(tree, path=""):
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _quantized_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _quantized_leaves(v, f"{path}[{i}]")


def _assert_k_major(tree) -> int:
    """Every int8 ``q`` is the transpose of a contiguous (out, in) tensor,
    held in one storage of in x out bytes; returns how many there are."""
    n = 0
    for path, w in _quantized_leaves(tree):
        q = w["q"]
        assert q.dtype == torch.int8 and q.t().is_contiguous(), path
        assert q.untyped_storage().nbytes() == q.numel(), path
        n += 1
    return n


@pytest.mark.parametrize("fused", [False, True])
def test_int8_weights_k_major_from_every_source(jax_params, fused):
    """quantize_*_params, params_from_jax of the JAX package's quantized
    trees and Qwen3ASR._transform_params all store ``q`` K-major with the
    JAX package's values (torch.equal, so shape and values)."""
    import types

    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.decoder import fuse_decoder_params as jax_fuse
    from qwen3_asr_tpu.ops.quant import quantize_decoder_params as jax_qdec
    from qwen3_asr_tpu.ops.quant import quantize_encoder_params as jax_qenc

    from qwen3_asr_tpu_torch.api import Qwen3ASR
    from qwen3_asr_tpu_torch.config import RuntimeConfig
    from qwen3_asr_tpu_torch.ops.quant import quantize_decoder_params, quantize_encoder_params

    _, _, enc, dec = jax_params
    dec_j = jax.tree_util.tree_map(jnp.asarray, dec)
    if fused:
        dec_j = jax_fuse(dec_j)
    ref_dec = jax.tree_util.tree_map(np.asarray, jax_qdec(dec_j))
    ref_enc = jax.tree_util.tree_map(np.asarray, jax_qenc(jax.tree_util.tree_map(jnp.asarray, enc)))
    enc_j, dec_jq = params_from_jax(ref_enc, ref_dec)
    assert _assert_k_major(dec_jq) > 0 and _assert_k_major(enc_j) > 0
    for path, w in _quantized_leaves(dec_jq):
        assert w["q"].shape[0] * w["q"].shape[1] == w["q"].numel(), path

    enc_t, dec_t = params_from_jax(enc, dec)
    if fused:
        dec_t = fuse_decoder_params(dec_t)
    port_dec, port_enc = quantize_decoder_params(dec_t), quantize_encoder_params(enc_t)
    assert _assert_k_major(port_dec) == _assert_k_major(dec_jq)
    assert _assert_k_major(port_enc) == _assert_k_major(enc_j)
    ref_leaves = dict(_quantized_leaves(dec_jq))
    for pa, a in _quantized_leaves(port_dec):
        assert torch.equal(a["q"], ref_leaves[pa]["q"]), pa
        assert torch.equal(a["s"], ref_leaves[pa]["s"]), pa

    host = types.SimpleNamespace(_runtime=RuntimeConfig(
        quantization="int8", act_quant="int8", fuse_qkv=fused))
    enc_x, dec_x = Qwen3ASR._transform_params(host, *params_from_jax(enc, dec))
    assert _assert_k_major(dec_x) == _assert_k_major(port_dec)
    assert _assert_k_major(enc_x) == _assert_k_major(port_enc)
    port_leaves = dict(_quantized_leaves(port_dec))
    for pa, a in _quantized_leaves(dec_x):
        assert torch.equal(a["q"], port_leaves[pa]["q"]), pa
