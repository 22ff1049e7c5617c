"""Int8 path of the PyTorch port against the JAX package.

Quantizers (weights, activations, KV rows) are held bit-exact against JAX,
all-zero rows and columns included.  K9 ``quantized_matmul``'s plain
version is held at rtol 1e-5 (float32) against the Pallas kernel in
interpret mode and against JAX ``qlinear``; K10 ``w8a8_matmul``'s plain
version exactly against JAX ``qlinear``'s W8A8 branch, since the integer
product is exact and the epilogue the same, and at rtol 1e-6 against the
Pallas kernel in interpret mode, which is 1 ulp off that branch itself on
a few percent of elements (the bound of ``tests/test_quant.py``).
The guard at the end checks that the int8 configuration really quantizes:
decode gets a ``{"q", "s"}`` cache and ``qlinear`` int8 weights.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import clips, models

from qwen3_asr_tpu_torch.ops import quant as tq
from qwen3_asr_tpu_torch.ops import quant_kv as tqkv
from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
from qwen3_asr_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul
from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul


def _weights(seed, shape, zero_col=True):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0
    return w


# -- quantizers: bit-exact ------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128), (256, 40), (7, 512)])
def test_quantize_weight_bit_exact(shape):
    from qwen3_asr_tpu.ops.quant import quantize_weight as jax_qw

    w = _weights(sum(shape), shape)
    ref = jax_qw(w)
    out = tq.quantize_weight(torch.from_numpy(w))
    assert out["q"].dtype == torch.int8 and out["s"].dtype == torch.float32
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(out["s"].numpy(), np.asarray(ref["s"]))
    assert out["s"][3] == 1.0                       # the all-zero column
    back = tq.dequantize_weight(out, torch.float32).numpy()
    assert np.all(np.abs(back - w) <= out["s"].numpy()[None, :] / 2 + 1e-6)


@pytest.mark.parametrize("shape", [(64, 128), (256, 40), (7, 512)])
def test_quantize_weight_k_major_one_storage(shape):
    """``q`` keeps the JAX package's (in, out) shape and values, stored as
    the transpose of a contiguous (out, in) tensor in one storage."""
    from qwen3_asr_tpu.ops.quant import quantize_weight as jax_qw

    w = _weights(sum(shape) + 1, shape)
    q = tq.quantize_weight(torch.from_numpy(w))["q"]
    assert q.shape == shape and q.t().is_contiguous()
    assert q.untyped_storage().nbytes() == shape[0] * shape[1]
    assert torch.equal(q, torch.from_numpy(np.array(jax_qw(w)["q"])))
    assert tq.k_major(q) is q


def test_qlinear_and_embedding_same_in_both_layouts():
    """The K-major layout computes what the (in, out) row-major layout
    computed: qlinear (weight-only and W8A8 plain versions) and the
    quantized embedding's lookup, bit for bit."""
    from qwen3_asr_tpu_torch.models.decoder import embed_tokens

    w = tq.quantize_weight(torch.from_numpy(_weights(5, (256, 384))))
    row_major = {"q": w["q"].contiguous(), "s": w["s"]}
    assert not torch.equal(torch.tensor(w["q"].stride()), torch.tensor(row_major["q"].stride()))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 7, 256)).astype(np.float32))
    assert torch.equal(tq.qlinear(x, w), tq.qlinear(x, row_major))
    with tq.act_quant_rows(1):
        assert torch.equal(tq.qlinear(x, w), tq.qlinear(x, row_major))
    emb = torch.from_numpy(_weights(7, (50, 256), zero_col=False))      # (V, H)
    qe = tq.quantize_weight(emb.T)                                        # q (H, V)
    params = {"embedding": qe, "final_norm": torch.ones(256)}
    old = {"embedding": {"q": qe["q"].contiguous(), "s": qe["s"]}, "final_norm": torch.ones(256)}
    ids = torch.tensor([[3, 0, 49], [7, 7, 12]])
    assert torch.equal(embed_tokens(params, ids), embed_tokens(old, ids))


def test_int8_wrappers_check_k_major():
    """The GPU wrappers' input check (run here on CPU tensors) refuses a
    row-major (K, N) weight and takes the K-major one without a copy."""
    from qwen3_asr_tpu_torch.ops.kernels import quantized_matmul as qm
    from qwen3_asr_tpu_torch.ops.kernels import w8a8_matmul as w8

    x = torch.zeros(8, 256, dtype=torch.bfloat16)
    w = tq.quantize_weight(torch.from_numpy(_weights(9, (256, 384))))
    qm._check(x, w["q"], w["s"], torch.bfloat16)
    w8._check(x, w["q"], w["s"], torch.float32)
    for check in (qm._check, w8._check):
        with pytest.raises(ValueError, match="K-major"):
            check(x, w["q"].contiguous(), w["s"], torch.bfloat16)


@pytest.mark.parametrize("M", [1, 3, 8, 9, 96, 128, 200, 448, 3584, 28672])
@pytest.mark.parametrize("K,N", [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048),
                                 (2048, 151936), (128, 16)])
def test_split_k_plan_covers_every_k_block_once(M, K, N):
    """K9's split-K plan: a row tile that holds all M <= 256 rows (or half
    of them from 128 on, where the tiles would fill less than half the
    card), ranges that cover every 64-deep k-block exactly once in
    increasing order (the order the kernel adds the partials), none empty,
    at least two blocks a range, and at most one block per SM."""
    from qwen3_asr_tpu_torch.ops.kernels import quantized_matmul as qm

    sms = 132
    nb, splits, per = qm.split_k_plan(M, N, K, sms)
    full = next(b for b in qm.ROW_TILES if b >= min(M, 256))
    assert nb == full or (full >= 128 and nb == full // 2)
    ranges = qm.k_ranges(K, splits, per)
    flat = [k for r in ranges for k in r]
    assert flat == list(range(K // qm.K_BLOCK))
    assert all(len(r) > 0 for r in ranges)
    units = -(-M // nb) * -(-N // qm.COL_TILE)
    k_blocks = K // qm.K_BLOCK
    if splits > 1:
        assert nb <= 64 and units * splits <= sms         # one block per SM at most
        assert all(len(r) >= 2 for r in ranges[:-1])
    elif nb <= 64 and k_blocks >= 4:
        assert 2 * units > sms                             # no room for a second range


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bit_exact(dtype):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.quant import quantize_activations as jax_qa

    rng = np.random.default_rng(5)
    x = rng.standard_normal((37, 256)).astype(np.float32) * 3.0
    x[4] = 0.0                                       # an all-zero row
    x[5, :8] = [0.5, -0.5, 1.5, 2.5, -2.5, 126.5, -127.0, 1e-3]
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qj, sj = jax_qa(xj)
    qt, st = tq.quantize_activations(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[4] == 1.0 and qt[4].eq(0).all()


def test_quantize_kv_bit_exact():
    from qwen3_asr_tpu.ops.quant_kv import dequantize_kv as jax_dq
    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jax_qkv

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 2, 40, 128)).astype(np.float32)
    x[1, 2, 0, 7] = 0.0                               # an all-zero row
    ref = jax_qkv(x)
    out = tqkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(out["s"].numpy(), np.asarray(ref["s"]))
    np.testing.assert_array_equal(
        tqkv.dequantize_kv(out, torch.float32).numpy(), np.asarray(jax_dq(ref, np.float32))
    )
    assert tqkv.is_quantized_kv(out) and tqkv.kv_seq_len(out) == 40
    assert tqkv.kv_seq_len(torch.from_numpy(x)) == 40


def test_quantize_kv_cache_per_layer_equals_whole():
    rng = np.random.default_rng(2)
    k = torch.from_numpy(rng.standard_normal((3, 2, 2, 16, 128)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 2, 2, 16, 128)).astype(np.float32))
    kq, vq = tqkv.quantize_kv_cache((k, v))
    for got, x in ((kq, k), (vq, v)):
        whole = tqkv.quantize_kv(x)
        assert torch.equal(got["q"], whole["q"]) and torch.equal(got["s"], whole["s"])


# -- K9: weight-only int8 matmul ------------------------------------------------


@pytest.mark.parametrize("M", [1, 3, 8, 40])
def test_quantized_matmul_plain_matches_pallas_and_qlinear(M):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.quant import qlinear as jax_qlinear
    from qwen3_asr_tpu.ops.quant import quantize_weight as jax_qw
    from qwen3_asr_tpu.ops.quant import quantized_matmul as jax_qmm

    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, 256)).astype(np.float32)).bfloat16().float()
    wj = jax_qw(_weights(M + 1, (256, 384)))
    wt = {"q": torch.from_numpy(np.asarray(wj["q"])), "s": torch.from_numpy(np.asarray(wj["s"]))}
    before = LAUNCHES["quantized_matmul"]
    out = quantized_matmul(x, wt["q"], wt["s"], torch.float32).numpy()
    assert LAUNCHES["quantized_matmul"] == before          # plain path never counts
    ref_kernel = np.asarray(jax_qmm(
        jnp.asarray(x.numpy(), jnp.bfloat16), wj["q"], wj["s"], block_n=128,
        block_k=128, out_dtype=jnp.float32, interpret=True,
    ))
    ref_qlinear = np.asarray(jax_qlinear(jnp.asarray(x.numpy()), wj, out_dtype=jnp.float32))
    atol = 1e-5 * np.abs(ref_kernel).max()
    np.testing.assert_allclose(out, ref_kernel, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(out, ref_qlinear, rtol=1e-5, atol=atol)


# -- K10: W8A8 matmul ---------------------------------------------------------


@pytest.mark.parametrize("M", [5, 37, 300])
def test_w8a8_matmul_plain_exact_vs_pallas_and_qlinear(M):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.w8a8_matmul import w8a8_matmul as jax_w8a8
    from qwen3_asr_tpu.ops.quant import act_quant_rows as jax_rows
    from qwen3_asr_tpu.ops.quant import qlinear as jax_qlinear
    from qwen3_asr_tpu.ops.quant import quantize_weight as jax_qw

    rng = np.random.default_rng(100 + M)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    x[1] = 0.0                                       # the zero-row case
    wj = jax_qw(_weights(M, (256, 384)))
    wq, ws = torch.from_numpy(np.asarray(wj["q"])), torch.from_numpy(np.asarray(wj["s"]))
    out = w8a8_matmul(torch.from_numpy(x), wq, ws, torch.float32).numpy()
    ref_kernel = np.asarray(jax_w8a8(
        x, wj["q"], wj["s"], block_m=16, block_n=128, block_k=128,
        out_dtype=jnp.float32, interpret=True,
    ))
    with jax_rows(1):
        ref_qlinear = np.asarray(jax_qlinear(jnp.asarray(x), wj, out_dtype=jnp.float32))
    np.testing.assert_array_equal(out, ref_qlinear)
    # The Pallas kernel in interpret mode is itself 1 ulp off JAX's jnp
    # W8A8 branch on a few percent of elements (its epilogue's rounding
    # differs), so it gets the bound of tests/test_quant.py:95.
    np.testing.assert_allclose(out, ref_kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out[1], 0.0)


def test_w8a8_zero_row_and_padding():
    """JAX's zero-row case (test_quant.py): zeros stay zero, a one-hot row
    meets the integer product exactly."""
    x = torch.zeros(5, 128)
    x[1] = 1.0
    out = w8a8_matmul(x, torch.ones(128, 128, dtype=torch.int8), torch.full((128,), 0.01),
                      torch.float32)
    assert out.shape == (5, 128)
    assert out[0].eq(0).all()
    torch.testing.assert_close(out[1], torch.full((128,), 127 * (1 / 127) * 0.01 * 128),
                               rtol=1e-6, atol=0)


# -- qlinear: the row gate ------------------------------------------------------


def test_qlinear_row_gate_picks_the_kernel(monkeypatch):
    from qwen3_asr_tpu_torch.ops import quant

    calls = []
    monkeypatch.setattr(quant, "w8a8_matmul", lambda *a: calls.append("w8a8") or torch.zeros(a[0].shape[0], 384))
    monkeypatch.setattr(quant, "quantized_matmul", lambda *a: calls.append("w8a16") or torch.zeros(a[0].shape[0], 384))
    w = tq.quantize_weight(torch.from_numpy(_weights(0, (256, 384))))
    x = torch.zeros(2, 10, 256)
    assert quant.qlinear(x, w).shape == (2, 10, 384)
    with quant.act_quant_rows(20):
        quant.qlinear(x, w)                           # 20 rows: W8A8
        quant.qlinear(x[:, :9], w)                    # 18 rows: weight-only
    with quant.act_quant_rows(None):
        quant.qlinear(x, w)
    assert calls == ["w8a16", "w8a8", "w8a16", "w8a16"]
    plain = torch.ones(256, 4)
    assert torch.equal(quant.qlinear(torch.ones(3, 256), plain), torch.full((3, 4), 256.0))


# -- the guard: the int8 configuration really runs int8 ---------------------------


def test_int8_config_really_quantizes(monkeypatch):
    """decode gets a {"q", "s"} cache, and qlinear sees int8 weights on both
    sides of the row gate (W8A8 in prefill, weight-only in decode)."""
    from qwen3_asr_tpu_torch.ops import quant
    from qwen3_asr_tpu_torch.runtime import generate

    _, port = models(seed=0, runtime=dict(
        quantization="int8", act_quant="int8", act_quant_min_rows=16,
        kv_cache_dtype="int8",
    ))
    seen = {"w8a8": [], "w8a16": [], "cache": []}
    real_w8a8, real_qmm = quant.w8a8_matmul, quant.quantized_matmul

    def spy_w8a8(x, wq, *a):
        seen["w8a8"].append((x.shape[0], wq.dtype))
        return real_w8a8(x, wq, *a)

    def spy_qmm(x, wq, *a):
        seen["w8a16"].append((x.shape[0], wq.dtype))
        return real_qmm(x, wq, *a)

    real_quantize = generate.quantize_kv_cache

    def spy_cache(kv):
        out = real_quantize(kv)
        seen["cache"].append(all(tqkv.is_quantized_kv(c) for c in out))
        return out

    monkeypatch.setattr(quant, "w8a8_matmul", spy_w8a8)
    monkeypatch.setattr(quant, "quantized_matmul", spy_qmm)
    monkeypatch.setattr(generate, "quantize_kv_cache", spy_cache)
    port.transcribe_batch(clips((1.0, 2.3, 5.1), seed=1), max_tokens=4)
    assert seen["cache"] == [True]
    assert seen["w8a8"] and all(dt == torch.int8 and m >= 16 for m, dt in seen["w8a8"])
    assert seen["w8a16"] and all(dt == torch.int8 for _, dt in seen["w8a16"])
    # Decode steps (M = 4 padded lanes) and the lm head stay weight-only.
    assert {m for m, _ in seen["w8a16"]} <= {4}
    assert tq.is_quantized(port._decoder_params["embedding"])
    assert tuple(port._decoder_params["embedding"]["q"].shape) == (64, 512)
    assert tq.is_quantized(port._encoder_params["layers"][0]["fc1_w"])
    assert not tq.is_quantized(port._encoder_params["conv1_w"])
