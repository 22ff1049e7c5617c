"""Kernel modules of the PyTorch port (K1 prefill flash attention, K2 decode
attention, K3 KV-row write, K4 decode attention over the int8 cache, K3 on
the int8 cache; K9 and K10 are in test_torch_quant.py, their GPU tests here).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels run in interpret mode on the same
numpy inputs.  Tolerances: K1 1e-5 (float32 throughout on both sides); K3
bit-exact; K2 1e-5 where the Pallas kernel's internal bf16 casts are exact
(zero queries: uniform weights over bf16-valued V rows, which pins the
two-interval mask, the layer offset and the self-term) and 5e-3 for random
queries against the plain version over bf16-rounded inputs, because the
Pallas kernel rounds q * scale, K, V and the softmax weights to bf16 even
for float32 inputs (decode_attention_hbm4.py:166, :199) -- the tolerance
tests/test_pallas.py holds it to.  K2's plain version is also held at
1e-4 against the JAX decoder's own float32 decode path in
test_torch_modules.py.  K4's plain version is held at 5e-3 against the
Pallas ``decode_attention_hbm4_q8`` (the bound of tests/test_quant_kv.py),
and the int8 row write bit-exact against JAX ``quantize_kv`` + the Pallas
``kv_write_rows``.

Tests marked ``cuda`` compare each CUDA kernel with its plain version on
the GPU and skip without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES, _build
from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da_mod
from qwen3_asr_tpu_torch.ops.kernels import flash_attention as fa_mod
from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw_mod
from qwen3_asr_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from qwen3_asr_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_causal,
    flash_attention_causal_plain,
)
from qwen3_asr_tpu_torch.ops.kernels.kv_write import (
    kv_write_rows,
    kv_write_rows_batch,
    kv_write_rows_plain,
)


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """float32 values that bf16 represents exactly."""
    return torch.from_numpy(x).bfloat16().float().numpy()


# -- K1: prefill flash attention ----------------------------------------------


@pytest.mark.parametrize("T", [64, 200, 256])
def test_flash_plain_matches_pallas(T):
    from qwen3_asr_tpu.ops.pallas.flash_attention import flash_attention_causal as pallas_fa

    rng = np.random.default_rng(T)
    B, hq, hkv, D = 2, 4, 2, 128
    q = rng.standard_normal((B, hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, hkv, T, D)).astype(np.float32)
    ref = np.asarray(pallas_fa(q, k, v, interpret=True))
    before = LAUNCHES["flash_attention_causal"]
    out = flash_attention_causal(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert LAUNCHES["flash_attention_causal"] == before   # plain path never counts


def test_flash_plain_is_causal():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 128)).astype(np.float32))
               for _ in range(3))
    a = flash_attention_causal_plain(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 30:] = 50.0
    v2[:, :, 30:] = -50.0
    b = flash_attention_causal_plain(q, k2, v2)
    torch.testing.assert_close(a[:, :, :30], b[:, :, :30], atol=1e-6, rtol=0)


# -- K2: decode attention -----------------------------------------------------


def _decode_inputs(seed, B=3, L=2, hq=4, hkv=2, S=384, D=128, zero_q=False):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, hq, D), np.float32) if zero_q else rng.standard_normal((B, hq, D)).astype(np.float32)
    kall = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    vall = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, 1, D)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, 1, D)).astype(np.float32)
    return [_bf16_exact(x) for x in (q, kall, vall, k_new, v_new)]


def _pallas_decode(q, kall, vall, k_new, v_new, layer, plen, dend, pb):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.decode_attention_hbm4 import decode_attention_hbm4

    return np.asarray(decode_attention_hbm4(
        q, kall, vall, k_new, v_new, jnp.int32(layer),
        jnp.asarray(plen, jnp.int32), jnp.asarray(dend, jnp.int32), pb,
        interpret=True,
    ))


def _plain_decode(q, kall, vall, k_new, v_new, layer, plen, dend, pb):
    t = [torch.from_numpy(x) for x in (q, kall, vall, k_new, v_new)]
    return decode_attention(
        *t, layer, torch.tensor(plen, dtype=torch.int32),
        torch.tensor(dend, dtype=torch.int32), pb,
    ).numpy()


#: The valid-row edge cases of the GPU kernel's bulk-copy tiles (32 rows),
#: at _decode_inputs' S = 384 and prompt_bucket 256: (prompt_len, decode_end
#: - prompt_bucket) per lane.  An idle lane (prompt_len 0, decode_end ==
#: prompt_bucket); runs shorter than one tile; run lengths that are no
#: multiple of a tile, with decode_end == S.
DECODE_EDGE_CASES = {
    "idle-lane": ([0, 250, 37], [0, 37, 1]),
    "short-runs": ([3, 1, 5], [2, 1, 0]),
    "ragged-runs": ([77, 33, 250], [45, 101, 128]),
}


def _decode_case(case, pb):
    """(prompt_len, decode_end) of a parametrised case: an int is the
    decode_end offset of every lane at prompt lengths 100, 250, 37."""
    if isinstance(case, int):
        return [100, 250, 37], [pb + case] * 3
    plen, offs = DECODE_EDGE_CASES[case]
    return plen, [pb + o for o in offs]


def _hold_decode(out, ref, plen, dend, pb, v_new, atol):
    """Live lanes against the Pallas kernel; an idle lane attends its fresh
    row alone (the Pallas kernel reads one clamped row there, and the caller
    discards that lane)."""
    idle = [b for b, (p, e) in enumerate(zip(plen, dend)) if p == 0 and e == pb]
    live = [b for b in range(len(plen)) if b not in idle]
    np.testing.assert_allclose(out[live], ref[live], atol=atol, rtol=0)
    for b in idle:
        group = out.shape[1] // v_new.shape[1]
        np.testing.assert_allclose(out[b], np.repeat(v_new[b, :, 0], group, axis=0), atol=1e-6)


@pytest.mark.parametrize("case", [0, 1, 37, 128, *DECODE_EDGE_CASES])
def test_decode_plain_matches_pallas_exact_weights(case):
    pb = 256
    inputs = _decode_inputs(case if isinstance(case, int) else len(case), zero_q=True)
    plen, dend = _decode_case(case, pb)
    ref = _pallas_decode(*inputs, 1, plen, dend, pb)
    out = _plain_decode(*inputs, 1, plen, dend, pb)
    _hold_decode(out, ref, plen, dend, pb, inputs[4], 1e-5)


@pytest.mark.parametrize("case", [1, 100, *DECODE_EDGE_CASES])
def test_decode_plain_matches_pallas_random_queries(case):
    pb = 256
    if isinstance(case, int):
        inputs = _decode_inputs(10 + case)
        plen, dend = [100, 250, 37], [pb + case, pb + case // 2, pb]
    else:
        inputs = _decode_inputs(20 + len(case))
        plen, dend = _decode_case(case, pb)
    ref = _pallas_decode(*inputs, 0, plen, dend, pb)
    out = _plain_decode(*inputs, 0, plen, dend, pb)
    _hold_decode(out, ref, plen, dend, pb, inputs[4], 5e-3)


def test_decode_plain_ignores_invalid_rows():
    """Garbage in the prompt padding and beyond decode_end must not leak."""
    pb = 256
    q, kall, vall, k_new, v_new = _decode_inputs(3)
    plen, dend = [90, 200, 10], [pb + 5, pb + 5, pb]
    a = _plain_decode(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    k2, v2 = kall.copy(), vall.copy()
    for b, p in enumerate(plen):
        k2[:, b, :, p:pb] = 40.0
        v2[:, b, :, p:pb] = -40.0
        k2[:, b, :, dend[b]:] = -30.0
        v2[:, b, :, dend[b]:] = 30.0
    b_out = _plain_decode(q, k2, v2, k_new, v_new, 1, plen, dend, pb)
    np.testing.assert_allclose(a, b_out, atol=1e-6, rtol=0)


def test_decode_idle_lane_is_finite():
    """plen 0 and decode_end == prompt_bucket: the self-term alone."""
    pb = 256
    q, kall, vall, k_new, v_new = _decode_inputs(4, B=2)
    out = _plain_decode(q, kall, vall, k_new, v_new, 0, [0, 17], [pb, pb + 3], pb)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], np.repeat(v_new[0, :, 0], 2, axis=0), atol=1e-6)


def test_arrival_counters_are_cached_and_grown():
    """The kernel's ticket counters: one zeroed buffer per scratch owner
    and device (``_build.scratch``), handed to every call that fits, grown
    (the old one kept alive) when a batch needs more."""
    cpu = torch.device("cpu")
    owner = _build.Scratch()
    with _build.scratch_scope(owner):
        a = da_mod.arrival_counters(cpu, 8 * 8)
        assert a.dtype == torch.int32 and a.numel() >= 64 and not a.any()
        assert da_mod.arrival_counters(cpu, 96 * 8) is a
        big = da_mod.arrival_counters(cpu, a.numel() + 1)
        assert big.numel() > a.numel() and not big.any()
        assert da_mod.arrival_counters(cpu, 1) is big
    assert owner.pool(cpu)["arrival_counters"] == [a, big]


@pytest.mark.parametrize("S,q8,ptrs,ok", [
    (640, True, (0, 256, 512, 1024), True),
    (700, True, (0, 16, 32, 48), True),    # 700 % 4 == 0
    (642, False, (0, 4096), True),         # the bf16 cache takes any S
    (642, True, (0, 16, 32, 48), False),   # a scale run's aligned superset leaves the lane
    (641, True, (0, 16, 32, 48), False),
    (640, False, (0, 8), False),           # a bulk copy needs 16-byte addresses
    (640, True, (0, 16, 4, 48), False),
])
def test_check_bulk_copies(S, q8, ptrs, ok):
    if ok:
        da_mod.check_bulk_copies(S, q8, ptrs)
    else:
        with pytest.raises(ValueError):
            da_mod.check_bulk_copies(S, q8, ptrs)


def test_decode_split_count():
    assert da_mod.split_count(1, 8, 640, 132) == 10     # capped by rows / 64
    assert da_mod.split_count(8, 8, 640, 132) == 5      # ~2 blocks per SM
    assert da_mod.split_count(96, 8, 2560, 132) == 1
    assert da_mod.split_count(1, 8, 100_000, 132) == 33


# -- K3: KV-row write ---------------------------------------------------------


@pytest.mark.parametrize("slot", [0, 5, 63])
def test_kv_write_rows_bit_exact_vs_pallas(slot):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.kv_write import kv_write_rows as pallas_write

    rng = np.random.default_rng(slot)
    cache = rng.standard_normal((2, 3, 2, 64, 128)).astype(np.float32)
    rows = rng.standard_normal((2, 3, 2, 1, 128)).astype(np.float32)
    ref = np.asarray(pallas_write(jnp.asarray(cache), jnp.asarray(rows), jnp.int32(slot), interpret=True))
    out = kv_write_rows(torch.from_numpy(cache.copy()), torch.from_numpy(rows),
                        torch.tensor(slot, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kv_write_rows_batch_bit_exact_vs_pallas():
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.kv_write import kv_write_rows_batch as pallas_write

    rng = np.random.default_rng(7)
    cache = rng.standard_normal((2, 3, 2, 64, 128)).astype(np.float32)
    rows = rng.standard_normal((2, 3, 2, 1, 128)).astype(np.float32)
    slots = np.array([3, 40, 63], np.int32)
    ref = np.asarray(pallas_write(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(slots), interpret=True
    ))
    out = kv_write_rows_batch(
        torch.from_numpy(cache.copy()), torch.from_numpy(rows), torch.from_numpy(slots)
    )
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kv_write_rows_in_place():
    cache = torch.zeros(1, 2, 1, 8, 128)
    rows = torch.ones(1, 2, 1, 1, 128)
    out = kv_write_rows(cache, rows, torch.tensor(6, dtype=torch.int32))
    assert out is cache
    assert cache[:, :, :, 6].eq(1).all() and cache.sum() == 2 * 128


# -- K4: decode attention over the int8 cache; K3 on the int8 cache ---------------


@pytest.mark.parametrize("dend_off", [0, 1, 37])
def test_decode_q8_plain_matches_pallas(dend_off):
    """At tests/test_quant_kv.py:118's shapes and bound (atol 5e-3), plus
    one idle lane (prompt_len 0, decode_end == prompt_bucket)."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.decode_attention_hbm4 import decode_attention_hbm4_q8
    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jax_qkv

    from qwen3_asr_tpu_torch.ops.kernels.decode_attention import decode_attention_q8

    L, B, hq, hkv, S, D, pb = 2, 4, 4, 2, 640, 128, 512
    rng = np.random.default_rng(40 + dend_off)
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    kall = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    vall = rng.standard_normal((L, B, hkv, S, D)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, 1, D)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, 1, D)).astype(np.float32)
    plen = np.array([100, 412, 37, 0], np.int32)
    dend = np.array([pb + dend_off] * 3 + [pb], np.int32)
    kq, vq = jax_qkv(kall), jax_qkv(vall)
    ref = np.asarray(decode_attention_hbm4_q8(
        q, kq, vq, k_new, v_new, jnp.int32(1), plen, dend, pb, interpret=True,
    ))

    def t(tree):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}

    out = decode_attention_q8(
        torch.from_numpy(q), t(kq), t(vq), torch.from_numpy(k_new),
        torch.from_numpy(v_new), 1, torch.from_numpy(plen), torch.from_numpy(dend), pb,
    ).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:3], ref[:3], atol=5e-3, rtol=0)
    # The idle lane attends the self-term alone (the Pallas wrapper reads one
    # clamped row there, and the caller discards that lane).
    np.testing.assert_allclose(out[3], np.repeat(v_new[3, :, 0], 2, axis=0), atol=1e-6)


@pytest.mark.parametrize("per_lane", [False, True])
def test_kv_write_q8_bit_exact_vs_pallas(per_lane):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.kv_write import kv_write_rows as pallas_write
    from qwen3_asr_tpu.ops.pallas.kv_write import kv_write_rows_batch as pallas_write_batch
    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jax_qkv

    from qwen3_asr_tpu_torch.ops.kernels.kv_write import kv_write_rows_q8

    rng = np.random.default_rng(11 + per_lane)
    L, B, H, S = 2, 3, 2, 64
    cache = jax_qkv(rng.standard_normal((L, B, H, S, 128)).astype(np.float32))
    rows = rng.standard_normal((L, B, H, 1, 128)).astype(np.float32)
    rows[1, 2, 0] = 0.0                                # an all-zero row
    slots = np.array([3, 40, 63], np.int32) if per_lane else np.full(3, 17, np.int32)
    qr = jax_qkv(rows)
    if per_lane:
        ref_q = pallas_write_batch(cache["q"], qr["q"], jnp.asarray(slots), interpret=True)
    else:
        ref_q = pallas_write(cache["q"], qr["q"], jnp.int32(17), interpret=True)
    ref_s = np.asarray(cache["s"]).copy()
    for b in range(B):
        ref_s[:, b, :, slots[b]] = np.asarray(qr["s"])[:, b, :, 0]
    out = kv_write_rows_q8(
        {"q": torch.from_numpy(np.array(cache["q"])), "s": torch.from_numpy(np.array(cache["s"]))},
        torch.from_numpy(rows), torch.from_numpy(slots),
    )
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(out["s"].numpy(), ref_s)


# -- wrapper checks and the build -----------------------------------------------


def test_wrapper_checks_reject_bad_inputs():
    bf = torch.bfloat16
    q = torch.zeros(1, 4, 8, 128, dtype=bf)
    kv = torch.zeros(1, 2, 8, 128, dtype=bf)
    fa_mod._check(q, kv, kv)
    with pytest.raises(TypeError):
        fa_mod._check(q.float(), kv, kv)
    with pytest.raises(ValueError):
        fa_mod._check(torch.zeros(1, 4, 8, 64, dtype=bf), kv[..., :64], kv[..., :64])
    with pytest.raises(ValueError):
        fa_mod._check(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)

    cache = torch.zeros(2, 3, 2, 16, 128, dtype=bf)
    rows = torch.zeros(2, 3, 2, 1, 128, dtype=bf)
    kw_mod._check(cache, rows, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kw_mod._check(cache, rows, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        kw_mod._check(cache, rows[:, :2], torch.zeros(3, dtype=torch.int32))

    qd = torch.zeros(3, 4, 128, dtype=bf)
    new = torch.zeros(3, 2, 1, 128, dtype=bf)
    i32 = torch.zeros(3, dtype=torch.int32)
    da_mod._check(qd, cache, cache, new, new, 1, i32, i32)
    with pytest.raises(ValueError):
        da_mod._check(qd, cache, cache, new, new, 2, i32, i32)       # layer
    with pytest.raises(ValueError):
        da_mod._check(torch.zeros(3, 6, 128, dtype=bf), cache, cache, new, new, 0, i32, i32)
    with pytest.raises(TypeError):
        da_mod._check(qd, cache.float(), cache, new, new, 0, i32, i32)


def test_flash_check_rejects_misaligned_inputs():
    """The kernel loads q, k and v by TMA, which needs 16-byte-aligned bases."""
    bf = torch.bfloat16
    kv = torch.zeros(1, 2, 8, 128, dtype=bf)
    flat = torch.zeros(1 * 4 * 8 * 128 + 8, dtype=bf)
    q = flat[1:1 + 4 * 8 * 128].view(1, 4, 8, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_mod._check(q, kv, kv)
    fa_mod._check(flat[8:].view(1, 4, 8, 128), kv, kv)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_library_path_tracks_sources(monkeypatch, tmp_path):
    (tmp_path / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    (tmp_path / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("grad_mode,requires,raises", [
    ("enabled", True, True), ("no_grad", True, False), ("inference", True, False),
    ("enabled", False, False),
])
def test_refuse_autograd(grad_mode, requires, raises):
    """The guard the ctypes kernels' wrappers call before a launch: it raises
    only where autograd would record the call (grad enabled and an input
    requiring grad), since the kernel's output would carry no gradient."""
    import contextlib

    x = torch.ones(4, requires_grad=requires)
    mode = {"enabled": contextlib.nullcontext(), "no_grad": torch.no_grad(),
            "inference": torch.inference_mode()}[grad_mode]
    with mode:
        if raises:
            with pytest.raises(RuntimeError, match="no backward"):
                _build.refuse_autograd("k", torch.ones(2), x, None)
        else:
            _build.refuse_autograd("k", torch.ones(2), x, None)


# -- on the GPU: each kernel against its plain version -----------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _cuda_flash_case(cuda, B, hq, hkv, T):
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + T * 10 + hq // hkv)
    q = torch.randn(B, hq, T, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(B, hkv, T, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(B, hkv, T, 128, generator=g, device=cuda).bfloat16()
    before = LAUNCHES["flash_attention_causal"]
    out = flash_attention_causal(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_causal"] == before + 1
    ref = flash_attention_causal_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(16, 8), (8, 8)])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 77, 448, 1088])
def test_cuda_flash_matches_plain(cuda, T, hq, hkv):
    """Ragged T inside a 64-row tile and across tiles; a GQA pair per KV head
    (Hq/Hkv = 2) and two query tiles per KV head (Hq == Hkv)."""
    _cuda_flash_case(cuda, 2, hq, hkv, T)


@pytest.mark.cuda
@pytest.mark.parametrize("B,hq,hkv,T", [
    (64, 16, 8, 448),     # 3584 work items: every block walks ~27
    (3, 6, 2, 200),       # Hq/Hkv = 3: the last pair's second unit idles
    (5, 4, 4, 130),       # Hq == Hkv with an odd tile count: an idle unit
])
def test_cuda_flash_tile_loop_wraps(cuda, B, hq, hkv, T):
    """More work items than blocks, so each persistent block's loop wraps
    (snake order), with idle units in the mix."""
    _cuda_flash_case(cuda, B, hq, hkv, T)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 640), (8, 2560), (5, 700)])
def test_cuda_decode_matches_plain(cuda, B, S):
    g = torch.Generator(device=cuda).manual_seed(B * S)
    pb = 512
    kall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    vall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    q = torch.randn(B, 16, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    plen = torch.randint(0, pb + 1, (B,), generator=g, device=cuda).int()
    dend = torch.randint(pb, S + 1, (B,), generator=g, device=cuda).int()
    out = decode_attention(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    ref = decode_attention_plain(
        q.float(), kall.float(), vall.float(), k_new.float(), v_new.float(),
        1, plen, dend, pb, 128 ** -0.5,
    )
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_cuda_kv_write_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    cache = torch.randn(4, 3, 8, 96, 128, generator=g, device=cuda).bfloat16()
    rows = torch.randn(4, 3, 8, 1, 128, generator=g, device=cuda).bfloat16()
    slots = torch.tensor([0, 50, 95], dtype=torch.int32, device=cuda)
    out = kv_write_rows_batch(cache.clone(), rows, slots)
    assert torch.equal(out, kv_write_rows_plain(cache.clone(), rows, slots))
    out = kv_write_rows(cache.clone(), rows, torch.tensor(7, dtype=torch.int32, device=cuda))
    assert torch.equal(out, kv_write_rows_plain(cache.clone(), rows, torch.full_like(slots, 7)))


# -- on the GPU: the int8 kernels (K4, K9, K10, K3 int8) against their plain versions


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (1, 2048, 4096), (8, 2048, 2048), (17, 6144, 2048), (96, 2048, 12288),
    (300, 256, 1040), (8, 2048, 151936),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantized_matmul_matches_plain(cuda, M, K, N, out_dtype):
    from qwen3_asr_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul

    g = torch.Generator(device=cuda).manual_seed(M * N + K)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    # K-major, as quantize_weight stores it: (N, K) contiguous, transposed.
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8).t()
    s = torch.rand(N, generator=g, device=cuda) * 1e-3
    before = LAUNCHES["quantized_matmul"]
    out = quantized_matmul(x, wq, s, out_dtype)
    assert LAUNCHES["quantized_matmul"] == before + 1
    ref = x.float() @ (wq.float() * s)         # f32 reference of the same function
    tol = 1e-5 * ref.abs().max().item()
    rtol = 1e-5 if out_dtype == torch.float32 else 8e-3
    assert out.dtype == out_dtype
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (3584, 2048, 4096), (3584, 6144, 2048), (3328, 7680, 1024), (37, 256, 384),
    (200, 1024, 1040),
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_w8a8_matmul_bit_exact_vs_plain(cuda, M, K, N, out_dtype):
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul, w8a8_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    x[1] = 0                                  # an all-zero row: scale 1, output 0
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8).t()
    ws = torch.rand(N, generator=g, device=cuda) * 1e-3
    out = w8a8_matmul(x, wq, ws, out_dtype)
    ref = w8a8_matmul_plain(x, wq, ws, out_dtype)
    assert torch.equal(out, ref)
    assert out[1].eq(0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 96, 128, 448])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantized_matmul_deterministic(cuda, M, out_dtype):
    """Split K (wo and wd at decode) and the row tiles past 256 rows: within
    the f32 product's tolerance, and two identical calls bit-identical
    (the partial sums are added in a fixed order)."""
    from qwen3_asr_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul

    for K, N in ((2048, 2048), (6144, 2048)):
        g = torch.Generator(device=cuda).manual_seed(M + K)
        x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
        wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8).t()
        s = torch.rand(N, generator=g, device=cuda) * 1e-3
        out = quantized_matmul(x, wq, s, out_dtype)
        assert torch.equal(out, quantized_matmul(x, wq, s, out_dtype))
        ref = x.float() @ (wq.float() * s)
        rtol = 1e-5 if out_dtype == torch.float32 else 8e-3
        torch.testing.assert_close(out.float(), ref, atol=1e-5 * ref.abs().max().item(),
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 64, 16), (77, 192, 272), (130, 320, 4112),
                                   (513, 1088, 1040)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_w8a8_ragged_bit_exact(cuda, M, K, N, out_dtype):
    """Ragged M with zero rows, a column edge (N % 256 != 0) and K a
    multiple of 64 but not of 128: bit-exact against the plain version."""
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul, w8a8_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(M * 7 + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    x[::5] = 0
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8).t()
    ws = torch.rand(N, generator=g, device=cuda) * 1e-3
    out = w8a8_matmul(x, wq, ws, out_dtype)
    assert torch.equal(out, w8a8_matmul_plain(x, wq, ws, out_dtype))
    assert out[::5].eq(0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(1, 64), (300, 1024), (3584, 2048), (33, 7680)])
def test_cuda_quantize_rows_bit_exact(cuda, M, K):
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import quantize_activations, quantize_rows

    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = (torch.randn(M, K, generator=g, device=cuda) * 3).bfloat16()
    x[M // 2] = 0
    xq, sx = quantize_rows(x)
    rq, rs = quantize_activations(x)
    assert torch.equal(xq, rq) and torch.equal(sx, rs)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "quantized_matmul", "w8a8_matmul", "conv_s2_gelu"])
def test_cuda_wrappers_refuse_autograd(cuda, kernel):
    """K1, K9, K10 and K11e raise on inputs that require grad (their output
    would have no ``grad_fn``), launch nothing, and run under ``no_grad``."""
    from qwen3_asr_tpu_torch.ops.kernels.experiments.conv_stem import conv_s2_gelu
    from qwen3_asr_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul
    from qwen3_asr_tpu_torch.ops.quant import quantize_weight

    bf = torch.bfloat16
    if kernel == "flash":
        name, fn = "flash_attention_causal", flash_attention_causal
        args = [torch.randn(1, 2, 64, 128, device=cuda, dtype=bf) for _ in range(3)]
    elif kernel == "conv_s2_gelu":
        name, fn = kernel, conv_s2_gelu
        args = [torch.randn(2, 16, 16, 8, device=cuda, dtype=bf),
                torch.randn(3, 3, 8, 16, device=cuda, dtype=bf), torch.zeros(16, device=cuda)]
    else:
        name = kernel
        fn = quantized_matmul if kernel == "quantized_matmul" else w8a8_matmul
        w = quantize_weight(torch.randn(256, 384, device=cuda))
        args = [torch.randn(8, 256, device=cuda, dtype=bf), w["q"], w["s"]]
    args[0].requires_grad_(True)
    before = LAUNCHES[name]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    assert LAUNCHES[name] == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1


@pytest.mark.cuda
def test_cuda_int8_wrappers_reject_row_major_weights(cuda):
    """The TMA kernels take only the K-major layout and never copy a
    weight: a (K, N) row-major int8 tensor raises."""
    from qwen3_asr_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import w8a8_matmul

    x = torch.randn(8, 256, device=cuda).bfloat16()
    wq = torch.zeros(256, 384, dtype=torch.int8, device=cuda)
    s = torch.ones(384, device=cuda)
    with pytest.raises(ValueError, match="K-major"):
        quantized_matmul(x, wq, s)
    with pytest.raises(ValueError, match="K-major"):
        w8a8_matmul(x, wq, s)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 640), (8, 2560), (5, 700)])
def test_cuda_decode_q8_matches_plain(cuda, B, S):
    from qwen3_asr_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_q8,
        decode_attention_q8_plain,
    )
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    g = torch.Generator(device=cuda).manual_seed(B * S + 1)
    pb = 512
    kall = quantize_kv(torch.randn(2, B, 8, S, 128, generator=g, device=cuda))
    vall = quantize_kv(torch.randn(2, B, 8, S, 128, generator=g, device=cuda))
    q = torch.randn(B, 16, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    plen = torch.randint(0, pb + 1, (B,), generator=g, device=cuda).int()
    dend = torch.randint(pb, S + 1, (B,), generator=g, device=cuda).int()
    before = LAUNCHES["decode_attention_q8"]
    out = decode_attention_q8(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    assert LAUNCHES["decode_attention_q8"] == before + 1
    ref = decode_attention_q8_plain(
        q.float(), kall, vall, k_new.float(), v_new.float(), 1, plen, dend, pb,
        128 ** -0.5,
    )
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


#: (B, S, prompt_len, decode_end - 512) at prompt_bucket 512 for K2/K4's
#: bulk-copy tiles of 32 rows; None: random lengths.
CUDA_DECODE_EDGES = {
    "idle-lane": (3, 640, [0, 100, 0], [0, 88, 0]),
    "short-runs": (2, 640, [5, 0], [3, 1]),            # fewer rows than one tile
    "ragged-runs": (3, 640, [77, 333, 511], [45, 101, 127]),
    "dend-is-S": (2, 2560, [512, 1], [2048, 2048]),
    "B96-S2560": (96, 2560, None, None),
}


def _cuda_decode_edge(cuda, case, q8):
    from qwen3_asr_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_q8,
        decode_attention_q8_plain,
    )
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    B, S, plen, offs = CUDA_DECODE_EDGES[case]
    pb = 512
    g = torch.Generator(device=cuda).manual_seed(B * S + q8)
    shape = (2, B, 8, S, 128)
    k32 = torch.randn(shape, generator=g, device=cuda)
    v32 = torch.randn(shape, generator=g, device=cuda)
    kall, vall = (quantize_kv(k32), quantize_kv(v32)) if q8 else (k32.bfloat16(), v32.bfloat16())
    del k32, v32
    q = torch.randn(B, 16, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    if plen is None:
        plen = torch.randint(0, pb + 1, (B,), generator=g, device=cuda).int()
        dend = torch.randint(pb, S + 1, (B,), generator=g, device=cuda).int()
    else:
        plen = torch.tensor(plen, dtype=torch.int32, device=cuda)
        dend = pb + torch.tensor(offs, dtype=torch.int32, device=cuda)
    name = "decode_attention_q8" if q8 else "decode_attention"
    fn = decode_attention_q8 if q8 else decode_attention
    before = LAUNCHES[name]
    out = fn(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    assert LAUNCHES[name] == before + 1
    again = fn(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    assert LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    if q8:
        ref = decode_attention_q8_plain(q.float(), kall, vall, k_new.float(), v_new.float(),
                                        1, plen, dend, pb, 128 ** -0.5)
    else:
        ref = decode_attention_plain(q.float(), kall[1:].float(), vall[1:].float(),
                                     k_new.float(), v_new.float(), 0, plen, dend, pb,
                                     128 ** -0.5)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_DECODE_EDGES))
def test_cuda_decode_edge_cases(cuda, case):
    """K2 at the ring's edge cases: held to the plain version, two identical
    calls bit-identical, one launch a call."""
    _cuda_decode_edge(cuda, case, q8=False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_DECODE_EDGES))
def test_cuda_decode_q8_edge_cases(cuda, case):
    """K4 as test_cuda_decode_edge_cases, with the scale runs' aligned
    supersets starting and ending mid-lane."""
    _cuda_decode_edge(cuda, case, q8=True)


@pytest.mark.cuda
def test_cuda_decode_q8_rejects_unaligned_cache_len(cuda):
    from qwen3_asr_tpu_torch.ops.kernels.decode_attention import decode_attention_q8
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    S = 642
    kall = quantize_kv(torch.randn(1, 1, 8, S, 128, device=cuda))
    q = torch.randn(1, 16, 128, device=cuda).bfloat16()
    new = torch.randn(1, 8, 1, 128, device=cuda).bfloat16()
    ends = torch.tensor([512], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        decode_attention_q8(q, kall, kall, new, new, 0, ends - 500, ends, 512)


@pytest.mark.cuda
def test_cuda_kv_write_q8_bit_exact_vs_plain(cuda):
    from qwen3_asr_tpu_torch.ops.kernels.kv_write import kv_write_rows_q8, kv_write_rows_q8_plain
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    g = torch.Generator(device=cuda).manual_seed(3)
    L, B, H, S = 28, 8, 8, 640
    cache = quantize_kv(torch.randn(L, B, H, S, 128, generator=g, device=cuda))
    rows = torch.randn(L, B, H, 1, 128, generator=g, device=cuda).bfloat16()
    rows[0, 0, 0] = 0                             # an all-zero row: scale 1
    for slots in (torch.full((B,), 600, dtype=torch.int32, device=cuda),
                  torch.randint(512, S, (B,), generator=g, device=cuda).int()):
        out = kv_write_rows_q8({k: v.clone() for k, v in cache.items()}, rows, slots)
        ref = kv_write_rows_q8_plain({k: v.clone() for k, v in cache.items()}, rows, slots)
        assert torch.equal(out["q"], ref["q"]) and torch.equal(out["s"], ref["s"])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, 4, 8])
def test_cuda_kv_write_span_bit_exact_vs_plain(cuda, T):
    """K5 at the verify pass's shapes (L=28, B=8, S=640): per-lane slots,
    two lanes whose span runs past S (rows there dropped) and one lane
    wholly past the end."""
    from qwen3_asr_tpu_torch.ops.kernels.kv_write import (
        kv_write_span_batch,
        kv_write_span_batch_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(T)
    L, B, H, S = 28, 8, 8, 640
    cache = torch.randn(L, B, H, S, 128, generator=g, device=cuda).bfloat16()
    rows = torch.randn(L, B, H, T, 128, generator=g, device=cuda).bfloat16()
    slots = torch.tensor([512, 513, 530, 600, 601, S - T + 1, S - 1, S + 3],
                         dtype=torch.int32, device=cuda)
    before = LAUNCHES["kv_write_span_batch"]
    out = kv_write_span_batch(cache.clone(), rows, slots)
    assert LAUNCHES["kv_write_span_batch"] == before + 1
    ref = kv_write_span_batch_plain(cache.clone(), rows, slots)
    assert torch.equal(out, ref)
    assert torch.equal(out[:, 7], cache[:, 7])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, 4, 8])
def test_cuda_kv_write_span_pair_bit_exact_vs_plain(cuda, T):
    """K5 on both caches in one launch, at the verify pass's shapes: lanes
    inside, two whose span runs past S and one wholly past the end; each
    cache bit-exact against the plain version, dropped rows untouched."""
    from qwen3_asr_tpu_torch.ops.kernels.kv_write import (
        kv_write_span_pair,
        kv_write_span_pair_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(10 + T)
    L, B, H, S = 28, 8, 8, 640
    caches = [torch.randn(L, B, H, S, 128, generator=g, device=cuda).bfloat16()
              for _ in range(2)]
    rows = [torch.randn(L, B, H, T, 128, generator=g, device=cuda).bfloat16() for _ in range(2)]
    slots = torch.tensor([512, 513, 530, 600, 601, S - T + 1, S - 1, S + 3],
                         dtype=torch.int32, device=cuda)
    before = LAUNCHES["kv_write_span_batch"]
    out = kv_write_span_pair(*(c.clone() for c in caches), *rows, slots)
    assert LAUNCHES["kv_write_span_batch"] == before + 1
    ref = kv_write_span_pair_plain(*(c.clone() for c in caches), *rows, slots)
    for o, r, c in zip(out, ref, caches):
        assert torch.equal(o, r)
        assert torch.equal(o[:, 7], c[:, 7])
        assert torch.equal(o[:, 6, :, : S - 1], c[:, 6, :, : S - 1])
