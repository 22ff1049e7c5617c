"""Kernels K11c (``decode_attention_hbm5``) and K11d
(``decode_attention_sched``) of the PyTorch port, and the schedule function
``build_decode_schedule``.

On the CPU:
  * ``build_decode_schedule`` equals the JAX function exactly, at
    tests/test_pallas.py:579-585's arguments (an idle lane, padded lanes)
    and at the port's own (cores, per_core) for B = 1, 8, 64;
  * each plain version against the Pallas kernel in interpret mode at
    tests/test_pallas.py's shapes (K11c :514-527 and :549-562, K11d
    :617-643 and :651-663): the Pallas kernel runs on the float32 inputs and
    rounds q * scale, K, V and the softmax weights to bf16 inside, so the
    plain version runs on the bf16-rounded inputs; atol 5e-3 (the bound
    tests/test_pallas.py holds the kernels to against its oracle), 2e-2 at
    :514-527, whose lane with prompt_len 1 attends two softmax terms only;
  * an idle lane (prompt_len 0) attends row 0 as the Pallas kernels do, and
    garbage (inf in dead K rows, finite values in dead V rows) does not leak
    into either plain version;
  * untileable shapes raise ValueError as in JAX, and the wrappers' input
    checks reject bad types, shapes and devices.

Tests marked ``cuda`` hold each kernel against its plain version on the GPU
(bf16 against the plain version in float32 over the same bf16 inputs: atol
2e-2 + rtol 2e-2, K2's bound) and skip without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm5 as h5
from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_sched as sc

PORT = {"hbm5": h5.decode_attention_hbm5, "sched": sc.decode_attention_sched}


def _pallas(kind):
    if kind == "hbm5":
        from qwen3_asr_tpu.ops.pallas.experiments.decode_attention_hbm5 import (
            decode_attention_hbm5 as fn,
        )
    else:
        from qwen3_asr_tpu.ops.pallas.experiments.decode_attention_sched import (
            decode_attention_sched as fn,
        )
    return fn


def _inputs(L, B, hq, hkv, S, seed, D=128):
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


def _ends(dend):
    """The decode end as each side takes it: a scalar or per lane."""
    import jax.numpy as jnp

    if np.ndim(dend) == 0:
        return jnp.int32(dend), int(dend)
    d = np.asarray(dend, np.int32)
    return jnp.asarray(d), torch.from_numpy(d)


def _against_pallas(kind, arrays, layer, plen, dend, pb, atol):
    import jax.numpy as jnp

    plen = np.asarray(plen, np.int32)
    jend, tend = _ends(dend)
    ref = np.asarray(_pallas(kind)(*arrays, jnp.int32(layer), jnp.asarray(plen), jend, pb,
                                   interpret=True))
    before = LAUNCHES[f"decode_attention_{kind}"]
    out = PORT[kind](*map(_bf16, arrays), layer, torch.from_numpy(plen), tend, pb)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)
    assert LAUNCHES[f"decode_attention_{kind}"] == before     # plain: not counted
    return out.numpy(), ref


# -- build_decode_schedule ----------------------------------------------------------


def _jax_schedule(plen, dend, pb, S, cores, per_core, B):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.experiments.decode_attention_sched import (
        build_decode_schedule,
    )

    jend = jnp.asarray(dend, jnp.int32)
    return [np.asarray(a) for a in build_decode_schedule(
        jnp.asarray(plen, jnp.int32), jend, pb, S, cores, per_core, B)]


def _torch_schedule(plen, dend, pb, S, cores, per_core, B):
    tend = torch.tensor(dend, dtype=torch.int32) if np.ndim(dend) else int(dend)
    got = sc.build_decode_schedule(torch.tensor(plen, dtype=torch.int32), tend, pb, S,
                                   cores, per_core, B)
    assert all(t.dtype == torch.int32 for t in got)
    return [t.numpy() for t in got]


def test_schedule_equals_jax_at_pallas_test_args():
    pb, S = 512, 1024
    plen = [100, 412, 37, 0, 512]
    dend = [pb, pb + 1, pb + 128, pb + 300, pb + 512]
    want = _jax_schedule(plen, dend, pb, S, 2, 3, 5)
    got = _torch_schedule(plen, dend, pb, S, 2, 3, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[0].tolist() == [8, 12]         # lane 3 (prompt_len 0) owns a prompt block


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("S,pb", [(640, 512), (5120, 4096)])
def test_schedule_equals_jax_at_port_geometry(B, S, pb):
    rng = np.random.default_rng(B + S)
    plen = rng.integers(0, pb + 1, B).tolist()
    dend = (pb + rng.integers(0, S - pb + 1, B)).tolist()
    cores, per_core = sc.schedule_geometry(B, 8, sc.H100_SMS)
    for ends in (dend, dend[0]):             # per lane, and one for every lane
        want = _jax_schedule(plen, ends, pb, S, cores, per_core, B)
        got = _torch_schedule(plen, ends, pb, S, cores, per_core, B)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("B,hkv,sms,want", [
    (1, 8, 132, (1, 1)), (8, 8, 132, (8, 1)), (64, 8, 132, (16, 4)),
    (40, 8, 132, (14, 3)), (6, 2, 132, (6, 1)), (96, 8, 132, (16, 6)),
])
def test_schedule_geometry(B, hkv, sms, want):
    cores, per_core = sc.schedule_geometry(B, hkv, sms)
    assert (cores, per_core) == want
    assert cores * per_core >= B > (cores - 1) * per_core     # no empty core
    assert cores * hkv <= max(sms, hkv)


def test_schedule_mask_is_the_clamped_two_interval_mask():
    pb, S, B = 256, 640, 6
    plen = torch.tensor([0, 1, 90, 256, 300, 128], dtype=torch.int32)
    dend = torch.tensor([pb, pb + 1, pb + 200, S, pb, pb + 128], dtype=torch.int32)
    sched = sc.build_decode_schedule(plen, dend, pb, S, 4, 2, B)
    slot = torch.arange(S)
    p = plen.clamp(1, pb)
    want = (slot[None] < p[:, None]) | ((slot[None] >= pb) & (slot[None] < dend[:, None]))
    assert torch.equal(sc.schedule_mask(sched, B, S), want)
    # A schedule fault shows on the CPU: drop lane 2's last entry.
    totals, bl, off, lim, flags = (t.clone() for t in sched)
    totals[1] -= 1
    assert not torch.equal(sc.schedule_mask((totals, bl, off, lim, flags), B, S), want)


# -- plain versions against the Pallas kernels --------------------------------------


def test_hbm5_plain_matches_pallas_per_lane_ends():
    arrays = _inputs(3, 8, 16, 8, 640, seed=0)
    _against_pallas("hbm5", arrays, 1, [100, 412, 37, 512, 1, 256, 300, 90],
                    [512, 513, 549, 640, 512, 640, 512, 523], 512, atol=2e-2)


@pytest.mark.parametrize("B", [1, 2, 4, 6])
def test_hbm5_plain_matches_pallas_small_batches(B):
    arrays = _inputs(2, B, 4, 2, 384, seed=7 + B)
    _against_pallas("hbm5", arrays, 0, [90, 200, 256, 1, 64, 130][:B], 256 + 64, 256,
                    atol=5e-3)


@pytest.mark.parametrize("dend", [512, 513, 549, 640, [512, 589, 640]])
def test_sched_plain_matches_pallas(dend):
    arrays = _inputs(3, 3, 16, 8, 640, seed=0)
    layer = 2 if np.ndim(dend) else 1
    _against_pallas("sched", arrays, layer, [100, 412, 37], dend, 512, atol=5e-3)


def test_sched_plain_matches_pallas_batch1():
    arrays = _inputs(2, 1, 4, 2, 384, seed=7)
    _against_pallas("sched", arrays, 0, [90], 256, 256, atol=5e-3)


@pytest.mark.parametrize("kind", ["hbm5", "sched"])
def test_idle_lane_attends_row_zero_as_pallas(kind):
    """prompt_len 0 clamps to 1 in both TPU kernels: the lane attends row 0
    and its fresh row, unlike K2 (the fresh row alone).  atol 2e-2, as
    tests/test_pallas.py:537-541 for its prompt_len-1 lane: two softmax
    terms average no bf16 rounding away."""
    pb = 256
    arrays = _inputs(2, 2, 4, 2, 384, seed=5)
    out, _ = _against_pallas(kind, arrays, 1, [0, 60], [pb, pb + 5], pb, atol=2e-2)
    t = [_bf16(a) for a in arrays]
    one = da.decode_attention_plain(*t, 1, torch.tensor([1, 60], dtype=torch.int32),
                                    torch.tensor([pb, pb + 5], dtype=torch.int32), pb,
                                    128 ** -0.5)
    np.testing.assert_allclose(out, one.numpy(), atol=1e-6)
    v_new = np.repeat(t[4][0, :, 0].numpy(), 2, axis=0)
    assert np.abs(out[0] - v_new).max() > 1e-2


@pytest.mark.parametrize("kind", ["hbm5", "sched"])
def test_plain_garbage_immunity(kind):
    """tests/test_pallas.py:667-693: inf in dead K rows and finite garbage
    in dead V rows change nothing."""
    pb = 512
    q, kall, vall, k_new, v_new = map(torch.from_numpy, _inputs(2, 2, 4, 2, 640, seed=9))
    plen = torch.tensor([90, 412], dtype=torch.int32)
    out_a = PORT[kind](q, kall, vall, k_new, v_new, 1, plen, pb + 10, pb)
    k2, v2 = kall.clone(), vall.clone()
    k2[:, 0, :, 90:pb] = float("inf")
    v2[:, 0, :, 90:pb] = -55.0
    k2[:, :, :, pb + 10:] = -44.0
    v2[:, :, :, pb + 10:] = 44.0
    k2[:, 1, :, 412:pb] = 33.0
    v2[:, 1, :, 412:pb] = -33.0
    out_b = PORT[kind](q, k2, v2, k_new, v_new, 1, plen, pb + 10, pb)
    assert torch.isfinite(out_b).all()
    np.testing.assert_allclose(out_a.numpy(), out_b.numpy(), atol=1e-5)


def test_sched_schedule_passed_in_equals_inline():
    pb, S, B = 256, 384, 3
    t = [_bf16(a) for a in _inputs(2, B, 4, 2, S, seed=3)]
    plen = torch.tensor([90, 0, 256], dtype=torch.int32)
    dend = torch.tensor([pb, pb + 100, S], dtype=torch.int32)
    sched = sc.build_decode_schedule(plen, dend, pb, S, 2, 2, B)
    inline = sc.decode_attention_sched(*t, 0, plen, dend, pb)
    given = sc.decode_attention_sched(*t, 0, plen, dend, pb, schedule=sched)
    assert torch.equal(inline, given)


# -- shapes and inputs the wrappers refuse ------------------------------------------


@pytest.mark.parametrize("kind,S,pb,kw", [
    ("sched", 640, 200, {}),                 # prompt bucket not a multiple of 128
    ("sched", 600, 512, {}),                 # decode region not a multiple of 128
    ("hbm5", 640, 256, {"block_p": 512}),    # block_p does not divide the bucket
    ("hbm5", 600, 512, {}),                  # decode region not a multiple of 128
])
def test_untileable_shapes_raise_as_jax(kind, S, pb, kw):
    import jax.numpy as jnp

    arrays = _inputs(1, 1, 4, 2, S, seed=1)
    plen = np.array([50], np.int32)
    with pytest.raises(ValueError):
        _pallas(kind)(*arrays, jnp.int32(0), jnp.asarray(plen), jnp.int32(pb), pb,
                      interpret=True, **kw)
    with pytest.raises(ValueError):
        PORT[kind](*map(torch.from_numpy, arrays), 0, torch.from_numpy(plen), pb, pb, **kw)


def test_prompt_block_rule():
    assert h5.prompt_block(512, 640) == 512
    assert h5.prompt_block(4096, 5120) == 512
    assert h5.prompt_block(256, 384) == 256
    assert h5.prompt_block(384, 512) == 128


def _schedule(B=2, S=384, pb=256):
    return sc.build_decode_schedule(torch.tensor([10] * B, dtype=torch.int32), pb + 3, pb,
                                    S, 1, B, B)


@pytest.mark.parametrize("bad", [
    lambda s: (s[0].long(), *s[1:]),                          # int64 totals
    lambda s: (s[0], s[1][:, :-1].contiguous(), *s[2:]),      # ragged rows
    lambda s: (s[0], s[1], s[2].t(), *s[3:]),                 # not (cores, J)
    lambda s: s[:4],                                          # four tensors
    lambda s: (s[0], s[1][:, :4].contiguous(), s[2][:, :4].contiguous(),
               s[3][:, :4].contiguous(), s[4][:, :4].contiguous()),  # J does not fit S
])
def test_schedule_check_rejects(bad):
    sched = _schedule()
    assert sc._check_schedule(sched, torch.device("cpu"), 384) == (1, 6)
    with pytest.raises(ValueError):
        sc._check_schedule(bad(sched), torch.device("cpu"), 384)
    with pytest.raises(ValueError):                           # another device
        sc._check_schedule(sched, torch.device("meta"), 384)


def test_decode_end_check_rejects():
    q = torch.zeros(2, 4, 128, dtype=torch.bfloat16)
    sc.check_ends(torch.zeros(2, dtype=torch.int32), q)
    for bad in (torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32)[::2], torch.zeros(2, dtype=torch.int32,
                                                                    device="meta")):
        with pytest.raises(ValueError):
            sc.check_ends(bad, q)
    assert sc.lane_ends(7, 3, "cpu").tolist() == [7, 7, 7]
    assert sc.lane_ends(torch.tensor(5, dtype=torch.int32), 2, "cpu").tolist() == [5, 5]


# -- on the GPU: K11c and K11d against their plain versions --------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _cuda_case(device, B, S, pb, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    kall = torch.randn(2, B, 8, S, 128, generator=g, device=device).bfloat16()
    vall = torch.randn(2, B, 8, S, 128, generator=g, device=device).bfloat16()
    q = torch.randn(B, 16, 128, generator=g, device=device).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=device).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=device).bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=g, device=device).int()
    dend = torch.randint(pb, S + 1, (B,), generator=g, device=device).int()
    if B > 1:
        plen[-1] = 0                          # an idle lane
    return q, kall, vall, k_new, v_new, plen, dend


def _plain_ref(q, kall, vall, k_new, v_new, layer, plen, dend, pb):
    return da.decode_attention_plain(
        q.float(), kall.float(), vall.float(), k_new.float(), v_new.float(), layer,
        plen.clamp(1, pb), dend, pb, 128 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hbm5", "sched"])
@pytest.mark.parametrize("B,S,pb", [(1, 640, 512), (6, 640, 512), (8, 640, 512),
                                    (40, 2560, 512)])
def test_cuda_matches_plain(cuda, kind, B, S, pb):
    q, kall, vall, k_new, v_new, plen, dend = _cuda_case(cuda, B, S, pb, B * S)
    name = f"decode_attention_{kind}"
    before = LAUNCHES[name]
    out = PORT[kind](q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    assert torch.isfinite(out.float()).all()
    ref = _plain_ref(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hbm5", "sched"])
def test_cuda_garbage_immunity(cuda, kind):
    pb, S = 512, 640
    q, kall, vall, k_new, v_new, plen, _ = _cuda_case(cuda, 8, S, pb, 11)
    plen[:] = 90
    dend = torch.full_like(plen, pb + 10)
    out_a = PORT[kind](q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    k2, v2 = kall.clone(), vall.clone()
    k2[:, :, :, 90:pb] = float("inf")
    v2[:, :, :, 90:pb] = -55.0
    k2[:, :, :, pb + 10:] = float("-inf")
    v2[:, :, :, pb + 10:] = 44.0
    out_b = PORT[kind](q, k2, v2, k_new, v_new, 1, plen, dend, pb)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b)


@pytest.mark.cuda
def test_cuda_sched_schedule_passed_in(cuda):
    pb, S, B = 512, 2560, 12
    q, kall, vall, k_new, v_new, plen, dend = _cuda_case(cuda, B, S, pb, 5)
    cores, per_core = sc.schedule_geometry(B, 8, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    sched = sc.build_decode_schedule(plen, dend, pb, S, cores, per_core, B)
    inline = sc.decode_attention_sched(q, kall, vall, k_new, v_new, 0, plen, dend, pb)
    given = sc.decode_attention_sched(q, kall, vall, k_new, v_new, 0, plen, dend, pb,
                                      schedule=sched)
    # Another split of the lanes over the cores: the same per-lane walk.
    other = sc.decode_attention_sched(
        q, kall, vall, k_new, v_new, 0, plen, dend, pb,
        schedule=sc.build_decode_schedule(plen, dend, pb, S, 2, 6, B))
    torch.cuda.synchronize()
    assert torch.equal(inline, given)
    assert torch.equal(inline, other)
    plain = sc.decode_attention_sched_plain(q.float(), kall.float(), vall.float(),
                                            k_new.float(), v_new.float(), 0, sched,
                                            128 ** -0.5)
    torch.testing.assert_close(given.float(), plain, atol=2e-2, rtol=2e-2)
