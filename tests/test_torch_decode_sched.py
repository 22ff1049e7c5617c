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
    checks reject bad types, shapes and devices;
  * the schedule names exactly the tiles K11c's stream walks: for each lane,
    the 32-row tiles of its entries whose first row is below the entry's
    lim are cdiv(plen, 32) prompt tiles from row 0 and cdiv(dend - pb, 32)
    decode tiles from pb (plen and dend clamped as K11c clamps them), and
    the runs the CUDA kernel reads from the entries (its read_runs, mirrored
    here) give the same tiles; a schedule built for other lengths decides
    the plain version's output.

Tests marked ``cuda`` hold each kernel against its plain version on the GPU
(bf16 against the plain version in float32 over the same bf16 inputs: atol
2e-2 + rtol 2e-2, K2's bound), K11c and K11b at equal ends bit for bit,
K11d and K11c on the same inputs bit for bit (also on a schedule built for
other lengths than the ones passed), and skip without one.
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


def _entry_tiles(schedule, B: int, S: int) -> list[list[int]]:
    """Each lane's first rows of the 32-row tiles its live entries name, in
    entry order: tile k of an entry counts when off + 32 k < lim."""
    totals, bl, off, lim, _ = (t.numpy() for t in schedule)
    per_core = sc._per_core(schedule, S)
    tiles = [[] for _ in range(B)]
    for c in range(bl.shape[0]):
        for j in range(totals[c]):
            b = c * per_core + bl[c, j]
            tiles[b] += [off[c, j] + 32 * k for k in range(sc.BLOCK // 32)
                         if off[c, j] + 32 * k < lim[c, j]]
    return tiles


def _kernel_runs(schedule, B: int, S: int) -> list[tuple[int, int, int]]:
    """The (plen, pb, dend) of each lane as the CUDA kernel's read_runs
    takes them from the live entries: plen the lim of the lane's FIRST
    entry; pb and dend the off (down to a whole tile) and lim of the entry
    whose lim differs from its predecessor's; (0, S, S) where none does."""
    totals, bl, off, lim, flags = (t.numpy() for t in schedule)
    per_core = sc._per_core(schedule, S)
    runs = [[0, S, S] for _ in range(B)]
    for c in range(bl.shape[0]):
        for j in range(min(totals[c], bl.shape[1])):
            b = c * per_core + bl[c, j]
            if flags[c, j] & sc.F_FIRST:
                runs[b][0] = min(max(lim[c, j], 0), S)
            elif j > 0 and lim[c, j] != lim[c, j - 1]:
                pb = min(max(off[c, j], 0), S) // 32 * 32
                runs[b][1:] = [pb, min(max(lim[c, j], pb), S)]
    return [tuple(r) for r in runs]


def _stream_tiles(plen: int, pb: int, dend: int) -> list[int]:
    """The tiles the stream walks for one lane: cdiv(plen, 32) from row 0,
    then cdiv(dend - pb, 32) from pb."""
    return [32 * i for i in range(-(-plen // 32))] + [pb + 32 * i
                                                     for i in range(-(-(dend - pb) // 32))]


@pytest.mark.parametrize("case", ["random", "skew"])
@pytest.mark.parametrize("S,pb", [(640, 512), (5120, 4096)])
@pytest.mark.parametrize("B", [1, 6, 8, 64])
def test_schedule_names_the_stream_tiles(B, S, pb, case):
    """At the port's geometry (and the JAX test's, cores 2 x 3 lanes where
    B = 6): random per-lane ends with the last lane idle (prompt_len 0, end
    at the bucket), or one lane at S and the rest at the bucket.  Each
    lane's entries name exactly K11c's tiles on the clamped lengths, and
    the kernel's runs read from the entries walk the same tiles."""
    rng = np.random.default_rng(B * 7 + S + len(case))
    plen = rng.integers(0, pb + 1, B)
    dend = pb + rng.integers(0, S - pb + 1, B)
    if case == "skew":
        dend[:] = pb
        dend[0] = S
    elif B > 1:
        plen[-1], dend[-1] = 0, pb
    geometries = [sc.schedule_geometry(B, 8, sc.H100_SMS)]
    if B == 6:
        geometries.append((2, 3))
    for cores, per_core in geometries:
        sched = sc.build_decode_schedule(torch.from_numpy(plen.astype(np.int32)),
                                         torch.from_numpy(dend.astype(np.int32)), pb, S,
                                         cores, per_core, B)
        named = _entry_tiles(sched, B, S)
        runs = _kernel_runs(sched, B, S)
        for b in range(B):
            p = min(max(int(plen[b]), 1), pb)
            d = min(max(int(dend[b]), pb), S)
            want = _stream_tiles(p, pb, d)
            assert named[b] == want, (cores, per_core, b)
            assert _stream_tiles(*runs[b]) == want, (cores, per_core, b)
            assert runs[b][0] == p
            if d > pb:
                assert runs[b][1:] == (pb, d)


def test_sched_plain_follows_its_schedule():
    """A schedule built for other lengths than the ones passed decides the
    output: K11c's plain version on the schedule's lengths."""
    pb, S, B = 256, 640, 4
    t = [_bf16(a) for a in _inputs(2, B, 4, 2, S, seed=13)]
    plen = torch.tensor([90, 0, 256, 17], dtype=torch.int32)
    dend = torch.tensor([pb + 40, pb, S, pb + 300], dtype=torch.int32)
    plen2 = torch.tensor([3, 200, 128, 255], dtype=torch.int32)
    dend2 = torch.tensor([S, pb + 1, pb, pb + 129], dtype=torch.int32)
    sched = sc.build_decode_schedule(plen2, dend2, pb, S, 2, 2, B)
    out = sc.decode_attention_sched(*t, 1, plen, dend, pb, schedule=sched)
    want = h5.decode_attention_hbm5(*t, 1, plen2, dend2, pb)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert not torch.allclose(out, sc.decode_attention_sched(*t, 1, plen, dend, pb))


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


@pytest.mark.parametrize("B,G,case", [
    (1, 2, "random"), (1, 2, "idle"), (3, 1, "idle"), (6, 2, "idle"), (8, 4, "idle"),
    (5, 2, "skew"), (8, 1, "skew"), (9, 4, "skew"), (12, 2, "random"),
])
def test_hbm5_plain_matches_pallas_lane_cases(B, G, case):
    """The lane cases the GPU checks hold K11c to, at a small size: random
    per-lane ends with an idle lane (prompt_len 0, end at the bucket) last,
    or one lane at S and the rest at the prompt bucket.  atol 2e-2 where the
    idle lane attends two softmax terms, 5e-3 elsewhere."""
    pb, S, hkv = 256, 512, 2
    rng = np.random.default_rng(B * 10 + G)
    arrays = _inputs(2, B, G * hkv, hkv, S, seed=B + G)
    plen = rng.integers(1, pb + 1, B)
    dend = rng.integers(pb, S + 1, B)
    if case == "idle":
        plen[-1], dend[-1] = 0, pb
    if case == "skew":
        plen[:], dend[:] = pb, pb
        dend[0] = S
    _against_pallas("hbm5", arrays, 1, plen, dend, pb,
                    atol=2e-2 if case == "idle" else 5e-3)


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
                                    (40, 2560, 512), (96, 2560, 512)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,skew", [(1, 640, False), (6, 640, False), (8, 640, False),
                                      (96, 2560, False), (96, 2560, True), (8, 2560, True)])
def test_cuda_hbm5_lanes_against_plain(cuda, B, S, skew):
    """K11c with per-lane ends and an idle lane (or one lane at S and the
    rest at the prompt bucket) against its plain version; two calls give the
    same bits."""
    pb = 512
    q, kall, vall, k_new, v_new, plen, dend = _cuda_case(cuda, B, S, pb, 7 * B + S)
    if skew:
        dend[:] = pb
        dend[0] = S
    out = h5.decode_attention_hbm5(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    again = h5.decode_attention_hbm5(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = _plain_ref(q, kall, vall, k_new, v_new, 1, plen, dend, pb)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,G", [(1, 640, 2), (6, 640, 2), (8, 640, 2), (96, 2560, 1),
                                   (96, 2560, 2), (96, 2560, 4)])
def test_cuda_hbm5_equals_hbm3_at_equal_ends(cuda, B, S, G):
    """Every lane's end equal and every prompt length >= 1: K11c is K11b
    bit for bit (the same stream, the same tiles, the same folds)."""
    from qwen3_asr_tpu_torch.ops.kernels.experiments.decode_attention_hbm3 import (
        decode_attention_hbm3,
    )

    pb = 512
    g = torch.Generator(device=cuda).manual_seed(B * S + G)
    kall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    vall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    q = torch.randn(B, 8 * G, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=g, device=cuda).int()
    dend = pb + (S - pb) // 2
    ends = torch.full_like(plen, dend)
    lanes = h5.decode_attention_hbm5(q, kall, vall, k_new, v_new, 1, plen, ends, pb)
    shared = decode_attention_hbm3(q, kall, vall, k_new, v_new, 1, plen, ends[0], pb)
    torch.cuda.synchronize()
    assert torch.equal(lanes, shared)


def _sched_call(device, fresh, layer, plen, dend, pb, S, schedule_lengths=None):
    """K11d on the port's schedule geometry, its schedule built beforehand
    (for ``schedule_lengths`` = (plen, dend) when given)."""
    B, hkv = fresh[0].shape[0], fresh[1].shape[2]
    cores, per_core = sc.schedule_geometry(
        B, hkv, torch.cuda.get_device_properties(device).multi_processor_count)
    sp, sd = schedule_lengths or (plen, dend)
    sched = sc.build_decode_schedule(sp, sd, pb, S, cores, per_core, B)
    return sc.decode_attention_sched(*fresh, layer, plen, dend, pb, schedule=sched)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,skew,G", [
    (1, 640, False, 2), (1, 2560, False, 2), (6, 640, False, 2), (6, 2560, False, 2),
    (8, 640, False, 2), (8, 2560, False, 2), (96, 640, False, 2), (96, 2560, False, 2),
    (96, 2560, True, 2), (96, 2560, False, 1), (96, 2560, False, 4), (8, 640, False, 4),
])
def test_cuda_sched_equals_hbm5(cuda, B, S, skew, G):
    """K11d and K11c on the same inputs bit for bit, at chip_smoke's
    LANES_GRID (random per-lane ends and an idle lane, or one lane at S and
    the rest at the prompt bucket) and at G = 1 and 4: one stream, the same
    tiles of each lane, the same folds."""
    pb = 512
    q, kall, vall, k_new, v_new, plen, dend = _cuda_case(cuda, B, S, pb, 3 * B + S + G)
    if G != 2:
        q = torch.randn(B, 8 * G, 128, device=cuda).bfloat16()
    if skew:
        dend[:] = pb
        dend[0] = S
    if B > 1:
        dend[-1] = pb
    fresh = (q, kall, vall, k_new, v_new)
    before = LAUNCHES["decode_attention_sched"]
    out = _sched_call(cuda, fresh, 1, plen, dend, pb, S)
    lanes = h5.decode_attention_hbm5(*fresh, 1, plen, dend, pb)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention_sched"] == before + 1
    assert torch.equal(out, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(8, 640), (96, 2560)])
def test_cuda_sched_follows_its_schedule(cuda, B, S):
    """A schedule built for other prompt lengths and ends than the ones
    passed decides the walk: K11c's output on the schedule's lengths."""
    pb = 512
    q, kall, vall, k_new, v_new, plen, dend = _cuda_case(cuda, B, S, pb, 17 * B)
    g = torch.Generator(device=cuda).manual_seed(B + 1)
    plen2 = torch.randint(1, pb + 1, (B,), generator=g, device=cuda).int()
    dend2 = torch.randint(pb, S + 1, (B,), generator=g, device=cuda).int()
    fresh = (q, kall, vall, k_new, v_new)
    out = _sched_call(cuda, fresh, 0, plen, dend, pb, S, schedule_lengths=(plen2, dend2))
    want = h5.decode_attention_hbm5(*fresh, 0, plen2, dend2, pb)
    other = h5.decode_attention_hbm5(*fresh, 0, plen, dend, pb)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not torch.equal(out, other)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [
    lambda s: (s[0].long(), *s[1:]),                          # int64 totals
    lambda s: (s[0], s[1][:, :-1].contiguous(), *s[2:]),      # ragged rows
    lambda s: (s[0], s[1], s[2].t(), *s[3:]),                 # not (cores, J)
    lambda s: s[:4],                                          # four tensors
    lambda s: (s[0].cpu(), *s[1:]),                           # another device
    lambda s: (s[0][:1].contiguous(), s[1][:1].contiguous(), s[2][:1].contiguous(),
               s[3][:1].contiguous(), s[4][:1].contiguous()),  # too few lanes
])
def test_cuda_sched_refuses_malformed_schedule(cuda, bad):
    """The wrapper's _check_schedule (and the lane count) still refuse a
    malformed schedule on the card, before any launch."""
    pb, S, B = 512, 640, 4
    q, kall, vall, k_new, v_new, plen, dend = _cuda_case(cuda, B, S, pb, 23)
    sched = sc.build_decode_schedule(plen, dend, pb, S, 2, 2, B)
    before = LAUNCHES["decode_attention_sched"]
    with pytest.raises(ValueError):
        sc.decode_attention_sched(q, kall, vall, k_new, v_new, 0, plen, dend, pb,
                                  schedule=bad(sched))
    assert LAUNCHES["decode_attention_sched"] == before
