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
  * the wrappers' one decode end a 0-d (or (1,)) int32 tensor, against the
    Pallas kernels at ends from Pb to S, and the shared-slot K3's slot one
    too, against the Pallas writer at the cache's edges; a host int, a
    per-lane (B,) end and a non-int32 end refused;
  * one split decode step under modes "3" and "4" against the JAX decoder
    (which runs its XLA attention on the CPU), 1e-4 as
    tests/test_torch_modules.py; per-lane write slots keep K2 under both
    modes; "0" runs (the plain attention: the "auto" step on the CPU), an
    unknown mode and a shape no block size tiles raise ValueError;
  * greedy ``transcribe_batch(speculative="off")`` token-identical to the
    JAX package under modes "3" and "4", and so at blocks of 1, 3 and 8:
    the modes' loop runs in blocks with one look at ``done`` a block, its
    end and slot 0-d tensors, and K2 never runs.

Tests marked ``cuda`` hold each kernel against its plain version on the GPU
(bf16 against the plain version in float32 over the same bf16 inputs: atol
2e-2 + rtol 2e-2, K2's bound; the kernels round q * scale, p and the
self-term products to bf16 where the plain version keeps f32), K11a to
K11b bit for bit (one stream under two names), a captured launch reading
the end its tensor holds at each replay, and the graphed modes loop's ids
bit-identical to the eager loop's; they skip without one.
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


def _end(value: int, device=None) -> torch.Tensor:
    """The one decode end (or shared slot) as the wrappers take it: a 0-d
    int32 tensor on the inputs' device."""
    return torch.tensor(value, dtype=torch.int32, device=device)


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
    out = PORT[kind](*map(_bf16, arrays), layer, torch.from_numpy(plen), _end(pb + doff), pb,
                     block_k=128)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-3, rtol=0)
    assert LAUNCHES[f"decode_attention_{kind}"] == before     # plain: not counted


#: Decode ends of the device-end case against Pallas, as offsets from Pb:
#: the prompt bucket itself (no decode row), one row, a middle, S.
END_OFFSETS = (0, 1, 37, 256)


@pytest.mark.parametrize("doff", END_OFFSETS)
@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_device_end_matches_pallas(kind, doff):
    """The wrappers take their one decode end as a 0-d int32 tensor (the
    plain loop's, computed on the device) or a (1,) one, and match the
    Pallas kernel, which reads it by scalar prefetch, at ends from Pb to S
    (atol 5e-3, as :func:`test_plain_matches_pallas`)."""
    import jax.numpy as jnp

    L, B, hq, hkv, S, pb, plen, _, layer, seed = CASES["B=3"]
    arrays = _inputs(L, B, hq, hkv, S, 128, seed + doff)
    plen = np.asarray(plen, np.int32)
    ref = np.asarray(_pallas(kind)(
        *arrays, jnp.int32(layer), jnp.asarray(plen), jnp.int32(pb + doff), pb,
        block_k=128, interpret=True,
    ))
    inputs = (*map(_bf16, arrays), layer, torch.from_numpy(plen))
    out = PORT[kind](*inputs, _end(pb + doff), pb, block_k=128)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-3, rtol=0)
    one = PORT[kind](*inputs, _end(pb + doff).reshape(1), pb, block_k=128)
    assert torch.equal(one, out)


@pytest.mark.parametrize("bad,err", [
    (256, TypeError),                                              # a host int
    (torch.tensor([256, 256], dtype=torch.int32), ValueError),     # a per-lane (B,) end
    (torch.tensor(256), ValueError),                               # int64
    (torch.tensor(256.0), ValueError),
])
@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_wrappers_refuse_a_host_or_per_lane_end(kind, bad, err):
    """K11a/K11b take one int32 end tensor, nothing else (``check_end``,
    before the CPU branch too); the shared-slot K3 takes one int32 slot."""
    from qwen3_asr_tpu_torch.ops.kernels.experiments.decode_attention_hbm2 import check_end
    from qwen3_asr_tpu_torch.ops.kernels.kv_write import kv_write_rows

    arrays = _inputs(1, 2, 4, 2, 256, 128, 2)
    with pytest.raises(err):
        PORT[kind](*map(torch.from_numpy, arrays), 0, torch.tensor([5, 9], dtype=torch.int32),
                   bad, 128)
    with pytest.raises(err):
        check_end(bad, torch.device("cpu"))
    with pytest.raises(err):
        kv_write_rows(torch.zeros(1, 2, 2, 8, 128), torch.zeros(1, 2, 2, 1, 128), bad)


@pytest.mark.parametrize("slot", [0, 128, 255, 300])
def test_shared_slot_write_takes_a_device_slot(slot):
    """``kv_write_rows`` with its slot a 0-d int32 tensor, expanded to
    the lanes on the device, against the Pallas ``kv_write_rows`` in
    interpret mode, which reads its slot by scalar prefetch: bit-identical
    at the prompt bucket, the last slot and the first and last of the
    cache (a slot past S drops the rows in both)."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas.kv_write import kv_write_rows as pallas_write

    from qwen3_asr_tpu_torch.ops.kernels.kv_write import kv_write_rows

    rng = np.random.default_rng(slot)
    cache = rng.standard_normal((2, 3, 2, 256, 128)).astype(np.float32)
    rows = rng.standard_normal((2, 3, 2, 1, 128)).astype(np.float32)
    out = kv_write_rows(torch.from_numpy(cache.copy()), torch.from_numpy(rows), _end(slot))
    if slot < 256:
        ref = np.asarray(pallas_write(jnp.asarray(cache), jnp.asarray(rows), jnp.int32(slot),
                                      interpret=True))
    else:
        ref = cache
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_idle_lane_is_the_self_term(kind):
    import jax.numpy as jnp

    pb = 128
    arrays = _inputs(2, 2, 4, 2, 256, 128, 5)
    plen = np.array([0, 60], np.int32)
    ref = np.asarray(_pallas(kind)(
        *arrays, jnp.int32(1), jnp.asarray(plen), jnp.int32(pb), pb, interpret=True,
    ))
    out = PORT[kind](*map(torch.from_numpy, arrays), 1, torch.from_numpy(plen), _end(pb),
                     pb).numpy()
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
        PORT[kind](*map(torch.from_numpy, arrays), 0, torch.from_numpy(plen), _end(pb), pb)


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

    for mode in ("1", "2", "x"):
        monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
        with pytest.raises(ValueError, match="'auto', '5', '4', '3', '0'"):
            step(256)
    # "0" runs: the plain attention, the same step as "auto" on the CPU.
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", "auto")
    h_auto, kv_auto = step(256)
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", "0")
    h_plain, kv_plain = step(256)
    assert torch.equal(h_plain, h_auto)
    assert all(torch.equal(a, b) for a, b in zip(kv_plain, kv_auto))
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


@pytest.fixture(scope="module")
def modes_pair():
    """(JAX token ids of the smoke-like batch, port model): the plain loop
    with 128-row token buckets, so that every cache length tiles."""
    jax_model, port = models(seed=0, runtime={"speculative": "off",
                                              "token_buckets": (128, 256)})
    return ids_of(jax_model.transcribe_batch(clips((1.0, 2.3, 5.1), seed=1), max_tokens=12)), port


@pytest.mark.parametrize("block", [1, 3, 8])
@pytest.mark.parametrize("mode", ["3", "4"])
def test_modes_loop_runs_in_blocks_token_identical_to_jax(modes_pair, monkeypatch, mode, block):
    """Under decode modes "3"/"4" the loop on CPU tensors runs in blocks
    of ``graphs.BLOCK`` with one look at ``done`` a block (the plain
    version of the graphed loop; no host step, no per-step look) and the
    JAX package's tokens; K11a/K11b (their plain versions) take the one
    decode end and K3 the one slot as 0-d tensors, and K2 never runs."""
    from qwen3_asr_tpu_torch.runtime import graphs

    ref, port = modes_pair
    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    monkeypatch.setattr(graphs, "BLOCK", block)
    ends, slots = [], []
    kernel = "decode_attention_hbm2" if mode == "3" else "decode_attention_hbm3"
    real, real_write = getattr(tdec, kernel), tdec.kv_write_rows

    def spy(*a, **k):
        ends.append(a[7])
        return real(*a, **k)

    def spy_write(cache, rows, slot):
        slots.append(slot)
        return real_write(cache, rows, slot)

    def never(*a, **k):
        raise AssertionError("K2 ran in the plain loop under a scalar-end mode")

    monkeypatch.setattr(tdec, kernel, spy)
    monkeypatch.setattr(tdec, "kv_write_rows", spy_write)
    monkeypatch.setattr(tdec, "decode_attention", never)
    out = ids_of(port.transcribe_batch(clips((1.0, 2.3, 5.1), seed=1), max_tokens=12))
    assert out == ref
    gen = port._generator
    steps, replays = gen.last_decode_steps, gen.last_replays
    assert replays % block == 0 and steps <= replays < steps + block
    assert gen.last_host_syncs == replays // block + 1
    if block > 1:
        assert gen.last_host_syncs < steps
    assert ends and all(e.dim() == 0 and e.dtype == torch.int32 for e in ends)
    assert slots and all(t.dim() == 0 and t.dtype == torch.int32 for t in slots)


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
    out = PORT[kind](q, kall, vall, k_new, v_new, 1, plen, _end(dend, cuda), pb,
                     block_k=block_k)
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
    args = (q, kall, vall, k_new, v_new, 1, plen, _end(pb + dend_off, cuda), pb)
    a, b = decode_attention_hbm2(*args), decode_attention_hbm3(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["3", "4"])
def test_cuda_graphed_modes_loop_equals_eager(cuda, monkeypatch, mode):
    """The plain loop under decode modes "3"/"4" on the card replays a
    captured graph (``_graphed``; fewer looks at ``done`` than live steps)
    whose ids are bit-identical to ``decode(eager=True)``'s from the same
    prefill; the graph holds K11a/K11b a layer and the standalone K3 twice
    (K and V), never K2."""
    from qwen3_asr_tpu_torch import RuntimeConfig
    from qwen3_asr_tpu_torch.models.decoder import fuse_decoder_params, init_decoder_params
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    monkeypatch.setattr(tdec, "DECODE_KERNEL_MODE", mode)
    tc = configs()[1].text_decoder
    params = fuse_decoder_params(init_decoder_params(
        tc, torch.Generator(device=cuda).manual_seed(0), torch.bfloat16, cuda))
    gen = Generator(params, tc, RuntimeConfig(speculative="off"))
    B, P, tb = 4, 256, 128
    rng = np.random.default_rng(B)
    plen = rng.integers(40, P, B)
    ids = torch.from_numpy(rng.integers(1, tc.vocab_size, (B, P))).to(cuda)
    feats = torch.from_numpy(rng.standard_normal((B, 64, tc.hidden_size)).astype(np.float32))
    kv, logits = gen.prefill(feats.to(cuda, torch.bfloat16), ids,
                             torch.full((B,), 30, device=cuda),
                             torch.from_numpy(plen).to(cuda), P + tb, arena=True)
    assert gen._graphed(cuda, False)
    kw = dict(repetition_penalty=1.1, seed=5)
    eager = gen.decode(kv, logits, plen.tolist(), [40] * B, tb, eager=True, **kw)
    steps = gen.last_decode_steps
    graphed = gen.decode(kv, logits, plen.tolist(), [40] * B, tb, **kw)
    assert graphed == eager and gen.graphs.captures == 1
    assert gen.last_decode_steps == steps and gen.last_host_syncs < steps
    per = gen.graphs.get(gen.last_bucket)[1].launches
    kernel = "decode_attention_hbm2" if mode == "3" else "decode_attention_hbm3"
    assert per[kernel] == tc.num_hidden_layers and per["kv_write_rows"] == 2
    assert "decode_attention" not in per
    gen.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hbm2", "hbm3"])
def test_cuda_end_read_at_each_replay(cuda, kind):
    """One launch captured as a CUDA graph takes the decode end its end
    tensor holds at each replay: bit-identical to an eager launch at that
    end, from Pb to S."""
    B, S, pb = 8, 640, 512
    g = torch.Generator(device=cuda).manual_seed(3)
    kall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    vall = torch.randn(2, B, 8, S, 128, generator=g, device=cuda).bfloat16()
    q = torch.randn(B, 16, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, 8, 1, 128, generator=g, device=cuda).bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=g, device=cuda).int()
    end = _end(S, cuda)
    args = (q, kall, vall, k_new, v_new, 1, plen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PORT[kind](*args, end, pb)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PORT[kind](*args, end, pb)
    for value in (pb, pb + 1, pb + 64, S):
        end.fill_(value)
        graph.replay()
        assert torch.equal(out, PORT[kind](*args, _end(value, cuda), pb))
