"""The paged-pool kernels of the port (K6 paged decode attention, K7 the
paged speculative verify, K8 the paged row write) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version:

* K6 and K7 (bf16-layout and int8 pools) are held at atol 5e-3 -- the bound
  ``tests/test_pallas.py`` holds the Pallas kernel to -- against the JAX
  ``decode_attention_paged*`` kernels in interpret mode, on shuffled
  non-contiguous pages, heterogeneous prompt lengths and decode depths and a
  lane with no decode rows; inputs are bf16-representable float32, since the
  Pallas kernel rounds q * scale, K, V and the probabilities to bf16;
* unreferenced pages and masked rows filled with large values change
  nothing; the verify at T = 1 is the step, and its position t equals the
  step over the history grown by the first t fresh rows;
* K8's plain version is bit-exact against the JAX decoder's own scatter:
  the bf16-layout writer against the pools ``decoder_paged_step`` /
  ``decoder_paged_verify`` return on the CPU, the int8 writer against
  ``quantize_kv`` and the decoder's scatter expression
  (``decoder.py:1006-1021``), everywhere but the trash page 0 that several
  rows may share; a page past the pool is clipped, a row sent to page 0
  lands there.

* the producer's run planning of the K6/K7 CUDA kernel, modelled by
  :func:`tile_runs`: every valid row of every split's chunk copied exactly
  once, each run inside one page and one interval, at most three runs a
  tile, and each run's 16-byte aligned superset of scales inside its page;
  the wrapper's check of the pool (alignment, page size).

Tests marked ``cuda`` hold each CUDA kernel to its plain version on the GPU
(K6/K7 also: repeatable bit for bit, arrival counters left at zero, a CUDA
graph's replay equal to the eager call).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import configs, numpy_params

from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
from qwen3_asr_tpu_torch.ops.kernels import decode_attention_paged as dap
from qwen3_asr_tpu_torch.ops.kernels.decode_attention import arrival_counters, split_count
from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

L, HQ, HKV, D = 2, 4, 2, 128


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float().numpy()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _table(rng, plen, dcount, PS, n_pages, max_pages):
    """Per-lane page tables over a shuffled pool (page 0 never owned)."""
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((len(plen), max_pages), np.int32)
    for b, (p, d) in enumerate(zip(plen, dcount)):
        need = -(-p // PS) + -(-d // PS)
        table[b, :need] = [free.pop() for _ in range(need)]
    return table


def _case(seed, PS, T=1, q8=False):
    """Random inputs: 3 lanes (plen 300/256/120, dcount 37/300/0)."""
    rng = np.random.default_rng(seed)
    plen = np.array([300, 256, 120], np.int32)
    dcount = np.array([37, 300, 0], np.int32)
    n_pages = 16 if PS == 256 else 24
    max_pages = 4 if PS == 256 else 6
    table = _table(rng, plen, dcount, PS, n_pages, max_pages)
    shape = (L, n_pages, HKV, PS, D)
    q = _bf16(rng.standard_normal((3, HQ, T, D)).astype(np.float32))
    k_new = _bf16(rng.standard_normal((3, HKV, T, D)).astype(np.float32))
    v_new = _bf16(rng.standard_normal((3, HKV, T, D)).astype(np.float32))
    if q8:
        kq = rng.integers(-127, 128, shape).astype(np.int8)
        vq = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.uniform(0.5, 2.0, shape[:-1]) / 127).astype(np.float32)
        vs = (rng.uniform(0.5, 2.0, shape[:-1]) / 127).astype(np.float32)
        kpool, vpool = {"q": kq, "s": ks}, {"q": vq, "s": vs}
    else:
        kpool = _bf16(rng.standard_normal(shape).astype(np.float32))
        vpool = _bf16(rng.standard_normal(shape).astype(np.float32))
    return dict(q=q, kpool=kpool, vpool=vpool, k_new=k_new, v_new=v_new,
                table=table, plen=plen, dcount=dcount)


def _to(tree, fn):
    return {k: fn(v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _port(c, layer=1, wrapper=None):
    args = [_t(c["q"]), _to(c["kpool"], _t), _to(c["vpool"], _t), _t(c["k_new"]),
            _t(c["v_new"]), layer, _t(c["table"]), _t(c["plen"]), _t(c["dcount"])]
    T = c["q"].shape[2]
    if wrapper is None:
        q8 = isinstance(c["kpool"], dict)
        if T == 1:
            wrapper = dap.decode_attention_paged_q8 if q8 else dap.decode_attention_paged
        else:
            wrapper = (dap.decode_attention_paged_verify_q8 if q8
                       else dap.decode_attention_paged_verify)
    if T == 1:
        args[0] = args[0][:, :, 0]
        return wrapper(*args)[:, :, None]
    return wrapper(*args)


def _jax(c, layer=1):
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.pallas import decode_attention_paged as jdap

    q8 = isinstance(c["kpool"], dict)
    T = c["q"].shape[2]
    q = jnp.asarray(c["q"][:, :, 0] if T == 1 else c["q"])
    fn = {
        (1, False): jdap.decode_attention_paged,
        (1, True): jdap.decode_attention_paged_q8,
        (0, False): jdap.decode_attention_paged_verify,
        (0, True): jdap.decode_attention_paged_verify_q8,
    }[(int(T == 1), q8)]
    out = fn(
        q, _to(c["kpool"], jnp.asarray), _to(c["vpool"], jnp.asarray),
        jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]), jnp.int32(layer),
        jnp.asarray(c["table"]), jnp.asarray(c["plen"]), jnp.asarray(c["dcount"]),
        interpret=True,
    )
    out = np.asarray(out)
    return out[:, :, None] if T == 1 else out


# -- K6 and K7 against the Pallas kernels -------------------------------------------


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T,PS", [(1, 256), (1, 128), (4, 256), (4, 128)])
def test_paged_attention_matches_pallas(T, PS, q8):
    c = _case(10 * T + PS % 7 + q8, PS, T=T, q8=q8)
    out = _port(c).numpy()
    ref = _jax(c)
    np.testing.assert_allclose(out, ref, atol=5e-3)


def test_paged_attention_garbage_immunity():
    """Unreferenced pages and masked rows (the prompt tail of a lane's last
    prompt page, the decode tail of its last decode page) at +-1e4 leave
    every output unchanged."""
    for T in (1, 4):
        c = _case(7, 256, T=T)
        ref = _port(c)
        kp, vp = c["kpool"].copy(), c["vpool"].copy()
        owned = np.zeros(kp.shape[1], bool)
        owned[c["table"][c["table"] > 0]] = True
        kp[:, ~owned] = 1e4
        vp[:, ~owned] = -1e4
        for b in range(3):
            plen, dcount, PS = c["plen"][b], c["dcount"][b], 256
            pp = -(-plen // PS)
            last_p = c["table"][b, pp - 1]
            kp[:, last_p, :, plen - (pp - 1) * PS:] = 1e4
            if dcount:
                dl = -(-dcount // PS)
                last_d = c["table"][b, pp + dl - 1]
                kp[:, last_d, :, dcount - (dl - 1) * PS:] = -1e4
                vp[:, last_d, :, dcount - (dl - 1) * PS:] = 1e4
        out = _port(dict(c, kpool=kp, vpool=vp))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_paged_verify_t1_is_the_step_and_causal():
    """The verify at T = 1 equals the step; position t of a T = 4 verify
    equals the step over the history grown by fresh rows 0..t-1 (written at
    each lane's next decode rows) with row t as its self-term."""
    c = _case(3, 256, T=4)
    full = _port(c)
    step1 = dap.decode_attention_paged_verify(
        _t(c["q"][:, :, :1]), _t(c["kpool"]), _t(c["vpool"]), _t(c["k_new"][:, :, :1]),
        _t(c["v_new"][:, :, :1]), 1, _t(c["table"]), _t(c["plen"]), _t(c["dcount"]),
    )
    step = dap.decode_attention_paged(
        _t(c["q"][:, :, 0]), _t(c["kpool"]), _t(c["vpool"]), _t(c["k_new"][:, :, :1]),
        _t(c["v_new"][:, :, :1]), 1, _t(c["table"]), _t(c["plen"]), _t(c["dcount"]),
    )
    np.testing.assert_array_equal(step1[:, :, 0].numpy(), step.numpy())
    PS = 256
    for t in range(4):
        kp, vp = _t(c["kpool"].copy()), _t(c["vpool"].copy())
        for b in range(3):
            pp = -(-c["plen"][b] // PS)
            for u in range(t):
                row = c["dcount"][b] + u
                page = c["table"][b, pp + row // PS]
                kp[1, page, :, row % PS] = _t(c["k_new"][b, :, u])
                vp[1, page, :, row % PS] = _t(c["v_new"][b, :, u])
        got = dap.decode_attention_paged(
            _t(c["q"][:, :, t]), kp, vp, _t(c["k_new"][:, :, t:t + 1]),
            _t(c["v_new"][:, :, t:t + 1]), 1, _t(c["table"]), _t(c["plen"]),
            _t(c["dcount"] + t),
        )
        np.testing.assert_allclose(full[:, :, t].numpy(), got.numpy(), atol=1e-5, rtol=1e-5)


def test_paged_attention_rejects_too_many_query_rows():
    c = _case(1, 256, T=4)
    with pytest.raises(ValueError, match="query rows"):
        dap._check(_t(c["q"]).bfloat16().repeat(1, 2, 1, 1), _t(c["kpool"]).bfloat16(),
                   _t(c["vpool"]).bfloat16(), _t(c["k_new"]).bfloat16(),
                   _t(c["v_new"]).bfloat16(), 1, _t(c["table"]), _t(c["plen"]),
                   _t(c["dcount"]), torch.bfloat16)


# -- the CUDA kernel's run planning -----------------------------------------------------


def tile_runs(ta: int, tb: int, plen: int, page_size: int) -> list[tuple[int, int, int, int]]:
    """The runs (j0, n, entry, off) of the tile of compact rows [ta, tb) of a
    lane with ``plen`` prompt rows, as ``plan_tile`` in
    ``csrc/decode_attention_paged.cu`` cuts them: n rows from compact row j0
    at offset ``off`` of table entry ``entry``, breaking at every page
    boundary and at the switch from prompt to decode rows (the kernel keeps
    the first three; the test shows there are never more)."""
    pp = -(-plen // page_size)
    runs, j = [], ta
    while j < tb:
        if j < plen:
            entry, off = divmod(j, page_size)
            room = min(page_size - off, plen - j)
        else:
            e, off = divmod(j - plen, page_size)
            entry, room = pp + e, page_size - off
        runs.append((j, min(room, tb - j), entry, off))
        j += runs[-1][1]
    return runs


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("PS", [128, 256])
def test_tile_runs_cover_each_valid_row_once(PS, B):
    """Every split of ``split_count``'s chunks (132 SMs, 8 KV heads), cut
    into 32-row tiles: the runs copy each valid row once, at the (entry,
    offset) of the plain version's gathered view (``compact_mask``), each
    run inside one page and one interval, at most three runs a tile, and a
    run's aligned superset of f32 scales inside its page and its slots."""
    rng = np.random.default_rng(PS + B)
    plen = rng.integers(0, 3 * PS, B)
    dcount = rng.integers(0, 3 * PS, B)
    plen[0], dcount[0] = 0, 0                      # an idle lane
    if B > 1:
        plen[1], dcount[1] = PS + 5, 0             # prompt rows only
    max_pages = int((-(-plen // PS) + -(-dcount // PS)).max())
    table = np.tile(np.arange(max_pages, dtype=np.int32), (B, 1))
    mask = dap.compact_mask(torch.from_numpy(table), PS, torch.from_numpy(plen),
                            torch.from_numpy(dcount)).numpy()
    splits = split_count(B, 8, max_pages * PS, 132)
    for b in range(B):
        n_valid = int(plen[b] + dcount[b])
        chunk = -(-n_valid // splits)
        cols = []
        for split in range(splits):
            start = min(n_valid, split * chunk)
            end = min(n_valid, start + chunk)
            for ta in range(start, end, dap.TILE_ROWS):
                tb = min(end, ta + dap.TILE_ROWS)
                runs = tile_runs(ta, tb, int(plen[b]), PS)
                assert 1 <= len(runs) <= 3
                assert runs[0][0] == ta and sum(n for _, n, _, _ in runs) == tb - ta
                for j0, n, entry, off in runs:
                    assert n >= 1 and off + n <= PS
                    prompt = entry < -(-int(plen[b]) // PS)
                    assert (j0 + n <= plen[b]) if prompt else (j0 >= plen[b])
                    lo, hi = off & ~3, (off + n + 3) & ~3
                    assert hi <= PS and hi - lo <= dap.TILE_ROWS + 8
                    cols.extend(entry * PS + off + i for i in range(n))
        assert sorted(cols) == np.flatnonzero(mask[b]).tolist()


@pytest.mark.parametrize("PS,q8,ptrs,ok", [
    (256, True, (0, 256, 512, 1024), True),
    (128, False, (0, 4096), True),
    (36, True, (0, 16, 32, 48), True),     # 36 >= 32, 36 % 4 == 0
    (34, False, (0, 16), True),            # the bf16 pool takes any page of 32 rows or more
    (34, True, (0, 16, 32, 48), False),    # a scale run's aligned superset leaves the page
    (16, False, (0, 16), False),           # a 32-row tile would span more than three runs
    (256, False, (0, 8), False),           # a bulk copy needs 16-byte addresses
    (256, True, (0, 16, 4, 48), False),
])
def test_paged_check_pool(PS, q8, ptrs, ok):
    if ok:
        dap.check_pool(PS, q8, ptrs)
    else:
        with pytest.raises(ValueError):
            dap.check_pool(PS, q8, ptrs)


# -- K8 against the JAX decoder's scatter ----------------------------------------------


@pytest.fixture(scope="module")
def tiny_decoder():
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu_torch.models.params import params_from_jax

    jcfg, tcfg = configs()
    _, dec = numpy_params(jcfg, seed=4)
    _, tdec = params_from_jax({}, dec)
    return jcfg.text_decoder, tcfg.text_decoder, jax.tree_util.tree_map(jnp.asarray, dec), tdec


def _decoder_inputs(cfg, T, seed, PS=128, n_pages=10):
    rng = np.random.default_rng(seed)
    B = 4
    plen = np.array([130, 60, 200, 1], np.int32)
    dcount = np.array([5, 0, 126, 0], np.int32)
    table = np.array([[3, 7, 2, 0, 0], [5, 1, 0, 0, 0], [9, 4, 8, 6, 0], [0, 0, 0, 0, 0]],
                     np.int32)
    shape = (cfg.num_hidden_layers, n_pages, cfg.num_key_value_heads, PS, cfg.head_dim)
    keys = rng.standard_normal(shape).astype(np.float32)
    values = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    pos = ((plen + dcount)[:, None] + np.arange(T)[None, :]).astype(np.int32)
    # Lane 0: decode rows on its page 2; lane 1 past the pool (clipped);
    # lane 2 across a page boundary (T = 4); lane 3 (idle) on the trash page.
    rows = dcount[:, None] + np.arange(T)[None, :]
    pp = -(-plen // PS)
    pages = table[np.arange(B)[:, None], np.minimum(pp[:, None] + rows // PS, 4)]
    pages[1] = n_pages + 3
    pages[3] = 0
    offs = (rows % PS).astype(np.int32)
    return dict(x=x, pos=pos, keys=keys, values=values, table=table, plen=plen,
                dcount=dcount, pages=pages.astype(np.int32), offs=offs)


def _jax_paged(jc, jdec, d, T):
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec_mod

    fn = jdec_mod.decoder_paged_step if T == 1 else jdec_mod.decoder_paged_verify
    pages, offs = (d["pages"][:, 0], d["offs"][:, 0]) if T == 1 else (d["pages"], d["offs"])
    h, (k, v) = fn(
        jdec, jc, jnp.asarray(d["x"]), jnp.asarray(d["pos"]),
        (jnp.asarray(d["keys"]), jnp.asarray(d["values"])), jnp.asarray(d["table"]),
        jnp.asarray(d["plen"]), jnp.asarray(d["dcount"]), jnp.asarray(pages),
        jnp.asarray(offs),
    )
    return np.asarray(h), np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("T", [1, 4])
def test_kv_write_paged_bit_exact_vs_jax_decoder(tiny_decoder, T):
    """The rows the JAX decoder wrote, written again by K8's plain version
    into the input pools at the same (page, offset) pairs, give the JAX
    decoder's output pools bit for bit outside page 0."""
    jc, _, jdec, _ = tiny_decoder
    d = _decoder_inputs(jc, T, seed=T)
    _, k_ref, v_ref = _jax_paged(jc, jdec, d, T)
    n_pages = d["keys"].shape[1]
    pages_c = np.clip(d["pages"], 0, n_pages - 1)
    for pool_in, ref in ((d["keys"], k_ref), (d["values"], v_ref)):
        rows = ref[:, pages_c, :, d["offs"]]                   # (B, T, L, H, D)
        rows = np.ascontiguousarray(rows.transpose(2, 0, 3, 1, 4))   # (L, B, H, T, D)
        out = kw.kv_write_rows_paged(_t(pool_in.copy()), _t(rows), _t(d["pages"]),
                                     _t(d["offs"])).numpy()
        np.testing.assert_array_equal(out[:, 1:], ref[:, 1:])
        # Lane 1's page past the pool was clipped onto the last page.
        assert (out[:, n_pages - 1] != pool_in[:, n_pages - 1]).any()
        # Lane 3's rows went to the trash page.
        assert (out[:, 0, :, d["offs"][3]] != pool_in[:, 0, :, d["offs"][3]]).any()


def test_kv_write_paged_q8_bit_exact_vs_jax_scatter():
    """quantize_kv + the JAX decoder's scatter of the int8 rows and scales
    (decoder.py:1006-1021, per position as in :1163-1182), against K8's
    int8 plain version, T = 4 rows per lane with a clipped page and trash
    rows."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.quant_kv import quantize_kv as jax_quantize_kv

    jc, _ = configs()
    d = _decoder_inputs(jc.text_decoder, 4, seed=9)
    rng = np.random.default_rng(9)
    Lc, n_pages, H, PS, Dh = d["keys"].shape
    pool_q = rng.integers(-127, 128, d["keys"].shape).astype(np.int8)
    pool_s = rng.uniform(0.001, 0.02, d["keys"].shape[:-1]).astype(np.float32)
    rows = _bf16(rng.standard_normal((Lc, 4, H, 4, Dh)).astype(np.float32))
    rows[0, 0, 0, 0] = 0.0                                     # an all-zero row
    qr = jax_quantize_kv(jnp.asarray(rows))
    ref_q, ref_s = jnp.asarray(pool_q), jnp.asarray(pool_s)
    for u in range(4):
        pages_u = jnp.clip(jnp.asarray(d["pages"][:, u]), 0, n_pages - 1)
        offs_u = jnp.asarray(d["offs"][:, u])
        ref_q = ref_q.at[:, pages_u, :, offs_u, :].set(jnp.moveaxis(qr["q"][:, :, :, u, :], 1, 0))
        ref_s = ref_s.at[:, pages_u, :, offs_u].set(jnp.moveaxis(qr["s"][:, :, :, u], 1, 0))
    pool = {"q": _t(pool_q.copy()), "s": _t(pool_s.copy())}
    out = kw.kv_write_rows_paged_q8(pool, _t(rows), _t(d["pages"]), _t(d["offs"]))
    assert out is pool
    np.testing.assert_array_equal(out["q"].numpy()[:, 1:], np.asarray(ref_q)[:, 1:])
    np.testing.assert_array_equal(out["s"].numpy()[:, 1:], np.asarray(ref_s)[:, 1:])


def test_kv_write_paged_drops_rows_outside_the_page():
    pool = torch.zeros(1, 3, 1, 8, 128)
    rows = torch.ones(1, 2, 1, 1, 128)
    kw.kv_write_rows_paged(pool, rows, torch.tensor([1, 2], dtype=torch.int32),
                           torch.tensor([3, 8], dtype=torch.int32))
    assert pool[0, 1, 0, 3].eq(1).all() and pool.sum() == 128


# -- on the GPU: each kernel against its plain version ----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _gpu_case(cuda, B, T, PS, q8, seed):
    """Smoke-like shapes: 16 query and 8 KV heads, shuffled pages, one idle
    lane (plen 0, no pages)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rng = np.random.default_rng(seed)
    hq, hkv, Lc = 16, 8, 2
    plen = rng.integers(1, 700, B).astype(np.int32)
    dcount = rng.integers(0, 300, B).astype(np.int32)
    plen[-1], dcount[-1] = 0, 0
    max_pages = -(-700 // PS) + -(-300 // PS)
    n_pages = 1 + B * max_pages
    table = _table(rng, plen, dcount, PS, n_pages, max_pages)
    shape = (Lc, n_pages, hkv, PS, 128)
    if q8:
        from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

        kpool = quantize_kv(torch.randn(shape, generator=g, device=cuda))
        vpool = quantize_kv(torch.randn(shape, generator=g, device=cuda))
    else:
        kpool = torch.randn(shape, generator=g, device=cuda).bfloat16()
        vpool = torch.randn(shape, generator=g, device=cuda).bfloat16()
    q = torch.randn(B, hq, T, 128, generator=g, device=cuda).bfloat16()
    k_new = torch.randn(B, hkv, T, 128, generator=g, device=cuda).bfloat16()
    v_new = torch.randn(B, hkv, T, 128, generator=g, device=cuda).bfloat16()
    to = lambda x: torch.from_numpy(x).to(cuda)   # noqa: E731
    return q, kpool, vpool, k_new, v_new, to(table), to(plen), to(dcount)


def _gpu_attend(q, kpool, vpool, k_new, v_new, table, plen, dcount, q8):
    """K6 (T = 1) or K7 on layer 1, as (B, Hq, T, D)."""
    if q.shape[2] == 1:
        fn = dap.decode_attention_paged_q8 if q8 else dap.decode_attention_paged
        return fn(q[:, :, 0], kpool, vpool, k_new, v_new, 1, table, plen, dcount)[:, :, None]
    fn = dap.decode_attention_paged_verify_q8 if q8 else dap.decode_attention_paged_verify
    return fn(q, kpool, vpool, k_new, v_new, 1, table, plen, dcount)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,T,PS", [(8, 1, 256), (3, 1, 128), (8, 4, 256), (5, 2, 128),
                                    (64, 1, 256), (64, 4, 128)])
def test_cuda_paged_attention_matches_plain(cuda, B, T, PS, q8):
    """K6/K7 against the plain version in float32, one launch a call; the
    last lane is idle (no prompt or decode rows)."""
    case = _gpu_case(cuda, B, T, PS, q8, B * T + PS)
    q, kpool, vpool, k_new, v_new, table, plen, dcount = case
    name = (dap.NAME_Q8 if q8 else dap.NAME) if T == 1 else (
        dap.NAME_VERIFY_Q8 if q8 else dap.NAME_VERIFY)
    before = LAUNCHES[name]
    out = _gpu_attend(*case, q8)
    assert LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    f32 = (lambda p: {k: v for k, v in p.items()}) if q8 else (lambda p: p.float())
    plain = dap.paged_attention_q8_plain if q8 else dap.paged_attention_plain
    ref = plain(q.float(), f32(kpool), f32(vpool), k_new.float(), v_new.float(), 1, table,
                plen, dcount, 128 ** -0.5)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,T,PS", [(1, 1, 256), (8, 4, 128), (64, 4, 256)])
def test_cuda_paged_attention_repeatable(cuda, B, T, PS, q8):
    """Two calls give the same bits (the last block folds the splits in
    order), and the arrival counters are back at zero after each."""
    case = _gpu_case(cuda, B, T, PS, q8, 7 * B + T)
    out = _gpu_attend(*case, q8)
    again = _gpu_attend(*case, q8)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert not arrival_counters(cuda, B * 8)[:B * 8].any()


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_paged_attention_graph_replay(cuda, T, q8):
    """A CUDA graph of the call (its workspace allocated in the graph's
    pool, the counters from the shared zeroed buffer) replays to the eager
    call's bits."""
    case = _gpu_case(cuda, 8, T, 256, q8, 11 + T)
    eager = _gpu_attend(*case, q8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _gpu_attend(*case, q8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _gpu_attend(*case, q8)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4])
def test_cuda_kv_write_paged_matches_plain(cuda, T):
    g = torch.Generator(device=cuda).manual_seed(T)
    Lc, B, H, PS, n_pages = 4, 5, 8, 256, 9
    pool = torch.randn(Lc, n_pages, H, PS, 128, generator=g, device=cuda).bfloat16()
    rows = torch.randn(Lc, B, H, T, 128, generator=g, device=cuda).bfloat16()
    pages = torch.tensor([3, 7, 0, n_pages + 2, 1], dtype=torch.int32, device=cuda)
    pages = pages[:, None].repeat(1, T).contiguous()
    offs = (torch.tensor([0, 100, 5, 255 - T, 17], device=cuda)[:, None]
            + torch.arange(T, device=cuda)).int().contiguous()
    out = kw.kv_write_rows_paged(pool.clone(), rows, pages, offs)
    ref = kw.kv_write_rows_paged_plain(pool.clone(), rows, pages, offs)
    assert torch.equal(out[:, 1:], ref[:, 1:])
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    qpool = quantize_kv(pool.float())
    out = kw.kv_write_rows_paged_q8({k: v.clone() for k, v in qpool.items()}, rows, pages, offs)
    ref = kw.kv_write_rows_paged_q8_plain({k: v.clone() for k, v in qpool.items()}, rows,
                                          pages, offs)
    assert torch.equal(out["q"][:, 1:], ref["q"][:, 1:])
    assert torch.equal(out["s"][:, 1:], ref["s"][:, 1:])
