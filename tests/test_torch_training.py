"""The port's training path (``qwen3_asr_tpu_torch/training/``) against the
JAX package's (``qwen3_asr_tpu/training/``), float32 on the CPU.

Inputs: the tiny model's numpy parameters (``torch_parity.numpy_params``)
and batches made with numpy from a seed.  Tolerances: the decoder's causal
prefill 1e-5; ``asr_loss`` 1e-5 relative; every gradient leaf
``1e-4 * max|g_leaf| + 1e-7``; one Adam and one AdamW update fed the same
(JAX) gradients 1e-6 absolute against optax (parameter parity after a
whole step is not tested: Adam's first step is about lr * sign(g), so
noise-level gradients flip sign); three steps' losses 1e-4 relative.
Checkpoints: round trip and resume bit-identical.  Each JAX function is
jitted once per module.  The ``cuda``-marked test runs on the card only.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.ops import quant as tquant
from qwen3_asr_tpu_torch.training import asr_loss, checkpoint as ckpt
from qwen3_asr_tpu_torch.training.train import (
    Batch,
    init_train_state,
    make_train_step,
    named_params,
)

from torch_parity import RUNTIME, StubTokenizer, clips, configs, numpy_params

LR = 1e-3
ADAM = functools.partial(torch.optim.Adam, lr=LR)


def _batch_np(seed: int | None):
    """(B=2, 800 frames, P=144) numpy batch.  ``seed`` None is
    ``tests/test_parallel.py``'s fixed batch (ids 7, labels 11, 104 audio
    tokens each); a seed draws ids and labels and gives the lanes 800 and
    700 valid frames (104 and 91 audio tokens)."""
    B, frames, P = 2, 800, 144
    rng = np.random.default_rng(0 if seed is None else seed)
    mel = (rng.standard_normal((B, 128, frames)) * 0.1).astype(np.float32)
    if seed is None:
        n_frames, n_audio = np.array([800, 800]), np.array([104, 104])
        ids = np.full((B, P), 7)
        labels = np.full((B, P), 11)
    else:
        n_frames, n_audio = np.array([800, 700]), np.array([104, 91])
        ids = rng.integers(0, 512, (B, P))
        labels = rng.integers(0, 512, (B, P))
        mel[1, :, 700:] = 0.0
    mask = np.arange(P)[None, :] >= 9 + n_audio[:, None]
    return dict(mel=mel, n_valid_frames=n_frames.astype(np.int32),
                input_ids=ids.astype(np.int32), n_audio=n_audio.astype(np.int32),
                labels=labels.astype(np.int32), label_mask=mask)


def _torch_batch(b) -> Batch:
    return Batch(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


def _jnp(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map(_jnp, tree))
    return jnp.asarray(tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map(_np, tree))
    return np.asarray(tree)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the tiny model's ops (faster than many, and
    kinder to the suite's other workers); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, numpy encoder, numpy decoder)."""
    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed=0)
    return jcfg, tcfg, enc, dec


@functools.lru_cache(maxsize=1)
def _other_params(seed: int):
    return numpy_params(configs()[0], seed=seed)


def _state(setup, opt=ADAM, seed: int | None = None):
    """A fresh port TrainState on the module's (or seed's) parameters."""
    _, tcfg, enc, dec = setup
    if seed is not None:
        enc, dec = _other_params(seed)
    return init_train_state(tcfg, opt, *params_from_jax(enc, dec))


@pytest.fixture(scope="module")
def jax_fns(setup):
    """The JAX loss-and-gradients of ``asr_loss`` over (encoder, decoder),
    jitted once (both batches share its shapes), and per optax
    transformation the update JAX ``make_train_step`` applies after it
    (``training/train.py:95-106``), jitted once each."""
    import jax
    import optax

    from qwen3_asr_tpu.training import train as jtrain

    jcfg = setup[0]

    def loss_fn(params, batch):
        return jtrain.asr_loss(*params, jcfg, jtrain.Batch(**batch))

    def update(tx):
        def apply(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        return tx, jax.jit(apply)

    return (jax.jit(jax.value_and_grad(loss_fn)),
            {"adam": update(optax.adam(LR)), "adamw": update(optax.adamw(LR))})


@pytest.fixture(scope="module")
def jax_grads(setup, jax_fns):
    """JAX's loss and gradients on the seeded batch: (loss, numpy
    gradients (encoder, decoder) in the JAX layout)."""
    _, _, enc, dec = setup
    loss, grads = jax_fns[0]((_jnp(enc), _jnp(dec)), _jnp(_batch_np(5)))
    return float(loss), _np(grads)


# -- the decoder's differentiable prefill -------------------------------------


@pytest.mark.parametrize("cache_len", [None, 160])
def test_decoder_causal_matches_jax(setup, cache_len):
    """``attn_impl="causal"``: hidden and the returned per-layer rows, sized
    T without a cache and padded to its length with one; the given cache is
    left as it was (no write in place)."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.models import decoder as jdec

    jcfg, tcfg, _, dec = setup
    _, dec_t = params_from_jax({}, dec)
    rng = np.random.default_rng(1)
    B, T, H = 2, 40, tcfg.text_decoder.hidden_size
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jcache = cache = None
    if cache_len is not None:
        jcache = jdec.init_kv_cache(jcfg.text_decoder, B, cache_len, jnp.float32)
        cache = tdec.init_kv_cache(tcfg.text_decoder, B, cache_len, torch.float32)
    jh, (jk, jv) = jdec.decoder_forward(_jnp(dec), jcfg.text_decoder, jnp.asarray(x),
                                        jnp.asarray(pos), kv_cache=jcache, attn_impl="causal")
    h, (k, v) = tdec.decoder_forward(dec_t, tcfg.text_decoder, torch.from_numpy(x),
                                     torch.from_numpy(pos), cache, attn_impl="causal")
    S = T if cache_len is None else cache_len
    assert k.shape == v.shape == (2, B, 2, S, 128)
    for got, want in ((h, jh), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if cache is not None:
        assert not cache[0].any() and not cache[1].any()


@pytest.mark.parametrize("impl,slots", [("causal", 0), ("flash", 0), ("cache", None)])
def test_decoder_attn_impl_refusals(setup, impl, slots):
    """"causal"/"flash" belong to the fresh prefill (no write slots); an
    unknown name raises."""
    _, tcfg, _, dec = setup
    _, dec_t = params_from_jax({}, dec)
    cache = tdec.init_kv_cache(tcfg.text_decoder, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="attn_impl"):
        tdec.decoder_forward(dec_t, tcfg.text_decoder, torch.zeros(1, 4, 64),
                             torch.arange(4)[None], cache, write_slots=slots, attn_impl=impl)


# -- the loss, its gradients and the optimizers -------------------------------


def test_asr_loss_matches_jax(setup, jax_grads):
    _, tcfg, enc, dec = setup
    loss = asr_loss(*params_from_jax(enc, dec), tcfg, _torch_batch(_batch_np(5)))
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert abs(loss.item() - jax_grads[0]) <= 1e-5 * abs(jax_grads[0])


@pytest.mark.parametrize("tree", ["encoder", "decoder"])
def test_gradients_match_jax(setup, jax_grads, tree):
    """Every leaf's gradient within ``1e-4 * max|g_leaf| + 1e-7`` of
    ``jax.value_and_grad``'s, mapped through ``params_from_jax``."""
    _, tcfg, _, _ = setup
    state = _state(setup)
    asr_loss(state.encoder, state.decoder, tcfg, _torch_batch(_batch_np(5))).backward()
    ref = dict(named_params(*params_from_jax(*jax_grads[1])))
    leaves = [(n, t) for n, t in named_params(state.encoder, state.decoder)
              if n.startswith(tree)]
    assert len(leaves) == (2 * 16 + 13 if tree == "encoder" else 2 * 11 + 2)
    for name, t in leaves:
        g, r = t.grad.numpy(), ref[name].numpy()
        assert np.abs(r).max() > 0, name
        tol = 1e-4 * np.abs(r).max() + 1e-7
        err = np.abs(g - r).max()
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_update_matches_optax(setup, jax_fns, jax_grads, name):
    """One update fed the same (JAX) gradients: ``torch.optim.Adam`` against
    ``optax.adam``, ``AdamW(weight_decay=1e-4)`` against ``optax.adamw``
    (its default decay)."""
    _, _, enc, dec = setup
    opt = ADAM if name == "adam" else functools.partial(torch.optim.AdamW, lr=LR,
                                                         weight_decay=1e-4)
    tx, apply = jax_fns[1][name]
    params = (_jnp(enc), _jnp(dec))
    new_params, _ = apply(_jnp(jax_grads[1]), tx.init(params), params)
    want = dict(named_params(*params_from_jax(*_np(new_params))))

    state = _state(setup, opt)
    grads = dict(named_params(*params_from_jax(*jax_grads[1])))
    for n, t in named_params(state.encoder, state.decoder):
        t.grad = grads[n]
    state.optimizer.step()
    for n, t in named_params(state.encoder, state.decoder):
        err = (t.detach() - want[n]).abs().max().item()
        assert err <= 1e-6, f"{n}: {err:.3e}"


def test_three_steps_match_jax(setup, jax_fns):
    """``tests/test_parallel.py``'s batch: three Adam steps' losses within
    1e-4 relative of the JAX step's (its loss-and-gradients, then its
    optax update), and falling."""
    _, tcfg, enc, dec = setup
    grad_fn, (tx, apply) = jax_fns[0], jax_fns[1]["adam"]
    params = (_jnp(enc), _jnp(dec))
    opt_state, jbatch = tx.init(params), _jnp(_batch_np(None))
    step, state, batch = make_train_step(tcfg), _state(setup), _torch_batch(_batch_np(None))
    want, got = [], []
    for _ in range(3):
        jloss, grads = grad_fn(params, jbatch)
        params, opt_state = apply(grads, opt_state, params)
        state, loss = step(state, batch)
        want.append(float(jloss))
        got.append(loss.item())
    assert state.step == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0] and np.isfinite(got).all()


def test_step_calls_no_kernel_wrapper(setup, monkeypatch):
    """A train step reaches none of the ``ctypes`` kernels' wrappers (K1, K9,
    K10, K11e): a spy on each, as the decoder, ``qlinear`` and the encoder
    import them."""
    from qwen3_asr_tpu_torch.models import encoder as tenc

    calls = []

    def spy(mod, name):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(name) or real(*a, **k))

    for mod, name in ((tdec, "flash_attention_causal"), (tquant, "quantized_matmul"),
                      (tquant, "w8a8_matmul"), (tenc, "conv_s2_gelu")):
        spy(mod, name)
    state = _state(setup)
    _, loss = make_train_step(setup[1])(state, _torch_batch(_batch_np(5)))
    assert np.isfinite(loss.item()) and calls == []


def test_init_train_state_refuses_fused_and_int8(setup):
    """The JAX package trains the split float layout: fused wqkv/wgu and
    int8 {"q", "s"} trees raise."""
    _, tcfg, enc, dec = setup
    enc_t, dec_t = params_from_jax(enc, dec)
    cases = [
        (enc_t, tdec.fuse_decoder_params(dec_t), "fused"),
        (enc_t, tquant.quantize_decoder_params(dec_t), "int8"),
        (tquant.quantize_encoder_params(enc_t), dec_t, "int8"),
    ]
    for e, d, match in cases:
        with pytest.raises(ValueError, match=match):
            init_train_state(tcfg, ADAM, e, d)
    assert not any(t.requires_grad for _, t in named_params(enc_t, dec_t))


# -- QWEN3_ASR_PREFILL_FLASH=0 -------------------------------------------------


def test_prefill_flash_off_keeps_tokens(setup, monkeypatch):
    """With the switch off (the module constant, as the env var is read at
    import) ``transcribe_batch`` never calls K1's wrapper and its tokens
    stay those of the default run, which calls it."""
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig

    _, tcfg, enc, dec = setup
    model = Qwen3ASR(tcfg, *params_from_jax(enc, dec), StubTokenizer(), RuntimeConfig(**RUNTIME))
    audio = clips((1.0, 2.3))
    real = tdec.flash_attention_causal
    calls = []
    monkeypatch.setattr(tdec, "flash_attention_causal",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ref = [r.text for r in model.transcribe_batch(audio, max_tokens=8)]
    assert calls
    calls.clear()
    monkeypatch.setattr(tdec, "PREFILL_FLASH_ENABLED", False)
    assert [r.text for r in model.transcribe_batch(audio, max_tokens=8)] == ref
    assert calls == []


# -- checkpoints -----------------------------------------------------------------


def _leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(named_params(a.encoder, a.decoder),
                                                           named_params(b.encoder, b.decoder)))


def _opt_equal(a, b) -> bool:
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sa["param_groups"] != sb["param_groups"] or sa["state"].keys() != sb["state"].keys():
        return False
    return all(torch.equal(sa["state"][i][k], sb["state"][i][k])
               for i in sa["state"] for k in sa["state"][i])


def test_checkpoint_round_trip(setup, tmp_path):
    """Parameters, the optimizer's moments and the step back bit-exact, in
    place in the template's tensors (its optimizer still steps them)."""
    state, batch = _state(setup), _torch_batch(_batch_np(None))
    state, _ = make_train_step(setup[1])(state, batch)
    path = ckpt.save_train_state(tmp_path, state)
    assert path.name == "step_00000001" and ckpt.latest_step(tmp_path) == 1
    template = _state(setup, seed=1)
    tensors = [t for _, t in named_params(template.encoder, template.decoder)]
    restored = ckpt.restore_train_state(tmp_path, template)
    assert restored.step == 1 and restored.optimizer is template.optimizer
    assert all(a is b for a, (_, b) in zip(tensors, named_params(restored.encoder,
                                                                   restored.decoder)))
    assert _leaves_equal(restored, state) and _opt_equal(restored, state)


@pytest.mark.parametrize("case", ["max", "empty", "missing", "temporary"])
def test_latest_step(setup, tmp_path, case):
    state = _state(setup)
    if case == "max":
        ckpt.save_train_state(tmp_path, state, step=3)
        ckpt.save_train_state(tmp_path, state, step=11)
        assert ckpt.latest_step(tmp_path) == 11
    elif case == "empty":
        assert ckpt.latest_step(tmp_path) is None
    elif case == "missing":
        assert ckpt.latest_step(tmp_path / "nope") is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore_train_state(tmp_path / "nope", state)
    else:
        ckpt.save_train_state(tmp_path, state, step=2)
        (tmp_path / ".step_00000009.abc").mkdir()     # a save in flight
        (tmp_path / "step_x").mkdir()
        (tmp_path / "step_00000007.tmp").mkdir()
        assert ckpt.latest_step(tmp_path) == 2
        assert sorted(p.name for p in (tmp_path / "step_00000002").iterdir()) == [ckpt.STATE_FILE]


def test_restore_refuses_other_layout(setup, tmp_path):
    jcfg, tcfg, enc, dec = setup
    ckpt.save_train_state(tmp_path, _state(setup))
    enc_t, dec_t = params_from_jax(enc, dec)
    dec_t["layers"] = dec_t["layers"][:1]
    with pytest.raises(ValueError, match="layout"):
        ckpt.restore_train_state(tmp_path, init_train_state(tcfg, ADAM, enc_t, dec_t))


def test_resume_is_bit_identical(setup, tmp_path):
    """Save at step 2, restore into a template of other parameters, take two
    more steps: parameters, moments and losses bit-identical to four
    uninterrupted steps."""
    step, batch = make_train_step(setup[1]), _torch_batch(_batch_np(None))
    ref = _state(setup)
    ref_losses = []
    for _ in range(4):
        ref, loss = step(ref, batch)
        ref_losses.append(loss.item())
    run = _state(setup)
    for _ in range(2):
        run, _ = step(run, batch)
    ckpt.save_train_state(tmp_path, run)
    run = ckpt.restore_train_state(tmp_path, _state(setup, seed=1))
    losses = []
    for _ in range(2):
        run, loss = step(run, batch)
        losses.append(loss.item())
    assert run.step == 4 and losses == ref_losses[2:]
    assert _leaves_equal(run, ref) and _opt_equal(run, ref)


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_prefill_flash_off_launches_no_k1(setup, monkeypatch):
    """On the card, ``transcribe_batch`` of the tiny bf16 model launches K1
    by default and never with the switch off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    _, tcfg, enc, dec = setup
    params = params_from_jax(enc, dec, dtype=torch.bfloat16, device="cuda")
    model = Qwen3ASR(tcfg, *params, StubTokenizer(), RuntimeConfig(**RUNTIME))
    audio = clips((1.0, 2.3))
    for enabled, launched in ((True, True), (False, False)):
        monkeypatch.setattr(tdec, "PREFILL_FLASH_ENABLED", enabled)
        before = LAUNCHES["flash_attention_causal"]
        model.transcribe_batch(audio, max_tokens=8)
        assert (LAUNCHES["flash_attention_causal"] > before) == launched



def test_profile_tool_needs_cuda(monkeypatch, capsys):
    """``tools/torch_train_profile.py`` imports nothing of JAX and exits 1
    without a CUDA device."""
    import ast
    import sys
    from pathlib import Path

    tools = Path(__file__).resolve().parents[1] / "tools"
    tree = ast.parse((tools / "torch_train_profile.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in imported} & {"jax", "optax", "qwen3_asr_tpu"}
    monkeypatch.syspath_prepend(str(tools))
    import torch_train_profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["torch_train_profile.py"])
    assert torch_train_profile.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
