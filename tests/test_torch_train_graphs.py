"""The train step's one body and its graphing rules
(``qwen3_asr_tpu_torch/training/train.py``: ``make_train_step``,
``TrainStep``), float32 on the CPU.

* The CPU step (the static-buffer body, run eagerly) against the JAX
  package's ``jax.jit(make_train_step(cfg, optimizer))``: three Adam and
  three AdamW steps, losses within 1e-4 relative
  (``tests/test_torch_training.py``'s three-step tolerance).
* The body against the plain loop (``zero_grad(set_to_none=True)``,
  ``asr_loss``, ``backward()``, ``optimizer.step()``) over two batch
  shapes in turn: losses, parameters and gradients bit-identical, every
  step writing the same ``.grad`` tensors; a returned loss keeps its value.
* The graphing decision (CPU and gloo eager, one device and NCCL graphed,
  ``eager=True`` eager), the hyperparameter check a replay makes, and the
  pointer fingerprint that drops the graphs after ``restore_train_state``
  or a tensor assigned anew (with a stub graph that replays the body: no
  graph runs on the CPU); a restored run equal to a fresh eager run from
  the same snapshot.
* ``restore_train_state`` keeps the template's ``capturable`` flag: a
  snapshot whose groups say ``capturable=True`` steps on the CPU.

``cuda``-marked (skipped without a card): the graphed step against
``eager=True`` on the card, the hyperparameter change there, and a capture
that waits for the device raising.
"""

from __future__ import annotations

import functools
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import numpy_params

from qwen3_asr_tpu_torch.models.params import params_from_jax
from qwen3_asr_tpu_torch.parallel import collectives
from qwen3_asr_tpu_torch.parallel.mesh import Mesh
from qwen3_asr_tpu_torch.runtime import graphs
from qwen3_asr_tpu_torch.training import checkpoint as ckpt
from qwen3_asr_tpu_torch.training import train
from qwen3_asr_tpu_torch.training.train import (
    Batch,
    asr_loss,
    capturable,
    check_hyperparameters,
    hyperparameters,
    init_train_state,
    make_train_step,
    named_params,
    pointers,
)

LR = 1e-3
OPTIMIZERS = {
    "adam": functools.partial(torch.optim.Adam, lr=LR),
    "adamw": functools.partial(torch.optim.AdamW, lr=LR, weight_decay=1e-4),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the tiny model's ops; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: The smallest training config (``tests/test_training_checkpoint.py``'s:
#: one encoder layer, decoder head_dim 16): the JAX step compiles in less
#: time than at ``torch_parity``'s widths.
ENCODER = dict(d_model=32, encoder_layers=1, encoder_attention_heads=4, encoder_ffn_dim=64,
               output_dim=64, downsample_hidden_size=8)
DECODER = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128, vocab_size=512)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, numpy encoder, numpy decoder)."""
    from qwen3_asr_tpu import config as jc

    from qwen3_asr_tpu_torch import config as tc

    jcfg, tcfg = ((m.ModelConfig(audio_encoder=m.AudioEncoderConfig(**ENCODER),
                                 text_decoder=m.TextDecoderConfig(**DECODER)))
                  for m in (jc, tc))
    return (jcfg, tcfg, *numpy_params(jcfg, seed=0))


def _batch_np(seed: int, B: int = 2, P: int = 144) -> dict:
    """A seeded batch of B lanes of 800 mel frames (the second, if any, 700
    valid) and prompts of P ids; the loss mask over [9 + n_audio, P)."""
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((B, 128, 800)) * 0.1).astype(np.float32)
    n_frames, n_audio = np.array([800, 700][:B]), np.array([104, 91][:B])
    mel[1:, :, 700:] = 0.0
    return dict(mel=mel, n_valid_frames=n_frames.astype(np.int32),
                input_ids=rng.integers(0, 512, (B, P)).astype(np.int32),
                n_audio=n_audio.astype(np.int32),
                labels=rng.integers(0, 512, (B, P)).astype(np.int32),
                label_mask=np.arange(P)[None, :] >= 9 + n_audio[:, None])


def _batch(b: dict) -> Batch:
    return Batch(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


def _state(setup, opt=OPTIMIZERS["adam"], seed: int | None = None):
    _, tcfg, enc, dec = setup
    if seed is not None:
        enc, dec = numpy_params(setup[0], seed=seed)
    return init_train_state(tcfg, opt, *params_from_jax(enc, dec))


def _leaves(state) -> list[torch.Tensor]:
    return [t for _, t in named_params(state.encoder, state.decoder)]


def _equal_states(a, b) -> bool:
    """Bit-equal parameters and optimizer state tensors."""
    if not all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b))):
        return False
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return sa.keys() == sb.keys() and all(torch.equal(sa[i][k], sb[i][k])
                                          for i in sa for k in sa[i])


# -- the CPU step against the JAX package's jitted step -----------------------


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_cpu_step_matches_the_jitted_jax_step(setup, name):
    """Three steps of the port's step (eager on CPU tensors, through the
    static buffers) against ``jax.jit(make_train_step(cfg, tx))`` with the
    stated optax counterpart: losses within 1e-4 relative, falling."""
    import jax
    import jax.numpy as jnp
    import optax

    from qwen3_asr_tpu.training import train as jtrain

    jcfg, tcfg, enc, dec = setup
    tx = optax.adam(LR) if name == "adam" else optax.adamw(LR)
    jstate = jtrain.init_train_state(jcfg, tx, jax.tree.map(jnp.asarray, enc),
                                     jax.tree.map(jnp.asarray, dec))
    jstep = jax.jit(jtrain.make_train_step(jcfg, tx))
    b = _batch_np(5)
    jbatch = jtrain.Batch(**{k: jnp.asarray(v) for k, v in b.items()})
    step, state = make_train_step(tcfg), _state(setup, OPTIMIZERS[name])
    want, got = [], []
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = step(state, _batch(b))
        want.append(float(jloss))
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0] and state.step == 3 == int(jstate.step)
    assert not step.graphed(state)
    assert step.stats == train.StepStats(eager_steps=3)


# -- the body: static buffers, shared gradients, the returned loss ------------


def test_body_equals_the_plain_loop_over_two_shapes(setup):
    """Shapes (B=2, P=144) and (B=1, P=160) in turn: each step's loss,
    parameters, gradients and Adam moments bit-identical to the plain loop
    on a copy of the state, every step writing the same ``.grad`` tensors,
    one set of static buffers a shape."""
    tcfg = setup[1]
    step, state, ref = make_train_step(tcfg), _state(setup), _state(setup)
    batches = [_batch(_batch_np(5)), _batch(_batch_np(6, B=1, P=160))]
    grads = None
    for k in range(4):
        batch = batches[k % 2]
        state, loss = step(state, batch)
        ref.optimizer.zero_grad(set_to_none=True)
        want = asr_loss(ref.encoder, ref.decoder, tcfg, batch)
        want.backward()
        ref.optimizer.step()
        assert loss.item() == want.item()
        assert _equal_states(state, ref)
        assert all(torch.equal(a.grad, b.grad) for a, b in zip(_leaves(state), _leaves(ref)))
        ptrs = [t.grad.data_ptr() for t in _leaves(state)]
        assert grads is None or ptrs == grads
        grads = ptrs
    assert len(step._shapes) == 2


def test_returned_loss_keeps_its_value(setup):
    """A loss the caller holds is a copy: later steps leave it as it was."""
    step, state = make_train_step(setup[1]), _state(setup)
    batch = _batch(_batch_np(5))
    state, first = step(state, batch)
    value = first.item()
    state, second = step(state, batch)
    assert first.item() == value != second.item()
    assert first.dim() == 0 and first.dtype == torch.float32


# -- the graphing decision ------------------------------------------------------


class _Groups:
    """A DeviceMesh stand-in: ``get_group`` names the axis."""

    def get_group(self, axis):
        return axis


def _mesh(dp: int, tp: int) -> Mesh:
    return Mesh({"dp": dp, "tp": tp}, {"dp": 0, "tp": 0}, _Groups())


@pytest.mark.parametrize("device,shape,backend,graphed", [
    ("cpu", None, None, False),
    ("cpu", (1, 2), "gloo", False),
    ("cuda", None, None, True),
    ("cuda", (1, 1), None, True),
    ("cuda", (1, 2), "nccl", True),
    ("cuda", (2, 2), "nccl", True),
    ("cuda", (2, 1), "gloo", False),
    ("cuda", (1, 2), "gloo", False),
])
def test_graphing_decision(monkeypatch, device, shape, backend, graphed):
    """CUDA on one device or over NCCL is graphed; CPU tensors and gloo
    groups run eagerly, and ``eager=True`` everywhere."""
    if backend is not None:
        monkeypatch.setattr(collectives.dist, "get_backend", lambda group=None: backend)
    mesh = None if shape is None else _mesh(*shape)
    assert capturable(torch.device(device), mesh) is graphed
    state = SimpleNamespace(decoder={"final_norm": SimpleNamespace(device=torch.device(device))},
                            mesh=mesh)
    assert make_train_step(None).graphed(state) is graphed
    assert not make_train_step(None, eager=True).graphed(state)


# -- the hyperparameter check ----------------------------------------------------


@pytest.mark.parametrize("change,key", [
    (lambda g: g.update(lr=2e-3), "lr"),
    (lambda g: g.update(betas=(0.8, 0.999)), "betas"),
    (lambda g: g.update(eps=1e-6), "eps"),
    (lambda g: g.update(weight_decay=1e-2), "weight_decay"),
    (lambda g: g.update(amsgrad=True), "amsgrad"),
])
def test_a_float_setting_changed_after_capture_raises(change, key):
    """A replay would run the captured value: the check names the key and
    says to schedule with a tensor lr updated in place."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = OPTIMIZERS["adamw"]([p])
    baked = hyperparameters(opt)
    check_hyperparameters(baked, opt)
    change(opt.param_groups[0])
    with pytest.raises(ValueError, match=rf"'{key}'.*tensor lr updated in place"):
        check_hyperparameters(baked, opt)


def test_a_tensor_lr_updated_in_place_passes_and_a_new_one_raises():
    """The graph reads a tensor lr on the device: filled in place it
    schedules, replaced by another tensor (or a param group added) it
    raises."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=torch.tensor(1e-3))
    baked = hyperparameters(opt)
    opt.param_groups[0]["lr"].fill_(5e-4)
    check_hyperparameters(baked, opt)
    opt.param_groups[0]["lr"] = torch.tensor(5e-4)
    with pytest.raises(ValueError, match="'lr'"):
        check_hyperparameters(baked, opt)
    baked = hyperparameters(opt)
    opt.add_param_group({"params": [torch.nn.Parameter(torch.ones(2))]})
    with pytest.raises(ValueError, match="param groups"):
        check_hyperparameters(baked, opt)


# -- stale pointers, with a stub graph -------------------------------------------


class _StubGraphs:
    """``DecodeGraphs`` on the CPU: the warm-up runs the body, a capture
    records it, and a replay runs it again (as a graph replays its ops on
    the captured tensors)."""

    def __init__(self, device):
        self.device, self.entries, self.last_capture_ms = device, {}, 1.5

    def get(self, key):
        return self.entries.get(key)

    def warm(self, step):
        step()

    def capture(self, key, statics, step, generator=None, warm=True):
        assert not warm
        graph = graphs.StepGraph(SimpleNamespace(replay=step), Counter())
        self.entries[key] = (statics, graph)
        return graph

    def close(self):
        self.entries.clear()


@pytest.mark.parametrize("how", ["restore", "assign"])
def test_stale_pointers_drop_the_graphs(setup, tmp_path, monkeypatch, how):
    """Graphed (a stub graph on the CPU): warm-up, capture, replays; then
    the snapshot restored into the captured state (its optimizer's state
    tensors are new) or a moment assigned anew drops the graphs, and the
    next calls warm up and capture again.  After the restore, three steps
    bit-identical to three ``eager=True`` steps of a fresh state restored
    from the same snapshot."""
    monkeypatch.setattr(train, "capturable", lambda device, mesh: True)
    monkeypatch.setattr(graphs, "DecodeGraphs", _StubGraphs)
    tcfg, batch = setup[1], _batch(_batch_np(5))
    step, state = make_train_step(tcfg), _state(setup)
    for _ in range(3):
        state, _ = step(state, batch)
    assert step.stats == train.StepStats(captures=1, replays=2, eager_steps=1, capture_ms=1.5)
    ckpt.save_train_state(tmp_path, state)
    state, _ = step(state, batch)
    before = pointers(state)
    if how == "restore":
        state = ckpt.restore_train_state(tmp_path, state)
    else:
        first = _leaves(state)[0]
        moments = state.optimizer.state[first]
        moments["exp_avg"] = moments["exp_avg"].clone()
    assert pointers(state) != before
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(loss.item())
    assert step.stats == train.StepStats(captures=2, replays=5, eager_steps=2, drops=1,
                                         capture_ms=1.5)
    if how == "restore":
        run = ckpt.restore_train_state(tmp_path, _state(setup, seed=1))
        oracle, want = make_train_step(tcfg, eager=True), []
        for _ in range(3):
            run, loss = oracle(run, batch)
            want.append(loss.item())
        assert losses == want and _equal_states(state, run)
    step.close()
    assert step._graphs is None and not any(s.warm for s in step._shapes.values())


def test_backward_collectives_count_with_the_capture(monkeypatch):
    """Autograd runs a capture's backward on a device thread of its own:
    the collectives that thread calls on the capture stream count with the
    capture (a replay adds them), not in ``TRAFFIC``; a thread on another
    stream counts as usual."""
    import threading

    monkeypatch.setattr(collectives, "TRAFFIC", Counter())
    monkeypatch.setattr(collectives.torch.cuda, "current_stream", lambda device=None: SimpleNamespace(
        cuda_stream=9 if threading.current_thread().name == "other" else 7))
    rows = SimpleNamespace(is_cuda=True, device="cuda:0", numel=lambda: 4, element_size=lambda: 2)

    def in_thread(kind: str, name: str) -> None:
        thread = threading.Thread(target=collectives._count, args=(kind, rows), name=name)
        thread.start()
        thread.join()

    def capture():
        collectives._count("all_reduce", rows)            # the forward, this thread
        in_thread("broadcast", "autograd")                # the backward
        in_thread("all_gather", "other")                  # another stream

    counted = collectives.diverted(capture, SimpleNamespace(cuda_stream=7))
    assert counted == Counter({"all_reduce": 1, "all_reduce bytes": 8,
                               "broadcast": 1, "broadcast bytes": 8})
    assert collectives.TRAFFIC == Counter({"all_gather": 1, "all_gather bytes": 8})
    assert collectives._stream_sinks == {}
    in_thread("broadcast", "autograd")
    assert collectives.TRAFFIC["broadcast"] == 1


# -- checkpoints across devices -----------------------------------------------------


def test_restore_keeps_the_templates_capturable_flag(setup, tmp_path):
    """A snapshot whose groups say ``capturable=True`` (taken on the card,
    where the step sets the flag) restores into a CPU template, which keeps
    its own flag and steps as from the same snapshot without it."""
    tcfg, batch = setup[1], _batch(_batch_np(5))
    step, state = make_train_step(tcfg), _state(setup)
    state, _ = step(state, batch)
    ckpt.save_train_state(tmp_path / "plain", state)
    for group in state.optimizer.param_groups:
        group["capturable"] = True
    ckpt.save_train_state(tmp_path / "card", state)
    saved = torch.load(tmp_path / "card" / "step_00000001" / ckpt.STATE_FILE, weights_only=True)
    assert saved["optimizer"]["param_groups"][0]["capturable"] is True
    losses = []
    for where in ("card", "plain"):
        run = ckpt.restore_train_state(tmp_path / where, _state(setup, seed=1))
        assert run.optimizer.param_groups[0]["capturable"] is False
        run, loss = make_train_step(tcfg)(run, batch)
        losses.append(loss.item())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


# -- on the card ------------------------------------------------------------------------


def _cuda_state(setup):
    """The tiny model's float32 state on the card."""
    _, tcfg, enc, dec = setup
    return init_train_state(tcfg, OPTIMIZERS["adam"],
                            *params_from_jax(enc, dec, dtype=torch.float32, device="cuda"))


def _cuda_run(setup, eager: bool, steps: int = 5):
    step, state = make_train_step(setup[1], eager=eager), _cuda_state(setup)
    batch = _batch(_batch_np(5)).to("cuda")
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss)
    return step, state, torch.stack(losses).tolist()


@pytest.mark.cuda
def test_cuda_graphed_step_matches_eager(setup):
    """The tiny float32 model on the card, TF32 off and ``cudnn.deterministic``
    on (cuDNN's default conv backward adds with atomics, and Adam turns
    rounding-level gradients into lr-sized steps): five graphed steps (one
    capture) bit-identical to ``eager=True`` from the same state, whose two
    runs are bit-identical; a changed lr raises before the next replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        step, state, losses = _cuda_run(setup, eager=False)
        _, ref, want = _cuda_run(setup, eager=True)
        _, ref2, want2 = _cuda_run(setup, eager=True)
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    assert step.graphed(state)
    assert step.stats.captures == 1 and step.stats.eager_steps == 1 and step.stats.replays == 4
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    assert want == want2 and _equal_states(ref, ref2)
    assert losses == want and _equal_states(state, ref)
    state.optimizer.param_groups[0]["lr"] = 2 * LR
    with pytest.raises(ValueError, match="'lr'"):
        step(state, _batch(_batch_np(5)).to("cuda"))
    step.close()


@pytest.mark.cuda
def test_cuda_capture_that_waits_raises(setup, monkeypatch):
    """A step body that waits for the device runs eagerly in its warm-up
    step and raises in the capture: nothing turns eager for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    real = train.asr_loss

    def waits(*args, **kwargs):
        loss = real(*args, **kwargs)
        float(loss)                                      # a host sync
        return loss

    monkeypatch.setattr(train, "asr_loss", waits)
    step, state = make_train_step(setup[1]), _cuda_state(setup)
    batch = _batch(_batch_np(5)).to("cuda")
    state, _ = step(state, batch)
    with pytest.raises(RuntimeError):
        step(state, batch)
    assert step.stats.captures == 0
    step.close()
    torch.cuda.synchronize()


def test_graph_probe_tool_needs_cuda(monkeypatch, capsys):
    """``tools/torch_train_graph_probe.py`` imports nothing of JAX and exits
    1 without a CUDA device."""
    import ast
    import sys
    from pathlib import Path

    tools = Path(__file__).resolve().parents[1] / "tools"
    tree = ast.parse((tools / "torch_train_graph_probe.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m.split(".")[0] for m in imported} & {"jax", "optax", "qwen3_asr_tpu"}
    monkeypatch.syspath_prepend(str(tools))
    import torch_train_graph_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["torch_train_graph_probe.py"])
    assert torch_train_graph_probe.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
