"""ASR fine-tuning: the end-to-end (encoder + decoder) training step.

Counterpart of ``qwen3_asr_tpu/training/train.py``: one step is mel ->
encoder -> feature injection -> decoder -> causal LM loss -> gradients ->
optimizer update, on the parameters' device.  Where the JAX package jits
``value_and_grad`` and applies an optax transformation, the port calls
``backward()`` and steps a ``torch.optim`` optimizer over the same leaves.

The forward is plain PyTorch that autograd records: the decoder attends with
``attn_impl="causal"`` (the plain ``sdpa``; JAX does the same because
``pallas_call`` has no VJP, ``train.py:69-75``), the encoder's stem is the
"conv" stem (``F.conv2d``), and every product is a float ``x @ w``.  No
hand-written kernel runs in a step; the kernels' wrappers raise if autograd
would record them (``ops/kernels/_build.py:refuse_autograd``).

On a (dp, tp) mesh (``init_train_state(..., mesh=)``, one process per
rank) the state holds this rank's parameter shards (``parallel.shard_params``)
and the step takes its dp coordinate's contiguous slice of the batch
(:func:`shard_batch`, JAX's ``P("dp")`` on axis 0).  The forward runs the
model's tp collectives, whose backward sums the partial gradients over the
tp group.  The loss is the masked mean over the whole batch: this slice's
NLL sum over the mask count summed over dp.  After ``backward()`` the
gradients are summed over the dp group in flat buckets, and the optimizer
steps the local shards (Adam and AdamW are elementwise, so a shard's update
is the slice of the whole one).  A tp group takes its first rank's
gradients of the replicated leaves, so those stay bit-identical across the
ranks.

On the card the step is graphed, the counterpart of JAX's one jitted
program: each batch shape's step body is captured once as a CUDA graph,
with a mesh's NCCL collectives in it, and replayed (:func:`make_train_step`,
:class:`TrainStep`; the rules of ``runtime/graphs.py`` hold).  CPU tensors,
gloo groups and ``make_train_step(cfg, eager=True)`` run the same body
eagerly.

Batch layout: every sample is a right-padded prompt of bucketed length P
holding the chat template with audio-pad placeholders at slots
[9, 9 + n_audio); ``labels`` carries the next-token target at each position
and ``label_mask`` selects the positions that count (typically the
transcription span of the assistant turn).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Iterator, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor.placement_types import Shard

from ..config import ModelConfig
from ..models.decoder import decoder_forward, decoder_logits, embed_tokens
from ..models.encoder import encoder_forward
from ..ops.quant import is_quantized
from ..runtime import graphs as _graphs
from ..parallel.collectives import TP, all_reduce_, broadcast_, on_device
from ..parallel.mesh import Mesh
from ..parallel.sharding import check_tp, decoder_param_sharding, encoder_param_sharding, shard_params

_AUDIO_OFFSET = 9  # chat-template prefix length (tokenizer.PROMPT_PREFIX)

#: An optimizer factory: the parameter leaves in :func:`named_params`' order
#: -> a ``torch.optim.Optimizer`` over them.
OptimizerFactory = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


@dataclass
class TrainState:
    """Parameters, the optimizer over their leaves, and the step count.

    The optimizer holds its state (the JAX ``opt_state``) and updates the
    parameter tensors in place; ``step`` is a host int, so reading it never
    waits for the device.  ``mesh`` is the (dp, tp) mesh whose rank holds
    these shards, None on one device."""

    encoder: Any
    decoder: Any
    optimizer: torch.optim.Optimizer
    step: int
    mesh: Mesh | None = None


class Batch(NamedTuple):
    mel: torch.Tensor             # (B, n_mels, T) float32, zero-padded
    n_valid_frames: torch.Tensor  # (B,) int
    input_ids: torch.Tensor       # (B, P) int, audio pads at [9, 9+n_audio)
    n_audio: torch.Tensor         # (B,) int valid audio tokens per sample
    labels: torch.Tensor          # (B, P) int next-token targets
    label_mask: torch.Tensor      # (B, P) bool: positions that count

    def to(self, device) -> "Batch":
        """Every field on ``device`` (no copy for fields already there)."""
        return Batch(*(t.to(device) for t in self))


def named_leaves(tree, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) for every leaf of a parameter tree: dict keys
    in sorted order (``jax.tree_util``'s order), list items in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from named_leaves(item, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def named_params(encoder, decoder) -> list[tuple[str, torch.Tensor]]:
    """The leaves the optimizer steps, named: the encoder tree's, then the
    decoder tree's, each in :func:`named_leaves` order."""
    return [*named_leaves(encoder, "encoder."), *named_leaves(decoder, "decoder.")]


def tp_dims(encoder, decoder) -> list[int | None]:
    """Each leaf's tp-split dim (None: replicated), in :func:`named_params`
    order."""
    def walk(tree):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from walk(tree[key])
        elif isinstance(tree, list):
            for item in tree:
                yield from walk(item)
        else:                           # a leaf's (dp, tp) placements
            yield tree[1].dim if isinstance(tree[1], Shard) else None

    return [*walk(encoder_param_sharding(encoder)), *walk(decoder_param_sharding(decoder))]


def _check_trainable(encoder, decoder) -> None:
    """Raise unless both trees are the split float layout the JAX package
    trains (its optimizer state maps leaf for leaf onto that layout)."""
    fused = [i for i, lp in enumerate(decoder["layers"]) if "wqkv" in lp or "wgu" in lp]
    if fused:
        raise ValueError(
            f"decoder layers {fused} hold fused wqkv/wgu weights: train the split "
            "layout (wq/wk/wv, wg/wu) and fuse for inference afterwards"
        )

    def quantized(tree) -> bool:
        if is_quantized(tree):
            return True
        if isinstance(tree, dict):
            return any(quantized(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return any(quantized(v) for v in tree)
        return False

    for name, tree in (("encoder", encoder), ("decoder", decoder)):
        if quantized(tree):
            raise ValueError(f"the {name} holds int8 {{'q', 's'}} weights: train float weights")


def asr_loss(enc_params, dec_params, cfg: ModelConfig, batch: Batch,
             tp: TP | None = None) -> torch.Tensor:
    """Masked next-token cross-entropy over the full speech-to-text graph
    (JAX ``train.py:54-81``): a 0-d float32 tensor on the batch's device.
    Under ``tp`` the parameters are this rank's shards and every rank of
    the group gets the same loss."""
    nll, count = masked_nll(enc_params, dec_params, cfg, batch, tp)
    return nll / torch.clamp(count, min=1.0)


def masked_nll(enc_params, dec_params, cfg: ModelConfig, batch: Batch,
               tp: TP | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(the sum of the masked next-token NLL, the mask count) of ``batch``:
    the numerator and denominator of :func:`asr_loss`."""
    features, _ = encoder_forward(
        enc_params, cfg.audio_encoder, batch.mel, batch.n_valid_frames, tp
    )

    B, P = batch.input_ids.shape
    embeds = embed_tokens(dec_params, batch.input_ids, tp)
    take = min(features.shape[1], P - _AUDIO_OFFSET)
    injected = F.pad(
        features[:, :take].to(embeds.dtype), (0, 0, _AUDIO_OFFSET, P - _AUDIO_OFFSET - take)
    )
    slot = torch.arange(P, device=embeds.device)[None, :]
    is_audio = (slot >= _AUDIO_OFFSET) & (slot < _AUDIO_OFFSET + batch.n_audio[:, None])
    embeds = torch.where(is_audio[:, :, None], injected, embeds)

    hidden, _ = decoder_forward(
        dec_params, cfg.text_decoder, embeds, slot.expand(B, P), attn_impl="causal", tp=tp
    )
    logits = decoder_logits(dec_params, cfg.text_decoder, hidden, tp)

    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch.labels.long()[..., None])[..., 0]
    mask = batch.label_mask.to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def shard_batch(batch: Batch, mesh: Mesh | None) -> Batch:
    """This rank's dp slice of ``batch``: the contiguous rows ``[d * B/dp,
    (d + 1) * B/dp)`` of every field for dp coordinate d (JAX ``P("dp")``
    on axis 0); the batch itself for no mesh or dp = 1.  ValueError unless
    dp divides B."""
    if mesh is None or mesh.shape["dp"] == 1:
        return batch
    dp, B = mesh.shape["dp"], batch.input_ids.shape[0]
    if B % dp:
        raise ValueError(f"dp={dp} does not divide the batch ({B})")
    n = B // dp
    lo = mesh.coordinate["dp"] * n
    return Batch(*(t[lo : lo + n] for t in batch))


#: Bytes of one bucket of the gradients' collectives.
BUCKET_BYTES = 256 * 2**20


def bucketed(tensors: list[torch.Tensor], collective) -> None:
    """Run ``collective`` (in place on a flat tensor) over ``tensors``:
    flattened into buckets of one dtype and device of up to
    :data:`BUCKET_BYTES`, one call a bucket, the results copied back."""
    open_runs: dict[tuple, tuple[list[torch.Tensor], int]] = {}
    runs = []
    for t in tensors:
        key, nbytes = (t.dtype, t.device), t.numel() * t.element_size()
        run, size = open_runs.get(key, ([], 0))
        if run and size + nbytes > BUCKET_BYTES:
            run, size = [], 0
        if not run:
            runs.append(run)
        run.append(t)
        open_runs[key] = (run, size + nbytes)
    for run in runs:
        flat = collective(torch.cat([t.reshape(-1) for t in run]))
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view_as(t))


def capturable(device: torch.device, mesh: Mesh | None) -> bool:
    """Whether a CUDA graph can hold a train step on ``device`` over
    ``mesh``: on CUDA, on one device or on a mesh whose groups run their
    collectives on the device (NCCL, ``collectives.on_device``, the test of
    ``Generator._capturable``).  A gloo group's collectives stage through
    host memory, which a capture cannot hold."""
    if device.type != "cuda":
        return False
    if mesh is None or mesh.shape["dp"] * mesh.shape["tp"] == 1:
        return True
    return all(on_device(mesh.group(axis)) for axis in ("dp", "tp") if mesh.shape[axis] > 1)


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Set ``capturable=True`` on every param group that has the option
    (``torch.optim.Adam`` and ``AdamW`` among them: their step count and
    bias corrections then live on the device), moving a step count kept on
    the host to its parameter's device, where ``load_state_dict`` puts it
    for such a group."""
    for group in optimizer.param_groups:
        if group.get("capturable") is not False:
            continue
        group["capturable"] = True
        for p in group["params"]:
            count = optimizer.state.get(p, {}).get("step")
            if isinstance(count, torch.Tensor) and count.device != p.device:
                optimizer.state[p]["step"] = count.to(device=p.device, dtype=torch.float32)


def hyperparameters(optimizer: torch.optim.Optimizer) -> list[dict]:
    """Each param group's settings but its params, as a captured step bakes
    them in: a float by value, a tensor (an ``lr`` that the step reads on
    the device) by its data pointer."""
    def baked(v):
        if isinstance(v, torch.Tensor):
            return ("tensor at", v.data_ptr())
        if isinstance(v, (tuple, list)):
            return tuple(baked(x) for x in v)
        return v

    return [{k: baked(v) for k, v in group.items() if k != "params"}
            for group in optimizer.param_groups]


def check_hyperparameters(baked: list[dict], optimizer: torch.optim.Optimizer) -> None:
    """Raise ``ValueError`` naming the first setting of ``optimizer``'s param
    groups that differs from ``baked`` (:func:`hyperparameters` at the
    capture): a replay would run the captured value and ignore the new one."""
    now = hyperparameters(optimizer)
    if len(now) != len(baked):
        raise ValueError(f"the optimizer has {len(now)} param groups, {len(baked)} when the "
                         "train step was captured: close() the step to capture anew")
    for i, (was, is_) in enumerate(zip(baked, now)):
        for key in sorted(was.keys() | is_.keys()):
            if was.get(key) != is_.get(key):
                raise ValueError(
                    f"param group {i}: {key!r} is {is_.get(key)!r}, {was.get(key)!r} when the "
                    "train step was captured, and a replay would run the captured value; "
                    "schedule the learning rate with a tensor lr updated in place "
                    "(lr=torch.tensor(...) on the parameters' device, then lr.fill_(...)), "
                    "or close() the step to capture anew"
                )


def pointers(state: TrainState) -> tuple[int, ...]:
    """The data pointers that a captured step holds: each parameter leaf of
    the trees and its gradient, then each tensor the optimizer steps and its
    state tensors (``restore_train_state`` and ``load_state_dict`` replace
    these)."""
    out = []
    for _, t in named_params(state.encoder, state.decoder):
        out += (t.data_ptr(), 0 if t.grad is None else t.grad.data_ptr())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            out.append(p.data_ptr())
            out += (v.data_ptr() for v in state.optimizer.state.get(p, {}).values()
                    if isinstance(v, torch.Tensor))
    return tuple(out)


@dataclass
class StepStats:
    """What a :class:`TrainStep` did: graphs captured, replays (a capturing
    call's included), steps run eagerly (every step on the CPU, over gloo
    and under ``eager=True``; on the card each shape's first call after a
    drop), times the graphs were dropped for stale pointers, and the last
    capture's host milliseconds."""

    captures: int = 0
    replays: int = 0
    eager_steps: int = 0
    drops: int = 0
    capture_ms: float = 0.0


class _Shape:
    """One batch shape's static tensors: the batch, the loss the step
    writes, whether a warm-up step ran since the last drop, and the
    optimizer settings its graph baked in."""

    def __init__(self, local: Batch, device: torch.device) -> None:
        self.batch = Batch(*(torch.empty_like(t, device=device) for t in local))
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.warm = False
        self.hyper: list[dict] = []


class TrainStep:
    """The train step of :func:`make_train_step`: ``step(state, batch) ->
    (state, loss)``, with :attr:`stats` and :meth:`close`."""

    def __init__(self, cfg: ModelConfig, eager: bool = False) -> None:
        self.cfg = cfg
        self.eager = eager
        self.stats = StepStats()
        #: Static tensors by shape key (the device, each field's shape and
        #: dtype).
        self._shapes: dict[tuple, _Shape] = {}
        self._graphs: _graphs.DecodeGraphs | None = None
        self._pointers: tuple[int, ...] | None = None

    def graphed(self, state: TrainState) -> bool:
        """Whether a step of ``state`` replays a captured graph."""
        return not self.eager and capturable(state.decoder["final_norm"].device, state.mesh)

    def __call__(self, state: TrainState, batch: Batch) -> tuple[TrainState, torch.Tensor]:
        device = state.decoder["final_norm"].device
        params = [t for _, t in named_params(state.encoder, state.decoder)]
        with torch.no_grad():
            for t in params:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
        if device.type == "cuda":
            make_capturable(state.optimizer)
        local = shard_batch(batch, state.mesh)
        key = (device, *((tuple(t.shape), t.dtype) for t in local))
        entry = self._shapes.get(key)
        if entry is None:
            entry = self._shapes[key] = _Shape(local, device)
        with torch.no_grad():
            for dst, src in zip(entry.batch, local):
                dst.copy_(src)
        if not self.graphed(state):
            self._body(state, params, entry)
            self.stats.eager_steps += 1
        else:
            self._graphed_step(state, params, entry, key, device)
        return replace(state, step=state.step + 1), entry.loss.clone()

    def _graphed_step(self, state, params, entry: _Shape, key: tuple, device) -> None:
        if self._graphs is None or self._graphs.device != device:
            self.close()
            self._graphs = _graphs.DecodeGraphs(device)
        graphs = self._graphs
        now = pointers(state)
        if now != self._pointers:
            if graphs.entries:
                self.stats.drops += 1
            graphs.entries.clear()
            for shape in self._shapes.values():
                shape.warm = False
            self._pointers = now
        captured = graphs.get(key)
        if captured is not None:
            check_hyperparameters(entry.hyper, state.optimizer)
            graph = captured[1]
        elif not entry.warm:
            # The shape's first step: a real one, on the capture's side
            # stream; it makes the optimizer's state.
            graphs.warm(lambda: self._body(state, params, entry))
            entry.warm = True
            self.stats.eager_steps += 1
            self._pointers = pointers(state)
            return
        else:
            graph = graphs.capture(key, entry, lambda: self._body(state, params, entry),
                                   warm=False)
            entry.hyper = hyperparameters(state.optimizer)
            self.stats.captures += 1
            self.stats.capture_ms = graphs.last_capture_ms
        graph.replay()
        self.stats.replays += 1

    def _body(self, state: TrainState, params: list[torch.Tensor], entry: _Shape) -> None:
        """One step on ``entry``'s static batch: the gradients zeroed in
        place, the loss and ``backward()``, on a mesh the dp sum and the tp
        broadcast, the optimizer's step, the loss written to ``entry``."""
        cfg, batch, mesh = self.cfg, entry.batch, state.mesh
        torch._foreach_zero_([t.grad for t in params])
        if mesh is None or mesh.shape["dp"] * mesh.shape["tp"] == 1:
            loss = asr_loss(state.encoder, state.decoder, cfg, batch)
            loss.backward()
        else:
            tp = mesh.tp_group()
            nll, count = masked_nll(state.encoder, state.decoder, cfg, batch, tp)
            dp = mesh.group("dp") if mesh.shape["dp"] > 1 else None
            if dp is not None:
                count = all_reduce_(count, dp)
            loss = nll / torch.clamp(count, min=1.0)
            loss.backward()
            loss = loss.detach().reshape(1)
            if dp is not None:
                # The loss rides in the gradients' buckets: the sum of the
                # slices' shares is the whole batch's mean.
                bucketed([t.grad for t in params] + [loss], lambda f: all_reduce_(f, dp))
            if tp is not None:
                # Every rank of the group computed the replicated leaves'
                # gradients from the same values, but a kernel that adds with
                # atomics (cuDNN's conv backward) may round them apart: the
                # group takes its first rank's, so the leaves stay equal.
                replicated = [t.grad for t, d in zip(params, tp_dims(state.encoder, state.decoder))
                              if d is None]
                bucketed(replicated, lambda f: broadcast_(f, tp.group))
        state.optimizer.step()
        entry.loss.copy_(loss.detach().reshape(()))

    def close(self) -> None:
        """Free the captured graphs and their memory pool; the next step on
        the card warms up and captures anew."""
        if self._graphs is not None:
            self._graphs.close()
        self._graphs = self._pointers = None
        for shape in self._shapes.values():
            shape.warm = False


def make_train_step(cfg: ModelConfig, eager: bool = False) -> TrainStep:
    """The train step: ``step(state, batch) -> (state, loss)``.

    Each call copies the batch (this rank's dp slice of it on a mesh) into
    static tensors of its shape key (each field's shape and dtype) on the
    parameters' device, then runs one step body: the gradients zeroed in
    place (``.grad`` tensors allocated once and shared by every shape), the
    loss (:func:`asr_loss`; on a mesh the slice's :func:`masked_nll` over
    the dp-summed mask count), ``backward()``, on a mesh the dp gradient sum
    and the tp broadcast, the optimizer's step (the parameters change in
    place).  The loss comes back as a fresh 0-d float32 tensor on the
    device, which later steps leave as it is; the state's step count goes
    up by one.

    Graphed (the counterpart of JAX's one jitted step, ``runtime/graphs.py``
    has the rules): on the card, on one device or a mesh whose collectives
    run on the device (NCCL; :func:`capturable`), each batch shape's first
    call is a real step on the capture's side stream (it makes the
    optimizer's state and warms cuBLAS and cuDNN), the second captures the
    body as a CUDA graph, with a mesh's collectives in it, and replays it;
    later calls replay it.  Every rank of a mesh captures the same shapes in
    the same order.  A replay adds its capture's collectives to
    ``collectives.TRAFFIC``.  No fallback: a failed capture or replay
    raises.

    On the card the step first sets ``capturable=True`` on every param
    group of an optimizer that has the option (:func:`make_capturable`;
    ``torch.optim.Adam`` and ``AdamW``, eagerly too, so that both run the
    same arithmetic); another optimizer is captured as it is, or its step
    raises under capture.  A graph bakes in each group's float settings
    (``lr``, betas, eps, weight decay): a replay after one changed raises
    ``ValueError`` (:func:`check_hyperparameters`); schedule with a tensor
    ``lr`` updated in place.  A graph holds the data pointers of the
    parameters, their gradients and the optimizer's state: when they change
    (:func:`pointers`; ``restore_train_state``, a tensor assigned anew) the
    graphs are dropped, and the next call is an eager step, then a capture.

    Eager: CPU tensors, a gloo group and ``eager=True`` (the graphs' oracle
    on the card) run the same body, one launch at a time.  With the batch
    already on the device nothing in a step waits for the device."""
    return TrainStep(cfg, eager)


def init_train_state(
    cfg: ModelConfig,
    optimizer: OptimizerFactory,
    enc_params,
    dec_params,
    mesh: Mesh | None = None,
) -> TrainState:
    """A step-0 state over the port's own parameter trees (``random_params``,
    ``params_from_jax``, ``load_checkpoint``): every leaf is set to require
    grad in place, and ``optimizer`` is called on them in
    :func:`named_params` order, for example
    ``functools.partial(torch.optim.Adam, lr=1e-3)``.  On a ``mesh``
    (``parallel.make_mesh``) the state holds this rank's shards of the
    whole trees given (the same in every rank); the replicated leaves are
    the given tensors.

    Stated counterparts of optax transformations, at equal ``lr``:
    ``torch.optim.Adam`` computes ``optax.adam`` (betas 0.9/0.999, eps 1e-8,
    ``eps_root`` 0), and ``torch.optim.AdamW(weight_decay=1e-4)`` computes
    ``optax.adamw`` (optax's default decay is 1e-4, torch's 1e-2), both held
    to optax in ``tests/test_torch_training.py``.  No other transformation
    has a stated counterpart.

    Raises ``ValueError`` for fused (``wqkv``/``wgu``) or int8 trees: the JAX
    package trains the split float layout."""
    _check_trainable(enc_params, dec_params)
    if mesh is not None and mesh.shape["tp"] > 1:
        check_tp(cfg, mesh.shape["tp"])
        enc_params = shard_params(enc_params, encoder_param_sharding(enc_params), mesh)
        dec_params = shard_params(dec_params, decoder_param_sharding(dec_params), mesh)
    leaves = [t for _, t in named_params(enc_params, dec_params)]
    for t in leaves:
        t.requires_grad_(True)
    return TrainState(enc_params, dec_params, optimizer(leaves), 0, mesh)

