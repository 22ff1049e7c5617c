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
from ..parallel.collectives import TP, all_reduce_, broadcast_
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


def make_train_step(cfg: ModelConfig) -> Callable[[TrainState, Batch], tuple[TrainState, torch.Tensor]]:
    """The train step: ``(state, batch) -> (state, loss)``.

    Zeroes the gradients, computes :func:`asr_loss` on the batch moved to
    the parameters' device, calls ``backward()``, steps the optimizer (the
    parameters change in place) and counts the step.  The loss comes back
    as a detached 0-d tensor on the device.  With the batch already there,
    nothing in a step after the first waits for the device (the first
    copies the RoPE and position tables to it once)."""

    def step(state: TrainState, batch: Batch) -> tuple[TrainState, torch.Tensor]:
        device = state.decoder["final_norm"].device
        state.optimizer.zero_grad(set_to_none=True)
        mesh = state.mesh
        if mesh is None or mesh.shape["dp"] * mesh.shape["tp"] == 1:
            loss = asr_loss(state.encoder, state.decoder, cfg, batch.to(device))
            loss.backward()
            state.optimizer.step()
            return replace(state, step=state.step + 1), loss.detach()
        tp = mesh.tp_group()
        nll, count = masked_nll(state.encoder, state.decoder, cfg,
                                shard_batch(batch, mesh).to(device), tp)
        dp = mesh.group("dp") if mesh.shape["dp"] > 1 else None
        if dp is not None:
            count = all_reduce_(count, dp)
        loss = nll / torch.clamp(count, min=1.0)
        loss.backward()
        loss = loss.detach().reshape(1)
        params = [t for _, t in named_params(state.encoder, state.decoder)]
        for t in params:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
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
        return replace(state, step=state.step + 1), loss[0]

    return step


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

