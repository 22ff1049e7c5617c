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

from ..config import ModelConfig
from ..models.decoder import decoder_forward, decoder_logits, embed_tokens
from ..models.encoder import encoder_forward
from ..ops.quant import is_quantized

_AUDIO_OFFSET = 9  # chat-template prefix length (tokenizer.PROMPT_PREFIX)

#: An optimizer factory: the parameter leaves in :func:`named_params`' order
#: -> a ``torch.optim.Optimizer`` over them.
OptimizerFactory = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


@dataclass
class TrainState:
    """Parameters, the optimizer over their leaves, and the step count.

    The optimizer holds its state (the JAX ``opt_state``) and updates the
    parameter tensors in place; ``step`` is a host int, so reading it never
    waits for the device."""

    encoder: Any
    decoder: Any
    optimizer: torch.optim.Optimizer
    step: int


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


def asr_loss(enc_params, dec_params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    """Masked next-token cross-entropy over the full speech-to-text graph
    (JAX ``train.py:54-81``): a 0-d float32 tensor on the batch's device."""
    features, _ = encoder_forward(
        enc_params, cfg.audio_encoder, batch.mel, batch.n_valid_frames
    )

    B, P = batch.input_ids.shape
    embeds = embed_tokens(dec_params, batch.input_ids)
    take = min(features.shape[1], P - _AUDIO_OFFSET)
    injected = F.pad(
        features[:, :take].to(embeds.dtype), (0, 0, _AUDIO_OFFSET, P - _AUDIO_OFFSET - take)
    )
    slot = torch.arange(P, device=embeds.device)[None, :]
    is_audio = (slot >= _AUDIO_OFFSET) & (slot < _AUDIO_OFFSET + batch.n_audio[:, None])
    embeds = torch.where(is_audio[:, :, None], injected, embeds)

    hidden, _ = decoder_forward(
        dec_params, cfg.text_decoder, embeds, slot.expand(B, P), attn_impl="causal"
    )
    logits = decoder_logits(dec_params, cfg.text_decoder, hidden)

    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch.labels.long()[..., None])[..., 0]
    mask = batch.label_mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


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
        loss = asr_loss(state.encoder, state.decoder, cfg, batch.to(device))
        loss.backward()
        state.optimizer.step()
        return replace(state, step=state.step + 1), loss.detach()

    return step


def init_train_state(
    cfg: ModelConfig,
    optimizer: OptimizerFactory,
    enc_params,
    dec_params,
) -> TrainState:
    """A step-0 state over the port's own parameter trees (``random_params``,
    ``params_from_jax``, ``load_checkpoint``): every leaf is set to require
    grad in place, and ``optimizer`` is called on them in
    :func:`named_params` order, for example
    ``functools.partial(torch.optim.Adam, lr=1e-3)``.

    Stated counterparts of optax transformations, at equal ``lr``:
    ``torch.optim.Adam`` computes ``optax.adam`` (betas 0.9/0.999, eps 1e-8,
    ``eps_root`` 0), and ``torch.optim.AdamW(weight_decay=1e-4)`` computes
    ``optax.adamw`` (optax's default decay is 1e-4, torch's 1e-2), both held
    to optax in ``tests/test_torch_training.py``.  No other transformation
    has a stated counterpart.

    Raises ``ValueError`` for fused (``wqkv``/``wgu``) or int8 trees: the JAX
    package trains the split float layout."""
    del cfg  # the JAX signature's; the layout is read from the trees
    _check_trainable(enc_params, dec_params)
    leaves = [t for _, t in named_params(enc_params, dec_params)]
    for t in leaves:
        t.requires_grad_(True)
    return TrainState(enc_params, dec_params, optimizer(leaves), 0)

