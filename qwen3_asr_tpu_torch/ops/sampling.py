"""Sampling on the device (counterpart of ``qwen3_asr_tpu/ops/sampling.py``):
the repetition penalty and the recent-token window it reads, the top-k and
top-p filters, ``sample_logits`` and the speculative verifier
``spec_verify_sample``.

Everything is batched over a leading lane axis, where the JAX package
``vmap``s one-lane functions.  The transform order is the JAX package's:
penalty -> temperature (``max(T, 1e-6)``) -> a top-``k_subset`` candidate
pool -> top-k keeping ties (``>= kth``) -> top-p on the exclusive cumsum of
full-vocabulary probabilities (the softmax denominator is a logsumexp over
every logit) -> draw.  Draws are Gumbel-max over uniforms from an explicit
``torch.Generator`` on the lanes' device (``jax.random.categorical`` is
Gumbel-max too); the two packages' random streams differ, so they agree in
distribution, not draw for draw.

The continuous engine's sampled lanes draw from counter streams instead
(:func:`sample_streams`): lane b's uniforms for its n-th token are a hash
of (its request's seed, n, the vocabulary id), computed in integer tensor
ops on the device with no generator state, so a lane's draws depend on
nothing but its request and its token index, and a captured CUDA graph of
the engine's chunk draws for every lane without a generator per slot.

``temperature``, ``top_k``, ``top_p``, the repetition penalty and the live
``repetition_context_size`` are values on the device, as the JAX package
traces them: each takes a Python number, a 0-d tensor or a per-lane (B,)
tensor, and the filters are masks, never host branches on those values, so
a captured CUDA graph of the decode step serves every value.  Only the
static sizes (``rep_window``, ``k_subset``) shape the work.  The greedy
case of :func:`sample_logits` and :func:`spec_verify_sample` (a Python
``temperature == 0``) is the one host branch; the decode loops choose it by
their static mode and never reach it with a tensor.
"""

from __future__ import annotations

import torch

#: Sentinel for empty slots of the recent-tokens window (any id >= vocab).
RECENT_PAD_ID = 2**30

#: Default size of the stochastic candidate pool (JAX ``TOP_K_SUBSET``);
#: ``RuntimeConfig.pick_top_k_subset`` widens it for larger ``top_k``.
TOP_K_SUBSET = 1024


def apply_repetition_penalty(
    logits: torch.Tensor, recent_tokens: torch.Tensor, penalty
) -> torch.Tensor:
    """Penalize, per row, the tokens present in ``recent_tokens`` (B, W):
    positive logits are divided by ``penalty``, negative ones multiplied.
    ``penalty`` is one float, a 0-d tensor or a (B,) tensor (the
    continuous engine's per-slot penalties; a row at 1.0 is unchanged).  Sentinel slots (ids
    >= vocab) are ignored."""
    if isinstance(penalty, torch.Tensor):
        penalty = penalty.to(logits.dtype).reshape(-1, 1)
    elif penalty == 1.0:
        return logits
    B, vocab = logits.shape
    hit = torch.zeros((B, vocab + 1), dtype=torch.bool, device=logits.device)
    hit.scatter_(1, recent_tokens.clamp(0, vocab).long(), True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(hit[:, :vocab], penalized, logits)


def recent_token_window(
    tokens: torch.Tensor,     # (B, token_bucket) generated ids
    counts: torch.Tensor,     # (B,) tokens generated so far
    rep_ctx,                  # live repetition_context_size: int, 0-d or (B,) tensor
    rep_window: int,          # static gather width
    token_bucket: int,
) -> torch.Tensor:
    """Last ``rep_window`` generated ids per sequence, :data:`RECENT_PAD_ID`
    outside the live ``repetition_context_size``."""
    idx = counts[:, None] - rep_window + torch.arange(rep_window, device=tokens.device)
    vals = torch.gather(tokens, 1, idx.clamp(0, token_bucket - 1))
    if isinstance(rep_ctx, torch.Tensor):
        rep_ctx_c = rep_ctx.to(counts.dtype).clamp(max=rep_window).reshape(-1, 1)
        in_ctx = (idx >= 0) & (idx >= counts[:, None] - rep_ctx_c) & (rep_ctx_c > 0)
        return torch.where(in_ctx, vals, torch.full_like(vals, RECENT_PAD_ID))
    rep_ctx_c = min(max(rep_ctx, 0), rep_window)
    in_ctx = (idx >= 0) & (idx >= (counts - rep_ctx_c)[:, None])
    if rep_ctx_c <= 0:
        return torch.full_like(vals, RECENT_PAD_ID)
    return torch.where(in_ctx, vals, torch.full_like(vals, RECENT_PAD_ID))


def _param(x, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A sampling parameter as a ``dtype`` column that broadcasts over the
    rows of ``like``: a number or 0-d tensor -> (1, 1), a (B,) tensor ->
    (B, 1)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((1, 1), x, dtype=dtype, device=like.device)
    return x.to(dtype).reshape(-1, 1)


def _kth_mask(vals_desc: torch.Tensor, values: torch.Tensor, k) -> torch.Tensor:
    """True where ``values`` >= the k-th largest of its row, read from the
    descending ``vals_desc`` (ties kept); every entry where k <= 0."""
    k = _param(k, vals_desc, torch.long)
    idx = (k.clamp(1, vals_desc.shape[-1]) - 1).expand(vals_desc.shape[0], 1)
    return (values >= vals_desc.gather(-1, idx)) | (k <= 0)


def top_k_mask(logits: torch.Tensor, k) -> torch.Tensor:
    """Keep logits (B, V) >= the k-th largest of their row (ties kept);
    k <= 0 disables."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    keep = _kth_mask(sorted_desc, logits, k)
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def top_p_mask(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filter per row of (B, V): drop tokens whose exclusive
    cumulative probability (descending order) is >= p; p >= 1 disables."""
    p = _param(p, logits, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    keep_sorted = ((torch.cumsum(sorted_probs, dim=-1) - sorted_probs) < p) | (p >= 1.0)
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def _filtered_pool(
    logits: torch.Tensor, temperature, top_k, top_p, k_subset: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked values (B, k_sub) in descending order, vocab ids (B, k_sub))
    of the filtered candidate pool; filtered entries are -inf."""
    scaled = logits / _param(temperature, logits, torch.float32).clamp_min(1e-6)
    k_sub = min(k_subset, scaled.shape[-1])
    vals, idx = torch.topk(scaled, k_sub, dim=-1)          # descending
    keep = _kth_mask(vals, vals, top_k)
    top_p = _param(top_p, logits, torch.float32)
    denom = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(vals - denom)
    keep &= ((torch.cumsum(probs, dim=-1) - probs) < top_p) | (top_p >= 1.0)
    masked = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    return masked, idx


def _gumbel_choice(masked: torch.Tensor, generator: torch.Generator | None,
                   u: torch.Tensor | None = None) -> torch.Tensor:
    """Column index of one categorical draw per row over the logits
    ``masked`` (Gumbel-max), from the uniforms ``u`` or from ``generator``."""
    if u is None:
        u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(masked + gumbel, dim=-1)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) held in int64 and a
    32-bit constant ``c``, multiplied by 16-bit halves of ``c`` so that no
    product reaches 2**63 (signed int64 overflow is not relied on)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, full avalanche) on
    values in [0, 2**32) held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(seed: torch.Tensor, n: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in (0, 1), (B, K): row b, column j is a hash of
    (``seed[b]``, ``n[b]``, ``ids[b, j]``) -- a request's seed (int64), its
    token index and a vocabulary id -- on a grid of 2**-23 offset by half a
    step, so that float32 holds every value exactly and none is 0 or 1.
    The seed enters as its two 32-bit limbs."""
    seed, n = seed.long(), n.long()
    key = _mix32(_mix32((seed & _M32) ^ 0x9E3779B9) ^ ((seed >> 32) & _M32))
    key = _mix32(key ^ (n & _M32))
    key2 = _mix32(key ^ 0x85EBCA6B)
    x = _mix32((ids.long() & _M32) ^ key[:, None])
    x = _mix32(x ^ key2[:, None])
    return ((x >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def _is_zero(temperature) -> bool:
    """The greedy case: a Python ``temperature == 0`` (a tensor never is:
    the caller that holds one has chosen to sample)."""
    return not isinstance(temperature, torch.Tensor) and temperature == 0.0


def sample_logits(
    logits: torch.Tensor,          # (B, vocab)
    temperature,                   # number, 0-d or (B,) tensor, as the filters
    top_k,
    top_p,
    repetition_penalty,
    recent_tokens: torch.Tensor,   # (B, W)
    generator: torch.Generator | None,
    k_subset: int = TOP_K_SUBSET,
) -> torch.Tensor:
    """One token id per lane (B,) int64: the penalized argmax at a Python
    ``temperature == 0``, else a draw from the filtered distribution."""
    logits = apply_repetition_penalty(logits.float(), recent_tokens, repetition_penalty)
    if _is_zero(temperature):
        return logits.argmax(dim=-1)
    masked, idx = _filtered_pool(logits, temperature, top_k, top_p, k_subset)
    choice = _gumbel_choice(masked, generator)
    return idx.gather(1, choice[:, None])[:, 0]


def sample_streams(
    logits: torch.Tensor,          # (B, vocab)
    temperature: torch.Tensor,     # (B,) float32, 0 = greedy lane
    top_k,
    top_p,
    repetition_penalty,
    recent_tokens: torch.Tensor,   # (B, W)
    k_subset: int,
    seed: torch.Tensor,            # (B,) int64 the lanes' request seeds
    n: torch.Tensor,               # (B,) int64 index of the token drawn
) -> torch.Tensor:
    """One token id per lane (B,) int64 of a mixed batch: the penalized
    argmax where ``temperature == 0``, else a draw from the filtered
    distribution whose Gumbel noise comes from :func:`counter_uniform`
    keyed by (``seed``, ``n``) and each candidate's vocabulary id.  No host
    value, no generator: a lane's draw depends only on its own logits,
    parameters, seed and token index."""
    logits = apply_repetition_penalty(logits.float(), recent_tokens, repetition_penalty)
    masked, idx = _filtered_pool(logits, temperature, top_k, top_p, k_subset)
    choice = _gumbel_choice(masked, None, counter_uniform(seed, n, idx))
    drawn = idx.gather(1, choice[:, None])[:, 0]
    return torch.where(temperature.reshape(-1) == 0, logits.argmax(dim=-1), drawn)


def spec_verify_sample(
    logits: torch.Tensor,          # (B, vocab)
    draft_id: torch.Tensor,        # (B,) int, < 0 = no proposal
    temperature,                   # as sample_logits
    top_k,
    top_p,
    repetition_penalty,
    recent_tokens: torch.Tensor,   # (B, W)
    generator: torch.Generator | None,
    k_subset: int = TOP_K_SUBSET,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One speculative-sampling verify position per lane against a
    point-mass draft: ``(accept (B,) bool, token (B,) int64)``.

    Accept the draft with probability p(draft) under the full sampling
    transform; on rejection draw from p with the draft's mass removed, so
    the emitted token is an exact draw from :func:`sample_logits`'s
    distribution.  ``draft_id < 0`` matches no vocab id: p(draft) = 0 and
    the draw is a plain sample.  Both random draws are made for every lane
    whatever the outcome, so the stream consumed does not depend on it."""
    logits = apply_repetition_penalty(logits.float(), recent_tokens, repetition_penalty)
    draft_id = draft_id.long()
    if _is_zero(temperature):
        tok = logits.argmax(dim=-1)
        return tok == draft_id, tok
    masked, idx = _filtered_pool(logits, temperature, top_k, top_p, k_subset)
    norm = torch.logsumexp(masked, dim=-1)
    is_draft = idx == draft_id[:, None]
    neg_inf = torch.full_like(masked, float("-inf"))
    draft_val = torch.where(is_draft, masked, neg_inf).amax(dim=-1)
    p_draft = torch.exp(draft_val - norm)                  # 0 if filtered/absent
    u = torch.rand(p_draft.shape, generator=generator, device=logits.device)
    accept = u < p_draft
    residual = torch.where(is_draft, neg_inf, masked)
    residual_ok = (residual > float("-inf")).any(dim=-1)
    choice = _gumbel_choice(torch.where(residual_ok[:, None], residual, masked), generator)
    alt = idx.gather(1, choice[:, None])[:, 0]
    # Degenerate residual: the draft holds all surviving mass (top_k == 1
    # hitting the draft); a rejection there is only rounding in p_draft,
    # so keep the draft and count it accepted.
    accepted = accept | ~residual_ok
    return accepted, torch.where(accepted, draft_id, alt)
