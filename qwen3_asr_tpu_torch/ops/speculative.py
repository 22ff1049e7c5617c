"""N-gram draft proposal for speculative decoding (counterpart of
``qwen3_asr_tpu/ops/speculative.py``).

The draft proposes the tokens that followed the most recent earlier
occurrence of the stream's last n tokens.  It is static-shaped tensor work
on the ``(B, token_bucket)`` token buffer (shifted equality sweeps, a
masked max that picks the most recent match, clipped gathers), with no host
sync, so it adds launches but no wait to the verify loop.  Orders ``n, n-1,
..., 2`` are tried highest first per lane, and a match whose whole
``gamma``-token continuation is already emitted is preferred to a more
recent partial one.  Greedy exactness never depends on the draft: the
verifier accepts a draft token only where it equals the model's own choice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _order_draft(
    tokens: torch.Tensor,   # (B, token_bucket) int64
    counts: torch.Tensor,   # (B,) int64
    n: int,
    gamma: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-order lookup: ``(draft (B, gamma), valid (B, gamma))`` from the
    most recent prior occurrence of the last ``n`` emitted tokens, with
    ``valid[:, 0]`` true where a match exists."""
    B, tb = tokens.shape
    idx = torch.arange(tb, device=tokens.device)

    # match[b, j] = tokens[b, j : j + n] == tokens[b, counts - n : counts]
    match = torch.ones((B, tb), dtype=torch.bool, device=tokens.device)
    for i in range(n):
        ctx_i = tokens.gather(1, (counts - n + i).clamp(0, tb - 1)[:, None])   # (B, 1)
        shifted = F.pad(tokens[:, i:], (0, i))          # tokens[b, j + i], zero-padded
        match &= shifted == ctx_i
    # The continuation token tokens[j + n] must already be emitted; this also
    # excludes the context matching itself at j = counts - n.
    match &= (idx[None, :] + n) <= (counts[:, None] - 1)
    has_ctx = counts >= (n + 1)

    # Two-tier pick: the most recent match whose full continuation is
    # emitted, else the most recent partial match.
    full = match & ((idx[None, :] + n + gamma - 1) <= (counts[:, None] - 1))
    pick = torch.where(full.any(dim=1, keepdim=True), full, match)
    found = match.any(dim=1) & has_ctx
    minus_one = torch.full_like(idx, -1)
    j_star = torch.where(pick, idx[None, :], minus_one[None, :]).amax(dim=1).clamp_min(0)

    offs = torch.arange(gamma, device=tokens.device)
    src = j_star[:, None] + n + offs[None, :]                 # (B, gamma)
    valid = found[:, None] & (src <= (counts[:, None] - 1))
    draft = tokens.gather(1, src.clamp(0, tb - 1))
    return draft, valid


def ngram_draft(
    tokens: torch.Tensor,   # (B, token_bucket) generated-token buffer
    counts: torch.Tensor,   # (B,) tokens[:, :counts] are emitted
    n: int = 2,
    gamma: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Propose ``gamma`` draft tokens per lane by n-gram lookup; ``n`` is
    the highest order tried (down to 2).  Returns ``(draft, valid)``, both
    (B, gamma): ``draft`` int64 proposals (unspecified where not valid),
    ``valid`` true where the proposal is a real, already-emitted
    continuation.  Invalid positions must be rejected by the verifier."""
    tokens = tokens.long()
    counts = counts.long()
    draft, valid = _order_draft(tokens, counts, n, gamma)
    for order in range(n - 1, 1, -1):
        d_lo, v_lo = _order_draft(tokens, counts, order, gamma)
        keep_hi = valid[:, :1]          # a higher-order match exists
        draft = torch.where(keep_hi, draft, d_lo)
        valid = torch.where(keep_hi, valid, v_lo)
    return draft, valid
