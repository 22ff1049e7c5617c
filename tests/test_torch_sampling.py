"""Sampled decoding in the port against the JAX package and the exact
distribution, float32 on the CPU.

The two packages' random streams differ, so sampled draws are compared in
distribution: the filtered candidate set equals the JAX package's (top-k
ties, the top-p boundary), a chi-squared test (20000 draws, alpha 1e-3)
holds the port's draws to the exact filtered distribution (numpy reference
below, as in ``tests/test_speculative.py``), ``spec_verify_sample`` accepts
with probability p(draft) and emits draws of p, and one seed gives one
stream.  ``top_k=1`` makes sampling deterministic, so there the port's
plain and speculative sampled loops are token-identical to the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import clips, ids_of, models

from qwen3_asr_tpu_torch.ops import sampling as tsamp

PAD = tsamp.RECENT_PAD_ID


def _plain_sample_dist(logits, recent, penalty, temperature, top_k, top_p):
    """Numpy reference: the exact distribution ``sample_logits`` draws from."""
    logits = np.asarray(logits, np.float64).copy()
    hit = np.zeros(logits.shape, bool)
    for t in recent:
        hit[t] = True
    if penalty != 1.0:
        logits = np.where(hit, np.where(logits > 0, logits / penalty, logits * penalty), logits)
    scaled = logits / max(temperature, 1e-6)
    keep = np.ones_like(scaled, bool)
    if top_k > 0:
        keep &= scaled >= np.sort(scaled)[::-1][min(top_k, len(scaled)) - 1]
    if top_p < 1.0:
        probs = np.exp(scaled - scaled.max())
        probs /= probs.sum()
        order = np.argsort(-probs, kind="stable")
        exclusive = np.cumsum(probs[order]) - probs[order]
        keep_p = np.zeros_like(keep)
        keep_p[order] = exclusive < top_p
        keep &= keep_p
    masked = np.where(keep, scaled, -np.inf)
    p = np.exp(masked - masked.max())
    return p / p.sum()


def _chi2_ok(tokens: np.ndarray, p: np.ndarray) -> None:
    from scipy.stats import chi2

    counts = np.bincount(tokens, minlength=len(p)).astype(np.float64)
    support = p > 0
    assert counts[~support].sum() == 0, "a token with zero mass was drawn"
    expected = len(tokens) * p[support]
    stat = ((counts[support] - expected) ** 2 / expected).sum()
    threshold = chi2.ppf(1 - 1e-3, int(support.sum()) - 1)
    assert stat < threshold, f"chi2 {stat:.1f} >= {threshold:.1f}"


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# -- filters --------------------------------------------------------------------


def test_top_k_and_top_p_masks_match_jax():
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.sampling import top_k_mask, top_p_mask

    rng = np.random.default_rng(0)
    rows = np.round(rng.standard_normal((6, 32)) * 2, 1).astype(np.float32)  # ties
    for k in (0, 1, 2, 5, 32, 40):
        out = tsamp.top_k_mask(torch.from_numpy(rows), k).numpy()
        ref = np.stack([np.asarray(top_k_mask(jnp.asarray(r), k)) for r in rows])
        np.testing.assert_array_equal(out, ref)
    for p in (0.05, 0.5, 0.9, 1.0):
        out = tsamp.top_p_mask(torch.from_numpy(rows), p).numpy()
        ref = np.stack([np.asarray(top_p_mask(jnp.asarray(r), p)) for r in rows])
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        np.testing.assert_array_equal(out[~np.isinf(out)], ref[~np.isinf(ref)])


@pytest.mark.parametrize("case", ["tie_at_k", "top_p_edge_in", "top_p_edge_out"])
def test_sample_filtered_set_matches_jax(case):
    """The set ``sample_logits`` draws from equals the JAX sampler's: the
    port's filtered pool, the support of 4000 JAX draws and of 4000 port
    draws coincide.  Ties at the k-th logit are all kept; the top-p
    boundary token sits just inside or just outside p."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.ops.sampling import sample_logits

    # A tie at the 4th-5th largest for top-k; a unique boundary token
    # (exclusive cumsum 0.75) for top-p.
    head = [0.4, 0.2, 0.15, 0.1, 0.1] if case == "tie_at_k" else [0.4, 0.2, 0.15, 0.12, 0.08]
    logits = np.log(np.array(head + [0.005] * 10, np.float64)).astype(np.float32)
    top_k, top_p = {
        "tie_at_k": (4, 1.0),          # kth = 0.1: both tied tokens kept
        "top_p_edge_in": (0, 0.751),   # exclusive cumsum 0.75 < p: 4 kept
        "top_p_edge_out": (0, 0.749),  # 0.75 >= p: the 4th token dropped
    }[case]
    recent = np.full((1, 2), PAD)
    masked, idx = tsamp._filtered_pool(torch.from_numpy(logits)[None], 1.0, top_k, top_p, 1024)
    pool = set(idx[0][torch.isfinite(masked[0])].tolist())
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    jax_draws = jax.jit(jax.vmap(lambda k: sample_logits(
        k, jnp.asarray(logits), 1.0, top_k, top_p, 1.0, jnp.asarray(recent[0]))))(keys)
    port_draws = tsamp.sample_logits(
        torch.from_numpy(np.tile(logits, (4000, 1))), 1.0, top_k, top_p, 1.0,
        torch.from_numpy(np.tile(recent, (4000, 1))), _gen(0),
    )
    assert pool == set(np.asarray(jax_draws).tolist()) == set(port_draws.tolist())
    want = {"tie_at_k": {0, 1, 2, 3, 4}, "top_p_edge_in": {0, 1, 2, 3},
            "top_p_edge_out": {0, 1, 2}}[case]
    assert pool == want


# -- distributions -------------------------------------------------------------------


def test_sample_logits_chi_square():
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal(16) * 2.0).astype(np.float32)
    recent = [3, 5]
    penalty, temperature, top_k, top_p = 1.2, 0.9, 8, 0.92
    p = _plain_sample_dist(logits, recent, penalty, temperature, top_k, top_p)
    n = 20000
    rec = torch.tensor([recent + [PAD, PAD]] * n)
    draws = tsamp.sample_logits(
        torch.from_numpy(np.tile(logits, (n, 1))), temperature, top_k, top_p,
        penalty, rec, _gen(11),
    )
    _chi2_ok(draws.numpy(), p)


@pytest.mark.parametrize("draft_case", ["in_nucleus", "second", "filtered_out", "no_proposal"])
def test_spec_verify_sample_distribution(draft_case):
    """Acceptance rate equals p(draft); the emitted marginal equals p (chi
    squared), for a likely draft, a less likely one, a filtered-out draft
    (always rejected) and no proposal (a plain sample)."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(16) * 1.5).astype(np.float32)
    recent = [1, 2]
    penalty, temperature, top_k, top_p = 1.3, 1.0, 8, 0.95
    p = _plain_sample_dist(logits, recent, penalty, temperature, top_k, top_p)
    draft = {
        "in_nucleus": int(np.argmax(p)),
        "second": int(np.argsort(-p)[1]),
        "filtered_out": int(np.argmin(p + (p > 0))),
        "no_proposal": -1,
    }[draft_case]
    n = 20000
    accept, token = tsamp.spec_verify_sample(
        torch.from_numpy(np.tile(logits, (n, 1))), torch.full((n,), draft),
        temperature, top_k, top_p, penalty,
        torch.tensor([recent + [PAD, PAD]] * n), _gen(5),
    )
    accept, token = accept.numpy(), token.numpy()
    _chi2_ok(token, p)
    if draft >= 0 and p[draft] > 0:
        np.testing.assert_allclose(accept.mean(), p[draft], atol=0.02)
        assert (token[accept] == draft).all() and (token[~accept] != draft).all()
    else:
        assert not accept.any()


def test_spec_verify_sample_greedy_and_degenerate_residual():
    logits = torch.tensor([[0.1, 3.0, -1.0, 0.5]] * 2)
    recent = torch.full((2, 4), PAD)
    acc, tok = tsamp.spec_verify_sample(logits, torch.tensor([1, 2]), 0.0, 0, 1.0, 1.0,
                                        recent, None)
    assert acc.tolist() == [True, False] and tok.tolist() == [1, 1]
    # top_k = 1 on the draft: the residual is empty, so the draft is kept
    # and counted accepted whatever the uniform draw.
    acc, tok = tsamp.spec_verify_sample(logits, torch.tensor([1, 1]), 0.7, 1, 1.0, 1.0,
                                        recent, _gen(0))
    assert acc.all() and tok.tolist() == [1, 1]


def test_same_seed_same_stream():
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((64, 100)).astype(np.float32))
    recent = torch.full((64, 3), PAD)
    draw = [tsamp.sample_logits(logits, 0.8, 20, 0.95, 1.1, recent, _gen(s)) for s in (4, 4, 5)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert torch.equal(tsamp.sample_logits(logits, 0.0, 20, 0.95, 1.0, recent, None),
                       logits.argmax(-1))


# -- the sampled slice ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return models(seed=0)


def test_sampled_transcribe_same_seed_same_stream(pair):
    _, port = pair
    audio = clips((1.0, 2.3, 5.1), seed=1)
    kw = dict(max_tokens=12, temperature=0.9, top_k=50, top_p=0.95)
    a = ids_of(port.transcribe_batch(audio, seed=3, **kw))
    b = ids_of(port.transcribe_batch(audio, seed=3, **kw))
    c = ids_of(port.transcribe_batch(audio, seed=4, **kw))
    assert a == b and a != c
    assert all(0 <= t < 512 for seq in a for t in seq)
    assert port.last_stats.n_spec_forwards == 0          # plain sampled loop


@pytest.mark.parametrize("spec_sampling", [False, True])
def test_top_k_1_sampling_token_identical_to_jax(spec_sampling):
    """top_k=1 is deterministic: the sampled loop (and, with
    ``spec_sampling``, the speculative sampled loop) equals the JAX
    package's token for token."""
    jax_model, port = models(seed=0, runtime=dict(spec_sampling=spec_sampling))
    audio = clips((1.0, 2.3, 5.1), seed=1)
    kw = dict(max_tokens=20, temperature=0.7, top_k=1, seed=5)
    ref = jax_model.transcribe_batch(audio, **kw)
    out = port.transcribe_batch(audio, **kw)
    assert ids_of(out) == ids_of(ref)
    assert port.last_stats.n_spec_forwards == jax_model.last_stats.n_spec_forwards
    assert (port.last_stats.n_spec_forwards > 0) == spec_sampling
