"""Generation: prefill, the plain decode loop and the speculative loop.

Counterpart of ``qwen3_asr_tpu/runtime/generate.py`` (``_prefill_impl``
:220-248, the first token of ``_decode_setup`` :303-323, the plain
while-loop body ``_decode_machinery`` :326-409, the speculative body
``_spec_machinery`` :413-536, ``_plan_spec`` :693-713, and
``plan``/``pack_prompts``/``plan_statics``/``harvest``/``decode``
:1083-1302).  The JAX package compiles each decode loop into one
``lax.while_loop``; here each is a Python loop over eager PyTorch ops with
one host sync per iteration (``done.all()``).  The cache layout, buckets
and step semantics are the JAX package's, so greedy decoding produces the
same tokens:

  * cache ``[prompt slots 0..pb) | decode slots pb..S)``; in the plain loop
    every live lane writes the SAME decode slot ``pb + step`` each step,
    while its RoPE position is ``prompt_len + count - 1``;
  * the first token comes from the prefill logits with no repetition
    penalty; later tokens from the penalized logits over the
    ``recent_token_window`` (argmax, or ``sample_logits`` when
    ``temperature > 0``, drawn from a ``torch.Generator`` seeded by
    ``seed``);
  * a lane stops at EOS or at its token budget; finished lanes keep their
    tokens while the others run on;
  * ``speculative="auto"`` (the default) runs greedy requests of at most
    ``spec_auto_max_batch`` padded lanes through the n-gram speculative
    loop, ``"ngram"`` every greedy request; sampled requests only with
    ``spec_sampling``; never over the int8 cache.  Each verify iteration
    writes lane b's ``gamma + 1`` rows at ``pb + counts[b] - 1`` onward
    (kernel K5) and emits the accepted prefix plus one token.

Int8 (``RuntimeConfig``): with ``quantization == act_quant == "int8"`` the
prefill forward runs under the activation-quant gate (JAX
``generate.py:193-209``, ``:244``), so its matmuls take W8A8 while the
prefill lm head (M = B rows) stays weight-only; with
``kv_cache_dtype="int8"`` :meth:`Generator.decode` quantizes the freshly
prefilled bf16 cache once before the loop (JAX ``:1230-1234``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..config import RuntimeConfig, TextDecoderConfig
from ..models.decoder import decoder_forward, decoder_logits, embed_tokens, init_kv_cache
from ..ops.quant import act_quant_rows
from ..ops.quant_kv import is_quantized_kv, kv_seq_len, quantize_kv_cache
from ..ops.sampling import (
    RECENT_PAD_ID,
    TOP_K_SUBSET,
    apply_repetition_penalty,
    recent_token_window,
    sample_logits,
    spec_verify_sample,
)
from ..ops.speculative import ngram_draft
from ..tokenizer import EOS_TOKEN_IDS, PROMPT_PREFIX
from ..utils.telemetry import logger

_AUDIO_OFFSET = len(PROMPT_PREFIX)  # audio features start at slot 9


@dataclass
class _Request:
    """Per-request constants of a decode call and the token choice they
    define (greedy: penalized argmax; sample: ``sample_logits``)."""

    mode: str
    temperature: float
    top_k: int
    top_p: float
    penalty: float
    rep_ctx: int
    rep_window: int
    k_subset: int
    token_bucket: int
    generator: torch.Generator | None
    plen: torch.Tensor        # (B,) int32 prompt lengths
    max_new: torch.Tensor     # (B,) int64 token budgets
    eos: torch.Tensor         # (n_eos,) int64

    def is_eos(self, tok: torch.Tensor) -> torch.Tensor:
        return (tok[:, None] == self.eos[None, :]).any(dim=-1)

    def recent(self, tokens: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return recent_token_window(
            tokens, counts, self.rep_ctx, self.rep_window, self.token_bucket
        )

    def sample(self, logits: torch.Tensor, recent: torch.Tensor, penalty: float):
        if self.mode == "greedy":
            return apply_repetition_penalty(logits.float(), recent, penalty).argmax(dim=-1)
        return sample_logits(
            logits, self.temperature, self.top_k, self.top_p, penalty, recent,
            self.generator, self.k_subset,
        )


class Generator:
    """Prefill and greedy decode for one decoder parameter set."""

    def __init__(
        self,
        params,
        cfg: TextDecoderConfig,
        runtime: RuntimeConfig | None = None,
        eos_ids: frozenset[int] = EOS_TOKEN_IDS,
    ) -> None:
        self.params = params
        self.cfg = cfg
        self.runtime = runtime or RuntimeConfig()
        self._eos_ids = sorted(eos_ids)
        #: Decode-loop iterations of the last :meth:`decode` call (verify
        #: iterations when it speculated).
        self.last_decode_steps = 0
        #: Verify iterations of the last :meth:`decode` call, 0 when the
        #: plain loop served it.
        self.last_spec_forwards = 0

    # -- planning ---------------------------------------------------------

    def plan(
        self,
        audio_token_bucket: int,
        max_prompt_len: int,
        max_new_tokens: int,
        batch: int = 1,
    ) -> tuple[int, int, int]:
        """(prompt_bucket, token_bucket, cache_len), as the JAX package
        plans them: a 256-multiple prompt bucket and a memory-aware token
        bucket under ``kv_cache_budget_gb``.  Rows are sized as bf16 even
        with the int8 cache: the prefill holds the bf16 cache first."""
        prompt_bucket = -(-(audio_token_bucket + 32) // 256) * 256
        if max_prompt_len > prompt_bucket:
            raise ValueError(
                f"prompt length {max_prompt_len} exceeds bucket {prompt_bucket}"
            )
        cfg = self.cfg
        row_bytes = (
            cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim * 2 * 2
        )
        budget = int(self.runtime.kv_cache_budget_gb * 2**30)
        allowed_mem = budget // (row_bytes * max(batch, 1)) - prompt_bucket
        cap = max(self.runtime.max_decode_slots, allowed_mem)
        want = min(max_new_tokens, cap)
        token_bucket = self.runtime.pick_bucket(want, self.runtime.token_buckets)
        if token_bucket > cap:
            fitting = [b for b in self.runtime.token_buckets if b <= cap]
            token_bucket = max(fitting) if fitting else self.runtime.token_buckets[0]
        return prompt_bucket, token_bucket, prompt_bucket + token_bucket

    @staticmethod
    def pack_prompts(input_ids: list[list[int]], prompt_bucket: int) -> np.ndarray:
        ids = np.zeros((len(input_ids), prompt_bucket), dtype=np.int32)
        for b, seq in enumerate(input_ids):
            ids[b, : len(seq)] = seq
        return ids

    def plan_statics(
        self, token_bucket: int, temperature: float, top_k: int,
        repetition_penalty: float, repetition_context_size: int,
    ) -> tuple[str, int, int]:
        """(mode, rep_window, k_subset): "greedy" or "sample", the
        recent-token window covering ``repetition_context_size`` and the
        top-k candidate pool covering ``top_k`` (JAX ``:1139-1177``)."""
        rep_window = self.runtime.rep_window
        if repetition_penalty != 1.0:
            rep_window = self.runtime.pick_rep_window(
                repetition_context_size, token_bucket
            )
            if rep_window < min(repetition_context_size, token_bucket):
                logger.warning(
                    "repetition_context_size=%d exceeds the largest "
                    "rep_window bucket (%d) and is clamped",
                    repetition_context_size, rep_window,
                )
        k_subset = TOP_K_SUBSET
        if temperature != 0.0:
            vocab = self.cfg.vocab_size
            want = top_k if top_k > 0 else TOP_K_SUBSET
            k_subset = self.runtime.pick_top_k_subset(want, vocab)
            if top_k > 0 and k_subset < min(want, vocab):
                logger.warning(
                    "top_k=%d exceeds the largest top_k_subset bucket (%d) "
                    "and is effectively clamped", top_k, k_subset,
                )
        mode = "greedy" if temperature == 0.0 else "sample"
        return mode, rep_window, k_subset

    def _plan_spec(self, mode: str, batch: int) -> tuple[int, int] | None:
        """(gamma, ngram_n) when the request decodes speculatively, else
        None (JAX ``:693-713``): "ngram" speculates on every greedy
        request, "auto" on greedy requests of at most
        ``spec_auto_max_batch`` lanes (the padded batch); sampled requests
        also need ``spec_sampling``."""
        rt = self.runtime
        if mode == "sample" and not rt.spec_sampling:
            return None
        if rt.speculative == "ngram" or (
            rt.speculative == "auto" and batch <= rt.spec_auto_max_batch
        ):
            return rt.spec_gamma, rt.spec_ngram
        return None

    def _act_quant_ctx(self):
        """The W8A8 gate for the prefill forward, when both
        ``quantization`` and ``act_quant`` are "int8"."""
        rt = self.runtime
        if rt.quantization == "int8" and rt.act_quant == "int8":
            return act_quant_rows(rt.act_quant_min_rows)
        return contextlib.nullcontext()

    # -- prefill ----------------------------------------------------------

    def prefill(self, features, ids, n_audio, prompt_len, cache_len: int):
        """Embed the prompt, inject audio features at slots [9, 9 + n_audio),
        run the fresh-prefill forward into a new cache of ``cache_len``
        slots, and take logits at ``prompt_len - 1``.

        features (B, Ta, H); ids (B, P) right-padded prompt ids; n_audio and
        prompt_len (B,).  Returns ((keys, values), first_logits (B, vocab))."""
        cfg = self.cfg
        B, P = ids.shape
        embeds = embed_tokens(self.params, ids)
        take = min(P - _AUDIO_OFFSET, features.shape[1])
        injected = torch.zeros_like(embeds)
        injected[:, _AUDIO_OFFSET : _AUDIO_OFFSET + take] = features[:, :take].to(embeds.dtype)
        slot = torch.arange(P, device=ids.device)[None, :]
        is_audio = (slot >= _AUDIO_OFFSET) & (slot < _AUDIO_OFFSET + n_audio[:, None])
        embeds = torch.where(is_audio[:, :, None], injected, embeds)

        kv = init_kv_cache(cfg, B, cache_len, embeds.dtype, embeds.device)
        with self._act_quant_ctx():
            hidden, kv = decoder_forward(self.params, cfg, embeds, slot.expand(B, P), kv)
        last = hidden[torch.arange(B, device=ids.device), prompt_len.long() - 1]
        logits = decoder_logits(self.params, cfg, last[:, None, :])[:, 0]
        return kv, logits

    # -- decode -----------------------------------------------------------

    def decode(
        self,
        kv,
        first_logits: torch.Tensor,
        prompt_lens: list[int],
        max_tokens: list[int],
        token_bucket: int,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        repetition_penalty: float = 1.0,
        repetition_context_size: int = 100,
        seed: int = 0,
    ) -> list[list[int]]:
        """Decode every lane until EOS or its budget; returns the per-lane
        token lists (trailing EOS included).  Dispatch as JAX
        ``:1208-1302``: the speculative loop where :meth:`_plan_spec` says
        so and the cache is not int8, else the plain loop."""
        self.last_spec_forwards = 0
        if self.runtime.kv_cache_dtype == "int8" and not is_quantized_kv(kv[0]):
            kv = quantize_kv_cache(kv)      # the bf16 pair is freed on return
        mode, rep_window, k_subset = self.plan_statics(
            token_bucket, temperature, top_k, repetition_penalty,
            repetition_context_size,
        )
        device = first_logits.device
        B = first_logits.shape[0]
        generator = None
        if mode == "sample":
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
        req = _Request(
            mode=mode, temperature=temperature, top_k=top_k, top_p=top_p,
            penalty=repetition_penalty, rep_ctx=repetition_context_size,
            rep_window=rep_window, k_subset=k_subset, token_bucket=token_bucket,
            generator=generator,
            plen=torch.tensor(prompt_lens, dtype=torch.int32, device=device),
            max_new=torch.tensor(
                [min(m, token_bucket) for m in max_tokens], dtype=torch.long,
                device=device,
            ),
            eos=torch.tensor(self._eos_ids, dtype=torch.long, device=device),
        )
        # First token: from the prefill logits with no repetition penalty.
        no_recent = torch.full((B, 1), RECENT_PAD_ID, dtype=torch.long, device=device)
        first = req.sample(first_logits, no_recent, 1.0)
        tokens = torch.zeros((B, token_bucket), dtype=torch.long, device=device)
        tokens[:, 0] = first
        counts = torch.ones((B,), dtype=torch.long, device=device)
        state = (tokens, counts, req.is_eos(first) | (counts >= req.max_new), first)

        spec = self._plan_spec(mode, B)
        if spec is not None and not is_quantized_kv(kv[0]):
            tokens, counts, iters = self._spec_loop(kv, req, state, *spec)
            self.last_spec_forwards = self.last_decode_steps = iters
            counts_host = counts.cpu().numpy()
            logger.debug(
                "speculative decode: %d tokens in %d verify iterations x %d "
                "lanes (%.2f tokens/lane-forward)", int(counts_host.sum()),
                iters, B, float(counts_host.sum()) / max(iters * B, 1),
            )
            tokens_host = tokens.cpu().numpy()
            return [
                tokens_host[b, : counts_host[b]].tolist()
                for b in range(len(prompt_lens))
            ]
        tokens, counts, self.last_decode_steps = self._plain_loop(kv, req, state)
        return self.harvest(tokens, counts, len(prompt_lens), max_tokens, token_bucket)

    def _plain_loop(self, kv, req: "_Request", state):
        """One token per live lane per step (JAX ``_decode_machinery``
        :326-409): every lane writes the shared decode slot ``pb + step``
        at RoPE position ``plen + count - 1``.  Returns (tokens, counts,
        steps)."""
        tokens, counts, done, cur = state
        S = kv_seq_len(kv[0])
        tb = req.token_bucket
        prompt_bucket = S - tb
        step = 0
        while not bool(done.all()):
            pos = req.plen.long() + counts - 1
            embeds = embed_tokens(self.params, cur)[:, None, :]
            slot_step = min(prompt_bucket + step, S - 1)
            dend = min(prompt_bucket + step, S)
            hidden, kv = decoder_forward(
                self.params, self.cfg, embeds, pos[:, None], kv,
                write_slots=slot_step, decode_ctx=(req.plen, dend, prompt_bucket),
            )
            logits = decoder_logits(self.params, self.cfg, hidden)[:, 0]
            nxt = req.sample(logits, req.recent(tokens, counts), req.penalty)

            slot = counts.clamp(0, tb - 1)[:, None]
            write = torch.where(done, tokens.gather(1, slot)[:, 0], nxt)
            tokens.scatter_(1, slot, write[:, None])
            counts = counts + (~done).long()
            done = done | req.is_eos(nxt) | (counts >= req.max_new)
            cur = torch.where(done, cur, nxt)
            step += 1
        return tokens, counts, step

    def _spec_loop(self, kv, req: "_Request", state, gamma: int, ngram_n: int):
        """The speculative loop (JAX ``_spec_machinery`` :413-536): per
        iteration an n-gram draft, ONE verify forward over ``gamma + 1``
        positions per lane, and an accept chain unrolled on the device
        that emits 1..gamma+1 tokens per lane.  Greedy: a position's
        choice is used only while every earlier draft matched, so the
        stream equals the plain greedy stream.  Sample: rejection-sampling
        verification, each emitted token an exact draw from the plain
        sampler's distribution.  One host sync per iteration (``done``).
        Returns (tokens, counts, iterations)."""
        tokens, counts, done, cur = state
        S = kv_seq_len(kv[0])
        tb = req.token_bucket
        prompt_bucket = S - tb
        B = tokens.shape[0]
        T = gamma + 1
        offs = torch.arange(T, device=tokens.device)
        no_draft = torch.full((B,), -1, dtype=torch.long, device=tokens.device)
        step = 0
        while not bool(done.all()):
            draft, dvalid = ngram_draft(tokens, counts, n=ngram_n, gamma=gamma)
            ids = torch.cat([cur[:, None], draft], dim=1)                # (B, T)
            pos = (req.plen.long() + counts - 1)[:, None] + offs[None, :]
            ws = (prompt_bucket + counts - 1).to(torch.int32)           # (B,)
            hidden, kv = decoder_forward(
                self.params, self.cfg, embed_tokens(self.params, ids), pos, kv,
                write_slots=ws, decode_ctx=(req.plen, ws, prompt_bucket),
            )
            logits = decoder_logits(self.params, self.cfg, hidden)      # (B, T, V)
            if req.mode == "sample":        # -1: no proposal at that position
                proposals = torch.where(dvalid, draft, no_draft[:, None])

            # Draft rows written at rejected positions sit at or past the
            # lane's new write slot: masked (< ws) and overwritten next time.
            chain = ~done
            for t in range(T):
                win = req.recent(tokens, counts)
                if req.mode == "greedy":
                    pen = apply_repetition_penalty(logits[:, t], win, req.penalty)
                    out_t = pen.argmax(dim=-1)
                else:
                    d_t = proposals[:, t] if t < gamma else no_draft
                    acc_t, out_t = spec_verify_sample(
                        logits[:, t], d_t, req.temperature, req.top_k, req.top_p,
                        req.penalty, win, req.generator, req.k_subset,
                    )
                emit = chain
                slot = counts.clamp(0, tb - 1)[:, None]
                keep = tokens.gather(1, slot)[:, 0]
                tokens.scatter_(1, slot, torch.where(emit, out_t, keep)[:, None])
                counts = counts + emit.long()
                newly_done = emit & (req.is_eos(out_t) | (counts >= req.max_new))
                done = done | newly_done
                cur = torch.where(emit & ~done, out_t, cur)
                if t < gamma:
                    if req.mode == "greedy":
                        ok = dvalid[:, t] & (out_t == draft[:, t])
                    else:
                        ok = acc_t
                    chain = emit & ~newly_done & ok
            step += 1
        return tokens, counts, step

    def harvest(
        self, tokens, counts, n: int, max_tokens: list[int], token_bucket: int
    ) -> list[list[int]]:
        """Per-lane token lists + the budget-exhaustion warning."""
        tokens_host = tokens.cpu().numpy()
        counts_host = counts.cpu().numpy()
        out = [tokens_host[b, : counts_host[b]].tolist() for b in range(n)]
        for b, toks in enumerate(out):
            budget = min(max_tokens[b], token_bucket)
            if (
                len(toks) >= budget
                and toks
                and toks[-1] not in self._eos_ids
                and max_tokens[b] > token_bucket
            ):
                logger.warning(
                    "sequence %d exhausted its %d-token decode budget without "
                    "EOS (requested max_tokens=%d was clamped by "
                    "max_decode_slots=%d); transcript may be truncated",
                    b, budget, max_tokens[b], self.runtime.max_decode_slots,
                )
        return out
