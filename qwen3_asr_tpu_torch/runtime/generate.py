"""Greedy generation: prefill and the batched decode loop.

Counterpart of ``qwen3_asr_tpu/runtime/generate.py`` (``_prefill_impl``
:220-248, the plain while-loop body ``_decode_machinery`` :326-409, and
``plan``/``pack_prompts``/``plan_statics``/``harvest`` :1083-1206).  The
JAX package compiles the whole decode loop into one ``lax.while_loop``;
here it is a Python loop over eager PyTorch ops with one host sync per step
(``done.all()``).  The cache layout, buckets and step semantics are the
JAX package's, so both produce the same tokens:

  * cache ``[prompt slots 0..pb) | decode slots pb..S)``; every live lane
    writes the SAME decode slot ``pb + step`` each step, while its RoPE
    position is ``prompt_len + count - 1``;
  * the first token is the argmax of the prefill logits with no repetition
    penalty; later tokens are the argmax of the penalized logits over the
    ``recent_token_window``;
  * a lane stops at EOS or at its token budget; finished lanes keep their
    tokens while the others run on.

Int8 (``RuntimeConfig``): with ``quantization == act_quant == "int8"`` the
prefill forward runs under the activation-quant gate (JAX
``generate.py:193-209``, ``:244``), so its matmuls take W8A8 while the
prefill lm head (M = B rows) stays weight-only; with
``kv_cache_dtype="int8"`` :meth:`Generator.decode` quantizes the freshly
prefilled bf16 cache once before the loop (JAX ``:1230-1234``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import RuntimeConfig, TextDecoderConfig
from ..models.decoder import decoder_forward, decoder_logits, embed_tokens, init_kv_cache
from ..ops.quant import act_quant_rows
from ..ops.quant_kv import is_quantized_kv, kv_seq_len, quantize_kv_cache
from ..ops.sampling import apply_repetition_penalty, recent_token_window
from ..tokenizer import EOS_TOKEN_IDS, PROMPT_PREFIX
from ..utils.telemetry import logger

_AUDIO_OFFSET = len(PROMPT_PREFIX)  # audio features start at slot 9


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
        #: Decode-loop iterations of the last :meth:`decode` call.
        self.last_decode_steps = 0

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
        """(mode, rep_window, k_subset) for a greedy request; sampling
        (temperature > 0) is not ported yet."""
        if temperature != 0.0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet"
            )
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
        return "greedy", rep_window, 1024

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
        """Greedy-decode every lane until EOS or its budget; returns the
        per-lane token lists (trailing EOS included).  ``top_p``, ``top_k``
        and ``seed`` only matter to sampling, which is not ported."""
        _, rep_window, _ = self.plan_statics(
            token_bucket, temperature, top_k, repetition_penalty,
            repetition_context_size,
        )
        if self.runtime.kv_cache_dtype == "int8" and not is_quantized_kv(kv[0]):
            kv = quantize_kv_cache(kv)      # the bf16 pair is freed on return
        cfg = self.cfg
        device = first_logits.device
        B = first_logits.shape[0]
        S = kv_seq_len(kv[0])
        prompt_bucket = S - token_bucket
        plen = torch.tensor(prompt_lens, dtype=torch.int32, device=device)
        max_new = torch.tensor(
            [min(m, token_bucket) for m in max_tokens], dtype=torch.long, device=device
        )

        eos = torch.tensor(self._eos_ids, dtype=torch.long, device=device)

        def is_eos(tok):
            return (tok[:, None] == eos[None, :]).any(dim=-1)

        first = first_logits.float().argmax(dim=-1)
        tokens = torch.zeros((B, token_bucket), dtype=torch.long, device=device)
        tokens[:, 0] = first
        counts = torch.ones((B,), dtype=torch.long, device=device)
        done = is_eos(first) | (counts >= max_new)
        cur = first
        step = 0
        while not bool(done.all()):
            pos = plen.long() + counts - 1
            embeds = embed_tokens(self.params, cur)[:, None, :]
            slot_step = min(prompt_bucket + step, S - 1)
            dend = min(prompt_bucket + step, S)
            hidden, kv = decoder_forward(
                self.params, cfg, embeds, pos[:, None], kv,
                write_slots=slot_step, decode_ctx=(plen, dend, prompt_bucket),
            )
            logits = decoder_logits(self.params, cfg, hidden)[:, 0]
            recent = recent_token_window(
                tokens, counts, repetition_context_size, rep_window, token_bucket
            )
            nxt = apply_repetition_penalty(logits, recent, repetition_penalty).argmax(dim=-1)

            slot = counts.clamp(0, token_bucket - 1)[:, None]
            write = torch.where(done, tokens.gather(1, slot)[:, 0], nxt)
            tokens.scatter_(1, slot, write[:, None])
            counts = counts + (~done).long()
            done = done | is_eos(nxt) | (counts >= max_new)
            cur = torch.where(done, cur, nxt)
            step += 1
        self.last_decode_steps = step
        return self.harvest(tokens, counts, len(prompt_lens), max_tokens, token_bucket)

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
