"""Generation: prefill, the plain decode loop and the speculative loop.

Counterpart of ``qwen3_asr_tpu/runtime/generate.py`` (``_prefill_impl``
:220-248, the first token of ``_decode_setup`` :303-323, the plain
while-loop body ``_decode_machinery`` :326-409, the speculative body
``_spec_machinery`` :413-536, ``_plan_spec`` :693-713,
``plan``/``pack_prompts``/``plan_statics``/``harvest``/``decode``
:1083-1302, and the live sessions' ``advance``/``embed_ids``
:156-217).  The JAX package compiles each decode loop into one
``lax.while_loop``.  Here each loop is a step function of device state,
:meth:`Generator._plain_step` and :meth:`Generator._spec_step`, which read
and write only device tensors (the state ``tokens``, ``counts``, ``done``,
``cur`` and the live-step counter, and the request's values, sampling
parameters included), and a loop that runs it:

  * on CUDA tensors under decode mode "auto", "5" or "0", each step is
    captured once per bucket, decode mode and KV writer as a CUDA graph
    and replayed in blocks, with one look at ``done`` per block
    (``runtime/graphs.py``).  Under "0" the graph holds the plain
    attention, which reads the decode ends from the device and never
    waits for it, and the standalone K3 (K3-int8) writer; under the "xla"
    KV writer (``models/decoder.py:KV_WRITER_MODE``) the plain writers,
    which never wait for the device either.  A step that waits for the
    device inside a capture raises: no loop turns eager for it;
  * on CPU tensors the same step runs eagerly in the same blocks: the
    plain version of the graphed loop;
  * decode modes "3" and "4" (K11a, K11b take the decode end as a host
    int) and ``decode(eager=True)`` run one step per look at ``done``.

The cache layout, buckets and step semantics are the JAX package's, so
greedy decoding produces the same tokens:

  * cache ``[prompt slots 0..pb) | decode slots pb..S)``; in the plain loop
    every live lane writes the SAME decode slot ``min(pb + step, S - 1)``
    each step (the attention reads up to ``min(pb + step, S)``), while its
    RoPE position is ``prompt_len + count - 1``; ``step`` counts the live
    steps, so a step taken after every lane is done changes no token,
    count or flag and stays inside the cache;
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

Tensor parallelism (``Generator(..., tp=...)``, parameters this rank's
shards): the cache holds the local KV heads and is planned for them; every
rank of the group runs the same loop on the same gathered logits, so a
sampled call, seeded alike in every rank, draws the same tokens in all of
them.  Under ``tp`` the loop runs eagerly, in the same blocks as on the CPU:
a gloo collective cannot be captured in a CUDA graph, and capturing NCCL's
is later work (ROADMAP).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..config import RuntimeConfig, TextDecoderConfig
from ..models import decoder as _decoder
from ..models.decoder import (
    decoder_forward,
    decoder_logits,
    embed_tokens,
    init_kv_cache,
    local_heads,
)
from ..ops.kernels import _build
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
from . import graphs as _graphs

_AUDIO_OFFSET = len(PROMPT_PREFIX)  # audio features start at slot 9


def _load(dst, src) -> None:
    """Copy every tensor field of the dataclass ``src`` into ``dst``'s."""
    for f in fields(dst):
        a = getattr(dst, f.name)
        if isinstance(a, torch.Tensor):
            a.copy_(getattr(src, f.name))


def _clone(obj, **changes):
    """A copy of the dataclass ``obj`` with its tensor fields cloned."""
    return replace(obj, **{
        f.name: getattr(obj, f.name).clone() for f in fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    }, **changes)


@dataclass
class _Request:
    """Per-request values of a decode call and the token choice they define
    (greedy: penalized argmax; sample: ``sample_logits``).  ``mode``,
    ``rep_window``, ``k_subset`` and ``token_bucket`` are static, as in the
    JAX package; every other value is a device tensor, read by the step."""

    mode: str
    rep_window: int
    k_subset: int
    token_bucket: int
    generator: torch.Generator | None
    plen: torch.Tensor         # (B,) int32 prompt lengths
    max_new: torch.Tensor      # (B,) int64 token budgets
    eos: torch.Tensor          # (n_eos,) int64
    temperature: torch.Tensor  # 0-d float32
    top_k: torch.Tensor        # 0-d int64
    top_p: torch.Tensor        # 0-d float32
    penalty: torch.Tensor      # 0-d float32
    rep_ctx: torch.Tensor      # 0-d int64

    def is_eos(self, tok: torch.Tensor) -> torch.Tensor:
        return (tok[:, None] == self.eos[None, :]).any(dim=-1)

    def recent(self, tokens: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return recent_token_window(
            tokens, counts, self.rep_ctx, self.rep_window, self.token_bucket
        )

    def sample(self, logits: torch.Tensor, recent: torch.Tensor, penalty):
        if self.mode == "greedy":
            return apply_repetition_penalty(logits.float(), recent, penalty).argmax(dim=-1)
        return sample_logits(
            logits, self.temperature, self.top_k, self.top_p, penalty, recent,
            self.generator, self.k_subset,
        )


@dataclass
class _State:
    """The decode loops' state on the device, updated in place by a step."""

    tokens: torch.Tensor       # (B, token_bucket) int64
    counts: torch.Tensor       # (B,) int64 tokens emitted
    done: torch.Tensor         # (B,) bool
    cur: torch.Tensor          # (B,) int64 the token fed next
    steps: torch.Tensor        # 0-d int64 live steps taken


class Generator:
    """Prefill and greedy decode for one decoder parameter set."""

    def __init__(
        self,
        params,
        cfg: TextDecoderConfig,
        runtime: RuntimeConfig | None = None,
        eos_ids: frozenset[int] = EOS_TOKEN_IDS,
        tp=None,
    ) -> None:
        self.params = params
        self.cfg = cfg
        self.runtime = runtime or RuntimeConfig()
        #: The tensor-parallel group (``parallel.collectives.TP``) or None.
        self.tp = tp
        #: The kernels' scratch for every launch of this generator and of the
        #: graphs it captures (``ops/kernels/_build.py`` ``Scratch``).
        self.scratch = _build.Scratch()
        self._eos_ids = sorted(eos_ids)
        #: Decode-loop iterations of the last :meth:`decode` call (verify
        #: iterations when it speculated).
        self.last_decode_steps = 0
        #: Verify iterations of the last :meth:`decode` call, 0 when the
        #: plain loop served it.
        self.last_spec_forwards = 0
        #: Steps the last :meth:`decode` ran (graph replays on CUDA, live
        #: steps plus the no-op steps of its last blocks), and its looks at
        #: ``done`` (host syncs before the result is read).
        self.last_replays = 0
        self.last_host_syncs = 0
        #: The bucket of the last :meth:`decode` call: (B, S, token_bucket,
        #: mode, rep_window, k_subset, cache dtype, spec (gamma, n) or None,
        #: decode kernel mode, KV writer), the key of its captured graph on
        #: CUDA.
        self.last_bucket: tuple | None = None
        #: The captured decode graphs and their cache arena (CUDA only).
        self.graphs: _graphs.DecodeGraphs | None = None

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
        with the int8 cache: the prefill holds the bf16 cache first; under
        ``tp`` they hold this rank's KV heads."""
        prompt_bucket = -(-(audio_token_bucket + 32) // 256) * 256
        if max_prompt_len > prompt_bucket:
            raise ValueError(
                f"prompt length {max_prompt_len} exceeds bucket {prompt_bucket}"
            )
        cfg = self.cfg
        row_bytes = (
            cfg.num_hidden_layers * local_heads(cfg, self.tp)[1] * cfg.head_dim * 2 * 2
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

    # -- incremental prompt advance (streaming sessions) -------------------

    @_build.owned
    def advance(self, kv, embeds, positions, write_slot: int, last_index: int):
        """Append T prompt tokens to an existing cache (the cached forward,
        JAX ``generate.py:156-198``): K/V rows land at slots ``[write_slot,
        write_slot + T)`` of ``kv``, updated in place, and the f32 logits
        are taken at ``last_index`` within the new span, as :meth:`prefill`
        takes them.  ``embeds`` (B, T, H); ``positions`` (B, T) RoPE
        positions.  The incremental sessions (``incremental.py``) extend
        their decoder prefix with it one encoder window at a time; the
        offline paths never call it.  Returns (kv, logits (B, vocab))."""
        positions = torch.as_tensor(positions, dtype=torch.long, device=embeds.device)
        with self._act_quant_ctx():
            hidden, kv = decoder_forward(self.params, self.cfg, embeds, positions, kv,
                                         write_slots=int(write_slot), tp=self.tp)
            logits = decoder_logits(self.params, self.cfg, hidden[:, last_index : last_index + 1],
                                    tp=self.tp)
        return kv, logits[:, 0]

    def embed_ids(self, ids) -> torch.Tensor:
        """Embedded token ids (B, T) -> (B, T, H) on the parameters' device
        (JAX ``generate.py:211-217``), for the sessions' prefix and suffix
        spans."""
        device = self.params["final_norm"].device
        return embed_tokens(self.params, torch.as_tensor(ids, device=device), tp=self.tp)

    # -- prefill ----------------------------------------------------------

    @_build.owned
    def prefill(self, features, ids, n_audio, prompt_len, cache_len: int,
                arena: bool = False):
        """Embed the prompt, inject audio features at slots [9, 9 + n_audio),
        run the fresh-prefill forward into a zeroed cache of ``cache_len``
        slots, and take logits at ``prompt_len - 1``.  With ``arena`` on CUDA
        (and no ``tp``) the cache is the decode graphs' arena view (valid
        until the next such prefill), so the graphed decode takes it without
        a copy.

        features (B, Ta, H); ids (B, P) right-padded prompt ids; n_audio and
        prompt_len (B,).  Returns ((keys, values), first_logits (B, vocab))."""
        cfg = self.cfg
        B, P = ids.shape
        embeds = embed_tokens(self.params, ids, tp=self.tp)
        take = min(P - _AUDIO_OFFSET, features.shape[1])
        injected = torch.zeros_like(embeds)
        injected[:, _AUDIO_OFFSET : _AUDIO_OFFSET + take] = features[:, :take].to(embeds.dtype)
        slot = torch.arange(P, device=ids.device)[None, :]
        is_audio = (slot >= _AUDIO_OFFSET) & (slot < _AUDIO_OFFSET + n_audio[:, None])
        embeds = torch.where(is_audio[:, :, None], injected, embeds)

        if arena and embeds.is_cuda and self.tp is None:
            kv = tuple(v.zero_() for v in self._arena_kv(
                (cfg.num_hidden_layers, B, cfg.num_key_value_heads, cache_len, cfg.head_dim),
                embeds.dtype, embeds.device,
            ))
        else:
            kv = init_kv_cache(cfg, B, cache_len, embeds.dtype, embeds.device, tp=self.tp)
        with self._act_quant_ctx():
            hidden, kv = decoder_forward(self.params, cfg, embeds, slot.expand(B, P), kv,
                                         tp=self.tp)
        last = hidden[torch.arange(B, device=ids.device), prompt_len.long() - 1]
        logits = decoder_logits(self.params, cfg, last[:, None, :], tp=self.tp)[:, 0]
        return kv, logits

    # -- decode -----------------------------------------------------------

    def _graphs_on(self, device: torch.device) -> _graphs.DecodeGraphs:
        if self.graphs is None or self.graphs.device != device:
            self.graphs = _graphs.DecodeGraphs(device)
        return self.graphs

    def _arena_kv(self, shape, dtype, device, q8: bool = False):
        """(keys, values) views of the arena: bf16/f32 tensors of ``shape``,
        or with ``q8`` the int8 cache's ``{"q", "s"}`` pairs."""
        g = self._graphs_on(device)
        if not q8:
            return g.view("k", shape, dtype), g.view("v", shape, dtype)
        return tuple(
            {"q": g.view(f"{n}q", shape, torch.int8),
             "s": g.view(f"{n}s", shape[:-1], torch.float32)}
            for n in "kv"
        )

    def _graph_cache(self, kv):
        """The cache the graphed loop runs on: ``kv`` in the arena, quantized
        there when ``kv_cache_dtype`` is int8, copied there when it lies
        elsewhere (a prefill made without ``arena``)."""
        q8 = is_quantized_kv(kv[0])
        src = kv[0]["q"] if q8 else kv[0]
        quantize = not q8 and self.runtime.kv_cache_dtype == "int8"
        out = self._arena_kv(tuple(src.shape), src.dtype, src.device, q8 or quantize)
        if quantize:
            return quantize_kv_cache(kv, out=out)
        if q8:
            for o, c in zip(out, kv):
                for part in "qs":
                    if o[part].data_ptr() != c[part].data_ptr():
                        o[part].copy_(c[part])
        else:
            for o, c in zip(out, kv):
                if o.data_ptr() != c.data_ptr():
                    o.copy_(c)
        return out

    @_build.owned
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
        eager: bool = False,
        plain: bool = False,
    ) -> list[list[int]]:
        """Decode every lane until EOS or its budget; returns the per-lane
        token lists (trailing EOS included).  Dispatch as JAX
        ``:1208-1302``: the speculative loop where :meth:`_plan_spec` says
        so and the cache is not int8, else the plain loop.

        On CUDA tensors under decode mode "auto", "5" or "0" the loop
        replays the bucket's captured step graph (captured on first use) in
        blocks of ``graphs.BLOCK`` steps; on CPU tensors the same step runs
        eagerly in the same blocks, as do CUDA tensors under ``tp`` (no
        graphs on a tp group).  Decode modes "3" and "4", whose kernels K11a
        and K11b take the decode end as a host int, and ``eager=True`` (the
        graphs' oracle on the card) run one eager step per look at
        ``done``.  ``plain=True`` runs the plain loop whatever
        :meth:`_plan_spec` says, as the JAX package's incremental sessions
        call its plain ``_decode`` (JAX ``incremental.py:395-418``).  A
        failed capture or replay raises."""
        self.last_spec_forwards = 0
        mode, rep_window, k_subset = self.plan_statics(
            token_bucket, temperature, top_k, repetition_penalty,
            repetition_context_size,
        )
        device = first_logits.device
        B = first_logits.shape[0]
        host_ends = _decoder.DECODE_KERNEL_MODE in ("3", "4")
        graphed = device.type == "cuda" and self.tp is None and not (eager or host_ends)
        if graphed:
            kv = self._graph_cache(kv)
        elif self.runtime.kv_cache_dtype == "int8" and not is_quantized_kv(kv[0]):
            kv = quantize_kv_cache(kv)      # the bf16 pair is freed on return
        q8 = is_quantized_kv(kv[0])
        spec = None if q8 or plain else self._plan_spec(mode, B)
        key = self.last_bucket = (
            B, kv_seq_len(kv[0]), token_bucket, mode, rep_window, k_subset,
            "int8" if q8 else kv[0].dtype, spec, _decoder.DECODE_KERNEL_MODE,
            _decoder.KV_WRITER_MODE,
        )
        entry = self._graphs_on(device).get(key) if graphed else None
        generator = None
        if mode == "sample":
            generator = entry[0][0].generator if entry else torch.Generator(device=device)

        req = self._request(
            (mode, rep_window, k_subset), token_bucket, generator, prompt_lens,
            max_tokens, temperature, top_p, top_k, repetition_penalty,
            repetition_context_size, device,
        )
        state = self._first_state(req, first_logits, seed)
        if graphed:
            if entry is None:
                statics = (_clone(req), _clone(state))
                step = self._step(kv, *statics, spec)
                graph = self.graphs.capture(key, statics, lambda: step(0), generator)
                logger.info("decode graph captured in %.1f ms: B=%d S=%d token_bucket=%d "
                            "%s spec=%s", self.graphs.last_capture_ms, *key[:4], spec)
                # The warm-up step drew numbers: draw the first token anew.
                state = self._first_state(req, first_logits, seed)
            else:
                statics, graph = entry
            _load(statics[0], req)
            _load(statics[1], state)
            state = statics[1]
            self.last_replays, self.last_host_syncs = _graphs.run_blocks(
                graph.replay, state.done, _graphs.BLOCK, ahead=True)
        else:
            block = 1 if eager or host_ends else _graphs.BLOCK
            self.last_replays, self.last_host_syncs = _graphs.run_blocks(
                self._step(kv, req, state, spec, host_ends), state.done, block)
        steps = int(state.steps)
        self.last_decode_steps = steps
        logger.debug("decode: %d live steps, %d replays, %d looks at done (%s)",
                     steps, self.last_replays, self.last_host_syncs,
                     "graphed" if graphed else "eager")
        if spec is not None:
            self.last_spec_forwards = steps
            counts_host = state.counts.cpu().numpy()
            logger.debug(
                "speculative decode: %d tokens in %d verify iterations x %d "
                "lanes (%.2f tokens/lane-forward)", int(counts_host.sum()),
                steps, B, float(counts_host.sum()) / max(steps * B, 1),
            )
            tokens_host = state.tokens.cpu().numpy()
            return [
                tokens_host[b, : counts_host[b]].tolist()
                for b in range(len(prompt_lens))
            ]
        return self.harvest(state.tokens, state.counts, len(prompt_lens), max_tokens,
                            token_bucket)

    def _request(self, statics, token_bucket, generator, prompt_lens, max_tokens,
                 temperature, top_p, top_k, repetition_penalty,
                 repetition_context_size, device) -> _Request:
        """A decode call's :class:`_Request`: ``statics`` = (mode,
        rep_window, k_subset) from :meth:`plan_statics`, the rest as
        :meth:`decode` takes them, made device tensors."""
        mode, rep_window, k_subset = statics

        def dev(value, dtype):
            return torch.tensor(value, dtype=dtype, device=device)

        return _Request(
            mode=mode, rep_window=rep_window, k_subset=k_subset,
            token_bucket=token_bucket, generator=generator,
            plen=dev(prompt_lens, torch.int32),
            max_new=dev([min(m, token_bucket) for m in max_tokens], torch.long),
            eos=dev(self._eos_ids, torch.long),
            temperature=dev(temperature, torch.float32), top_k=dev(top_k, torch.long),
            top_p=dev(top_p, torch.float32), penalty=dev(repetition_penalty, torch.float32),
            rep_ctx=dev(repetition_context_size, torch.long),
        )

    def _first_state(self, req: _Request, first_logits: torch.Tensor, seed: int) -> _State:
        """The state after the first token, drawn from the prefill logits
        with no repetition penalty (from ``req.generator`` seeded anew)."""
        B = first_logits.shape[0]
        device = first_logits.device
        if req.generator is not None:
            req.generator.manual_seed(seed)
        no_recent = torch.full((B, 1), RECENT_PAD_ID, dtype=torch.long, device=device)
        first = req.sample(first_logits, no_recent, 1.0)
        tokens = torch.zeros((B, req.token_bucket), dtype=torch.long, device=device)
        tokens[:, 0] = first
        counts = torch.ones((B,), dtype=torch.long, device=device)
        done = req.is_eos(first) | (counts >= req.max_new)
        return _State(tokens, counts, done, first,
                      torch.zeros((), dtype=torch.long, device=device))

    def _step(self, kv, req: _Request, state: _State, spec, host_ends: bool = False):
        """The loop's step as a function of the step index: the speculative
        verify iteration, or the plain step (given the index as its host
        step with ``host_ends``)."""
        if spec is not None:
            return lambda _i: self._spec_step(kv, req, state, *spec)
        if host_ends:
            return lambda i: self._plain_step(kv, req, state, host_step=i)
        return lambda _i: self._plain_step(kv, req, state)

    def _plain_step(self, kv, req: _Request, st: _State, host_step: int | None = None):
        """One token per live lane (JAX ``_decode_machinery`` :326-409): every
        lane writes the shared decode slot ``min(pb + step, S - 1)`` at RoPE
        position ``plen + count - 1``, attending up to ``min(pb + step, S)``.
        Slot and end are (B,) int32 tensors computed from the live-step
        counter on the device (K2, or K4 on the int8 cache, with the fused
        row store), or ints from ``host_step`` (the decode modes "3"/"4"
        loop: K11a/K11b, then K3).  Updates ``st`` in place."""
        S = kv_seq_len(kv[0])
        tb = req.token_bucket
        prompt_bucket = S - tb
        B = st.counts.shape[0]
        live = ~st.done
        if host_step is None:
            at = (st.steps + prompt_bucket).to(torch.int32).expand(B)
            slot_step, dend = at.clamp(max=S - 1), at.clamp(max=S)
        else:
            slot_step = min(prompt_bucket + host_step, S - 1)
            dend = min(prompt_bucket + host_step, S)
        pos = req.plen.long() + st.counts - 1
        embeds = embed_tokens(self.params, st.cur, tp=self.tp)[:, None, :]
        hidden, kv = decoder_forward(
            self.params, self.cfg, embeds, pos[:, None], kv,
            write_slots=slot_step, decode_ctx=(req.plen, dend, prompt_bucket), tp=self.tp,
        )
        logits = decoder_logits(self.params, self.cfg, hidden, tp=self.tp)[:, 0]
        nxt = req.sample(logits, req.recent(st.tokens, st.counts), req.penalty)

        slot = st.counts.clamp(0, tb - 1)[:, None]
        write = torch.where(st.done, st.tokens.gather(1, slot)[:, 0], nxt)
        st.tokens.scatter_(1, slot, write[:, None])
        counts = st.counts + live.long()
        done = st.done | req.is_eos(nxt) | (counts >= req.max_new)
        st.cur.copy_(torch.where(done, st.cur, nxt))
        st.counts.copy_(counts)
        st.done.copy_(done)
        st.steps.add_(live.any().long())

    def _spec_step(self, kv, req: _Request, st: _State, gamma: int, ngram_n: int):
        """One iteration of the speculative loop (JAX ``_spec_machinery``
        :413-536): an n-gram draft, ONE verify forward over ``gamma + 1``
        positions per lane, and an accept chain unrolled on the device
        that emits 1..gamma+1 tokens per lane.  Greedy: a position's
        choice is used only while every earlier draft matched, so the
        stream equals the plain greedy stream.  Sample: rejection-sampling
        verification, each emitted token an exact draw from the plain
        sampler's distribution.  Updates ``st`` in place."""
        tokens, counts, done, cur = st.tokens, st.counts, st.done, st.cur
        S = kv_seq_len(kv[0])
        tb = req.token_bucket
        prompt_bucket = S - tb
        B = tokens.shape[0]
        T = gamma + 1
        offs = torch.arange(T, device=tokens.device)
        no_draft = torch.full((B,), -1, dtype=torch.long, device=tokens.device)
        any_live = (~done).any()
        draft, dvalid = ngram_draft(tokens, counts, n=ngram_n, gamma=gamma)
        ids = torch.cat([cur[:, None], draft], dim=1)                # (B, T)
        pos = (req.plen.long() + counts - 1)[:, None] + offs[None, :]
        ws = (prompt_bucket + counts - 1).to(torch.int32)           # (B,)
        hidden, kv = decoder_forward(
            self.params, self.cfg, embed_tokens(self.params, ids, tp=self.tp), pos, kv,
            write_slots=ws, decode_ctx=(req.plen, ws, prompt_bucket), tp=self.tp,
        )
        logits = decoder_logits(self.params, self.cfg, hidden, tp=self.tp)   # (B, T, V)
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
        st.counts.copy_(counts)
        st.done.copy_(done)
        st.cur.copy_(cur)
        st.steps.add_(any_live.long())

    def close(self) -> None:
        """Free the captured decode graphs, their cache arena and the
        kernels' scratch."""
        if self.graphs is not None:
            self.graphs.close()
            self.graphs = None
        self.scratch.clear()

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
