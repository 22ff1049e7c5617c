"""Slot-based continuous-batching decode engine (PyTorch).

Counterpart of ``qwen3_asr_tpu/runtime/engine.py``.  One persistent KV cache
of ``n_slots`` sequence slots lives on the device, and three operations
interleave at chunk boundaries:

  * ``admit``  -- place a prefilled group's prompt K/V and first token into
    free slots while other slots are mid-decode;
  * ``step``   -- run up to ``chunk_steps`` decode iterations for every live
    slot, each slot at its own depth (per-slot RoPE positions, write rows and
    attention intervals);
  * ``retire`` -- harvest finished sequences and free their slots without
    stopping the batch.

The cache is flat, (L, n_slots, Hkv, prompt_bucket + token_bucket, D) with
per-lane write slots (kernel K2 storing the rows itself, K3 fused; K4 with
K3-int8 fused on the int8 cache; K5 for speculative chunks), or paged
(``paged=True``): a pool of ``page_size``-row pages (L, n_pages, Hkv, PS, D)
that each slot owns only as far as its prompt and transcript reach, through
a per-slot page table (kernels K6, K7, each with K8 fused).
Physical page 0 is a reserved trash page that no table entry owns: idle
lanes and rows past a slot's table write there.  All-greedy chunks on narrow
engines run speculative verify iterations (``RuntimeConfig.spec_engine``)
that emit exactly the plain greedy stream.

A chunk runs one iteration function, :meth:`DecodeEngine._chunk_step`,
which reads and writes only static device tensors: the slots' state
(tokens, counts, done flags, current tokens), the chunk's counters (per-lane
verify forwards, live iterations) and the control buffers (live mask,
prompt lengths, budgets, sampling values, seeds, page table), which
admissions, retirements and page events fill in place.  On CUDA tensors
each bucket's iteration (width, greedy/sampled, speculative, rep window,
candidate pool, cache dtype, paged, decode mode, KV writer) is captured once
as a CUDA graph and replayed in blocks of ``graphs.BLOCK``, with one look at
the lanes a block and one status fetch a chunk, as the JAX package runs a
chunk as one compiled program; on CPU tensors the same iteration runs
eagerly in the same blocks, and ``eager=True`` runs one iteration a look
(the graphs' oracle on the card).  A chunk stops at ``k_steps``
iterations or once no live lane is undone; iterations run after that are
no-ops on every slot's tokens, counts and flags, and a device counter
counts only the live ones.  The JAX package's default ``"scan"`` chunk
shape exists for the TPU's persistent compile cache and is not carried
over; greedy tokens are the same under both.  Sampled lanes draw from
counter streams keyed by (the request's seed, the token index) and each
candidate's vocabulary id (``ops/sampling.py`` ``sample_streams``), so a
request's sampled stream depends only on its own seed and tokens, not on
its slot, its neighbours, a pause or the block size.  Every public method
runs under ``torch.inference_mode()``.

On a tp group (the generator's ``tp``) each rank's engine holds its own KV
heads (a pool of the one-device engine's page count, ``1/tp`` of its
bytes) and runs every forward with the group's collectives; its host state
(slots, page tables, counters) is the one-device engine's.  Every host
decision reads device values that the gathered logits make bit-identical
on every rank (the looks at the lanes, the first tokens, the status
fetch), so ranks that apply the same operations in the same order stay in
lockstep: ``serving/server.py`` has one rank drive and broadcast them
(``parallel/lockstep.py``).  On an NCCL group the captured chunks hold the
group's collectives, and every rank captures the same buckets in the same
order; a gloo group's collectives stage through host memory, so its chunks
run eagerly in blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..config import TextDecoderConfig
from ..models import decoder as _decoder
from ..models.decoder import (
    decoder_forward,
    decoder_logits,
    decoder_paged_step,
    decoder_paged_verify,
    embed_tokens,
    local_heads,
)
from ..ops import speculative
from ..ops.kernels import _build
from ..ops.kernels.decode_attention_paged import MAX_QUERY_ROWS
from ..ops.quant_kv import quantize_kv
from ..ops.sampling import (
    RECENT_PAD_ID,
    TOP_K_SUBSET,
    apply_repetition_penalty,
    recent_token_window,
    sample_streams,
)
from ..utils.telemetry import logger
from . import graphs as _graphs


def _spec_accept_chain(
    logits, draft, dvalid, tokens, counts, done, cur, live,
    recent_window, rep_pen, max_new, token_bucket, is_eos, gamma,
):
    """The greedy accept chain of a speculative chunk iteration (JAX
    ``engine.py:68-103``): position t's penalized argmax is emitted only
    while every earlier draft matched the argmax at its own position, the
    penalty window recomputed after each emitted token, so the stream is
    the sequential greedy stream.  ``tokens`` is updated in place; returns
    (tokens, counts, done, cur)."""
    chain = live & ~done
    for t in range(gamma + 1):
        pen = apply_repetition_penalty(
            logits[:, t].float(), recent_window(tokens, counts), rep_pen
        )
        out_t = pen.argmax(dim=-1)
        emit = chain
        slot = counts.clamp(0, token_bucket - 1)[:, None]
        keep = tokens.gather(1, slot)[:, 0]
        tokens.scatter_(1, slot, torch.where(emit, out_t, keep)[:, None])
        counts = counts + emit.long()
        newly_done = emit & (is_eos(out_t) | (counts >= max_new))
        done = done | newly_done
        cur = torch.where(emit & ~done, out_t, cur)
        if t < gamma:
            chain = emit & ~newly_done & dvalid[:, t] & (out_t == draft[:, t])
    return tokens, counts, done, cur


def _seed64(seed: int) -> int:
    """A request's seed as the int64 its counter stream is keyed by (the
    low 64 bits, two's complement)."""
    return (int(seed) + 2**63) % 2**64 - 2**63


@dataclass
class SlotRequest:
    """One admitted clip's bookkeeping (host side)."""

    samples: np.ndarray
    prompt: list[int]
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.2
    repetition_context_size: int = 100
    seed: int = 0
    meta: Any = None  # opaque caller payload (e.g. a Future)


@dataclass
class EngineStats:
    """Continuous-batching counters."""

    admitted: int = 0
    retired: int = 0
    chunks: int = 0
    steps: int = 0
    #: Live chunk iterations (plain steps or verify forwards), counted on
    #: the device: iterations with a live lane not yet done.
    iterations: int = 0
    #: Iterations run (graph replays on CUDA), the live ones and the no-op
    #: ones of a chunk's last block; and looks at the lanes (host syncs
    #: before a chunk's status fetch).
    replays: int = 0
    looks: int = 0
    mid_decode_admissions: int = 0
    occupancy_sum: float = 0.0
    # Speculative chunks: lane-steps are verify forwards a lane paid while
    # live and not done; lane-tokens the tokens those lanes emitted.
    spec_chunks: int = 0
    spec_lane_steps: int = 0
    spec_lane_tokens: int = 0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.chunks if self.chunks else 0.0

    @property
    def spec_tokens_per_forward(self) -> float:
        return (
            self.spec_lane_tokens / self.spec_lane_steps
            if self.spec_lane_steps
            else 0.0
        )


class DecodeEngine:
    """Persistent multi-slot decode engine over one decoder parameter set.

    ``generator`` is the model's :class:`~qwen3_asr_tpu_torch.runtime.
    generate.Generator` (parameters, config, runtime).  ``prompt_bucket``
    (a multiple of 256) and ``token_bucket`` (a multiple of 128) are each
    slot's prompt and decode rows; ``n_slots`` the most sequences decoding
    at once; ``chunk_steps`` the decode iterations per :meth:`step`.
    ``paged=True`` backs the engine with ``n_pages`` pages of ``page_size``
    (128 or 256) rows (default: every slot's worst case plus the trash
    page).  Under the generator's ``tp`` the cache and the pool hold this
    rank's KV heads.  ``eager=True`` runs every chunk eagerly, one
    iteration a look at the lanes, on the card too: the oracle of the
    captured chunks.
    """

    @torch.inference_mode()
    def __init__(
        self,
        generator,
        prompt_bucket: int,
        token_bucket: int,
        n_slots: int = 8,
        chunk_steps: int = 32,
        paged: bool = False,
        page_size: int = 256,
        n_pages: int | None = None,
        eager: bool = False,
    ) -> None:
        if prompt_bucket % 256:
            raise ValueError("prompt_bucket must be a multiple of 256")
        if token_bucket % 128:
            raise ValueError("token_bucket must be a multiple of 128")
        self.gen = generator
        self.tp = generator.tp
        #: The kernels' scratch of this engine's launches and captured
        #: chunks, its own: a server's thread steps it while the model may
        #: serve other calls.
        self.scratch = _build.Scratch()
        self.cfg: TextDecoderConfig = generator.cfg
        self.prompt_bucket = prompt_bucket
        self.token_bucket = token_bucket
        self.cache_len = prompt_bucket + token_bucket
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        self.eager = eager
        self.stats = EngineStats()
        self._eos_ids = generator._eos_ids
        #: The captured chunk iterations by bucket (CUDA only), and the
        #: bucket of the last chunk: (width, greedy, spec, rep_window,
        #: k_subset, cache dtype, paged, decode kernel mode, KV writer).
        self.graphs: _graphs.DecodeGraphs | None = None
        self.last_bucket: tuple | None = None

        ref = generator.params["final_norm"]
        self.device = ref.device
        dtype = ref.dtype
        # kv_cache_dtype="int8": int8 rows + per-row f32 scales; prompt K/V
        # is quantized once at admission, fresh rows on write.
        self.kv_dtype = generator.runtime.kv_cache_dtype
        L, H, D = (self.cfg.num_hidden_layers, local_heads(self.cfg, self.tp)[1],
                   self.cfg.head_dim)

        def alloc(shape):
            if self.kv_dtype == "int8":
                return {
                    "q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                    "s": torch.ones(shape[:-1], dtype=torch.float32, device=self.device),
                }
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.paged = paged
        if paged:
            if page_size not in (128, 256):
                # Admission groups arrive with prompt buckets that are
                # multiples of 256; pages must tile every such group.
                raise ValueError("page_size must be 128 or 256")
            self.page_size = page_size
            self.max_pages = -(-prompt_bucket // page_size) - (-token_bucket // page_size)
            if n_pages is None:
                n_pages = 1 + n_slots * self.max_pages
            self.n_pages = n_pages
            shape = (L, n_pages, H, page_size, D)
            self._page_table = np.zeros((n_slots, self.max_pages), np.int32)
            self._free_pages: list[int] = list(range(n_pages - 1, 0, -1))
            self._pp = np.zeros(n_slots, np.int32)        # prompt pages
            self._dp_alloc = np.zeros(n_slots, np.int32)  # decode pages
            self._paused = np.zeros(n_slots, bool)        # out of pages
        else:
            shape = (L, n_slots, H, self.cache_len, D)
        self._keys = alloc(shape)
        self._values = alloc(shape)

        n = n_slots
        # Host mirrors, refreshed from one status fetch per chunk.
        self._live = np.zeros(n, bool)
        self._done = np.ones(n, bool)
        self._counts = np.ones(n, np.int64)
        self._prompt_len = np.zeros(n, np.int32)
        self._max_new = np.ones(n, np.int64)
        self._cur = np.zeros(n, np.int64)
        self._temp = np.zeros(n, np.float32)
        self._top_k = np.zeros(n, np.int64)
        self._top_p = np.ones(n, np.float32)
        self._rep_pen = np.ones(n, np.float32)
        self._rep_ctx = np.zeros(n, np.int64)
        self._seed = np.zeros(n, np.int64)
        self._meta: list[Optional[SlotRequest]] = [None] * n

        # Device state: the truth a chunk reads and advances.  Every tensor
        # a chunk iteration reads or writes is allocated here, once, and
        # updated in place: a captured chunk keeps these pointers.
        dev = self.device
        self._tokens = torch.zeros((n, token_bucket), dtype=torch.long, device=dev)
        self._counts_d = torch.ones(n, dtype=torch.long, device=dev)
        self._done_d = torch.ones(n, dtype=torch.bool, device=dev)
        self._cur_d = torch.zeros(n, dtype=torch.long, device=dev)
        self._eos_d = torch.tensor(self._eos_ids, dtype=torch.long, device=dev)
        #: A chunk's counters: per-lane verify forwards, live iterations,
        #: and the lanes with nothing to do (what a look reads).
        self._fwd_d = torch.zeros(n, dtype=torch.long, device=dev)
        self._iters_d = torch.zeros((), dtype=torch.long, device=dev)
        self._halt_d = torch.ones(n, dtype=torch.bool, device=dev)
        #: Control buffers (:meth:`_refresh_ctl` fills them in place from
        #: their host mirrors, through pinned staging tensors on CUDA).
        ctl = {
            "mask": (torch.bool, (n,)), "prompt_len": (torch.int32, (n,)),
            "max_new": (torch.long, (n,)), "rep_pen": (torch.float32, (n,)),
            "rep_ctx": (torch.long, (n,)), "temp": (torch.float32, (n,)),
            "top_k": (torch.long, (n,)), "top_p": (torch.float32, (n,)),
            "seed": (torch.long, (n,)),
        }
        if paged:
            ctl["table"] = (torch.int32, (n, self.max_pages))
        pin = dev.type == "cuda"
        self._ctl_d = {k: torch.zeros(shape, dtype=dt, device=dev)
                       for k, (dt, shape) in ctl.items()}
        self._ctl_host = {k: torch.zeros(shape, dtype=dt, pin_memory=pin)
                          for k, (dt, shape) in ctl.items()}
        self._ctl_dirty = True
        # Paged step widths: powers of two up to n_slots.
        self._widths = sorted(
            {min(1 << i, n_slots) for i in range((n_slots - 1).bit_length() + 1)}
        ) or [n_slots]

    # -- chunk body ----------------------------------------------------------

    def _is_eos(self, tok: torch.Tensor) -> torch.Tensor:
        return (tok[:, None] == self._eos_d[None, :]).any(dim=-1)

    def _chunk_step(self, B: int, greedy: bool, rep_window: int, k_subset: int, spec):
        """One chunk iteration over the first ``B`` slots, as a function of
        no arguments that reads and writes only the engine's static tensors
        and never reads the device from the host (a CUDA graph holds it).
        A plain step, or a speculative verify iteration with ``spec`` =
        (gamma, ngram_n) (all-greedy chunks); sampled lanes of a mixed chunk
        draw from their counter streams at the index of the token drawn,
        one candidate pool of ``k_subset`` for the chunk.  An iteration with
        no live lane left undone changes no token, count or flag."""
        params, cfg, tp = self.gen.params, self.cfg, self.tp
        tb = self.token_bucket
        ctl = self._ctl_d
        live, plen = ctl["mask"][:B], ctl["prompt_len"][:B]
        max_new, rep_pen, rep_ctx = ctl["max_new"][:B], ctl["rep_pen"][:B], ctl["rep_ctx"][:B]
        temp, top_k, top_p, seed = (ctl[k][:B] for k in ("temp", "top_k", "top_p", "seed"))
        tokens = self._tokens[:B]
        counts_s, done_s, cur_s = self._counts_d[:B], self._done_d[:B], self._cur_d[:B]
        fwd, halt, iters = self._fwd_d[:B], self._halt_d[:B], self._iters_d
        paged = self.paged
        if paged:
            PS, maxp = self.page_size, self.max_pages
            table = ctl["table"][:B]

        def recent(tokens, counts):
            return recent_token_window(tokens, counts, rep_ctx, rep_window, tb)

        def store(counts, done, cur) -> None:
            counts_s.copy_(counts)
            done_s.copy_(done)
            cur_s.copy_(cur)
            halt.copy_(~(live & ~done))

        def step() -> None:
            lanes = torch.arange(B, device=tokens.device)
            plen_l = plen.long()
            active = live & ~done_s
            iters.add_(active.any().long())
            counts = counts_s
            drow = (counts - 1).clamp_min(0)            # decode row being written
            if paged:
                pp = (plen_l + PS - 1) // PS
            if spec is not None:
                gamma, ngram_n = spec
                T = gamma + 1
                offs = torch.arange(T, device=tokens.device)
                fwd.add_(active.long())
                draft, dvalid = speculative.ngram_draft(tokens, counts, n=ngram_n, gamma=gamma)
                ids = torch.cat([cur_s[:, None], draft], dim=1)             # (B, T)
                pos = (plen_l + counts - 1)[:, None] + offs[None, :]
                embeds = embed_tokens(params, ids, tp=tp)
                if paged:
                    wrow = drow[:, None] + offs[None, :]                    # (B, T)
                    raw = pp[:, None] + wrow // PS
                    pages = table[lanes[:, None], raw.clamp(0, maxp - 1)]
                    # Rows whose entry walks off the table go to the trash
                    # page explicitly: clipping would land them on the
                    # slot's last real page (JAX engine.py:664-681).
                    pages = torch.where(raw >= maxp, torch.zeros_like(pages), pages)
                    hidden, _ = decoder_paged_verify(
                        params, cfg, embeds, pos, (self._keys, self._values), table,
                        plen, drow, pages, wrow % PS, tp=tp,
                    )
                else:
                    ws = (self.prompt_bucket + drow).int()
                    hidden, _ = decoder_forward(
                        params, cfg, embeds, pos, (self._keys, self._values),
                        write_slots=ws, decode_ctx=(plen, ws, self.prompt_bucket), tp=tp,
                    )
                logits = decoder_logits(params, cfg, hidden, tp=tp)         # (B, T, V)
                store(*_spec_accept_chain(
                    logits, draft, dvalid, tokens, counts, done_s, cur_s, live, recent,
                    rep_pen, max_new, tb, self._is_eos, gamma,
                )[1:])
                return
            pos = plen_l + counts - 1
            embeds = embed_tokens(params, cur_s, tp=tp)[:, None, :]
            if paged:
                page = table[lanes, (pp + drow // PS).clamp(0, maxp - 1)]
                hidden, _ = decoder_paged_step(
                    params, cfg, embeds, pos[:, None], (self._keys, self._values),
                    table, plen, drow, page, drow % PS, tp=tp,
                )
            else:
                ws = (self.prompt_bucket + drow).int()
                hidden, _ = decoder_forward(
                    params, cfg, embeds, pos[:, None], (self._keys, self._values),
                    write_slots=ws, decode_ctx=(plen, ws, self.prompt_bucket), tp=tp,
                )
            logits = decoder_logits(params, cfg, hidden, tp=tp)[:, 0]
            if greedy:
                nxt = apply_repetition_penalty(
                    logits.float(), recent(tokens, counts), rep_pen
                ).argmax(dim=-1)
            else:
                nxt = sample_streams(logits, temp, top_k, top_p, rep_pen,
                                     recent(tokens, counts), k_subset, seed, counts)
            slot = counts.clamp(0, tb - 1)[:, None]
            keep = tokens.gather(1, slot)[:, 0]
            tokens.scatter_(1, slot, torch.where(active, nxt, keep)[:, None])
            counts = counts + active.long()
            # Only genuine completion sets done: a page-paused slot (masked
            # out of ``live`` for this chunk) must not be harvested.
            done = done_s | (active & (self._is_eos(nxt) | (counts >= max_new)))
            store(counts, done, torch.where(active & ~done, nxt, cur_s))

        return step

    def _run_chunk(self, k_steps: int, greedy: bool, B: int, rep_window: int,
                   k_subset: int, spec) -> tuple[int, int]:
        """Up to ``k_steps`` iterations over the first ``B`` slots in blocks,
        stopping at the first look that finds no live lane undone: replays
        of the bucket's captured iteration on the card (captured on first
        use: its warm-up run is the chunk's first iteration), the same
        iteration eagerly on CPU tensors, on a gloo tp group or with
        ``eager``.  Returns (iterations run, looks at the lanes)."""
        self._fwd_d.zero_()
        self._iters_d.zero_()
        self._halt_d.copy_(~(self._ctl_d["mask"] & ~self._done_d))
        halt = self._halt_d[:B]
        key = self.last_bucket = (
            B, greedy, spec, rep_window, k_subset,
            "int8" if self.kv_dtype == "int8" else self._keys.dtype, self.paged,
            _decoder.DECODE_KERNEL_MODE, _decoder.KV_WRITER_MODE,
        )
        if self.eager or not self.gen._capturable(self.device):
            step = self._chunk_step(B, greedy, rep_window, k_subset, spec)
            block = 1 if self.eager else _graphs.BLOCK
            return _graphs.run_blocks(lambda _i: step(), halt, block, cap=k_steps)
        if self.graphs is None:
            self.graphs = _graphs.DecodeGraphs(self.device)
        entry = self.graphs.get(key)
        graph = entry[1] if entry else None

        def replay(_i: int) -> None:
            nonlocal graph
            if graph is None:
                step = self._chunk_step(B, greedy, rep_window, k_subset, spec)
                graph = self.graphs.capture(key, step, step)
                logger.info("engine chunk graph captured in %.1f ms: B=%d greedy=%s spec=%s "
                            "rep_window=%d k_subset=%d", self.graphs.last_capture_ms,
                            *key[:5])
                return
            graph.replay()

        return _graphs.run_blocks(replay, halt, _graphs.BLOCK, ahead=True, cap=k_steps)

    def close(self) -> None:
        """Free the captured chunks and the kernels' scratch."""
        if self.graphs is not None:
            self.graphs.close()
            self.graphs = None
        self.scratch.clear()

    # -- host control --------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.n_slots) if not self._live[i]]

    def n_active(self) -> int:
        return int((self._live & ~self._done).sum())

    def n_live(self) -> int:
        """Slots holding a request (decoding or finished-but-unharvested)."""
        return int(self._live.sum())

    def _first_tokens(self, first_logits: torch.Tensor, reqs) -> torch.Tensor:
        """First token per admitted sequence, with no repetition penalty
        (JAX ``_first_impl`` :550): argmax, or for sampled requests the
        draw of index 0 of the request's counter stream, from one candidate
        pool for the group as JAX ``admit`` picks it (1024, or the bucket of
        the largest ``top_k`` when that exceeds 1024 and a request
        samples)."""
        first = first_logits.float().argmax(dim=-1)
        if all(r.temperature == 0.0 for r in reqs):
            return first
        top_k_max = max(r.top_k for r in reqs)
        k_subset = TOP_K_SUBSET
        if top_k_max > TOP_K_SUBSET:
            k_subset = self.gen.runtime.pick_top_k_subset(top_k_max, self.cfg.vocab_size)
        dev = first_logits.device

        def column(name, dtype):
            return torch.tensor([getattr(r, name) for r in reqs], dtype=dtype, device=dev)

        no_recent = torch.full((len(reqs), 1), RECENT_PAD_ID, dtype=torch.long, device=dev)
        seeds = torch.tensor([_seed64(r.seed) for r in reqs], dtype=torch.long, device=dev)
        return sample_streams(
            first_logits, column("temperature", torch.float32), column("top_k", torch.long),
            column("top_p", torch.float32), 1.0, no_recent, k_subset, seeds,
            torch.zeros_like(seeds),
        )

    def _put_flat(self, cache, group: torch.Tensor, slots: torch.Tensor) -> None:
        """Prompt rows of the group into the slots' first ``pb_g`` rows (this
        rank's KV heads under tp, as the prefill made them)."""
        pb_g = group.shape[3]
        for layer in range(group.shape[0]):
            if isinstance(cache, dict):
                qg = quantize_kv(group[layer])
                cache["q"][layer, slots, :, :pb_g] = qg["q"]
                cache["s"][layer, slots, :, :pb_g] = qg["s"]
            else:
                cache[layer, slots, :, :pb_g] = group[layer].to(cache.dtype)

    def _put_pages(self, pool, group: torch.Tensor, dst: torch.Tensor) -> None:
        """Scatter the group's prompt rows, page by page, into ``dst`` (B_g *
        pb_g / PS,): each sequence's prompt pages in order, the trash page 0
        for pages past its prompt (JAX ``_admit_paged_impl`` :781)."""
        L, Bg, H, pb_g, D = group.shape
        PS = self.page_size
        npg = pb_g // PS
        for layer in range(L):
            src = group[layer].reshape(Bg, H, npg, PS, D).transpose(1, 2)
            src = src.reshape(Bg * npg, H, PS, D)
            if isinstance(pool, dict):
                qg = quantize_kv(src)
                pool["q"][layer, dst] = qg["q"]
                pool["s"][layer, dst] = qg["s"]
            else:
                pool[layer, dst] = src.to(pool.dtype)

    @torch.inference_mode()
    @_build.owned
    def admit(
        self, kv_group, first_logits, slots: list[int], reqs: list[SlotRequest]
    ) -> list[SlotRequest]:
        """Place a prefilled group into ``slots`` (one entry per request).

        ``kv_group`` is the prefill's (keys, values) with cache length <=
        ``prompt_bucket``; ``first_logits`` the last prompt position's logits
        (B_g, vocab).  Returns the requests that could NOT be admitted (paged
        mode only: the page pool is exhausted); retry them after retirements
        free pages."""
        if len(reqs) > len(slots):
            raise ValueError(
                f"admission group of {len(reqs)} exceeds the {len(slots)} "
                "provided slots -- cap groups at free_slots() before "
                "prefilling (the server does this automatically)"
            )
        rejected: list[SlotRequest] = []
        pages_per_req: list[list[int]] = []
        if self.paged:
            admitted_idx = []
            for j, r in enumerate(reqs):
                pp = -(-len(r.prompt) // self.page_size)
                if pp <= len(self._free_pages):
                    pages_per_req.append([self._free_pages.pop() for _ in range(pp)])
                    admitted_idx.append(j)
                else:
                    rejected.append(r)
            if not admitted_idx:
                return rejected
            if len(admitted_idx) < len(reqs):
                sel = torch.tensor(admitted_idx, device=first_logits.device)
                kv_group = (kv_group[0][:, sel], kv_group[1][:, sel])
                first_logits = first_logits[sel]
                reqs = [reqs[j] for j in admitted_idx]
        if self.n_active() > 0:
            self.stats.mid_decode_admissions += len(reqs)
        bg = len(reqs)
        slots_np = np.asarray(slots[:bg], np.int64)
        first = self._first_tokens(first_logits, reqs)
        first_np = first.cpu().numpy()
        budgets = np.asarray([min(r.max_new, self.token_bucket) for r in reqs], np.int64)
        done_new = np.array(
            [bool(first_np[j] in self._eos_ids or budgets[j] <= 1) for j in range(bg)]
        )
        idx = torch.as_tensor(slots_np, device=self.device)
        if self.paged:
            npg = kv_group[0].shape[3] // self.page_size
            dst = np.zeros(bg * npg, np.int64)       # unused entries -> trash page
            for i, pages in enumerate(pages_per_req):
                dst[i * npg : i * npg + len(pages)] = pages
                s = slots_np[i]
                self._page_table[s, :] = 0
                self._page_table[s, : len(pages)] = pages
                self._pp[s] = len(pages)
                self._dp_alloc[s] = 0
                self._paused[s] = False
            dst_t = torch.as_tensor(dst, device=self.device)
            self._put_pages(self._keys, kv_group[0], dst_t)
            self._put_pages(self._values, kv_group[1], dst_t)
        else:
            self._put_flat(self._keys, kv_group[0], idx)
            self._put_flat(self._values, kv_group[1], idx)
        self._tokens[idx] = 0
        self._tokens[idx, 0] = first
        self._counts_d[idx] = 1
        self._done_d[idx] = torch.as_tensor(done_new, device=self.device)
        self._cur_d[idx] = first

        for j, (s, r) in enumerate(zip(slots_np, reqs)):
            self._live[s] = True
            self._counts[s] = 1
            self._prompt_len[s] = len(r.prompt)
            self._max_new[s] = int(budgets[j])
            self._cur[s] = first_np[j]
            self._temp[s] = r.temperature
            self._top_k[s] = r.top_k
            self._top_p[s] = r.top_p
            self._rep_pen[s] = r.repetition_penalty
            self._rep_ctx[s] = r.repetition_context_size
            self._seed[s] = _seed64(r.seed)
            self._meta[s] = r
            self._done[s] = bool(done_new[j])
        self._ctl_dirty = True
        self.stats.admitted += bg
        return rejected

    def _ensure_decode_pages(self, k: int, allow_force_finish: bool = True) -> np.ndarray:
        """Grow each live slot's decode pages to cover ``k`` more tokens this
        chunk.  A slot that cannot get enough pages is paused (it keeps its
        state and resumes when retirements free pages).  If nothing can run
        and nothing is retirable, the deepest sequence is force-finished
        (truncated, logged) so the pool always drains -- unless
        ``allow_force_finish`` is False (the provisional spec-sized pass,
        whose failure downgrades the chunk to plain).  Returns the runnable
        mask."""
        ps = self.page_size
        max_dp = -(-self.token_bucket // ps)
        want = np.nonzero(self._live & ~self._done)[0]
        for s in want:
            rows = int(min(self._counts[s] + k - 1, self._max_new[s] - 1))
            dp_need = min(-(-max(rows, 1) // ps), max_dp)
            while self._dp_alloc[s] < dp_need and self._free_pages:
                page = self._free_pages.pop()
                self._page_table[s, self._pp[s] + self._dp_alloc[s]] = page
                self._dp_alloc[s] += 1
                self._ctl_dirty = True
            paused = self._dp_alloc[s] < dp_need
            if paused != self._paused[s]:
                self._ctl_dirty = True
            self._paused[s] = paused
        runnable = self._live & ~self._done & ~self._paused
        if allow_force_finish and not runnable.any() and len(want) and not (
            self._live & self._done
        ).any():
            deepest = want[np.argmax(self._counts[want])]
            logger.warning(
                "page pool exhausted with no retirable work: force-finishing "
                "slot %d at %d tokens (transcript truncated); grow n_pages=%d",
                deepest, self._counts[deepest], self.n_pages,
            )
            self._done[deepest] = True
            self._ctl_dirty = True
        return self._live & ~self._done & ~self._paused

    def _refresh_ctl(self) -> None:
        """Fill the control buffers in place from their host mirrors
        (admission, retirement and page events only): the buffers keep the
        pointers a captured chunk holds.  Host ``done`` folds into the mask:
        it is a superset of the device's (force-finished slots are marked on
        the host only)."""
        mask = self._live & ~self._done
        if self.paged:
            mask &= ~self._paused
        mirrors = {
            "mask": mask, "prompt_len": self._prompt_len, "max_new": self._max_new,
            "rep_pen": self._rep_pen, "rep_ctx": self._rep_ctx, "temp": self._temp,
            "top_k": self._top_k, "top_p": self._top_p, "seed": self._seed,
        }
        if self.paged:
            mirrors["table"] = self._page_table
        for name, buf in self._ctl_d.items():
            host = self._ctl_host[name]
            host.numpy()[...] = mirrors[name]
            buf.copy_(host)         # waits for the copy: the host buffer is reused
        self._ctl_dirty = False

    def _plan_chunk_spec(self, greedy: bool):
        """(gamma, ngram_n) when this chunk runs speculative verify
        iterations, else None: all-greedy chunks only; flat engines need the
        bf16 cache (the verify split writes bf16 rows), paged engines take
        both pools but need T x group <= the K7 kernel's query rows; under
        "auto" the engine must be within its mode's width ceiling
        (``spec_engine_max_slots``, ``spec_engine_max_slots_paged``)."""
        if not greedy:
            return None
        rt = self.gen.runtime
        if self.paged:
            group = self.cfg.num_attention_heads // self.cfg.num_key_value_heads
            if (rt.spec_gamma + 1) * group > MAX_QUERY_ROWS:
                return None
            limit = rt.spec_engine_max_slots_paged
        elif self.kv_dtype == "int8":
            return None
        else:
            limit = rt.spec_engine_max_slots
        mode = rt.spec_engine
        if mode == "on" or (mode == "auto" and self.n_slots <= limit):
            return (rt.spec_gamma, rt.spec_ngram)
        return None

    @torch.inference_mode()
    @_build.owned
    def step(self, k_steps: int | None = None) -> None:
        """Run one decode chunk over every live slot: at most ``k_steps``
        (default ``chunk_steps``) iterations in blocks, graphed on the card
        (:meth:`_run_chunk`), then one status fetch.  Per chunk, on the
        host: page planning, the width, greedy or mixed, the rep window, the
        candidate pool (JAX ``engine.py:1112-1117``: the bucket of the
        largest ``top_k`` over the live lanes, for every lane) and whether
        to speculate."""
        k = k_steps or self.chunk_steps
        pre_spec = None
        if self.paged:
            # Speculative chunks may emit gamma + 1 tokens per iteration, so
            # pages are planned for that first, provisionally: if the bigger
            # demand pauses any slot, the chunk runs plain with plain-sized
            # planning instead of pausing or truncating work.
            pre_mask = self._live & ~self._done
            pre_greedy = bool((self._temp[pre_mask] == 0).all())
            pre_spec = self._plan_chunk_spec(pre_greedy)
            if pre_spec is not None:
                runnable = self._ensure_decode_pages(
                    k * (pre_spec[0] + 1), allow_force_finish=False
                )
                if self._paused.any():
                    pre_spec = None
            if pre_spec is None:
                runnable = self._ensure_decode_pages(k)
            if not runnable.any():
                return
        if self._ctl_dirty:
            self._refresh_ctl()
        if self.paged and self._live.any():
            # Live slots form a prefix after compaction: run the narrowest
            # width that covers them.
            hi = int(np.nonzero(self._live)[0][-1]) + 1
            width = next(w for w in self._widths if w >= hi)
        else:
            width = self.n_slots
        mask = self._live & ~self._done
        greedy = bool((self._temp[mask] == 0).all())
        rt = self.gen.runtime
        rep_window = rt.rep_window
        if mask.any() and (self._rep_pen[mask] != 1.0).any():
            rep_window = rt.pick_rep_window(int(self._rep_ctx[mask].max()), self.token_bucket)
        k_subset = TOP_K_SUBSET
        if not greedy and mask.any():
            top_k_max = int(self._top_k[mask].max())
            k_subset = rt.pick_top_k_subset(
                top_k_max if top_k_max > 0 else TOP_K_SUBSET, self.cfg.vocab_size
            )
        spec = self._plan_chunk_spec(greedy)
        if self.paged and spec is not None and pre_spec is None:
            # A force-finish flipped the chunk to all-greedy after pages were
            # planned for plain steps: run it plain.
            spec = None
        replays, looks = self._run_chunk(k, greedy, width, rep_window, k_subset, spec)
        counts_before = self._counts
        n = self.n_slots
        status = torch.cat([self._counts_d, self._done_d.long(), self._fwd_d,
                            self._iters_d.reshape(1)]).cpu().numpy()
        self._counts = status[:n].copy()
        self._done = status[n : 2 * n].astype(bool)
        self.stats.chunks += 1
        self.stats.iterations += int(status[-1])
        self.stats.replays += replays
        self.stats.looks += looks
        self.stats.steps += int((self._counts - counts_before).max(initial=0))
        if spec is not None:
            self.stats.spec_chunks += 1
            self.stats.spec_lane_steps += int(status[2 * n : 3 * n].sum())
            self.stats.spec_lane_tokens += int((self._counts - counts_before)[mask].sum())
        self.stats.occupancy_sum += self.n_active() + int((self._live & self._done).sum())

    @torch.inference_mode()
    def retire(self) -> list[tuple[SlotRequest, list[int]]]:
        """Harvest finished sequences, free their slots, return token lists."""
        finished = np.nonzero(self._live & self._done)[0]
        if len(finished) == 0:
            return []
        rows = self._tokens[torch.as_tensor(finished, device=self.device)].cpu().numpy()
        out = []
        for row, s in zip(rows, finished):
            out.append((self._meta[s], row[: self._counts[s]].tolist()))
            self._live[s] = False
            self._done[s] = True
            self._counts[s] = 1
            self._prompt_len[s] = 0
            self._cur[s] = 0
            self._meta[s] = None
            if self.paged:
                n_owned = int(self._pp[s] + self._dp_alloc[s])
                self._free_pages.extend(
                    int(p) for p in self._page_table[s, :n_owned] if p != 0
                )
                self._page_table[s, :] = 0
                self._pp[s] = 0
                self._dp_alloc[s] = 0
                self._paused[s] = False
        self._ctl_dirty = True
        if self.paged:
            self._compact()
        self.stats.retired += len(out)
        return out

    def _compact(self) -> None:
        """Move the highest live slot into each freed hole, so live slots
        form a prefix and the next chunk runs at the narrowest width (paged
        mode: a slot move is a page-table row and a few small device rows,
        never a KV copy)."""
        while True:
            live_idx = np.nonzero(self._live)[0]
            if len(live_idx) == 0:
                return
            hi = int(live_idx[-1])
            holes = np.nonzero(~self._live[:hi])[0]
            if len(holes) == 0:
                return
            dst, src = int(holes[0]), hi
            for a in (
                self._live, self._done, self._counts, self._prompt_len,
                self._max_new, self._cur, self._temp, self._top_k,
                self._top_p, self._rep_pen, self._rep_ctx, self._seed,
                self._pp, self._dp_alloc, self._paused,
            ):
                a[dst] = a[src]
            self._meta[dst] = self._meta[src]
            self._page_table[dst, :] = self._page_table[src, :]
            self._live[src] = False
            self._done[src] = True
            self._meta[src] = None
            self._page_table[src, :] = 0
            self._pp[src] = 0
            self._dp_alloc[src] = 0
            self._paused[src] = False
            for t in (self._tokens, self._counts_d, self._done_d, self._cur_d):
                t[dst] = t[src]
            self._ctl_dirty = True
