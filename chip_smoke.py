#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``qwen3_asr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and a
CUDA build of PyTorch; it imports nothing of JAX.  Phases, in order (any
failure raises and the script exits non-zero):

  1. card identity (``nvidia-smi`` name and power limit);
  2. build the CUDA kernels from ``qwen3_asr_tpu_torch/csrc`` (seconds),
     and the native audio library (``make -C
     qwen3_asr_tpu_torch/audio/csrc``, no fallback): ``load_audio`` of a
     PCM16 WAV written under ``build/`` must take the native route and
     equal the numpy decoder's samples bit for bit;
  3. each kernel against its plain PyTorch version at main-path shapes, on
     the card: max abs error vs the plain version computed in float32
     (K1 at B=8, T = 64, 448, 1024, 1088, 77 and B=64, T=448; K1, K2,
     K4: atol 2e-2 + rtol 2e-2 of the bf16 kernel; K9, at decode M = 1,
     8, 96, at an incremental session's advance M = 16 and 104 and at
     the int8-weights prefill's M = 448 and 3584: 1e-5 of the
     largest |value| + rtol 8e-3 (bf16 out) or 1e-5 (f32 out) against the
     f32 product of the same int8 weights, two calls bit-identical; K3, K3
     int8, K5 and K10: exact, K10's row quantize also against
     ``quantize_activations``, K5 (both caches in one launch, and its
     single-cache oracle) with overflow rows and a lane past S dropped, its
     one launch timed against the two single-cache launches in turns; K6
     and K7, the paged decode attention and
     verify over bf16 and int8 pools, at ``PAGED_GRID`` (B = 1, 8, 64 x
     dcount 64, 1024 at PS 256, and B=8 dcount 64 at PS 128, the smoke
     clips' prompt lengths, an idle lane): as K2; K8, the paged row write, bf16
     and int8: exact outside the trash page 0; K11a and K11b, decode
     attention with one decode end for every lane (a 0-d int32 tensor on
     the card), at K2's shapes and at B=6 with the decode end at the
     prompt bucket and an idle lane: as K2, K11a bit-identical to K11b,
     and one launch captured as a CUDA graph replayed with the end changed
     on the device between replays, each replay bit-identical to the eager
     call at that end (K3's shared slot likewise);
     K11e, the stem's conv + bias + GELU at conv2's and conv3's shapes for
     the smoke batch's 256 chunks: atol 2e-2 + rtol 2e-2 of the bf16
     output; K11c and K11d, decode attention with per-lane decode ends and
     an idle lane, at K2's shapes and B=6, and at B=96 with one lane at S:
     as K2, with K2's time beside theirs, K11c, at one end for every
     lane, bit-identical to K11b, and K11d bit-identical to K11c on the
     same inputs, with K11c's time beside; the fused stores, K3 and K3-int8 in
     K2/K4 and K8 in K6/K7 (a call with a write target), at every
     ``DECODE_GRID`` and ``PAGED_GRID`` shape and at the clamp case (every
     decode end S, write slot S - 1): the output bit-identical to the call
     without the store,
     the whole cache or pool (int8 rows and scales) bit-identical to that
     call followed by the standalone writer, the layer to the plain writer;
     the call's device time with and without the store in turns), kernel,
     plain and
     library-call times from CUDA events (K3, K3 int8, K5, K8 and K9, which
     launch-bound wrappers pace from the host: the kernel and
     ``index_put_`` by device time, a CUDA graph of 20 calls replayed
     between two events, the host-paced readings printed beside; the decode
     attention kernels K2, K4, K6, K7 and K11a-K11d by device time on a cold
     cache, rotated over enough layers of one cache that the calls between
     two on one layer read more than the 50 MB L2, the host-paced readings
     printed beside; K9 and
     K10 with bf16 ``torch.matmul`` on the dequantized weights and
     ``torch._int_mm`` beside), the bound (bytes over 3.35 TB/s
     or operations over the peak of their type, whichever is larger), and
     the share of the published peak; then the ``kernelab`` section of
     ``tools/torch_micro_bench.py`` (K2, K11d and K11c over 28 layers at
     B=64, S=640, three decode depths), the path that launches K11c and
     K11d: each arm 28 launches a pass and held to K2;
  4. small-width reference checks: the decoder's prefill logits, one
     decode step and (bf16) one verify-split forward (T=4, per-lane write
     slots) with the kernels on the GPU against the same weights on the
     CPU with the plain versions -- bf16 against float32 under decode modes
     "auto" (K2), "3" (K11a) and "4" (K11b) in turn, and the int8
     decoder (int8 weights, W8A8 prefill, int8 cache) against the same
     quantized weights in float32; then one paged step and one paged
     verify forward (K6, K7, each with K8 fused) over shuffled pages, bf16
     against float32;
  5. the full-width 1.7B paths from random weights (seed 0), each with the
     launch counters set to 0 just before it and read just after.  The
     offline decode loops run as CUDA graphs (``runtime/graphs.py``): each
     path's ``warm_up`` captures its buckets first, and the counted runs
     replay them; the checks that hook a decode step in Python (the choice
     rows of the near-tie and forced-stream holds) run the eager loop,
     whose tokens must equal the graphed loop's.  Greedy
     ``transcribe_batch`` of 8 synthetic clips of 4-30 s
     (``max_tokens=64``) twice and one ``transcribe`` under
     ``speculative="off"`` (K1, K2 with K3 fused, no standalone writer;
     the bf16 lm head must keep its f32 accumulator); the same plain loop
     over the int8 cache (K4 with K3-int8 fused), the int8 runs'
     reference; decode mode "0" on both caches (the plain attention:
     K2/K4 never launched, the standalone K3 or K3-int8 twice a replay,
     the mode's own graph captured once and replayed, ms per iteration
     beside the default loop's, streams and tokens held as the modes'
     below); decode modes "3" and "4" on the int8 cache (K4 with K3-int8
     fused kept, graphed, a layer a replay each, no K11a/K11b, no
     standalone writer; the stream held to the int8 reference's); on the
     same model ``transcribe_batch`` under decode modes "3" (K11a) and "4"
     (K11b; both graphed: the kernels read the decode end, and the
     standalone K3 the slot, from the device), K2 never launched, the
     mode's kernel 28 x (replays + the capture's warm-up step) and the
     standalone K3 twice that, the eager loop's ids equal to the graphed
     loop's, and under the "pallas" stem (K11e twice per encoder call), each
     stream held to the plain one by the near-tie rule below,
     every token of the three streams held to the default modes' logits
     on the same prefix (the default loop forced along the stream),
     the encoder features of the "pallas" stem held to the "conv" stem's
     (5e-2 of max |feature|) and those of "taps", "merged", "c512" and
     "merged512" (the "conv" stem here) equal to them;
     then the same runs on the same weights under the
     default ``"auto"`` (the speculative loop: K5 once per verify
     iteration run, the no-op replays after the last lane finished
     included; no K2/K3), each lane's
     stream equal to the plain one or first differing at a near-tie of the
     plain run's penalized logits, and every token of the B=8 stream held
     to the plain step's logits on the same prefix (the plain loop forced
     along the speculative stream), for the n-gram run and for a
     teacher-forced run whose drafts are mostly accepted; sampled ``transcribe_batch`` twice with
     one seed (identical), sampled speculative (``spec_sampling``),
     int8-weights speculative (K5 and K9), long-form 20 s clips in 8 s
     chunks (one clip, and two pooled into one group); the
     ``ContinuousTranscriptionServer(n_slots=8, chunk_steps=16)`` on the
     smoke clips in two waves (the second admitted mid-decode): paged under
     ``spec_engine="off"`` (K6) and the default ``"auto"`` (K7), each with
     K8 fused, the int8 pool under both (q8 K6/K7, int8 K8 fused), never a
     contiguous-cache kernel or a standalone writer, and the flat engine
     (K2 with per-lane K3 fused), every stream held to
     the plain ``transcribe_batch`` stream by the near-tie rule, with ms per
     chunk iteration, engine counters and each request's TTFT, the engine's
     chunks replayed from captured CUDA graphs (captured in the first chunk
     of each bucket, no warm-up); before the servers, the engine's graphed
     chunks against ``eager=True`` chunks from the same admissions
     (:func:`engine_graphs_phase`: ``DecodeEngine`` driven directly, the
     smoke clips in two waves, 32-token budgets, ``chunk_steps=16``; paged
     bf16 plain in an oversubscribed pool whose lanes pause and resume,
     paged bf16 speculative, paged int8 plain, flat bf16 plain and
     speculative, and a sampled chunk mixing greedy lanes with two seeds
     of unequal ``top_k``: tokens bit-identical, the engine counters
     equal, each chunk's launches its live iterations (eager) or its
     replays (graphed) x the bucket's captured launches; ms per chunk
     iteration both ways, captures, replays, looks, peak memory); the "xla"
     KV writer (:func:`xla_writer_phase`: the plain writers, which wait
     for nothing on the device, no fused store, no standalone writer, no
     K5): the plain loop (K2 without its store; its every token held to
     the default row on the same prefix) and the speculative loop, each
     captured once for the writer's bucket and replayed, then the paged
     server under ``spec_engine`` off (K6) and auto (K7), streams held to
     the plain stream by the near-tie rule, then the end-to-end line (ms
     per decode iteration of the graphed plain loop under the default
     modes, "0" and "xla", in turns); the graphed
     loops against the eager loop (:func:`graphs_phase`: plain B=1, 8 and
     96 (W8A8), the int8 cache at B=8, sampled B=8, speculative B=1 and 8,
     sampled speculative B=1, int8-weights speculative B=1, decode modes
     "3" and "4" at B=8; from one
     prefill, two decodes of each loop in turns (32-token budgets): tokens
     bit-identical, launches = the eager count plus the no-op replays', no
     re-capture for
     new sampling values; ms per live iteration, capture ms, device busy
     share, replays and host syncs per decode, peak memory); the
     live-stream path (:func:`live_phase`, on a model sharing the plain
     run's weights): an ``IncrementalSession`` fed a 24 s clip whose first
     window is near-silent in 1 s pieces, previewed at five prefixes, each
     preview's tokens held to ``transcribe`` of the prefix by the near-tie
     rule, K2 with K3 fused 28 x replays a preview and no K1, K5 or
     standalone writer, one capture of the decode bucket and one of the
     window advance's on the first preview (the advance replays a graph
     per (B, S, T) bucket), the committed windows counted, the quiet window
     re-advanced once the clamp floor rose, one preview again with every
     advance and the decode eager (text and first-token logits
     bit-identical), a ``transcribe`` of another clip between two previews
     changing nothing (preview, transcribe, advance and decode ms
     printed), the advance's graphed and eager ms at T = 16 and 104; a
     ``StreamingTranscriber`` over 60 s of gapped tones
     (segments and one ``partial()`` held to ``transcribe``) and two
     sessions streaming that audio through ``feed_nowait`` on the paged
     continuous server (held to the model path); one preview on int8
     weights over the bf16 cache (K9 in the advance and the decode); then a
     second 1.7B model with ``RuntimeConfig(quantization="int8",
     act_quant="int8", kv_cache_dtype="int8")`` (K4 with K3-int8 fused),
     on which a ``StreamingTranscriber`` opens no incremental session and
     previews by re-transcription; then, with that model closed, the
     training path (:func:`training_phase`): one Adam step of the tiny
     float32 config (``tests/test_training_checkpoint.py``'s) on the card
     against the same step on the CPU (TF32 off; the loss within 1e-5
     relative, every gradient leaf within 1e-4 x max |g| + 1e-7), whether
     the bf16 lm head's ``torch.mm(..., out_dtype=float32)`` has a
     derivative, and ``ModelConfig()`` from random weights (seed 0) in
     float32 and in bf16, Adam at lr 1e-4 on two 30 s clips at P=512: a
     warm step, three timed steps (CUDA events), one step under the sync
     debug mode (no host sync), every loss finite and falling, every
     parameter leaf's gradient finite and nonzero, ms a step against its
     bound, peak memory, the global gradient norm, and no hand-written
     kernel launched in the whole phase; then the train step on (dp, tp)
     meshes of spawned ranks (:func:`mesh_training_phase`: the tiny config
     on (1, 2), (2, 1), and (2, 2) with four cards, held to one device's
     loss and gradients; ``ModelConfig()`` on (1, 2) in float32, its
     gradient's per-leaf norms and seeded projections held to one
     device's, and three bf16 steps; a full-width dp mesh at reduced depth
     (full depth on (2, 2) with four cards) held to one device's loss, the
     replicated leaves bit-identical across ranks; a sharded snapshot
     restored onto the mesh and onto one device; no kernel launched;
     ``dryrun_multichip(2)``).  Before the int8 model, on the
     plain run's model: :func:`replicated_phase` (a
     ``ReplicatedTranscriptionServer`` of ``max(2, cards)`` replicas, two
     on ``cuda:0`` on one card, 16 requests in two rounds, each result held
     to the solo model's ``transcribe`` by the near-tie rule, every replica
     serving, wall and RTFx against the solo model) and :func:`mesh_phase`
     (spawned ranks holding ``ModelConfig()`` shards: (dp, tp) = (1, 2)
     held to the plain streams by the near-tie rule and its prefill logits
     within 5e-2 of max |logit|, (2, 1) bit-identical to one device on each
     slice, and with four cards (2, 2); gloo on a shared card, NCCL with a
     card a rank; a rank that fails or outlives its time fails the smoke;
     in the same ranks :func:`mesh_serving_phase`: on (1, 2) the
     ``ContinuousTranscriptionServer(n_slots=8, chunk_steps=16)`` in two
     waves, paged under ``spec_engine`` off (K6) and auto (K7), each with
     K8 fused, and flat (K2 with K3 fused), every rank constructing it and
     rank 0 submitting, streams held to one device's plain streams by the
     near-tie rule and every token to one device's plain step on the same
     prefix (:func:`hold_forced`), launches and engine counters equal
     across ranks, ms per chunk iteration, TTFTs and peak memory printed;
     the drain ``TranscriptionServer`` on (1, 2), held so to one device's
     ``transcribe_batch`` of the same batch, and on (2, 1), bit-identical
     to one device's ``transcribe_batch`` of each dp slice).
     With two cards or more, phase 3's checks also run on ``cuda:1``
     (:func:`second_card_phase`).
     Token ids must be <
     vocab, logits never NaN, repeated runs identical, every kernel of a
     path launched;
  6. ``{"kernels": [...]}`` JSON, one entry for every kernel a path
     launches, the fused stores included (the standalone K8, which no path
     launches any more, is held in phase 3 and left out; the standalone
     K3-int8's launches come from decode mode "0" on the int8 cache),
     then the last line
     ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available or when
the package is not beside this script.  ``python3 chip_smoke.py --training``
runs :func:`training_phase` and :func:`mesh_training_phase` alone and prints
no result line.
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# Published H100 SXM peaks (dense bf16 and int8 tensor cores, HBM3) at a
# 700 W limit.
PEAK_BF16_TFLOPS = 989.0
PEAK_INT8_TOPS = 1979.0
PEAK_HBM_GBPS = 3350.0
INT8_RUNTIME = dict(quantization="int8", act_quant="int8", kv_cache_dtype="int8")

# (name, route, source, TPU kernel it replaces)
KERNELS = {
    "flash_attention_causal": (
        "cuda", "qwen3_asr_tpu_torch/csrc/flash_attention.cu",
        "qwen3_asr_tpu/ops/pallas/flash_attention.py:95",
    ),
    "decode_attention": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:405",
    ),
    "kv_write_rows": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:260",
    ),
    "decode_attention_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_hbm4.py:434",
    ),
    "kv_write_rows_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:260",
    ),
    "quantized_matmul": (
        "cuda", "qwen3_asr_tpu_torch/csrc/quantized_matmul.cu",
        "qwen3_asr_tpu/ops/quant.py:129",
    ),
    "w8a8_matmul": (
        "cuda", "qwen3_asr_tpu_torch/csrc/w8a8_matmul.cu",
        "qwen3_asr_tpu/ops/pallas/w8a8_matmul.py:65",
    ),
    # K10 with the row scales given: a row-parallel shard's product under
    # tp (the scaled quantize kernel, then K10's product).
    "w8a8_matmul_scaled": (
        "cuda", "qwen3_asr_tpu_torch/csrc/w8a8_matmul.cu",
        "qwen3_asr_tpu/ops/pallas/w8a8_matmul.py:65",
    ),
    "kv_write_span_batch": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:156",
    ),
    "decode_attention_paged": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:472",
    ),
    "decode_attention_paged_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:499",
    ),
    "decode_attention_paged_verify": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:526",
    ),
    "decode_attention_paged_verify_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_paged.cu",
        "qwen3_asr_tpu/ops/pallas/decode_attention_paged.py:560",
    ),
    "kv_write_rows_paged": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:219",
    ),
    "kv_write_rows_paged_q8": (
        "cuda", "qwen3_asr_tpu_torch/csrc/kv_write.cu",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:219",
    ),
    "decode_attention_hbm2": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_hbm2.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm2.py:134",
    ),
    "decode_attention_hbm3": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_hbm3.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:181",
    ),
    "conv_s2_gelu": (
        "cuda", "qwen3_asr_tpu_torch/csrc/conv_stem.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/conv_stem.py:82",
    ),
    "decode_attention_hbm5": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_hbm5.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm5.py:268",
    ),
    "decode_attention_sched": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_attention_sched.cu",
        "qwen3_asr_tpu/ops/pallas/experiments/decode_attention_sched.py:280",
    ),
    # K3 and K8 fused into the decode attention's fold block: a launch of
    # K2, K4, K6 or K7 with a write target (the same launch counted twice,
    # under the attention's name and the store's).
    "kv_write_rows_fused": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_split.cuh",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:260",
    ),
    "kv_write_rows_q8_fused": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_split.cuh",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:260",
    ),
    "kv_write_rows_paged_fused": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_split.cuh",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:219",
    ),
    "kv_write_rows_paged_q8_fused": (
        "cuda", "qwen3_asr_tpu_torch/csrc/decode_split.cuh",
        "qwen3_asr_tpu/ops/pallas/kv_write.py:219",
    ),
}
#: The kernels the micro-bench's ``kernelab`` section A/Bs, 28 launches a
#: pass each (the JAX package runs K11c and K11d from no other path).
KERNELAB = ("decode_attention", "decode_attention_sched", "decode_attention_hbm5")
#: The standalone row writers that no default path launches: the decode
#: attention stores the fresh rows itself (the ``*_fused`` names).  Decode
#: modes "0", "3" and "4" launch ``kv_write_rows``, and "0" on the int8
#: cache ``kv_write_rows_q8``; the paged two launch on no path
#: (:data:`ORACLES`).
STANDALONE_WRITERS = ("kv_write_rows", "kv_write_rows_q8", "kv_write_rows_paged",
                      "kv_write_rows_paged_q8")
#: Kernels that no path launches: held to their plain versions in phase 3
#: and used there as their fused stores' oracles, left out of the kernels
#: line, whose TPU sites the fused entries carry.
ORACLES = ("kv_write_rows_paged", "kv_write_rows_paged_q8")
#: The kernels each path must launch, and those it must not.
BF16_PATH = ("flash_attention_causal", "decode_attention", "kv_write_rows_fused")
INT8_PATH = ("flash_attention_causal", "decode_attention_q8", "kv_write_rows_q8_fused",
             "quantized_matmul", "w8a8_matmul")
SPEC_PATH = ("flash_attention_causal", "kv_write_span_batch")
SPEC_NEVER = ("decode_attention", "kv_write_rows_fused") + STANDALONE_WRITERS
SPEC_W8_PATH = ("flash_attention_causal", "kv_write_span_batch", "quantized_matmul")
#: The continuous server's paths: the paged engine never launches a
#: contiguous-cache kernel; the flat engine runs K2 with its fused store.
CONTIGUOUS = ("decode_attention", "decode_attention_q8", "kv_write_rows_fused",
              "kv_write_rows_q8_fused", "kv_write_span_batch")
PAGED = ("decode_attention_paged", "decode_attention_paged_q8", "decode_attention_paged_verify",
         "decode_attention_paged_verify_q8", "kv_write_rows_paged_fused",
         "kv_write_rows_paged_q8_fused")
SERVER_PATHS = {
    # (runtime, paged): (kernels the run must launch, kernels it must not)
    "paged, spec_engine off": ({"spec_engine": "off"}, True,
                               ("flash_attention_causal", "decode_attention_paged",
                                "kv_write_rows_paged_fused"), CONTIGUOUS + STANDALONE_WRITERS),
    "paged, spec_engine auto": ({}, True,
                                ("flash_attention_causal", "decode_attention_paged_verify",
                                 "kv_write_rows_paged_fused"), CONTIGUOUS + STANDALONE_WRITERS),
    "paged int8 pool, spec_engine off": ({"kv_cache_dtype": "int8", "spec_engine": "off"}, True,
                                         ("flash_attention_causal", "decode_attention_paged_q8",
                                          "kv_write_rows_paged_q8_fused"),
                                         CONTIGUOUS + STANDALONE_WRITERS),
    "paged int8 pool, spec_engine auto": ({"kv_cache_dtype": "int8"}, True,
                                          ("flash_attention_causal",
                                           "decode_attention_paged_verify_q8",
                                           "kv_write_rows_paged_q8_fused"),
                                          CONTIGUOUS + STANDALONE_WRITERS),
    "flat, spec_engine off": ({"spec_engine": "off"}, False,
                              ("flash_attention_causal", "decode_attention",
                               "kv_write_rows_fused"),
                              PAGED + ("kv_write_span_batch",) + STANDALONE_WRITERS),
}
#: bf16 speculative vs plain rows of one prefix at 1.7B: the largest allowed
#: max |difference| over max |logit|, 1.5x what the plain loop's own rows of
#: one lane differ by between B=1 and B=8 (2.7e-2 on an H100 80GB HBM3 from
#: seed 0), and the top-two gap over max |logit| under which the two may
#: choose apart: above the largest gap of such a flip measured there
#: (1.3e-2), below the median gap of the plain run's choices (2.1e-2).
LOGIT_TOL = 4e-2
NEAR_TIE = 1.5e-2


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call with the host out of the reading:
    ``iters`` calls captured in one CUDA graph, replayed ``replays`` times
    between two CUDA events.  For launch-bound kernels, whose host-paced
    ``cuda_ms`` shows the wrapper's Python cost per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def write_times(label: str, kernel, plain, library=None) -> dict:
    """A launch-bound write kernel's ms and library_ms by device time
    (``graph_ms``), the host-paced ``cuda_ms`` readings printed beside; the
    plain version's ms host-paced (some plain versions sync on the host,
    which a graph cannot capture)."""
    host = {"ms": cuda_ms(kernel), "library_ms": None if library is None else cuda_ms(library)}
    dev = {"ms": graph_ms(kernel), "library_ms": None if library is None else graph_ms(library)}
    plain_ms = cuda_ms(plain)

    def fmt(t):
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        return f"kernel {t['ms']:.4f}, index_put_ {lib} ms"

    print(f"{label}: device time (CUDA graph of 20 calls, 5 replays) {fmt(dev)}; "
          f"host-paced (20 calls between events) {fmt(host)}, plain {plain_ms:.4f} ms")
    return {**dev, "plain_ms": plain_ms}


def bound(nbytes: float, ops: float, peak_ops_per_s: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the peak rate of their type."""
    t_bytes = nbytes / (PEAK_HBM_GBPS * 1e9) * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sum_bounds(parts: list[dict]) -> dict:
    """The bound of calls run one after another (their bounds summed; the
    label of the larger share)."""
    by_bytes = sum(b["bound_ms"] for b in parts if b["bound_by"] == "bytes")
    total = sum(b["bound_ms"] for b in parts)
    return {"bound_ms": total,
            "bound_by": "bytes" if by_bytes >= total - by_bytes else "operations"}


def _close(name: str, out, ref, atol: float, rtol: float) -> float:
    import torch

    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond atol={atol} rtol={rtol} "
            f"(max abs err {err.max().item():.3e})"
        )
    return err.max().item()


def check_flash(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from qwen3_asr_tpu_torch.ops.kernels import flash_attention as fa

    hq, hkv, D = 16, 8, 128
    worst, times = 0.0, []
    for B, T in ((8, 64), (8, 448), (8, 1024), (8, 1088), (8, 77), (64, 448)):
        q = torch.randn(B, hq, T, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16()
        out = fa.flash_attention_causal(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_causal_plain(q.float(), k.float(), v.float())
        err = _close(f"K1 B={B} T={T}", out, ref, 2e-2, 2e-2)
        ms = cuda_ms(lambda: fa.flash_attention_causal(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_causal_plain(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        # Causal QK^T and PV: 2 products x 2 FLOP per MAC over T(T+1)/2 pairs;
        # q, k, v read and the output written once.
        flops = 4 * B * hq * D * T * (T + 1) / 2
        b = bound(2 * B * T * D * (2 * hq + 2 * hkv), flops, PEAK_BF16_TFLOPS * 1e12)
        tflops = flops / (ms * 1e-3) / 1e12
        print(f"K1 flash_attention_causal B={B} T={T}: max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) = {b['bound_ms'] / ms:.1%} "
              f"of the kernel's time (sdpa {b['bound_ms'] / library_ms:.1%}); "
              f"{tflops:.1f} TFLOP/s = {tflops / PEAK_BF16_TFLOPS:.1%} of the bf16 peak")
        worst = max(worst, err)
        times.append(((B, T), {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": library_ms}))
        del q, k, v, out, ref
    # The record's time is the main path's largest smoke shape (B=8, T=448:
    # the 30 s bucket's 64-aligned prefill run).
    return {"max_abs_err": worst, **next(t for bt, t in times if bt == (8, 448))}


#: Bytes of other layers that the calls between two calls on one layer must
#: read for the second to find the H100's 50 MB L2 cold, and the most layers
#: a timing rotates over.
COLD_BYTES = 64 * 2**20
MAX_COLD_LAYERS = 64


def cold_layers(call_bytes: int) -> int:
    """Layers to rotate a decode attention kernel over so that between two
    calls on one layer the others read more than ``COLD_BYTES`` (at least 2,
    at most ``MAX_COLD_LAYERS``)."""
    return min(MAX_COLD_LAYERS, max(2, -(-COLD_BYTES // max(call_bytes, 1)) + 1))


def attention_ms(call, n_layers: int) -> tuple[float, float]:
    """(device ms, host-paced ms) per call of ``call(layer)`` rotated over
    ``n_layers`` layers of one cache, so that each call reads a cold cache:
    by ``graph_ms`` (at least 20 calls, a multiple of ``n_layers``, in one
    CUDA graph) and by ``cuda_ms`` over the same rotation."""
    layers = itertools.cycle(range(n_layers))
    iters = n_layers * -(-20 // n_layers)
    fn = lambda: call(next(layers))   # noqa: E731
    return graph_ms(fn, iters=iters), cuda_ms(fn, iters=iters)


def cold_note(n_layers: int, call_bytes: int) -> str:
    return (f"{n_layers} layers rotated, {(n_layers - 1) * call_bytes / 1e6:.1f} MB of other "
            f"layers between two calls on one layer")


#: K2/K4's check grid: (B, S) at prompt_bucket 512, Hq 16, Hkv 8.
DECODE_GRID = tuple((B, S) for B in (1, 8, 96) for S in (640, 2560))


def decode_case(gen, B: int, S: int, q8: bool, hq: int = 16, hkv: int = 8,
                pb: int = 512) -> dict:
    """K2/K4 inputs at (B, S): random prompt lengths in [1, pb] and decode
    ends in [pb, S], one idle lane (prompt_len 0, decode_end == pb) where
    B > 1, and a cache of ``cold_layers`` layers for the valid rows' bytes
    (int8 rows plus one f32 scale each when ``q8``)."""
    import torch

    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    D = 128
    q = torch.randn(B, hq, D, generator=gen, device="cuda").bfloat16()
    k_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    v_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=gen, device="cuda").int()
    dend = torch.randint(pb, S + 1, (B,), generator=gen, device="cuda").int()
    if B > 1:                      # one idle lane
        plen[-1] = 0
        dend[-1] = pb
    rows = int((plen + dend - pb).sum())
    call_bytes = rows * hkv * ((D + 4) if q8 else D * 2) * 2
    L = cold_layers(call_bytes)
    caches = []
    for _ in range(2):
        x = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda")
        caches.append(quantize_kv(x) if q8 else x.bfloat16())
        del x
    return dict(q=q, kall=caches[0], vall=caches[1], k_new=k_new, v_new=v_new, plen=plen,
                dend=dend, pb=pb, L=L, rows=rows, call_bytes=call_bytes)


def decode_layer(c: dict, layer: int) -> tuple:
    """Layer ``layer`` of the case's caches alone, as a one-layer cache."""
    if isinstance(c["kall"], dict):
        return tuple({k: v[layer:layer + 1] for k, v in c[n].items()} for n in ("kall", "vall"))
    return c["kall"][layer:layer + 1], c["vall"][layer:layer + 1]


def decode_reference(c: dict, layer: int):
    """K2's (K4's) plain version on one layer, in float32."""
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da

    D = c["q"].shape[-1]
    kl, vl = decode_layer(c, layer)
    f32 = [t.float() for t in (c["q"], c["k_new"], c["v_new"])]
    if isinstance(kl, dict):
        return da.decode_attention_q8_plain(f32[0], kl, vl, *f32[1:], 0, c["plen"], c["dend"],
                                            c["pb"], D ** -0.5)
    return da.decode_attention_plain(f32[0], kl.float(), vl.float(), *f32[1:], 0, c["plen"],
                                     c["dend"], c["pb"], D ** -0.5)


def attention_bound(B: int, hq: int, hkv: int, rows: int, row_bytes: int,
                    T: int = 1, store: bool = False) -> tuple[dict, int]:
    """(bound, the cache bytes a call reads) of decode attention over
    ``rows`` valid rows of ``row_bytes`` (an int8 row's include its f32
    scale): their K and V read once, plus q, the T fresh rows and the
    output; QK and PV over the valid rows and the fresh block.  ``store``:
    the call also writes the T fresh K and V rows of each lane into the
    cache (the fused store)."""
    D = 128
    call_bytes = rows * hkv * row_bytes * 2
    stored = B * T * hkv * row_bytes * 2 if store else 0
    return bound(call_bytes + B * T * (2 * hq + 2 * hkv) * D * 2 + stored,
                 4 * hq * T * D * (rows + B * T), PEAK_BF16_TFLOPS * 1e12), call_bytes


def decode_bound(c: dict, store: bool = False) -> dict:
    """K2's (K4's) bound at the case's valid rows (``store``: with the
    fresh rows' store)."""
    B, hq, D = c["q"].shape
    q8 = isinstance(c["kall"], dict)
    return attention_bound(B, hq, c["k_new"].shape[1], c["rows"], D + 4 if q8 else 2 * D,
                           store=store)[0]


def clone_cache(c):
    """A copy of a bf16 cache or pool, or of an int8 ``{"q", "s"}`` one."""
    return {k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone()


def layer_of(c, layer: int):
    """Layer ``layer`` of a cache or pool as a one-layer view (writes reach
    the whole)."""
    return {k: v[layer:layer + 1] for k, v in c.items()} if isinstance(c, dict) \
        else c[layer:layer + 1]


def same_cache(a, b) -> bool:
    """Bit-identical bf16 caches, or int8 caches' rows and scales."""
    import torch

    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in ("q", "s"))
    return torch.equal(a, b)


def decode_write_slots(c: dict):
    """The fused store's slots at a ``DECODE_GRID`` case: each lane's decode
    end (the flat engine writes the lane's next row there), S - 1 where that
    is S; the int8 cache's scale runs read as 16-byte supersets cover the
    slot, so the store lands beside rows the attention reads."""
    S = (c["kall"]["q"] if isinstance(c["kall"], dict) else c["kall"]).shape[3]
    return c["dend"].clamp(max=S - 1).contiguous()


def hold_fused_decode(label: str, c: dict, layer: int, slots) -> None:
    """K2 (K4) with ``write_slots`` on the case's cache against the call
    without them on a copy followed by the standalone K3 (K3-int8) on the
    layer: the output and the whole cache (int8 rows and scales) bit for
    bit; the layer also against the plain writer.  Raises otherwise."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    q8 = isinstance(c["kall"], dict)
    fn = da.decode_attention_q8 if q8 else da.decode_attention
    write = kw.kv_write_rows_q8 if q8 else kw.kv_write_rows_batch
    write_plain = kw.kv_write_rows_q8_plain if q8 else kw.kv_write_rows_plain
    tail = (layer, c["plen"], c["dend"], c["pb"])
    ref_k, ref_v = clone_cache(c["kall"]), clone_cache(c["vall"])
    plain_k = clone_cache(layer_of(c["kall"], layer))
    ref = fn(c["q"], ref_k, ref_v, c["k_new"], c["v_new"], *tail)
    write(layer_of(ref_k, layer), c["k_new"][None], slots)
    write(layer_of(ref_v, layer), c["v_new"][None], slots)
    write_plain(plain_k, c["k_new"][None], slots)
    out = fn(c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"], *tail, write_slots=slots)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"{label}: output differs from the call without the store")
    if not (same_cache(c["kall"], ref_k) and same_cache(c["vall"], ref_v)):
        raise AssertionError(f"{label}: cache differs from the attention, then the standalone "
                             "writer")
    if not same_cache(layer_of(c["kall"], layer), plain_k):
        raise AssertionError(f"{label}: cache differs from the plain writer's")
    del ref_k, ref_v, plain_k


def fused_turns(call, n_layers: int) -> dict:
    """Device and host-paced ms of ``call(layer, fused)`` on a cold cache
    (``attention_ms``) in turns without, with, with, without the store:
    the means of each arm's two readings."""
    arms = {False: [], True: []}
    for fused in (False, True, True, False):
        arms[fused].append(attention_ms(lambda layer: call(layer, fused), n_layers))
    mean = lambda xs: sum(xs) / len(xs)   # noqa: E731
    return {"ms": mean([d for d, _ in arms[False]]), "host_ms": mean([h for _, h in arms[False]]),
            "fused_ms": mean([d for d, _ in arms[True]]),
            "fused_host_ms": mean([h for _, h in arms[True]])}


def check_decode(gen, q8: bool = False) -> tuple[dict, dict]:
    """K2 (K4 when ``q8``) at ``DECODE_GRID`` against its plain version in
    float32 (atol 2e-2 + rtol 2e-2; the idle lane's output is checked finite
    and not compared, as the caller discards it); the call with its fused
    store (``write_slots``, :func:`decode_write_slots`) held to the call
    without it followed by the standalone K3 (:func:`hold_fused_decode`) at
    every shape and at the clamp case (every decode end S, slot S - 1);
    timed on a cold cache without and with the store in turns.  Returns the
    records of K2 (K4) and of its fused store."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    fn = da.decode_attention_q8 if q8 else da.decode_attention
    label = "K4 decode_attention_q8" if q8 else "K2 decode_attention"
    store = "K3-int8 fused into K4" if q8 else "K3 fused into K2"
    plain = da.decode_attention_q8_plain if q8 else da.decode_attention_plain
    write_plain = kw.kv_write_rows_q8_plain if q8 else kw.kv_write_rows_plain
    worst, times = 0.0, []
    for B, S in DECODE_GRID:
        c = decode_case(gen, B, S, q8)
        args = lambda layer: (c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"],  # noqa: E731
                              layer, c["plen"], c["dend"], c["pb"])
        layer = c["L"] - 1
        out = fn(*args(layer))
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{label} B={B} S={S}: non-finite output")
        ref = decode_reference(c, layer)
        live = slice(0, B - 1) if B > 1 else slice(0, 1)
        err = _close(f"{label} B={B} S={S}", out[live], ref[live], 2e-2, 2e-2)
        del out, ref
        slots = decode_write_slots(c)
        hold_fused_decode(f"{store} B={B} S={S}", c, layer, slots)
        t = fused_turns(lambda layer, fused: fn(*args(layer),
                                                write_slots=slots if fused else None), c["L"])
        ms = t["ms"]
        kl, vl = decode_layer(c, 0)
        plain_ms = cuda_ms(lambda: plain(c["q"], kl, vl, c["k_new"], c["v_new"], 0, c["plen"],
                                          c["dend"], c["pb"], 128 ** -0.5))
        fused_plain_ms = cuda_ms(lambda: (
            plain(c["q"], kl, vl, c["k_new"], c["v_new"], 0, c["plen"], c["dend"], c["pb"],
                  128 ** -0.5),
            write_plain(kl, c["k_new"][None], slots), write_plain(vl, c["v_new"][None], slots)))
        b, bf = decode_bound(c), decode_bound(c, store=True)
        gbps = c["call_bytes"] / (ms * 1e-3) / 1e9
        print(f"{label} B={B} pb={c['pb']} S={S}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
              f"device time ({cold_note(c['L'], c['call_bytes'])}; host-paced "
              f"{t['host_ms']:.4f} ms), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); {c['rows']} valid rows, {gbps:.0f} GB/s = "
              f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
        print(f"{store} B={B} S={S}: output and cache bit-identical to the attention, then "
              f"the standalone writer; with the store {t['fused_ms']:.4f} ms device time "
              f"against {ms:.4f} without ({t['fused_ms'] - ms:+.4f} ms; host-paced "
              f"{t['fused_host_ms']:.4f} / {t['host_ms']:.4f} ms), plain attention + writer "
              f"{fused_plain_ms:.4f} ms, bound {bf['bound_ms']:.4f} ms (the store's "
              f"{(bf['bound_ms'] - b['bound_ms']) * 1e3:.4f} us)")
        worst = max(worst, err)
        times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b},
                      {"ms": t["fused_ms"], "plain_ms": fused_plain_ms, **bf}))
        del c
        torch.cuda.empty_cache()
    # The clamp case: the plain loop's last step writes slot S - 1 while
    # every lane's decode end is S, so the store replaces a row that the
    # same launch reads.
    c = decode_case(gen, 8, 640, q8)
    c["dend"].fill_(640)
    hold_fused_decode(f"{store} clamp case B=8 S=640 (slot S - 1, decode end S)", c,
                      c["L"] - 1, torch.full_like(c["dend"], 639))
    print(f"{store} clamp case B=8 S=640: output and cache bit-identical to the attention, "
          "then the standalone writer")
    del c
    torch.cuda.empty_cache()
    # No one PyTorch call computes it: two valid intervals plus the
    # self-term of a row that is not in the cache (K4: over int8 rows and
    # their scales).
    rec, fused = next((t, f) for B, S, t, f in times if B == 8 and S == 640)
    return ({"max_abs_err": worst, **rec, "library_ms": None},
            {"max_abs_err": worst, **fused, "library_ms": None})


def check_kv_write(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    L, B, hkv, S, D = 28, 8, 8, 640, 128
    cache = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
    rows = torch.randn(L, B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    slots = torch.randint(512, S, (B,), generator=gen, device="cuda").int()
    shared_slot = device_int(600)
    for label, run, plain_slots in (
        ("shared slot", lambda c: kw.kv_write_rows(c, rows, shared_slot),
         torch.full_like(slots, 600)),
        ("per-lane slots", lambda c: kw.kv_write_rows_batch(c, rows, slots), slots),
    ):
        out = run(cache.clone())
        ref = kw.kv_write_rows_plain(cache.clone(), rows, plain_slots)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K3 {label}: differs from the plain version")
        print(f"K3 kv_write_rows {label}: bit-exact")
    work = cache.clone()
    hold_replays("K3 kv_write_rows shared slot",
                 lambda: kw.kv_write_rows(work, rows, shared_slot), lambda: work.copy_(cache),
                 shared_slot, (600, 513, S - 1),
                 lambda v: kw.kv_write_rows_plain(cache.clone(), rows, torch.full_like(slots, v)))
    shared_slot.fill_(600)
    shared = torch.full_like(slots, 600)
    # One index_put_ of the same rows at the same (lane, slot) pairs.
    lane = torch.arange(B, device="cuda")
    slot = torch.full((B,), 600, device="cuda")
    vals = rows[:, :, :, 0].transpose(0, 1).contiguous()          # (B, L, H, D)

    def index_put():
        work[:, lane, :, slot] = vals

    t = write_times(f"K3 kv_write_rows L={L} B={B} S={S}",
                    lambda: kw.kv_write_rows(work, rows, shared_slot),
                    lambda: kw.kv_write_rows_plain(work, rows, shared), index_put)
    b = bound(2 * L * B * hkv * D * 2, 0, 1.0)
    print(f"K3 bound {b['bound_ms']:.4f} ms (bytes)")
    return {"max_abs_err": 0.0, **t, **b}


def stream_case(gen, B: int, S: int, pb: int = 512, hq: int = 16, hkv: int = 8) -> dict:
    """Decode attention inputs at (B, S) for the kernels of decode modes
    "3"/"4" and the per-lane stream kernels: random prompt lengths in [1, pb]
    and a bf16 cache of ``cold_layers`` layers for about half the decode rows
    (the rows of a lane's exact valid count follow from the kernel's own
    lengths)."""
    import torch

    D = 128
    q = torch.randn(B, hq, D, generator=gen, device="cuda").bfloat16()
    k_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    v_new = torch.randn(B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    plen = torch.randint(1, pb + 1, (B,), generator=gen, device="cuda").int()
    L = cold_layers((int(plen.sum()) + B * (S - pb) // 2) * hkv * D * 2 * 2)
    kall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
    vall = torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
    return dict(q=q, kall=kall, vall=vall, k_new=k_new, v_new=v_new, plen=plen, pb=pb, L=L)


#: K11a's and K11b's shapes beyond ``DECODE_GRID``: ``check_decode_lanes``'
#: B=6, with the decode end at the prompt bucket, so that the lane with no
#: prompt row is idle (its output the self-term alone).
STREAM_EXTRA = ((6, 640), (6, 2560))
#: K11c's and K11d's check shapes (B, S, skew): per-lane ends drawn from
#: [pb, S] and an idle lane; skewed: lane 0's end at S, the others' at pb,
#: so that one lane holds most tiles.
LANES_GRID = tuple((B, S, False) for B in (1, 6, 8, 96) for S in (640, 2560)) + (
    (96, 2560, True),)


def lanes_case(gen, B: int, S: int, skew: bool) -> tuple[dict, object, object]:
    """(``stream_case`` inputs, prompt lengths, per-lane ends) of a
    ``LANES_GRID`` shape: where B > 1 the last lane is idle (prompt_len 0,
    which K11c and K11d clamp to 1, and its end at pb)."""
    import torch

    c = stream_case(gen, B, S)
    pb, plen = c["pb"], c["plen"]
    dend = torch.randint(pb, S + 1, (B,), generator=gen, device="cuda").int()
    if skew:
        dend[:] = pb
        dend[0] = S
    if B > 1:
        plen[-1] = 0
        dend[-1] = pb
    return c, plen, dend


def device_int(value: int):
    """A 0-d int32 tensor on the card: the one decode end or shared slot
    that K11a, K11b and K3 read on the device."""
    import torch

    return torch.tensor(value, dtype=torch.int32, device="cuda")


def hold_replays(label: str, call, reset, end, values, want) -> None:
    """``call()`` (one launch that reads the 0-d ``end`` on the device,
    returning its output) captured once as a CUDA graph, then replayed
    after ``reset()`` with ``end`` filled with each of ``values`` in turn:
    each replay's output bit-identical to ``want(value)``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reset()
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for v in values:
        reset()
        end.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, want(v)):
            raise AssertionError(f"{label}: the replay at {v} differs from the eager call")
    print(f"{label}: one captured launch replayed at {', '.join(map(str, values))} (the value "
          f"changed on the device between replays), each bit-identical to the eager call")
    del graph


def check_decode_stream(gen, kind: str) -> dict:
    """K11a (``"hbm2"``) or K11b (``"hbm3"``) at K2's check shapes and
    ``STREAM_EXTRA`` with one decode end for every lane, a 0-d int32 tensor
    on the card (as the plain loop passes it), against K2's plain version
    in float32 (atol 2e-2 + rtol 2e-2, as K2), K11a also bit for bit
    against K11b (one stream under two kernel names); at B=8 S=640 one
    launch captured as a CUDA graph and replayed with the end changed on
    the device between replays, each replay bit-identical to the eager
    call at that end; the kernel and K2 on the same inputs timed on a cold
    cache."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm2 as h2
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm3 as h3

    fn = h2.decode_attention_hbm2 if kind == "hbm2" else h3.decode_attention_hbm3
    label = "K11a decode_attention_hbm2" if kind == "hbm2" else "K11b decode_attention_hbm3"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, times = 0.0, []
    for B, S in DECODE_GRID + STREAM_EXTRA:
        c = stream_case(gen, B, S)
        pb, plen, D = c["pb"], c["plen"], 128
        if B > 1:
            plen[-1] = 0               # a lane with no prompt rows
        dend = pb if (B, S) in STREAM_EXTRA else pb + (S - pb) // 2
        end = device_int(dend)
        block_k = h2.tile_block_k(S, pb, 512)
        fresh = (c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"])
        layer = c["L"] - 1
        out = fn(*fresh, layer, plen, end, pb)
        torch.cuda.synchronize()
        one = (c["kall"][layer:layer + 1], c["vall"][layer:layer + 1])
        ref = h2.scalar_end_plain(c["q"].float(), one[0].float(), one[1].float(),
                                  c["k_new"].float(), c["v_new"].float(), 0, plen, end, pb,
                                  D ** -0.5)
        err = _close(f"{label} B={B} S={S}", out, ref, 2e-2, 2e-2)
        if kind == "hbm2" and not torch.equal(out, h3.decode_attention_hbm3(
                *fresh, layer, plen, end, pb)):
            raise AssertionError(f"{label} B={B} S={S}: not bit-identical to K11b")
        del out, ref
        if (B, S) == (8, 640):
            probe = device_int(dend)
            hold_replays(f"{label} B={B} S={S}", lambda: fn(*fresh, layer, plen, probe, pb),
                         lambda: None, probe, (pb, pb + 1, dend, S),
                         lambda v: fn(*fresh, layer, plen, device_int(v), pb))
        ms, host_ms = attention_ms(lambda layer: fn(*fresh, layer, plen, end, pb), c["L"])
        plain_ms = cuda_ms(lambda: h2.scalar_end_plain(
            c["q"], *one, c["k_new"], c["v_new"], 0, plen, end, pb, D ** -0.5))
        ends = torch.full_like(plen, dend)
        k2_ms, k2_host = attention_ms(
            lambda layer: da.decode_attention(*fresh, layer, plen, ends, pb), c["L"])
        b, call_bytes = attention_bound(B, 16, 8, int(plen.sum()) + B * (dend - pb), 2 * D)
        gbps = call_bytes / (ms * 1e-3) / 1e9
        blocks, per = h2.stream_grid(B * 8, sms)
        same = ", bit-identical to K11b" if kind == "hbm2" else ""
        print(f"{label} B={B} pb={pb} S={S} dend={dend} block_k={block_k} ({blocks} blocks of "
              f"{per} pairs{same}): max_abs_err={err:.3e} kernel {ms:.4f} ms device time "
              f"({cold_note(c['L'], call_bytes)}; host-paced {host_ms:.4f} ms), K2 {k2_ms:.4f} "
              f"ms (host-paced {k2_host:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {gbps:.0f} GB/s = "
              f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak (K2 "
              f"{call_bytes / (k2_ms * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%})")
        worst = max(worst, err)
        times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b}))
        del c, fresh, one
        torch.cuda.empty_cache()
    # No one PyTorch call computes it (as K2).
    rec = next(t for B, S, t in times if B == 8 and S == 640)
    return {"max_abs_err": worst, **rec, "library_ms": None}


def check_decode_lanes(gen, kind: str) -> dict:
    """K11c (``"hbm5"``) or K11d (``"sched"``) at ``LANES_GRID``: K2's check
    shapes plus B=6, with per-lane decode ends and an idle lane (prompt_len
    0, clamped to 1 as the TPU kernels do) where B > 1, and B=96 with one
    lane at S, against the module's plain version in float32 (atol 2e-2 +
    rtol 2e-2, as K2).  Also bit for bit: K11c, with every end set to one
    value and the prompt lengths clamped to >= 1, against K11b; K11d against
    K11c on the same inputs (one stream, the same tiles).  Times on a cold
    cache: the kernel (K11d with its schedule built beforehand, as the
    micro-bench builds it once per pass), K2 on the same inputs and clamped
    prompt lengths (and K11c beside K11d) by device time, the plain version
    host-paced; the bound's share of the kernel's time."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm3 as h3
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm5 as h5
    from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_sched as sc

    label = {"hbm5": "K11c decode_attention_hbm5", "sched": "K11d decode_attention_sched"}[kind]
    D = 128
    scale = D ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, times = 0.0, []
    for B, S, skew in LANES_GRID:
        c, plen, dend = lanes_case(gen, B, S, skew)
        pb = c["pb"]
        clamped = plen.clamp(1, pb)
        fresh = (c["q"], c["kall"], c["vall"], c["k_new"], c["v_new"])
        layer = c["L"] - 1
        blocks = min(B * 8, sms)
        ranges = "tile-balanced ranges" if B * 8 > blocks else "one pair each"
        if kind == "hbm5":
            def kernel(layer):
                return h5.decode_attention_hbm5(*fresh, layer, plen, dend, pb)

            def plain(*t):
                return da.decode_attention_plain(*t, 0, clamped, dend, pb, scale)
            mid = pb + (S - pb) // 2
            same_end = (h5.decode_attention_hbm5(*fresh, layer, clamped,
                                                 torch.full_like(plen, mid), pb),
                        h3.decode_attention_hbm3(*fresh, layer, clamped, device_int(mid), pb))
            extra = (f"block_p={h5.prompt_block(pb, S)}, {blocks} blocks, "
                     f"{B * 8 / blocks:.2f} pairs a block ({ranges}); "
                     f"equal ends = K11b bit for bit")
            if not torch.equal(*same_end):
                raise AssertionError(f"{label} B={B} S={S}: equal ends not bit-identical to "
                                     f"K11b")
            del same_end
        else:
            cores, per_core = sc.schedule_geometry(B, c["k_new"].shape[1], sms)
            sched = sc.build_decode_schedule(plen, dend, pb, S, cores, per_core, B)

            def kernel(layer):
                return sc.decode_attention_sched(*fresh, layer, plen, dend, pb,
                                                 schedule=sched)

            def plain(*t):
                return sc.decode_attention_sched_plain(*t, 0, sched, scale)

            def k11c(layer):
                return h5.decode_attention_hbm5(*fresh, layer, plen, dend, pb)
            build_ms = cuda_ms(lambda: sc.build_decode_schedule(
                plen, dend, pb, S, cores, per_core, B))
            k11c_ms = attention_ms(k11c, c["L"])[0]
            extra = (f"cores={cores} per_core={per_core}, {blocks} blocks ({ranges}), "
                     f"schedule build {build_ms:.4f} ms; K11c bit for bit, {k11c_ms:.4f} ms")
        out = kernel(layer)
        torch.cuda.synchronize()
        if kind == "sched" and not torch.equal(out, k11c(layer)):
            raise AssertionError(f"{label} B={B} S={S}: not bit-identical to K11c")
        one = (c["kall"][layer:layer + 1], c["vall"][layer:layer + 1])
        ref = plain(c["q"].float(), one[0].float(), one[1].float(), c["k_new"].float(),
                    c["v_new"].float())
        err = _close(f"{label} B={B} S={S}", out, ref, 2e-2, 2e-2)
        del out, ref
        ms, host_ms = attention_ms(kernel, c["L"])
        plain_ms = cuda_ms(lambda: plain(c["q"], *one, c["k_new"], c["v_new"]))
        k2_ms, k2_host = attention_ms(
            lambda layer: da.decode_attention(*fresh, layer, clamped, dend, pb), c["L"])
        b, call_bytes = attention_bound(B, 16, 8, int(clamped.sum() + (dend - pb).sum()),
                                        2 * D)
        gbps = call_bytes / (ms * 1e-3) / 1e9
        print(f"{label} B={B} pb={pb} S={S} {'one lane at S' if skew else 'per-lane ends'} "
              f"({extra}): max_abs_err={err:.3e} kernel {ms:.4f} ms device time "
              f"({cold_note(c['L'], call_bytes)}; host-paced {host_ms:.4f} ms), K2 "
              f"{k2_ms:.4f} ms (host-paced {k2_host:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) = {b['bound_ms'] / ms:.1%} of the "
              f"kernel's time; {gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak "
              f"(K2 {call_bytes / (k2_ms * 1e-3) / 1e9 / PEAK_HBM_GBPS:.1%})")
        worst = max(worst, err)
        times.append((B, S, {"ms": ms, "plain_ms": plain_ms, **b}))
        del c, fresh, one
        torch.cuda.empty_cache()
    # No one PyTorch call computes it (as K2).
    rec = next(t for B, S, t in times if B == 8 and S == 640)
    return {"max_abs_err": worst, **rec, "library_ms": None}


def kernelab_step() -> dict:
    """The micro-bench's ``kernelab`` section (K2 against K11d and K11c over
    28 layers, B=64, S=640), imported from ``tools/torch_micro_bench.py``:
    the path that launches K11c and K11d, as the JAX package's micro-bench
    launches K11d.  Every arm must launch 28 times a pass and agree with K2.
    Returns the launch counts of that run."""
    from qwen3_asr_tpu_torch.ops.kernels import _build

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_micro_bench import bench_kernel_ab

    _build.LAUNCHES.clear()
    res = bench_kernel_ab(B=64, S=640, pb=512, L=28, iters=3, warmup=1)
    launches = dict(_build.LAUNCHES)
    for name in KERNELAB:
        if launches.get(name, 0) != 28 * res["passes"]:
            raise AssertionError(f"kernelab: {name} launched {launches.get(name, 0)} times, "
                                 f"not 28 x {res['passes']} passes")
    check_launches("kernelab (tools/torch_micro_bench.py)", launches, KERNELAB)
    return launches


#: The stem convs K11e takes at the smoke batch (8 clips in the 3200-frame
#: bucket = 256 chunks): conv2 (64 x 50 -> 32 x 25) and conv3 (-> 16 x 13).
STEM_CONVS = (("conv2", 256, 64, 50, 480), ("conv3", 256, 32, 25, 480))


def check_conv_stem(gen) -> dict:
    """K11e at conv2's and conv3's shapes against its plain version (f32
    tap sum + bias, rounded to bf16, then the exact GELU): atol 2e-2 + rtol
    2e-2 (one bf16 ulp of the rounded conv output where the two f32 sums
    round apart).  Library call: ``F.conv2d`` with bias on the same
    channels-last data (cuDNN), the GELU being one more call."""
    import torch
    import torch.nn.functional as F

    from qwen3_asr_tpu_torch.ops.kernels.experiments import conv_stem as cs

    worst, parts = 0.0, []
    for name, N, H, W, C in STEM_CONVS:
        x = torch.randn(N, H, W, C, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(3, 3, C, C, generator=gen, device="cuda")).bfloat16()
        b = 0.1 * torch.randn(C, generator=gen, device="cuda")
        out = cs.conv_s2_gelu(x, w, b)
        torch.cuda.synchronize()
        ref = cs.conv_s2_gelu_plain(x, w, b)
        err = _close(f"K11e {name}", out, ref, 2e-2, 2e-2)
        ms = cuda_ms(lambda: cs.conv_s2_gelu(x, w, b), iters=10)
        plain_ms = cuda_ms(lambda: cs.conv_s2_gelu_plain(x, w, b), iters=5)
        x_cl = x.permute(0, 3, 1, 2)               # NCHW view, channels-last strides
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = b.bfloat16()
        lib = F.conv2d(x_cl, w_cl, b16, stride=2, padding=1)
        lib_err = (lib.permute(0, 2, 3, 1).float()
                   - cs.conv2d_s2_taps_f32(x, w) - b).abs().max().item()
        library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, b16, stride=2, padding=1), iters=10)
        Ho, Wo = out.shape[1], out.shape[2]
        flops = 2 * N * Ho * Wo * C * 9 * C
        bnd = bound(x.numel() * 2 + w.numel() * 2 + C * 4 + out.numel() * 2, flops,
                    PEAK_BF16_TFLOPS * 1e12)
        tflops = flops / (ms * 1e-3) / 1e12
        layout = "channels-last" if lib.is_contiguous(memory_format=torch.channels_last) else "NCHW"
        print(f"K11e conv_s2_gelu {name} N={N} {H}x{W}x{C} -> {Ho}x{Wo}x{C}: "
              f"max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d+bias "
              f"{library_ms:.4f} ms (layout {layout}, "
              f"max |conv2d - f32 taps| {lib_err:.3e}), bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}) = {bnd['bound_ms'] / ms:.1%} of the kernel's time "
              f"(cuDNN {bnd['bound_ms'] / library_ms:.1%}); {tflops:.1f} TFLOP/s")
        worst = max(worst, err)
        parts.append((ms, plain_ms, bnd, library_ms))
        del x, out, ref, lib
    # The record: one encoder call's conv2 + conv3.
    return {"max_abs_err": worst, "ms": sum(p[0] for p in parts),
            "plain_ms": sum(p[1] for p in parts), **_sum_bounds([p[2] for p in parts]),
            "library_ms": sum(p[3] for p in parts)}


def check_kv_write_q8(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    L, B, hkv, S, D = 28, 8, 8, 640, 128
    cache = quantize_kv(torch.randn(L, B, hkv, S, D, generator=gen, device="cuda"))
    rows = torch.randn(L, B, hkv, 1, D, generator=gen, device="cuda").bfloat16()
    rows[0, 0, 0] = 0                       # an all-zero row: scale 1
    shared = torch.full((B,), 600, dtype=torch.int32, device="cuda")
    per_lane = torch.randint(512, S, (B,), generator=gen, device="cuda").int()
    for label, slots in (("shared slot", shared), ("per-lane slots", per_lane)):
        out = kw.kv_write_rows_q8({k: v.clone() for k, v in cache.items()}, rows, slots)
        ref = kw.kv_write_rows_q8_plain({k: v.clone() for k, v in cache.items()}, rows, slots)
        torch.cuda.synchronize()
        if not (torch.equal(out["q"], ref["q"]) and torch.equal(out["s"], ref["s"])):
            raise AssertionError(f"K3 int8 {label}: differs from the plain version")
        print(f"K3 kv_write_rows_q8 {label}: bit-exact")
    work = {k: v.clone() for k, v in cache.items()}
    # No one PyTorch call quantizes a row and stores it with its scale.
    t = write_times(f"K3 kv_write_rows_q8 L={L} B={B} S={S}",
                    lambda: kw.kv_write_rows_q8(work, rows, shared),
                    lambda: kw.kv_write_rows_q8_plain(work, rows, shared))
    # bf16 rows in; int8 rows and f32 scales out.
    b = bound(L * B * hkv * (D * 2 + D + 4), 0, 1.0)
    print(f"K3 int8 bound {b['bound_ms']:.4f} ms (bytes)")
    return {"max_abs_err": 0.0, **t, **b}


#: Decoder (K, N) of every decode-time matmul (1.7B widths): fused QKV, o,
#: fused gate|up, down, and the tied lm head (f32 out).
DECODE_MATMULS = (
    ("wqkv", 2048, 4096), ("wo", 2048, 2048), ("wgu", 2048, 12288),
    ("wd", 6144, 2048), ("lm_head", 2048, 151936),
)
#: (M, K, N) of the W8A8 matmuls at the smoke batch (8 clips, 30 s bucket):
#: decoder prefill M = 8 x 448 rows, encoder M = 8 x 416 tokens.
PREFILL_MATMULS = (
    ("dec wqkv", 3584, 2048, 4096), ("dec wo", 3584, 2048, 2048),
    ("dec wgu", 3584, 2048, 12288), ("dec wd", 3584, 6144, 2048),
    ("enc wq", 3328, 1024, 1024), ("enc fc1", 3328, 1024, 4096),
    ("enc fc2", 3328, 4096, 1024), ("enc conv_out", 3328, 7680, 1024),
    ("enc proj2", 3328, 1024, 2048),
)

#: (name, M, K, N) of K10's row-parallel products at tp = 2, one rank's
#: K-slice of each row (the row scales are the whole row's): the decoder's
#: wo and wd at the smoke batch's prefill (8 x 448 rows), the encoder's wo,
#: fc2 and proj2 (8 x 416 tokens).
ROW_PARALLEL_MATMULS = (
    ("dec wo", 3584, 1024, 2048), ("dec wd", 3584, 3072, 2048),
    ("enc wo", 3328, 512, 1024), ("enc fc2", 3328, 2048, 1024),
    ("enc proj2", 3328, 512, 2048),
)


#: (M, K, N) of K9 at the int8-weights prefill (quantization="int8" without
#: act_quant): one clip's 448-row prompt and the smoke batch's 8 x 448 rows,
#: the decoder layer's four products.
K9_PREFILL_MATMULS = tuple(
    (f"prefill {name}", M, K, N)
    for M in (448, 3584)
    for name, K, N in DECODE_MATMULS if name != "lm_head"
)
#: (M, K, N) of K9 in an incremental session's cached advance under int8
#: weights: the 16-row prefix and suffix spans and a window's 104 rows.
K9_ADVANCE_MATMULS = tuple(
    (f"advance {name}", M, K, N)
    for M in (16, 104)
    for name, K, N in DECODE_MATMULS if name != "lm_head"
)


def k_major_int8(gen, K: int, N: int):
    """A random (K, N) int8 weight stored K-major, as quantize_weight
    stores it (the transpose of a contiguous (N, K) tensor)."""
    import torch

    return torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8).t()


def check_quantized_matmul(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import quantized_matmul as qm

    worst, times = 0.0, []
    shapes = [(f"{name}", B, K, N) for B in (1, 8, 96) for name, K, N in DECODE_MATMULS]
    for name, B, K, N in shapes + list(K9_ADVANCE_MATMULS) + list(K9_PREFILL_MATMULS):
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        x = torch.randn(B, K, generator=gen, device="cuda").bfloat16()
        wq = k_major_int8(gen, K, N)
        s = torch.rand(N, generator=gen, device="cuda") * 1e-3
        out = qm.quantized_matmul(x, wq, s, out_dtype)
        again = qm.quantized_matmul(x, wq, s, out_dtype)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K9 {name} M={B}: two identical calls differ")
        ref = x.float() @ (wq.float() * s)
        rtol = 1e-5 if out_dtype == torch.float32 else 8e-3
        err = _close(f"K9 {name} M={B}", out, ref, 1e-5 * ref.abs().max().item(), rtol)
        del ref, again
        # Device time (a CUDA graph of 20 calls): at decode the host-paced
        # reading is the wrapper's Python time, printed beside.
        ms = graph_ms(lambda: qm.quantized_matmul(x, wq, s, out_dtype))
        host_ms = cuda_ms(lambda: qm.quantized_matmul(x, wq, s, out_dtype))
        plain_ms = cuda_ms(lambda: qm.quantized_matmul_plain(x, wq, s, out_dtype))
        # _weight_int8pack_mm takes seconds over a run at the prefill shapes
        # (tools/torch_kernel_ab.py times it there).
        library_ms = (weight_int8pack_ms(x, wq, s)
                      if out_dtype == torch.bfloat16 and B <= 96 else None)
        w16 = (wq.float() * s).bfloat16()
        bf16_ms = cuda_ms(lambda: torch.matmul(x, w16))
        del w16
        nbytes = K * N + B * K * 2 + B * N * out.element_size() + N * 4
        b = bound(nbytes, 2 * B * K * N, PEAK_BF16_TFLOPS * 1e12)
        gbps = nbytes / (ms * 1e-3) / 1e9
        tflops = 2 * B * K * N / (ms * 1e-3) / 1e12
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        nb, splits, per = qm.split_k_plan(B, N, K, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
        print(f"K9 quantized_matmul {name} M={B} K={K} N={N} (row tile {nb}, {splits} k "
              f"ranges): max_abs_err={err:.3e}, two calls bit-identical; kernel {ms:.4f} ms "
              f"by device time ({host_ms:.4f} ms host-paced), "
              f"plain {plain_ms:.4f} ms, _weight_int8pack_mm {lib}, bf16 torch.matmul "
              f"(dequantized weights) {bf16_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) = {b['bound_ms'] / ms:.1%} of the kernel's time; "
              f"{gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak, "
              f"{tflops:.1f} TFLOP/s = {tflops / PEAK_BF16_TFLOPS:.1%} of the bf16 peak")
        worst = max(worst, err)
        times.append((B, name, ms, plain_ms, b, library_ms))
        del wq, out
    torch.cuda.empty_cache()
    # The record: B=8 decode, summed over one layer's four matmuls.
    layer = [t for t in times if t[0] == 8 and t[1] in ("wqkv", "wo", "wgu", "wd")]
    libs = [t[5] for t in layer]
    return {"max_abs_err": worst, "ms": sum(t[2] for t in layer),
            "plain_ms": sum(t[3] for t in layer), **_sum_bounds([t[4] for t in layer]),
            "library_ms": None if None in libs else sum(libs)}


def check_w8a8_matmul(gen) -> dict:
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import w8a8_matmul as w8

    times = []
    for name, M, K, N in PREFILL_MATMULS:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        x[1] = 0                                   # a zero row: sx = 1
        wq = k_major_int8(gen, K, N)
        ws = torch.rand(N, generator=gen, device="cuda") * 1e-3
        out = w8.w8a8_matmul(x, wq, ws, torch.float32)
        ref = w8.w8a8_matmul_plain(x, wq, ws, torch.float32)
        xq, sx = w8.quantize_rows(x)
        rq, rs = w8.quantize_activations(x)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = (out - ref).abs().max().item()
            raise AssertionError(f"K10 {name}: not bit-exact (max abs err {err:.3e})")
        if not (torch.equal(xq, rq) and torch.equal(sx, rs)):
            raise AssertionError(f"K10 quantize_rows {name}: not bit-exact to quantize_activations")
        del out, ref, rq, rs
        ms = cuda_ms(lambda: w8.w8a8_matmul(x, wq, ws))
        plain_ms = cuda_ms(lambda: w8.w8a8_matmul_plain(x, wq, ws, torch.bfloat16))
        quant_ms = cuda_ms(lambda: w8.quantize_rows(x))
        int_mm_ms = int_mm_ms_or_none(xq, wq)
        w16 = (wq.float() * ws).bfloat16()
        bf16_ms = cuda_ms(lambda: torch.matmul(x, w16))
        del w16
        b = bound(M * K * 2 + K * N + M * N * 2 + N * 4, 2 * M * N * K, PEAK_INT8_TOPS * 1e12)
        tops = 2 * M * N * K / (ms * 1e-3) / 1e12
        qb = bound(M * K * 3 + M * 4, 0, PEAK_INT8_TOPS * 1e12)
        imm = "n/a" if int_mm_ms is None else f"{int_mm_ms:.4f} ms"
        print(f"K10 w8a8_matmul {name} M={M} K={K} N={N}: bit-exact (f32 out), quantize_rows "
              f"bit-exact to quantize_activations ({quant_ms:.4f} ms, bound "
              f"{qb['bound_ms']:.4f} ms); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch._int_mm (int8 operands, no quantize or epilogue) {imm}, bf16 "
              f"torch.matmul (dequantized weights) {bf16_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {tops:.1f} TOPS = "
              f"{tops / PEAK_INT8_TOPS:.1%} of the int8 peak")
        times.append((name, ms, plain_ms, b))
        del wq, xq, sx, x
    torch.cuda.empty_cache()
    # The record: one decoder layer's four prefill matmuls.  No one PyTorch
    # call computes it (torch._int_mm takes int8 operands: the row quantize
    # and the scale epilogue are further calls).
    dec = [t for t in times if t[0].startswith("dec")]
    return {"max_abs_err": 0.0, "ms": sum(t[1] for t in dec), "plain_ms": sum(t[2] for t in dec),
            **_sum_bounds([t[3] for t in dec]), "library_ms": None}


def check_w8a8_scaled(gen) -> dict:
    """K10's entry with the row scales given (``w8a8_matmul(...,
    row_scales=)``: the scaled quantize kernel, then the product) at
    :data:`ROW_PARALLEL_MATMULS`, f32 out as the row-parallel partials
    are: bit-exact to its plain version, and ``quantize_rows_scaled``
    bit-exact to ``quantize_activations`` with the same scales.  x is the
    first of two K-slices of a whole row, whose abs-max gives the scales
    (one row's maximum lies in the other slice, one row is zero)."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import w8a8_matmul as w8

    times = []
    for name, M, K, N in ROW_PARALLEL_MATMULS:
        whole = torch.randn(M, 2 * K, generator=gen, device="cuda").bfloat16()
        whole[1] = 0
        whole[2, K:] *= 8
        x = whole[:, :K].contiguous()
        scales = w8.scales_of_amax(w8.row_amax(whole))
        del whole
        wq = k_major_int8(gen, K, N)
        ws = torch.rand(N, generator=gen, device="cuda") * 1e-3
        out = w8.w8a8_matmul(x, wq, ws, torch.float32, row_scales=scales)
        ref = w8.w8a8_matmul_plain(x, wq, ws, torch.float32, row_scales=scales)
        xq = w8.quantize_rows_scaled(x, scales)
        rq = w8.quantize_activations(x, scales)[0]
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = (out - ref).abs().max().item()
            raise AssertionError(f"K10 scaled {name}: not bit-exact (max abs err {err:.3e})")
        if not torch.equal(xq, rq):
            raise AssertionError(f"K10 quantize_rows_scaled {name}: not bit-exact to "
                                 f"quantize_activations")
        del out, ref, xq, rq
        ms = cuda_ms(lambda: w8.w8a8_matmul(x, wq, ws, torch.float32, row_scales=scales))
        plain_ms = cuda_ms(lambda: w8.w8a8_matmul_plain(x, wq, ws, torch.float32,
                                                        row_scales=scales))
        quant_ms = cuda_ms(lambda: w8.quantize_rows_scaled(x, scales))
        b = bound(M * K * 2 + M * 4 + K * N + N * 4 + M * N * 4, 2 * M * N * K,
                  PEAK_INT8_TOPS * 1e12)
        qb = bound(M * K * 3 + M * 4, 0, PEAK_INT8_TOPS * 1e12)
        tops = 2 * M * N * K / (ms * 1e-3) / 1e12
        print(f"K10 w8a8_matmul row_scales= {name} (tp=2 shard) M={M} K={K} N={N}: bit-exact "
              f"(f32 out), quantize_rows_scaled bit-exact to quantize_activations "
              f"({quant_ms:.4f} ms, bound {qb['bound_ms']:.4f} ms); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
              f"{tops:.1f} TOPS = {tops / PEAK_INT8_TOPS:.1%} of the int8 peak")
        times.append((name, ms, plain_ms, b))
        del wq, x, scales
    torch.cuda.empty_cache()
    # The record: one decoder layer's two row-parallel prefill products.
    dec = [t for t in times if t[0].startswith("dec")]
    return {"max_abs_err": 0.0, "ms": sum(t[1] for t in dec), "plain_ms": sum(t[2] for t in dec),
            **_sum_bounds([t[3] for t in dec]), "library_ms": None}


def int_mm_ms_or_none(xq, wq) -> float | None:
    """CUDA-event ms of ``torch._int_mm`` (cuBLAS's int8 x int8 -> int32
    product alone) on already quantized operands, or None where the card's
    torch refuses the shapes."""
    import torch

    try:
        torch._int_mm(xq, wq)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return cuda_ms(lambda: torch._int_mm(xq, wq))


def weight_int8pack_ms(x, wq, s) -> float | None:
    """CUDA-event ms of ``torch._weight_int8pack_mm`` (bf16 x, int8 (N, K)
    weight, per-column scale: K9's function in one PyTorch call), or None
    where the card's torch has no CUDA implementation of it."""
    import torch

    w_nk = wq.t().contiguous()
    scales = s.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w_nk, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return cuda_ms(lambda: torch._weight_int8pack_mm(x, w_nk, scales))


def check_kv_write_span(gen) -> dict:
    """K5 at the verify pass's shapes: lane b's T=4 K and V rows at per-lane
    slots, one lane with slot + T > S (its overflow rows dropped) and one
    wholly past S; the two-cache launch (``kv_write_span_pair``, the
    decoder's) and the single-cache one (its oracle, the TPU kernel's
    signature) bit-exact against the plain version.  Device time of the one
    launch against the two single-cache launches it replaces, in turns."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    L, B, hkv, T, S, D = 28, 8, 8, 4, 640, 128
    caches = [torch.randn(L, B, hkv, S, D, generator=gen, device="cuda").bfloat16()
              for _ in range(2)]
    rows = [torch.randn(L, B, hkv, T, D, generator=gen, device="cuda").bfloat16()
            for _ in range(2)]
    slots = torch.tensor([512, 515, 531, 560, 600, 617, S - 2, S + 5],
                         dtype=torch.int32, device="cuda")
    pair = kw.kv_write_span_pair(*(c.clone() for c in caches), *rows, slots)
    single = [kw.kv_write_span_batch(c.clone(), r, slots) for c, r in zip(caches, rows)]
    ref = kw.kv_write_span_pair_plain(*(c.clone() for c in caches), *rows, slots)
    torch.cuda.synchronize()
    for name, out in (("pair", pair), ("single-cache", single)):
        for o, r, c in zip(out, ref, caches):
            if not torch.equal(o, r):
                raise AssertionError(f"K5 {name}: differs from the plain version")
            if not (torch.equal(o[:, 6, :, : S - 2], c[:, 6, :, : S - 2])
                    and torch.equal(o[:, 7], c[:, 7])):
                raise AssertionError(f"K5 {name}: rows past the cache end were not dropped")
    print(f"K5 kv_write_span_pair (K and V, one launch) and kv_write_span_batch (one cache) "
          f"L={L} B={B} T={T} S={S}, slots {slots.tolist()}: bit-exact, overflow rows dropped")
    work = [c.clone() for c in caches]
    lane, row, slot = kw.span_indices(slots, T, S)
    vals = [r[:, lane, :, row].contiguous() for r in rows]

    def index_put():
        for w, v in zip(work, vals):
            w[:, lane, :, slot] = v

    t = write_times("K5 kv_write_span_pair", lambda: kw.kv_write_span_pair(*work, *rows, slots),
                    lambda: kw.kv_write_span_pair_plain(*work, *rows, slots), index_put)
    turns = []
    for arm in ("two", "pair", "pair", "two"):
        if arm == "pair":
            turns.append(graph_ms(lambda: kw.kv_write_span_pair(*work, *rows, slots)))
        else:
            turns.append(graph_ms(lambda: [kw.kv_write_span_batch(w, r, slots)
                                           for w, r in zip(work, rows)]))
    # The valid rows of both caches, read once and written once.
    nbytes = 2 * 2 * L * hkv * D * 2 * int(lane.numel())
    b = bound(nbytes, 0, 1.0)
    gbps = nbytes / (t["ms"] * 1e-3) / 1e9
    print(f"K5 device time in turns, two single-cache launches / the pair / the pair / two "
          f"launches: {' / '.join(f'{x:.4f}' for x in turns)} ms (index_put_ above: one call "
          f"per cache)")
    print(f"K5 bound {b['bound_ms']:.4f} ms (bytes, both caches); {lane.numel()} valid span "
          f"rows per layer and head, {gbps:.0f} GB/s by device time = "
          f"{gbps / PEAK_HBM_GBPS:.1%} of the HBM peak, {b['bound_ms'] / t['ms']:.1%} of the bound")
    # No one PyTorch call writes both caches (index_put_ takes one tensor).
    return {"max_abs_err": 0.0, **t, **b, "library_ms": None}


def check_one_span_write(label: str, launches: dict, stats) -> None:
    """The speculative loop writes both caches' span rows with one K5 launch
    per verify iteration run (a graph replay, the no-op ones after the last
    lane finished included)."""
    want = sum(st.n_decode_replays for st in stats)
    got = launches.get("kv_write_span_batch", 0)
    if got != want:
        raise AssertionError(f"{label}: kv_write_span_batch launched {got} times, want one "
                             f"per verify iteration run ({want})")
    print(f"{label}: one K5 launch per verify iteration run ({got}; "
          f"{sum(st.n_decode_steps for st in stats)} of them live)")


def smoke_prompt_lens() -> list[int]:
    """Prompt lengths of the 8 smoke clips (the model's prompt builder)."""
    from types import SimpleNamespace

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR
    from qwen3_asr_tpu_torch.audio.mel import HOP_LENGTH

    fake = SimpleNamespace(_config=ModelConfig())
    tok = StubTokenizer()
    return [len(tok.build_prompt(Qwen3ASR._n_audio_tokens(fake, len(c) // HOP_LENGTH)))
            for c in smoke_clips()]


#: K6/K7's check grid: (B, dcount, PS) over the smoke clips' prompt lengths
#: (cycled past 8 lanes), Hq 16, Hkv 8.  B=64 is the paged engine's
#: ``spec_engine_max_slots_paged``; the kernels line reads the smoke
#: batch's shape, ``PAGED_ROW``.
PAGED_GRID = tuple((B, dc, 256) for B in (1, 8, 64) for dc in (64, 1024)) + ((8, 64, 128),)
PAGED_ROW = (8, 64, 256)


def paged_case(gen, B: int, T: int, q8: bool, dcount: int, PS: int) -> dict:
    """K6 (T = 1) or K7 inputs at (B, dcount, PS): the smoke clips' prompt
    lengths, cycled; ``dcount`` decode rows a lane; one idle lane (no prompt
    or decode rows) where B > 1; pages shuffled over a pool sized as the
    engine's (1 + B x max_pages pages), with ``cold_layers`` layers for the
    valid rows' bytes (int8 rows plus one f32 scale each when ``q8``)."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    hq, hkv, D = 16, 8, 128
    plen = np.resize(np.asarray(smoke_prompt_lens(), np.int32), B)
    dc = np.full(B, dcount, np.int32)
    if B > 1:                      # one idle lane
        plen[-1] = dc[-1] = 0
    max_pages = -(-int(plen.max()) // PS) + -(-dcount // PS)
    n_pages = 1 + B * max_pages
    free = list(np.random.default_rng(SEED).permutation(np.arange(1, n_pages)))
    table = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        need = -(-int(plen[b]) // PS) + -(-int(dc[b]) // PS)
        table[b, :need] = [free.pop() for _ in range(need)]
    rows = int((plen + dc).sum())
    b_, call_bytes = attention_bound(B, hq, hkv, rows, (D + 4) if q8 else D * 2, T)
    bf, _ = attention_bound(B, hq, hkv, rows, (D + 4) if q8 else D * 2, T, store=True)
    # The fused store's targets: the T rows after each lane's decode rows,
    # on the page the engine plans for them, or on the lane's last page at
    # its first offsets where that page is full (dcount 1024: the store
    # replaces rows the launch reads); the idle lane's on the trash page 0.
    pp = -(-plen // PS)
    need = pp + -(-dc // PS)
    wrow = dc[:, None] + np.arange(T)[None, :]
    entry = np.minimum(pp[:, None] + wrow // PS, np.maximum(need - 1, 0)[:, None])
    wpages = table[np.arange(B)[:, None], entry]
    woffs = (wrow % PS).astype(np.int32)
    L = cold_layers(call_bytes)
    pools = []
    for _ in range(2):
        x = torch.randn((L, n_pages, hkv, PS, D), generator=gen, device="cuda")
        pools.append(quantize_kv(x) if q8 else x.bfloat16())
        del x
    to = lambda x: torch.from_numpy(x).cuda()   # noqa: E731
    return dict(
        q=torch.randn(B, hq, T, D, generator=gen, device="cuda").bfloat16(),
        kpool=pools[0], vpool=pools[1],
        k_new=torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16(),
        v_new=torch.randn(B, hkv, T, D, generator=gen, device="cuda").bfloat16(),
        table=to(table), plen=to(plen), dcount=to(dc), rows=rows, L=L, PS=PS,
        call_bytes=call_bytes, bound=b_, store_bound=bf,
        wpages=to(np.ascontiguousarray(wpages)), woffs=to(woffs),
    )


def paged_kernel(T: int, q8: bool):
    """(wrapper, label) of K6 (T = 1) or K7 over the bf16 or int8 pool."""
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention_paged as dap

    if T == 1:
        return ((dap.decode_attention_paged_q8 if q8 else dap.decode_attention_paged),
                "K6 decode_attention_paged" + ("_q8" if q8 else ""))
    return ((dap.decode_attention_paged_verify_q8 if q8 else dap.decode_attention_paged_verify),
            "K7 decode_attention_paged_verify" + ("_q8" if q8 else ""))


def paged_call(c: dict, layer: int, pools=None, write: bool = False):
    """The case's K6/K7 call on ``layer`` through its wrapper, as (B, Hq,
    T, D), on the case's pools or ``pools``; ``write``: with the fused
    store at the case's write targets."""
    T = c["q"].shape[2]
    fn, _ = paged_kernel(T, isinstance(c["kpool"], dict))
    kp, vp = pools or (c["kpool"], c["vpool"])
    target = dict(write_pages=c["wpages"], write_offsets=c["woffs"]) if write else {}
    args = (kp, vp, c["k_new"], c["v_new"], layer, c["table"], c["plen"], c["dcount"])
    if T > 1:
        return fn(c["q"], *args, **target)
    return fn(c["q"][:, :, 0], *args, **target)[:, :, None]


def hold_fused_paged(label: str, c: dict, layer: int) -> None:
    """K6/K7 with the fused store on the case's pools against the call
    without it on copies followed by the standalone K8 on the layer: the
    output and the whole pool (int8 rows and scales) bit for bit; the layer
    also against the plain writer.  Raises otherwise."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    q8 = isinstance(c["kpool"], dict)
    write = kw.kv_write_rows_paged_q8 if q8 else kw.kv_write_rows_paged
    write_plain = kw.kv_write_rows_paged_q8_plain if q8 else kw.kv_write_rows_paged_plain
    ref_k, ref_v = clone_cache(c["kpool"]), clone_cache(c["vpool"])
    plain_k = clone_cache(layer_of(c["kpool"], layer))
    ref = paged_call(c, layer, (ref_k, ref_v))
    write(layer_of(ref_k, layer), c["k_new"][None], c["wpages"], c["woffs"])
    write(layer_of(ref_v, layer), c["v_new"][None], c["wpages"], c["woffs"])
    write_plain(plain_k, c["k_new"][None], c["wpages"], c["woffs"])
    out = paged_call(c, layer, write=True)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"{label}: output differs from the call without the store")
    if not (same_cache(c["kpool"], ref_k) and same_cache(c["vpool"], ref_v)):
        raise AssertionError(f"{label}: pool differs from the attention, then the standalone "
                             "writer")
    if not same_cache(layer_of(c["kpool"], layer), plain_k):
        raise AssertionError(f"{label}: pool differs from the plain writer's")
    del ref_k, ref_v, plain_k


def paged_layer(c: dict, layer: int) -> tuple:
    """Layer ``layer`` of the case's pools alone, as a one-layer pool."""
    if isinstance(c["kpool"], dict):
        return tuple({k: v[layer:layer + 1] for k, v in c[n].items()} for n in ("kpool", "vpool"))
    return c["kpool"][layer:layer + 1], c["vpool"][layer:layer + 1]


def paged_plain(c: dict, layer: int, f32: bool = True):
    """K6/K7's plain version on one layer, in float32 (the reference) or in
    the kernel's types (timed)."""
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention_paged as dap

    kl, vl = paged_layer(c, layer)
    q8 = isinstance(kl, dict)
    plain = dap.paged_attention_q8_plain if q8 else dap.paged_attention_plain
    q, k_new, v_new = c["q"], c["k_new"], c["v_new"]
    if f32:
        q, k_new, v_new = q.float(), k_new.float(), v_new.float()
        if not q8:
            kl, vl = kl.float(), vl.float()
    return plain(q, kl, vl, k_new, v_new, 0, c["table"], c["plen"], c["dcount"],
                 q.shape[-1] ** -0.5)


def paged_hold(label: str, c: dict, out, ref=None) -> float:
    """Max abs error of a K6/K7 output on the last layer against the plain
    version in float32 (``ref``, or computed from the pools as they are;
    atol 2e-2 + rtol 2e-2 of the bf16 kernel, as K2), the idle lane checked
    finite and not compared, as the engine discards it."""
    import torch

    B = out.shape[0]
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{label}: non-finite output")
    if ref is None:
        ref = paged_plain(c, c["L"] - 1)
    live = slice(0, B - 1) if B > 1 else slice(0, 1)
    return _close(label, out[live], ref[live], 2e-2, 2e-2)


def check_decode_paged(gen, T: int, q8: bool) -> tuple[dict, dict]:
    """K6 (T = 1) or K7 (T = 4, 8 query rows per KV head), bf16 or int8
    pool, at ``PAGED_GRID`` against the plain version in float32
    (``paged_hold``); with its fused store (the case's write targets) held
    to the call without it followed by the standalone K8
    (:func:`hold_fused_paged`); timed on a cold cache without and with the
    store in turns.  Returns the records of the kernel and of its store."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw

    _, label = paged_kernel(T, q8)
    store = "K8-int8" if q8 else "K8"
    write_plain = kw.kv_write_rows_paged_q8_plain if q8 else kw.kv_write_rows_paged_plain
    worst, row = 0.0, None
    for B, dcount, PS in PAGED_GRID:
        c = paged_case(gen, B, T, q8, dcount, PS)
        name = f"{label} B={B} T={T} PS={PS} dcount={dcount}"
        out = paged_call(c, c["L"] - 1)
        torch.cuda.synchronize()
        err = paged_hold(name, c, out)
        del out
        hold_fused_paged(f"{store} fused into {name}", c, c["L"] - 1)
        t = fused_turns(lambda layer, fused: paged_call(c, layer, write=fused), c["L"])
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: paged_plain(c, 0, f32=False))
        kl, vl = paged_layer(c, 0)
        fused_plain_ms = cuda_ms(lambda: (
            paged_plain(c, 0, f32=False),
            write_plain(kl, c["k_new"][None], c["wpages"], c["woffs"]),
            write_plain(vl, c["v_new"][None], c["wpages"], c["woffs"])))
        b, bf = c["bound"], c["store_bound"]
        gbps = c["call_bytes"] / (ms * 1e-3) / 1e9
        print(f"{name}: max_abs_err={err:.3e} kernel {ms:.4f} ms device time "
              f"({cold_note(c['L'], c['call_bytes'])}; host-paced {t['host_ms']:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); {c['rows']} "
              f"valid rows, {gbps:.0f} GB/s = {gbps / PEAK_HBM_GBPS:.1%} of the HBM peak")
        print(f"{store} fused into {name}: output and pool bit-identical to the attention, "
              f"then the standalone writer; with the store {t['fused_ms']:.4f} ms device time "
              f"against {ms:.4f} without ({t['fused_ms'] - ms:+.4f} ms; host-paced "
              f"{t['fused_host_ms']:.4f} / {t['host_ms']:.4f} ms), plain attention + writer "
              f"{fused_plain_ms:.4f} ms, bound {bf['bound_ms']:.4f} ms (the store's "
              f"{(bf['bound_ms'] - b['bound_ms']) * 1e3:.4f} us)")
        worst = max(worst, err)
        if (B, dcount, PS) == PAGED_ROW:
            row = ({"ms": ms, "plain_ms": plain_ms, **b},
                   {"ms": t["fused_ms"], "plain_ms": fused_plain_ms, **bf})
        del c
        torch.cuda.empty_cache()
    # No one PyTorch call: a page-table gather, two masked intervals and a
    # fresh (causal) block of rows not in the pool.
    return ({"max_abs_err": worst, **row[0], "library_ms": None},
            {"max_abs_err": worst, **row[1], "library_ms": None})


def check_kv_write_paged(gen, q8: bool) -> dict:
    """K8 at the engine's shapes (L=28, B=8, PS=256, the 33-page pool): the
    step's one row per lane and the verify's 4, one lane on the trash page,
    one past the pool (clipped); bit-exact outside page 0."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import kv_write as kw
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv

    L, B, hkv, PS, D, n_pages = 28, 8, 8, 256, 128, 33
    if q8:
        pool = quantize_kv(torch.randn(L, n_pages, hkv, PS, D, generator=gen, device="cuda"))
        fn, plain, label = kw.kv_write_rows_paged_q8, kw.kv_write_rows_paged_q8_plain, "K8 int8"
    else:
        pool = torch.randn(L, n_pages, hkv, PS, D, generator=gen, device="cuda").bfloat16()
        fn, plain, label = kw.kv_write_rows_paged, kw.kv_write_rows_paged_plain, "K8 bf16"
    clone = (lambda p: {k: v.clone() for k, v in p.items()}) if q8 else (lambda p: p.clone())
    rec = None
    for T in (1, 4):
        rows = torch.randn(L, B, hkv, T, D, generator=gen, device="cuda").bfloat16()
        pages = torch.tensor([5, 9, 0, 17, 22, 30, 2, n_pages + 4], dtype=torch.int32,
                             device="cuda")[:, None].repeat(1, T).contiguous()
        offs = (torch.tensor([64, 100, 7, 0, 255 - T, 128, 31, 90], device="cuda")[:, None]
                + torch.arange(T, device="cuda")).int().contiguous()
        out, ref = fn(clone(pool), rows, pages, offs), plain(clone(pool), rows, pages, offs)
        torch.cuda.synchronize()
        outs = (out["q"], out["s"]) if q8 else (out,)
        refs = (ref["q"], ref["s"]) if q8 else (ref,)
        if not all(torch.equal(o[:, 1:], r[:, 1:]) for o, r in zip(outs, refs)):
            raise AssertionError(f"{label} T={T}: differs from the plain version outside page 0")
        print(f"{label} kv_write_rows_paged T={T}: bit-exact outside the trash page")
        if T == 1:
            work = clone(pool)
            index_put = None
            if not q8:
                keep, p, o = kw.paged_indices(pages, offs, n_pages, PS)
                vals = rows.permute(1, 3, 0, 2, 4).reshape(B * T, L, hkv, D)[keep].contiguous()

                def index_put():
                    work[:, p, :, o] = vals

            # int8: no one PyTorch call quantizes a row and stores it with its scale.
            t = write_times(f"{label} kv_write_rows_paged L={L} B={B} T=1",
                            lambda: fn(work, rows, pages, offs),
                            lambda: plain(work, rows, pages, offs), index_put)
            # bf16 rows in; bf16 rows, or int8 rows and f32 scales out.
            b = bound(L * B * T * hkv * (D * 2 + ((D + 4) if q8 else D * 2)), 0, 1.0)
            print(f"{label} bound {b['bound_ms']:.4f} ms (bytes)")
            rec = {"max_abs_err": 0.0, **t, **b}
    return rec


def _params_to(tree, device, dtype):
    """A parameter tree on ``device``: float tensors in ``dtype``, int8
    ``{"q", "s"}`` weights with their own dtypes."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return {k: v.to(device) for k, v in tree.items()}
        return {k: _params_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype)


#: The decode modes whose split step runs its own kernel with a shared write
#: slot, and that kernel's launch counter.
DECODE_MODES = (("auto", "decode_attention"), ("3", "decode_attention_hbm2"),
                ("4", "decode_attention_hbm3"))


def reference_check(quantized: bool) -> None:
    """Kernels (GPU) against the plain path (float32, CPU) on one small
    decoder: prefill logits, one split-decode step and, on the bf16 cache,
    one verify-split forward (T=4 per lane at per-lane write slots, one
    lane's span running past the cache end); on the bf16 cache once under
    each of :data:`DECODE_MODES`.  ``quantized``: int8 weights, W8A8 prefill
    and the int8 cache on both sides (no verify: the int8 cache never
    speculates)."""
    import torch

    from qwen3_asr_tpu_torch.config import RuntimeConfig, TextDecoderConfig
    from qwen3_asr_tpu_torch.models import decoder as dec_mod
    from qwen3_asr_tpu_torch.models.decoder import (
        decoder_forward, decoder_logits, embed_tokens, fuse_decoder_params,
        init_decoder_params,
    )
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.ops.quant import quantize_decoder_params
    from qwen3_asr_tpu_torch.ops.quant_kv import quantize_kv_cache
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    cfg = TextDecoderConfig(
        hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, intermediate_size=512,
        vocab_size=1024,
    )
    g = torch.Generator().manual_seed(SEED)
    ref_params = fuse_decoder_params(init_decoder_params(cfg, g, torch.float32, "cpu"))
    runtime = RuntimeConfig()
    if quantized:
        ref_params = quantize_decoder_params(ref_params)
        # 3 x 77 prefill rows pass the W8A8 gate; the 3-row decode step and
        # the lm head stay weight-only.
        runtime = RuntimeConfig(**INT8_RUNTIME, act_quant_min_rows=64)
    gpu_params = _params_to(ref_params, "cuda", torch.bfloat16)
    B, P, Ta, pb, tb = 3, 77, 60, 256, 128
    features = torch.randn(B, Ta, cfg.hidden_size, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    n_audio = torch.tensor([60, 41, 17])
    plen = torch.tensor([77, 58, 34])
    draft = torch.randint(0, cfg.vocab_size, (B, 3), generator=g)   # verify ids 1..3
    ws = torch.tensor([pb + 1, pb + 3, pb + tb - 2], dtype=torch.int32)
    cur = None                       # step token: the f32 run's first argmax

    def run(params, dev):
        nonlocal cur
        gen = Generator(params, cfg, runtime)
        dtype = params["final_norm"].dtype
        with torch.inference_mode():
            kv, logits = gen.prefill(
                features.to(dev, dtype), ids.to(dev), n_audio.to(dev), plen.to(dev),
                pb + tb,
            )
            if quantized:
                kv = quantize_kv_cache(kv)
            if cur is None:
                cur = logits.argmax(-1).cpu()
            embeds = embed_tokens(params, cur.to(dev))[:, None, :]
            pos = plen.to(dev)[:, None]       # prompt_len + count - 1, count 1
            hidden, kv = decoder_forward(
                params, cfg, embeds, pos, kv, write_slots=pb,
                decode_ctx=(plen.to(dev, torch.int32), pb, pb),
            )
            step_logits = decoder_logits(params, cfg, hidden)[:, 0]
            if quantized:
                return logits.float().cpu(), step_logits.float().cpu()
            verify_ids = torch.cat([cur[:, None], draft], dim=1).to(dev)
            w = ws.to(dev)
            pos = plen.to(dev)[:, None] + (w.long() - pb)[:, None] + torch.arange(4, device=dev)
            hidden, kv = decoder_forward(
                params, cfg, embed_tokens(params, verify_ids), pos, kv, write_slots=w,
                decode_ctx=(plen.to(dev, torch.int32), w, pb),
            )
            verify_logits = decoder_logits(params, cfg, hidden)
        return logits.float().cpu(), step_logits.float().cpu(), verify_logits.float().cpu()

    ref = run(ref_params, "cpu")
    labels = ("prefill logits", "decode-step logits", "verify-split logits (T=4)")
    # The bf16 step runs once per decode mode with a shared slot: K2
    # ("auto"), K11a ("3"), K11b ("4"); the f32 CPU reference is one function.
    modes = (("auto", "decode_attention_q8"),) if quantized else DECODE_MODES
    for mode, kernel in modes:
        what = "int8 decoder, GPU kernels vs f32 CPU plain" if quantized else \
            f"bf16 GPU kernels, decode mode {mode!r}, vs f32 CPU plain"
        saved, dec_mod.DECODE_KERNEL_MODE = dec_mod.DECODE_KERNEL_MODE, mode
        before = LAUNCHES[kernel]
        try:
            out = run(gpu_params, "cuda")
        finally:
            dec_mod.DECODE_KERNEL_MODE = saved
        if LAUNCHES[kernel] - before < cfg.num_hidden_layers:
            raise AssertionError(f"reference check, decode mode {mode!r}: {kernel} not launched")
        for i, label in enumerate(labels[: len(ref)]):
            rel = ((out[i] - ref[i]).abs().max() / ref[i].abs().max()).item()
            print(f"reference check ({label}, {what}): "
                  f"max abs err / max |ref| = {rel:.3e}")
            if not rel < 5e-2:
                raise AssertionError(f"{label}: relative error {rel:.3e} >= 5e-2")


def reference_check_paged() -> None:
    """Kernels (GPU, bf16) against the plain path (CPU, float32) on one small
    decoder, through the paged pool: a prefill's rows scattered into
    shuffled pages (PS=128), then one paged step (K6, K8 fused) and one
    paged verify (K7 at T=4, K8 fused) on the rows the step wrote."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.config import TextDecoderConfig
    from qwen3_asr_tpu_torch.models.decoder import (
        decoder_logits, decoder_paged_step, decoder_paged_verify, embed_tokens,
        fuse_decoder_params, init_decoder_params,
    )
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    cfg = TextDecoderConfig(
        hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, intermediate_size=512, vocab_size=1024,
    )
    g = torch.Generator().manual_seed(SEED + 7)
    ref_params = fuse_decoder_params(init_decoder_params(cfg, g, torch.float32, "cpu"))
    gpu_params = _params_to(ref_params, "cuda", torch.bfloat16)
    B, P, Ta, pb, PS = 3, 77, 60, 256, 128
    features = torch.randn(B, Ta, cfg.hidden_size, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    n_audio = torch.tensor([60, 41, 17])
    plen = torch.tensor([77, 58, 34], dtype=torch.int32)
    draft = torch.randint(0, cfg.vocab_size, (B, 3), generator=g)
    npg, max_pages = pb // PS, pb // PS + 1
    n_pages = 1 + B * max_pages
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    table = torch.from_numpy(perm.reshape(B, max_pages).astype(np.int32))
    lanes = torch.arange(B)
    cur = None

    def run(params, dev):
        nonlocal cur
        gen = Generator(params, cfg)
        dtype = params["final_norm"].dtype
        with torch.inference_mode():
            (k, v), logits = gen.prefill(features.to(dev, dtype), ids.to(dev),
                                         n_audio.to(dev), plen.long().to(dev), pb)
            pools = []
            for c in (k, v):
                pool = torch.zeros((cfg.num_hidden_layers, n_pages) + c.shape[2:3] + (PS, 128),
                                   dtype=dtype, device=dev)
                src = c.reshape(c.shape[0], B, c.shape[2], npg, PS, 128).transpose(2, 3)
                pool[:, table[:, :npg].reshape(-1).long().to(dev)] = src.reshape(
                    c.shape[0], B * npg, c.shape[2], PS, 128)
                pools.append(pool)
            if cur is None:                  # the f32 run's first argmax
                cur = logits.argmax(-1).cpu()
            tab, pl = table.to(dev), plen.to(dev)
            pp = (plen.long() + PS - 1) // PS
            # The step: decode row 0 of each lane at its first decode page.
            hidden, pools = decoder_paged_step(
                params, cfg, embed_tokens(params, cur.to(dev))[:, None], pl.long()[:, None],
                tuple(pools), tab, pl, torch.zeros(B, dtype=torch.int32, device=dev),
                table[lanes, pp].to(dev), torch.zeros(B, dtype=torch.int32, device=dev),
            )
            step_logits = decoder_logits(params, cfg, hidden)[:, 0]
            # The verify: decode rows 1..4 after the step's row.
            verify_ids = torch.cat([cur[:, None], draft], dim=1).to(dev)
            pos = pl.long()[:, None] + 1 + torch.arange(4, device=dev)
            rows = 1 + torch.arange(4)
            pages = table[lanes[:, None], pp[:, None] + rows[None, :] // PS].to(dev)
            offs = (rows % PS).int()[None, :].repeat(B, 1).to(dev)
            hidden, _ = decoder_paged_verify(
                params, cfg, embed_tokens(params, verify_ids), pos, pools, tab, pl,
                torch.ones(B, dtype=torch.int32, device=dev), pages, offs,
            )
            verify_logits = decoder_logits(params, cfg, hidden)
        return step_logits.float().cpu(), verify_logits.float().cpu()

    ref = run(ref_params, "cpu")
    out = run(gpu_params, "cuda")
    for label, o, r in zip(("paged step logits (K6, K8 fused)",
                            "paged verify logits (K7 T=4, K8 fused)"), out, ref):
        rel = ((o - r).abs().max() / r.abs().max()).item()
        print(f"reference check ({label}, bf16 GPU kernels vs f32 CPU plain): "
              f"max abs err / max |ref| = {rel:.3e}")
        if not rel < 5e-2:
            raise AssertionError(f"{label}: relative error {rel:.3e} >= 5e-2")


class StubTokenizer:
    """Prompt-structure-preserving tokenizer: no tokenizer files are on the
    card's machine.  ``decode`` writes ids as ``t<id>`` words."""

    def encode(self, text):
        return [sum(map(ord, text)) % 1000 + 100]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{t}" for t in ids)

    def build_prompt(self, n_audio_tokens, language="English"):
        from qwen3_asr_tpu_torch.tokenizer import build_detect_prompt, build_prompt

        if language is None:
            return build_detect_prompt(n_audio_tokens)
        return build_prompt(n_audio_tokens, self.encode(f" {language}"))


def _ids(results) -> list[list[int]]:
    return [[int(w[1:]) for w in r.text.split()] for r in results]


def check_lm_head_f32(model, hidden) -> None:
    """The bf16 lm head's logits equal the f32 upcast product on a few rows
    (f32 accumulator; a bf16-rounded output would be off by up to 1/256 of
    each logit)."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import decoder_logits
    from qwen3_asr_tpu_torch.ops.norms import rms_norm

    params, cfg = model._decoder_params, model._config.text_decoder
    h = hidden[:4].reshape(-1, 1, hidden.shape[-1])
    with torch.inference_mode():
        logits = decoder_logits(params, cfg, h)
        hn = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        ref = hn.float() @ params["embedding"].float().T
    if logits.dtype != torch.float32:
        raise AssertionError(f"lm head logits are {logits.dtype}, not float32")
    err = _close("bf16 lm head vs f32 product", logits, ref,
                 1e-5 * ref.abs().max().item(), 1e-5)
    print(f"bf16 lm head: f32 logits of {h.shape[0]} prefill rows vs the f32 upcast "
          f"product: max_abs_err={err:.3e} (max |logit| {ref.abs().max().item():.3f})")


def smoke_clips():
    """The smoke batch: 8 tone-plus-noise clips of 4-30 s (133 s of audio)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    clips = []
    for d in (4.0, 7.5, 11.0, 14.5, 18.0, 22.0, 26.0, 30.0):
        t = np.arange(int(d * 16000)) / 16000.0
        f = rng.uniform(120.0, 900.0)
        clip = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(len(t))
        clips.append(clip.astype(np.float32))
    return clips


def runtime_tag(runtime: dict | None) -> str:
    return f"RuntimeConfig({', '.join(f'{k}={v!r}' for k, v in (runtime or {}).items())})"


def build_model(runtime: dict | None, base=None):
    """The 1.7B model from random weights (seed 0) on the card, or, given
    ``base``, a model sharing its weights under another runtime (with
    ``quantization="int8"`` the decoder is quantized from them)."""
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig

    t0 = time.perf_counter()
    rt = RuntimeConfig(**(runtime or {}))
    if base is None:
        model = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(), runtime=rt,
                                     dtype=torch.bfloat16, seed=SEED, device="cuda")
        how = f"from_random(ModelConfig(), bf16, seed={SEED})"
    else:
        model = Qwen3ASR(base._config, base._encoder_params, base._decoder_params,
                         base._tokenizer, rt)
        how = "the same weights"
    torch.cuda.synchronize()
    print(f"{how}, {runtime_tag(runtime)} on cuda: {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return model


#: The device flag every :class:`Watch` sets on NaN logits: one tensor, so a
#: decode graph captured under one Watch sets it when replayed under another.
_NAN_SEEN = []


class Watch:
    """Wraps the decode loop's logits function while active (``module``'s
    ``decoder_logits``: the generator's, or the engine's): one device flag
    for NaN logits (no sync per step; a decode step captured as a graph
    while a Watch is active keeps the check) and the first lm-head input
    that an eager step computes."""

    def __init__(self, module=None):
        import torch

        from qwen3_asr_tpu_torch.runtime import generate

        self.generate = module or generate
        if not _NAN_SEEN:
            _NAN_SEEN.append(torch.zeros((), dtype=torch.bool, device="cuda"))
        self.nan_seen = _NAN_SEEN[0]
        self.first_hidden = []

    def __enter__(self):
        import torch

        self.nan_seen.zero_()
        real_logits = self.real_logits = self.generate.decoder_logits

        def logits(params, cfg, hidden, tp=None):
            out = real_logits(params, cfg, hidden, tp=tp)
            self.nan_seen.logical_or_(torch.isnan(out).any())
            if not self.first_hidden:
                self.first_hidden.append(hidden.clone())
            return out

        self.generate.decoder_logits = logits
        return self

    def __exit__(self, *exc):
        self.generate.decoder_logits = self.real_logits


def top_two_gaps(rows):
    """(choices, 2, B) on the host: per recorded token choice, the gap
    between the top two penalized logits and the row's max |logit|."""
    import torch

    out = []
    for r in rows:
        top2 = r.topk(2, dim=-1).values
        out.append(torch.stack([top2[:, 0] - top2[:, 1], r.abs().amax(-1)]))
    return torch.stack(out).cpu()


def check_launches(label: str, launches: dict, path=(), never=()) -> None:
    for name in path:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    for name in never:
        if launches.get(name, 0):
            raise AssertionError(f"{label}: kernel {name} was launched {launches[name]} times")
    print(f"{label} launches: {launches}")


def check_ids(label: str, ids: list[list[int]], vocab: int) -> None:
    flat = [t for seq in ids for t in seq]
    if not flat or min(flat) < 0 or max(flat) >= vocab:
        raise AssertionError(f"{label}: no tokens, or token ids outside [0, vocab)")


def print_stats(label: str, card: str, st) -> None:
    steps = max(st.n_decode_steps, 1)
    decode_ms = st.stages["decode"] * 1e3
    kind = "verify iterations" if st.n_spec_forwards else "steps"
    spec = (f", {st.spec_tokens_per_forward:.3f} tokens per lane-forward"
            if st.n_spec_forwards else "")
    print(
        f"{label} [{card}]: audio {st.audio_seconds:.1f} s, prepare "
        f"{st.stages['prepare'] * 1e3:.1f} ms, mel+encoder+prefill "
        f"{st.stages['prefill'] * 1e3:.1f} ms, decode {decode_ms:.1f} ms over "
        f"{st.n_decode_steps} {kind} ({st.n_decode_replays} run, {st.n_host_syncs} host "
        f"syncs) = {decode_ms / steps:.2f} ms/iteration, "
        f"{st.n_generated_tokens} tokens = {decode_ms / max(st.n_generated_tokens, 1):.3f} "
        f"ms per emitted token{spec}, RTFx {st.rtfx:.1f}"
    )


def slice_phase(card: str, model, runtime: dict | None, path, never=(),
                lm_head: bool = False, record_gaps: bool = False) -> dict:
    """The 1.7B path through the entry points: a warm-up that captures the
    path's decode graphs (B=8 and B=1 at the smoke batch's bucket), then
    greedy ``transcribe_batch`` of the smoke batch (``max_tokens=64``) twice
    and one ``transcribe`` of the 30 s clip, graphed, with the launch
    counters set to 0 just before and read just after.  Checks ids, NaN,
    run-to-run identity and the path's launches.  With ``record_gaps`` the
    same calls then run the eager loop under :class:`Choices`, which must
    give the graphed tokens bit for bit, recording each choice's top-two
    gap."""
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    vocab = model._config.text_decoder.vocab_size
    tag = runtime_tag(runtime)
    clips = smoke_clips()
    out = {"gaps": []}
    with Watch() as watch:
        model.warm_up(durations=(30.0,), batch_sizes=(8, 1), max_tokens=64)
        graphs = model._generator.graphs
        captures = graphs.captures
        LAUNCHES.clear()
        runs = [(_ids(model.transcribe_batch(clips, max_tokens=64)), model.last_stats)
                for _ in range(2)]
        single = model.transcribe(clips[-1], max_tokens=64)
        single_stats = model.last_stats
        launches = dict(LAUNCHES)
        if graphs.captures != captures:
            raise AssertionError(f"{tag}: the warm-up left a bucket of the path uncaptured")
        if bool(watch.nan_seen):
            raise AssertionError(f"{tag}: NaN logits on the path")
        if record_gaps:
            watch.first_hidden.clear()
            eager = []
            for call in (lambda: model.transcribe_batch(clips, max_tokens=64),
                         lambda: [model.transcribe(clips[-1], max_tokens=64)]):
                with Choices() as rec:
                    eager.append(_ids(call()))
                out["gaps"].append(top_two_gaps(rec.rows))
            del rec
            if eager != [runs[0][0], _ids([single])]:
                raise AssertionError(f"{tag}: the eager loop's tokens differ from the graphed")
            print(f"{tag}: eager loop (transcribe_batch B=8, transcribe B=1) token-identical "
                  f"to the graphed loop")
            if lm_head:
                check_lm_head_f32(model, watch.first_hidden[0])
    (ids_a, stats_a), (ids_b, stats_b) = runs
    if ids_a != ids_b:
        raise AssertionError(f"{tag}: two greedy transcribe_batch runs gave different tokens")
    check_ids(tag, ids_a + _ids([single]), vocab)
    check_launches(f"path {tag}", launches, path, never)
    for label, st in (("transcribe_batch B=8 run 1", stats_a),
                      ("transcribe_batch B=8 run 2", stats_b),
                      ("transcribe B=1", single_stats)):
        print_stats(f"{label} {tag}", card, st)
    out.update(launches=launches, ids=(ids_a, _ids([single])[0]),
               stats=(stats_a, stats_b, single_stats))
    return out


def compare_streams(label: str, plain, spec, gaps) -> None:
    """Each lane's speculative stream equals its plain stream, or first
    differs where the plain run's top two penalized logits lie within
    NEAR_TIE of that row's max |logit| (a bf16 near-tie: the verify
    forward's M = 4B-row products may round otherwise than the step's
    M = B).  ``gaps`` (choices, 2, B): position p of a lane is the plain
    run's p-th token choice.  Prints the median top-two gap of the plain
    run's choices beside the limit."""
    import torch

    rel = gaps[:, 0] / gaps[:, 1]
    live = torch.arange(gaps.shape[0])[:, None] < torch.tensor([len(p) for p in plain])[None, :]
    print(f"{label}: median plain top-two gap {rel[live].median().item():.2e} of max "
          f"|logit| over {int(live.sum())} choices, {(rel[live] <= NEAR_TIE).float().mean():.1%} "
          f"of them within the near-tie limit {NEAR_TIE:g}")
    identical, diverged = 0, []
    for b, (p, s) in enumerate(zip(plain, spec)):
        if p == s:
            identical += 1
            continue
        i = next((j for j, (x, y) in enumerate(zip(p, s)) if x != y), min(len(p), len(s)))
        if i >= gaps.shape[0]:
            raise AssertionError(f"{label} lane {b}: diverges at {i}, past the recorded steps")
        gap, top = float(gaps[i, 0, b]), float(gaps[i, 1, b])
        diverged.append((b, i, gap, top))
        print(f"{label} lane {b}: first divergence at position {i}, plain top-two gap "
              f"{gap:.4e} = {gap / top:.2e} of max |logit| {top:.3f}")
        if gap > NEAR_TIE * top:
            raise AssertionError(f"{label} lane {b}: diverges at {i} where the plain "
                                 f"run's top-two gap is {gap / top:.2e} of max |logit|")
    print(f"{label}: {identical} of {len(plain)} lanes identical in full, "
          f"{len(diverged)} diverge at a near-tie")


class Choices:
    """Records, while active, every greedy token choice of the decode loops
    (its penalized logits row (B, V), on the device), the lanes' counts at
    each verify iteration, and each decode call's token lists.  ``drafts``
    (B, n) replaces the n-gram draft with each lane's next ``gamma`` tokens
    of that stream (teacher forcing); ``forced`` (B, n) makes the loop emit
    that stream whatever its own choice.  The hooks run in Python at every
    step, so the decode calls made while active run the eager loop
    (``decode(eager=True)``), never a captured graph."""

    def __init__(self, drafts=None, forced=None):
        from qwen3_asr_tpu_torch.runtime import generate

        self.generate = generate
        self.drafts, self.forced = drafts, forced
        self.rows, self.counts, self.streams = [], [], []
        self.n_sampled = 0

    def __enter__(self):
        import torch

        g = self.generate
        self.saved = (g.apply_repetition_penalty, g.ngram_draft, g._Request.sample,
                      g.Generator.decode)
        real_penalty, real_draft, real_sample, real_decode = self.saved

        def penalty(lg, recent, pen):
            out = real_penalty(lg, recent, pen)
            self.rows.append(out)
            return out

        def draft(tokens, counts, n, gamma):
            self.counts.append(counts.clone())
            if self.drafts is None:
                return real_draft(tokens, counts, n=n, gamma=gamma)
            stream, lens = self.drafts
            idx = counts.long()[:, None] + torch.arange(gamma, device=counts.device)[None, :]
            return stream.gather(1, idx.clamp(max=stream.shape[1] - 1)), idx < lens[:, None]

        def sample(req, logits, recent, pen):
            out = real_sample(req, logits, recent, pen)
            j, self.n_sampled = self.n_sampled, self.n_sampled + 1
            if self.forced is None or j >= self.forced[0].shape[1]:
                return out
            return self.forced[0][:, j]

        def decode(gen, *args, **kwargs):
            out = real_decode(gen, *args, eager=True, **kwargs)
            self.streams.append(out)
            return out

        g.apply_repetition_penalty, g.ngram_draft = penalty, draft
        g._Request.sample, g.Generator.decode = sample, decode
        return self

    def __exit__(self, *exc):
        g = self.generate
        (g.apply_repetition_penalty, g.ngram_draft, g._Request.sample,
         g.Generator.decode) = self.saved


def padded(streams):
    """Token lists as a (B, n) int64 tensor on the card and their lengths."""
    import torch

    n = max(len(s) for s in streams)
    out = torch.zeros((len(streams), n), dtype=torch.long)
    for b, s in enumerate(streams):
        out[b, : len(s)] = torch.tensor(s)
    return out.cuda(), torch.tensor([len(s) for s in streams], device="cuda")


def hold_to_plain(label: str, base, model, clips, teacher=None, penalty: float = 1.2):
    """One greedy ``transcribe_batch`` of ``clips`` through the speculative
    loop of ``model`` (n-gram drafts, or with ``teacher`` each lane's next
    tokens of that stream), then the plain loop of ``base`` (same weights,
    ``"off"``) forced to emit the speculative stream.  Both see the same
    prefix at every position, so every token the verify forward emitted is
    held to the plain step's row: the token is the verify row's argmax (the
    accept chain emitted what the verify forward chose), |verify row - plain
    row| <= LOGIT_TOL of max |plain row|, and the token is the plain argmax
    unless the plain top two lie within NEAR_TIE of max |logit|.  Returns
    (stream, the plain rows (choices, B, V))."""
    import torch

    T = model._runtime.spec_gamma + 1
    kw = dict(max_tokens=64, repetition_penalty=penalty)
    with Choices(drafts=teacher) as spec:
        model.transcribe_batch(clips, **kw)
    stream = spec.streams[-1]
    K = len(spec.counts)
    if len(spec.rows) != 1 + T * K:
        raise AssertionError(f"{label}: {len(spec.rows)} choices for {K} verify iterations")
    with Choices(forced=padded(stream)) as plain:
        base.transcribe_batch(clips, **kw)
    if plain.streams[-1] != stream:
        raise AssertionError(f"{label}: the forced plain run left the speculative stream")
    P = torch.stack(plain.rows)               # (choices, B, V): choice i made token i
    B = len(stream)
    lanes = torch.arange(B, device="cuda")
    counts = spec.counts + [torch.tensor([len(s) for s in stream], device="cuda")]
    per = []
    with torch.inference_mode():
        for k in range(K):
            for t in range(T):
                s_row = spec.rows[1 + k * T + t]
                i = counts[k].long() + t
                p_row = P[i.clamp(max=P.shape[0] - 1), lanes]
                top2 = p_row.topk(2, dim=-1).values
                per.append(torch.stack([
                    i.float(), (i < counts[k + 1]).float(),
                    (s_row - p_row).abs().amax(-1), p_row.abs().amax(-1),
                    top2[:, 0] - top2[:, 1], p_row.argmax(-1).float(),
                    s_row.argmax(-1).float(),
                ]))
    per = torch.stack(per).cpu().reshape(K, T, 7, B)
    rels, flips = [], []
    for k in range(K):
        for t in range(T):
            for b in range(B):
                i, emitted, diff, top, gap, p_arg, s_arg = per[k, t, :, b].tolist()
                if not emitted:
                    continue
                i = int(i)
                tok = stream[b][i]
                if tok != int(s_arg):
                    raise AssertionError(f"{label} lane {b} token {i}: not the verify row's argmax")
                rels.append(diff / top)
                if diff > LOGIT_TOL * top:
                    raise AssertionError(f"{label} lane {b} token {i}: verify row differs from "
                                         f"the plain row by {diff / top:.2e} of max |logit|")
                if tok != int(p_arg):
                    flips.append(gap / top)
                    if gap > NEAR_TIE * top:
                        raise AssertionError(
                            f"{label} lane {b} token {i}: the verify forward chose otherwise "
                            f"than the plain step at a top-two gap of {gap / top:.2e} of max |logit|")
    if len(rels) != sum(len(s) - 1 for s in stream):
        raise AssertionError(f"{label}: {len(rels)} tokens held, "
                             f"{sum(len(s) - 1 for s in stream)} emitted")
    # A token emitted at position t >= 1 of an iteration follows t accepted drafts.
    emitted = per[:, :, 1, :] > 0                        # (K, T, B)
    accepted = int(emitted[:, 1:].sum())
    full = int(emitted[:, T - 1].sum())
    rels.sort()
    same = "" if teacher is None else (
        f"; {sum(x == y for x, y in zip(stream, teacher_lists(teacher)))} of {B} lanes "
        f"equal their teacher stream in full")
    print(f"{label}: {len(rels)} tokens after the first over {K} verify iterations x {B} lanes "
          f"({sum(len(s) for s in stream) / (K * B):.3f} tokens per lane-forward, {accepted} "
          f"drafts accepted, {full} lane-iterations accepting all {T - 1}){same}; every token "
          f"held to the forced plain step's row: row diff / max |logit| median "
          f"{rels[len(rels) // 2]:.2e}, p99 {rels[int(len(rels) * 0.99)]:.2e}, max {rels[-1]:.2e} "
          f"(limit {LOGIT_TOL:g}); {len(flips)} choices apart from the plain argmax, at "
          f"top-two gaps up to {max(flips, default=0.0):.2e} of max |logit| (limit {NEAR_TIE:g})")
    return stream, P, accepted, full


def hold_loop_to_plain(label: str, base, clips, rows, stream) -> None:
    """Every token of a plain-loop ``transcribe_batch`` stream that ran
    under a kernel mode (its penalized rows ``rows``) held to the default
    modes' row on the same prefix: the default loop of ``base`` forced
    along the stream, then per token |mode row - default row| <= LOGIT_TOL
    of max |default row|, the token is the mode row's argmax, and the
    default argmax unless the default top two lie within NEAR_TIE of max
    |logit|."""
    import torch

    with Choices(forced=padded(stream)) as plain:
        base.transcribe_batch(clips, max_tokens=64)
    if plain.streams[-1] != stream:
        raise AssertionError(f"{label}: the forced default run left the mode's stream")
    n = max(len(s) for s in stream)
    if min(len(rows), len(plain.rows)) < n:
        raise AssertionError(f"{label}: {len(rows)} / {len(plain.rows)} rows for {n} tokens")
    per = []
    with torch.inference_mode():
        for m_row, p_row in zip(rows[:n], plain.rows[:n]):
            top2 = p_row.topk(2, dim=-1).values
            per.append(torch.stack([
                (m_row - p_row).abs().amax(-1), p_row.abs().amax(-1),
                top2[:, 0] - top2[:, 1], p_row.argmax(-1).float(), m_row.argmax(-1).float(),
            ]))
    per = torch.stack(per).cpu()                       # (n, 5, B)
    rels, flips = [], []
    for b, lane in enumerate(stream):
        for i, tok in enumerate(lane):
            diff, top, gap, p_arg, m_arg = per[i, :, b].tolist()
            if tok != int(m_arg):
                raise AssertionError(f"{label} lane {b} token {i}: not the mode row's argmax")
            rels.append(diff / top)
            if diff > LOGIT_TOL * top:
                raise AssertionError(f"{label} lane {b} token {i}: the mode's row differs from "
                                     f"the default row by {diff / top:.2e} of max |logit|")
            if tok != int(p_arg):
                flips.append(gap / top)
                if gap > NEAR_TIE * top:
                    raise AssertionError(
                        f"{label} lane {b} token {i}: the mode chose otherwise than the "
                        f"default step at a top-two gap of {gap / top:.2e} of max |logit|")
    rels.sort()
    print(f"{label}: {len(rels)} tokens held to the forced default step's row: row diff / max "
          f"|logit| median {rels[len(rels) // 2]:.2e}, p99 {rels[int(len(rels) * 0.99)]:.2e}, "
          f"max {rels[-1]:.2e} (limit {LOGIT_TOL:g}); {len(flips)} choices apart from the "
          f"default argmax, at top-two gaps up to {max(flips, default=0.0):.2e} of max |logit| "
          f"(limit {NEAR_TIE:g})")


def teacher_lists(teacher) -> list[list[int]]:
    stream, lens = teacher
    return [row[:n] for row, n in zip(stream.tolist(), lens.tolist())]


def plain_floor(base, clip, stream, rows8, lane: int) -> None:
    """The bf16 floor of the row check: the plain loop's rows of one lane
    at B=1 (``transcribe`` forced along the lane's stream) against its rows
    at B=8, the same prefixes computed at another batch size."""
    import torch

    with Choices(forced=padded([stream])) as one:
        base.transcribe(clip, max_tokens=64)
    P1 = torch.stack(one.rows)[: len(stream), 0]
    P8 = rows8[: len(stream), lane]
    rel = ((P1 - P8).abs().amax(-1) / P8.abs().amax(-1)).cpu()
    print(f"plain B=1 vs plain B=8 rows of lane {lane} over {len(stream)} choices: row diff / "
          f"max|logit| median {rel.median().item():.2e}, max {rel.max().item():.2e}")


def speculative_phase(card: str, base, off: dict) -> dict:
    """Greedy ``"auto"`` (the default) on the plain run's weights: the same
    runs as the plain path, through the speculative loop (K5; no K2/K3),
    held to the plain streams; then sampled, sampled-speculative,
    int8-weights speculative and long-form runs.  Returns the launches of
    the speculative path."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    vocab = base._config.text_decoder.vocab_size
    model = build_model({}, base)
    spec = slice_phase(card, model, {}, SPEC_PATH, SPEC_NEVER)
    check_one_span_write("speculative path", spec["launches"], spec["stats"])
    compare_streams("spec vs plain, transcribe_batch B=8", off["ids"][0], spec["ids"][0],
                    off["gaps"][0])
    compare_streams("spec vs plain, transcribe B=1", [off["ids"][1]], [spec["ids"][1]],
                    off["gaps"][1])
    # The whole of every stream, past any divergence: the n-gram run (drafts
    # mostly rejected), then a teacher-forced run whose drafts are the
    # n-gram run's own stream (drafts the verify forward confirms).
    # Every token of the B=8 stream, past any divergence, held to the plain
    # step on the same prefix: the default n-gram run (drafts mostly
    # rejected), the bf16 floor of that check (plain rows at B=1 against
    # B=8), and a teacher-forced run whose drafts are the stream of an
    # n-gram run without repetition penalty (more of them accepted).
    clips = smoke_clips()
    own, rows8, _, _ = hold_to_plain("spec held to plain, n-gram drafts, B=8", base, model, clips)
    plain_floor(base, clips[-1], own[-1], rows8, len(clips) - 1)
    del rows8
    own1, _, _, _ = hold_to_plain("spec held to plain, n-gram drafts, penalty 1.0, B=8", base,
                                  model, clips, penalty=1.0)
    _, _, accepted, full = hold_to_plain(
        "spec held to plain, teacher-forced drafts, penalty 1.0, B=8", base, model, clips,
        teacher=padded(own1), penalty=1.0)
    if not (accepted and full):
        raise AssertionError("teacher-forced run: no iteration accepted all its drafts")
    torch.cuda.empty_cache()
    for (label, p_st, s_st) in zip(("B=8 run 1", "B=8 run 2", "B=1"), off["stats"], spec["stats"]):
        p_ms, s_ms = p_st.stages["decode"] * 1e3, s_st.stages["decode"] * 1e3
        print(f"spec vs plain {label} [{card}]: tokens per lane-forward "
              f"{s_st.spec_tokens_per_forward:.3f} vs 1; ms per iteration "
              f"{s_ms / max(s_st.n_decode_steps, 1):.2f} vs {p_ms / max(p_st.n_decode_steps, 1):.2f}; "
              f"ms per emitted token {s_ms / s_st.n_generated_tokens:.3f} vs "
              f"{p_ms / p_st.n_generated_tokens:.3f}; decode {s_ms:.1f} vs {p_ms:.1f} ms")

    # Sampled, plain loop (spec_sampling is off by default): twice, same seed.
    sample_kw = dict(max_tokens=64, temperature=0.7, top_k=50, top_p=0.9, seed=1)
    LAUNCHES.clear()
    runs = []
    for _ in range(2):
        runs.append(_ids(model.transcribe_batch(clips, **sample_kw)))
        print_stats("sampled transcribe_batch B=8 (T=0.7, top_k=50, top_p=0.9, seed=1)",
                    card, model.last_stats)
    if runs[0] != runs[1]:
        raise AssertionError("sampled runs with one seed gave different tokens")
    check_ids("sampled", runs[0], vocab)
    check_launches("sampled B=8", dict(LAUNCHES), BF16_PATH,
                   ("kv_write_span_batch",) + STANDALONE_WRITERS)

    # Sampled and speculative (rejection-sampling verification).
    spec_sampling = build_model({"spec_sampling": True}, base)
    spec_sampling.transcribe(clips[-1], **sample_kw)         # captures the bucket
    LAUNCHES.clear()
    res = spec_sampling.transcribe(clips[-1], **sample_kw)
    print_stats("sampled speculative transcribe B=1", card, spec_sampling.last_stats)
    check_ids("sampled speculative", _ids([res]), vocab)
    check_launches("sampled speculative B=1", dict(LAUNCHES), SPEC_PATH, SPEC_NEVER)
    check_one_span_write("sampled speculative B=1", dict(LAUNCHES), [spec_sampling.last_stats])

    # Int8 weights with the bf16 cache: the verify forward's products run K9.
    w8 = build_model({"quantization": "int8"}, base)
    w8.transcribe(clips[-1], max_tokens=64)                  # captures the bucket
    LAUNCHES.clear()
    res = w8.transcribe(clips[-1], max_tokens=64)
    print_stats("int8-weights speculative transcribe B=1", card, w8.last_stats)
    check_ids("int8-weights speculative", _ids([res]), vocab)
    check_launches("int8-weights speculative B=1", dict(LAUNCHES), SPEC_W8_PATH, SPEC_NEVER)
    check_one_span_write("int8-weights speculative B=1", dict(LAUNCHES), [w8.last_stats])
    w8.close()
    del w8
    torch.cuda.empty_cache()

    # Long-form: 20 s clips, chunk_duration 8, quiet pockets at 8 s and 16 s
    # (so chunks of about 8 + 8 + 4 s); every chunk decodes up to max(256, 50 s)
    # tokens (the chunked path ignores max_tokens, as in the JAX package).
    rng = np.random.default_rng(SEED + 1)
    long_clips = []
    for f in (230.0, 410.0):
        t = np.arange(20 * 16000) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(len(t))
        for pocket in (8.0, 16.0):
            x[int(pocket * 16000) - 1600 : int(pocket * 16000) + 1600] *= 0.01
        long_clips.append(x.astype(np.float32))
    groups = []
    real = model._run_pipeline_batch

    def recorded(batch, *args):
        groups.append([len(c) / 16000 for c in batch])
        return real(batch, *args)

    model._run_pipeline_batch = recorded
    LAUNCHES.clear()
    try:
        for label, call in (
            ("transcribe, one 20 s clip", lambda: [model.transcribe(long_clips[0], chunk_duration=8.0)]),
            ("transcribe_batch, two 20 s clips", lambda: model.transcribe_batch(long_clips, chunk_duration=8.0)),
        ):
            groups.clear()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            chunks = [d for g in groups for d in g]
            budgets = [max(256, int(d * 50)) for d in chunks]
            st = model.last_stats
            print(f"long-form {label}, chunk_duration 8 [{card}]: {len(chunks)} chunks "
                  f"({', '.join(f'{d:.2f}' for d in chunks)} s) in {len(groups)} group(s) of "
                  f"{[len(g) for g in groups]}, token budgets {budgets}; {wall:.2f} s wall, "
                  f"{sum(len(r.text.split()) for r in res)} tokens, last group "
                  f"{st.n_decode_steps} verify iterations "
                  f"({st.spec_tokens_per_forward:.3f} tokens per lane-forward)")
            check_ids(f"long-form {label}", _ids(res), vocab)
            if any(abs(r.duration - 20.0) > 1e-6 for r in res):
                raise AssertionError(f"long-form {label}: wrong durations")
        if [len(g) for g in groups] != [6]:
            raise AssertionError(f"long-form batch: chunks not pooled into one group: {groups}")
    finally:
        del model._run_pipeline_batch
    check_launches("long-form", dict(LAUNCHES), SPEC_PATH, SPEC_NEVER)
    for m in (spec_sampling, model):
        m.close()
    return spec["launches"]


class EncoderCalls:
    """Records, while active, each ``encoder_forward`` call of the API: its
    mel and valid frames, and the features it returned."""

    def __enter__(self):
        from qwen3_asr_tpu_torch import api

        self.api, self.real, self.calls = api, api.encoder_forward, []

        def forward(params, cfg, mel, n_valid, tp=None):
            out = self.real(params, cfg, mel, n_valid, tp=tp)
            self.calls.append((mel, n_valid, out[0]))
            return out

        api.encoder_forward = forward
        return self

    def __exit__(self, *exc):
        self.api.encoder_forward = self.real


#: The encoder features of the "pallas" stem against the "conv" stem's, bf16
#: at 1.7B from random weights: the largest allowed max |difference| over
#: max |feature|, the repository's bound for bf16 against f32
#: (reference_check).  K11e rounds conv2/conv3 otherwise (f32 until conv +
#: bias, where cuDNN rounds the conv and the bias add), and 24 layers carry
#: that on.
STEM_TOL = 5e-2


class Switch:
    """Sets ``models/decoder.py``'s plain-path switches while active: the
    decode kernel mode (``QWEN3_ASR_DECODE_KERNEL``) and the KV writer
    (``QWEN3_ASR_KV_WRITER``)."""

    def __init__(self, mode: str = "auto", writer: str = "auto"):
        self.values = {"DECODE_KERNEL_MODE": mode, "KV_WRITER_MODE": writer}

    def __enter__(self):
        from qwen3_asr_tpu_torch.models import decoder

        self.module = decoder
        self.saved = {k: getattr(decoder, k) for k in self.values}
        for k, v in self.values.items():
            setattr(decoder, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


def iteration_ms(st) -> float:
    """The decode stage's ms over its iterations (verify iterations when
    the loop speculated)."""
    return st.stages["decode"] * 1e3 / max(st.n_decode_steps, 1)


def int8_cache_reference(card: str, base) -> dict:
    """The plain loop over the int8 cache (K4 with K3-int8 fused) on
    ``base``'s weights: its model, a graphed ``transcribe_batch`` of the
    smoke clips (after one that captures the bucket) and the same under
    :class:`Choices` (the eager loop: its tokens must equal the graphed,
    and its choice rows give the near-tie gaps).  The reference of the
    int8-cache runs under decode mode "0" and of the int8 pool servers."""
    model = build_model({"kv_cache_dtype": "int8", "speculative": "off"}, base)
    clips = smoke_clips()
    model.transcribe_batch(clips, max_tokens=64)
    ids = _ids(model.transcribe_batch(clips, max_tokens=64))
    st = model.last_stats
    with Choices() as rec:
        eager = _ids(model.transcribe_batch(clips, max_tokens=64))
    if eager != ids:
        raise AssertionError("int8 cache: the eager loop's tokens differ from the graphed")
    print_stats("transcribe_batch B=8 int8 cache (the default modes, graphed)", card, st)
    return {"model": model, "ids": ids, "gaps": top_two_gaps(rec.rows), "stats": st}


#: The kernels a decode mode "0" run must not launch: no hand-written
#: decode attention, no fused store, no K5.
MODE0_NEVER = ("decode_attention", "decode_attention_q8", "kv_write_rows_fused",
               "kv_write_rows_q8_fused", "kv_write_span_batch", "decode_attention_hbm2",
               "decode_attention_hbm3")


def mode0_runs(card: str, base, off: dict, int8_ref: dict) -> dict:
    """Decode mode "0" (the plain attention, ``decode_attention_plain``, or
    ``decode_attention_q8_plain`` over the dequantized int8 cache) on the
    plain run's model and on the int8-cache reference's, greedy
    ``transcribe_batch`` of the smoke clips: one call that captures the
    mode's own graph, then one counted that replays it (no capture), K2/K4
    never launched, the standalone K3 (K3-int8) twice a replay (K and V,
    all layers a launch), ms per decode iteration beside the default
    graphed loop's, replays and host syncs; then the eager loop under
    :class:`Choices` (its tokens equal the graphed), the stream held to the
    default stream by the near-tie rule and every token to the default
    modes' row on the same prefix.  Returns the launches of K3-int8 (its
    one path)."""
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    clips = smoke_clips()
    vocab = base._config.text_decoder.vocab_size
    launches = {}
    for label, model, ref_ids, ref_gaps, ref_st, writer in (
            ("decode mode 0, bf16 cache", base, off["ids"][0], off["gaps"][0], off["stats"][1],
             "kv_write_rows"),
            ("decode mode 0, int8 cache", int8_ref["model"], int8_ref["ids"], int8_ref["gaps"],
             int8_ref["stats"], "kv_write_rows_q8")):
        t0 = time.perf_counter()
        graphs = model._generator.graphs
        with Switch(mode="0"):
            captures = graphs.captures
            first = _ids(model.transcribe_batch(clips, max_tokens=64))
            if graphs.captures != captures + 1:
                raise AssertionError(f"{label}: the mode's bucket was not captured")
            with Watch() as watch:
                LAUNCHES.clear()
                ids = _ids(model.transcribe_batch(clips, max_tokens=64))
                got = dict(LAUNCHES)
                if bool(watch.nan_seen):
                    raise AssertionError(f"{label}: NaN logits")
            st = model.last_stats
            if graphs.captures != captures + 1 or ids != first:
                raise AssertionError(f"{label}: a second capture, or the replayed run's "
                                     "tokens differ from the capturing run's")
            with Choices() as rec:
                eager = _ids(model.transcribe_batch(clips, max_tokens=64))
        if eager != ids:
            raise AssertionError(f"{label}: the eager loop's tokens differ from the graphed")
        check_ids(label, ids, vocab)
        other = "kv_write_rows" if writer == "kv_write_rows_q8" else "kv_write_rows_q8"
        check_launches(label, got, ("flash_attention_causal", writer), MODE0_NEVER + (other,))
        if got[writer] != 2 * st.n_decode_replays:
            raise AssertionError(f"{label}: {writer} launched {got[writer]} times, want 2 x "
                                 f"{st.n_decode_replays} replays")
        print_stats(f"transcribe_batch B=8 {label} (graphed)", card, st)
        print(f"{label} [{card}]: graphed, one capture of the mode's bucket, "
              f"{st.n_decode_replays} replays and {st.n_host_syncs} host syncs for "
              f"{st.n_decode_steps} live steps; ms per decode iteration {iteration_ms(st):.3f} "
              f"against the default modes' graphed {iteration_ms(ref_st):.3f} "
              f"({iteration_ms(st) / iteration_ms(ref_st):.2f}x)")
        compare_streams(f"{label} vs the default modes, transcribe_batch B=8", ref_ids, ids,
                        ref_gaps)
        hold_loop_to_plain(f"{label} held to the default modes, B=8", model, clips, rec.rows, ids)
        del rec
        launches.setdefault(writer, got[writer])
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
    return launches


def int8_modes_runs(card: str, int8_ref: dict) -> None:
    """Decode modes "3" and "4" on the int8 cache (the int8-cache
    reference's model), greedy ``transcribe_batch`` of the smoke clips: the
    int8 cache keeps K4 with its fused K3-int8 store (the JAX package
    dequantizes for its XLA attention there; the port runs the kernel the
    caller asked for), graphed (the mode's own bucket, captured by the run),
    K4 and its store a layer a replay (the capture's warm-up step
    included), neither K11a/K11b nor a standalone writer nor the plain
    attention; the stream held to the int8 reference's by the near-tie
    rule."""
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    model, clips = int8_ref["model"], smoke_clips()
    n_layers = model._config.text_decoder.num_hidden_layers
    for mode in ("3", "4"):
        t0 = time.perf_counter()
        label = f"decode mode {mode}, int8 cache"
        graphs = model._generator.graphs
        captures = graphs.captures
        with Switch(mode=mode), Watch() as watch:
            LAUNCHES.clear()
            ids = _ids(model.transcribe_batch(clips, max_tokens=64))
            got = dict(LAUNCHES)
            if bool(watch.nan_seen):
                raise AssertionError(f"{label}: NaN logits")
        st = model.last_stats
        runs = st.n_decode_replays + graphs.captures - captures
        check_ids(label, ids, model._config.text_decoder.vocab_size)
        check_launches(label, got, ("flash_attention_causal", "decode_attention_q8",
                                    "kv_write_rows_q8_fused"),
                       ("decode_attention", "decode_attention_hbm2", "decode_attention_hbm3",
                        "kv_write_rows_fused") + STANDALONE_WRITERS)
        if graphs.captures != captures + 1:
            raise AssertionError(f"{label}: {graphs.captures - captures} captures, want 1")
        for name in ("decode_attention_q8", "kv_write_rows_q8_fused"):
            if got[name] != n_layers * runs:
                raise AssertionError(f"{label}: {name} launched {got[name]} times, want "
                                     f"{n_layers} x ({st.n_decode_replays} replays + 1 "
                                     "capture's warm-up step)")
        print_stats(f"transcribe_batch B=8 {label} (graphed)", card, st)
        compare_streams(f"{label} vs the default modes, transcribe_batch B=8", int8_ref["ids"],
                        ids, int8_ref["gaps"])
        print(f"{label}: {time.perf_counter() - t0:.1f} s")


def modes_phase(card: str, base, off: dict, int8_ref: dict) -> dict:
    """The JAX package's kernel modes on the plain run's model (``"off"``):
    decode mode "0" on the bf16 and the int8 cache (:func:`mode0_runs`),
    modes "3"/"4" on the int8 cache (:func:`int8_modes_runs`: K4 kept);
    ``transcribe_batch`` of the smoke clips under decode modes "3" (K11a)
    and "4" (K11b), graphed -- one capture of the mode's bucket, K2 never
    launched, the mode's kernel 28 x (replays + the capture's warm-up
    step), no-op replays included, and the standalone K3 twice as many --
    under "3" then the same call's eager loop under :class:`Choices` (its
    ids equal to the graphed run's), under "4" the stream bit-identical to
    mode "3"'s (K11b is K11a bit for bit, phase 3), and under the "pallas"
    stem (K11e twice per encoder call), each stream held to the plain
    ("auto", "conv") stream by the near-tie rule and each of its tokens to
    the default modes' row on the same prefix; then the
    encoder features of every stem mode held to the "conv" stem's.  Returns
    the launches of K11a, K11b and K11e, each from its own run, of the
    standalone K3 from mode "0"'s bf16 run and of K3-int8 from its int8
    run (the paths that launch them)."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dec_mod
    from qwen3_asr_tpu_torch.models import encoder as enc_mod
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    clips = smoke_clips()
    vocab = base._config.text_decoder.vocab_size
    n_layers = base._config.text_decoder.num_hidden_layers
    launches = mode0_runs(card, base, off, int8_ref)
    int8_modes_runs(card, int8_ref)
    runs = (("decode mode 3", dec_mod, "DECODE_KERNEL_MODE", "3", "decode_attention_hbm2"),
            ("decode mode 4", dec_mod, "DECODE_KERNEL_MODE", "4", "decode_attention_hbm3"),
            ("stem pallas", enc_mod, "CONV_STEM_MODE", "pallas", "conv_s2_gelu"))
    pallas_calls = None
    graphs = base._generator.graphs
    mode3_ids = None
    for label, module, attr, mode, kernel in runs:
        graphed = kernel != "conv_s2_gelu"
        saved = getattr(module, attr)
        setattr(module, attr, mode)
        rec = None
        try:
            if graphed:
                # The mode's own bucket, captured by this call; under "3"
                # then the same call's eager loop under Choices for its rows.
                captures = graphs.captures
                with Watch() as watch:
                    LAUNCHES.clear()
                    ids = _ids(base.transcribe_batch(clips, max_tokens=64))
                    got = dict(LAUNCHES)
                st = base.last_stats
                new = graphs.captures - captures
                if mode3_ids is None:
                    mode3_ids = ids
                    with Choices() as rec:
                        eager = _ids(base.transcribe_batch(clips, max_tokens=64))
                    if eager != ids:
                        raise AssertionError(f"{label}: the eager loop's ids differ from the "
                                             "graphed loop's")
                elif ids != mode3_ids:
                    # K11b is K11a bit for bit (phase 3): mode "4" decodes
                    # mode "3"'s stream, held below through it.
                    raise AssertionError(f"{label}: the stream differs from decode mode 3's")
            else:
                with Watch() as watch, EncoderCalls() as enc, Choices() as rec:
                    LAUNCHES.clear()
                    ids = _ids(base.transcribe_batch(clips, max_tokens=64))
                    got = dict(LAUNCHES)
                st = base.last_stats
            if bool(watch.nan_seen):
                raise AssertionError(f"{label}: NaN logits")
        finally:
            setattr(module, attr, saved)
        check_ids(label, ids, vocab)
        if kernel == "conv_s2_gelu":
            want = 2 * len(enc.calls)
            pallas_calls = enc.calls
            check_launches(label, got, ("flash_attention_causal", "decode_attention",
                                        "kv_write_rows_fused", kernel), STANDALONE_WRITERS)
        else:
            # The stream kernels take no write target: the standalone K3
            # writes after the layer loop.  Graphed: every replay and the
            # capture's warm-up step launch them.
            if new != 1:
                raise AssertionError(f"{label}: {new} captures, want 1 (the mode's bucket)")
            n_runs = st.n_decode_replays + new
            want = n_layers * n_runs
            check_launches(label, got, ("flash_attention_causal", "kv_write_rows", kernel),
                           ("decode_attention", "kv_write_rows_fused", "kv_write_span_batch"))
            if got["kv_write_rows"] != 2 * n_runs:
                raise AssertionError(f"{label}: kv_write_rows launched {got['kv_write_rows']} "
                                     f"times, want 2 x ({st.n_decode_replays} replays + 1 "
                                     "capture's warm-up step)")
            if st.n_host_syncs >= st.n_decode_steps:
                raise AssertionError(f"{label}: {st.n_host_syncs} looks at done for "
                                     f"{st.n_decode_steps} live steps: not graphed")
            launches.setdefault("kv_write_rows", got["kv_write_rows"])
        if got[kernel] != want:
            raise AssertionError(f"{label}: {kernel} launched {got[kernel]} times, want {want}")
        print_stats(f"transcribe_batch B=8 {label}{' (graphed)' if graphed else ''}", card, st)
        launches[kernel] = got[kernel]
        if rec is None:
            print(f"{label}: the stream bit-identical to decode mode 3's (K11b is K11a bit "
                  "for bit), which is held to the default modes")
            continue
        compare_streams(f"{label} vs auto, transcribe_batch B=8", off["ids"][0], ids,
                        off["gaps"][0])
        hold_loop_to_plain(f"{label} held to the default modes, B=8", base, clips, rec.rows, ids)
        del rec

    # Encoder features of each stem mode against the "conv" stem on the
    # smoke batch's mel; each stem's own output against the float32 stem
    # (cuDNN's TF32 off); the encoder's device time under "conv" and
    # "pallas" in turns.
    mel, n_valid, pallas_feats = pallas_calls[0]
    params, cfg = base._encoder_params, base._config.audio_encoder
    B, n_mels, T = mel.shape
    n_chunks = T // cfg.chunk_frames
    chunks = mel.reshape(B, n_mels, n_chunks, cfg.chunk_frames).permute(0, 2, 1, 3)
    chunks = chunks.reshape(B * n_chunks, 1, n_mels, cfg.chunk_frames)
    stem_params = {k: v for k, v in params.items() if k != "layers"}
    stem32 = {k: v.float() for k, v in stem_params.items()}

    def in_mode(mode, fn):
        saved, enc_mod.CONV_STEM_MODE = enc_mod.CONV_STEM_MODE, mode
        try:
            return fn()
        finally:
            enc_mod.CONV_STEM_MODE = saved

    tf32, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, False
    try:
        with torch.inference_mode():
            ref, _ = encoder_forward(params, cfg, mel, n_valid)
            top = ref.float().abs().max().item()
            stem_ref = in_mode("conv", lambda: enc_mod.conv_stem(stem32, chunks.float()))
            stem_top = stem_ref.abs().max().item()
            for mode in ("conv", "pallas"):
                stem = in_mode(mode, lambda: enc_mod.conv_stem(stem_params, chunks.bfloat16()))
                diff = (stem.float() - stem_ref).abs()
                print(f"stem {mode!r} output vs the f32 stem [{card}]: max abs diff / max "
                      f"|output| {diff.max().item() / stem_top:.3e}, mean abs diff / mean "
                      f"|output| {diff.mean().item() / stem_ref.abs().mean().item():.3e}")
            rel = (pallas_feats.float() - ref.float()).abs().max().item() / top
            print(f"encoder features, stem 'pallas' vs 'conv' [{card}]: max abs diff / "
                  f"max |feature| = {rel:.3e} (limit {STEM_TOL:g}; {tuple(pallas_feats.shape)})")
            if not (torch.isfinite(pallas_feats).all() and rel < STEM_TOL):
                raise AssertionError(f"stem 'pallas': features differ by {rel:.3e} of max |feature|")
            # The JAX package's TPU layout modes run the "conv" stem here.
            for mode in ("taps", "merged", "c512", "merged512"):
                feats = in_mode(mode, lambda: encoder_forward(params, cfg, mel, n_valid)[0])
                if not torch.equal(feats, ref):
                    raise AssertionError(f"stem {mode!r}: features differ from the 'conv' stem's")
            print("encoder features, stems 'taps', 'merged', 'c512', 'merged512': "
                  "equal to the 'conv' stem's")
            turns = []
            for mode in ("conv", "pallas", "pallas", "conv"):
                turns.append(in_mode(mode, lambda: cuda_ms(
                    lambda: encoder_forward(params, cfg, mel, n_valid), iters=5, warmup=1)))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"encoder_forward of the smoke batch ({B} x {T} frames), CUDA-event ms in turns "
          f"conv / pallas / pallas / conv [{card}]: "
          f"{' / '.join(f'{t:.3f}' for t in turns)}")
    return launches


def server_run(card: str, model, label: str, paged: bool, path, never, plain) -> dict:
    """``ContinuousTranscriptionServer(n_slots=8, chunk_steps=16)`` on the
    smoke clips in two waves (the second submitted once the first chunk
    ran), greedy, 64-token budgets, the engine's chunks graphed (each
    bucket captured in its first chunk: no warm-up); launch counters set to
    0 just before the first submit and read after the last result.  Each
    stream is held to ``plain`` (ids, gaps) of the same clips by the
    near-tie rule."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.runtime import engine as engine_mod
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    clips = smoke_clips()
    vocab = model._config.text_decoder.vocab_size
    srv = ContinuousTranscriptionServer(model, n_slots=8, max_duration=30.0,
                                        max_new_tokens=512, chunk_steps=16, paged=paged)
    engine = srv._engine
    step_s = []
    real_step = engine.step

    def timed(k_steps=None):            # a chunk ends in its status fetch
        t0 = time.perf_counter()
        real_step(k_steps)
        step_s.append(time.perf_counter() - t0)

    engine.step = timed
    keys = engine._keys["q"] if isinstance(engine._keys, dict) else engine._keys
    cache_gib = 2 * sum(t.numel() * t.element_size() for t in (
        engine._keys.values() if isinstance(engine._keys, dict) else [engine._keys])) / 2**30
    shape = f"{engine.n_pages} pages of {engine.page_size} rows" if paged else \
        f"{engine.n_slots} slots x {engine.cache_len} rows"
    with Watch(engine_mod) as watch:
        LAUNCHES.clear()
        t0 = time.perf_counter()
        with srv:
            futs = [srv.submit(c, max_tokens=64) for c in clips[:4]]
            deadline = time.time() + 300
            while engine.stats.chunks < 1 and time.time() < deadline:
                time.sleep(0.002)
            futs += [srv.submit(c, max_tokens=64) for c in clips[4:]]
            results = [f.result(timeout=600) for f in futs]
            captures = engine.graphs.captures if engine.graphs else 0
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        if bool(watch.nan_seen):
            raise AssertionError(f"server {label}: NaN logits")
    ids = _ids(results)
    check_ids(f"server {label}", ids, vocab)
    check_launches(f"server {label}", launches, path, never)
    st = engine.stats
    if st.mid_decode_admissions < 1:
        raise AssertionError(f"server {label}: no mid-decode admission")
    if srv.stats.failures or any(getattr(f, "ttft_s", None) is None for f in futs):
        raise AssertionError(f"server {label}: a request failed or has no ttft_s")
    spec = (f", {st.spec_tokens_per_forward:.3f} spec tokens per lane-forward"
            if st.spec_chunks else "")
    if captures < 1:
        raise AssertionError(f"server {label}: the engine captured no chunk graph")
    print(f"server {label} [{card}]: {keys.dtype} cache of {shape} ({cache_gib:.2f} GiB "
          f"K+V), {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; {wall:.2f} s "
          f"wall for 8 requests, {st.chunks} chunks, {st.iterations} iterations, "
          f"{sum(step_s) * 1e3 / max(st.iterations, 1):.2f} ms per chunk iteration (graphed: "
          f"{captures} captures, {st.replays} replays, {st.looks} looks); mean "
          f"occupancy {st.mean_occupancy:.2f}, {st.mid_decode_admissions} mid-decode "
          f"admissions{spec}; ttft_s {[round(f.ttft_s, 3) for f in futs]}")
    compare_streams(f"server {label} vs plain transcribe_batch B=8", plain[0], ids, plain[1])
    return launches


def server_phase(card: str, base, off: dict, int8_ref: dict) -> dict:
    """The continuous server at 1.7B on the plain run's weights: paged
    (K6), paged speculative (K7), the int8 pool plain and speculative (q8
    K6/K7), each with K8 fused, and the flat engine (K2, per-lane K3
    fused); the int8 pools' streams held to the plain loop over the int8
    cache (``int8_ref``).
    Returns the launches of the paged kernels, each from its own path."""
    import torch

    launches = {}
    plain = (off["ids"][0], off["gaps"][0])
    int8_plain = (int8_ref["ids"], int8_ref["gaps"])
    for label, (runtime, paged, path, never) in SERVER_PATHS.items():
        model = build_model(runtime, base)
        run = server_run(card, model, label, paged, path, never,
                         int8_plain if runtime.get("kv_cache_dtype") == "int8" else plain)
        for name in path:
            if name in PAGED:
                launches.setdefault(name, run[name])
        del model
        torch.cuda.empty_cache()
    return launches


#: The graphed engine's arms (:func:`engine_graphs_phase`): (label, runtime,
#: paged, sampled, oversubscribed pool, the kernels the chunks launch).
ENGINE_ARMS = (
    ("paged bf16 plain, oversubscribed pool", {"spec_engine": "off"}, True, False, True,
     ("decode_attention_paged", "kv_write_rows_paged_fused")),
    ("paged bf16 speculative", {"spec_engine": "on"}, True, False, False,
     ("decode_attention_paged_verify", "kv_write_rows_paged_fused")),
    ("paged int8 plain", {"spec_engine": "off", "kv_cache_dtype": "int8"}, True, False, False,
     ("decode_attention_paged_q8", "kv_write_rows_paged_q8_fused")),
    ("flat bf16 plain", {"spec_engine": "off"}, False, False, False,
     ("decode_attention", "kv_write_rows_fused")),
    ("flat bf16 speculative", {"spec_engine": "on"}, False, False, False,
     ("kv_write_span_batch",)),
    ("paged bf16 sampled mixed", {"spec_engine": "off"}, True, True, False,
     ("decode_attention_paged", "kv_write_rows_paged_fused")),
)
#: Token budget and chunk iterations of the engine phase's requests.
ENGINE_TOKENS = 32
ENGINE_CHUNK = 16
#: The sampled arm's sampling by clip index (the rest greedy): two seeds,
#: unequal ``top_k``, so one chunk mixes greedy lanes and two pools' worth
#: of ``top_k`` (the chunk takes the largest).
ENGINE_SAMPLED = {1: dict(temperature=0.8, top_k=50, top_p=0.9, seed=1),
                  4: dict(temperature=1.0, top_k=300, top_p=0.95, seed=2)}


def engine_requests(clips, prompts, first: int, sampled: bool) -> list:
    """The engine phase's SlotRequests for ``clips`` (clip index ``first``
    on), ``ENGINE_TOKENS``-token budgets, greedy unless ``sampled`` names
    their index in :data:`ENGINE_SAMPLED`."""
    from qwen3_asr_tpu_torch.runtime.engine import SlotRequest

    return [SlotRequest(samples=c, prompt=p, max_new=ENGINE_TOKENS, meta=first + j,
                        **(ENGINE_SAMPLED.get(first + j, {}) if sampled else {}))
            for j, (c, p) in enumerate(zip(clips, prompts))]


def engine_drive(engine, waves) -> dict:
    """Admit ``waves[0]``, one chunk, then ``waves[1]`` (if any) mid-decode;
    chunks until every request retired.  A wave is (kv, first logits, requests);
    requests the page pool refuses wait, in order, one at a time, for the
    next retirement.  Per chunk: its bucket, live iterations, replays,
    launches, captures, wall.  Launches are counted only inside ``step``."""
    import collections

    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    pending = []

    def queue(kv, lg, reqs):
        pending.extend(((kv[0][:, j : j + 1], kv[1][:, j : j + 1]), lg[j : j + 1], r)
                       for j, r in enumerate(reqs))

    def admit():
        while pending and engine.free_slots():
            kv, lg, req = pending[0]
            if engine.admit(kv, lg, engine.free_slots(), [req]):
                return
            pending.pop(0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    queue(*waves[0])
    admit()
    chunks, results, paused = [], {}, 0
    total = sum(len(w[2]) for w in waves)
    for i in range(200):
        if i == 1 and len(waves) > 1:
            queue(*waves[1])
            admit()
        st = engine.stats
        before = (collections.Counter(LAUNCHES), st.iterations, st.replays,
                  engine.graphs.captures if engine.graphs else 0)
        t0 = time.perf_counter()
        engine.step()
        wall = time.perf_counter() - t0
        if engine.paged:
            paused += int(engine._paused.any())
        chunks.append(dict(
            bucket=engine.last_bucket, iterations=st.iterations - before[1],
            replays=st.replays - before[2], launches=collections.Counter(LAUNCHES) - before[0],
            captured=(engine.graphs.captures if engine.graphs else 0) - before[3], wall=wall))
        for req, toks in engine.retire():
            results[req.meta] = [int(t) for t in toks]
        admit()
        if len(results) == total and not pending:
            break
    return dict(results=results, chunks=chunks, paused=paused,
                peak=torch.cuda.max_memory_allocated() / 2**30)


def hold_engine_pair(label: str, card: str, graphed: dict, eager: dict, eng_g, eng_e,
                     path=(), vocab: int = 0, counters: bool = True) -> dict:
    """The graphed engine against its ``eager=True`` run from the same
    admissions: tokens bit-identical, with ``counters`` the counters equal
    (replays and looks aside; an engine run a second time counts its
    freed slots' stale device counts into ``steps``, as the JAX engine
    does), each chunk's live iterations equal, every eager chunk's
    launches = its live iterations x the bucket's captured launches and
    every graphed chunk's = its replays x them (so the graphed run's are
    the eager count plus the no-op replays'); prints ms per chunk
    iteration both ways, captures, replays, looks, peak memory.  Returns
    the graphed chunks' launches."""
    import collections
    import dataclasses

    if graphed["results"] != eager["results"] or len(graphed["results"]) != 8:
        raise AssertionError(f"{label}: graphed tokens differ from the eager engine's")
    ids = [graphed["results"][i] for i in sorted(graphed["results"])]
    if vocab:
        check_ids(label, ids, vocab)
    sg, se = dataclasses.asdict(eng_g.stats), dataclasses.asdict(eng_e.stats)
    aside = ("replays", "looks") if counters else tuple(sg)
    if {k: v for k, v in sg.items() if k not in aside} != \
            {k: v for k, v in se.items() if k not in aside}:
        raise AssertionError(f"{label}: engine counters {sg} against eager {se}")
    if [c["iterations"] for c in graphed["chunks"]] != [c["iterations"] for c in eager["chunks"]]:
        raise AssertionError(f"{label}: live iterations per chunk differ")
    total = collections.Counter()
    for cg, ce in zip(graphed["chunks"], eager["chunks"]):
        entry = eng_g.graphs.get(cg["bucket"]) if cg["iterations"] else None
        per = entry[1].launches if entry else collections.Counter()
        want_g = collections.Counter({k: v * cg["replays"] for k, v in per.items()})
        want_e = collections.Counter({k: v * ce["iterations"] for k, v in per.items()})
        if +cg["launches"] != +want_g or +ce["launches"] != +want_e:
            raise AssertionError(f"{label}: chunk launches graphed {dict(cg['launches'])}, "
                                 f"eager {dict(ce['launches'])}, a replay {dict(per)}")
        total += cg["launches"]
    check_launches(f"{label} graphed chunks", dict(total), path)
    its = sum(c["iterations"] for c in graphed["chunks"])
    g_ms = sum(c["wall"] for c in graphed["chunks"]) * 1e3 / max(its, 1)
    warm = [c for c in graphed["chunks"] if not c["captured"]]
    warm_ms = sum(c["wall"] for c in warm) * 1e3 / max(sum(c["iterations"] for c in warm), 1)
    e_ms = sum(c["wall"] for c in eager["chunks"]) * 1e3 / max(its, 1)
    ref_ms = warm_ms if warm else g_ms
    spec = (f", {eng_g.stats.spec_tokens_per_forward:.3f} tokens per lane-forward"
            if eng_g.stats.spec_chunks else "")
    same = "counters equal" if counters else "live iterations a chunk equal"
    print(f"engine {label} [{card}]: graphed tokens bit-identical to eager=True, {same}; "
          f"{eng_g.stats.chunks} chunks, {its} live iterations, {eng_g.stats.replays} "
          f"replays ({eng_g.stats.replays - its} no-op), {eng_g.stats.looks} looks graphed "
          f"against {eng_e.stats.looks} eager; ms per chunk iteration graphed {g_ms:.3f} "
          f"({warm_ms:.3f} over the {len(warm)} chunks that captured nothing), eager "
          f"{e_ms:.3f} = {e_ms / ref_ms:.2f}x; {eng_g.graphs.captures} captures "
          f"(the last {eng_g.graphs.last_capture_ms:.1f} ms); peak memory graphed "
          f"{graphed['peak']:.2f} GiB, eager {eager['peak']:.2f} GiB; "
          f"{graphed['paused']} chunks with a paused lane{spec}; launches {dict(total)}")
    return dict(total)


def engine_graphs_phase(card: str, base) -> dict:
    """The continuous engine's chunks as CUDA graphs, driven through
    ``DecodeEngine`` directly at 1.7B on ``base``'s weights (seed 0), arm
    by arm (:data:`ENGINE_ARMS`): the smoke clips prefilled once in two
    waves of four, the graphed engine and then an ``eager=True`` engine
    admitting them in the same order (:func:`engine_drive`,
    ``ENGINE_TOKENS``-token budgets, ``chunk_steps=ENGINE_CHUNK``), held by
    :func:`hold_engine_pair`, then the graphed engine, emptied, once more
    (every bucket replayed, no capture), held the same way.  The
    oversubscribed arm's pool holds every
    prompt and three decode pages, so lanes pause and resume.  Returns
    each arm's graphed launches."""
    import torch

    from qwen3_asr_tpu_torch.runtime import engine as engine_mod

    clips = smoke_clips()
    vocab = base._config.text_decoder.vocab_size
    out = {}
    for label, runtime, paged, sampled, tight, path in ENGINE_ARMS:
        t0 = time.perf_counter()
        model = build_model(runtime, base)
        waves = []
        for first in (0, 4):
            kv, lg, prompts = model.prefill_group(clips[first : first + 4], ["English"] * 4)
            waves.append((kv, lg, engine_requests(clips[first : first + 4], prompts, first,
                                                  sampled)))
        pool_gb = None
        if tight:           # every prompt's pages, three decode pages, the trash page
            ps = 256        # make_engine's page size
            pages = sum(-(-len(r.prompt) // ps) for w in waves for r in w[2]) + 3 + 1
            tc = base._config.text_decoder
            page_bytes = tc.num_hidden_layers * tc.num_key_value_heads * ps * tc.head_dim * 4
            pool_gb = (pages + 0.5) * page_bytes / 2**30
        runs, engines = {}, {}
        with Watch(engine_mod) as watch:
            for eager in (False, True):
                eng = model.make_engine(n_slots=8, max_duration=30.0,
                                        max_new_tokens=ENGINE_TOKENS, chunk_steps=ENGINE_CHUNK,
                                        paged=paged, kv_pool_gb=pool_gb, eager=eager)
                runs[eager] = engine_drive(eng, waves)
                engines[eager] = eng
            # The graphed engine again, emptied: every bucket replays.
            eng = engines[False]
            captures, first_stats = eng.graphs.captures, eng.stats
            eng.stats = engine_mod.EngineStats()
            again = engine_drive(eng, waves)
            if bool(watch.nan_seen):
                raise AssertionError(f"engine {label}: NaN logits")
        if tight and not (runs[False]["paused"] and runs[True]["paused"]):
            raise AssertionError(f"engine {label}: no lane paused for pages")
        if eng.graphs.captures != captures:
            raise AssertionError(f"engine {label}: the second graphed run captured again")
        hold_engine_pair(f"{label}, replaying", card, again, runs[True], eng, engines[True],
                         path, vocab, counters=False)
        eng.stats = first_stats
        out[label] = hold_engine_pair(label, card, runs[False], runs[True], engines[False],
                                      engines[True], path, vocab)
        for eng in engines.values():
            eng.close()
        model.close()
        del model, engines, waves
        torch.cuda.empty_cache()
        print(f"engine {label}: {time.perf_counter() - t0:.1f} s for the arm")
    return out


#: The fused stores, which no run under the "xla" writer may launch.
FUSED_STORES = ("kv_write_rows_fused", "kv_write_rows_q8_fused", "kv_write_rows_paged_fused",
                "kv_write_rows_paged_q8_fused")
#: The continuous server's arms under the "xla" writer: (label, runtime,
#: the kernel it must launch).
XLA_SERVER_RUNS = (("paged, spec_engine off", {"spec_engine": "off"}, "decode_attention_paged"),
                   ("paged, spec_engine auto", {}, "decode_attention_paged_verify"))


def xla_writer_phase(card: str, base, off: dict) -> None:
    """``QWEN3_ASR_KV_WRITER=xla`` at 1.7B on the plain run's weights: every
    row lands through the plain writers (the JAX package's XLA writers), so
    no fused store, no standalone writer and no K5 runs.  The plain writers
    never wait for the device, so the loops capture them: the plain loop
    (K2 without its store) and the speculative loop (the verify split) on
    the smoke batch each capture one graph for the writer's bucket and
    replay it, then the eager loop under :class:`Choices` must give the
    same tokens; each stream held to the plain stream by the near-tie rule,
    the plain loop's every token also to the default step's row on the same
    prefix; the continuous server, paged under ``spec_engine`` off (K6) and
    auto (K7), held as :func:`server_run` holds it.  Then the end-to-end
    line: ms per decode iteration of the graphed plain loop under the
    default modes, decode mode "0" and the "xla" writer, in turns."""
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    clips = smoke_clips()
    vocab = base._config.text_decoder.vocab_size
    n_layers = base._config.text_decoder.num_hidden_layers
    never = FUSED_STORES + STANDALONE_WRITERS + ("kv_write_span_batch",)
    spec_model = build_model({}, base)
    for label, model, path in (("xla writer, plain loop", base,
                                ("flash_attention_causal", "decode_attention")),
                               ("xla writer, speculative loop", spec_model,
                                ("flash_attention_causal",))):
        t0 = time.perf_counter()
        with Switch(writer="xla"):
            model.transcribe_batch(clips, max_tokens=64)           # captures the bucket
            graphs = model._generator.graphs
            captures = graphs.captures
            with Watch() as watch:
                LAUNCHES.clear()
                ids = _ids(model.transcribe_batch(clips, max_tokens=64))
                got = dict(LAUNCHES)
                if bool(watch.nan_seen):
                    raise AssertionError(f"{label}: NaN logits")
            st = model.last_stats
            if graphs.captures != captures or not st.n_decode_replays:
                raise AssertionError(f"{label}: the writer's bucket was not replayed from "
                                     "its one capture")
            with Choices() as rec:
                eager = _ids(model.transcribe_batch(clips, max_tokens=64))
            if eager != ids:
                raise AssertionError(f"{label}: the eager loop's tokens differ from the graphed")
        check_ids(label, ids, vocab)
        check_launches(label, got, path, never + (("decode_attention",) if model is spec_model
                                                  else ()))
        if "decode_attention" in path and got["decode_attention"] != n_layers * st.n_decode_replays:
            raise AssertionError(f"{label}: K2 launched {got['decode_attention']} times, want "
                                 f"{n_layers} x {st.n_decode_replays} replays")
        print_stats(f"transcribe_batch B=8 {label} (graphed)", card, st)
        print(f"{label} [{card}]: graphed, one capture of the writer's bucket, "
              f"{st.n_decode_replays} replays and {st.n_host_syncs} host syncs for "
              f"{st.n_decode_steps} live steps")
        compare_streams(f"{label} vs plain transcribe_batch B=8", off["ids"][0], ids,
                        off["gaps"][0])
        if "decode_attention" in path:
            hold_loop_to_plain(f"{label} held to the default modes, B=8", base, clips, rec.rows,
                               ids)
        del rec
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
    spec_model.close()
    del spec_model

    for label, runtime, kernel in XLA_SERVER_RUNS:
        t0 = time.perf_counter()
        model = build_model(runtime, base)
        with Switch(writer="xla"):
            server_run(card, model, f"{label}, xla writer", True,
                       ("flash_attention_causal", kernel), CONTIGUOUS + never,
                       (off["ids"][0], off["gaps"][0]))
        model.close()
        del model
        print(f"server {label}, xla writer: {time.perf_counter() - t0:.1f} s")

    # The end-to-end line: the graphed plain loop of the same model under
    # the default modes, "0" and "xla", in turns, after one run of each
    # (which captures its bucket only if the graphs were dropped since).
    t0 = time.perf_counter()
    arms = {"default": Switch(), "0": Switch(mode="0"), "xla": Switch(writer="xla")}
    ms = {name: [] for name in arms}
    for name, arm in arms.items():
        with arm:
            base.transcribe_batch(clips, max_tokens=64)
    graphs = base._generator.graphs
    captures = graphs.captures
    for name in ("default", "0", "xla", "xla", "0", "default"):
        with arms[name]:
            base.transcribe_batch(clips, max_tokens=64)
        ms[name].append(iteration_ms(base.last_stats))
    if graphs.captures != captures:
        raise AssertionError("end to end: an arm captured its bucket again")

    def fmt(xs):
        return " / ".join(f"{x:.3f}" for x in xs)

    best = {name: min(xs) for name, xs in ms.items()}
    print(f"end to end, graphed plain loop B=8, ms per decode iteration in turns [{card}]: "
          f"default (K2 with K3 fused) {fmt(ms['default'])}, mode 0 (plain attention, "
          f"standalone K3) {fmt(ms['0'])}, xla writer (K2 without its store, plain writer) "
          f"{fmt(ms['xla'])}; the hand-written attention and fused store buy "
          f"{best['0'] / best['default']:.2f}x, the fused store alone "
          f"{best['xla'] / best['default']:.2f}x ({time.perf_counter() - t0:.1f} s)")


#: The graphed loops' arms: (label, runtime, batch, sampling, decode kernel
#: mode).  Each runs the eager and the graphed loop from one prefill.
SAMPLING = dict(temperature=0.7, top_k=50, top_p=0.9, seed=1)
GRAPH_ARMS = (
    ("plain B=1", {"speculative": "off"}, 1, {}, "auto"),
    ("plain B=8", {"speculative": "off"}, 8, {}, "auto"),
    ("plain B=96 W8A8", {"quantization": "int8", "act_quant": "int8"}, 96, {}, "auto"),
    ("plain int8 cache B=8", {"speculative": "off", "kv_cache_dtype": "int8"}, 8, {}, "auto"),
    ("sampled B=8", {}, 8, SAMPLING, "auto"),
    ("speculative B=1", {}, 1, {}, "auto"),
    ("speculative B=8", {}, 8, {}, "auto"),
    ("sampled speculative B=1", {"spec_sampling": True}, 1, SAMPLING, "auto"),
    ("int8-weights speculative B=1", {"quantization": "int8"}, 1, {}, "auto"),
    ("decode mode 3 B=8", {"speculative": "off"}, 8, {}, "3"),
    ("decode mode 4 B=8", {"speculative": "off"}, 8, {}, "4"),
)
#: Eager and graphed decodes per arm, taken in turns (E G G E), each with
#: every lane's budget cut to GRAPH_TOKENS (the arm's graph, captured by a
#: 64-token call, unchanged).
GRAPH_TURNS = "EGGE"
GRAPH_TOKENS = 32


def profiled_busy(call) -> tuple[int, float, float]:
    """(device kernels, their summed ms, the call's host wall ms) of one
    ``call`` under ``torch.profiler`` (device activity only): kernel time
    over wall is the share of the call the device was busy.  The profiler
    slows the replays somewhat, so the share is a lower bound."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # User annotations (the port's ``qwen3_asr/*`` spans, the optimizer's
    # ``Optimizer.step#Adam.step``) also sit on the device timeline.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "qwen3_asr/"))
               and "#" not in e.name and not getattr(e, "is_user_annotation", False)]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3, wall


#: Token budget of the profiled decodes of the graphed phase (a window of
#: the same loop; a whole 64-token eager decode is ~120k kernel events).
BUSY_TOKENS = 8


def graphs_phase(card: str, base) -> None:
    """The offline decode loops as CUDA graphs, arm by arm (:data:`GRAPH_ARMS`,
    each on a model sharing ``base``'s weights): one ``transcribe_batch`` of
    the arm's clips (``max_tokens=64``) captures the bucket's graph and
    records the decode call's inputs; from that one prefill the eager loop
    (``decode(eager=True)``, one host sync a step) and the graphed loop then
    run in turns (:data:`GRAPH_TURNS`, budgets cut to :data:`GRAPH_TOKENS`).
    Held: every run's tokens bit-identical to the first eager run's (greedy
    and sampled: the sampled graph registers the call's generator, whose
    Philox offsets advance as in the eager loop; were they not to match,
    two graphed runs at one seed must agree, and the arm says so); every
    eager run's launches = live steps x the captured step's launches, every
    graphed run's = the eager count + the no-op replays' launches; new
    sampling values reuse the bucket's graph (no new capture).  The decode modes "3" and "4" arms (K11a, K11b and the
    standalone K3, the end and slot read on the device) run under
    :class:`Switch`.  Printed beside the card: ms per live iteration
    (median of the turns, each loop), capture ms, device busy share of one
    run of each loop (``torch.profiler``), replays, live steps and host
    syncs per decode, and peak device memory of each loop."""
    clips8 = smoke_clips()
    for label, runtime, B, sampling, mode in GRAPH_ARMS:
        clips = [clips8[-1]] if B == 1 else (clips8 * (B // 8))
        with Switch(mode=mode):
            graph_arm(card, base, label, runtime, clips, sampling)


def graph_arm(card: str, base, label: str, runtime: dict, clips, sampling: dict) -> None:
    """One arm of :func:`graphs_phase` on ``clips``, under the decode
    kernel mode in force."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.runtime import graphs as graphs_mod
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    vocab = base._config.text_decoder.vocab_size
    model = build_model(runtime, base)
    gen = model._generator
    seen = {}
    real = Generator.decode

    def spy(self, *args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        return real(self, *args, **kwargs)

    Generator.decode = spy
    try:
        with Watch():
            model.transcribe_batch(clips, max_tokens=64, **sampling)
    finally:
        Generator.decode = real
    dg = gen.graphs
    capture_ms, captures = dg.last_capture_ms, dg.captures
    if captures != 1:
        raise AssertionError(f"graphs {label}: {captures} captures, want 1")
    args, kwargs = seen["args"], seen["kwargs"]

    def decode(eager: bool, budget: int | None = None) -> dict:
        call = args if budget is None else (
            *args[:3], [min(m, budget) for m in args[3]], *args[4:])
        LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks = gen.decode(*call, eager=eager, **kwargs)
        torch.cuda.synchronize()
        return {"toks": toks, "ms": (time.perf_counter() - t0) * 1e3,
                "launches": dict(LAUNCHES), "steps": gen.last_decode_steps,
                "replays": gen.last_replays, "syncs": gen.last_host_syncs,
                "peak": torch.cuda.max_memory_allocated() / 2**30}

    with Watch() as watch, torch.inference_mode():
        runs = {"E": [], "G": []}
        for turn in GRAPH_TURNS:
            runs[turn].append(decode(turn == "E", GRAPH_TOKENS))
        peak = {turn: max(r["peak"] for r in runs[turn]) for turn in "EG"}
        busy = {turn: profiled_busy(lambda: decode(turn == "E", BUSY_TOKENS))
                for turn in "EG"}
        if sampling:
            for other in (dict(temperature=0.5, top_k=7, top_p=0.8, seed=2),
                          dict(temperature=1.1, top_k=200, top_p=0.97, seed=3,
                               repetition_penalty=1.05, repetition_context_size=40)):
                gen.decode(*args, **dict(kwargs, **other))
            if dg.captures != captures:
                raise AssertionError(f"graphs {label}: new sampling values re-captured")
        if bool(watch.nan_seen):
            raise AssertionError(f"graphs {label}: NaN logits")
    eager, graphed = runs["E"], runs["G"]
    ref = eager[0]["toks"]
    check_ids(f"graphs {label}", ref, vocab)
    if any(r["toks"] != ref for r in eager):
        raise AssertionError(f"graphs {label}: two eager runs at one seed differ")
    if any(r["toks"] != ref for r in graphed):
        if not sampling or any(r["toks"] != graphed[0]["toks"] for r in graphed):
            raise AssertionError(f"graphs {label}: the graphed loop's tokens differ")
        print(f"graphs {label}: the graphed sampled stream differs from the eager one "
              f"(the graph's Philox offsets); the graphed runs agree at one seed")
        same = "graphed runs identical at one seed"
    else:
        same = "graphed tokens bit-identical to eager"
    per = dg.get(gen.last_bucket)[1].launches
    steps = ref_steps = eager[0]["steps"]
    for r in eager + graphed:
        if r["steps"] != ref_steps:
            raise AssertionError(f"graphs {label}: {r['steps']} live steps, want {ref_steps}")
    for r in eager:
        want = {k: v * steps for k, v in per.items()}
        if r["launches"] != want:
            raise AssertionError(f"graphs {label}: eager launches {r['launches']}, want "
                                 f"{want} ({steps} steps x the captured step's {dict(per)})")
    for r in graphed:
        want = {k: v * r["replays"] for k, v in per.items()}
        if r["launches"] != want:
            raise AssertionError(f"graphs {label}: graphed launches {r['launches']}, want "
                                 f"{want} ({r['replays']} replays)")
    e_ms = sorted(r["ms"] / steps for r in eager)
    g_ms = sorted(r["ms"] / steps for r in graphed)
    g = graphed[0]
    print(f"graphs {label} [{card}]: {same}; {steps} live steps, {g['replays']} replays "
          f"(blocks of {graphs_mod.BLOCK}), "
          f"{g['syncs']} host syncs per graphed decode against {eager[0]['syncs']} eager; "
          f"ms per live iteration eager {e_ms[len(e_ms) // 2]:.3f} (min {e_ms[0]:.3f}, max "
          f"{e_ms[-1]:.3f}), graphed {g_ms[len(g_ms) // 2]:.3f} (min {g_ms[0]:.3f}, max "
          f"{g_ms[-1]:.3f}) = {e_ms[len(e_ms) // 2] / g_ms[len(g_ms) // 2]:.2f}x; capture "
          f"{capture_ms:.1f} ms ({captures} capture{'s' if captures > 1 else ''}"
          f"{', none for new sampling values' if sampling else ''}); device busy over a "
          f"{BUSY_TOKENS}-token decode under the profiler, eager "
          f"{busy['E'][1] / busy['E'][2]:.1%} ({busy['E'][0]} kernels, {busy['E'][1]:.1f} of "
          f"{busy['E'][2]:.1f} ms), graphed {busy['G'][1] / busy['G'][2]:.1%} "
          f"({busy['G'][0]} kernels, {busy['G'][1]:.1f} of {busy['G'][2]:.1f} ms); peak "
          f"memory eager {peak['E']:.2f} GiB, graphed {peak['G']:.2f} GiB; launches per "
          f"step {dict(per)}")
    model.close()
    del model, gen, dg
    torch.cuda.empty_cache()


#: The live-stream phase's session and stream options.
LIVE_OPTIONS = dict(max_tokens=64, language="English")
#: Launches a preview may make: the graphed plain loop's K2 with K3 fused;
#: never K1 (the advance attends over the cache in plain PyTorch), a
#: standalone writer or K5.
LIVE_NEVER = ("flash_attention_causal", "kv_write_span_batch") + STANDALONE_WRITERS


def live_clip():
    """~24 s of smoke-like audio (tone plus noise) whose first 9 s are
    near-silent, so the first 8 s window is advanced under a low clamp
    floor that the loud rest then lifts."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    t = np.arange(24 * 16000) / 16000.0
    clip = 0.3 * np.sin(2 * np.pi * 310.0 * t) + 0.05 * rng.standard_normal(len(t))
    clip[: 9 * 16000] *= 3e-4
    return clip.astype(np.float32)


def gapped_tones(seconds: float, gap_every: float, seed: int):
    """Tones of changing pitch with a 0.4 s silence every ``gap_every``
    seconds (the streaming split lands in one)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, step = int(seconds * 16000), int(gap_every * 16000)
    out = np.zeros(n, np.float32)
    for lo in range(0, n, step):
        t = np.arange(min(step, n - lo)) / 16000.0
        out[lo : lo + len(t)] = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 800) * t)
        out[lo : lo + int(0.4 * 16000)] = 0.0
    return out + 0.02 * rng.standard_normal(n).astype(np.float32)


def hold_to_transcribe(label: str, model, audio, ids: list[int]) -> list[int]:
    """``ids`` equal to the greedy tokens of ``model.transcribe(audio)``, or
    first apart where that run's top two penalized logits lie within
    NEAR_TIE of max |logit| (then the offline run's rows come from its eager
    loop, whose tokens must equal the graphed loop's).  Returns the offline
    tokens."""
    graphed = _ids([model.transcribe(audio, **LIVE_OPTIONS)])[0]
    if ids == graphed:
        print(f"{label}: {len(ids)} tokens identical to transcribe's")
        return graphed
    with Choices() as rec:
        eager = _ids([model.transcribe(audio, **LIVE_OPTIONS)])[0]
    if eager != graphed:
        raise AssertionError(f"{label}: the offline eager loop's tokens differ from the graphed")
    compare_streams(label, [graphed], [ids], top_two_gaps(rec.rows))
    return graphed


class StageTimes:
    """While active, CUDA-synced wall ms of ``gen``'s ``advance`` calls and
    of its ``decode`` calls (instance attributes over the class's methods;
    the syncs add a few microseconds to a preview), and the first-token
    logits each decode call was given."""

    def __init__(self, gen):
        self.gen = gen
        self.advance_ms, self.decode_ms, self.advances = 0.0, 0.0, 0
        self.first_logits = []

    def _timed(self, fn, field: str):
        import torch

        def call(*args, **kwargs):
            if field == "decode_ms":
                self.first_logits.append(args[1].float().clone())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            setattr(self, field, getattr(self, field) + (time.perf_counter() - t0) * 1e3)
            if field == "advance_ms":
                self.advances += 1
            return out
        return call

    def __enter__(self):
        self.gen.advance = self._timed(type(self.gen).advance.__get__(self.gen), "advance_ms")
        self.gen.decode = self._timed(type(self.gen).decode.__get__(self.gen), "decode_ms")
        return self

    def __exit__(self, *exc):
        del self.gen.advance, self.gen.decode


def timed_preview(sess) -> tuple[object, float, StageTimes]:
    """(result, CUDA-synced wall ms, stage times) of one ``sess.preview()``."""
    import torch

    torch.cuda.synchronize()
    with StageTimes(sess._gen) as st:
        t0 = time.perf_counter()
        res = sess.preview()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return res, ms, st


def timed_transcribe(model, audio, options=LIVE_OPTIONS) -> tuple[object, float, StageTimes]:
    """(result, CUDA-synced wall ms, stage times) of one ``model.transcribe``."""
    import torch

    torch.cuda.synchronize()
    with StageTimes(model._generator) as st:
        t0 = time.perf_counter()
        res = model.transcribe(audio, **options)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return res, ms, st


def first_row_note(preview: StageTimes, offline: StageTimes) -> str:
    """The preview's first-token logits (the suffix advance's) against the
    offline prefill's: max |difference| and the offline top-two gap, each
    over max |logit|."""
    a, b = preview.first_logits[0][0], offline.first_logits[0][0]
    top = b.abs().max().item()
    top2 = b.topk(2).values
    return (f"first-token row diff {(a - b).abs().max().item() / top:.2e} of max |logit|, "
            f"offline top-two gap {(top2[0] - top2[1]).item() / top:.2e}")


def hold_eager_preview(card: str, sess, res, st: StageTimes) -> None:
    """The same preview again with every advance and the decode eager
    (``eager=True``, the graphs' oracle): its text and first-token logits
    bit-identical to the graphed preview's ``res`` and ``st``."""
    from functools import partialmethod

    import torch

    from qwen3_asr_tpu_torch.runtime.generate import Generator

    saved = Generator.advance, Generator.decode
    Generator.advance = partialmethod(saved[0], eager=True)
    Generator.decode = partialmethod(saved[1], eager=True)
    try:
        eager, ms, est = timed_preview(sess)
    finally:
        Generator.advance, Generator.decode = saved
    if eager.text != res.text:
        raise AssertionError("live: the eager preview's text differs from the graphed one's")
    for a, b in zip(st.first_logits, est.first_logits):
        if not torch.equal(a, b):
            raise AssertionError("live: the eager preview's first-token logits differ from "
                                 "the graphed one's")
    print(f"live preview, eager advance and decode [{card}]: text and first-token logits "
          f"bit-identical to the graphed preview's; preview {ms:.1f} ms, advance "
          f"{est.advance_ms:.1f} ms ({est.advances} calls), decode {est.decode_ms:.1f} ms")


#: The advance spans a session makes (the prefix and suffix, a window) and
#: the turns of each timing (eager, graphed, graphed, eager) x rounds.
ADVANCE_SPANS = (16, 104)
ADVANCE_ROUNDS = 5


def advance_turns(card: str, gen, sess) -> None:
    """``Generator.advance`` at T = 16 and 104 on a copy of the session's
    cache, graphed (the arena copies in and out included) and eager in
    turns: CUDA-synced wall ms a call, medians; the timed calls replay the
    bucket's graph (no capture among them)."""
    import torch

    cfg = gen.cfg
    rng = torch.Generator(device="cuda").manual_seed(SEED + 7)
    with torch.inference_mode():
        kv = tuple(c.clone() for c in sess._kv)
        for T in ADVANCE_SPANS:
            embeds = (0.02 * torch.randn(1, T, cfg.hidden_size, generator=rng,
                                         device="cuda")).to(kv[0].dtype)
            pos = (9 + torch.arange(T))[None]
            times = {True: [], False: []}

            def call(eager: bool) -> float:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen.advance(kv, embeds, pos, 9, T - 1, eager=eager)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            call(True)
            call(False)
            captures = gen.graphs.captures
            for _ in range(ADVANCE_ROUNDS):
                for eager in (True, False, False, True):
                    times[eager].append(call(eager))
            if gen.graphs.captures != captures:
                raise AssertionError(f"live advance T={T}: a timed call captured again")
            e, g = (sorted(times[x]) for x in (True, False))
            print(f"live advance T={T} B=1 S={kv[0].shape[3]} [{card}]: graphed "
                  f"{g[len(g) // 2]:.3f} ms (min {g[0]:.3f}, max {g[-1]:.3f}; the cache copied "
                  f"into the arena and back included), eager {e[len(e) // 2]:.3f} ms (min "
                  f"{e[0]:.3f}, max {e[-1]:.3f}) = {e[len(e) // 2] / g[len(g) // 2]:.2f}x, "
                  f"{2 * ADVANCE_ROUNDS} calls each in turns, no capture among them")


def live_int8_phase(int8) -> None:
    """On the int8-cache model a ``StreamingTranscriber`` opens no
    incremental session (the session refuses the int8 cache, the JAX
    package's rule) and previews by re-transcribing its tail."""
    from qwen3_asr_tpu_torch import StreamingTranscriber

    stream = StreamingTranscriber(int8, segment_duration=20, search_duration=5,
                                  **LIVE_OPTIONS)
    if stream._inc is not None:
        raise AssertionError("live: the int8-cache model opened an incremental session")
    audio = gapped_tones(6.0, 2.0, SEED + 5)
    stream.feed(audio)
    if _ids([stream.partial()]) != _ids([int8.transcribe(audio, **LIVE_OPTIONS)]):
        raise AssertionError("live: the int8-cache stream's preview is not the transcript")
    print("live, int8 cache: StreamingTranscriber has no incremental session; partial() "
          "re-transcribes the tail (token-identical to transcribe)")


def live_phase(card: str, base) -> None:
    """The live-stream path at 1.7B on ``base``'s weights (a fresh model,
    so its decode graphs start empty).  An ``IncrementalSession``
    (``max_duration=30``, :data:`LIVE_OPTIONS`) fed :func:`live_clip` in 1 s
    pieces and previewed at five prefixes (inside window 1, window 1 + 40
    samples, mid window 2, window 2 + 40 samples, the end): each preview's
    tokens held to ``transcribe`` of the same prefix by the near-tie rule;
    launches per preview K2 and its fused K3 28 x replays, never K1, K5 or
    a standalone writer; on the first preview one capture of the decode
    bucket and one of the window advance's (T = 104; the session's prefix
    advance captured T = 16, which the suffix advance replays), none later;
    the committed windows counted and the quiet window re-advanced after
    the floor rose; the 12.5 s preview again with every advance and the
    decode eager (:func:`hold_eager_preview`: text and first-token logits
    bit-identical); a ``transcribe`` of another clip between two previews
    of the same audio changes nothing; the advance's graphed and eager ms
    at T = 16 and 104 (:func:`advance_turns`).  Printed per preview:
    preview ms, transcribe ms of the prefix, advance ms, decode ms per
    iteration.  Then ``StreamingTranscriber``: 60 s of gapped tones in 1 s
    pieces (``segment_duration=20``, ``search_duration=5``), each final
    segment and one ``partial()`` held to ``transcribe`` of its audio; two
    sessions streaming the same audio through ``feed_nowait`` on the paged
    ``ContinuousTranscriptionServer``, their segments held to the model
    path's; a session on int8 weights (:func:`live_int8_weights`).  On
    the int8-cache model, a stream with no incremental session, previewing
    by re-transcription (:func:`live_int8_phase`)."""
    import torch

    from qwen3_asr_tpu_torch import StreamingTranscriber
    from qwen3_asr_tpu_torch.incremental import WINDOW_SAMPLES
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    t_phase = time.perf_counter()
    model = build_model({"speculative": "off"}, base)
    gen = model._generator
    vocab = model._config.text_decoder.vocab_size
    layers = model._config.text_decoder.num_hidden_layers
    clip = live_clip()
    prefixes = (int(3.2 * 16000), WINDOW_SAMPLES + 40, int(12.5 * 16000),
                2 * WINDOW_SAMPLES + 40, len(clip))
    committed_want = (0, 1, 1, 2, 2)
    with Watch() as watch:
        sess = model.incremental_session(max_duration=30.0, **LIVE_OPTIONS)
        advanced = []
        real_window = sess._advance_window
        sess._advance_window = lambda w, floor: (advanced.append(w), real_window(w, floor))
        fed, floors, last = 0, [], None
        for i, (cut, want) in enumerate(zip(prefixes, committed_want)):
            while fed < cut:
                sess.feed(clip[fed : min(fed + 16000, cut)])
                fed = min(fed + 16000, cut)
            keys = set(gen.graphs.entries)
            LAUNCHES.clear()
            res, prev_ms, st = timed_preview(sess)
            launches = dict(LAUNCHES)
            new_keys = set(gen.graphs.entries) - keys
            new_advance = sum(k[0] == "advance" for k in new_keys)
            new_captures = len(new_keys) - new_advance
            # The first preview captures the decode bucket and the window
            # advance's (T = 104); the session's prefix advance captured
            # T = 16, which the suffix advance replays.
            if (new_captures, new_advance) != ((1, 1) if i == 0 else (0, 0)):
                raise AssertionError(f"live preview {i}: {new_captures} decode and "
                                     f"{new_advance} advance captures")
            replays = gen.last_replays
            # A capture's warm-up step runs eagerly once, and counts.
            for name in ("decode_attention", "kv_write_rows_fused"):
                if launches.get(name) != layers * (replays + new_captures):
                    raise AssertionError(f"live preview {i}: {name} launched "
                                         f"{launches.get(name)} times, want {layers} x "
                                         f"({replays} replays + {new_captures} capture)")
            check_launches(f"live preview {i}", launches, (), LIVE_NEVER)
            if sess._committed != want:
                raise AssertionError(f"live preview {i}: {sess._committed} windows "
                                     f"committed, want {want}")
            floors.append(list(sess._win_floor))
            ids = _ids([res])[0]
            check_ids(f"live preview {i}", [ids], vocab)
            off, off_ms, off_st = timed_transcribe(model, clip[:cut])
            hold_to_transcribe(f"live preview {i} ({cut / 16000:.4f} s) vs transcribe",
                               model, clip[:cut], ids)
            steps = gen.last_decode_steps
            print(f"live preview {i} [{card}]: {cut / 16000:.4f} s of audio, "
                  f"{sess._committed} windows committed; preview {prev_ms:.1f} ms against "
                  f"transcribe of the prefix {off_ms:.1f} ms; advance {st.advance_ms:.1f} ms "
                  f"({st.advances} graphed calls, {new_advance} captured), decode "
                  f"{st.decode_ms:.1f} ms over {steps} live steps "
                  f"= {st.decode_ms / max(steps, 1):.3f} ms per iteration ({replays} replays); "
                  f"{len(ids)} tokens, offline tokens equal: {_ids([off])[0] == ids}; "
                  f"{first_row_note(st, off_st)}")
            last = ids
            if i == 2:
                hold_eager_preview(card, sess, res, st)
        if advanced.count(0) < 2 or not floors[2][0] > floors[1][0]:
            raise AssertionError(f"live: window 0 advanced {advanced.count(0)} times, floors "
                                 f"{floors[1][0]} -> {floors[2][0]}: no re-advance after the "
                                 "floor rose")
        model.transcribe(smoke_clips()[0], **LIVE_OPTIONS)      # zeroes the arena
        again = _ids([sess.preview()])[0]
        if again != last:
            raise AssertionError("live: a transcribe between two previews changed the preview")
        print(f"live session: window 0 advanced {advanced.count(0)} times (clamp floor "
              f"{floors[1][0]:.4f} -> {floors[2][0]:.4f}), windows advanced in order "
              f"{advanced}; a transcribe of another clip between two previews of the same "
              f"audio left the preview's tokens identical")
        advance_turns(card, gen, sess)

        # StreamingTranscriber: final segments and one partial().
        audio = gapped_tones(60.0, 3.7, SEED + 3)
        stream = StreamingTranscriber(model, segment_duration=20, search_duration=5,
                                      **LIVE_OPTIONS)
        if stream._inc is None:
            raise AssertionError("live: the bf16 stream has no incremental session")
        segs, partial = [], None
        for lo in range(0, len(audio), 16000):
            segs += stream.feed(audio[lo : lo + 16000])
            if partial is None and lo >= 30 * 16000:
                tail = audio[stream._consumed : lo + 16000]
                partial = (stream.partial(), tail)
        segs += stream.flush()
        if len(segs) < 3:
            raise AssertionError(f"live stream: {len(segs)} segments of 60 s")
        for k, g in enumerate(segs):
            span = audio[round(g.start * 16000) : round(g.end * 16000)]
            hold_to_transcribe(f"live stream segment {k} ({g.start:.2f}-{g.end:.2f} s)",
                               model, span, _ids([g])[0])
        hold_to_transcribe("live stream partial()", model, partial[1], _ids([partial[0]])[0])

        # The server= path: two sessions streaming the same audio through
        # feed_nowait, their segments held to the model path's above.
        with ContinuousTranscriptionServer(model, n_slots=8, max_duration=30.0,
                                           max_new_tokens=512, chunk_steps=16) as srv:
            sessions = [StreamingTranscriber(model, segment_duration=20, search_duration=5,
                                             server=srv, **LIVE_OPTIONS) for _ in range(2)]
            futs = [[] for _ in sessions]
            for lo in range(0, len(audio), 16000):
                for k, s in enumerate(sessions):
                    futs[k] += s.feed_nowait(audio[lo : lo + 16000])
            for k, s in enumerate(sessions):
                futs[k] += s.flush_nowait()
            served = [[f.result(timeout=600) for f in fs] for fs in futs]
        for k, got in enumerate(served):
            if [(g.start, g.end) for g in got] != [(g.start, g.end) for g in segs]:
                raise AssertionError(f"live server stream {k}: segment spans differ from the "
                                     "model path's")
            for j, (g, r) in enumerate(zip(got, segs)):
                span = audio[round(g.start * 16000) : round(g.end * 16000)]
                offline = hold_to_transcribe(f"live server stream {k} segment {j}", model,
                                             span, _ids([g])[0])
                if _ids([r])[0] != offline:
                    raise AssertionError(f"live segment {j}: the model path is not the "
                                         "transcript")
        if bool(watch.nan_seen):
            raise AssertionError("live: NaN logits")
    live_int8_weights(card, base, clip[: prefixes[2]])
    print(f"live streams [{card}]: {len(segs)} final segments and one partial() of a 60 s "
          f"stream held to transcribe; 2 server streams of "
          f"{[len(x) for x in served]} segments held to the model path's; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    model.close()
    del model, gen, sess, stream
    torch.cuda.empty_cache()


def live_int8_weights(card: str, base, audio) -> None:
    """One preview of ``audio`` by a session on int8 weights over the bf16
    cache (``quantization="int8"``): the advance's products run K9 at its
    16- and 104-row spans, inside the advance's captured graphs, the decode
    K9 at M = 1 with K2 and the fused K3;
    the tokens held to ``transcribe`` of the same audio."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    model = build_model({"speculative": "off", "quantization": "int8"}, base)
    sess = model.incremental_session(max_duration=30.0, **LIVE_OPTIONS)
    for lo in range(0, len(audio), 16000):
        sess.feed(audio[lo : lo + 16000])
    sess.preview()                          # captures the bucket's graph
    LAUNCHES.clear()
    res, ms, st = timed_preview(sess)
    launches = dict(LAUNCHES)
    replays = model._generator.last_replays
    check_launches("live preview, int8 weights", launches,
                   ("quantized_matmul", "decode_attention", "kv_write_rows_fused"), LIVE_NEVER)
    if launches["decode_attention"] != model._config.text_decoder.num_hidden_layers * replays:
        raise AssertionError(f"live preview, int8 weights: K2 {launches['decode_attention']} "
                             f"launches for {replays} replays")
    hold_to_transcribe("live preview, int8 weights", model, audio, _ids([res])[0])
    print(f"live preview, int8 weights [{card}]: {len(audio) / 16000:.4f} s, preview {ms:.1f} "
          f"ms, advance {st.advance_ms:.1f} ms ({st.advances} calls), decode "
          f"{st.decode_ms / max(model._generator.last_decode_steps, 1):.3f} ms per iteration")
    model.close()
    del model, sess
    torch.cuda.empty_cache()


#: The training phase's tiny model: ``tests/test_training_checkpoint.py``'s
#: config (one encoder layer, head_dim 16), float32.
TRAIN_TINY_ENCODER = dict(d_model=32, encoder_layers=1, encoder_attention_heads=4,
                          encoder_ffn_dim=64, output_dim=64, downsample_hidden_size=8)
TRAIN_TINY_DECODER = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16, intermediate_size=128,
                          vocab_size=512)
#: (B, mel frames, valid frames, audio tokens, prompt length P) of the
#: full-width batch: two 30 s clips in the 3200-frame bucket, the JAX dry
#: run's loss mask over [9 + n_audio, P).
TRAIN_FULL = (2, 3200, 3000, 390, 512)
TRAIN_LR = 1e-4
TRAIN_STEPS = 3
#: Peak dense rates (NVIDIA's H100 SXM data sheet): float32 outside the
#: tensor cores (the step runs with TF32 off) and bf16.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def train_batch(vocab: int, B: int, frames: int, valid: int, n_audio: int, P: int,
                seed: int, device):
    """A seeded training batch: uniform [-1, 1) log-mel (zero past ``valid``
    frames), prompt ids and next-token labels drawn from the vocabulary,
    the loss mask over [9 + n_audio, P)."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.training.train import Batch

    rng = np.random.default_rng(seed)
    mel = rng.uniform(-1.0, 1.0, (B, 128, frames)).astype(np.float32)
    mel[:, :, valid:] = 0.0
    ids, labels = rng.integers(0, vocab, (B, P)), rng.integers(0, vocab, (B, P))
    mask = np.broadcast_to(np.arange(P) >= 9 + n_audio, (B, P))
    fields = (mel, np.full(B, valid), ids, np.full(B, n_audio), labels, mask)
    return Batch(*(torch.from_numpy(np.ascontiguousarray(f)).to(device) for f in fields))


def train_step_work(cfg, B: int, frames: int, P: int) -> tuple[float, float]:
    """(FLOPs of one train step's forward and backward, FLOPs of the tied lm
    head's share): 6 x multiply-adds of every dense product (the decoder's
    B*P tokens, the encoder's B*frames/100*13), the conv stem, the decoder's
    attention over the full P x P square (the plain sdpa computes it all) and
    the encoder's 104-token windows.  The data-dependent parts (masking)
    change no count."""
    enc, dec = cfg.audio_encoder, cfg.text_decoder
    tok_d, tok_e = B * P, B * frames // enc.chunk_frames * enc.tokens_per_chunk
    H, D = dec.hidden_size, dec.head_dim
    nq, nkv, inter = dec.num_attention_heads, dec.num_key_value_heads, dec.intermediate_size
    per_layer_d = H * (nq + 2 * nkv) * D + nq * D * H + 3 * H * inter
    head = dec.vocab_size * H
    d = enc.d_model
    per_layer_e = 4 * d * d + 2 * d * enc.encoder_ffn_dim
    top_e = enc.downsample_hidden_size * enc.freq_after_conv * d + d * d + d * enc.output_dim
    flops = 6.0 * (tok_d * (dec.num_hidden_layers * per_layer_d + head)
                   + tok_e * (enc.encoder_layers * per_layer_e + top_e))
    # Conv stem: multiply-adds per chunk of each 3x3 stride-2 conv.
    n_chunks, ch = B * frames // enc.chunk_frames, enc.downsample_hidden_size
    h, w, c_in, macs = enc.num_mel_bins, enc.chunk_frames, 1, 0.0
    for _ in range(3):
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        macs += h * w * ch * c_in * 9
        c_in = ch
    flops += 6.0 * n_chunks * macs
    # Attention: QK^T and PV, two products of 2 * rows * cols * head_dim each.
    flops += 3 * dec.num_hidden_layers * 4.0 * B * nq * P * P * D
    win = enc.window_tokens
    flops += 3 * enc.encoder_layers * 4.0 * tok_e * win * d
    return flops, 6.0 * tok_d * head


def grad_report(state) -> tuple[list[str], list[str], float]:
    """(leaves with a non-finite gradient, leaves with an all-zero or missing
    gradient, global L2 norm), from one stacked read of the device."""
    import torch

    from qwen3_asr_tpu_torch.training.train import named_params

    named = named_params(state.encoder, state.decoder)
    stats = []
    for _, t in named:
        g = t.grad.detach().float() if t.grad is not None else torch.full((), float("nan"),
                                                                         device=t.device)
        stats.append(torch.stack([torch.isfinite(g).all().float(), g.abs().amax(),
                                  torch.sum(g * g)]))
    rows = torch.stack(stats).cpu()
    bad = [n for (n, t), r in zip(named, rows) if t.grad is None or r[0] < 1]
    zero = [n for (n, t), r in zip(named, rows) if t.grad is None or r[1] == 0]
    return bad, zero, float(rows[:, 2].sum().sqrt())


def train_tiny_config():
    """The float32 parity config (:data:`TRAIN_TINY_ENCODER`, ``_DECODER``)."""
    from qwen3_asr_tpu_torch.config import AudioEncoderConfig, ModelConfig, TextDecoderConfig

    return ModelConfig(audio_encoder=AudioEncoderConfig(**TRAIN_TINY_ENCODER),
                       text_decoder=TextDecoderConfig(**TRAIN_TINY_DECODER))


def train_parity(card: str) -> tuple[float, dict]:
    """(a) The tiny config, float32 with TF32 off (cuDNN's conv uses it by
    default): one Adam step on the card against the same step on CPU
    tensors, the loss within 1e-5 relative and every gradient leaf within
    1e-4 x max |CPU grad| + 1e-7 (``tests/test_torch_training.py``'s
    tolerances).  Returns the card's loss and gradients by leaf name."""
    import functools

    import torch

    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training.train import init_train_state, make_train_step, named_params

    cfg = train_tiny_config()
    opt = functools.partial(torch.optim.Adam, lr=1e-3)
    step = make_train_step(cfg)
    cpu_params = random_params(cfg, seed=SEED, dtype=torch.float32)
    gpu_params = tuple(_params_to(p, "cuda", torch.float32) for p in cpu_params)
    out = []
    for params, device in ((cpu_params, "cpu"), (gpu_params, "cuda")):
        state = init_train_state(cfg, opt, *params)
        batch = train_batch(cfg.text_decoder.vocab_size, 2, 800, 700, 91, 144, SEED, device)
        state, loss = step(state, batch)
        out.append((loss.item(), {n: t.grad.float().cpu()
                                  for n, t in named_params(state.encoder, state.decoder)}))
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = out
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    if not rel <= 1e-5:
        raise AssertionError(f"training parity: loss {gpu_loss} on the card, {cpu_loss} on the CPU")
    worst, worst_name = -1.0, ""
    for name, ref in cpu_g.items():
        scale = ref.abs().max().item()
        err = (gpu_g[name] - ref).abs().max().item()
        if not err <= 1e-4 * scale + 1e-7:
            raise AssertionError(f"training parity: {name} grad err {err:.3e}, max |g| {scale:.3e}")
        if err / (1e-4 * scale + 1e-7) > worst:
            worst, worst_name = err / (1e-4 * scale + 1e-7), f"{name} (err {err:.2e}, max |g| {scale:.2e})"
    print(f"training parity (tiny f32 config, TF32 off, one Adam step): loss card {gpu_loss:.7f} "
          f"CPU {cpu_loss:.7f} (rel {rel:.2e}); {len(cpu_g)} gradient leaves within 1e-4 x max |g| "
          f"+ 1e-7, the closest at {worst:.1%} of its tolerance: {worst_name} ({card})")
    return gpu_loss, gpu_g


def train_restore(card: str) -> None:
    """Restore after a capture, on the tiny float32 config (TF32 off, Adam
    lr 1e-3, weights drawn on the host): a state takes three steps (the
    warm-up, the capture and its replay, a replay), is saved, and takes a
    fourth; ``restore_train_state`` loads the snapshot back into that
    captured state (the optimizer's state tensors are new, so the step drops
    its graphs), and its next three steps (eager, capture, replay) must
    equal three ``eager=True`` steps of a fresh state restored from the same
    snapshot bit for bit: losses, parameters and Adam moments."""
    import dataclasses
    import functools
    import shutil

    import torch

    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training import checkpoint as ckpt
    from qwen3_asr_tpu_torch.training.train import init_train_state, make_train_step

    cfg = train_tiny_config()
    opt = functools.partial(torch.optim.Adam, lr=1e-3)

    def fresh(seed):
        params = random_params(cfg, seed=seed, dtype=torch.float32)
        return init_train_state(cfg, opt, *(_params_to(p, "cuda", torch.float32) for p in params))

    batch = train_batch(cfg.text_decoder.vocab_size, 2, 800, 700, 91, 144, SEED, "cuda")
    where = ROOT / "build" / "train_restore"
    shutil.rmtree(where, ignore_errors=True)
    try:
        step, state = make_train_step(cfg), fresh(SEED)
        for _ in range(3):
            state, _ = step(state, batch)
        ckpt.save_train_state(where, state)
        state, _ = step(state, batch)
        state = ckpt.restore_train_state(where, state)
        runs = {}
        for label, st, stepper in (("graphed", state, step),
                                   ("eager", ckpt.restore_train_state(where, fresh(SEED + 1)),
                                    make_train_step(cfg, eager=True))):
            losses = []
            for _ in range(3):
                st, loss = stepper(st, batch)
                losses.append(loss)
            runs[label] = (torch.stack(losses).cpu().tolist(), state_digests(st, moments=True))
    finally:
        shutil.rmtree(where, ignore_errors=True)
    counts = dataclasses.asdict(step.stats)
    want = {"captures": 2, "replays": 5, "eager_steps": 2, "drops": 1}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"training restore after capture: the step's counters {counts}, "
                             f"want {want}")
    if runs["graphed"] != runs["eager"]:
        raise AssertionError(f"training restore after capture: losses {runs['graphed'][0]} "
                             f"against a fresh eager run's {runs['eager'][0]}, parameters and "
                             f"moments equal: {runs['graphed'][1] == runs['eager'][1]}")
    print(f"training restore after capture (tiny f32 config): the snapshot loaded into the "
          f"captured state dropped its graphs (drops {counts['drops']}), its next three steps "
          f"(eager, capture, replay) bit-identical to eager=True from a fresh restore: losses "
          f"{['%.7f' % x for x in runs['graphed'][0]]}, {len(runs['graphed'][1])} leaves and "
          f"moments ({card})")


def train_run(cfg, dtype, init, batch, eager: bool, fingerprint: bool = False) -> dict:
    """One run of the train step (``make_train_step(cfg, eager=eager)``) from
    a copy of the parameter trees ``init``, Adam at lr :data:`TRAIN_LR`, on
    ``batch``: two steps on the host clock (graphed: the shape's warm-up
    step, then its capture and first replay), :data:`TRAIN_STEPS` steps
    between two CUDA events, one step under
    ``torch.cuda.set_sync_debug_mode("warn")`` and one under
    :func:`profiled_busy`.  Returns the losses, the timings, the step's
    counters, the host syncs of the checked step, the profiled step's
    kernels and busy share, the peak memory, the last step's
    :func:`grad_fingerprint` and :func:`grad_report`, and the parameters'
    :func:`state_digests`; with ``fingerprint`` also the first step's
    :func:`grad_fingerprint`."""
    import copy
    import dataclasses
    import functools
    import warnings

    import torch

    from qwen3_asr_tpu_torch.training.train import init_train_state, make_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, functools.partial(torch.optim.Adam, lr=TRAIN_LR),
                             *copy.deepcopy(init))
    step = make_train_step(cfg, eager=eager)
    losses, first_s, out = [], [], {}
    for k in range(2):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(loss)
        torch.cuda.synchronize()
        first_s.append(time.perf_counter() - t0)
        if k == 0 and fingerprint:
            out["first_fingerprint"] = grad_fingerprint(state)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, loss = step(state, batch)
            losses.append(loss)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    last = []

    def profiled():
        last.append(step(state, batch))

    kernels, kernel_ms, wall_ms = profiled_busy(profiled)
    state = last[0][0]
    losses.append(last[0][1])
    bad, zero, gnorm = grad_report(state)
    out.update(
        losses=torch.stack(losses).float().cpu().tolist(), ms=ms, first_s=first_s,
        stats=dataclasses.asdict(step.stats), graphed=step.graphed(state), syncs=syncs,
        kernels=kernels, kernel_ms=kernel_ms, wall_ms=wall_ms,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, fingerprint=grad_fingerprint(state),
        bad=bad, zero=zero, gnorm=gnorm, digests=state_digests(state),
        n_params=sum(t.numel() for t in state.optimizer.param_groups[0]["params"]))
    step.close()
    del state, loss, losses, last
    torch.cuda.empty_cache()
    return out


def same_bits(a: dict, b: dict) -> bool:
    """Whether two :func:`train_run` records have bit-identical losses and
    parameters."""
    return a["losses"] == b["losses"] and a["digests"] == b["digests"]


def hold_graphed(label: str, graphed: dict, eager: list[dict]) -> None:
    """Hold a graphed :func:`train_run` to two ``eager=True`` runs from the
    same state, with ``cudnn.deterministic`` on (:func:`training_phase`):
    the two eager runs bit-identical (losses and parameters), so eager is
    reproducible, and the graphed run bit-identical to them; every leaf's
    last gradient (norm and seeded projection, :func:`grad_fingerprint`)
    within :data:`TRAIN_GRAD_TOL` of its norm plus 1e-6 of the whole
    gradient's norm of the first eager run's."""
    e1, e2 = eager
    if not same_bits(e1, e2):
        raise AssertionError(f"{label}: two eager=True runs from one state differ: losses "
                             f"{e1['losses']} against {e2['losses']}")
    if not same_bits(graphed, e1):
        raise AssertionError(f"{label}: the graphed run is not bit-identical to eager=True: "
                             f"losses {graphed['losses']} against {e1['losses']}, parameters "
                             f"equal {graphed['digests'] == e1['digests']}")
    ref, got = e1["fingerprint"], graphed["fingerprint"]
    total = ref[:, 0].sum().sqrt().item()
    for i in range(ref.shape[0]):
        norm = ref[i, 0].sqrt().item()
        err = max(abs(got[i, 0].sqrt().item() - norm), abs(got[i, 1].item() - ref[i, 1].item()))
        if not err <= TRAIN_GRAD_TOL * norm + 1e-6 * total:
            raise AssertionError(f"{label}: leaf {i} last gradient off by {err:.3e} (norm "
                                 f"{norm:.3e}) against eager=True")


def train_arm(card: str, dtype, label: str) -> dict:
    """(b)/(c) ``ModelConfig()`` from ``random_params(seed=0)`` in ``dtype``
    on the card, the :data:`TRAIN_FULL` batch: :func:`train_run` graphed,
    then twice with ``eager=True`` from the same initial trees, the graphed
    run held to them (:func:`hold_graphed`).  (d) In each run every loss
    finite and the last below the first, every parameter leaf's last
    gradient finite and nonzero, no host sync in the checked step; the
    graphed run captures once.  Returns the graphed run's record (with
    ``fingerprint`` its first step's gradient fingerprint, the float32
    reference of :func:`mesh_training_phase`) and the eager runs' ms."""
    import torch

    from qwen3_asr_tpu_torch.config import ModelConfig
    from qwen3_asr_tpu_torch.models.params import random_params

    cfg = ModelConfig()
    B, frames, valid, n_audio, P = TRAIN_FULL
    init = random_params(cfg, seed=SEED, dtype=dtype, device="cuda")
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, "cuda")
    graphed = train_run(cfg, dtype, init, batch, eager=False, fingerprint=dtype == torch.float32)
    eager = [train_run(cfg, dtype, init, batch, eager=True) for _ in range(2)]
    del init, batch
    torch.cuda.empty_cache()
    flops, head_flops = train_step_work(cfg, B, frames, P)
    n_params = graphed["n_params"]
    itemsize = torch.empty((), dtype=dtype).element_size()
    if dtype == torch.float32:
        t_ops = flops / PEAK_F32_FLOPS
    else:   # the differentiable lm head multiplies float32 copies
        t_ops = (flops - head_flops) / PEAK_BF16_FLOPS + head_flops / PEAK_F32_FLOPS
    # Adam reads the parameters, gradients and both moments, writes the
    # parameters and moments: 7 tensors of the parameters' size.
    t_bytes = 7 * n_params * itemsize / (PEAK_HBM_GBPS * 1e9)
    bound_ms = max(t_ops, t_bytes) * 1e3
    for run, name in ((graphed, "graphed"), (eager[0], "eager"), (eager[1], "eager (2nd)")):
        st, traj = run["stats"], run["losses"]
        print(f"training {label} {name}: ModelConfig() ({n_params / 1e9:.3f}B parameters, "
              f"{dtype}), B={B} x {frames} mel frames ({valid} valid, {n_audio} audio tokens), "
              f"P={P}, Adam lr {TRAIN_LR}: losses {['%.6f' % x for x in traj]} (2 first steps, "
              f"{TRAIN_STEPS} timed, one sync-checked, one profiled); {run['ms']:.1f} ms a step "
              f"(CUDA events, mean of {TRAIN_STEPS}; first steps {run['first_s'][0]:.2f} / "
              f"{run['first_s'][1]:.2f} s host); bound {bound_ms:.1f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} ({flops / 1e12:.2f} TFLOP, "
              f"{bound_ms / run['ms']:.1%} of it); profiled step {run['kernels']} device "
              f"kernels, {run['kernel_ms']:.1f} ms of them in {run['wall_ms']:.1f} ms wall "
              f"({run['kernel_ms'] / run['wall_ms']:.1%} busy); captures {st['captures']} "
              f"({st['capture_ms']:.1f} ms host), replays {st['replays']}, eager steps "
              f"{st['eager_steps']}; peak memory {run['peak_gb']:.2f} GB (max_memory_allocated, "
              f"the state included); global grad norm {run['gnorm']:.4e} (last step); host "
              f"syncs in the checked step {len(run['syncs'])} ({card})")
        if run["syncs"]:
            raise AssertionError(f"training {label} {name}: host syncs inside a step: "
                                 f"{run['syncs'][:3]}")
        if not all(map(math.isfinite, traj)):
            raise AssertionError(f"training {label} {name}: non-finite loss {traj}")
        if not traj[-1] < traj[0]:
            raise AssertionError(f"training {label} {name}: loss did not fall {traj}")
        if run["bad"] or run["zero"]:
            raise AssertionError(f"training {label} {name}: non-finite gradient {run['bad'][:5]}, "
                                 f"zero gradient {run['zero'][:5]}")
    st = graphed["stats"]
    if not (graphed["graphed"] and st["captures"] == 1 and st["eager_steps"] == 1
            and st["replays"] == len(graphed["losses"]) - 1):
        raise AssertionError(f"training {label}: the graphed run's counters {st}")
    hold_graphed(f"training {label}", graphed, eager)
    print(f"training {label}: graphed {graphed['ms']:.1f} ms a step against eager=True "
          f"{eager[0]['ms']:.1f} / {eager[1]['ms']:.1f} ({eager[0]['ms'] / graphed['ms']:.2f}x), "
          f"one capture of {st['capture_ms']:.1f} ms; losses and parameters bit-identical to "
          f"eager=True (two eager runs bit-identical); every leaf's last gradient "
          f"within {TRAIN_GRAD_TOL:g} x its norm + 1e-6 x the whole norm; peak memory "
          f"{graphed['peak_gb']:.2f} GB graphed against {eager[0]['peak_gb']:.2f} eager ({card})")
    return {"ms": graphed["ms"], "eager_ms": [e["ms"] for e in eager],
            "peak_gb": graphed["peak_gb"], "losses": graphed["losses"], "bound_ms": bound_ms,
            "fingerprint": graphed.get("first_fingerprint")}


def lm_head_derivative(card: str) -> None:
    """Whether ``torch.mm(..., out_dtype=float32)`` (the bf16 lm head of
    inference) has a derivative here, and the differentiable route (an f32
    product of the same bf16 operands) against it at full width, M=64."""
    import torch

    from qwen3_asr_tpu_torch.config import ModelConfig

    cfg = ModelConfig().text_decoder
    g = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn(64, cfg.hidden_size, generator=g, device="cuda").bfloat16()
    emb = (0.02 * torch.randn(cfg.vocab_size, cfg.hidden_size, generator=g,
                              device="cuda")).bfloat16()
    a = h.clone().requires_grad_(True)
    try:
        torch.mm(a, emb.T, out_dtype=torch.float32).sum().backward()
        derivative = "yes"
    except RuntimeError as e:
        derivative = f"none ({str(e).splitlines()[0]})"
    with torch.no_grad():
        ref = torch.mm(h, emb.T, out_dtype=torch.float32)
        f32 = h.float() @ emb.float().T
    err = (f32 - ref).abs().max().item()
    print(f"lm head: torch.mm(bf16, bf16, out_dtype=float32) derivative on the card: "
          f"{derivative}; the differentiable route's f32 product of the same operands "
          f"against it, max abs err {err:.3e} of max |logit| {ref.abs().max().item():.3e} "
          f"({card})")


def training_phase(card: str) -> dict:
    """The training path (``qwen3_asr_tpu_torch/training``): (a)
    :func:`train_parity` and :func:`train_restore`; the lm head's
    derivative; (b) :func:`train_arm` in float32 and (c) in bf16 at full
    width, the graphed step against ``eager=True``; (d) no hand-written
    kernel launched in the whole phase (``LAUNCHES`` unchanged).  TF32 off
    and ``cudnn.deterministic`` on: cuDNN's default conv backward adds with
    atomics, and two eager runs of the tiny config then differ in most
    leaves (Adam turns rounding-level gradients into lr-sized steps).  Returns the
    one-device references of :func:`mesh_training_phase`: the tiny step's
    loss and gradients (``"tiny"``) and each arm's record."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    before = dict(LAUNCHES)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        arms = {"tiny": train_parity(card)}
        train_restore(card)
        lm_head_derivative(card)
        for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            arms[label] = train_arm(card, dtype, label)
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    if dict(LAUNCHES) != before:
        changed = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES if LAUNCHES[k] != before.get(k, 0)}
        raise AssertionError(f"training phase launched hand-written kernels: {changed}")
    print(f"training phase: no hand-written kernel launched ({sum(before.values())} launches "
          f"before, unchanged) ({card})")
    return arms


# -- one replica per device, and (dp, tp) meshes ------------------------------------------

#: The replicated server's requests: the smoke clips twice.
REPLICATED_REQUESTS = 16
#: The meshes the smoke runs on any machine, and with four cards also (2, 2).
MESHES = ((1, 2), (2, 1))
#: Seconds a mesh rank may take (spawn, CUDA init, the 1.7B build, the run).
MESH_TIMEOUT = 600
#: tp = 2 prefill logits against one device's, bf16 both: the largest
#: allowed max |difference| over max |logit|, the bf16 floor that
#: reference_check holds the kernels' bf16 logits to against float32.
MESH_LOGIT_TOL = 5e-2
#: A tp stream's token against one device's row on the same prefix: the
#: largest allowed gap below that row's max, over max |logit|.  A tp row
#: within MESH_LOGIT_TOL of one device's, element by element, can choose
#: any token within twice that of one device's best.
MESH_TOKEN_TOL = 2 * MESH_LOGIT_TOL


def solo_choices(base, clips) -> tuple[list[list[int]], "object"]:
    """Each clip's greedy ``transcribe`` on ``base`` (B = 1, eager under
    :class:`Choices`) and the gaps of its choices, as one (choices, 2,
    len(clips)) tensor (positions past a lane's stream padded with a gap
    of 1 x max |logit|)."""
    import torch

    streams, per = [], []
    for clip in clips:
        with Choices() as rec:
            streams.append(_ids([base.transcribe(clip, max_tokens=64)])[0])
        per.append(top_two_gaps(rec.rows))
    n = max(g.shape[0] for g in per)
    gaps = torch.ones((n, 2, len(clips)))
    for b, g in enumerate(per):
        gaps[: g.shape[0], :, b] = g[:, :, 0]
    return streams, gaps


def replicated_phase(card: str, base) -> dict:
    """``ReplicatedTranscriptionServer`` over ``max(2, device_count())``
    replicas of ``ModelConfig()`` from random weights (seed 0,
    ``speculative="off"``): two on ``cuda:0`` on a one-card machine (each
    capturing its decode graphs while the other's kernels run), one a card
    otherwise.  :data:`REPLICATED_REQUESTS` requests of the smoke clips
    submitted at once (``max_tokens=64``); every result held to the solo
    model's ``transcribe`` of its clip (``base``, the same weights) by the
    near-tie rule; every replica served a batch; K1 and K2 launched.
    Printed: wall time and RTFx of the server and of the solo model's
    ``transcribe`` of the same requests one by one, batches per replica,
    peak memory.  On one card the two replicas share it, so the ratio is an
    observation, not a scaling claim."""
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, ReplicatedTranscriptionServer
    from qwen3_asr_tpu_torch import RuntimeConfig
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    clips = smoke_clips()
    requests = [clips[i % len(clips)] for i in range(REPLICATED_REQUESTS)]
    audio_s = sum(len(c) for c in requests) / 16000.0
    streams, gaps = solo_choices(base, clips)
    for clip in clips:                      # captures each clip's bucket
        base.transcribe(clip, max_tokens=64)
    t0 = time.perf_counter()
    for clip in requests:
        base.transcribe(clip, max_tokens=64)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0

    n_cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", 0)] * 2 if n_cards == 1
               else [torch.device("cuda", i) for i in range(n_cards)])

    def factory():
        return Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                    runtime=RuntimeConfig(speculative="off"),
                                    dtype=torch.bfloat16, seed=SEED,
                                    device=torch.device("cuda", torch.cuda.current_device()))

    for d in sorted({d.index for d in devices}):
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    srv = ReplicatedTranscriptionServer(factory, devices=devices)
    build_s = time.perf_counter() - t0
    solo = [streams[i % len(clips)] for i in range(REPLICATED_REQUESTS)]
    lane_gaps = gaps[:, :, [i % len(clips) for i in range(REPLICATED_REQUESTS)]]
    walls = []
    try:
        # Round 1 captures the replicas' graphs as the batches come; round 2
        # replays them where its batches fall in the same buckets.
        for rnd in (1, 2):
            LAUNCHES.clear()
            t0 = time.perf_counter()
            futures = [srv.submit(c, max_tokens=64) for c in requests]
            results = [f.result(timeout=900) for f in futures]
            walls.append(time.perf_counter() - t0)
            launches = dict(LAUNCHES)
            ids = _ids(results)
            label = f"replicated server round {rnd}"
            check_ids(label, ids, base._config.text_decoder.vocab_size)
            check_launches(label, launches, BF16_PATH,
                           ("kv_write_span_batch",) + STANDALONE_WRITERS)
            compare_streams(f"{label} vs solo transcribe", solo, ids, lane_gaps)
        captures = [m._generator.graphs.captures if m._generator.graphs else 0
                    for m in srv.models]
    finally:
        srv.close()
        for m in srv.models:
            m.close()
    if srv.stats.requests != 2 * REPLICATED_REQUESTS or srv.stats.failures:
        raise AssertionError(f"replicated server: stats {srv.stats}")
    if not all(n > 0 for n in srv.replica_batches):
        raise AssertionError(f"replicated server: a replica served no batch "
                             f"({srv.replica_batches})")
    peaks = {d: torch.cuda.max_memory_allocated(d) / 2**30 for d in sorted({d.index for d in devices})}
    where = ", ".join(str(d) for d in devices)
    cold_s, wall_s = walls
    print(f"replicated server [{card}]: {len(devices)} replicas on {where}, built in "
          f"{build_s:.2f} s; {REPLICATED_REQUESTS} requests ({audio_s:.1f} s of audio) in "
          f"{wall_s:.3f} s = RTFx {audio_s / wall_s:.1f} (round 1, capturing: {cold_s:.3f} s "
          f"= RTFx {audio_s / cold_s:.1f}); the solo model's transcribe of the same requests "
          f"one by one {solo_s:.3f} s = RTFx {audio_s / solo_s:.1f} (solo / server "
          f"{solo_s / wall_s:.2f}); batches per replica {srv.replica_batches}, "
          f"mean batch {srv.stats.mean_batch_size:.2f}; graph captures per replica "
          f"{captures}; peak memory GiB by card {peaks}")
    return launches


#: The kernels each tp runtime's decode loop launches (in its graph).
TP_DECODE_KERNELS = {"off": ("decode_attention", "kv_write_rows_fused"),
                     "default": ("kv_write_span_batch",),
                     "int8": ("decode_attention_q8", "kv_write_rows_q8_fused",
                              "quantized_matmul")}


def loop_runs(model, clips, device, runs) -> dict:
    """``model.transcribe_batch(clips, max_tokens=64)`` once for each (name,
    eager) of ``runs``, the decode loop graphed or eager
    (``decode(eager=True)``); per run the ids, the decode's ms, live steps,
    steps run and looks at ``done``, the wall, and the kernel launches and
    collectives counted from the decode call's start (a replay adds its
    capture's).  Also the graphs' captures and last capture ms, and the
    peak memory over the runs."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.parallel import collectives

    gen = model._generator
    real = gen.decode

    def counted(eager, *args, **kwargs):
        collectives.TRAFFIC.clear()
        LAUNCHES.clear()
        return real(*args, eager=eager, **kwargs)

    out = {}
    torch.cuda.reset_peak_memory_stats(device)
    try:
        for name, eager in runs:
            gen.decode = functools.partial(counted, eager)
            t0 = time.perf_counter()
            ids = _ids(model.transcribe_batch(clips, max_tokens=64))
            torch.cuda.synchronize(device)
            st = model.last_stats
            out[name] = dict(ids=ids, wall_s=time.perf_counter() - t0,
                             decode_ms=st.stages["decode"] * 1e3, steps=st.n_decode_steps,
                             replays=st.n_decode_replays, syncs=st.n_host_syncs,
                             traffic=dict(collectives.TRAFFIC), launches=dict(LAUNCHES))
    finally:
        del gen.decode
    out["captures"] = gen.graphs.captures if gen.graphs else 0
    out["capture_ms"] = gen.graphs.last_capture_ms if gen.graphs else 0.0
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def hold_loops(label: str, card: str, loops: dict, want=()) -> list[list[int]]:
    """The graphed loop of :func:`loop_runs` against its eager run: ids bit
    for bit (and the capturing run's, when there is one), a capture made,
    each replay's collectives equal to one eager step's (the eager loop runs
    one step a look), the kernels ``want`` launched graphed.  Prints both
    ms per iteration, replays, looks at ``done``, collectives a step and
    peak memory beside ``card``; returns the graphed ids."""
    g, e = loops["graphed"], loops["eager"]
    ids = [r["ids"] for r in (loops.get("capture", g), g, e)]
    if not ids[0] == ids[1] == ids[2]:
        raise AssertionError(f"{label}: the graphed loop's ids differ from the eager loop's")
    if loops["captures"] < 1:
        raise AssertionError(f"{label}: no decode graph was captured")
    per_replay = {k: v / max(g["replays"], 1) for k, v in g["traffic"].items()}
    per_step = {k: v / max(e["replays"], 1) for k, v in e["traffic"].items()}
    if per_replay != per_step or not per_step.get("all_reduce"):
        raise AssertionError(f"{label}: collectives a replay {per_replay} against an eager "
                             f"step's {per_step}")
    missing = [k for k in want if not g["launches"].get(k)]
    if missing:
        raise AssertionError(f"{label}: the graphed loop launched no {missing}")
    graphed_ms = g["decode_ms"] / max(g["steps"], 1)
    eager_ms = e["decode_ms"] / max(e["steps"], 1)
    print(f"{label} [{card}]: graphed ids bit-identical to the eager loop's; decode "
          f"{graphed_ms:.3f} ms/iteration graphed ({g['steps']} live iterations, "
          f"{g['replays']} replays, {g['syncs']} looks at done; {loops['captures']} "
          f"capture(s), the last {loops['capture_ms']:.1f} ms) against {eager_ms:.3f} eager "
          f"({eager_ms / graphed_ms:.2f}x; {e['steps']} steps, {e['syncs']} looks); a replay "
          f"{per_replay.get('all_reduce', 0):g} all-reduces "
          f"({per_replay.get('all_reduce bytes', 0) / 1024:.1f} KiB) and "
          f"{per_replay.get('all_gather', 0):g} all-gathers "
          f"({per_replay.get('all_gather bytes', 0) / 1024:.1f} KiB) as an eager step; "
          f"transcribe_batch wall {g['wall_s']:.3f} s graphed, {e['wall_s']:.3f} s eager; "
          f"peak memory {loops['peak_gib']:.2f} GiB; launches a replay "
          + ", ".join(f"{k} {g['launches'].get(k, 0) / max(g['replays'], 1):g}" for k in want))
    return g["ids"]


def mesh_rank(rank: int, dp: int, tp: int, workdir: str, backend: str, runtimes: dict,
              refs: dict, serve: dict) -> None:
    """One rank of :func:`mesh_phase` (a spawned process): joins the group,
    builds ``ModelConfig()`` from random weights (seed 0) on its card under
    each of ``runtimes`` with ``(dp, tp)``, and ``transcribe_batch``es the
    smoke clips (``max_tokens=64``); saves per runtime the ids, the
    prefill logits, the launches, the decode stats and the peak memory.
    Where that run captured decode graphs on a tp group (NCCL), the graphed
    and the eager loop then run the same clips (:func:`loop_runs`).
    For a runtime in ``refs`` (per dp coordinate, the path of one device's
    streams and logits rows of that slice, :func:`mesh_reference`) it then
    runs :func:`forced_run`; for a runtime in ``serve``, the servers' runs
    named there on the same model (:func:`mesh_serving_rank`)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig, parallel
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    parallel.initialize(num_processes=dp * tp, process_id=rank, backend=backend,
                        init_method=f"file://{workdir}/init")
    out = {}
    clips = smoke_clips()
    for name, runtime in runtimes.items():
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        model = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                     runtime=RuntimeConfig(**runtime, dp=dp, tp=tp),
                                     dtype=torch.bfloat16, seed=SEED, device=device)
        torch.cuda.synchronize(device)
        build_s = time.perf_counter() - t0
        logits = []
        gen = model._generator
        real = gen.decode
        gen.decode = lambda kv, fl, *a, **k: logits.append(fl.float().cpu()) or real(kv, fl, *a, **k)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        results = model.transcribe_batch(clips, max_tokens=64)
        torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
        del gen.decode
        st = model.last_stats if logits else None
        graphed = gen.graphs is not None and gen.graphs.captures > 0
        out[name] = dict(
            ids=_ids(results), logits=logits, launches=dict(LAUNCHES), wall_s=wall_s,
            build_s=build_s, peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
            decode_ms=st.stages["decode"] * 1e3 if st else 0.0,
            steps=st.n_decode_steps if st else 0, tokens=st.n_generated_tokens if st else 0,
            graphs=graphed,
        )
        if graphed and tp > 1:
            # The first run captured: the graphed loop again, then the eager
            # loop (its oracle) on the same clips.
            out[name]["loops"] = loop_runs(model, clips, device, (("graphed", False),
                                                                  ("eager", True)))
        if name in refs:
            lo, hi = dp_slices(len(clips), dp)[rank // tp]
            out[name]["forced"] = forced_run(model, clips, refs[name][rank // tp], lo, hi)
        if name in serve:
            out[name]["serving"] = mesh_serving_rank(model, device, serve[name])
        model.close()
        del model, gen
        torch.cuda.empty_cache()
    out["topology"] = parallel.topology()
    out["device"] = str(device)
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def forced_run(model, clips, ref_path: str, lo: int, hi: int) -> dict:
    """``model``'s greedy ``transcribe_batch`` of ``clips`` forced along one
    device's streams (:class:`Choices` ``forced``; the eager loop), so that
    both see the same prefix at every position: each of its logits rows
    (row 0 the prefill's, the later ones after the repetition penalty) held
    to one device's row at every live position of every lane of this
    rank's dp slice ``clips[lo:hi]``.  Returns the forced run's ids of the
    slice, the worst max |difference| over max |logit| of one device's
    row, its (position, lane), and the rows compared."""
    import torch

    ref = torch.load(ref_path, weights_only=False)
    streams, rows = ref["streams"], ref["rows"]
    with Choices(forced=padded(streams)) as rec:
        ids = _ids(model.transcribe_batch(clips, max_tokens=64))[lo:hi]
    worst, at, compared = 0.0, (0, 0), 0
    for j, row in enumerate(rec.rows[: rows.shape[0]]):
        row = row.float().cpu()
        for b, stream in enumerate(streams):
            if j < len(stream):
                want = rows[j, b]
                rel = ((row[b] - want).abs().max() / want.abs().max()).item()
                compared += 1
                if rel > worst:
                    worst, at = rel, (j, b)
    return dict(ids=ids, worst=worst, at=at, compared=compared)


def run_mesh(dp: int, tp: int, backend: str, runtimes: dict, refs: dict,
             serve: dict) -> list[dict]:
    """Spawn the ``dp * tp`` ranks of :func:`mesh_rank`; each rank's saved
    result."""
    return spawn_ranks(mesh_rank, dp, tp, f"mesh_{dp}x{tp}", backend, runtimes, refs, serve)


#: The continuous servers of :func:`mesh_serving_phase` on a tp group, named
#: as in :data:`SERVER_PATHS`: (label, spec_engine, paged).
MESH_SERVER_RUNS = (("paged, spec_engine off", "off", True),
                    ("paged, spec_engine auto", "auto", True),
                    ("flat, spec_engine off", "off", False))
#: The continuous server's page pool on a mesh, the whole group's (each tp
#: rank holds 1/tp of it): bounded, since a gloo mesh's ranks share a card.
MESH_POOL_GB = 2.0
#: The drain server's requests on a mesh: the smoke clips of 18-30 s, one
#: frame bucket, so one batch.
DRAIN_CLIPS = slice(4, 8)
#: Each mesh serving request's token budget: the first 32 tokens of one
#: device's 64-token plain streams are the streams it is held to.
MESH_SERVE_TOKENS = 32


def mesh_serving_rank(model, device, runs) -> dict:
    """One rank's part of :func:`mesh_serving_phase` on ``model``: the
    continuous servers of :data:`MESH_SERVER_RUNS` (``"continuous"`` in
    ``runs``) and the drain server (``"drain"``); the seconds they took."""
    out = {}
    t0 = time.perf_counter()
    if "continuous" in runs:
        rt = model._generator.runtime
        saved = rt.spec_engine
        for label, spec, paged in MESH_SERVER_RUNS:
            rt.spec_engine = spec
            out[label] = mesh_server_run(model, device, paged)
        rt.spec_engine = saved
    if "drain" in runs:
        out["drain"] = mesh_drain_run(model, device)
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_server_run(model, device, paged: bool) -> dict:
    """``ContinuousTranscriptionServer(n_slots=8, chunk_steps=16)`` on this
    rank of a tp group, every rank constructing it: on the driving rank the
    smoke clips in two waves (the second once the first chunk ran, greedy,
    :data:`MESH_SERVE_TOKENS`-token budgets), their ids and TTFTs; on every
    rank the launches
    (counters set to 0 just before the first submit, read after close),
    the engine counters, the chunks' seconds, the pool and peak memory."""
    import dataclasses

    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    clips = smoke_clips()
    srv = ContinuousTranscriptionServer(model, n_slots=8, max_duration=30.0,
                                        max_new_tokens=512, chunk_steps=16, paged=paged,
                                        kv_pool_gb=MESH_POOL_GB)
    engine = srv._engine
    step_s, real_step = [], engine.step

    def timed(k_steps=None):            # a chunk ends in its status fetch
        t0 = time.perf_counter()
        real_step(k_steps)
        step_s.append(time.perf_counter() - t0)

    engine.step = timed
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = {}
    LAUNCHES.clear()
    t0 = time.perf_counter()
    if srv.driving:
        futs = [srv.submit(c, max_tokens=MESH_SERVE_TOKENS) for c in clips[:4]]
        deadline = time.time() + 300
        while engine.stats.chunks < 1 and time.time() < deadline:
            time.sleep(0.002)
        futs += [srv.submit(c, max_tokens=MESH_SERVE_TOKENS) for c in clips[4:]]
        out["ids"] = _ids([f.result(timeout=600) for f in futs])
        out["ttft_s"] = [getattr(f, "ttft_s", None) for f in futs]
    srv.close()
    out.update(
        wall_s=time.perf_counter() - t0, launches=dict(LAUNCHES),
        stats=dataclasses.asdict(engine.stats), step_s=sum(step_s),
        pool_gib=2 * sum(t.numel() * t.element_size() for t in (
            engine._keys.values() if isinstance(engine._keys, dict) else [engine._keys]))
        / 2**30,
        shape=(f"{engine.n_pages} pages of {engine.page_size} rows" if paged else
               f"{engine.n_slots} slots x {engine.cache_len} rows"),
        peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
        failures=srv.stats.failures, fault=repr(srv._fault),
    )
    return out


def mesh_drain_run(model, device) -> dict:
    """``TranscriptionServer`` on the mesh, every rank constructing it: the
    smoke clips of :data:`DRAIN_CLIPS` (one frame bucket) submitted at once
    on global rank 0 (``max_tokens=MESH_SERVE_TOKENS``), their ids; the
    launches and batches on every rank."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.serving import TranscriptionServer

    srv = TranscriptionServer(model, max_batch_size=8, batch_window_ms=2000)
    out = {}
    torch.cuda.synchronize(device)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    if srv.driving:
        out["ids"] = _ids([f.result(timeout=600) for f in
                           [srv.submit(c, max_tokens=MESH_SERVE_TOKENS)
                            for c in smoke_clips()[DRAIN_CLIPS]]])
    srv.close()
    out.update(wall_s=time.perf_counter() - t0, launches=dict(LAUNCHES),
               batches=srv.stats.batches, failures=srv.stats.failures)
    return out


def hold_forced(label: str, base, clips, streams, max_tokens: int) -> None:
    """Every token of ``streams`` (one per clip, from a run on a tp mesh)
    held to one device's plain step on the same prefix: ``base``'s plain
    loop forced along the streams (:class:`Choices`), then each token's
    penalized logit within MESH_TOKEN_TOL x max |logit| of its row's max.
    Unlike :func:`compare_streams`, this holds every token, not only a
    lane's first divergence.  Prints how many tokens of a row lie within
    the limit on average (the check's reach), and how many chosen tokens
    lie past NEAR_TIE."""
    import torch

    with Choices(forced=padded(streams)) as plain:
        forced = _ids(base.transcribe_batch(clips, max_tokens=max_tokens))
    if any(got[: len(s)] != s for got, s in zip(forced, streams)):
        raise AssertionError(f"{label}: the forced plain run left the streams")
    n = max(len(s) for s in streams)
    if len(plain.rows) < n:
        raise AssertionError(f"{label}: {len(plain.rows)} rows for {n} tokens")
    tokens, lens = padded(streams)
    with torch.inference_mode():
        rows = torch.stack(plain.rows[:n])[:, : len(streams)].float()   # (n, B, V)
        top, scale = rows.amax(-1), rows.abs().amax(-1)
        gap = (top - rows.gather(2, tokens.t()[:, :, None])[..., 0]) / scale
        within = (rows >= (top - MESH_TOKEN_TOL * scale)[..., None]).sum(-1).float()
        live = torch.arange(n, device="cuda")[:, None] < lens[None, :]
        gap, within = gap[live].cpu(), within[live].cpu()
    worst = int(gap.argmax())
    print(f"{label}: {gap.numel()} tokens held to one device's forced plain step: "
          f"{int((gap > 0).sum())} apart from its argmax, {int((gap > NEAR_TIE).sum())} past "
          f"{NEAR_TIE:g}, top gap to the chosen token up to {gap.max().item():.2e} of max "
          f"|logit| (limit {MESH_TOKEN_TOL:g}); {within.mean().item():.2f} tokens a row "
          f"within the limit on average")
    if gap[worst] > MESH_TOKEN_TOL:
        raise AssertionError(f"{label}: a token {gap[worst].item():.2e} of max |logit| below "
                             f"one device's best choice on the same prefix")


def mesh_serving_phase(card: str, label: str, dp: int, tp: int, ranks: list[dict], base,
                       one_device: dict) -> float:
    """The servers on a mesh, from :func:`mesh_phase`'s spawned ranks
    (:func:`mesh_serving_rank`), held to one device (``base``, the same
    weights, ``"off"``).  On a tp group the continuous server of each
    :data:`MESH_SERVER_RUNS` entry: its driving rank's streams held to one
    device's plain streams (``one_device``: streams and gaps) by the
    near-tie rule and every token by :func:`hold_forced`, each rank
    launching its :data:`SERVER_PATHS` kernels (K6/K7 with K8 fused, or K2
    with K3 fused; no standalone writer), the ranks' launches and engine
    counters equal, a mid-decode admission, the pool within
    :data:`MESH_POOL_GB`.  The drain server's one batch: on a tp group held
    to one device's ``transcribe_batch`` of the same batch by both rules;
    on (2, 1) bit-identical to one device's ``transcribe_batch`` of each
    dp slice.  Prints ms per chunk iteration, each request's TTFT and
    every rank's peak memory; returns the seconds the ranks spent
    serving."""
    import torch

    n, vocab = MESH_SERVE_TOKENS, base._config.text_decoder.vocab_size
    clips = smoke_clips()
    one_device = {"streams": [s[:n] for s in one_device["streams"]],
                  "gaps": one_device["gaps"][:n]}
    for name in ("default", "off"):
        serving = [r[name].get("serving") for r in ranks if name in r]
        if not serving or serving[0] is None:
            continue
        for run, _, _ in MESH_SERVER_RUNS:
            if run not in serving[0]:
                continue
            got = [s[run] for s in serving]
            head = f"{label} continuous server {run}"
            path, never = SERVER_PATHS[run][2:]
            for r, g in enumerate(got):
                check_launches(f"{head} rank {r}", g["launches"], path, never)
                if g["fault"] != "None" or g["failures"]:
                    raise AssertionError(f"{head} rank {r}: fault {g['fault']}, "
                                         f"{g['failures']} failures")
                if g["pool_gib"] > MESH_POOL_GB / tp + 1e-6:
                    raise AssertionError(f"{head} rank {r}: a {g['pool_gib']:.2f} GiB pool")
            if any(g["launches"] != got[0]["launches"] or g["stats"] != got[0]["stats"]
                   for g in got):
                raise AssertionError(f"{head}: the ranks' launches or engine counters differ")
            st = got[0]["stats"]
            if st["mid_decode_admissions"] < 1:
                raise AssertionError(f"{head}: no mid-decode admission")
            ids = got[0]["ids"]
            check_ids(head, ids, vocab)
            if any(t is None for t in got[0]["ttft_s"]):
                raise AssertionError(f"{head}: a request has no ttft_s")
            for r, g in enumerate(got):
                print(f"{head} rank {r} [{card}]: {g['shape']} ({g['pool_gib']:.2f} GiB K+V "
                      f"a rank), {g['wall_s']:.2f} s wall for 8 requests, {st['chunks']} "
                      f"chunks, {st['iterations']} iterations, "
                      f"{g['step_s'] * 1e3 / max(st['iterations'], 1):.2f} ms per chunk "
                      f"iteration; {st['mid_decode_admissions']} mid-decode admissions; peak "
                      f"memory {g['peak_gib']:.2f} GiB; launches and engine counters equal "
                      f"across ranks")
            print(f"{head} ttft_s {[round(t, 3) for t in got[0]['ttft_s']]}")
            compare_streams(f"{head} vs one device", one_device["streams"], ids,
                            one_device["gaps"])
            hold_forced(f"{head} forced", base, clips, ids, n)
        drain = [s["drain"] for s in serving if "drain" in s]
        if drain:
            head = f"{label} drain server"
            for r, g in enumerate(drain):
                check_launches(f"{head} rank {r}", g["launches"],
                               ("flash_attention_causal", "decode_attention"),
                               ("kv_write_span_batch",) + STANDALONE_WRITERS)
            if drain[0]["batches"] != 1 or drain[0]["failures"]:
                raise AssertionError(f"{head}: {drain[0]['batches']} batches, "
                                     f"{drain[0]['failures']} failures")
            ids = drain[0]["ids"]
            check_ids(head, ids, vocab)
            print(f"{head} [{card}]: {len(ids)} requests in one batch, "
                  f"{drain[0]['wall_s']:.2f} s wall")
            batch = clips[DRAIN_CLIPS]
            if tp == 1:
                want = [seq for lo, hi in dp_slices(len(batch), dp)
                        for seq in _ids(base.transcribe_batch(batch[lo:hi], max_tokens=n))]
                if ids != want:
                    raise AssertionError(f"{head}: not bit-identical to one device's "
                                         f"transcribe_batch of each dp slice")
                print(f"{head}: each dp slice bit-identical to one device's "
                      f"transcribe_batch of it")
            else:
                with Choices() as rec:
                    want = _ids(base.transcribe_batch(batch, max_tokens=n))
                compare_streams(f"{head} vs one device's batch", want, ids,
                                top_two_gaps(rec.rows))
                hold_forced(f"{head} forced", base, batch, ids, n)
            torch.cuda.empty_cache()
    seconds = max(r[name]["serving"]["seconds"] for r in ranks for name in ("default", "off")
                  if name in r and "serving" in r[name])
    print(f"mesh serving phase at (dp={dp}, tp={tp}) [{card}]: {seconds:.1f} s in the ranks")
    return seconds


def spawn_ranks(target, dp: int, tp: int, name: str, *args) -> list[dict]:
    """Spawn ``target(rank, dp, tp, workdir, *args)`` in ``dp * tp``
    processes, ``workdir`` = ``build/<name>``; each rank's saved result
    (``workdir/rank<r>.pt``).  A rank that exits non-zero or outlives
    :data:`MESH_TIMEOUT` raises."""
    import multiprocessing as mp
    import shutil

    import torch

    workdir = ROOT / "build" / name
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, dp, tp, str(workdir), *args))
             for r in range(dp * tp)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise AssertionError(f"{name} ({dp}, {tp}) rank {r} outlived {MESH_TIMEOUT} s")
            if p.exitcode != 0:
                raise AssertionError(f"{name} ({dp}, {tp}) rank {r} exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(dp * tp)]


def dp_slices(n: int, dp: int) -> list[tuple[int, int]]:
    """The ``[lo, hi)`` of each dp coordinate's clips, as
    ``Qwen3ASR.transcribe_batch`` splits ``n`` of them."""
    per, extra = divmod(n, dp)
    return [(d * per + min(d, extra), (d + 1) * per + min(d + 1, extra)) for d in range(dp)]


def one_device_refs(model, clips, dp: int, name: str) -> dict:
    """One device's references for a mesh of ``dp`` slices of ``clips``: per
    slice the file of :func:`mesh_reference` and the prefill logits, and
    the slices' streams and gaps joined in lane order (a slice is decoded
    as a batch of its own, as a dp coordinate decodes it)."""
    import torch

    paths, logits, streams, gaps = [], [], [], []
    for d, (lo, hi) in enumerate(dp_slices(len(clips), dp)):
        path = ROOT / "build" / "mesh_refs" / f"{name}_dp{dp}_{d}.pt"
        got, g = mesh_reference(model, clips[lo:hi], path)
        paths.append(str(path))
        streams += got
        gaps.append(g)
        logits.append(prefill_logits(model, clips[lo:hi]))
    joined = torch.ones((max(g.shape[0] for g in gaps), 2, len(streams)))
    b = 0
    for g in gaps:
        joined[: g.shape[0], :, b : b + g.shape[2]] = g
        b += g.shape[2]
    return dict(paths=paths, logits=logits, streams=streams, gaps=joined)


def mesh_reference(model, clips, path: Path):
    """One device's greedy ``transcribe_batch`` of ``clips`` through the
    eager loop (:class:`Choices`): its streams and every step's (B, V)
    logits row saved to ``path`` for the ranks' :func:`forced_run`; returns
    the streams and the gaps of their choices (:func:`top_two_gaps`)."""
    import torch

    with Choices() as rec:
        streams = _ids(model.transcribe_batch(clips, max_tokens=64))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"streams": streams, "rows": torch.stack([r.float().cpu() for r in rec.rows])},
               path)
    return streams, top_two_gaps(rec.rows)


class _Stop(Exception):
    pass


def prefill_logits(model, clips):
    """The f32 prefill logits (B, V) of ``model.transcribe_batch(clips)``,
    stopping before the decode."""
    got = []
    gen = model._generator

    def stop(kv, first_logits, *args, **kwargs):
        got.append(first_logits.float().cpu())
        raise _Stop

    gen.decode = stop
    try:
        model.transcribe_batch(clips, max_tokens=64)
    except _Stop:
        pass
    finally:
        del gen.decode
    return got[0]


class SplitRowParallel:
    """While active, one device computes each row-parallel product (the
    decoder's wo and wd, the encoder's wo, fc2 and proj2) as a tp = 2 group
    does: two K-halves, each an f32 partial (W8A8 against the whole row's
    scales, K9, or a bf16 product with an f32 result), summed in f32 and
    rounded once.  The (1, 2) mesh's arithmetic without its collectives:
    its column-parallel W8A8 products are exact integer sums either way."""

    def __enter__(self):
        import torch

        from qwen3_asr_tpu_torch.models import decoder, encoder
        from qwen3_asr_tpu_torch.ops import quant
        from qwen3_asr_tpu_torch.ops.kernels import w8a8_matmul as w8

        self.modules, self.real = (decoder, encoder), quant.qlinear_row_parallel

        def half(w, i: int, k: int):
            if quant.is_quantized(w):
                return {"q": w["q"][i * k:(i + 1) * k].t().contiguous().t(), "s": w["s"]}
            return w[i * k:(i + 1) * k]

        def split(x, w, tp):
            if tp is not None:
                return self.real(x, w, tp)
            lead, K = x.shape[:-1], x.shape[-1]
            x2, k = x.reshape(-1, K).contiguous(), K // 2
            min_rows = quant._ACT_QUANT_MIN_ROWS.get()
            w8a8 = quant.is_quantized(w) and min_rows is not None and x2.shape[0] >= min_rows
            scales = w8.activation_scales(x2) if w8a8 else None
            total = None
            for i in (0, 1):
                xi, wi = x2[:, i * k:(i + 1) * k].contiguous(), half(w, i, k)
                part = (w8.w8a8_matmul(xi, wi["q"], wi["s"], torch.float32, row_scales=scales)
                        if w8a8 else quant._partial_f32(xi, wi, None))
                total = part if total is None else total + part
            return total.to(x.dtype).reshape(*lead, total.shape[-1])

        for module in self.modules:
            module.qlinear_row_parallel = split
        return self

    def __exit__(self, *exc):
        for module in self.modules:
            module.qlinear_row_parallel = self.real


def bf16_floor(base, clips) -> float:
    """max |bf16 - f32| / max |f32 logit| of one device's prefill logits of
    ``clips`` at full depth: ``base`` (bf16 weights and kernels) against
    ``ModelConfig()`` from the same seed in float32 on the card (the plain
    causal prefill, since K1 takes bf16 only; TF32 off)."""
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.models import decoder as dec_mod

    saved = (dec_mod.PREFILL_FLASH_ENABLED, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    dec_mod.PREFILL_FLASH_ENABLED = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ref = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                               runtime=RuntimeConfig(speculative="off"), dtype=torch.float32,
                               seed=SEED, device=torch.device("cuda"))
    try:
        f32 = prefill_logits(ref, clips)
    finally:
        (dec_mod.PREFILL_FLASH_ENABLED, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
        ref.close()
        del ref
        torch.cuda.empty_cache()
    got = prefill_logits(base, clips)
    return ((got - f32).abs().max() / f32.abs().max()).item()


def mesh_phase(card: str, base, off: dict, int8, meshes=None, serving: bool = True) -> dict:
    """``transcribe_batch`` of the smoke clips (``max_tokens=64``) on (dp, tp)
    meshes of spawned ranks, each on a card, each holding ``ModelConfig()``
    from random weights (seed 0; its tp shards).  With fewer cards than
    ranks, the ranks share ``cuda:0`` over gloo (CUDA tensors through host
    memory); with enough cards, NCCL, one rank a card.

      * (1, 2), ``speculative="off"``, the default, and the int8 runtime
        (int8 weights, W8A8 prefill with the row-parallel products' scales
        all-reduced, int8 cache): every rank's streams equal, held to one
        device's streams (``base``'s plain ones; ``int8``'s under
        :class:`SplitRowParallel`, since re-quantizing the next product's
        input amplifies a rounding difference) by the near-tie rule; the
        prefill logits within :data:`MESH_LOGIT_TOL` of max |logit| of one
        device's; for "off" and int8 a second run forced along one
        device's streams (:func:`forced_run`), every step's logits row
        within :data:`MESH_LOGIT_TOL` of one device's;
        K1 and K2 (off), K5 (default), K4, K9, K10 and its row-scaled
        entry (int8) launched in every rank; ms per decode iteration, eager
        over gloo, graphed over NCCL (each tp step's collectives captured in
        its graph), where every rank also runs the eager loop on the same
        clips and its graphed ids must equal it bit for bit
        (:func:`hold_loops`);
      * (2, 1), ``speculative="off"``: each dp slice bit-identical to
        ``base``'s ``transcribe_batch`` of the same slice, the whole list
        in every rank;
      * (2, 2) with four cards: as (1, 2);
      * the servers on (1, 2) and (2, 1) (:func:`mesh_serving_phase`, in
        the same ranks after their ``transcribe_batch`` runs): on (1, 2) the
        continuous server (paged under ``spec_engine`` off and auto, flat),
        every rank constructing it and rank 0 submitting, and the drain
        server on both meshes.

    Before the meshes, one device's bf16 prefill logits against float32
    (:func:`bf16_floor`), the floor the tp logits are read against, and
    the int8 model's with its row-parallel products split against whole.  Every
    rank's peak memory is printed.  ``meshes`` (default :data:`MESHES`, and
    (2, 2) with four cards) and ``serving=False`` cut the phase to the
    meshes named, without the servers (``--tp-graphs``).  Returns the
    launches of (1, 2)'s rank 0 under each runtime."""
    import torch

    n_cards = torch.cuda.device_count()
    clips = smoke_clips()
    plain = off["ids"][0]
    floor = bf16_floor(base, clips)
    print(f"one device, bf16 against float32 (the same weights before rounding) [{card}]: "
          f"prefill logits max abs err / max |logit| = {floor:.3e} at full depth (28 layers)")
    whole = prefill_logits(int8, clips)
    with SplitRowParallel():
        split = prefill_logits(int8, clips)
    split_rel = ((split - whole).abs().max() / whole.abs().max()).item()
    print(f"one device, int8 (W8A8 prefill), its row-parallel products as two K-halves "
          f"summed in f32 against whole [{card}]: prefill logits max abs err / max |logit| = "
          f"{split_rel:.3e} (the int8 arm's rounding floor; the int8 mesh is held to the split)")
    sliced = [_ids(base.transcribe_batch(clips[lo:hi], max_tokens=64))
              for lo, hi in dp_slices(len(clips), 2)]
    refs_by_dp = {}

    def refs_for(dp: int) -> dict:
        """One device's references by runtime for a tp mesh of ``dp`` slices."""
        if dp not in refs_by_dp:
            off_refs = one_device_refs(base, clips, dp, "off")
            with SplitRowParallel():
                int8_refs = one_device_refs(int8, clips, dp, "int8")
            refs_by_dp[dp] = {"off": off_refs, "default": off_refs, "int8": int8_refs}
        return refs_by_dp[dp]

    if refs_for(1)["off"]["streams"] != plain:
        raise AssertionError("one device's eager streams differ from its graphed ones")
    if meshes is None:
        meshes = MESHES + (((2, 2),) if n_cards >= 4 else ())
    first, serving_s = {}, 0.0
    for dp, tp in meshes:
        backend = "nccl" if n_cards >= dp * tp else "gloo"
        runtimes = {"off": {"speculative": "off"}}
        if tp > 1:
            runtimes.update(default={}, int8=dict(INT8_RUNTIME))
        t0 = time.perf_counter()
        refs = refs_for(dp) if tp > 1 else {}
        serve = ({"default": ("continuous",), "off": ("drain",)} if tp > 1 else
                 {"off": ("drain",)}) if serving and (dp, tp) in MESHES else {}
        ranks = run_mesh(dp, tp, backend, runtimes,
                         {k: refs[k]["paths"] for k in ("off", "int8")} if tp > 1 else {},
                         serve)
        label = f"mesh (dp={dp}, tp={tp}) over {backend} on " + ", ".join(
            sorted({r['device'] for r in ranks}))
        print(f"{label}: {dp * tp} ranks ran in {time.perf_counter() - t0:.1f} s "
              f"(spawn, CUDA init, builds and runs)")
        for name in runtimes:
            ids = [r[name]["ids"] for r in ranks]
            if any(i != ids[0] for i in ids):
                raise AssertionError(f"{label} {name}: the ranks' results differ")
            check_ids(f"{label} {name}", ids[0], base._config.text_decoder.vocab_size)
            if tp == 1:
                if ids[0] != sliced[0] + sliced[1]:
                    raise AssertionError(f"{label} {name}: not bit-identical to one device's "
                                         f"transcribe_batch of each slice")
                print(f"{label} {name}: each dp slice bit-identical to one device's "
                      f"transcribe_batch of it; every rank holds all {len(ids[0])} results")
            else:
                streams, lane_gaps = refs[name]["streams"], refs[name]["gaps"]
                compare_streams(f"{label} {name} vs one device", streams, ids[0], lane_gaps)
                for r, res in enumerate(ranks):
                    d = r // tp
                    got, ref = res[name]["logits"][0], refs[name]["logits"][d]
                    rel = ((got - ref).abs().max() / ref.abs().max()).item()
                    print(f"{label} {name} rank {r}: prefill logits vs one device's: max abs "
                          f"err / max |logit| = {rel:.3e} (limit {MESH_LOGIT_TOL:g}; one "
                          f"device's bf16 vs f32 {floor:.3e})")
                    if not rel < MESH_LOGIT_TOL:
                        raise AssertionError(f"{label} {name}: prefill logits {rel:.3e} apart")
                    forced = res[name].get("forced")
                    if forced is None:
                        continue
                    lo, hi = dp_slices(len(clips), dp)[d]
                    if forced["ids"] != streams[lo:hi]:
                        raise AssertionError(f"{label} {name} rank {r}: the forced run did "
                                             f"not emit one device's streams")
                    print(f"{label} {name} rank {r}: forced along one device's streams, "
                          f"{forced['compared']} logits rows (every live position of every "
                          f"lane): worst max abs err / max |logit| = {forced['worst']:.3e} at "
                          f"(position, lane) {forced['at']} (limit {MESH_LOGIT_TOL:g})")
                    if not forced["worst"] < MESH_LOGIT_TOL:
                        raise AssertionError(f"{label} {name} rank {r}: step logits "
                                             f"{forced['worst']:.3e} apart at {forced['at']}")
            want = ("flash_attention_causal",) + {
                "off": ("decode_attention",), "default": ("kv_write_span_batch",),
                "int8": ("decode_attention_q8", "kv_write_rows_q8_fused", "quantized_matmul",
                         "w8a8_matmul", "w8a8_matmul_scaled"),
            }[name]
            if tp == 1:
                want = ("flash_attention_causal", "decode_attention")
            for r, res in enumerate(ranks):
                got = res[name]["launches"]
                if res[name]["ids"] and not all(got.get(k, 0) for k in want):
                    raise AssertionError(f"{label} {name} rank {r}: launches {got}")
                if "loops" in res[name]:
                    if res[name]["loops"]["graphed"]["ids"] != res[name]["ids"]:
                        raise AssertionError(f"{label} {name} rank {r}: the graphed rerun's "
                                             f"ids differ from the first run's")
                    hold_loops(f"{label} {name} rank {r}", card, res[name]["loops"],
                               TP_DECODE_KERNELS[name])
                elif tp > 1 and backend == "nccl":
                    raise AssertionError(f"{label} {name} rank {r}: an NCCL tp group decoded "
                                         f"eagerly")
                steps = max(res[name]["steps"], 1)
                counts = ", ".join(f"{k} {got.get(k, 0)}" for k in want)
                print(f"{label} {name} rank {r} [{card}]: launches {counts}; transcribe_batch "
                      f"{res[name]['wall_s']:.3f} s, decode "
                      f"{res[name]['decode_ms']:.1f} ms over {res[name]['steps']} iterations = "
                      f"{res[name]['decode_ms'] / steps:.2f} ms/iteration "
                      f"({'graphed' if res[name]['graphs'] else 'eager'}), "
                      f"{res[name]['tokens']} tokens, build {res[name]['build_s']:.2f} s, "
                      f"peak memory {res[name]['peak_gib']:.2f} GiB")
            if (dp, tp) == (1, 2):
                first[name] = ranks[0][name]["launches"]
        if serve:
            serving_s += mesh_serving_phase(card, label, dp, tp, ranks, base,
                                            refs_for(1)["off"])
    if serving:
        print(f"mesh serving phase [{card}]: {serving_s:.1f} s in the ranks over "
              f"{', '.join(str(m) for m in MESHES)}")
    if n_cards < 2:
        print(f"mesh phase: {n_cards} card: the graphed decode on an NCCL tp group of "
              f"several ranks not run (tp_graphs_phase checks it on one rank)")
    if n_cards < 4:
        print(f"mesh phase: {n_cards} card(s): NCCL at (2, 2) not run")
    return first


#: The runtimes of :func:`tp_graphs_phase`.
TP_GRAPH_RUNTIMES = {"off": {"speculative": "off"}, "default": {}, "int8": dict(INT8_RUNTIME)}


def tp_graphs_rank(rank: int, dp: int, tp: int, workdir: str, runtimes: dict) -> None:
    """The one rank of :func:`tp_graphs_phase` (a spawned process): joins a
    one-rank NCCL group on ``cuda:0``, builds ``ModelConfig()`` from random
    weights (seed 0), and for each of ``runtimes`` (a model on those
    weights) hands its generator a ``TP(1, 0, <the world group>)`` by hand
    (``_mesh_of`` makes no group when dp * tp == 1) and runs
    :func:`loop_runs` on the smoke clips: graphed (capturing), graphed, and
    eager."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig, parallel
    from qwen3_asr_tpu_torch.parallel.collectives import TP

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    parallel.initialize(num_processes=dp * tp, process_id=rank, backend="nccl",
                        init_method=f"file://{workdir}/init")
    group = TP(1, 0, dist.group.WORLD)
    t0 = time.perf_counter()
    base = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                runtime=RuntimeConfig(speculative="off"),
                                dtype=torch.bfloat16, seed=SEED, device=device)
    torch.cuda.synchronize(device)
    out = {"build_s": time.perf_counter() - t0, "backend": dist.get_backend(group.group)}
    clips = smoke_clips()
    for name, runtime in runtimes.items():
        model = Qwen3ASR(base._config, base._encoder_params, base._decoder_params,
                         base._tokenizer, RuntimeConfig(**runtime))
        model._generator.tp = group
        out[name] = loop_runs(model, clips, device, (("capture", False), ("graphed", False),
                                                    ("eager", True)))
        if name == "off":
            out["engine"] = tp_engine_runs(model, clips)
        model.close()
    base.close()
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def tp_engine_runs(model, clips) -> dict:
    """The paged continuous engine on the model's tp group: four smoke
    clips admitted into a graphed engine and into an ``eager=True`` one
    from one prefill (:func:`engine_drive`); per run the tokens, counters,
    chunks' walls and the captures."""
    import dataclasses

    kv, lg, prompts = model.prefill_group(clips[:4], ["English"] * 4)
    waves = [(kv, lg, engine_requests(clips[:4], prompts, 0, False))]
    out = {}
    for name, eager in (("graphed", False), ("eager", True)):
        eng = model.make_engine(n_slots=4, max_duration=30.0, max_new_tokens=ENGINE_TOKENS,
                                chunk_steps=ENGINE_CHUNK, paged=True, eager=eager)
        run = engine_drive(eng, waves)
        out[name] = dict(results=run["results"], stats=dataclasses.asdict(eng.stats),
                         wall=sum(c["wall"] for c in run["chunks"]),
                         captures=eng.graphs.captures if eng.graphs else 0)
        eng.close()
    return out


def hold_tp_engine(label: str, card: str, runs: dict) -> None:
    """:func:`tp_engine_runs`' graphed engine against its eager one: tokens
    bit-identical, counters equal (replays and looks aside), a capture
    made; ms per chunk iteration both ways."""
    g, e = runs["graphed"], runs["eager"]
    aside = ("replays", "looks")
    same = {k: v for k, v in g["stats"].items() if k not in aside} == \
        {k: v for k, v in e["stats"].items() if k not in aside}
    if g["results"] != e["results"] or len(g["results"]) != 4 or not same:
        raise AssertionError(f"{label}: the graphed engine differs from the eager one: "
                             f"{g['stats']} against {e['stats']}")
    if g["captures"] < 1 or e["captures"]:
        raise AssertionError(f"{label}: {g['captures']} captures graphed, {e['captures']} eager")
    its = max(g["stats"]["iterations"], 1)
    print(f"{label} [{card}]: graphed paged engine chunks bit-identical to eager=True, "
          f"counters equal; {g['stats']['chunks']} chunks, {its} live iterations, "
          f"{g['stats']['replays']} replays, {g['stats']['looks']} looks ({e['stats']['looks']} "
          f"eager), {g['captures']} captures; ms per chunk iteration graphed "
          f"{g['wall'] * 1e3 / its:.3f} (captures included), eager {e['wall'] * 1e3 / its:.3f}")


def tp_graphs_phase(card: str, off: dict, int8_slice: dict) -> None:
    """The graphed decode loop on a tensor-parallel group over NCCL, on one
    card: one spawned rank (:func:`tp_graphs_rank`), a one-rank NCCL group,
    ``ModelConfig()`` at full width and depth, the smoke clips under
    ``speculative="off"``, the default (speculative) and the int8 runtime.
    Every collective of the tp step (the embedding's all-reduce, wo's and
    wd's in each layer, the logits' all-gather) is a real
    ``ProcessGroupNCCL`` call inside the captured graph.  Held per runtime
    (:func:`hold_loops`): the capturing and the replaying run's ids
    bit-identical to the eager loop's (the same kernels run, and a one-rank
    collective is an identity), each replay's collectives equal to an eager
    step's, the path's decode kernels launched; the streams held to one
    device's graphed streams (``off``'s plain ones for the bf16 runtimes,
    ``int8_slice``'s for int8) by the near-tie rule; on ``off``'s model the
    paged continuous engine's captured chunks, collectives inside, held to
    its ``eager=True`` chunks (:func:`tp_engine_runs`).  It shows the capture
    plumbing, not that several ranks agree: :func:`mesh_phase` checks that
    with two cards or more."""
    t0 = time.perf_counter()
    res = spawn_ranks(tp_graphs_rank, 1, 1, "tp_graphs", TP_GRAPH_RUNTIMES)[0]
    label = f"tp graphs (one-rank {res['backend']} group, TP(1, 0, world))"
    refs = {"off": off, "default": off, "int8": int8_slice}
    for name in TP_GRAPH_RUNTIMES:
        ids = hold_loops(f"{label} {name}", card, res[name], TP_DECODE_KERNELS[name])
        ref = refs[name]
        compare_streams(f"{label} {name} vs one device", ref["ids"][0], ids, ref["gaps"][0])
    hold_tp_engine(f"{label} engine", card, res["engine"])
    print(f"{label}: {time.perf_counter() - t0:.1f} s (spawn, CUDA and NCCL init, the 1.7B "
          f"build {res['build_s']:.2f} s, three runtimes)")


def kernel_checks_on(index: int, seed: int = SEED) -> float:
    """Phase 3's kernel checks against the plain versions, again, on
    ``cuda:index``; returns the seconds they took."""
    import torch

    t0 = time.perf_counter()
    with torch.cuda.device(index):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        check_flash(gen)
        check_decode(gen)
        check_decode(gen, True)
        check_kv_write(gen)
        check_quantized_matmul(gen)
        check_w8a8_matmul(gen)
        check_w8a8_scaled(gen)
        check_kv_write_span(gen)
        check_decode_paged(gen, 1, False)
        check_decode_paged(gen, 4, True)
        check_decode_stream(gen, "hbm2")
        check_decode_stream(gen, "hbm3")
        check_conv_stem(gen)
        check_decode_lanes(gen, "hbm5")
        check_decode_lanes(gen, "sched")
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def second_card_phase() -> None:
    """With two cards or more, phase 3's kernel checks again on ``cuda:1``
    in the same process, after ``cuda:0``: each kernel with more than 48 KB
    of shared memory sets its opt-in on that card too."""
    import torch

    if torch.cuda.device_count() < 2:
        print("second card: one card, the kernels' checks on cuda:1 not run")
        return
    seconds = kernel_checks_on(1)
    print(f"second card: every kernel checked against its plain version on cuda:1 after "
          f"cuda:0 in {seconds:.1f} s")


# -- the train step on (dp, tp) meshes ----------------------------------------------------

#: (encoder layers, decoder layers) at full width of the dp meshes on one
#: card (a (2, 1) float32 state at full depth, 2 x 32.5 GB of parameters,
#: gradients and Adam moments, does not fit beside the activations) and of
#: the sharded snapshot (the full-depth float32 state is 32.5 GB on disk).
TRAIN_DP_DEPTH = (4, 4)
TRAIN_SNAPSHOT_DEPTH = (1, 1)
#: The full-width (1, 2) float32 gradient against one device's, per leaf:
#: its norm and its projection on a seeded N(0, 1) tensor each within this
#: share of the leaf's norm plus 1e-6 of the whole gradient's norm (a leaf
#: whose exact gradient is 0, as the encoder's key biases, holds rounding).
TRAIN_GRAD_TOL = 1e-3


def depth_config(enc_layers: int, dec_layers: int):
    """``ModelConfig()`` at full width with ``enc_layers`` encoder and
    ``dec_layers`` decoder layers."""
    from qwen3_asr_tpu_torch.config import AudioEncoderConfig, ModelConfig, TextDecoderConfig

    return ModelConfig(audio_encoder=AudioEncoderConfig(encoder_layers=enc_layers),
                       text_decoder=TextDecoderConfig(num_hidden_layers=dec_layers))


def grad_fingerprint(state):
    """(leaves, 2) float64 on the host: each leaf's gradient's squared norm
    and its projection on a seeded N(0, 1) tensor of the leaf's global
    shape, over this rank's shard (summed over a tp group's ranks, the
    whole gradient's)."""
    import torch

    from qwen3_asr_tpu_torch.training.train import named_params, tp_dims

    mesh = state.mesh
    tp, coord = (mesh.shape["tp"], mesh.coordinate["tp"]) if mesh is not None else (1, 0)
    rows = []
    named = named_params(state.encoder, state.decoder)
    for i, ((_, t), d) in enumerate(zip(named, tp_dims(state.encoder, state.decoder))):
        g = t.grad.detach()
        shape = list(g.shape)
        if d is not None:
            shape[d] *= tp
        r = torch.randn(shape, generator=torch.Generator(device=g.device).manual_seed(SEED + i),
                        device=g.device)
        if d is not None:
            r = r.chunk(tp, dim=d)[coord]
        rows.append(torch.stack([(g * g).sum(dtype=torch.float64),
                                 (g * r).sum(dtype=torch.float64)]))
    return torch.stack(rows).cpu()


def digest(t) -> tuple[int, int]:
    """Two int64 sums of ``t``'s bit patterns, plain and position-weighted
    (wrapping): equal for equal bits."""
    import torch

    bits = t.detach().reshape(-1).view(torch.int32 if t.element_size() == 4 else torch.int16)
    plain = weighted = 0
    for lo in range(0, bits.numel(), 1 << 24):
        chunk = bits[lo : lo + (1 << 24)].long()
        w = torch.arange(lo, lo + chunk.numel(), device=chunk.device) % 65521 + 1
        plain += chunk.sum().item()
        weighted += (chunk * w).sum().item()
    return plain, weighted


def state_digests(state, moments: bool = False) -> dict:
    """Each local leaf's :func:`digest` by name; with ``moments`` also its
    Adam moments' (``name:exp_avg``, ``name:exp_avg_sq``)."""
    from qwen3_asr_tpu_torch.training.train import named_params

    named = named_params(state.encoder, state.decoder)
    out = {n: digest(t) for n, t in named}
    if moments:
        opt = state.optimizer.state_dict()["state"]
        for i, (n, _) in enumerate(named):
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{n}:{k}"] = digest(opt[i][k])
    return out


def mesh_train_state(cfg, dtype, device, mesh, seed: int = SEED, **adam):
    """A step-0 Adam (lr :data:`TRAIN_LR`, ``adam`` its other options) state
    of ``cfg`` from ``random_params(seed)`` on ``device``, this rank's
    shards on ``mesh``."""
    import functools

    import torch

    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training.train import init_train_state

    params = random_params(cfg, seed=seed, dtype=dtype, device=device)
    return init_train_state(cfg, functools.partial(torch.optim.Adam, lr=TRAIN_LR, **adam),
                            *params, mesh)


def timed_steps(step, state, batch, n: int, device) -> tuple:
    """``n`` calls of the train step ``step`` between two CUDA events:
    (state, losses, ms a step, collectives a step, bytes a step)."""
    import torch

    from qwen3_asr_tpu_torch.parallel.collectives import TRAFFIC

    TRAFFIC.clear()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize(device)
    calls = sum(v for k, v in TRAFFIC.items() if not k.endswith("bytes"))
    nbytes = sum(v for k, v in TRAFFIC.items() if k.endswith("bytes"))
    return (state, torch.stack(losses).float().cpu().tolist(), start.elapsed_time(end) / n,
            calls / n, nbytes / n)


def train_job_tiny(mesh, device, workdir) -> dict:
    """(a) The tiny float32 step of :func:`train_parity` (Adam lr 1e-3, the
    weights drawn on the host): the loss and this rank's gradients."""
    import functools

    import torch

    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training.train import init_train_state, make_train_step, named_params

    cfg = train_tiny_config()
    params = tuple(_params_to(p, device, torch.float32)
                   for p in random_params(cfg, seed=SEED, dtype=torch.float32))
    state = init_train_state(cfg, functools.partial(torch.optim.Adam, lr=1e-3), *params, mesh)
    batch = train_batch(cfg.text_decoder.vocab_size, 2, 800, 700, 91, 144, SEED, device)
    state, loss = make_train_step(cfg)(state, batch)
    return {"loss": loss.item(),
            "grads": {n: t.grad.cpu() for n, t in named_params(state.encoder, state.decoder)}}


def train_job_full(mesh, device, workdir) -> dict:
    """(b) ``ModelConfig()`` on the :data:`TRAIN_FULL` batch: one float32
    step (its loss, host-clock seconds, :func:`grad_fingerprint`, peak
    memory, collectives and the replicated leaves' digests), then in bf16
    two first steps (graphed over NCCL: the warm-up, then the capture and
    its replay) and :data:`TRAIN_STEPS` timed steps, the step's counters and
    whether it was graphed; where it was, the same bf16 steps again with
    ``eager=True`` from the same initial state (their losses, ms and the
    parameters' digests beside the graphed run's)."""
    import dataclasses

    import torch

    from qwen3_asr_tpu_torch.config import ModelConfig
    from qwen3_asr_tpu_torch.training.train import make_train_step

    cfg = ModelConfig()
    B, frames, valid, n_audio, P = TRAIN_FULL
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, device)
    out = {}
    for dtype, label, eager in ((torch.float32, "f32", False), (torch.bfloat16, "bf16", False),
                                (torch.bfloat16, "bf16 eager", True)):
        if eager and not out["bf16"]["graphed"]:
            break
        state = mesh_train_state(cfg, dtype, device, mesh)
        step = make_train_step(cfg, eager=eager)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state, losses, ms, calls, nbytes = timed_steps(step, state, batch, 1, device)
        first_s = time.perf_counter() - t0
        rec = {"first_s": first_s, "first_loss": losses[0]}
        if label == "f32":
            rec.update(fingerprint=grad_fingerprint(state), digests=state_digests(state))
        else:
            state, more, _, _, _ = timed_steps(step, state, batch, 1, device)
            state, timed, ms, calls, nbytes = timed_steps(step, state, batch, TRAIN_STEPS, device)
            rec.update(losses=losses + more + timed, digests=state_digests(state))
        rec.update(ms=ms, calls=calls, bytes=nbytes, graphed=step.graphed(state),
                   stats=dataclasses.asdict(step.stats),
                   peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        out[label] = rec
        step.close()
        del state
        torch.cuda.empty_cache()
    return out


def train_job_dp(mesh, device, workdir, depth) -> dict:
    """(c) One float32 step at full width and ``depth`` (None: full depth)
    on the :data:`TRAIN_FULL` batch: loss, ms, peak memory, collectives and
    every leaf's digest after the step."""
    import torch

    from qwen3_asr_tpu_torch.config import ModelConfig
    from qwen3_asr_tpu_torch.training.train import make_train_step

    cfg = ModelConfig() if depth is None else depth_config(*depth)
    B, frames, valid, n_audio, P = TRAIN_FULL
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, device)
    state = mesh_train_state(cfg, torch.float32, device, mesh)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    state, losses, ms, calls, nbytes = timed_steps(make_train_step(cfg), state, batch, 1, device)
    return {"loss": losses[0], "ms": ms, "calls": calls, "bytes": nbytes,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "digests": state_digests(state)}


def train_job_snapshot(mesh, device, workdir) -> dict:
    """(d) At :data:`TRAIN_SNAPSHOT_DEPTH`, float32: one step, a sharded
    snapshot under ``workdir/ckpt``, a second step; a fresh state (other
    weights) restored from the snapshot, held bit for bit to the saved
    state, and its step: both second losses and the saved state's
    digests."""
    import torch

    from qwen3_asr_tpu_torch.training import checkpoint as ckpt
    from qwen3_asr_tpu_torch.training.train import make_train_step

    cfg = depth_config(*TRAIN_SNAPSHOT_DEPTH)
    B, frames, valid, n_audio, P = TRAIN_FULL
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, device)
    step = make_train_step(cfg)
    state = mesh_train_state(cfg, torch.float32, device, mesh)
    state, loss1 = step(state, batch)
    t0 = time.perf_counter()
    path = ckpt.save_train_state(Path(workdir) / "ckpt", state)
    save_s = time.perf_counter() - t0
    saved = state_digests(state, moments=True)
    state, loss2 = step(state, batch)
    del state
    t0 = time.perf_counter()
    run = ckpt.restore_train_state(Path(workdir) / "ckpt",
                                   mesh_train_state(cfg, torch.float32, device, mesh, SEED + 1))
    restore_s = time.perf_counter() - t0
    restored = state_digests(run, moments=True)
    run, loss2r = step(run, batch)
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    return {"loss1": loss1.item(), "loss2": loss2.item(), "loss2_restored": loss2r.item(),
            "restored_step": run.step - 1, "equal": restored == saved, "saved": saved,
            "path": str(path.parent), "save_s": save_s, "restore_s": restore_s,
            "snapshot_bytes": nbytes}


TRAIN_JOBS = {"tiny": train_job_tiny, "full": train_job_full, "dp": train_job_dp,
              "snapshot": train_job_snapshot}


def train_rank(rank: int, dp: int, tp: int, workdir: str, backend: str, jobs: dict) -> None:
    """One rank of :func:`mesh_training_phase` (a spawned process): joins the
    group with TF32 off and ``cudnn.deterministic`` on and runs ``jobs`` (:data:`TRAIN_JOBS` name ->
    keyword arguments) on its card; saves each job's record, its mesh
    coordinate and the hand-written kernels it launched."""
    sys.path.insert(0, str(ROOT))
    import torch

    from qwen3_asr_tpu_torch import parallel
    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    parallel.initialize(num_processes=dp * tp, process_id=rank, backend=backend,
                        init_method=f"file://{workdir}/init")
    mesh = parallel.make_mesh(dp, tp)
    out = {"coordinate": dict(mesh.coordinate), "device": str(device)}
    for name, kwargs in jobs.items():
        out[name] = TRAIN_JOBS[name](mesh, device, workdir, **kwargs)
        torch.cuda.empty_cache()
    out["launches"] = dict(LAUNCHES)
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def same_replicated(label: str, ranks: list[dict], digests_of, dims: dict) -> int:
    """Raise unless every replicated leaf's digest is the same in every rank
    and a sharded leaf's in the ranks of one tp coordinate; returns the
    leaves compared."""
    first = {}
    for r in ranks:
        tp = r["coordinate"]["tp"]
        for name, dg in digests_of(r).items():
            key = name if dims[name] is None else (name, tp)
            if first.setdefault(key, dg) != dg:
                raise AssertionError(f"{label}: {name} differs across ranks")
    return len(first)


def mesh_training_phase(card: str, refs: dict) -> None:
    """The train step on (dp, tp) meshes of spawned ranks
    (:func:`train_rank`, the spawn, timeout and failure handling of
    :func:`mesh_phase`), TF32 off, held to :func:`training_phase`'s one
    device (``refs``):

      (a) the tiny float32 config on (1, 2), (2, 1), and (2, 2) with four
          cards: the loss within 1e-5 relative of one device's, every
          gathered gradient leaf within 1e-4 x max |g| + 1e-7;
      (b) ``ModelConfig()`` on (1, 2): one float32 step held to one
          device's (the loss within 1e-5 relative; per leaf the gradient's
          norm and seeded projection, summed over the shards, within
          :data:`TRAIN_GRAD_TOL`), then bf16, two first steps and three
          timed, every loss finite and the last below the first; over
          NCCL the step is graphed (one capture a rank) and each rank's
          run bit-identical to an ``eager=True`` rerun, its collectives a
          replay those of an eager step, over gloo eager;
          ms a step (CUDA events), peak memory a rank, collectives and
          bytes a step;
      (c) dp meshes, float32: (2, 1) at :data:`TRAIN_DP_DEPTH` (one card:
          gloo through host memory; NCCL with two cards or more), and with
          four cards (2, 2) over NCCL at full depth: the loss within 1e-5
          relative of one device's on the whole batch, replicated leaves
          bit-identical across the ranks (digests);
      (d) a sharded snapshot on (1, 2) at :data:`TRAIN_SNAPSHOT_DEPTH`
          restored into a fresh (1, 2) state (bit-identical to the saved
          state, the next step's loss bit-identical) and into one device
          (its slices' digests equal to the ranks' saved ones, the next
          loss within 1e-5 relative);
      (e) no hand-written kernel launched in any rank or here;
      (f) ``dryrun_multichip(2)``."""
    import shutil

    import torch

    from qwen3_asr_tpu_torch.ops.kernels import LAUNCHES
    from qwen3_asr_tpu_torch.training import asr_loss, checkpoint as ckpt
    from qwen3_asr_tpu_torch.training.dryrun import dryrun_multichip
    from qwen3_asr_tpu_torch.training.train import named_params

    t_phase = time.perf_counter()
    before = dict(LAUNCHES)
    n_cards = torch.cuda.device_count()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        B, frames, valid, n_audio, P = TRAIN_FULL
        dp_cfg = depth_config(*TRAIN_DP_DEPTH)
        with torch.no_grad():
            params = mesh_train_state(dp_cfg, torch.float32, "cuda", None)
            batch = train_batch(dp_cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P,
                                SEED, "cuda")
            dp_ref = asr_loss(params.encoder, params.decoder, dp_cfg, batch).item()
        del params, batch
        torch.cuda.empty_cache()
        plans = [((1, 2), {"tiny": {}, "full": {}, "snapshot": {}}),
                 ((2, 1), {"tiny": {}, "dp": {"depth": TRAIN_DP_DEPTH}})]
        if n_cards >= 4:
            plans.append(((2, 2), {"tiny": {}, "dp": {"depth": None}}))
        results = {}
        for (dp, tp), jobs in plans:
            backend = "nccl" if n_cards >= dp * tp else "gloo"
            t0 = time.perf_counter()
            ranks = spawn_ranks(train_rank, dp, tp, f"train_mesh_{dp}x{tp}", backend, jobs)
            label = f"train mesh (dp={dp}, tp={tp}) over {backend} on " + ", ".join(
                sorted({r["device"] for r in ranks}))
            print(f"{label}: {dp * tp} ranks ran {', '.join(jobs)} in "
                  f"{time.perf_counter() - t0:.1f} s (spawn, CUDA init, builds and steps)")
            results[(dp, tp)] = (label, ranks)
            hold_tiny(card, label, ranks, refs["tiny"])
            for r, rank in enumerate(ranks):
                if any(rank["launches"].values()):
                    raise AssertionError(f"{label} rank {r}: hand-written kernels launched "
                                         f"{rank['launches']}")
            if "full" in jobs:
                hold_full(card, label, ranks, refs)
            if "dp" in jobs:
                depth = jobs["dp"]["depth"]
                want = refs["f32"]["losses"][0] if depth is None else dp_ref
                hold_dp(card, label, ranks, want, depth)
            if "snapshot" in jobs:
                hold_snapshot(card, label, ranks)
        dryrun_multichip(2)
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
        for d in (ROOT / "build").glob("train_mesh_*"):
            shutil.rmtree(d, ignore_errors=True)
    if dict(LAUNCHES) != before:
        raise AssertionError("mesh training phase launched hand-written kernels here")
    if n_cards < 4:
        print(f"mesh training phase: {n_cards} card(s): (2, 2) not run")
    print(f"mesh training phase: no hand-written kernel launched in any rank or here "
          f"({time.perf_counter() - t_phase:.1f} s) ({card})")


def leaf_dims(cfg) -> dict:
    """Each parameter leaf's tp-split dim (None: replicated) by name."""
    import torch

    from qwen3_asr_tpu_torch.models.params import random_params
    from qwen3_asr_tpu_torch.training.train import named_params, tp_dims

    enc, dec = random_params(cfg, seed=None, dtype=torch.float32, device="meta")
    return {n: d for (n, _), d in zip(named_params(enc, dec), tp_dims(enc, dec))}


def tp_row(ranks: list[dict]) -> list[dict]:
    """The ranks at dp coordinate 0, in tp order."""
    return sorted((r for r in ranks if r["coordinate"]["dp"] == 0),
                  key=lambda r: r["coordinate"]["tp"])


def one_loss(label: str, values: list[float]) -> float:
    if any(v != values[0] for v in values):
        raise AssertionError(f"{label}: the ranks' losses differ: {values}")
    if not math.isfinite(values[0]):
        raise AssertionError(f"{label}: non-finite loss {values[0]}")
    return values[0]


def hold_loss(label: str, got: float, want: float) -> float:
    rel = abs(got - want) / abs(want)
    if not rel <= 1e-5:
        raise AssertionError(f"{label}: loss {got} against one device's {want} (rel {rel:.2e})")
    return rel


def hold_tiny(card: str, label: str, ranks: list[dict], ref: tuple) -> None:
    """(a) The tiny step's loss and gathered gradients against one device's."""
    import torch

    loss_ref, grads_ref = ref
    loss = one_loss(f"{label} tiny", [r["tiny"]["loss"] for r in ranks])
    rel = hold_loss(f"{label} tiny", loss, loss_ref)
    dims, row = leaf_dims(train_tiny_config()), tp_row(ranks)
    worst, worst_name = 0.0, ""
    for name, want in grads_ref.items():
        parts = [r["tiny"]["grads"][name] for r in row]
        got = parts[0] if dims[name] is None else torch.cat(parts, dim=dims[name])
        tol = 1e-4 * want.abs().max().item() + 1e-7
        err = (got - want).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{label} tiny: {name} grad err {err:.3e} > {tol:.3e}")
        if err / tol > worst:
            worst, worst_name = err / tol, name
    print(f"{label} tiny f32 (TF32 off): loss {loss:.7f} against one device's {loss_ref:.7f} "
          f"(rel {rel:.2e}); {len(grads_ref)} gathered gradient leaves within 1e-4 x max |g| "
          f"+ 1e-7, the closest at {worst:.1%} of its tolerance ({worst_name}) ({card})")


def hold_full(card: str, label: str, ranks: list[dict], refs: dict) -> None:
    """(b) The full-width float32 step against one device's, then the bf16
    steps; times, peaks and collectives printed a rank."""
    import torch

    from qwen3_asr_tpu_torch.config import ModelConfig

    f32 = [r["full"]["f32"] for r in ranks]
    loss = one_loss(f"{label} f32", [x["first_loss"] for x in f32])
    rel = hold_loss(f"{label} f32", loss, refs["f32"]["losses"][0])
    dims = leaf_dims(ModelConfig())
    ref = refs["f32"]["fingerprint"]
    got = tp_row(ranks)[0]["full"]["f32"]["fingerprint"].clone()
    for i, d in enumerate(dims.values()):
        if d is not None:
            got[i] = sum(r["full"]["f32"]["fingerprint"][i] for r in tp_row(ranks))
    total = ref[:, 0].sum().sqrt().item()
    worst, worst_name = 0.0, ""
    for i, name in enumerate(dims):
        norm = ref[i, 0].sqrt().item()
        tol = TRAIN_GRAD_TOL * norm + 1e-6 * total
        err = max(abs(got[i, 0].sqrt().item() - norm), abs(got[i, 1].item() - ref[i, 1].item()))
        if not err <= tol:
            raise AssertionError(f"{label} f32: {name} gradient norm/projection off by "
                                 f"{err:.3e} (norm {norm:.3e}, tolerance {tol:.3e})")
        if err / norm > worst and norm > 1e-6 * total:
            worst, worst_name = err / norm, name
    n = same_replicated(f"{label} f32", ranks, lambda r: r["full"]["f32"]["digests"], dims)
    print(f"{label} ModelConfig() f32: loss {loss:.7f} against one device's "
          f"{refs['f32']['losses'][0]:.7f} (rel {rel:.2e}); {len(dims)} leaves' gradient norm "
          f"and seeded projection summed over the shards within {TRAIN_GRAD_TOL:g} x the leaf's "
          f"norm + 1e-6 x the whole norm of one device's, the worst at {worst:.2e} of its "
          f"norm ({worst_name}); {n} leaf copies bit-identical where replicated ({card})")
    bf16 = [r["full"]["bf16"] for r in ranks]
    traj = [one_loss(f"{label} bf16 step {k}", [x["losses"][k] for x in bf16])
            for k in range(len(bf16[0]["losses"]))]
    if not traj[-1] < traj[0]:
        raise AssertionError(f"{label} bf16: loss did not fall {traj}")
    graphed = {x["graphed"] for x in bf16}
    if len(graphed) != 1:
        raise AssertionError(f"{label} bf16: some ranks graphed the step, some did not")
    graphed = graphed.pop()
    for r, x in enumerate(bf16):
        st = x["stats"]
        want = ({"captures": 1, "replays": len(traj) - 1, "eager_steps": 1} if graphed else
                {"captures": 0, "replays": 0, "eager_steps": len(traj)})
        if {k: st[k] for k in want} != want:
            raise AssertionError(f"{label} rank {r} bf16: the step's counters {st}, want {want}")
    how = "eager (the group's collectives stage through host memory)"
    if graphed:
        eager = [r["full"]["bf16 eager"] for r in ranks]
        same = all(g["losses"] == e["losses"] and g["digests"] == e["digests"]
                   for g, e in zip(bf16, eager))
        if not same:
            raise AssertionError(f"{label} bf16: graphed losses {traj} against eager=True "
                                 f"{eager[0]['losses']}, parameters equal per rank "
                                 f"{[g['digests'] == e['digests'] for g, e in zip(bf16, eager)]}")
        for r, (g, e) in enumerate(zip(bf16, eager)):
            if (g["calls"], g["bytes"]) != (e["calls"], e["bytes"]):
                raise AssertionError(f"{label} rank {r} bf16: a replay counts {g['calls']} "
                                     f"collectives ({g['bytes']} bytes), an eager step "
                                     f"{e['calls']} ({e['bytes']})")
        how = (f"graphed over NCCL (one capture a rank, {bf16[0]['stats']['capture_ms']:.1f} ms "
               f"on rank 0), every rank's losses and parameters bit-identical to its "
               f"eager=True rerun ({', '.join('%.1f' % e['ms'] for e in eager)} ms a step), "
               f"{bf16[0]['calls']:.0f} collectives a replay as in an eager step")
    print(f"{label} ModelConfig() bf16: losses {['%.6f' % x for x in traj]} (2 first steps, "
          f"{TRAIN_STEPS} timed), one device's first {refs['bf16']['losses'][0]:.6f}; the step "
          f"ran {how} ({card})")
    for r, rank in enumerate(ranks):
        for dtype in ("f32", "bf16"):
            x = rank["full"][dtype]
            timing = (f"{x['first_s'] * 1e3:.1f} ms the step (host clock, first)"
                      if dtype == "f32" else
                      f"{x['ms']:.1f} ms a step (CUDA events, mean of {TRAIN_STEPS}; first "
                      f"{x['first_s'] * 1e3:.1f} ms host)")
            print(f"{label} rank {r} {dtype}: {timing}; peak memory {x['peak_gb']:.2f} GB "
                  f"(max_memory_allocated, built state included); {x['calls']:.0f} collectives "
                  f"a step, {x['bytes'] / 1e9:.3f} GB handed to them ({card})")


def hold_dp(card: str, label: str, ranks: list[dict], want: float, depth) -> None:
    """(c) A dp mesh's float32 step against one device's loss on the whole
    batch; replicated leaves bit-identical across the ranks."""
    from qwen3_asr_tpu_torch.config import ModelConfig

    cfg = ModelConfig() if depth is None else depth_config(*depth)
    loss = one_loss(f"{label} dp", [r["dp"]["loss"] for r in ranks])
    rel = hold_loss(f"{label} dp", loss, want)
    n = same_replicated(f"{label} dp", ranks, lambda r: r["dp"]["digests"], leaf_dims(cfg))
    where = "full depth" if depth is None else f"{depth[0]} encoder, {depth[1]} decoder layers"
    print(f"{label} ModelConfig() f32 at {where}: loss {loss:.7f} against one device's "
          f"{want:.7f} on the whole batch (rel {rel:.2e}); {n} leaf copies bit-identical "
          f"across the ranks ({card})")
    for r, rank in enumerate(ranks):
        x = rank["dp"]
        print(f"{label} rank {r} f32: {x['ms']:.1f} ms the step (CUDA events); peak memory "
              f"{x['peak_gb']:.2f} GB; {x['calls']:.0f} collectives a step, "
              f"{x['bytes'] / 1e9:.3f} GB handed to them ({card})")


def hold_snapshot(card: str, label: str, ranks: list[dict]) -> None:
    """(d) The sharded snapshot: restored on the mesh bit for bit, then onto
    one device (its slices' digests the ranks' saved ones; the next step's
    loss within 1e-5 relative of the mesh's)."""
    import torch

    from qwen3_asr_tpu_torch.training import checkpoint as ckpt
    from qwen3_asr_tpu_torch.training.train import make_train_step, named_params

    for r, rank in enumerate(ranks):
        x = rank["snapshot"]
        if not (x["equal"] and x["restored_step"] == 1 and x["loss2"] == x["loss2_restored"]):
            raise AssertionError(f"{label} snapshot rank {r}: restored state equal "
                                 f"{x['equal']}, step {x['restored_step']}, next loss "
                                 f"{x['loss2_restored']} against {x['loss2']}")
    x = ranks[0]["snapshot"]
    cfg = depth_config(*TRAIN_SNAPSHOT_DEPTH)
    state = ckpt.restore_train_state(x["path"], mesh_train_state(cfg, torch.float32, "cuda",
                                                                 None, SEED + 2))
    dims = leaf_dims(cfg)
    opt = state.optimizer.state_dict()["state"]
    named = named_params(state.encoder, state.decoder)
    tp = len(tp_row(ranks))
    for rank in tp_row(ranks):
        c = rank["coordinate"]["tp"]
        for i, (name, t) in enumerate(named):
            d = dims[name]
            for key, whole in ((name, t), (f"{name}:exp_avg", opt[i]["exp_avg"]),
                               (f"{name}:exp_avg_sq", opt[i]["exp_avg_sq"])):
                part = whole if d is None else whole.chunk(tp, dim=d)[c]
                if digest(part.contiguous()) != rank["snapshot"]["saved"][key]:
                    raise AssertionError(f"{label} snapshot: {key} restored on one device is "
                                         f"not tp rank {c}'s saved shard")
    B, frames, valid, n_audio, P = TRAIN_FULL
    batch = train_batch(cfg.text_decoder.vocab_size, B, frames, valid, n_audio, P, SEED, "cuda")
    state, loss = make_train_step(cfg)(state, batch)
    rel = hold_loss(f"{label} snapshot on one device", loss.item(), x["loss2"])
    print(f"{label} sharded snapshot of ModelConfig() at {TRAIN_SNAPSHOT_DEPTH[0]} encoder, "
          f"{TRAIN_SNAPSHOT_DEPTH[1]} decoder layer(s), f32, Adam: "
          f"{x['snapshot_bytes'] / 1e9:.2f} GB in {x['save_s']:.1f} s, restored in "
          f"{x['restore_s']:.1f} s; on the mesh bit-identical and the next loss equal "
          f"({x['loss2']:.7f}); on one device every leaf and moment equal to the ranks' "
          f"shards, the next loss {loss.item():.7f} (rel {rel:.2e}) ({card})")
    del state
    torch.cuda.empty_cache()


def native_audio_phase(card: str) -> None:
    """The port's native C++ audio library: built from the checkout
    (``make -C qwen3_asr_tpu_torch/audio/csrc``, no fallback), then
    ``load_audio`` of a PCM16 WAV of the 30 s smoke clip at 24 kHz, written
    under ``build/``: it must take the native route, and its samples must
    equal the numpy decoder's, resampled the same way, bit for bit."""
    import struct

    import numpy as np

    from qwen3_asr_tpu_torch.audio import io as audio_io
    from qwen3_asr_tpu_torch.audio import native

    t0 = time.perf_counter()
    subprocess.run(["make", "-C", str(native.library_path().parent)], check=True,
                   capture_output=True, timeout=300)
    native._load_attempted, native._lib = False, None
    if not native.available():
        raise AssertionError(f"native audio: {native.library_path()} did not load")
    rate = 24000
    pcm = (np.clip(smoke_clips()[-1], -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, 2 * rate, 2, 16)
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm
    wav = ROOT / "build" / "smoke_audio" / "clip.wav"
    wav.parent.mkdir(parents=True, exist_ok=True)
    wav.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    calls, real = [], native.decode_wav_file
    native.decode_wav_file = lambda path: calls.append(path) or real(path)
    try:
        got = audio_io.load_audio(wav)
    finally:
        native.decode_wav_file = real
    samples, sr = audio_io._decode_wav(wav.read_bytes())
    want = audio_io.resample_linear(samples, sr, audio_io.SAMPLE_RATE)
    if calls != [wav] or not np.array_equal(got, want):
        raise AssertionError("native audio: load_audio did not take the native route, or its "
                             "samples differ from the numpy decoder's")
    print(f"native audio [{card}]: {native.library_path().relative_to(ROOT)} built and loaded; "
          f"load_audio of a {len(samples) / sr:.1f} s PCM16 WAV at {sr} Hz took the native "
          f"route, {len(got)} samples at 16 kHz equal to the numpy decoder's "
          f"({time.perf_counter() - t0:.2f} s)")


def tp_graphs_only(card: str) -> None:
    """``--tp-graphs``: the kernels built, the bf16 and int8 models' slices
    (their graphed streams and gaps), :func:`tp_graphs_phase`, and with two
    cards or more :func:`mesh_phase` at (1, 2) without the servers."""
    import torch

    from qwen3_asr_tpu_torch.ops.kernels import _build

    _build.library()
    off_rt = {"speculative": "off"}
    base = build_model(off_rt)
    off = slice_phase(card, base, off_rt, BF16_PATH, record_gaps=True)
    int8 = build_model(INT8_RUNTIME)
    int8_slice = slice_phase(card, int8, INT8_RUNTIME, INT8_PATH, record_gaps=True)
    tp_graphs_phase(card, off, int8_slice)
    if torch.cuda.device_count() >= 2:
        mesh_phase(card, base, off, int8, meshes=((1, 2),), serving=False)
    else:
        print("tp graphs: 1 card: the graphed decode on an NCCL group of several ranks "
              "not run")
    for model in (base, int8):
        model.close()


class Laps:
    """Prints the wall seconds of each phase of :func:`main` as it ends,
    and the total since the build began."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        print(f"phase time, {label}: {now - self.last:.1f} s (total {now - self.t0:.1f} s)")
        self.last = now


def main() -> int:
    if not (ROOT / "qwen3_asr_tpu_torch").is_dir():
        print("chip_smoke.py: qwen3_asr_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = card_identity()
    print(card)              # the nvidia-smi name,power.limit line as it is
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if sys.argv[1:] == ["--training"]:
        # The training phases alone (no kernel is built or checked), to
        # iterate on them; prints no result line.
        mesh_training_phase(card, training_phase(card))
        return 0
    if sys.argv[1:] == ["--tp-graphs"]:
        # The graphed tp decode alone: the one-rank NCCL phase and, with two
        # cards or more, (1, 2) over NCCL, each against one device's
        # streams; prints no result line.
        tp_graphs_only(card)
        return 0

    from qwen3_asr_tpu_torch.ops.kernels import _build

    lap = Laps()
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.last_build_seconds:.2f} s; 0 = library already built) -> "
          f"{_build.library_path().relative_to(ROOT)}")

    native_audio_phase(card)
    lap("build and native audio")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    measured = {"flash_attention_causal": check_flash(gen)}
    measured["decode_attention"], measured["kv_write_rows_fused"] = check_decode(gen)
    measured["kv_write_rows"] = check_kv_write(gen)
    measured["decode_attention_q8"], measured["kv_write_rows_q8_fused"] = check_decode(gen, True)
    measured.update({
        "kv_write_rows_q8": check_kv_write_q8(gen),
        "quantized_matmul": check_quantized_matmul(gen),
        "w8a8_matmul": check_w8a8_matmul(gen),
        "w8a8_matmul_scaled": check_w8a8_scaled(gen),
        "kv_write_span_batch": check_kv_write_span(gen),
    })
    # The fused paged stores' records: K6's (the paged step's) at PAGED_ROW.
    measured["decode_attention_paged"], measured["kv_write_rows_paged_fused"] = \
        check_decode_paged(gen, 1, False)
    measured["decode_attention_paged_q8"], measured["kv_write_rows_paged_q8_fused"] = \
        check_decode_paged(gen, 1, True)
    measured["decode_attention_paged_verify"] = check_decode_paged(gen, 4, False)[0]
    measured["decode_attention_paged_verify_q8"] = check_decode_paged(gen, 4, True)[0]
    measured.update({
        "kv_write_rows_paged": check_kv_write_paged(gen, False),
        "kv_write_rows_paged_q8": check_kv_write_paged(gen, True),
        "decode_attention_hbm2": check_decode_stream(gen, "hbm2"),
        "decode_attention_hbm3": check_decode_stream(gen, "hbm3"),
        "conv_s2_gelu": check_conv_stem(gen),
        "decode_attention_hbm5": check_decode_lanes(gen, "hbm5"),
        "decode_attention_sched": check_decode_lanes(gen, "sched"),
    })
    torch.cuda.empty_cache()
    lap("kernel checks")
    second_card_phase()
    kab_launches = kernelab_step()
    torch.cuda.empty_cache()
    reference_check(quantized=False)
    reference_check(quantized=True)
    reference_check_paged()
    lap("kernelab and small-width references")
    # Each kernel's launch count comes from the run of its own path.
    off_rt = {"speculative": "off"}
    base = build_model(off_rt)
    off = slice_phase(card, base, off_rt, BF16_PATH, ("kv_write_span_batch",) + STANDALONE_WRITERS,
                      lm_head=True, record_gaps=True)
    launches = dict(off["launches"])
    int8_ref = int8_cache_reference(card, base)
    lap("plain slice and int8-cache reference")
    launches.update(modes_phase(card, base, off, int8_ref))
    lap("modes")
    spec_launches = speculative_phase(card, base, off)
    launches["kv_write_span_batch"] = spec_launches["kv_write_span_batch"]
    lap("speculative")
    t_engine = time.perf_counter()
    engine_launches = engine_graphs_phase(card, base)
    print(f"engine graphs phase: {time.perf_counter() - t_engine:.1f} s; graphed chunk "
          f"launches by arm (no-op replays included): {engine_launches}")
    launches.update(server_phase(card, base, off, int8_ref))
    lap("engine graphs and servers")
    int8_ref["model"].close()
    del int8_ref
    xla_writer_phase(card, base, off)
    lap("xla writer")
    graphs_phase(card, base)
    lap("graphed loops")
    live_phase(card, base)
    lap("live")
    replicated_phase(card, base)
    int8 = build_model(INT8_RUNTIME)
    int8_slice = slice_phase(card, int8, INT8_RUNTIME, INT8_PATH, STANDALONE_WRITERS,
                             record_gaps=True)
    int8_launches = int8_slice["launches"]
    live_int8_phase(int8)
    lap("replicated, int8 slice and live int8")
    tp_graphs_phase(card, off, int8_slice)
    lap("tp graphs")
    mesh_launches = mesh_phase(card, base, off, int8)
    lap("meshes")
    launches["w8a8_matmul_scaled"] = mesh_launches["int8"].get("w8a8_matmul_scaled", 0)
    for model in (base, int8):
        model.close()
    del base, int8, model
    torch.cuda.empty_cache()
    train_refs = training_phase(card)
    lap("training")
    mesh_training_phase(card, train_refs)
    lap("mesh training")
    launches.update({name: int8_launches[name] for name in INT8_PATH})
    launches.update({name: kab_launches[name] for name in KERNELAB[1:]})

    rows = []
    for name, (route, source, replaces) in KERNELS.items():
        if name in ORACLES:
            print(f"{name}: held in phase 3 (the oracle of its fused store); no path launches it")
            continue
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was launched on no path")
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], **measured[name],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
