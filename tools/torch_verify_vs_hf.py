#!/usr/bin/env python3
"""Real-dimension verification of the PyTorch port against HuggingFace
``transformers`` (the port of ``tools/verify_vs_hf.py``).

Runs the ``tests/test_torch_hf_cross_oracle.py`` comparison at the REAL
Qwen3-ASR 1.7B dimensions, so dimension-dependent faults (GQA 16Q/8KV at
head_dim 128, the 7680-wide conv_out, the 104-token window at d_model
1024) cannot hide behind the tiny config:

  1. build HF's ``Qwen3OmniMoeAudioEncoder`` + ``Qwen3ForCausalLM`` at the
     default (real) config dims with random init;
  2. export them through the published checkpoint layout (``audio_tower.*``
     / ``model.*`` in one ``model.safetensors``, torch conv layout);
  3. compute HF's three outputs (encoder, prefill logits with injected
     audio features, N greedy tokens), then free the HF models;
  4. load the checkpoint with the port's own loader
     (``models/params.py`` ``load_checkpoint``), delete it, and compare.

The port runs the route its generator takes: the fresh prefill into a KV
cache, then one split decode step per token over that cache.  On the CPU
(``--device cpu``, the default) that is the kernels' plain versions in
float32; on a CUDA card (``--device cuda``) it is the card's bf16 path:
K1 in the prefill, K2 with K3 fused in the greedy steps, plus K9 under
``int8`` and K10 under ``w8a8``, held to the same f32 oracle::

    python3 tools/torch_verify_vs_hf.py [--quant none int8 w8a8] [--device cpu|cuda]

Several ``--quant`` modes share one oracle and one load.  Takes a few
minutes on 8 CPU cores and ~16 GB of host memory at the peak (two f32
copies of the weights) plus the 7.6 GB temporary checkpoint.  Exit code 0
= every mode within its gates.

Gates.  ``none`` on the CPU: encoder max|diff| < 5e-4, prefill max|diff| <
2e-3 with per-position argmax agreement 1.0, and the greedy tokens
identical to HF's.  ``--quant int8|w8a8`` (and every mode on the card,
whose bf16 is lossy against the f32 oracle too) measures a FIDELITY BOUND:

  * encoder relative error < 5% of the oracle's max |value|;
  * prefill logit rms relative error < 25% (noise accumulation over 28
    residual layers on random weights stays well under it; the gate
    catches SYSTEMATIC errors such as a wrong scale axis, which land near
    100%), and
  * the flip-margin bound: every argmax flip sits at an oracle margin
    below 10 x rms|delta-logit|, i.e. flips are confined to near-ties at
    the noise scale, never at real margins.

A random 1.7B model's greedy logit margins are noise-level (p50 ~0.1 over
the 151936 vocab), so in those modes a single near-tie flip diverges the
rollout: greedy token identity is reported (the first step that left HF's
path), not gated.  ``w8a8`` forces the W8A8 path at these shapes
(``act_quant_rows(2)`` for the decoder, the encoder's row gate at 8), as
the JAX tool does; the 1-token greedy steps stay weight-only.

Needs ``transformers`` and ``safetensors``; never downloads.  ``--device
cuda`` without a CUDA device exits 1.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("none", "int8", "w8a8")


def log(msg: str) -> None:
    print(f"[torch_verify_vs_hf] {msg}", flush=True)


def hf_models(cfg):
    """HF's audio encoder and text decoder at ``cfg``'s dims, random init
    from the torch seed in force, float32, eval mode."""
    # transformers also imports TensorFlow and JAX/Flax when they are
    # installed (unless it was imported before); the oracle needs only its
    # PyTorch models.
    for var in ("USE_TF", "USE_FLAX", "USE_JAX"):
        os.environ.setdefault(var, "0")
    import transformers
    from transformers.models.qwen3_omni_moe.modeling_qwen3_omni_moe import (
        Qwen3OmniMoeAudioEncoder,
        Qwen3OmniMoeAudioEncoderConfig,
    )

    enc_c, dec_c = cfg.audio_encoder, cfg.text_decoder
    hf_enc = Qwen3OmniMoeAudioEncoder(
        Qwen3OmniMoeAudioEncoderConfig(
            num_mel_bins=enc_c.num_mel_bins,
            encoder_layers=enc_c.encoder_layers,
            encoder_attention_heads=enc_c.encoder_attention_heads,
            encoder_ffn_dim=enc_c.encoder_ffn_dim,
            d_model=enc_c.d_model,
            output_dim=enc_c.output_dim,
            n_window=enc_c.n_window,
            n_window_infer=enc_c.n_window_infer,
            downsample_hidden_size=enc_c.downsample_hidden_size,
            max_source_positions=enc_c.max_source_positions,
            dropout=0.0,
            attention_dropout=0.0,
        )
    ).float().eval()
    hf_dec = transformers.Qwen3ForCausalLM(
        transformers.Qwen3Config(
            hidden_size=dec_c.hidden_size,
            num_hidden_layers=dec_c.num_hidden_layers,
            num_attention_heads=dec_c.num_attention_heads,
            num_key_value_heads=dec_c.num_key_value_heads,
            head_dim=dec_c.head_dim,
            intermediate_size=dec_c.intermediate_size,
            vocab_size=dec_c.vocab_size,
            rope_theta=dec_c.rope_theta,
            rms_norm_eps=dec_c.rms_norm_eps,
            max_position_embeddings=dec_c.max_position_embeddings,
            tie_word_embeddings=True,
            attention_bias=False,
            use_cache=False,
        )
    ).float().eval()
    return hf_enc, hf_dec


def save_hf_checkpoint(hf_enc, hf_dec, directory) -> Path:
    """HF's weights in the published layout: ``audio_tower.*`` and
    ``model.*`` in one ``model.safetensors``.  The lm head is tied to the
    embedding; published checkpoints omit it (and safetensors refuses
    aliased tensors)."""
    from safetensors.torch import save_file

    tensors = {f"audio_tower.{k}": v.contiguous() for k, v in hf_enc.state_dict().items()}
    for k, v in hf_dec.state_dict().items():
        if k != "lm_head.weight":
            tensors[k] = v.contiguous()
    path = Path(directory) / "model.safetensors"
    save_file(tensors, str(path))
    return path


def hf_encode_windowed(hf_enc, mel_valid: np.ndarray) -> np.ndarray:
    """HF audio-encoder forward with its documented windowed attention.

    transformers' sdpa/eager code path passes ``attention_mask=None`` to the
    attention interface and never calls its own ``_prepare_attention_mask``:
    ``cu_seqlens`` only takes effect under flash_attention_2 (CUDA only).
    The real model's semantics (HF's FA2 varlen path) are block-diagonal,
    so for multi-window clips HF's own layers run under HF's own
    ``_prepare_attention_mask`` block mask, from the layer input captured
    by a pre-hook."""
    import torch

    cap = {}

    def pre_hook(mod, args, kwargs):
        # Membership checks, not truthiness: `tensor or args[0]` raises on
        # multi-element tensors, and args may be empty when transformers
        # passes everything by keyword.
        h = kwargs["hidden_states"] if "hidden_states" in kwargs else args[0]
        cap["h"] = h.detach().clone()
        cap["cu"] = kwargs["cu_seqlens"] if "cu_seqlens" in kwargs else args[1]

    handle = hf_enc.layers[0].register_forward_pre_hook(pre_hook, with_kwargs=True)
    try:
        with torch.no_grad():
            hf_enc(torch.from_numpy(mel_valid), feature_lens=torch.tensor([mel_valid.shape[1]]))
    finally:
        handle.remove()

    h, cu = cap["h"], cap["cu"]
    mask = hf_enc._prepare_attention_mask(h, cu)
    with torch.no_grad():
        for layer in hf_enc.layers:
            h = layer(h, cu, attention_mask=mask)[0]
        h = hf_enc.ln_post(h)
        h = hf_enc.act(hf_enc.proj1(h))
        h = hf_enc.proj2(h)
    return h.numpy()


def hf_oracle(cfg, workdir, max_new: int = 8, t_valid: int = 1000, n_prompt: int = 96,
              say=log) -> dict:
    """Build HF's models (torch seed 0), write their checkpoint under
    ``workdir``, compute HF's encoder output over ``t_valid`` random mel
    frames, its prefill logits over ``n_prompt`` random ids with 32 rows of
    injected "audio" features, and ``max_new`` greedy tokens (a full
    re-forward per token), then free the models.  Returns the inputs, the
    outputs and the checkpoint's directory."""
    import torch

    t0 = time.time()
    torch.manual_seed(0)
    say("building HF models (random init)...")
    hf_enc, hf_dec = hf_models(cfg)
    say(f"HF models built in {time.time() - t0:.1f}s")
    save_hf_checkpoint(hf_enc, hf_dec, workdir)
    say(f"checkpoint written to {workdir} at {time.time() - t0:.1f}s")

    enc_c, dec_c = cfg.audio_encoder, cfg.text_decoder
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((enc_c.num_mel_bins, t_valid)).astype(np.float32)
    ref_enc = hf_encode_windowed(hf_enc, mel)
    say(f"HF encoder forward done at {time.time() - t0:.1f}s")

    ids = rng.integers(0, dec_c.vocab_size, size=(1, n_prompt))
    audio_pos = np.arange(8, 8 + 32)              # 32 injected "audio token" rows
    inj = (0.5 * rng.standard_normal((32, dec_c.hidden_size))).astype(np.float32)
    embed = hf_dec.get_input_embeddings()
    with torch.no_grad():
        emb = embed(torch.from_numpy(ids)).clone()
        emb[0, torch.from_numpy(audio_pos)] = torch.from_numpy(inj)
        ref_logits = hf_dec(inputs_embeds=emb).logits.numpy()
        say(f"HF decoder prefill done at {time.time() - t0:.1f}s")
        hf_tokens, cur = [], emb
        for _ in range(max_new):
            nxt = int(torch.argmax(hf_dec(inputs_embeds=cur).logits[0, -1]))
            hf_tokens.append(nxt)
            cur = torch.cat([cur, embed(torch.tensor([[nxt]]))], dim=1)
    say(f"HF greedy loop done at {time.time() - t0:.1f}s: {hf_tokens}")
    del hf_enc, hf_dec, embed, emb, cur
    return {"mel": mel, "ref_enc": ref_enc, "ids": ids, "audio_pos": audio_pos, "inj": inj,
            "ref_logits": ref_logits, "hf_tokens": hf_tokens, "dir": Path(workdir)}


@contextlib.contextmanager
def quant_mode(enc_params, dec_params, mode: str):
    """(encoder, decoder, activation-gate context factory) for ``mode``:
    the parameters as they are for "none"; int8 decoder weights for "int8";
    for "w8a8" also int8 encoder weights, the encoder's row gate at 8 and
    the decoder's at 2 (restored on exit)."""
    from qwen3_asr_tpu_torch.models import encoder as enc_mod
    from qwen3_asr_tpu_torch.ops.quant import (
        act_quant_rows,
        quantize_decoder_params,
        quantize_encoder_params,
    )

    if mode == "none":
        yield enc_params, dec_params, contextlib.nullcontext
        return
    dec_params = quantize_decoder_params(dec_params)
    if mode == "int8":
        yield enc_params, dec_params, contextlib.nullcontext
        return
    # W8A8 at these small verification shapes: the default row gates would
    # keep everything weight-only and prove nothing; min_rows=2 keeps the
    # 1-token greedy steps on the weight-only path, as in production.
    saved = enc_mod._ACT_QUANT_ENC_MIN_ROWS
    enc_mod._ACT_QUANT_ENC_MIN_ROWS = 8
    try:
        yield quantize_encoder_params(enc_params), dec_params, lambda: act_quant_rows(2)
    finally:
        enc_mod._ACT_QUANT_ENC_MIN_ROWS = saved


def port_outputs(cfg, enc_params, dec_params, oracle: dict, act_ctx, device) -> dict:
    """The port's encoder features, prefill logits and greedy tokens on the
    oracle's inputs: the fresh prefill into a cache of ``n_prompt + 16``
    slots (at least ``max_new`` decode slots), then one split decode step
    per token, each writing its row at ``n_prompt + t`` and attending the
    prompt and the decode rows before it."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import (
        decoder_forward,
        decoder_logits,
        embed_tokens,
        init_kv_cache,
    )
    from qwen3_asr_tpu_torch.models.encoder import encoder_forward

    enc_c, dec_c = cfg.audio_encoder, cfg.text_decoder
    dtype = dec_params["final_norm"].dtype
    mel = oracle["mel"]
    t_valid = mel.shape[1]
    t_pad = -(-t_valid // enc_c.n_window_infer) * enc_c.n_window_infer
    mel_p = np.zeros((1, enc_c.num_mel_bins, t_pad), np.float32)
    mel_p[0, :, :t_valid] = mel
    n_prompt = oracle["ids"].shape[1]
    max_new = len(oracle["hf_tokens"])
    pb = n_prompt
    with torch.inference_mode():
        feats, n_tok = encoder_forward(
            enc_params, enc_c, torch.from_numpy(mel_p).to(device),
            torch.tensor([t_valid], dtype=torch.int32, device=device))
        got_enc = feats[0, : int(n_tok[0])].float().cpu().numpy()

        h = embed_tokens(dec_params, torch.from_numpy(oracle["ids"]).to(device))
        h[0, torch.from_numpy(oracle["audio_pos"]).to(device)] = (
            torch.from_numpy(oracle["inj"]).to(device, h.dtype))
        kv = init_kv_cache(dec_c, 1, pb + max(16, max_new), dtype, device)
        with act_ctx():
            out, kv = decoder_forward(dec_params, dec_c, h,
                                      torch.arange(n_prompt, device=device)[None], kv)
            logits = decoder_logits(dec_params, dec_c, out)
        got_logits = logits.cpu().numpy()

        plen = torch.tensor([n_prompt], dtype=torch.int32, device=device)
        tokens = []
        last = int(np.argmax(got_logits[0, -1]))
        for t in range(max_new):
            tokens.append(last)
            if t == max_new - 1:
                break
            nh = embed_tokens(dec_params, torch.tensor([[last]], device=device))
            slot = torch.tensor([pb + t], dtype=torch.int32, device=device)
            with act_ctx():
                out, kv = decoder_forward(
                    dec_params, dec_c, nh, torch.tensor([[n_prompt + t]], device=device), kv,
                    write_slots=slot, decode_ctx=(plen, slot, pb))
                last = int(torch.argmax(decoder_logits(dec_params, dec_c, out)[0, 0]))
    return {"enc": got_enc, "logits": got_logits, "tokens": tokens}


def judge(oracle: dict, got: dict, lossy: bool, tag: str, say=log) -> list[str]:
    """The JAX tool's gates (module docstring) on one mode's outputs; logs
    its lines and returns the failures."""
    failures = []
    ref_enc, got_enc = oracle["ref_enc"], got["enc"]
    same_shape = got_enc.shape == ref_enc.shape
    d = float(np.abs(got_enc - ref_enc).max()) if same_shape else float("inf")
    say(f"encoder max|diff| = {d:.3e} over {ref_enc.shape} ({tag})")
    if not lossy:
        if not (same_shape and d < 5e-4):
            failures.append(f"encoder mismatch: {d:.3e}")
    else:
        rel = d / (np.abs(ref_enc).max() + 1e-9)
        say(f"encoder rel err vs f32 oracle = {rel:.3e} ({tag})")
        if not (same_shape and rel < 0.05):
            failures.append(f"encoder rel err too large: {rel:.3e}")

    ref_logits, got_logits = oracle["ref_logits"], got["logits"]
    d = float(np.abs(got_logits - ref_logits).max())
    agree = float((got_logits.argmax(-1) == ref_logits.argmax(-1)).mean())
    say(f"decoder prefill max|diff| = {d:.3e}, per-position argmax agreement = {agree:.4f} "
        f"({tag})")
    if not lossy:
        if not (d < 2e-3 and agree == 1.0):
            failures.append(f"decoder prefill mismatch: {d:.3e}, agree {agree}")
    else:
        delta = got_logits.astype(np.float64) - ref_logits
        rms = float(np.sqrt((delta ** 2).mean()))
        rms_rel = rms / float(ref_logits.astype(np.float64).std())
        top2 = np.partition(ref_logits, -2, axis=-1)
        margins = top2[..., -1] - top2[..., -2]          # oracle top-2 gaps
        flips = np.nonzero(got_logits.argmax(-1) != ref_logits.argmax(-1))
        flip_margins = [
            float(ref_logits[b, p].max() - ref_logits[b, p, got_logits[b, p].argmax()])
            for b, p in zip(*flips)
        ]
        max_flip_margin = max(flip_margins, default=0.0)
        say(f"quant perturbation: rms|dlogit| {rms:.4f} (rel {rms_rel:.4f}), "
            f"oracle margin p50 {np.median(margins):.4f}, agreement {agree:.4f}, "
            f"flips {len(flip_margins)} (max margin {max_flip_margin:.4f}) ({tag})")
        if rms_rel > 0.25:
            failures.append(f"logit rms rel err {rms_rel:.4f} > 0.25")
        if max_flip_margin > 10 * rms:
            failures.append(f"argmax flip at margin {max_flip_margin:.4f} > 10 x "
                            f"rms|dlogit| {rms:.4f}: systematic, not noise-scale")

    hf_tokens, my_tokens = oracle["hf_tokens"], got["tokens"]
    say(f"our greedy loop ({tag}): {my_tokens}")
    if my_tokens != hf_tokens:
        if not lossy:
            failures.append(f"greedy tokens differ: {my_tokens} vs {hf_tokens}")
        else:
            div = next((i for i, (a, b) in enumerate(zip(my_tokens, hf_tokens)) if a != b),
                       len(my_tokens))
            say(f"greedy rollout diverges at step {div}/{len(hf_tokens)} ({tag}; "
                "expected near ties, not gated)")
    return failures


def compare(cfg, device: str = "cpu", modes=("none",), max_new: int = 8, t_valid: int = 1000,
            n_prompt: int = 96, say=log) -> dict[str, list[str]]:
    """Hold the port at ``cfg`` on ``device`` to HF in each of ``modes``
    ("none", "int8", "w8a8"): one oracle, one load of the checkpoint (f32
    on the CPU, bf16 on a CUDA device), then each mode's outputs judged by
    its gates.  Returns the failures per mode (empty lists = all passed)."""
    import torch

    from qwen3_asr_tpu_torch.models.params import load_checkpoint
    from qwen3_asr_tpu_torch.ops.kernels import _build

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="hf_real_ckpt_")
    try:
        oracle = hf_oracle(cfg, tmp, max_new, t_valid, n_prompt, say)
        dtype = torch.bfloat16 if device == "cuda" else torch.float32
        enc_params, dec_params = load_checkpoint(tmp, cfg, dtype=dtype, device=device)
        say(f"loaded via the qwen3_asr_tpu_torch loader ({dtype}, {device}) at "
            f"{time.time() - t0:.1f}s")
    finally:
        # 7.6 GB at real dims.
        shutil.rmtree(tmp, ignore_errors=True)

    lossy_device = device == "cuda"
    results = {}
    for mode in modes:
        tag = f"{mode}, {device}"
        before = _build.LAUNCHES.copy()
        with quant_mode(enc_params, dec_params, mode) as (enc, dec, act_ctx):
            got = port_outputs(cfg, enc, dec, oracle, act_ctx, device)
        launches = _build.LAUNCHES - before
        say(f"port outputs done at {time.time() - t0:.1f}s ({tag}); kernel launches: "
            f"{dict(sorted(launches.items())) or 'none (plain versions)'}")
        results[mode] = judge(oracle, got, mode != "none" or lossy_device, tag, say)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--quant", choices=MODES, nargs="+", default=["none"],
        help="quantize the port's params before comparing (fidelity bound mode); "
        "several modes share one oracle",
    )
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="cpu: f32 plain versions; cuda: the card's bf16 kernels")
    args = ap.parse_args()

    t0 = time.time()
    missing = [m for m in ("transformers", "safetensors") if importlib.util.find_spec(m) is None]
    if missing:
        log(f"FAIL: {' and '.join(missing)} not importable (nothing is downloaded)")
        return 1
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("FAIL: --device cuda needs a CUDA device")
            return 1
        from chip_smoke import card_identity

        print(card_identity(), flush=True)

    from qwen3_asr_tpu_torch import ModelConfig

    results = compare(ModelConfig(), args.device, args.quant, args.max_new)
    failed = False
    for mode, failures in results.items():
        for f in failures:
            log(f"FAIL ({mode}): {f}")
        failed = failed or bool(failures)
    if failed:
        return 1
    log(f"ALL REAL-DIM COMPARISONS PASSED [{', '.join(args.quant)}; {args.device}] in "
        f"{time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
