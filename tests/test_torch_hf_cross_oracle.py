"""The PyTorch port held to HuggingFace ``transformers`` (the port's side of
``tests/test_hf_cross_oracle.py``, every case with its tolerance).

``transformers`` ships independent, third-party PyTorch implementations of
both halves of Qwen3-ASR: the audio tower as ``Qwen3OmniMoeAudioEncoder``
and the text decoder as ``Qwen3ForCausalLM``.  Tiny HF models export their
``state_dict`` through the published checkpoint layout (``audio_tower.*`` /
``model.*`` in one ``model.safetensors``, torch ``(O, I, KH, KW)`` conv
layout), the port's own loader (``models/params.py`` ``load_checkpoint``)
reads that file, and the two must agree in float32, greedy tokens through
the cached forward with injected audio features included.  The sampler's
transforms are held to HF's logits processors and the mel frontend to
``transformers.audio_utils``.  The HF-side helpers are
``tools/torch_verify_vs_hf.py``'s, which runs the same comparison at the
real 1.7B dims.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3_asr_tpu_torch.config import AudioEncoderConfig, ModelConfig, TextDecoderConfig
from qwen3_asr_tpu_torch.models.decoder import (
    decoder_forward,
    decoder_logits,
    embed_tokens,
    init_kv_cache,
)
from qwen3_asr_tpu_torch.models.encoder import encoder_forward
from qwen3_asr_tpu_torch.models.params import load_checkpoint

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))
try:
    from torch_verify_vs_hf import hf_encode_windowed, hf_models, save_hf_checkpoint
finally:
    sys.path.remove(str(TOOLS))

if not all(importlib.util.find_spec(m) for m in ("transformers", "safetensors")):
    # Looked up, not imported: the HF models' first import happens in
    # hf_models, which keeps transformers to its PyTorch side.
    pytest.skip("needs transformers and safetensors", allow_module_level=True)

# Tiny dims with the 1.7B config's shape relationships: mel 128 (the conv
# stem's 128 -> 16 frequency collapse), head_dim decoupled from
# hidden/heads, GQA 2:1, and the real window math (n_window 50,
# n_window_infer 800: 104-token attention blocks).
ENC = AudioEncoderConfig(
    d_model=64,
    encoder_layers=2,
    encoder_attention_heads=4,
    encoder_ffn_dim=128,
    num_mel_bins=128,
    output_dim=32,
    n_window=50,
    n_window_infer=800,
    downsample_hidden_size=16,
)
DEC = TextDecoderConfig(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    intermediate_size=64,
    vocab_size=512,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
)
CFG = ModelConfig(audio_encoder=ENC, text_decoder=DEC)


@pytest.fixture(scope="module")
def hf_and_mine(tmp_path_factory):
    """Tiny HF models, their weights round-tripped through a checkpoint in
    the published layout, loaded by the port's loader in float32."""
    torch.manual_seed(0)
    hf_enc, hf_dec = hf_models(CFG)
    ckpt = tmp_path_factory.mktemp("hf_ckpt")
    save_hf_checkpoint(hf_enc, hf_dec, ckpt)
    enc_params, dec_params = load_checkpoint(ckpt, CFG, dtype=torch.float32, device="cpu")
    return hf_enc, hf_dec, enc_params, dec_params


def _my_encode(enc_params, mel_valid: np.ndarray) -> np.ndarray:
    """The port's encoder on one clip: only the valid tokens."""
    n_mels, t_valid = mel_valid.shape
    t_pad = -(-t_valid // ENC.n_window_infer) * ENC.n_window_infer
    mel = np.zeros((1, n_mels, t_pad), np.float32)
    mel[0, :, :t_valid] = mel_valid
    with torch.inference_mode():
        feats, n_tok = encoder_forward(
            enc_params, ENC, torch.from_numpy(mel), torch.tensor([t_valid], dtype=torch.int32))
    return feats[0, : int(n_tok[0])].numpy()


@pytest.mark.parametrize(
    "t_valid",
    [
        100,   # exactly one chunk
        250,   # padded tail chunk (13 + 13 + 7 = 33 tokens)
        1650,  # several 104-token attention windows + a ragged tail block
    ],
)
def test_encoder_matches_hf(hf_and_mine, t_valid):
    hf_enc, _, enc_params, _ = hf_and_mine
    rng = np.random.default_rng(t_valid)
    mel = rng.standard_normal((ENC.num_mel_bins, t_valid)).astype(np.float32)

    if t_valid <= ENC.n_window_infer:
        # One attention window: HF's plain forward is exact (dense ==
        # windowed when everything fits one block).
        with torch.no_grad():
            ref = hf_enc(torch.from_numpy(mel),
                         feature_lens=torch.tensor([t_valid])).last_hidden_state.numpy()
    else:
        ref = hf_encode_windowed(hf_enc, mel)

    got = _my_encode(enc_params, mel)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_encoder_batch_matches_hf_per_clip(hf_and_mine):
    """The port's batched padded encoder == HF run clip by clip."""
    hf_enc, _, enc_params, _ = hf_and_mine
    rng = np.random.default_rng(7)
    lens = [250, 730]
    mels = [rng.standard_normal((ENC.num_mel_bins, t)).astype(np.float32) for t in lens]

    batch = np.zeros((2, ENC.num_mel_bins, 800), np.float32)
    for i, m in enumerate(mels):
        batch[i, :, : m.shape[1]] = m
    with torch.inference_mode():
        feats, n_tok = encoder_forward(enc_params, ENC, torch.from_numpy(batch),
                                       torch.tensor(lens, dtype=torch.int32))
    for i, m in enumerate(mels):
        with torch.no_grad():
            ref = hf_enc(torch.from_numpy(m),
                         feature_lens=torch.tensor([m.shape[1]])).last_hidden_state.numpy()
        got = feats[i, : int(n_tok[i])].numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_decoder_logits_match_hf(hf_and_mine):
    _, hf_dec, _, dec_params = hf_and_mine
    ids = np.array([[7, 42, 99, 3, 256, 17, 501, 0, 12]], np.int64)

    with torch.no_grad():
        ref = hf_dec(input_ids=torch.from_numpy(ids)).logits.numpy()

    T = ids.shape[1]
    with torch.inference_mode():
        h = embed_tokens(dec_params, torch.from_numpy(ids))
        out, _ = decoder_forward(dec_params, DEC, h, torch.arange(T)[None],
                                 init_kv_cache(DEC, 1, T, torch.float32))
        got = decoder_logits(dec_params, DEC, out).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_greedy_decode_with_audio_injection_matches_hf(hf_and_mine):
    """Token-identical greedy continuation, audio features injected into
    the prompt embeddings, the port's side stepping the cached forward
    (``write_slots``) one token at a time."""
    _, hf_dec, _, dec_params = hf_and_mine
    rng = np.random.default_rng(3)
    prompt = np.array([[5, 150, 151, 151, 151, 152, 9, 30]], np.int64)
    audio_pos = [3, 4]  # stand-ins for <|audio_pad|> slots
    feats = (0.5 * rng.standard_normal((len(audio_pos), DEC.hidden_size))).astype(np.float32)
    max_new = 12

    # HF: a full re-forward per step over the growing inputs_embeds.
    emb_layer = hf_dec.get_input_embeddings()
    with torch.no_grad():
        emb = emb_layer(torch.from_numpy(prompt)).clone()
        for j, p in enumerate(audio_pos):
            emb[0, p] = torch.from_numpy(feats[j])
        hf_tokens = []
        for _ in range(max_new):
            logits = hf_dec(inputs_embeds=emb).logits
            nxt = int(torch.argmax(logits[0, -1]))
            hf_tokens.append(nxt)
            emb = torch.cat([emb, emb_layer(torch.tensor([[nxt]]))], dim=1)

    # The port: the prompt written into a preallocated cache, then one
    # cached forward per token.
    T = prompt.shape[1]
    my_tokens = []
    with torch.inference_mode():
        h = embed_tokens(dec_params, torch.from_numpy(prompt))
        h[0, torch.tensor(audio_pos)] = torch.from_numpy(feats)
        kv = init_kv_cache(DEC, 1, T + max_new, torch.float32)
        out, kv = decoder_forward(dec_params, DEC, h, torch.arange(T)[None], kv,
                                  write_slots=torch.zeros((1,), dtype=torch.int32))
        last = int(torch.argmax(decoder_logits(dec_params, DEC, out[:, -1:])[0, 0]))
        for t in range(max_new):
            my_tokens.append(last)
            if t == max_new - 1:
                break
            nh = embed_tokens(dec_params, torch.tensor([[last]]))
            out, kv = decoder_forward(dec_params, DEC, nh, torch.tensor([[T + t]]), kv,
                                      write_slots=torch.tensor([T + t], dtype=torch.int32))
            last = int(torch.argmax(decoder_logits(dec_params, DEC, out)[0, 0]))

    assert my_tokens == hf_tokens


# -- sampling transforms vs HF logits processors -----------------------------
#
# The sampler's rules coincide with HF's processors: the repetition penalty
# divides positive / multiplies negative scores of seen ids
# (RepetitionPenaltyLogitsProcessor), top-k keeps everything >= the k-th
# largest, ties included (TopKLogitsWarper), and "drop exclusive-cumsum >=
# p over the descending sort" is HF's TopPLogitsWarper rule (keep the
# ascending suffix with inclusive cumsum > 1-p: a token at descending
# exclusive cumsum E has ascending inclusive cumsum 1-E, and 1-E <= 1-p <=>
# E >= p).


def _hf_warp(processor, logits: np.ndarray, ids=None) -> np.ndarray:
    from transformers.generation.logits_process import (
        RepetitionPenaltyLogitsProcessor,
        TopKLogitsWarper,
        TopPLogitsWarper,
    )

    kinds = {
        "rep": RepetitionPenaltyLogitsProcessor,
        "topk": TopKLogitsWarper,
        "topp": TopPLogitsWarper,
    }
    kind, arg = processor
    proc = kinds[kind](arg)
    ids_t = torch.tensor(ids if ids is not None else [[]], dtype=torch.long)
    with torch.no_grad():
        return proc(ids_t, torch.from_numpy(logits.copy())).numpy()


def test_repetition_penalty_matches_hf():
    from qwen3_asr_tpu_torch.ops.sampling import RECENT_PAD_ID, apply_repetition_penalty

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((1, 64)).astype(np.float32) * 3.0
    logits[0, 7] = 0.0  # the sign-boundary case
    seen = [3, 7, 7, 50, 63]  # duplicates must not double-penalize

    for penalty in (1.2, 2.0, 0.7):
        ref = _hf_warp(("rep", penalty), logits, ids=[seen])
        window = np.full(16, RECENT_PAD_ID, np.int64)
        window[: len(seen)] = seen
        got = apply_repetition_penalty(
            torch.from_numpy(logits), torch.from_numpy(window)[None], penalty).numpy()
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6)


def test_top_k_matches_hf():
    from qwen3_asr_tpu_torch.ops.sampling import top_k_mask

    rng = np.random.default_rng(1)
    logits = rng.standard_normal(64).astype(np.float32)
    logits[10] = logits[20] = 1.5  # a tie exactly at a potential threshold

    for k in (1, 5, 20, 64):
        ref = _hf_warp(("topk", k), logits[None])[0]
        got = top_k_mask(torch.from_numpy(logits)[None], k)[0].numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_top_p_matches_hf():
    from qwen3_asr_tpu_torch.ops.sampling import top_p_mask

    rng = np.random.default_rng(2)
    logits = (rng.standard_normal(64) * 2.0).astype(np.float32)

    for p in (0.1, 0.5, 0.9, 0.99):
        ref = _hf_warp(("topp", p), logits[None])[0]
        got = top_p_mask(torch.from_numpy(logits)[None], p)[0].numpy()
        # The same kept set and identical surviving logits.
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        np.testing.assert_allclose(got[~np.isinf(got)], ref[~np.isinf(ref)], atol=1e-6)


# -- mel frontend vs transformers' audio_utils --------------------------------
#
# transformers ships independent implementations of every math step of the
# frontend: ``audio_utils.spectrogram`` (framing, center=True reflect pad,
# windowed rFFT, power, mel matmul, floored log10) and
# ``audio_utils.mel_filter_bank`` (triangles + Slaney area norm).  The
# frontend's parameters differ from Whisper's defaults in two documented
# ways, held fixed here as inputs:
#
#   * window: the symmetric ``np.hanning(400)``, not Whisper's periodic Hann;
#   * filterbank norm: HTK-scale triangles divided by the full base width in
#     Hz, exactly HALF of transformers' ``norm="slaney"`` (2 / width).  The
#     factor is a uniform +log10(2) shift of the log-mel that the max-8
#     clamp and the (x+4)/4 affine keep: a constant log10(2)/4 offset in
#     the final features (pinned below).


def _mel_consts():
    from qwen3_asr_tpu_torch.audio import mel as m

    return m.N_FFT, m.HOP_LENGTH, m.N_MELS, m.SAMPLE_RATE, m.F_MIN, m.F_MAX


def _hf_filterbank():
    """transformers' HTK-scale Slaney-normalized filterbank, (n_freqs, n_mels)."""
    from transformers.audio_utils import mel_filter_bank

    n_fft, _, n_mels, sr, f_min, f_max = _mel_consts()
    return mel_filter_bank(
        num_frequency_bins=n_fft // 2 + 1,
        num_mel_filters=n_mels,
        min_frequency=f_min,
        max_frequency=f_max,
        sampling_rate=sr,
        norm="slaney",
        mel_scale="htk",
    )


def test_mel_filterbank_matches_hf():
    from qwen3_asr_tpu_torch.audio.mel import mel_filterbank

    hf = _hf_filterbank()            # (n_freqs, n_mels), 2 / width norm
    ours = mel_filterbank()          # (n_mels, n_freqs), 1 / width norm
    assert hf.T.shape == ours.shape
    np.testing.assert_allclose(2.0 * ours, hf.T, atol=1e-7, rtol=1e-5)


def _hf_log_mel(audio: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Whisper's post-processing over transformers' spectrogram(), with the
    window and the filterbank passed in as parameters."""
    from transformers.audio_utils import spectrogram

    n_fft, hop, _, _, _, _ = _mel_consts()
    log_spec = spectrogram(
        audio.astype(np.float64),
        np.hanning(n_fft),           # the frontend's symmetric Hann
        frame_length=n_fft,
        hop_length=hop,
        power=2.0,
        center=True,
        pad_mode="reflect",
        mel_filters=filters,
        mel_floor=1e-10,
        log_mel="log10",
    )
    log_spec = log_spec[:, :-1]      # the last STFT frame is dropped
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


@pytest.mark.parametrize("n_samples", [16_000, 11_731, 640])
def test_log_mel_matches_hf_spectrogram(n_samples):
    """The port's mel == HF's spectrogram pipeline run with the port's
    filterbank (itself pinned to HF's above): framing, reflect pad,
    windowed rFFT, power, mel projection, floor, log, clamp and
    normalization, all against third-party code."""
    from qwen3_asr_tpu_torch.audio import log_mel_spectrogram
    from qwen3_asr_tpu_torch.audio.mel import mel_filterbank

    rng = np.random.default_rng(n_samples)
    audio = (0.3 * rng.standard_normal(n_samples)).astype(np.float32)

    ref = _hf_log_mel(audio, mel_filterbank().T.astype(np.float64))
    got = log_mel_spectrogram(audio, device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-4)


def test_log_mel_offset_vs_hf_norm_is_exactly_log10_2_over_4():
    """With HF's own factor-2 Slaney filterbank the whole pipeline lands a
    constant log10(2)/4 above the port's (for signals clear of the 1e-10
    floor): the only end-to-end difference from the canonical HTK-Whisper
    normalization is the half-width norm."""
    from qwen3_asr_tpu_torch.audio import log_mel_spectrogram

    rng = np.random.default_rng(9)
    audio = (0.5 * rng.standard_normal(8_000)).astype(np.float32)

    hf_norm = _hf_log_mel(audio, _hf_filterbank())
    got = log_mel_spectrogram(audio, device="cpu").numpy()
    np.testing.assert_allclose(
        hf_norm - got, np.full_like(hf_norm, np.log10(2.0) / 4.0), atol=5e-4
    )
