"""The PyTorch port's slices as a whole: greedy ``transcribe`` and
``transcribe_batch`` (under the default ``speculative="auto"``, so the
n-gram speculative loop at these batch sizes) are token-identical to the
JAX package on the same tiny float32 checkpoint, in bf16 and under each
int8 setting (``quantization``, ``act_quant``, ``kv_cache_dtype``, alone
and together); what the port leaves out raises ``NotImplementedError``;
importing the port needs neither JAX nor nvcc."""

from __future__ import annotations

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import clips, ids_of, models

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair():
    return models(seed=0)


def test_transcribe_batch_token_identical(pair):
    jax_model, port = pair
    audio = clips((1.0, 2.3, 5.1), seed=1)
    ref = jax_model.transcribe_batch(audio, max_tokens=12)
    out = port.transcribe_batch(audio, max_tokens=12)
    ref_ids, out_ids = ids_of(ref), ids_of(out)
    assert out_ids == ref_ids
    assert all(len(t) == 12 for t in out_ids)
    assert len({t for seq in out_ids for t in seq}) > 3      # not degenerate
    assert [r.duration for r in out] == [r.duration for r in ref]
    assert [r.language for r in out] == ["English"] * 3
    assert port.last_stats.n_generated_tokens == 36
    # B=3 pads to 4 lanes and speculates: decode steps are verify
    # iterations, and lane-forwards count them once per real lane.
    iters = jax_model._generator.last_spec_forwards
    assert 0 < iters <= 11
    assert port.last_stats.n_decode_steps == iters
    assert port.last_stats.n_spec_forwards == jax_model.last_stats.n_spec_forwards == 3 * iters


def test_transcribe_token_identical_with_default_budget(pair):
    jax_model, port = pair
    audio = clips((3.7,), seed=2)[0]
    ref = jax_model.transcribe(audio, max_tokens=20, language="de")
    out = port.transcribe(audio, max_tokens=20, language="de")
    assert ids_of([out]) == ids_of([ref])
    assert out.language == ref.language == "German"


def test_int16_and_detect_mode_token_identical(pair):
    jax_model, port = pair
    audio = [(a * 30000).astype(np.int16) for a in clips((1.5, 0.4), seed=3)]
    ref = jax_model.transcribe_batch(audio, max_tokens=6, language="detect")
    out = port.transcribe_batch(audio, max_tokens=6, language="detect")
    assert [(r.text, r.language) for r in out] == [(r.text, r.language) for r in ref]


def test_repetition_penalty_off_token_identical(pair):
    jax_model, port = pair
    audio = clips((2.0,), seed=4)
    ref = jax_model.transcribe_batch(audio, max_tokens=10, repetition_penalty=1.0)
    out = port.transcribe_batch(audio, max_tokens=10, repetition_penalty=1.0)
    assert ids_of(out) == ids_of(ref)


def test_empty_and_invalid_audio(pair):
    _, port = pair
    res = port.transcribe(np.zeros(0, np.float32))
    assert (res.text, res.language, res.duration) == ("", "Unknown", 0.0)
    out = port.transcribe_batch([np.zeros(0, np.float32), clips((0.5,))[0]], max_tokens=2)
    assert out[0].text == "" and len(out[1].text.split()) == 2
    with pytest.raises(ValueError):
        port.transcribe(np.zeros((2, 100), np.float32))


#: The int8 settings, alone and together.  ``act_quant_min_rows`` 16 lets
#: the tiny prefill (4 padded lanes x at least 64 rows) take W8A8 while the
#: decode steps (M = 4 rows) stay weight-only; test_torch_quant.py checks
#: that split with a spy.
INT8_SETTINGS = {
    "w8": dict(quantization="int8"),
    "w8a8": dict(quantization="int8", act_quant="int8", act_quant_min_rows=16),
    "kv8": dict(kv_cache_dtype="int8"),
    "all": dict(quantization="int8", act_quant="int8", act_quant_min_rows=16,
                kv_cache_dtype="int8"),
}


@pytest.fixture(scope="module", params=list(INT8_SETTINGS))
def int8_pair(request):
    return models(seed=0, runtime=INT8_SETTINGS[request.param])


def test_int8_transcribe_batch_token_identical(int8_pair):
    jax_model, port = int8_pair
    audio = clips((1.0, 2.3, 5.1), seed=1)
    ref = ids_of(jax_model.transcribe_batch(audio, max_tokens=12))
    out = ids_of(port.transcribe_batch(audio, max_tokens=12))
    assert out == ref
    assert all(len(t) == 12 for t in out)
    assert len({t for seq in out for t in seq}) > 3


def test_int8_transcribe_and_detect_token_identical(int8_pair):
    jax_model, port = int8_pair
    audio = clips((3.7,), seed=2)[0]
    ref = jax_model.transcribe(audio, max_tokens=20, language="de")
    out = port.transcribe(audio, max_tokens=20, language="de")
    assert ids_of([out]) == ids_of([ref])
    pcm = [(a * 30000).astype(np.int16) for a in clips((1.5, 0.4), seed=3)]
    ref = jax_model.transcribe_batch(pcm, max_tokens=6, language="detect")
    out = port.transcribe_batch(pcm, max_tokens=6, language="detect")
    assert [(r.text, r.language) for r in out] == [(r.text, r.language) for r in ref]


def test_unported_features_raise(pair):
    """Only multi-device meshes are left out; sampling, long-form chunking
    and ``speculative="ngram"`` (with either cache) construct and run."""
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig

    _, port = pair
    for rt in ({"dp": 2}, {"tp": 2}, {"dp": 2, "speculative": "ngram"}):
        with pytest.raises(NotImplementedError, match="multi-device"):
            Qwen3ASR(port._config, port._encoder_params, port._decoder_params,
                     port._tokenizer, RuntimeConfig(**rt))
    for rt in ({"speculative": "ngram"},
               {"speculative": "ngram", "kv_cache_dtype": "int8"}):
        Qwen3ASR(port._config, port._encoder_params, port._decoder_params,
                 port._tokenizer, RuntimeConfig(**rt))


def test_wav_file_round_trip(pair, tmp_path):
    _, port = pair
    audio = clips((0.8,), seed=6)[0]
    pcm = (audio * 32767).astype("<i2").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
    header += b"data" + struct.pack("<I", len(pcm))
    path = tmp_path / "clip.wav"
    path.write_bytes(header + pcm)
    from_file = port.transcribe(str(path), max_tokens=4)
    from_array = port.transcribe((audio * 32767).astype(np.int16).astype(np.float32) / 32768.0,
                                 max_tokens=4)
    assert from_file.text == from_array.text
    assert from_file.duration == pytest.approx(0.8)


def test_api_tables_match_jax(pair):
    from qwen3_asr_tpu.api import LANGUAGE_MAP as JAX_MAP

    from qwen3_asr_tpu_torch import LANGUAGE_MAP

    jax_model, port = pair
    assert LANGUAGE_MAP == JAX_MAP
    for b in (1, 2, 3, 5, 8, 9, 17, 96):
        assert port._batch_bucket(b) == jax_model._batch_bucket(b)
    for n in (0, 1, 99, 100, 731, 3000):
        assert port._n_audio_tokens(n) == jax_model._n_audio_tokens(n)
    for lang in (None, "auto", "", "de", "DE", "Klingon", "detect"):
        assert port._resolve_language(lang) == jax_model._resolve_language(lang)


def test_context_manager_closes(pair):
    from qwen3_asr_tpu_torch import Qwen3ASR

    _, port = pair
    with Qwen3ASR(port._config, port._encoder_params, port._decoder_params,
                  port._tokenizer, port._runtime) as m:
        m.warm_up(durations=(0.3,), batch_sizes=(2,), max_tokens=2)
    assert m._generator is None and m._decoder_params is None


def test_import_needs_neither_jax_nor_nvcc(tmp_path):
    code = (
        "import sys\n"
        "import qwen3_asr_tpu_torch\n"
        "from qwen3_asr_tpu_torch import api, models, runtime\n"
        "from qwen3_asr_tpu_torch.ops.kernels import _build, decode_attention, "
        "flash_attention, kv_write, quantized_matmul, w8a8_matmul\n"
        "from qwen3_asr_tpu_torch.ops import sampling, speculative\n"
        "from qwen3_asr_tpu_torch.ops import quant, quant_kv\n"
        "from qwen3_asr_tpu_torch.ops.kernels.experiments import decode_attention_hbm5, "
        "decode_attention_sched\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qwen3_asr_tpu.'))"
        " or m == 'qwen3_asr_tpu']\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n"
        "print('ok')\n"
    )
    env = {
        "PATH": str(tmp_path),                 # no nvcc on PATH
        "CUDA_HOME": str(tmp_path / "none"),
        "HOME": os.environ.get("HOME", str(tmp_path)),
        "PYTHONPATH": str(REPO),
    }
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_warm_up_deployment_grid(pair, caplog):
    """Mirror of tests/test_api.py's test: the deployment dict's grid, one
    log line per cell and the same closing line."""
    import logging

    _, port = pair
    with caplog.at_level(logging.INFO, logger="qwen3_asr_tpu_torch"):
        port.warm_up(deployment={
            "durations": (0.5, 1.0),
            "batch_sizes": (1, 2),
            "max_tokens": (2,),
        })
    assert "warm_up 4/4" in caplog.text
    assert "warm_up complete: 4 program shapes" in caplog.text


def test_warm_up_tuple_max_tokens(pair, caplog, monkeypatch):
    """A tuple of budgets warms each one: (batch, duration, budget) cells."""
    import logging

    _, port = pair
    seen = []
    real = port.transcribe_batch
    monkeypatch.setattr(port, "transcribe_batch",
                        lambda clips, max_tokens: seen.append((len(clips), max_tokens))
                        or real(clips, max_tokens=max_tokens))
    with caplog.at_level(logging.INFO, logger="qwen3_asr_tpu_torch"):
        port.warm_up(durations=(0.3,), batch_sizes=(1, 3), max_tokens=(2, 3))
    assert seen == [(1, 2), (1, 3), (3, 2), (3, 3)]
    assert "warm_up 4/4: batch=3 duration=0.3s max_tokens=3" in caplog.text
    assert "warm_up complete: 4 program shapes" in caplog.text


#: Public names of the JAX package that later slices bring (ROADMAP Queue 1,
#: "Multi-GPU" and "Streaming and incremental sessions").
LATER_SLICES = {"ReplicatedTranscriptionServer", "IncrementalSession",
                "StreamingTranscriber", "StreamSegment"}


def test_root_exports_match_jax():
    import qwen3_asr_tpu as jax_pkg

    import qwen3_asr_tpu_torch as port_pkg

    assert LATER_SLICES <= set(jax_pkg.__all__)
    assert port_pkg.__all__ == [n for n in jax_pkg.__all__ if n not in LATER_SLICES]
    namespace: dict = {}
    exec("from qwen3_asr_tpu_torch import *", namespace)
    assert set(port_pkg.__all__) - {"__version__"} <= set(namespace)


def test_log_mel_spectrogram_matches_jax():
    """The unbucketed mel against the JAX package's on the CPU (1e-4, as
    tests/test_torch_modules.py holds the batched mel: a framed matmul
    against JAX's strided convolution), float and int16 input."""
    from qwen3_asr_tpu.audio.mel import log_mel_spectrogram as jax_mel

    from qwen3_asr_tpu_torch import log_mel_spectrogram

    for audio in (clips((1.3,), seed=8)[0], (clips((0.7,), seed=9)[0] * 30000).astype(np.int16),
                  np.zeros(100, np.float32)):
        out = log_mel_spectrogram(audio, device="cpu")
        ref = np.asarray(jax_mel(audio))
        assert out.shape == ref.shape == (128, max(1, len(audio) // 160))
        assert out.device.type == "cpu" and out.dtype.is_floating_point
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_log_mel_spectrogram_np_equals_jax():
    from qwen3_asr_tpu.audio.mel import log_mel_spectrogram_np as jax_np

    from qwen3_asr_tpu_torch import log_mel_spectrogram_np

    for audio in (clips((2.1,), seed=10)[0], (clips((0.9,), seed=11)[0] * 30000).astype(np.int16)):
        np.testing.assert_array_equal(log_mel_spectrogram_np(audio), jax_np(audio))
