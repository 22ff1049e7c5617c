"""Long-form transcription in the port against the JAX package, float32 on
the CPU: ``find_split_points`` equals the JAX package's on seeded audio;
chunked ``transcribe`` and ``transcribe_batch`` with long clips pooled into
shared chunk groups give the JAX package's texts; and the chunk-slack
cases of ``tests/test_api.py`` (both snapped boundaries within the largest
frame bucket, a bucket table too small for the full slack) hold.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_parity import RUNTIME, StubTokenizer, clips, configs, models, numpy_params

from qwen3_asr_tpu_torch.audio.io import find_split_points


def _speech_like(seconds: float, seed: int) -> np.ndarray:
    """Tones with a slow loudness envelope and a few quiet gaps."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6))
    x = env * 0.3 * np.sin(2 * np.pi * rng.uniform(150, 600) * t)
    for start in rng.uniform(0, max(seconds - 0.5, 0.0), size=4):
        i = int(start * 16000)
        x[i : i + 2400] *= 0.01
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("chunk_s,search_s", [(2.0, 0.5), (4.0, 5.0), (7.5, 1.2), (30.0, 5.0)])
def test_find_split_points_matches_jax(chunk_s, search_s):
    from qwen3_asr_tpu.audio.io import find_split_points as jax_split

    for seed, seconds in ((0, 23.3), (1, 61.0), (2, 0.01)):
        audio = _speech_like(seconds, seed)
        args = (int(chunk_s * 16000), int(search_s * 16000))
        assert find_split_points(audio, *args) == jax_split(audio, *args)


@pytest.fixture(scope="module")
def pair():
    return models(seed=0)


def test_chunked_transcribe_matches_jax(pair):
    jax_model, port = pair
    audio = _speech_like(10.0, 3)
    ref = jax_model.transcribe(audio, chunk_duration=4.0, max_tokens=2)
    out = port.transcribe(audio, chunk_duration=4.0, max_tokens=2)
    assert (out.text, out.language, out.duration) == (ref.text, ref.language, ref.duration)
    # The chunked path ignores max_tokens (each chunk decodes up to
    # max(256, 50 s) tokens), as the JAX package does.
    assert len(out.text.split()) > 3 * 2
    assert port.last_stats.n_spec_forwards == jax_model.last_stats.n_spec_forwards > 0


def test_pooled_transcribe_batch_matches_jax(pair):
    """Two long clips (3 chunks each) pool into ONE group of 6 chunks
    beside a short clip that runs as its own batch."""
    jax_model, port = pair
    audio = [_speech_like(10.0, 3), clips((1.5,), seed=4)[0], _speech_like(9.0, 5)]
    ref = jax_model.transcribe_batch(audio, chunk_duration=4.0, max_tokens=8)
    calls = []
    real = port._run_pipeline_batch
    port._run_pipeline_batch = lambda batch, *a: calls.append(len(batch)) or real(batch, *a)
    try:
        out = port.transcribe_batch(audio, chunk_duration=4.0, max_tokens=8)
    finally:
        del port._run_pipeline_batch
    assert calls == [1, 6]
    assert [(r.text, r.language, r.duration) for r in out] == \
        [(r.text, r.language, r.duration) for r in ref]
    assert len(out[1].text.split()) == 8


def test_chunk_group_size_follows_the_kv_budget():
    """Groups hold at most ``max_batch_size`` chunks, fewer when the KV
    budget cannot hold that many caches of the longest chunk."""
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.models.params import params_from_jax

    jcfg, tcfg = configs()
    enc_t, dec_t = params_from_jax(*numpy_params(jcfg, 0))
    # Per chunk cache at the 1600-frame bucket: 2 layers x 2 heads x
    # (208 + 32 + 4096 slots) x 128 x 2 x 2 = 8.9 MB; a 20 MB budget fits 2.
    m = Qwen3ASR(tcfg, enc_t, dec_t, StubTokenizer(),
                 RuntimeConfig(**RUNTIME, kv_cache_budget_gb=20 / 1024))
    sizes = []
    m._run_pipeline_batch = lambda group, *a: sizes.append(len(group)) or ([[]] * len(group), None)
    m._run_chunks_grouped([np.zeros(12 * 16000, np.float32)] * 5, "English",
                          0.0, 1.0, 0, 1.0, 100, 0)
    assert sizes == [2, 2, 1]


def test_chunk_slack_covers_both_snapped_boundaries(pair):
    """As ``tests/test_api.py:326``: the clamp reserves 10 s for both
    snapped ends, the chunks of a 70 s clip with deep pockets fit the
    32 s bucket (and equal the JAX package's chunks), and it transcribes."""
    jax_model, port = pair
    cd = port._clamp_chunk_duration(1200.0)
    max_bucket_s = RUNTIME["frame_buckets"][-1] * 160 / 16000
    assert cd == pytest.approx(max_bucket_s - 10.0) == jax_model._clamp_chunk_duration(1200.0)
    audio = clips((70.0,), seed=7)[0]
    for pocket_s in (17.0, 48.9):
        i = int(pocket_s * 16000)
        audio[i : i + 3200] = 0.0
    chunks = port._split_long_chunks(audio, cd)
    ref_chunks = jax_model._split_long_chunks(audio, cd)
    assert [len(c) for c in chunks] == [len(c) for c in ref_chunks]
    assert all(len(c) <= RUNTIME["frame_buckets"][-1] * 160 for c in chunks)
    assert max(len(c) for c in chunks) > int((cd + 5.0) * 16000)
    res = port.transcribe(audio, max_tokens=2, repetition_penalty=1.0)
    assert res.duration == pytest.approx(70.0)


def test_chunk_search_window_shrinks_for_small_bucket_tables():
    """As ``tests/test_api.py:353``: an 8 s bucket table clamps the chunk
    to 4 s and shrinks the search window so every chunk fits the bucket."""
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.models.params import params_from_jax

    jcfg, tcfg = configs()
    enc_t, dec_t = params_from_jax(*numpy_params(jcfg, 0))
    m = Qwen3ASR(tcfg, enc_t, dec_t, StubTokenizer(),
                 RuntimeConfig(frame_buckets=(800,), token_buckets=(16,)))
    cd = m._clamp_chunk_duration(20.0)
    assert cd == pytest.approx(4.0)
    audio = clips((12.0,), seed=8)[0]
    audio[int(3.0 * 16000) : int(3.0 * 16000) + 3200] = 0.0
    chunks = m._split_long_chunks(audio, cd)
    assert all(len(c) <= 800 * 160 for c in chunks)
    res = m.transcribe(audio, chunk_duration=20.0, max_tokens=2)
    assert res.duration == pytest.approx(12.0)
