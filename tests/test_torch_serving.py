"""The port's servers, float32 on the CPU (JAX ``tests/test_serving.py`` and
the server half of ``tests/test_engine.py``).

The continuous server's transcripts equal direct ``transcribe`` results,
flat and paged; a short request submitted mid-decode finishes before the
long one; long clips are rejected on their future, empty clips resolve
empty; a request done at admission (budget 1, or an EOS first token)
resolves without another request arriving; ``future.ttft_s`` is stamped;
a cancelled future leaves the worker alive; prefill groups never exceed
``admit_batch``, in warm-up too.  The drain ``TranscriptionServer`` equals
``transcribe_batch``.
"""

from __future__ import annotations

import time
from concurrent.futures import Future

import numpy as np
import pytest

from torch_parity import clips, models

from qwen3_asr_tpu_torch import TranscriptionResult
from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer, TranscriptionServer
from qwen3_asr_tpu_torch.serving.server import _Request


@pytest.fixture(scope="module")
def port():
    return models(seed=0, runtime=dict(token_buckets=(16, 128, 256)))[1]


def _wait_admitted(srv, n, deadline_s=60):
    deadline = time.time() + deadline_s
    while srv.engine_stats.admitted < n and time.time() < deadline:
        time.sleep(0.01)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "flat"])
def test_continuous_server_matches_direct(port, paged):
    audio = clips((0.7, 1.3, 0.9, 2.2, 0.5), seed=20)
    direct = [port.transcribe(c, max_tokens=5) for c in audio]
    with ContinuousTranscriptionServer(port, n_slots=2, max_duration=8.0, max_new_tokens=128,
                                       chunk_steps=4, paged=paged) as srv:
        futs = [srv.submit(c, max_tokens=5) for c in audio]
        results = [f.result(timeout=300) for f in futs]
    assert results == direct
    assert srv.engine_stats.retired == 5          # 5 requests through 2 slots


def test_continuous_server_mid_decode_admission(port):
    long_clip, short_clip = clips((2.0, 0.5), seed=21)
    direct_short = port.transcribe(short_clip, max_tokens=4)
    with ContinuousTranscriptionServer(port, n_slots=4, max_duration=8.0, max_new_tokens=128,
                                       chunk_steps=4) as srv:
        f_long = srv.submit(long_clip, max_tokens=100)
        _wait_admitted(srv, 1)
        f_short = srv.submit(short_clip, max_tokens=4)
        short_res = f_short.result(timeout=120)
        assert not f_long.done(), "the short request waited for the long decode"
        assert f_long.result(timeout=120).text
    assert short_res == direct_short
    assert srv.engine_stats.mid_decode_admissions >= 1


def test_continuous_server_rejects_long_and_resolves_empty(port):
    with ContinuousTranscriptionServer(port, n_slots=2, max_duration=4.0,
                                       max_new_tokens=128) as srv:
        long_fut = srv.submit(clips((6.0,))[0], max_tokens=4)
        empty = srv.submit(np.zeros(0, np.float32)).result(timeout=60)
        with pytest.raises(ValueError, match="max_duration"):
            long_fut.result(timeout=60)
    assert empty == TranscriptionResult(text="", language="Unknown", duration=0.0)
    assert srv.stats.failures == 1


def test_continuous_first_token_done_resolves_promptly(port, monkeypatch):
    """A budget of 1, and a first token that is EOS, finish at admission and
    resolve without another request arriving."""
    clip = clips((0.5,), seed=22)[0]
    with ContinuousTranscriptionServer(port, n_slots=2, max_duration=4.0, max_new_tokens=64,
                                       chunk_steps=4) as srv:
        res = srv.submit(clip, max_tokens=1).result(timeout=60)
    assert len(res.text.split()) == 1
    first = int(res.text.split()[0][1:])
    monkeypatch.setattr(port._generator, "_eos_ids", sorted({first, *port._generator._eos_ids}))
    with ContinuousTranscriptionServer(port, n_slots=2, max_duration=4.0, max_new_tokens=64,
                                       chunk_steps=4) as srv:
        res = srv.submit(clip, max_tokens=50).result(timeout=60)
        assert srv.engine_stats.chunks == 0
    assert res.text == f"t{first}"              # one token: the EOS first token


def test_continuous_future_carries_ttft(port):
    with ContinuousTranscriptionServer(port, n_slots=2, max_duration=4.0, max_new_tokens=16,
                                       chunk_steps=4) as srv:
        t0 = time.time()
        fut = srv.submit(clips((0.5,), seed=23)[0], max_tokens=4)
        fut.result(timeout=120)
        total = time.time() - t0
    assert 0.0 < fut.ttft_s <= total + 0.05


def test_cancelled_future_does_not_kill_the_workers(port):
    a, b = clips((0.5, 0.6), seed=24)
    with TranscriptionServer(port, max_batch_size=2) as srv:
        f1 = srv.submit(a, max_tokens=4)
        f1.cancel()
        assert srv.submit(b, max_tokens=4).result(timeout=120).text
    with ContinuousTranscriptionServer(port, n_slots=2, max_duration=4.0, max_new_tokens=16,
                                       chunk_steps=4) as srv:
        f1 = srv.submit(a, max_tokens=4)
        f1.cancel()
        assert srv.submit(b, max_tokens=4).result(timeout=120).text


def test_admit_batch_caps_prefill_groups_in_warm_up_and_serving(port, monkeypatch):
    """With admit_batch < n_slots, warm-up and serving never prefill a wider
    group, the warm-up still fills every slot (the full-width chunk), and
    ``_admit`` caps deferred + fresh requests at the cap."""
    widths = []
    real = port.prefill_group

    def recording(samples_list, lang_names):
        widths.append(len(samples_list))
        return real(samples_list, lang_names)

    monkeypatch.setattr(port, "prefill_group", recording)
    audio = clips((0.5, 0.6, 0.7, 0.8), seed=25)
    with ContinuousTranscriptionServer(port, n_slots=4, admit_batch=2, max_duration=2.0,
                                       max_new_tokens=8, chunk_steps=4, warm=(0.5,)) as srv:
        warm_widths = list(widths)
        results = [f.result(timeout=120) for f in [srv.submit(c, max_tokens=4) for c in audio]]
    assert max(warm_widths) == 2 and sum(warm_widths) >= 4 + 2, warm_widths
    assert max(widths) <= 2, widths
    assert all(isinstance(r, TranscriptionResult) for r in results)
    widths.clear()
    with ContinuousTranscriptionServer(port, n_slots=4, admit_batch=2, max_duration=2.0,
                                       max_new_tokens=8, chunk_steps=4) as srv:
        reqs = [_Request(c, {"max_tokens": 4}, Future(), time.time()) for c in audio]
        overflow = srv._admit(reqs)
        assert len(overflow) == 2 and widths and max(widths) <= 2
    for r in reqs[:2]:
        assert r.future.result(timeout=120).text


def test_drain_server_matches_transcribe_batch(port):
    audio = clips((0.5, 0.7, 0.6), seed=26)
    ref = port.transcribe_batch(audio, max_tokens=5)
    with TranscriptionServer(port, max_batch_size=4, batch_window_ms=200) as srv:
        futs = [srv.submit(c, max_tokens=5) for c in audio]
        results = [f.result(timeout=120) for f in futs]
        bad = srv.submit(np.zeros((2, 10), np.float32), max_tokens=4)
        with pytest.raises(ValueError):
            bad.result(timeout=120)
    assert results == ref
    assert srv.stats.requests == 4 and srv.stats.failures == 1
    assert srv.stats.mean_batch_size >= 1.0
