"""``ReplicatedTranscriptionServer`` (one model replica per device, one
shared queue) and what several replicas in one process need of the kernel
layer: launch counts kept per thread while a graph is captured, scratch
buffers kept per owner (a generator and the graphs it captures, or an
engine), the shared-memory opt-in kept per device.

CPU: four CPU replicas against a solo model (the JAX package's test,
``tests/test_serving.py:87-120``: 12 requests, equal texts, every request
counted, more than one batch); no device, no replicas; a failed batch
retried request by request.  ``cuda``-marked: two replicas on one card
(each capturing its first decode graph while the other launches), equal to
the solo model; and, with two cards, every kernel of the transcription
paths launched on ``cuda:1`` after ``cuda:0`` (the opt-in above 48 KB of
shared memory belongs to each device's context), bit-identical across the
cards.  This file imports no JAX.
"""

from __future__ import annotations

import threading

import pytest
import torch

from torch_parity import StubTokenizer, clips, ids_of, port_config

from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, ReplicatedTranscriptionServer, RuntimeConfig
from qwen3_asr_tpu_torch.config import AudioEncoderConfig, TextDecoderConfig
from qwen3_asr_tpu_torch.ops.kernels import _build

RT = dict(frame_buckets=(800,), token_buckets=(16,))
REQUESTS = clips(tuple(0.5 + 0.1 * (i % 4) for i in range(12)), seed=5)


def _factory(calls=None, device="cpu", dtype=torch.float32, config=None, **runtime):
    def make():
        if calls is not None:
            calls.append(torch.cuda.current_device() if device != "cpu" else device)
        return Qwen3ASR.from_random(config or port_config(), tokenizer=StubTokenizer(),
                                    runtime=RuntimeConfig(**dict(RT, **runtime)),
                                    dtype=dtype, seed=3, device=device)
    return make


def test_replicated_server_matches_solo():
    solo = _factory()()
    expected = [solo.transcribe(c, max_tokens=4).text for c in REQUESTS]
    calls = []
    with ReplicatedTranscriptionServer(_factory(calls), devices=["cpu"] * 4, max_batch_size=2,
                                       batch_window_ms=40.0) as srv:
        assert srv.n_replicas == 4 and calls == ["cpu"] * 4
        futs = [srv.submit(c, max_tokens=4) for c in REQUESTS]
        results = [f.result(timeout=300).text for f in futs]
    assert results == expected
    assert len({r for r in results}) > 1
    assert srv.stats.requests == 12
    assert srv.stats.batches >= 2
    assert sum(srv.replica_batches) == srv.stats.batches
    assert srv.stats.failures == 0


def test_no_device_no_replicas(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    made = []
    with pytest.raises(ValueError, match="no devices for replicas"):
        ReplicatedTranscriptionServer(lambda: made.append(1))
    with pytest.raises(ValueError, match="no devices for replicas"):
        ReplicatedTranscriptionServer(lambda: made.append(1), devices=[])
    assert made == []


def test_failed_batch_is_retried_per_request():
    model = _factory()()

    def broken(*args, **kwargs):
        raise RuntimeError("batch failed")

    model.transcribe_batch = broken
    with ReplicatedTranscriptionServer(lambda: model, devices=["cpu"], max_batch_size=4,
                                       batch_window_ms=40.0) as srv:
        futs = [srv.submit(c, max_tokens=4) for c in REQUESTS[:3]]
        got = [f.result(timeout=300).text for f in futs]
    solo = _factory()()
    assert got == [solo.transcribe(c, max_tokens=4).text for c in REQUESTS[:3]]
    assert srv.stats.failures == 0


def test_launches_counted_per_thread_during_a_capture(monkeypatch):
    """A capture's launches go aside in its own thread; another thread's
    launches meanwhile still count."""
    from collections import Counter

    monkeypatch.setattr(_build, "LAUNCHES", Counter())
    started, counted = threading.Event(), threading.Event()

    def other():
        started.wait(10)
        for _ in range(5):
            _build.count("decode_attention")
        counted.set()

    def capture():
        _build.count("flash_attention_causal")
        started.set()
        counted.wait(10)
        _build.count("flash_attention_causal")

    t = threading.Thread(target=other)
    t.start()
    aside = _build.diverted(capture)
    t.join()
    assert aside == Counter({"flash_attention_causal": 2})
    assert _build.LAUNCHES == Counter({"decode_attention": 5})
    _build.add_launches(aside)
    assert _build.LAUNCHES["flash_attention_causal"] == 2


def test_scratch_belongs_to_its_owner(monkeypatch):
    """Kernel scratch has one owner: launches inside a scope use its
    buffers from any thread, two owners never share, launches outside every
    scope share the device's; a model's encoder and decoder launch under
    its generator's scratch, an engine under its own, and close() frees
    them."""
    from qwen3_asr_tpu_torch import api
    from qwen3_asr_tpu_torch.ops.kernels import decode_attention as da_mod
    from qwen3_asr_tpu_torch.runtime import engine as engine_mod
    from qwen3_asr_tpu_torch.runtime import generate
    from qwen3_asr_tpu_torch.runtime.engine import SlotRequest

    cpu = torch.device("cpu")
    one, two = _build.Scratch(), _build.Scratch()
    with _build.scratch_scope(one):
        mine = da_mod.arrival_counters(cpu, 8)
        with _build.scratch_scope(two):
            assert da_mod.arrival_counters(cpu, 8) is not mine
        assert da_mod.arrival_counters(cpu, 8) is mine
    other = []

    def in_thread():
        with _build.scratch_scope(one):
            other.append(da_mod.arrival_counters(cpu, 8))
        other.append(_build.scratch(cpu))

    t = threading.Thread(target=in_thread)
    t.start()
    t.join()
    assert other[0] is mine
    assert other[1] is _build.SHARED_SCRATCH.pool(cpu) is _build.scratch(cpu)

    owners = []

    def spy(fn):
        def run(*args, **kwargs):
            owners.append(_build._scope.scratch)
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(api, "encoder_forward", spy(api.encoder_forward))
    monkeypatch.setattr(generate, "decoder_logits", spy(generate.decoder_logits))
    monkeypatch.setattr(engine_mod, "decoder_logits", spy(engine_mod.decoder_logits))
    model = _factory()()
    gen = model._generator
    model.transcribe(REQUESTS[0], max_tokens=4)
    assert len(owners) > 2 and all(o is gen.scratch for o in owners)
    engine = model.make_engine(n_slots=2, max_duration=8.0, max_new_tokens=8, chunk_steps=2)
    owners.clear()
    kv, first_logits, prompts = model.prefill_group([REQUESTS[1]], ["English"])
    assert owners and all(o is gen.scratch for o in owners)
    owners.clear()
    engine.admit(kv, first_logits, engine.free_slots()[:1],
                 [SlotRequest(samples=REQUESTS[1], prompt=prompts[0], max_new=4)])
    engine.step()
    assert owners and all(o is engine.scratch for o in owners)
    with _build.scratch_scope(gen.scratch):
        da_mod.arrival_counters(cpu, 8)
    model.close()
    assert gen.scratch._pools == {}


# -- on the card ------------------------------------------------------------------------

#: A small model the kernels take: K9 needs K % 128 == 0, K10 K % 64 == 0,
#: decode attention head_dim 128.
CUDA_CONFIG = ModelConfig(
    audio_encoder=AudioEncoderConfig(d_model=128, encoder_layers=2, encoder_attention_heads=4,
                                     encoder_ffn_dim=256, output_dim=256,
                                     downsample_hidden_size=8),
    text_decoder=TextDecoderConfig(hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, head_dim=128, intermediate_size=512,
                                   vocab_size=512),
)
CUDA_RUNTIMES = {
    "off": dict(speculative="off"),                       # K1, K2 (K3 fused)
    "speculative": dict(),                                # K1, K5
    "int8": dict(quantization="int8", act_quant="int8", act_quant_min_rows=16,
                 kv_cache_dtype="int8"),                  # K9, K10, K4 (K3-int8 fused)
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_two_replicas_on_one_card(cuda):
    """Two replicas on cuda:0 serve one queue at once, one request a batch
    (B = 1, as the solo model's transcribe), each capturing its decode
    graphs while the other's kernels run: equal to the solo model."""
    torch.cuda.set_device(cuda)
    make = _factory(device="cuda", dtype=torch.bfloat16, config=CUDA_CONFIG, speculative="off")
    solo = make()
    audio = clips(tuple(1.0 + 0.2 * (i % 4) for i in range(8)), seed=6)
    expected = [ids_of([solo.transcribe(a, max_tokens=12)])[0] for a in audio]
    solo.close()
    with ReplicatedTranscriptionServer(make, devices=[cuda, cuda], max_batch_size=1,
                                       batch_window_ms=1.0) as srv:
        futs = [srv.submit(a, max_tokens=12) for a in audio]
        got = [ids_of([f.result(timeout=600)])[0] for f in futs]
        captures = [m._generator.graphs.captures for m in srv.models
                    if m._generator.graphs is not None]
    assert got == expected
    assert all(n > 0 for n in srv.replica_batches), srv.replica_batches
    assert captures and all(n > 0 for n in captures)


@pytest.mark.cuda
def test_cuda_graph_captured_in_one_thread_replays_in_another(cuda):
    """A model warmed up (its decode graphs captured) on this thread is
    served from another thread, replaying those graphs, while this thread
    runs a second model's decodes on the same card: each model keeps its
    generator's scratch whichever thread launches or replays, the shared
    pool is never used, and both give the solo tokens with no new capture
    of the first model."""
    torch.cuda.set_device(cuda)
    make = _factory(device="cuda", dtype=torch.bfloat16, config=CUDA_CONFIG, speculative="off")
    audio = clips((1.0, 1.4), seed=8)
    _build.SHARED_SCRATCH.clear()
    first, second = make(), make()
    expected = [ids_of([first.transcribe(a, max_tokens=12)])[0] for a in audio]
    captures = first._generator.graphs.captures
    served = []

    def serve():
        torch.cuda.set_device(cuda)
        for _ in range(3):
            served.append([ids_of([first.transcribe(a, max_tokens=12)])[0] for a in audio])

    t = threading.Thread(target=serve)
    t.start()
    beside = [[ids_of([second.transcribe(a, max_tokens=12)])[0] for a in audio]
              for _ in range(3)]
    t.join()
    assert served == [expected] * 3 and beside == [expected] * 3
    assert first._generator.graphs.captures == captures
    pools = [m._generator.scratch.pool(cuda) for m in (first, second)]
    assert all("arrival_counters" in p for p in pools)
    assert pools[0]["arrival_counters"][-1] is not pools[1]["arrival_counters"][-1]
    assert _build.SHARED_SCRATCH.pool(cuda) == {}
    first.close()
    second.close()


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(CUDA_RUNTIMES))
def test_cuda_kernels_on_a_second_card(cuda, arm):
    """Every kernel of an arm's transcription launched on cuda:1 after
    cuda:0 in one process: each card sets its own shared-memory opt-in, and
    the two cards' tokens and kernel counts are equal.  K10's scaled
    quantize entry and K11e run directly on both cards, bit-identical."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    audio = clips((1.0, 2.3, 3.1), seed=7)
    out = []
    for index in (0, 1):
        device = torch.device("cuda", index)
        with torch.cuda.device(device):
            model = _factory(device=device, dtype=torch.bfloat16, config=CUDA_CONFIG,
                             **CUDA_RUNTIMES[arm])()
            _build.LAUNCHES.clear()
            ids = ids_of(model.transcribe_batch(audio, max_tokens=12))
            torch.cuda.synchronize(device)
            out.append((ids, +_build.LAUNCHES))
            model.close()
    (ids0, n0), (ids1, n1) = out
    assert ids0 == ids1
    assert n0 == n1 and sum(n0.values()) > 0, (n0, n1)
    if arm != "int8":
        return
    from qwen3_asr_tpu_torch.ops.kernels.experiments.conv_stem import conv_s2_gelu
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import (
        quantize_rows_scaled,
        scales_of_amax,
        w8a8_matmul,
    )

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(96, 512, generator=gen).to(torch.bfloat16)
    amax = x.float().abs().amax(1) * 1.5
    wq = torch.randint(-127, 128, (384, 512), generator=gen, dtype=torch.int8).t()
    ws = torch.rand(384, generator=gen) * 1e-2
    img = torch.randn(4, 64, 50, 480, generator=gen).to(torch.bfloat16)
    w = (torch.randn(3, 3, 480, 480, generator=gen) * 0.02).to(torch.bfloat16)
    b = torch.randn(480, generator=gen) * 0.1
    results = []
    for index in (0, 1):
        d = torch.device("cuda", index)
        with torch.cuda.device(d):
            s = scales_of_amax(amax).to(d)
            results.append([
                quantize_rows_scaled(x.to(d), s).cpu(),
                w8a8_matmul(x.to(d), wq.to(d).t().contiguous().t(), ws.to(d),
                            torch.float32, row_scales=s).cpu(),
                conv_s2_gelu(img.to(d), w.to(d), b.to(d)).cpu(),
            ])
    plain = quantize_rows_scaled(x, scales_of_amax(amax))
    assert torch.equal(results[0][0], plain)
    for a, c in zip(*results):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cuda_w8a8_row_scales_bit_exact_vs_plain(cuda, out_dtype):
    """K10 with the row scales given (a row-parallel shard's): the scaled
    quantize and the product bit-identical to the plain version, and equal
    to the unscaled entry when the given scales are the rows' own."""
    from qwen3_asr_tpu_torch.ops.kernels.w8a8_matmul import (
        activation_scales,
        quantize_rows_scaled,
        scales_of_amax,
        w8a8_matmul,
        w8a8_matmul_plain,
    )

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(200, 1024, generator=gen).to(torch.bfloat16)
    x[3] = 0
    amax = x.float().abs().amax(1) * torch.rand(200, generator=gen).add(1.0)
    amax[3] = 0
    wq = torch.randint(-127, 128, (768, 1024), generator=gen, dtype=torch.int8).t()
    ws = torch.rand(768, generator=gen) * 1e-2
    s = scales_of_amax(amax)
    xc, wc, wsc, sc = x.to(cuda), wq.to(cuda).t().contiguous().t(), ws.to(cuda), s.to(cuda)
    assert torch.equal(quantize_rows_scaled(xc, sc).cpu(), quantize_rows_scaled(x, s))
    got = w8a8_matmul(xc, wc, wsc, out_dtype, row_scales=sc).cpu()
    assert torch.equal(got, w8a8_matmul_plain(x, wq, ws, out_dtype, row_scales=s))
    own = activation_scales(xc)
    assert torch.equal(w8a8_matmul(xc, wc, wsc, out_dtype, row_scales=own),
                       w8a8_matmul(xc, wc, wsc, out_dtype))
