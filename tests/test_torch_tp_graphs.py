"""The graphed decode loop on a tensor-parallel group (``runtime/graphs.py``,
``Generator._capturable``/``_graphed``, ``parallel/collectives.py``).

On the CPU:

* a captured step's collectives (``collectives.TRAFFIC``) leave ``TRAFFIC``
  during the capture and come back once per replay, beside its kernel
  launches, and a capture that raises leaves both counters as they were
  (a stub graph);
* the graphing decision: CPU tensors and a gloo group run the loop
  eagerly, one device and an NCCL group (a fake group, ``get_backend``
  patched) graph it under every decode mode, "3"/"4" included (K11a/K11b
  read their decode end from the device), and ``eager=True`` stays eager
  on any group;
* the prefill's arena view on a tp group holds this rank's KV heads, the
  shape ``init_kv_cache(..., tp=)`` gives, and the graphed decode takes it
  (and its int8 quantization) in place.

``cuda``-marked (skipped without the cards): a one-rank NCCL group (a
``TP`` over the world group, made by hand) and, with two cards or more, a
(1, 2) mesh over NCCL run the plain, speculative, sampled and int8
(weights and cache) loops graphed on the tiny bf16 model (widened for K9),
ids bit-identical to the same rank's eager loop, the same in every rank,
and the collectives a replay adds equal to an eager step's.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch_mesh import run_mesh
from torch_parity import RUNTIME, TINY_DECODER, clips

from qwen3_asr_tpu_torch.config import RuntimeConfig, TextDecoderConfig
from qwen3_asr_tpu_torch.models import decoder as _decoder
from qwen3_asr_tpu_torch.models.decoder import init_kv_cache
from qwen3_asr_tpu_torch.ops.kernels import _build
from qwen3_asr_tpu_torch.parallel import collectives
from qwen3_asr_tpu_torch.parallel.collectives import TP
from qwen3_asr_tpu_torch.runtime import graphs
from qwen3_asr_tpu_torch.runtime.generate import Generator

GROUP = object()


@pytest.fixture
def backend(monkeypatch):
    """Set the fake group's backend: ``backend("nccl")``."""
    def set_backend(name: str) -> None:
        monkeypatch.setattr(collectives.dist, "get_backend", lambda group=None: name)
    return set_backend


def test_replays_add_the_recorded_collectives(monkeypatch, backend):
    backend("nccl")
    monkeypatch.setattr(collectives, "TRAFFIC", Counter({"kept": 2}))
    monkeypatch.setattr(_build, "LAUNCHES", Counter({"kept": 1}))
    monkeypatch.setattr(collectives.dist, "all_reduce", lambda t, op=None, group=None: None)
    monkeypatch.setattr(collectives.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(collectives.dist, "all_gather_into_tensor",
                        lambda out, t, group=None: out.copy_(t.expand_as(out)))
    x = torch.ones(3, 4, dtype=torch.bfloat16)

    def step():
        _build.count("decode_attention")
        collectives.all_reduce_(x, GROUP)
        collectives.all_reduce_(x, GROUP)
        gathered = collectives.all_gather(x[:, None, :], GROUP, dim=-1)
        assert gathered.shape == (3, 1, 8)

    launches, traffic = graphs.record(step)
    assert launches == Counter({"decode_attention": 1})
    assert traffic == Counter({"all_reduce": 2, "all_reduce bytes": 48,
                               "all_gather": 1, "all_gather bytes": 24})
    assert collectives.TRAFFIC == Counter({"kept": 2})
    assert _build.LAUNCHES == Counter({"kept": 1})
    stub = _StubGraph()
    captured = graphs.StepGraph(stub, launches, traffic)
    for i in range(5):
        captured.replay(i)
    assert stub.replays == 5
    assert collectives.TRAFFIC == Counter({"kept": 2, "all_reduce": 10, "all_reduce bytes": 240,
                                           "all_gather": 5, "all_gather bytes": 120})
    assert _build.LAUNCHES == Counter({"kept": 1, "decode_attention": 5})

    before = Counter(collectives.TRAFFIC)
    def failing():
        collectives.all_reduce_(x, GROUP)
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.record(failing)
    assert collectives.TRAFFIC == before
    collectives.all_reduce_(x, GROUP)        # counted again once the capture is over
    assert collectives.TRAFFIC["all_reduce"] == before["all_reduce"] + 1


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _generator(tp: TP | None, **runtime) -> Generator:
    return Generator(None, TextDecoderConfig(**TINY_DECODER), RuntimeConfig(**runtime), tp=tp)


#: (device, backend of the tp group or None for one device, decode kernel
#: mode, eager) -> whether the decode loop is graphed.
DECISIONS = {
    ("cpu", None, "auto", False): False,
    ("cpu", "gloo", "auto", False): False,
    ("cpu", "nccl", "auto", False): False,
    ("cuda", None, "auto", False): True,
    ("cuda", "nccl", "auto", False): True,
    ("cuda", "nccl", "0", False): True,
    ("cuda", "nccl", "5", False): True,
    ("cuda", "gloo", "auto", False): False,
    ("cuda", "gloo", "0", False): False,
    ("cuda", "nccl", "3", False): True,
    ("cuda", "nccl", "4", False): True,
    ("cuda", None, "3", False): True,
    ("cuda", None, "4", False): True,
    ("cuda", "gloo", "3", False): False,
    ("cuda", None, "4", True): False,
    ("cuda", "nccl", "auto", True): False,
}


@pytest.mark.parametrize("case", list(DECISIONS), ids=str)
def test_graphing_decision(case, backend, monkeypatch):
    device, group_backend, mode, eager = case
    monkeypatch.setattr(_decoder, "DECODE_KERNEL_MODE", mode)
    if group_backend is not None:
        backend(group_backend)
    gen = _generator(TP(2, 0, GROUP) if group_backend else None)
    assert gen._graphed(torch.device(device), eager) == DECISIONS[case]
    # The prefill's arena follows the group and the device, not the mode.
    assert gen._capturable(torch.device(device)) == (
        device == "cuda" and group_backend != "gloo")


def test_tp_arena_holds_this_ranks_kv_heads(monkeypatch):
    tp = TP(2, 1, GROUP)
    gen = _generator(tp)
    cfg = gen.cfg
    B, S = 3, 272
    monkeypatch.setattr(Generator, "_capturable", lambda self, device: True)
    assert gen.graphs is None
    kv = gen._prefill_cache(B, S, torch.float32, torch.device("cpu"), arena=True)
    want = init_kv_cache(cfg, B, S, torch.float32, "cpu", tp=tp)
    assert [t.shape for t in kv] == [t.shape for t in want]
    assert kv[0].shape == (cfg.num_hidden_layers, B, cfg.num_key_value_heads // 2, S,
                           cfg.head_dim)
    assert [t.data_ptr() for t in kv] == [gen.graphs.buffers[n].data_ptr() for n in "kv"]
    assert not any(t.any() for t in kv)
    kv[0].normal_()
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(gen._graph_cache(kv), kv))

    gen.runtime = RuntimeConfig(kv_cache_dtype="int8")
    q8 = gen._graph_cache(kv)
    for pair, name in zip(q8, "kv"):
        assert pair["q"].shape == kv[0].shape and pair["s"].shape == kv[0].shape[:-1]
        assert pair["q"].data_ptr() == gen.graphs.buffers[f"{name}q"].data_ptr()

    fresh = _generator(tp)._prefill_cache(B, S, torch.float32, torch.device("cpu"), arena=False)
    assert [t.shape for t in fresh] == [t.shape for t in want]


# -- on the card: one-rank and (1, 2) NCCL groups -------------------------------------

#: name -> (runtime, transcribe_batch keywords).
ARMS = {
    "plain": (dict(RUNTIME, speculative="off"), dict(max_tokens=12)),
    "speculative": (dict(RUNTIME, speculative="ngram"), dict(max_tokens=12)),
    "sampled": (dict(RUNTIME, speculative="off"),
                dict(max_tokens=12, temperature=0.9, top_k=40, top_p=0.9, seed=5)),
    "int8": (dict(RUNTIME, quantization="int8", kv_cache_dtype="int8"), dict(max_tokens=12)),
}
#: The tiny model widened so that every int8 decoder product has K >= 128,
#: K9's k-block (W8A8 stays off: the tiny encoder's K = 32 is below K10's).
WIDTHS = {"encoder": dict(output_dim=128),
          "decoder": dict(hidden_size=128, intermediate_size=256)}


def _hold_graphed_to_eager(ranks: list[dict]) -> None:
    for name in ARMS:
        per_rank = [r["tp_graphs"][name] for r in ranks]
        for r, got in enumerate(per_rank):
            first, again, eager = got["runs"]
            assert got["captures"] >= 1, (name, r)
            assert first["ids"] == again["ids"] == eager["ids"], (name, r)
            assert again["steps"] == eager["steps"], (name, r)
            # The eager loop runs one step per look; a replay's collectives
            # are one eager step's.
            per_replay = {k: v / again["replays"] for k, v in again["traffic"].items()}
            per_step = {k: v / eager["replays"] for k, v in eager["traffic"].items()}
            assert per_replay == per_step and per_step["all_reduce"] > 0, (name, r)
            assert per_step.get("all_gather", 0) > 0, (name, r)
        assert all(g["runs"][0]["ids"] == per_rank[0]["runs"][0]["ids"] for g in per_rank), name


def _job() -> dict:
    return {"backend": "nccl",
            "tp_graphs": dict(WIDTHS, arms=ARMS, clips=clips((1.0, 2.3, 5.1), 1))}


@pytest.mark.cuda
def test_one_rank_nccl_group_graphs_its_loops(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _hold_graphed_to_eager(run_mesh(1, 1, tmp_path, _job()))


@pytest.mark.cuda
def test_tp2_nccl_mesh_graphs_its_loops(tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    _hold_graphed_to_eager(run_mesh(1, 2, tmp_path, _job()))
