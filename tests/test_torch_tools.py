"""The port's counterparts of four JAX tools: ``tools/torch_verify_vs_hf.py``,
``torch_spec_bench.py``, ``torch_serving_bench.py`` and
``torch_ttft_probe.py``.  None imports JAX; each keeps its JAX tool's
options, less the TPU-only ones; the three card tools refuse to run without
a CUDA device; and their measuring functions run at the tiny config on the
CPU: the HF comparison passes in f32 and int8, the speculative bench reads
its acceptance floor and ceiling, and the Poisson load records every
request or raises.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import RUNTIME, StubTokenizer, port_config

from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
from qwen3_asr_tpu_torch.config import AudioEncoderConfig, ModelConfig, TextDecoderConfig
from qwen3_asr_tpu_torch.runtime.generate import Generator
from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"

#: port tool -> (its JAX tool, the JAX tool's TPU-only options it drops,
#: the options it adds).
PORTED = {
    "torch_verify_vs_hf": ("verify_vs_hf", set(), {"--device"}),
    "torch_spec_bench": ("spec_bench", set(), set()),
    "torch_serving_bench": ("serving_bench", set(), set()),
    "torch_ttft_probe": ("ttft_probe", {"--cache", "--no-progressive", "--quiet-compiles"},
                         {"--unbuilt"}),
}
CARD_TOOLS = ("torch_spec_bench", "torch_serving_bench", "torch_ttft_probe")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's steps are microseconds of work,
    and beside the other test workers more threads only wait."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(name: str):
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(TOOLS))


def _env(tmp_path) -> dict:
    return {"PATH": os.environ.get("PATH", ""), "HOME": str(tmp_path),
            "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_tool_imports_no_jax(name, tmp_path):
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({str(TOOLS / (name + '.py'))!r}, run_name='tool')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qwen3_asr_tpu.'))"
        " or m == 'qwen3_asr_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _options(path: Path) -> set[str]:
    return set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', path.read_text()))


@pytest.mark.parametrize("name", sorted(PORTED))
def test_options_match_the_jax_tool(name):
    jax_tool, dropped, added = PORTED[name]
    jax_options = _options(TOOLS / f"{jax_tool}.py")
    assert jax_options and dropped <= jax_options
    assert _options(TOOLS / f"{name}.py") == (jax_options - dropped) | added


@pytest.mark.parametrize("argv", [[name] for name in CARD_TOOLS]
                         + [["torch_verify_vs_hf", "--device", "cuda"]],
                         ids=list(CARD_TOOLS) + ["torch_verify_vs_hf-cuda"])
def test_card_tools_exit_1_without_cuda(argv, tmp_path):
    proc = subprocess.run([sys.executable, str(TOOLS / f"{argv[0]}.py"), *argv[1:]],
                          cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    if argv[0] == "torch_verify_vs_hf":
        assert "needs a CUDA device" in proc.stdout
    else:
        assert "no CUDA device" in proc.stderr
        assert proc.stdout == ""       # the card's line comes after the check


# -- torch_verify_vs_hf: the comparison at tiny dims -------------------------

TINY_HF = ModelConfig(
    audio_encoder=AudioEncoderConfig(
        d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128,
        num_mel_bins=128, output_dim=32, n_window=50, n_window_infer=800,
        downsample_hidden_size=16),
    text_decoder=TextDecoderConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, intermediate_size=64, vocab_size=512),
)


@pytest.mark.skipif(
    not all(importlib.util.find_spec(m) for m in ("transformers", "safetensors")),
    reason="needs transformers and safetensors")
def test_verify_vs_hf_passes_f32_and_int8():
    lines = []
    results = _tool("torch_verify_vs_hf").compare(TINY_HF, "cpu", ("none", "int8"),
                                                  say=lines.append)
    assert results == {"none": [], "int8": []}, "\n".join(lines)
    assert any("per-position argmax agreement = 1.0000 (none, cpu)" in s for s in lines)
    assert any(s.startswith("quant perturbation") and "(int8, cpu)" in s for s in lines)


# -- torch_spec_bench: floor and ceiling on the CPU --------------------------

#: A tiny decoder with the real vocabulary: the bench's prompt holds the
#: audio pad id 151676.
SPEC_DEC = TextDecoderConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, head_dim=128, intermediate_size=128)


def _spread(params):
    """The bench's random weights (std 0.02) rescaled to N(0, 1/fan_in)
    layers and a 0.2-scale embedding: at std 0.02 a tiny model's tied head
    predicts its own input and loops, which would put the floor at the
    ceiling."""
    layers = [{k: v / (0.02 * v.shape[0] ** 0.5) if v.dim() == 2 else v for k, v in lp.items()}
              for lp in params["layers"]]
    return {"embedding": params["embedding"] * 10.0, "layers": layers,
            "final_norm": params["final_norm"]}


def test_spec_bench_ceiling_and_floor_on_cpu():
    bench = _tool("torch_spec_bench")
    args = types.SimpleNamespace(batch=1, steps=24, gamma=3, ngram=None, init="zero",
                                 temperature=0.0, quant="none")
    zero = bench.decoder_params(SPEC_DEC, "zero", "none", "cpu", torch.float32)
    row = bench.measure(zero, SPEC_DEC, args, "ngram", "cpu")
    assert set(row) == {"mode", "temperature", "quant", "init", "batch", "gamma",
                        "ms_per_token", "decode_tok_s", "tokens_per_forward"}
    assert row["mode"] == "ngram" and row["gamma"] == 3
    assert row["tokens_per_forward"] > 2            # every draft accepted

    random = _spread(bench.decoder_params(SPEC_DEC, "random", "none", "cpu", torch.float32))
    gen = Generator(random, SPEC_DEC, RuntimeConfig(speculative="ngram", spec_gamma=3))
    _, n_tok = bench.run_one(gen, 1, 24, audio_tokens=16)
    assert n_tok == 24
    # Near the floor: (24 tokens) / (verify iterations + the prefill's one).
    assert 1.0 <= n_tok / (gen.last_spec_forwards + 1) < 1.5


# -- torch_serving_bench: the Poisson load on the CPU ------------------------


@pytest.fixture(scope="module")
def tiny_model():
    return Qwen3ASR.from_random(port_config(), tokenizer=StubTokenizer(),
                                runtime=RuntimeConfig(**RUNTIME), dtype=torch.float32, seed=0,
                                device="cpu")


def test_run_poisson_records_every_request(tiny_model):
    bench = _tool("torch_serving_bench")
    with ContinuousTranscriptionServer(tiny_model, n_slots=2, max_duration=2.0,
                                       max_new_tokens=16, chunk_steps=4) as srv:
        wall, ttft, lat = bench.run_poisson(srv, 0.5, 4, rate=50.0, budget=4, seed=1)
        assert srv.engine_stats.retired == 4
    assert ttft.shape == lat.shape == (4,)
    assert np.isfinite(ttft).all() and (ttft > 0).all()
    assert (lat >= ttft).all() and wall >= lat.max()


def test_run_poisson_raises_on_a_lost_callback(tiny_model, monkeypatch):
    bench = _tool("torch_serving_bench")
    with ContinuousTranscriptionServer(tiny_model, n_slots=2, max_duration=2.0,
                                       max_new_tokens=16, chunk_steps=4) as srv:
        submit = srv.submit
        submitted = []

        def losing_submit(*a, **k):
            fut = submit(*a, **k)
            submitted.append(fut)
            if len(submitted) == 3:       # this request's record never arrives
                monkeypatch.setattr(fut, "add_done_callback", lambda fn: None)
            return fut

        monkeypatch.setattr(srv, "submit", losing_submit)
        with pytest.raises(RuntimeError, match="3 of 4 done-callbacks"):
            bench.run_poisson(srv, 0.5, 4, rate=50.0, budget=4, seed=1, callback_timeout=0.5)
    assert all(f.done() for f in submitted)
