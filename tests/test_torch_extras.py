"""The port's remaining surface beside the JAX package's, on the CPU:
``utils/telemetry.py:profile_trace``, ``Qwen3ASR.from_pretrained``'s Hub
fallback, and the five ``examples/torch_*.py``.

* ``profile_trace`` around a tiny CPU ``transcribe`` writes a Chrome trace
  under its directory that holds the ``qwen3_asr/prefill`` span.
* The Hub fallback: with ``huggingface_hub.snapshot_download`` patched to
  return a directory holding the JAX package's ``save_checkpoint`` output
  and a ``config.json`` (as ``tests/test_api.py`` writes them, the stub
  tokenizer patched in), ``from_pretrained("org/repo", ...)`` passes the
  repo id and keyword arguments on and transcribes to the same tokens as
  loading that directory; no network is touched.
* Each example runs through ``runpy`` with ``Qwen3ASR.from_pretrained``
  patched to return the tiny model on the CPU (the pattern of
  ``tests/test_torch_cli.py``), its calls' token budget cut to 8, on WAV
  files written here; a fresh
  interpreter runs the five examples' imports and finds neither ``jax``
  nor the JAX package in ``sys.modules``.
"""

from __future__ import annotations

import dataclasses
import json
import runpy
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import RUNTIME, StubTokenizer, clips, configs, ids_of, numpy_params, port_config

from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
from qwen3_asr_tpu_torch import api as api_mod
from qwen3_asr_tpu_torch.utils.telemetry import profile_trace

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_serving", "torch_continuous_serving",
            "torch_streaming", "torch_live_captions")
#: The tiny runtime with a 40 s frame bucket: ``torch_streaming.py``'s 30 s
#: segments plus the split search must fit one.
EXAMPLE_RUNTIME = dict(RUNTIME, frame_buckets=(800, 1600, 3200, 4000))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module: the tiny model's steps are a few
    microseconds of work each, and beside the other test workers more
    threads only wait for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny():
    return Qwen3ASR.from_random(port_config(), tokenizer=StubTokenizer(),
                                runtime=RuntimeConfig(**EXAMPLE_RUNTIME), dtype=torch.float32,
                                seed=3, device="cpu")


def test_profile_trace_holds_the_stage_spans(tmp_path):
    model = _tiny()
    with profile_trace(tmp_path / "trace") as prof:
        model.transcribe(clips((1.0,), seed=4)[0], max_tokens=4)
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"qwen3_asr/prefill", "qwen3_asr/decode"} <= names
    assert any(e.key == "qwen3_asr/prefill" for e in prof.key_averages())


def _checkpoint_dir(path: Path) -> Path:
    """The JAX package's checkpoint of the tiny weights (seed 5) and its
    HF-schema ``config.json``, as ``tests/test_api.py`` writes them."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.params import save_checkpoint

    jcfg, _ = configs()
    enc, dec = numpy_params(jcfg, seed=5)
    save_checkpoint(path, *(jax.tree_util.tree_map(jnp.asarray, t) for t in (enc, dec)))
    (path / "config.json").write_text(json.dumps({
        **dataclasses.asdict(jcfg.text_decoder),
        "audio_encoder_config": dataclasses.asdict(jcfg.audio_encoder),
    }))
    return path


def test_from_pretrained_falls_back_to_the_hub(tmp_path, monkeypatch):
    import huggingface_hub

    ckpt = _checkpoint_dir(tmp_path / "snapshot")
    monkeypatch.setattr(api_mod, "Tokenizer", lambda path: StubTokenizer())
    calls = []

    def snapshot_download(repo_id, **kwargs):
        calls.append((repo_id, kwargs))
        return str(ckpt)

    monkeypatch.setattr(huggingface_hub, "snapshot_download", snapshot_download)
    audio = clips((1.0, 2.3), seed=6)
    load = dict(runtime=RuntimeConfig(**RUNTIME), dtype=torch.float32, device="cpu")
    hub = Qwen3ASR.from_pretrained("org/qwen3-asr-tiny", revision="main", **load)
    local = Qwen3ASR.from_pretrained(ckpt, **load)
    assert calls == [("org/qwen3-asr-tiny", {"revision": "main"})]
    got = ids_of(hub.transcribe_batch(audio, max_tokens=8))
    assert got == ids_of(local.transcribe_batch(audio, max_tokens=8))
    assert len({t for seq in got for t in seq}) > 2


def _write_wav(path: Path, seconds: float, seed: int) -> Path:
    x = (np.clip(clips((seconds,), seed=seed)[0], -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)
    data = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(x)) + x
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(data)) + b"WAVE" + data)
    return path


def _wavs(tmp_path: Path) -> list[str]:
    return [str(_write_wav(tmp_path / f"clip{i}.wav", s, i))
            for i, s in enumerate((1.2, 3.1))]


#: The token budget the examples' calls get on the tiny model: a random
#: model never ends its transcript, and the calls' default budget (256 and
#: more) would decode that many tokens a clip on the CPU.
EXAMPLE_TOKENS = 8


def _capped(model, monkeypatch):
    """``model`` whose calls that take ``max_tokens`` default it to
    :data:`EXAMPLE_TOKENS`."""
    for name in ("transcribe", "transcribe_batch", "incremental_session"):
        def call(*a, _real=getattr(model, name), **k):
            if k.get("max_tokens") is None:
                k["max_tokens"] = EXAMPLE_TOKENS
            return _real(*a, **k)
        monkeypatch.setattr(model, name, call)
    return model


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(tmp_path, monkeypatch, capsys, name):
    model = _capped(_tiny(), monkeypatch)
    monkeypatch.setattr(Qwen3ASR, "from_pretrained", classmethod(lambda cls, *a, **k: model))
    wavs = _wavs(tmp_path)
    monkeypatch.setattr(sys, "argv", [name, "/no/such/checkpoint", *wavs])
    runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert out.strip()
    if name in ("torch_quickstart", "torch_serving", "torch_continuous_serving"):
        assert all(f"{w}:" in out for w in wavs)
    elif name == "torch_streaming":
        assert "full transcript:" in out
    else:
        assert out.count("s] ") == 2               # a caption a second of 1.2 s


#: Runs every import statement of the five examples in a fresh interpreter
#: (the examples themselves run in ``test_example_runs``, where pytest has
#: loaded JAX already), then lists the JAX modules it finds loaded.
_SUBPROCESS = """
import ast, sys
for path in {paths!r}:
    tree = ast.parse(open(path).read())
    imports = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    exec(compile(ast.Module(imports, []), path, "exec"), {{}})
print("LOADED", sorted(m for m in sys.modules
                       if m == "jax" or m.startswith(("jax.", "jaxlib"))
                       or m == "qwen3_asr_tpu" or m.startswith("qwen3_asr_tpu.")))
"""


def test_examples_import_no_jax():
    paths = [str(REPO / "examples" / f"{name}.py") for name in EXAMPLES]
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS.format(paths=paths)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
