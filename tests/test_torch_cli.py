"""The port's command line (``qwen3_asr_tpu_torch/cli.py``) against the JAX
package's: the cases of ``tests/test_cli.py``, with ``from_pretrained``
monkeypatched (to a tiny CPU model, or to a stop before any model work),
and where a run prints transcripts, its output held line for line to the
JAX package's CLI on the same weights and the same WAV file.
"""

from __future__ import annotations

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from qwen3_asr_tpu_torch import cli
from qwen3_asr_tpu_torch.api import Qwen3ASR
from qwen3_asr_tpu_torch.cli import build_parser
from torch_parity import models

REPO = Path(__file__).resolve().parents[1]
#: tests/test_cli.py's runtime for the end-to-end runs.
RT = dict(frame_buckets=(800, 1600, 3200), token_buckets=(32,))
#: Weights whose greedy tokens follow the audio (tests/test_torch_incremental.py).
WEIGHTS_SEED = 3


def _write_wav(path: Path, samples: np.ndarray, sr: int = 16000) -> None:
    """A mono PCM16 RIFF/WAVE file."""
    payload = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)
    data = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    data += b"data" + struct.pack("<I", len(payload)) + payload
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(data)) + b"WAVE" + data)


def _tone(seconds: float, freq: float = 330.0) -> np.ndarray:
    t = np.arange(int(seconds * 16000)) / 16000
    rng = np.random.default_rng(int(seconds * 10))
    sig = 0.1 * np.sin(2 * np.pi * freq * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (sig + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return models(seed=WEIGHTS_SEED, runtime=RT)


def _run_both(pair, argv, monkeypatch, capsys):
    """(port CLI output, JAX CLI output, port rc) of one argv, each CLI's
    ``from_pretrained`` returning its tiny model."""
    from qwen3_asr_tpu import cli as jax_cli
    from qwen3_asr_tpu.api import Qwen3ASR as JaxASR

    jax_model, port = pair
    monkeypatch.setattr(Qwen3ASR, "from_pretrained", classmethod(lambda cls, *a, **k: port))
    monkeypatch.setattr(JaxASR, "from_pretrained", classmethod(lambda cls, *a, **k: jax_model))
    rc = cli.main(argv)
    out = capsys.readouterr()
    assert jax_cli.main(argv) == rc
    ref = capsys.readouterr()
    return out, ref, rc


def test_basic_args():
    args = build_parser().parse_args(["a.wav", "--model", "/m"])
    assert args.audio == ["a.wav"]
    assert args.model == "/m"
    assert args.temperature == 0.0
    assert args.repetition_penalty == 1.2


def test_multiple_files_and_options():
    args = build_parser().parse_args(
        ["a.wav", "b.wav", "--model", "/m", "--language", "de",
         "--temperature", "0.7", "--top-k", "40", "--json", "--batch"]
    )
    assert len(args.audio) == 2
    assert args.language == "de"
    assert args.top_k == 40
    assert args.json and args.batch


def test_model_required():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["a.wav"])


def test_same_flags_as_jax():
    from qwen3_asr_tpu.cli import build_parser as jax_parser

    def flags(p):
        return sorted((a.dest, tuple(a.option_strings), a.nargs, a.type, a.default)
                      for a in p._actions)

    assert flags(build_parser()) == flags(jax_parser())


def test_runtime_flags():
    args = build_parser().parse_args(
        ["a.wav", "--model", "/m", "--no-spec", "--int8-weights",
         "--int8-kv", "--compile-cache", "/tmp/xc"]
    )
    assert args.no_spec and args.int8_weights and args.int8_kv
    assert args.compile_cache == "/tmp/xc"


class _Boom(Exception):
    pass


def _stop_at_load(monkeypatch, seen):
    def fake(cls, path, runtime=None, **kw):
        seen["runtime"] = runtime
        raise _Boom  # stop before any model work

    monkeypatch.setattr(Qwen3ASR, "from_pretrained", classmethod(fake))


def test_runtime_flags_reach_from_pretrained(monkeypatch):
    """--no-spec / --int8-* / --compile-cache build the RuntimeConfig passed
    to from_pretrained (and no runtime kwarg without them)."""
    seen = {}
    _stop_at_load(monkeypatch, seen)
    with pytest.raises(_Boom):
        cli.main(["a.wav", "--model", "/m", "--no-spec", "--int8-kv",
                  "--compile-cache", "/tmp/xc"])
    rt = seen["runtime"]
    assert rt.speculative == "off" and rt.spec_engine == "off"
    assert rt.kv_cache_dtype == "int8"
    assert rt.compile_cache_dir == "/tmp/xc"
    with pytest.raises(_Boom):
        cli.main(["a.wav", "--model", "/m"])
    assert seen["runtime"] is None


def test_stream_flag():
    args = build_parser().parse_args(["a.wav", "--model", "/m", "--stream", "30"])
    assert args.stream == 30.0
    assert build_parser().parse_args(["a.wav", "--model", "/m"]).stream is None


def test_live_flag():
    args = build_parser().parse_args(["a.wav", "--model", "/m", "--live", "1.0"])
    assert args.live == 1.0
    assert build_parser().parse_args(["a.wav", "--model", "/m"]).live is None


def test_live_mode_end_to_end(pair, tmp_path, monkeypatch, capsys):
    """--live drives IncrementalSession through the CLI: one refresh per fed
    second, each line the JAX CLI's."""
    wav = tmp_path / "clip.wav"
    _write_wav(wav, _tone(2.5))
    out, ref, rc = _run_both(pair, [str(wav), "--model", "/ignored", "--live", "1.0",
                                    "--max-tokens", "4"], monkeypatch, capsys)
    assert rc == 0
    lines = out.out.strip().splitlines()
    assert len(lines) == 3
    assert all("clip.wav" in line for line in lines)
    assert lines == ref.out.strip().splitlines()


def test_live_mode_long_audio_falls_back_to_streaming(pair, tmp_path, monkeypatch, capsys):
    """--live with audio longer than the largest frame bucket falls back to
    segmented streaming, as the JAX CLI does, with the same segments."""
    wav = tmp_path / "long.wav"
    _write_wav(wav, _tone(40.0))                   # > the 32 s largest bucket
    out, ref, rc = _run_both(pair, [str(wav), "--model", "/ignored", "--live", "10.0",
                                    "--max-tokens", "4"], monkeypatch, capsys)
    assert rc == 0
    assert "falling back to segmented streaming" in out.err
    lines = [ln for ln in out.out.strip().splitlines() if "long.wav" in ln]
    assert lines
    assert out.out == ref.out


@pytest.mark.parametrize("mode", [[], ["--stream", "10"], ["--batch"]])
def test_transcripts_match_jax_cli(pair, tmp_path, monkeypatch, capsys, mode):
    """The offline, --stream and --batch modes print the JAX CLI's lines."""
    paths = []
    for i, secs in enumerate((3.4, 12.5)):
        paths.append(tmp_path / f"c{i}.wav")
        _write_wav(paths[-1], _tone(secs, 300.0 + 90 * i))
    out, ref, rc = _run_both(pair, [*map(str, paths), "--model", "/ignored",
                                    "--max-tokens", "6", *mode], monkeypatch, capsys)
    assert rc == 0
    assert out.out.strip() and out.out == ref.out


def test_w8a8_and_spec_sampling_flags(monkeypatch):
    seen = {}
    _stop_at_load(monkeypatch, seen)
    with pytest.raises(_Boom):
        cli.main(["a.wav", "--model", "/m", "--int8-weights", "--int8-act",
                  "--spec-sampling"])
    rt = seen["runtime"]
    assert rt.quantization == "int8"
    assert rt.act_quant == "int8"
    assert rt.spec_sampling is True


def test_int8_act_requires_int8_weights(capsys):
    rc = cli.main(["a.wav", "--model", "/m", "--int8-act"])
    assert rc == 2
    assert "--int8-weights" in capsys.readouterr().err


def test_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_asr_tpu_torch", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--live" in proc.stdout and "--stream" in proc.stdout
