"""``tools/torch_micro_bench.py``, the port of ``tools/micro_bench.py``: it
imports no JAX, keeps the JAX tool's section names, runs its kernel sections
on CPU tensors at tiny shapes (the kernel wrappers' plain versions), and
refuses to run without a CUDA device."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, str(TOOLS))
    try:
        import torch_micro_bench
    finally:
        sys.path.remove(str(TOOLS))
    return torch_micro_bench


def _run(code: str, tmp_path) -> subprocess.CompletedProcess:
    env = {"PATH": os.environ.get("PATH", ""), "HOME": str(tmp_path),
           "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)


def test_imports_no_jax(tmp_path):
    proc = _run(
        "import runpy, sys\n"
        f"runpy.run_path({str(TOOLS / 'torch_micro_bench.py')!r}, run_name='bench')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qwen3_asr_tpu.'))"
        " or m == 'qwen3_asr_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n", tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_section_names_match_the_jax_tool(bench):
    source = (TOOLS / "micro_bench.py").read_text()
    jax_sections = re.findall(r'if "([\w-]+)" in sections', source)
    assert list(bench.SECTIONS) == jax_sections
    assert len(jax_sections) == 14


def test_kernelab_runs_on_cpu(bench, capsys):
    res = bench.bench_kernel_ab(device="cpu", B=4, S=384, pb=256, L=2, plen=100,
                                iters=1, warmup=0)
    arms = ("K2 decode_attention", "K11d decode_attention_sched",
            "K11c decode_attention_hbm5")
    assert set(res) == {"passes"} | {(a, off) for a in arms for off in (8, 64, 128)}
    assert res["passes"] == 3 * 2
    # Plain versions of one function on one input: the arms agree.
    assert all(v["max_abs_err"] < 1e-5 for k, v in res.items() if k != "passes")
    out = capsys.readouterr().out
    assert out.count("ms/2-layer pass") == 9
    assert "peak device memory: not measured (CPU)" in out


def test_kernel_runs_on_cpu(bench, capsys):
    bench.bench_kernel(device="cpu", B=4, S=384, pb=256, L=2, plen=100, block_k=128)
    out = capsys.readouterr().out
    assert "kernel 1-layer B=4 S=384" in out and "kernel 2-layer loop" in out


def test_entry_point_needs_cuda(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(TOOLS / "torch_micro_bench.py"), "kernelab"], cwd=tmp_path,
        env={"PATH": os.environ.get("PATH", ""), "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
