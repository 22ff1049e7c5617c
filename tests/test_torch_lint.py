"""The port (``qwen3_asr_tpu_torch/``) and ``chip_smoke.py`` hold no finding
of the repository's linter (``tools/lint.py``: syntax, unused and duplicate
imports, whitespace, lines over 120 characters)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "qwen3_asr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_lints_clean(path):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from lint import lint_file
    finally:
        sys.path.remove(str(ROOT / "tools"))
    assert lint_file(path) == []
