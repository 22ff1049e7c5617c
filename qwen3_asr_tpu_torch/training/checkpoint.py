"""Training checkpoint and resume.

Counterpart of ``qwen3_asr_tpu/training/checkpoint.py``, with its directory
layout: one ``step_{step:08d}`` directory per snapshot of the full
:class:`~.train.TrainState` (parameters, optimizer state, step).  Where the
JAX package commits through Orbax, a snapshot here is one ``torch.save`` of
the parameter trees, the optimizer's ``state_dict()`` and the step, written
into a temporary directory that ``os.replace`` renames into place, and read
back with ``weights_only=True``.  Inference-facing exports are the
safetensors checkpoints of ``models/params.py``.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from dataclasses import replace
from pathlib import Path

import torch

from .train import TrainState, named_params

STATE_FILE = "train_state.pt"
_STEP_DIR = re.compile(r"step_(\d+)")


def save_train_state(directory: str | Path, state: TrainState, step: int | None = None) -> Path:
    """Snapshot a TrainState; returns the checkpoint path.  A snapshot of
    the same step replaces the earlier one."""
    path = Path(directory).absolute()
    if step is None:
        step = state.step
    target = path / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{target.name}.", dir=path))
    try:
        torch.save({
            "encoder": state.encoder,
            "decoder": state.decoder,
            "optimizer": state.optimizer.state_dict(),
            "step": int(step),
        }, tmp / STATE_FILE)
        if target.exists():
            shutil.rmtree(target)
        os.replace(tmp, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def latest_step(directory: str | Path) -> int | None:
    """The largest step saved under ``directory``; None if there is none or
    no such directory.  Names other than ``step_<digits>`` (temporary
    directories of a save in flight) are ignored."""
    path = Path(directory)
    if not path.is_dir():
        return None
    steps = [
        int(m.group(1))
        for p in path.iterdir()
        if p.is_dir() and (m := _STEP_DIR.fullmatch(p.name))
    ]
    return max(steps) if steps else None


def restore_train_state(
    directory: str | Path, template: TrainState, step: int | None = None
) -> TrainState:
    """Restore the given (or latest) step into ``template``.

    The saved values are copied in place into the template's tensors, in
    their device and dtype (replacing the tensors would detach the
    template's optimizer from its parameters), then the optimizer state is
    loaded into the template's optimizer.  Pass a freshly initialized state
    (:func:`~.train.init_train_state`) of the same layout.  Returns the
    template with the saved step."""
    path = Path(directory).absolute()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(path / f"step_{step:08d}" / STATE_FILE, map_location="cpu",
                       weights_only=True)
    src = named_params(saved["encoder"], saved["decoder"])
    dst = named_params(template.encoder, template.decoder)
    src_layout = [(name, tuple(t.shape)) for name, t in src]
    dst_layout = [(name, tuple(t.shape)) for name, t in dst]
    if src_layout != dst_layout:
        diff = sorted(set(src_layout) ^ set(dst_layout))[:4]
        raise ValueError(f"checkpoint step {step} does not match the template's layout: {diff}")
    with torch.no_grad():
        for (_, d), (_, s) in zip(dst, src):
            d.copy_(s)
    template.optimizer.load_state_dict(saved["optimizer"])
    return replace(template, step=int(saved["step"]))
