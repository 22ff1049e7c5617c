"""Training checkpoint and resume.

Counterpart of ``qwen3_asr_tpu/training/checkpoint.py``, with its directory
layout: one ``step_{step:08d}`` directory per snapshot of the full
:class:`~.train.TrainState` (parameters, optimizer state, step), written
into a temporary directory that ``os.replace`` renames into place.
Inference-facing exports are the safetensors checkpoints of
``models/params.py``.

  * One device: one ``torch.save`` of the parameter trees, the optimizer's
    ``state_dict()`` and the step (:data:`STATE_FILE`).
  * A (dp, tp) mesh: the ranks at dp coordinate 0 write one file each
    (:data:`SHARD_FILE`), holding their local leaves and the optimizer
    state of each (Adam's moments share their leaf's placement), and
    :data:`MANIFEST` records the mesh shape and each leaf's global shape
    and tp dim.  Every rank reaches the temporary directory; after a
    barrier rank 0 renames it into place.

:func:`restore_train_state` reads either, one leaf at a time
(``torch.load(..., mmap=True)``): it rebuilds each leaf's global tensor
from the shards and copies the template's local slice into it in place, and
likewise the optimizer state, so a snapshot restores onto the same mesh,
another mesh or one device (Orbax's contract, which restores onto the
template's shardings); a one-device snapshot is the tp = 1 case.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist

from .train import TrainState, named_params, tp_dims

STATE_FILE = "train_state.pt"
MANIFEST = "manifest.json"
SHARD_FILE = "shard_tp{}.pt"
_STEP_DIR = re.compile(r"step_(\d+)")


def _sharded(state: TrainState) -> bool:
    mesh = state.mesh
    return mesh is not None and mesh.shape["dp"] * mesh.shape["tp"] > 1


def _global_shape(t: torch.Tensor, dim: int | None, tp: int) -> list[int]:
    shape = list(t.shape)
    if dim is not None:
        shape[dim] *= tp
    return shape


def _optimizer_state(state: TrainState) -> tuple[dict, list]:
    """(leaf name -> its optimizer state, the param groups)."""
    saved = state.optimizer.state_dict()
    names = [n for n, _ in named_params(state.encoder, state.decoder)]
    return {names[i]: s for i, s in saved["state"].items()}, saved["param_groups"]


def save_train_state(directory: str | Path, state: TrainState, step: int | None = None) -> Path:
    """Snapshot a TrainState; returns the checkpoint path.  A snapshot of
    the same step replaces the earlier one.  On a mesh every rank calls
    it, with the same ``directory`` (a file system they share)."""
    path = Path(directory).absolute()
    if step is None:
        step = state.step
    target = path / f"step_{step:08d}"
    if _sharded(state):
        return _save_sharded(path, target, state, int(step))
    path.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{target.name}.", dir=path))
    try:
        torch.save({
            "encoder": state.encoder,
            "decoder": state.decoder,
            "optimizer": state.optimizer.state_dict(),
            "step": int(step),
        }, tmp / STATE_FILE)
        _commit(tmp, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def _commit(tmp: Path, target: Path) -> None:
    if target.exists():
        shutil.rmtree(target)
    os.replace(tmp, target)


def _save_sharded(path: Path, target: Path, state: TrainState, step: int) -> Path:
    mesh = state.mesh
    tp, rank = mesh.shape["tp"], dist.get_rank()
    tmp = path / f".{target.name}.partial"
    if rank == 0:
        path.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
    dist.barrier()
    if mesh.coordinate["dp"] == 0:
        named = named_params(state.encoder, state.decoder)
        opt, groups = _optimizer_state(state)
        torch.save({
            "params": {n: t.detach() for n, t in named},
            "optimizer": opt,
            "param_groups": groups,
        }, tmp / SHARD_FILE.format(mesh.coordinate["tp"]))
        if mesh.coordinate["tp"] == 0:
            dims = tp_dims(state.encoder, state.decoder)
            manifest = {
                "mesh": dict(mesh.shape),
                "step": step,
                "leaves": [{"name": n, "shape": _global_shape(t, d, tp), "tp_dim": d}
                           for (n, t), d in zip(named, dims)],
            }
            (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    dist.barrier()
    if rank == 0:
        _commit(tmp, target)
    dist.barrier()
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


class _Snapshot:
    """A snapshot's leaves as global tensors, read one at a time: its
    ``layout`` [(name, global shape)], ``param(name)``, ``moments(name)``
    (that leaf's optimizer state), ``param_groups`` and ``step``."""

    def __init__(self, target: Path):
        load = lambda p: torch.load(p, map_location="cpu", mmap=True, weights_only=True)  # noqa: E731
        if (target / MANIFEST).exists():
            manifest = json.loads((target / MANIFEST).read_text())
            self.shards = [load(target / SHARD_FILE.format(r))
                           for r in range(manifest["mesh"]["tp"])]
            self.dims = {leaf["name"]: leaf["tp_dim"] for leaf in manifest["leaves"]}
            self.layout = [(leaf["name"], tuple(leaf["shape"])) for leaf in manifest["leaves"]]
            self.param_groups = self.shards[0]["param_groups"]
            self.step = int(manifest["step"])
            return
        saved = load(target / STATE_FILE)
        named = named_params(saved["encoder"], saved["decoder"])
        names = [n for n, _ in named]
        self.shards = [{
            "params": dict(named),
            "optimizer": {names[i]: s for i, s in saved["optimizer"]["state"].items()},
        }]
        self.dims = {n: None for n in names}
        self.layout = [(n, tuple(t.shape)) for n, t in named]
        self.param_groups = saved["optimizer"]["param_groups"]
        self.step = int(saved["step"])

    def _whole(self, pieces: list[torch.Tensor], dim: int | None) -> torch.Tensor:
        if dim is None or len(pieces) == 1:
            return pieces[0]
        return torch.cat(pieces, dim=dim)

    def param(self, name: str) -> torch.Tensor:
        return self._whole([s["params"][name] for s in self.shards], self.dims[name])

    def moments(self, name: str) -> dict[str, torch.Tensor]:
        """The leaf's optimizer state, each tensor whole: those shaped as the
        leaf's shard share its placement, the rest (Adam's step) are
        replicated."""
        first = self.shards[0]["optimizer"].get(name)
        if first is None:
            return {}
        local = self.shards[0]["params"][name].shape
        return {k: self._whole([s["optimizer"][name][k] for s in self.shards],
                               self.dims[name] if v.shape == local else None)
                for k, v in first.items()}


def restore_train_state(
    directory: str | Path, template: TrainState, step: int | None = None
) -> TrainState:
    """Restore the given (or latest) step into ``template``.

    Each saved leaf, rebuilt whole from its shards, is sliced to the
    template's placement on the template's mesh (``template.mesh``; None is
    one device) and copied in place into the template's tensor, in its
    device and dtype (replacing the tensors would detach the template's
    optimizer from its parameters); the optimizer state likewise, then
    loaded into the template's optimizer, whose param groups keep their own
    ``capturable`` flag.  Pass a freshly initialized state
    (:func:`~.train.init_train_state`) of the same global layout, on any
    mesh; ValueError if the layouts differ.  Returns the template with the
    saved step."""
    path = Path(directory).absolute()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    snap = _Snapshot(path / f"step_{step:08d}")
    mesh = template.mesh
    tp, coord = (mesh.shape["tp"], mesh.coordinate["tp"]) if mesh is not None else (1, 0)
    dst = named_params(template.encoder, template.decoder)
    dims = tp_dims(template.encoder, template.decoder)
    dst_layout = [(name, tuple(_global_shape(t, d, tp))) for (name, t), d in zip(dst, dims)]
    if snap.layout != dst_layout:
        diff = sorted(set(snap.layout) ^ set(dst_layout))[:4]
        raise ValueError(f"checkpoint step {step} does not match the template's layout: {diff}")

    def local(t: torch.Tensor, dim: int | None) -> torch.Tensor:
        return t if dim is None else t.chunk(tp, dim=dim)[coord]

    state = {}
    with torch.no_grad():
        for i, ((name, d), dim) in enumerate(zip(dst, dims)):
            whole = snap.param(name)
            d.copy_(local(whole, dim))
            moments = snap.moments(name)
            if moments:
                state[i] = {k: local(v, dim if v.shape == whole.shape else None)
                            .clone(memory_format=torch.contiguous_format)
                            for k, v in moments.items()}
    groups, own = snap.param_groups, template.optimizer.param_groups
    if len(groups) == len(own):
        # The template's own ``capturable`` flag: a snapshot taken on the
        # card says True (the train step sets it there), which an optimizer
        # over CPU tensors cannot step.
        groups = [dict(g, capturable=o["capturable"]) if "capturable" in o else g
                  for g, o in zip(groups, own)]
    template.optimizer.load_state_dict({"state": state, "param_groups": groups})
    return replace(template, step=snap.step)
