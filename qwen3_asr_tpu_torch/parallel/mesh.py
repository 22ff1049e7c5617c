"""The (dp, tp) device mesh over the job's ranks.

Counterpart of ``qwen3_asr_tpu/parallel/mesh.py``.  Axes as in the JAX
package:

  * ``dp`` -- data parallel: every dp coordinate holds the whole model (or
    its tp shards) and takes a contiguous slice of a request batch.  No
    collective inside a decode; the results meet once, at the end.
  * ``tp`` -- tensor parallel: attention heads and FFN columns split over
    the tp ranks (Megatron); the port calls the all-reduces and gathers
    itself (``parallel/collectives.py``), where GSPMD inserts them in the
    JAX package.

One process per rank, each driving one device: rank r sits at ``(r // tp,
r % tp)``, so a tp group is ``tp`` consecutive ranks.  Pipeline and expert
parallelism stay absent, as in the JAX package.

With the mesh come its control channels (``parallel/lockstep.py``): gloo
groups of their own, one over the world and one per tp group, which the
servers use to keep the ranks in lockstep.  Every rank makes them in the
same order, the first time it makes a mesh of that shape.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .collectives import TP
from .lockstep import Channel

#: The control groups of each (world, dp, tp): (world group, tp groups by
#: dp coordinate).  Made once, in the same order on every rank.
_CONTROL_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) mesh seen from one rank: ``shape`` {"dp": dp, "tp": tp},
    this rank's ``coordinate`` on it, and the ``DeviceMesh`` whose groups
    carry the collectives (None on a mesh of one device without a process
    group)."""

    shape: dict[str, int]
    coordinate: dict[str, int]
    device_mesh: object = None
    #: (world control group, tp control groups by dp coordinate), or None.
    control: tuple | None = None

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.device_mesh is None:
            raise ValueError("a mesh of one device has no process group")
        return self.device_mesh.get_group(axis)

    def tp_group(self) -> TP | None:
        """This rank's tensor-parallel group, the models' ``tp``; None for
        tp = 1."""
        if self.shape["tp"] == 1:
            return None
        return TP(self.shape["tp"], self.coordinate["tp"], self.group("tp"))

    def channel(self, axis: str) -> Channel:
        """The control channel of this rank's tp group (``"tp"``, tp > 1)
        or of every rank (``"world"``)."""
        if self.control is None:
            raise ValueError("a mesh of one device has no control channel")
        dp, tp = self.shape["dp"], self.shape["tp"]
        world, tp_groups = self.control
        if axis == "world":
            return Channel(world, tuple(range(dp * tp)))
        if axis == "tp" and tp > 1:
            d = self.coordinate["dp"]
            return Channel(tp_groups[d], tuple(range(d * tp, (d + 1) * tp)))
        raise ValueError(f"no control channel along {axis!r} on a {self.shape} mesh")


def _mesh_device_type() -> str:
    """DeviceMesh's device type: "cuda" under NCCL; "cpu" under gloo, which
    carries CUDA tensors through host memory (``collectives.py``)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _control_groups(dp: int, tp: int) -> tuple:
    """The gloo control groups of a (dp, tp) mesh, made on first use: every
    rank calls ``new_group`` for every group, in the same order."""
    key = (dist.group.WORLD, dp, tp)
    if key not in _CONTROL_GROUPS:
        world = dist.new_group(list(range(dp * tp)), backend="gloo")
        tps = [dist.new_group(list(range(d * tp, (d + 1) * tp)), backend="gloo")
               for d in range(dp)] if tp > 1 else []
        _CONTROL_GROUPS[key] = (world, tps)
    return _CONTROL_GROUPS[key]


def make_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, tp) mesh over the default process group, which must hold
    exactly ``dp * tp`` ranks (``parallel.initialize`` first), with its
    control channels.  A (1, 1) mesh needs no group."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp}, tp={tp}")
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if world != dp * tp:
        raise ValueError(
            f"need dp*tp = {dp * tp} ranks, have {world}"
            + ("" if initialized else
               " (no process group: call qwen3_asr_tpu_torch.parallel.initialize(...) "
               "in every rank first)")
        )
    rank = dist.get_rank() if initialized else 0
    device_mesh = control = None
    if initialized:
        from torch.distributed.device_mesh import DeviceMesh

        device_mesh = DeviceMesh(
            _mesh_device_type(), torch.arange(world).reshape(dp, tp),
            mesh_dim_names=("dp", "tp"),
        )
        control = _control_groups(dp, tp)
    return Mesh({"dp": dp, "tp": tp}, {"dp": rank // tp, "tp": rank % tp}, device_mesh,
                control)


def local_mesh() -> Mesh:
    """Single-device mesh (dp=1, tp=1): the no-distribution fast path."""
    return Mesh({"dp": 1, "tp": 1}, {"dp": 0, "tp": 0})
