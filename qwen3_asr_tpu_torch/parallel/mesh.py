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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .collectives import TP


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) mesh seen from one rank: ``shape`` {"dp": dp, "tp": tp},
    this rank's ``coordinate`` on it, and the ``DeviceMesh`` whose groups
    carry the collectives (None on a mesh of one device without a process
    group)."""

    shape: dict[str, int]
    coordinate: dict[str, int]
    device_mesh: object = None

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


def _mesh_device_type() -> str:
    """DeviceMesh's device type: "cuda" under NCCL; "cpu" under gloo, which
    carries CUDA tensors through host memory (``collectives.py``)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, tp) mesh over the default process group, which must hold
    exactly ``dp * tp`` ranks (``parallel.initialize`` first).  A (1, 1)
    mesh needs no group."""
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
    device_mesh = None
    if initialized:
        from torch.distributed.device_mesh import DeviceMesh

        device_mesh = DeviceMesh(
            _mesh_device_type(), torch.arange(world).reshape(dp, tp),
            mesh_dim_names=("dp", "tp"),
        )
    return Mesh({"dp": dp, "tp": tp}, {"dp": rank // tp, "tp": rank % tp}, device_mesh)


def local_mesh() -> Mesh:
    """Single-device mesh (dp=1, tp=1): the no-distribution fast path."""
    return Mesh({"dp": 1, "tp": 1}, {"dp": 0, "tp": 0})
