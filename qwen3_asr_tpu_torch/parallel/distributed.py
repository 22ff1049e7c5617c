"""Process-group initialization: one process per rank over ``torch.distributed``.

Counterpart of ``qwen3_asr_tpu/parallel/distributed.py``.  The JAX package
is single-controller: one process drives every local device and
``jax.distributed.initialize`` joins the hosts.  The port runs one process
per rank, each driving one device, so initialization is
``torch.distributed.init_process_group`` in every rank, made an explicit,
idempotent call here.  Rank, world size and rendezvous come from the
arguments, or from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) where they are not given.

Backends: ``"nccl"`` (the default) puts one rank on each card, rank
``LOCAL_RANK`` on ``cuda:LOCAL_RANK``; ``"gloo"`` must be asked for, and
carries CUDA tensors through host memory (the CPU tests, and ranks that
share one card).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Topology:
    """The process's place in the job: its rank (``process_index``) among
    ``process_count`` ranks, the CUDA devices it sees (``local_devices``; 1
    on a machine without one, as JAX counts its CPU device) and the devices
    of the job (``global_devices``: one per rank)."""

    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    init_method: str | None = None,
) -> Topology:
    """Join this process to the job's default process group; a no-op when
    it has joined already, or when neither the arguments nor the
    environment name a job (one process, as JAX's single host).

    ``coordinator_address`` ("host:port") is the rendezvous of rank 0
    (``tcp://`` is prefixed); ``init_method`` takes any
    ``init_process_group`` URL instead (``file://`` for the CPU tests);
    with neither, ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).
    ``num_processes``/``process_id`` default to ``WORLD_SIZE``/``RANK``.
    ``backend`` None means ``"nccl"``, whose rank sets its current CUDA
    device to ``LOCAL_RANK`` (default: the rank modulo the visible
    cards)."""
    if dist.is_initialized():
        return topology()
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and num_processes is None:
        return topology()
    if num_processes is None or process_id is None or init_method is None:
        raise ValueError(
            "parallel.initialize needs a rendezvous (coordinator_address, init_method or "
            "MASTER_ADDR/MASTER_PORT), the world size (num_processes or WORLD_SIZE) and "
            "this process's rank (process_id or RANK)"
        )
    backend = backend or "nccl"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id
    )
    return topology()


def topology() -> Topology:
    initialized = dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return Topology(
        process_index=dist.get_rank() if initialized else 0,
        process_count=count,
        local_devices=max(torch.cuda.device_count(), 1),
        global_devices=count,
    )
