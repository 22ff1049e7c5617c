"""The control channel that keeps a group of ranks in lockstep.

The JAX package serves a mesh from one controller: one process admits,
steps and retires, and GSPMD runs each program on every device.  The port
runs one process per rank, so a server on a mesh runs SPMD: every rank
constructs it with the same arguments, and the group's first rank, the
**driving rank**, owns the request queue, the clock, batching and futures.
It broadcasts each operation to the group's other ranks, the
**followers**, which apply the same operation to their own shards, in the
same order, and never look at a clock.

A :class:`Channel` carries those messages over a gloo group of its own
(``parallel/mesh.py`` makes one per tp group and one over the world with
the mesh), so under NCCL too a control message costs no device sync and
never queues behind the data collectives.  An operation is a picklable
record: its name and its host arguments.  Every operation ends in a status
exchange on the same channel: each rank reports whether its operation
raised, and when any did, every rank raises :class:`RankFault` naming the
ranks and their errors, so a fault stops the group together.  A rank that
raises inside a data collective leaves its peers waiting in that
collective (until the process group's timeout), as in any SPMD program:
the exchange covers faults between the collectives and faults every rank
raises alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch.distributed as dist

#: The operation that ends a follower's loop.
STOP = "stop"


class RankFault(RuntimeError):
    """An operation raised on some rank of a group: ``errors`` maps each
    such rank (global) to its error's message."""

    def __init__(self, op: str, errors: dict[int, str]) -> None:
        self.op, self.errors = op, errors
        detail = "; ".join(f"rank {r}: {m}" for r, m in sorted(errors.items()))
        super().__init__(f"operation {op!r} raised on {len(errors)} rank(s): {detail}")

    def __reduce__(self):
        return type(self), (self.op, self.errors)


@dataclasses.dataclass(frozen=True)
class Channel:
    """The control channel of the global ``ranks`` (in order; the first
    drives) over their gloo ``group``."""

    group: Any
    ranks: tuple[int, ...]

    @property
    def driving_rank(self) -> int:
        """The driving rank's global rank."""
        return self.ranks[0]

    @property
    def driving(self) -> bool:
        return dist.get_rank() == self.driving_rank

    def post(self, op: str, args: dict | None = None) -> None:
        """Driving rank: send ``op`` and its host arguments to the followers."""
        dist.broadcast_object_list([op, args or {}], src=self.driving_rank, group=self.group)

    def receive(self) -> tuple[str, dict]:
        """Follower: the next operation the driving rank posted."""
        box: list = [None, None]
        dist.broadcast_object_list(box, src=self.driving_rank, group=self.group)
        return box[0], box[1]

    def settle(self, op: str, error: BaseException | None) -> None:
        """The status exchange that ends ``op`` on every rank: RankFault
        (from this rank's ``error``, if any) when any rank raised."""
        mine = None if error is None else f"{type(error).__name__}: {error}"
        reports: list = [None] * len(self.ranks)
        dist.all_gather_object(reports, mine, group=self.group)
        errors = {r: m for r, m in zip(self.ranks, reports) if m is not None}
        if errors:
            raise RankFault(op, errors) from error

    def run(self, op: str, apply: Callable[[str, dict], Any], args: dict) -> Any:
        """``apply(op, args)`` here, then the status exchange; its result."""
        result, error = None, None
        try:
            result = apply(op, args)
        except Exception as exc:  # noqa: BLE001 -- every rank learns it in settle
            error = exc
        self.settle(op, error)
        return result

    def lead(self, op: str, apply: Callable[[str, dict], Any], args: dict,
             wire: dict | None = None) -> Any:
        """Driving rank: post ``op`` with ``wire`` (default ``args``: what the
        followers need, without this rank's own payload such as futures),
        apply it here with ``args`` and settle; the result of this rank's
        ``apply``."""
        self.post(op, args if wire is None else wire)
        return self.run(op, apply, args)

    def follow(self, apply: Callable[[str, dict], Any]) -> None:
        """Follower: apply and settle each posted operation until
        :data:`STOP`; RankFault when an operation raised on any rank."""
        while True:
            op, args = self.receive()
            if op == STOP:
                return
            self.run(op, apply, args)
