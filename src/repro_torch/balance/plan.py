"""Granularity-agnostic move decisions (the port's copy of
``repro.balance.plan``).

A rebalancing policy never sees what a "unit" is — it emits
:class:`MovePlan`\\ s, and a per-granularity executor (see
:mod:`repro_torch.balance.executors`) turns them into node reassignments,
bucket-row permutations, or expert-shard migrations.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MovePlan", "UNIT_KINDS"]

UNIT_KINDS = ("node", "bucket", "expert-shard", "device")


@dataclasses.dataclass(frozen=True)
class MovePlan:
    """«move ``units`` load units from worker ``src`` to worker ``dst``».

    ``src`` is always the overloaded / slow worker shedding load (the
    paper's i_min: the PID with the lagging convergence slope).
    """

    src: int
    dst: int
    units: int
    kind: str = "node"

    def __post_init__(self):
        if self.kind not in UNIT_KINDS:
            raise ValueError(
                f"unknown unit kind {self.kind!r}; expected one of "
                f"{UNIT_KINDS}"
            )
        if self.units < 1:
            raise ValueError(f"units must be >= 1, got {self.units}")
        if self.src == self.dst:
            raise ValueError("src == dst move is a no-op")

    def to_instruction(self):
        """Down-convert for the §2.5.2 primitives in ``core.partition``."""
        from ..core.partition import MoveInstruction

        return MoveInstruction(src=self.src, dst=self.dst,
                               n_move=self.units)

    @classmethod
    def from_instruction(cls, mi, kind: str = "node") -> "MovePlan":
        return cls(src=mi.src, dst=mi.dst, units=mi.n_move, kind=kind)
