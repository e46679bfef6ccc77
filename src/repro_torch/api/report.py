"""Unified solve results: :class:`SolveReport` + :class:`RoundReport`.

Every backend — reference sequential, frontier jnp/Pallas, distributed
engine, faithful simulator — returns the same report shape with the
same field semantics (DESIGN.md §4):

* ``n_ops`` is the **edge-push count** of §2.3 for every backend: one
  op per edge pushed plus one per selected dangling node
  (``max(out_degree, 1)`` per diffusion).  Backend-specific cost models
  (the simulator's exchange/reassignment charges, its wall-clock
  ``steps·PID_Speed/L`` table metric) live in ``extras`` — they remain
  available but never leak into the cross-backend fields.
* ``cost_iterations = n_ops / L`` — the paper's normalized iteration
  count, directly comparable across backends.
* ``trace`` is the per-round convergence history at each backend's
  native grain (sweeps, frontier rounds, engine chunks, simulator time
  steps), every record carrying the cumulative edge-push count.
* ``move_log`` lists executed dynamic-partition decisions
  ``(when, src, dst, units)``; empty for static/single-PID runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["RoundReport", "SolveReport"]


@dataclasses.dataclass(frozen=True)
class RoundReport:
    """One progress record: the backend's native round/sweep/chunk/step."""

    round: int  # progress index in the backend's native unit
    residual: float  # |F|_1 (+ in-flight fluid where applicable)
    n_ops: int  # cumulative edge-push ops so far


@dataclasses.dataclass
class SolveReport:
    """What every backend returns from :func:`repro_torch.api.solve`."""

    x: np.ndarray  # solution estimate H ([N] or [N, C] for batched)
    residual: float  # |F|_1 at exit (global upper bound)
    n_ops: int  # elementary edge pushes (§2.3, unified accounting)
    cost_iterations: float  # n_ops / L (paper's normalized cost)
    n_rounds: int  # native rounds/sweeps/steps executed
    converged: bool
    method: str  # registry key that produced this report
    trace: List[RoundReport] = dataclasses.field(default_factory=list)
    move_log: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    wall_time_s: float = 0.0
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.trace and self.n_ops != self.trace[-1].n_ops:
            # the final trace record must agree with the headline count
            raise ValueError(
                f"trace/n_ops mismatch: {self.trace[-1].n_ops} != "
                f"{self.n_ops}"
            )

    def summary(self) -> str:
        return (
            f"[{self.method}] converged={self.converged} "
            f"residual={self.residual:.3e} "
            f"cost={self.cost_iterations:.2f} matvec-equivalents "
            f"({self.n_ops} edge pushes, {self.n_rounds} rounds, "
            f"{len(self.move_log)} moves, {self.wall_time_s:.2f}s)"
        )
