"""Graceful-degradation ladder: overload sheds quality, not requests (the
port's copy of ``repro.resilience.degrade``).

Each :class:`Rung` names a cheaper serving target; the
:class:`DegradationLadder` walks between rungs on the ±1
recommendations of a :class:`~repro_torch.balance.PressurePolicy` fed with
``latency`` :class:`~repro_torch.balance.LoadSignal`\\ s.  The knobs and
their exactness guarantees (DESIGN.md §10):

=====================  ====================================================
knob                   guarantee when engaged
=====================  ====================================================
defer_updates          **exact** against the *effective* update schedule —
                       the graph the session serves is a real (staler)
                       version; a reference replaying the same effective
                       schedule matches bit-for-bit (§2.2 invariant holds
                       throughout)
occupancy_threshold τ  **exact at convergence** — deferring sparse block
                       columns reorders pushes (any D-iteration schedule
                       converges, §2.2) but the solve still drains to the
                       same tolerance before a response is served
target_scale           **bounded** — served error grows to at most
                       ``scale × target_error`` (the solve stops earlier
                       on the same monotone residual)
round_cap              **best-effort** — the emergency rung: serve
                       whatever H holds when the cap strikes; the
                       response's residual is reported, never hidden
=====================  ====================================================

Ladder order matters: the exact knobs engage first, accuracy-costing
knobs only under sustained overload.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..balance import LoadSignal, PressurePolicy

__all__ = ["Rung", "DEFAULT_RUNGS", "SERVE_RUNGS", "DegradationLadder"]


@dataclasses.dataclass(frozen=True)
class Rung:
    """One serving target.  ``None`` / ``1.0`` / ``False`` fields mean
    "leave the session's configured behavior alone"."""

    name: str
    target_scale: float = 1.0          # solve until scale × target_error
    occupancy_threshold: Optional[float] = None  # frontier τ override
    round_cap: Optional[int] = None    # hard per-request round budget
    defer_updates: bool = False        # queue graph deltas, serve stale

    def __post_init__(self):
        if self.target_scale < 1.0:
            raise ValueError(
                f"target_scale loosens (>= 1.0), got {self.target_scale}")
        if (self.occupancy_threshold is not None
                and not 0.0 <= self.occupancy_threshold < 1.0):
            raise ValueError(
                f"occupancy_threshold must be in [0, 1), got "
                f"{self.occupancy_threshold}")


DEFAULT_RUNGS: Tuple[Rung, ...] = (
    Rung("nominal"),
    Rung("defer-updates", defer_updates=True),
    Rung("shed-occupancy", defer_updates=True, occupancy_threshold=0.25),
    Rung("loosen-target", defer_updates=True, occupancy_threshold=0.25,
         target_scale=8.0),
    Rung("survival", defer_updates=True, occupancy_threshold=0.5,
         target_scale=32.0, round_cap=64),
)

# The continuous-batching scheduler's ladder (repro_torch.serving): the
# batched lane round has no per-block occupancy τ to shed — its
# frontier mask is already per-lane — so the exact defer-updates knob
# engages first and overload then walks straight into the bounded /
# best-effort knobs.  round_cap counts *per-lane* rounds (a lane
# admitted late is capped on its own clock, not the batch's), and a
# capped lane retires best-effort with its residual reported — shed
# quality, never requests (DESIGN.md §11).
SERVE_RUNGS: Tuple[Rung, ...] = (
    Rung("nominal"),
    Rung("defer-updates", defer_updates=True),
    Rung("loosen-target", defer_updates=True, target_scale=4.0),
    Rung("loosen-more", defer_updates=True, target_scale=16.0),
    Rung("survival", defer_updates=True, target_scale=64.0,
         round_cap=256),
)


class DegradationLadder:
    """Current-rung state machine over a pressure controller.

    ``observe(signal)`` runs one control step and moves at most one
    rung; the supervisor reads the active rung's knobs per request and
    re-applies live driver overrides via :meth:`apply`.
    """

    def __init__(self, rungs: Tuple[Rung, ...] = DEFAULT_RUNGS,
                 policy: Optional[PressurePolicy] = None):
        if not rungs:
            raise ValueError("ladder needs at least one rung")
        self.rungs = tuple(rungs)
        self.policy = policy if policy is not None else PressurePolicy()
        self.index = 0
        # driver τ to restore when a shed-occupancy rung disengages
        self._base_tau: Optional[float] = None

    @property
    def rung(self) -> Rung:
        return self.rungs[self.index]

    @property
    def engaged(self) -> bool:
        return self.index > 0

    def until(self, base_target: float) -> float:
        return base_target * self.rung.target_scale

    def observe(self, signal: LoadSignal) -> int:
        """One control step: returns the executed rung delta
        (−1 | 0 | +1); the index saturates at the ladder ends."""
        delta = self.policy.update(signal)
        new = min(max(self.index + delta, 0), len(self.rungs) - 1)
        executed = new - self.index
        self.index = new
        return executed

    def apply(self, session) -> dict:
        """Push the active rung's live overrides into the session's
        driver.  Only the frontier drivers expose a τ knob
        (``driver.occupancy_threshold`` is read per advance); other
        knobs are consumed by the supervisor at solve time.  Returns
        the applied overrides for event logging."""
        applied: dict = {}
        d = session._driver
        if hasattr(d, "occupancy_threshold"):
            if self._base_tau is None:
                self._base_tau = float(d.occupancy_threshold)
            tau = (self.rung.occupancy_threshold
                   if self.rung.occupancy_threshold is not None
                   else self._base_tau)
            if float(d.occupancy_threshold) != tau:
                d.occupancy_threshold = tau
                applied["occupancy_threshold"] = tau
        return applied

    def reset(self) -> None:
        self.index = 0
        self.policy.reset_worker(0)

    def history_names(self) -> List[str]:
        return [r.name for r in self.rungs]
