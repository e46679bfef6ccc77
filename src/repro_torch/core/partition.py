"""The paper's dynamic partition controller (§2.5.2), the port's copy of
the controller half of ``repro.core.partition``.

:class:`DynamicController` is a measurement-driven controller that
equalizes per-PID convergence *slopes* by moving load units from the
slowest PID to the fastest one, with a cooldown to damp oscillation.  It
is deliberately ignorant of the graph structure: load balance emerges
from the *observed* residual decay rates alone.  The
:mod:`repro_torch.balance` control plane wraps it as ``SlopeEMAPolicy``;
the engine executes its decisions as bucket moves.

The static partitions (``uniform_partition``, ``cb_partition``) and the
node-granular ``apply_move`` come with the simulator slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = [
    "DynamicControllerConfig",
    "DynamicController",
    "MoveInstruction",
    "slope_ema_update",
]


# ------------------------------------------------------------------------------
# Dynamic partition controller (§2.5.2) — the paper's contribution
# ------------------------------------------------------------------------------
@dataclasses.dataclass
class DynamicControllerConfig:
    """Paper defaults, §2.5.2."""

    k: int
    target_error: float
    eta: float = 0.5  # EMA factor η
    z: int = 10  # cooldown steps Z
    max_move_frac: float = 0.1  # min(·, 0.1) cap on the moved fraction
    # trigger: slope_min < slope_max + log10(0.5)  («difference more than 50%»)
    trigger_log10: float = math.log10(0.5)

    @property
    def eps_c(self) -> float:
        """ε' = target_error/K/1000 — keeps log defined when r+s → 0."""
        return self.target_error / self.k / 1000.0


@dataclasses.dataclass
class MoveInstruction:
    """«move n_move units from PID src to PID dst» (src is the slowest)."""

    src: int  # i_min — slowest PID (smallest slope = largest residual exponent)
    dst: int  # i_max — fastest PID
    n_move: int  # |Ω_src| · min((slope_min+1)/(slope_max+1), 0.1)


def slope_ema_update(slope: np.ndarray, r_plus_s: np.ndarray,
                     eta: float, eps_c: float) -> np.ndarray:
    """The §2.5.2 slope update, shared by every slope-based policy::

        slope_k := slope_k·(1−η) − log10(r_k + s_k + ε')·η
    """
    r_plus_s = np.asarray(r_plus_s, dtype=np.float64)
    return slope * (1.0 - eta) - np.log10(r_plus_s + eps_c) * eta


class DynamicController:
    """Slope-EMA load balancer (paper §2.5.2), unit-agnostic.

    Feed it the per-PID residual magnitude ``r_k + s_k`` (or any positive
    per-worker progress signal: per-expert token counts, per-device step
    times) once per time step together with the current per-PID set sizes;
    it returns a :class:`MoveInstruction` when the imbalance rule fires.

    Paper-exact update::

        slope_k := slope_k·(1−η) − log10(r_k + s_k + ε')·η          (EMA)
        fire iff slope_min < slope_max + log10(0.5)                 (50% rule)
        n_move = |Ω_imin| · min((slope_min+1)/(slope_max+1), 0.1)
        cooldown: modified sets frozen for Z steps

    ``−slope_k`` tracks the exponent of the residual, so *larger* slope =
    *faster* convergence; i_min is the slowest PID and sheds load.
    """

    def __init__(self, cfg: DynamicControllerConfig):
        self.cfg = cfg
        self.slope = np.zeros(cfg.k, dtype=np.float64)
        self.cooldown = np.zeros(cfg.k, dtype=np.int64)
        self.n_updates = 0
        self.n_moves = 0

    def update(
        self, r_plus_s: np.ndarray, set_sizes: np.ndarray
    ) -> Optional[MoveInstruction]:
        cfg = self.cfg
        self.slope = slope_ema_update(self.slope, r_plus_s, cfg.eta,
                                      cfg.eps_c)
        self.n_updates += 1
        self.cooldown = np.maximum(self.cooldown - 1, 0)

        eligible = np.nonzero(self.cooldown == 0)[0]
        if eligible.size < 2:
            return None
        i_min = int(eligible[np.argmin(self.slope[eligible])])
        i_max = int(eligible[np.argmax(self.slope[eligible])])
        if i_min == i_max:
            return None
        s_min, s_max = self.slope[i_min], self.slope[i_max]
        if not (s_min < s_max + cfg.trigger_log10):
            return None
        ratio = (s_min + 1.0) / (s_max + 1.0) if (s_max + 1.0) != 0 else 1.0
        frac = min(max(ratio, 0.0), cfg.max_move_frac)
        n_move = int(set_sizes[i_min] * frac)
        if n_move < 1:
            return None
        self.cooldown[i_min] = cfg.z
        self.cooldown[i_max] = cfg.z
        self.n_moves += 1
        return MoveInstruction(src=i_min, dst=i_max, n_move=n_move)

    def reset_pid(self, k: int) -> None:
        """Re-seed a PID's slope after an external event (elastic join/leave)."""
        self.slope[k] = 0.0
        self.cooldown[k] = self.cfg.z
