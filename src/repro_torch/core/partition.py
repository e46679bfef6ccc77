"""Partition strategies for the distributed D-iteration (paper §2.5), the
port's copy of ``repro.core.partition``.

* :func:`uniform_partition` — Ω_k are contiguous equal-node-count ranges
  (§2.5.1, "Uniform partition").
* :func:`cb_partition` — Cost-Balanced: contiguous ranges with
  (approximately) equal out-degree sums Σ#out = L/K (§2.5.1).
* :class:`DynamicController` — the paper's contribution (§2.5.2): a
  measurement-driven controller that equalizes per-PID convergence
  *slopes* by moving load units from the slowest PID to the fastest one,
  with a cooldown to damp oscillation.  It is deliberately ignorant of
  the graph structure: load balance emerges from the *observed* residual
  decay rates alone.  The :mod:`repro_torch.balance` control plane wraps
  it as ``SlopeEMAPolicy``; the simulator executes its decisions as node
  moves (:func:`apply_move`), the engine as bucket moves.

The node sets are int64 torch tensors on the device the caller names
(the simulator's); the boundaries are computed on the host, as the
reference computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "uniform_partition",
    "cb_partition",
    "partition_bounds_to_sets",
    "apply_move",
    "DynamicControllerConfig",
    "DynamicController",
    "MoveInstruction",
    "slope_ema_update",
]


# ------------------------------------------------------------------------------
# Static partitions (§2.5.1)
# ------------------------------------------------------------------------------
def uniform_partition(n: int, k: int, device="cpu") -> List[torch.Tensor]:
    """Ω_1 = {0..N/K-1}, Ω_2 = {N/K..2N/K-1}, ... (paper uses 1-based ids)."""
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    return partition_bounds_to_sets(bounds, device)


def cb_partition(out_deg: np.ndarray, k: int,
                 device="cpu") -> List[torch.Tensor]:
    """Cost-Balanced contiguous partition: Σ_{n∈Ω_k} #out_n ≈ L/K.

    Greedy boundary placement on the cumulative out-degree curve: boundary
    ω_{k+1} is the first node where the running cost reaches k·L/K.
    Dangling nodes (deg 0) still cost one op to absorb, so they are counted
    with weight 1 (cost model §2.3/§2.4).
    """
    n = out_deg.shape[0]
    cost = np.maximum(np.asarray(out_deg).astype(np.float64), 1.0)
    cum = np.concatenate([[0.0], np.cumsum(cost)])
    total = cum[-1]
    bounds = [0]
    for i in range(1, k):
        target = total * i / k
        # first index where cumulative cost >= target, at least 1 past previous
        b = int(np.searchsorted(cum, target))
        b = min(max(b, min(bounds[-1] + 1, n)), max(n - (k - i), 0))
        b = max(b, bounds[-1])  # k > n: allow empty tail sets
        bounds.append(b)
    bounds.append(n)
    return partition_bounds_to_sets(bounds, device)


def partition_bounds_to_sets(bounds: Sequence[int],
                             device="cpu") -> List[torch.Tensor]:
    return [
        torch.arange(int(bounds[i]), int(bounds[i + 1]), dtype=torch.int64,
                     device=device)
        for i in range(len(bounds) - 1)
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


def apply_move(
    sets: List[torch.Tensor], move: MoveInstruction
) -> Tuple[List[torch.Tensor], int]:
    """Move the *tail* nodes of Ω_src to Ω_dst (boundary nodes for contiguous
    partitions — matches the boundary evolution in paper Fig 4/9).

    Returns the new sets and the number of nodes actually moved (≤ n_move,
    never emptying the source).  Reassignment cost is charged by the caller
    (§2.4: count_active += nodes modified, to both PIDs).
    """
    src_set = sets[move.src]
    n_move = min(move.n_move, max(src_set.numel() - 1, 0))
    if n_move == 0:
        return sets, 0
    moved, kept = src_set[-n_move:], src_set[:-n_move]
    new_sets = list(sets)
    new_sets[move.src] = kept
    # keep destination sorted so its cyclic sweep order stays deterministic
    new_sets[move.dst] = torch.sort(torch.cat([sets[move.dst], moved])).values
    return new_sets, int(n_move)
