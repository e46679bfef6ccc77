"""Pluggable rebalancing policies (the port's copy of
``repro.balance.policies``).

All policies implement the :class:`Rebalancer` protocol —
``propose(LoadSignal) -> list[MovePlan]`` once per control step plus
``reset_worker(k)`` for elastic events — and are deliberately ignorant
of what a load unit is (node, bucket, expert shard, device slice).

* :class:`SlopeEMAPolicy` — the paper's §2.5.2 controller, verbatim: it
  wraps :class:`repro_torch.core.partition.DynamicController`.
* :class:`CostRefreshPolicy` — periodic Cost-Balanced re-split (§2.5.1
  made dynamic): every ``period`` steps, recompute cost-proportional
  target sizes from the EMA'd signal and plan the greedy set of moves
  toward them.
* :class:`HysteresisPolicy` — slope-EMA with a deadband (the trigger
  must persist ``patience`` consecutive steps) and multi-move batching
  (pairs slowest↔fastest extremes in one shot).
* :class:`PressurePolicy` — overload controller for the serving tier:
  EMAs a ``latency`` signal's absolute pressure and emits ±1 rung
  recommendations for the degradation ladder (DESIGN.md §10) instead of
  MovePlans — structurally it is still a Rebalancer (``propose``
  returns ``[]``), so it plugs into the same control loop.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable

import numpy as np

from ..core.partition import (
    DynamicController,
    DynamicControllerConfig,
    slope_ema_update,
)
from .plan import MovePlan
from .signals import LoadSignal

__all__ = [
    "Rebalancer",
    "SlopeEMAPolicy",
    "CostRefreshPolicy",
    "HysteresisPolicy",
    "PressurePolicy",
    "make_rebalancer",
    "POLICY_NAMES",
]


@runtime_checkable
class Rebalancer(Protocol):
    """Policy protocol: one ``propose`` per control step."""

    def propose(self, signal: LoadSignal) -> List[MovePlan]:
        ...

    def reset_worker(self, k: int) -> None:
        """Re-seed worker ``k``'s state after an external event
        (elastic join/leave, checkpoint restore)."""
        ...


class SlopeEMAPolicy:
    """Paper §2.5.2, exact — a thin adapter over
    :class:`~repro_torch.core.partition.DynamicController`.

    The controller is fed ``signal.values``/``signal.sizes`` exactly as
    the historical inline call sites did, so the move sequence (and
    therefore the simulator's ``cost_iterations``) is unchanged by the
    control-plane refactor.
    """

    def __init__(self, k: int, target_error: float, eta: float = 0.5,
                 z: int = 10, max_move_frac: float = 0.1,
                 unit: str = "node"):
        self.ctl = DynamicController(
            DynamicControllerConfig(
                k=k, target_error=target_error, eta=eta, z=z,
                max_move_frac=max_move_frac,
            )
        )
        self.unit = unit

    @property
    def n_moves(self) -> int:
        return self.ctl.n_moves

    def propose(self, signal: LoadSignal) -> List[MovePlan]:
        mi = self.ctl.update(signal.values, signal.sizes)
        if mi is None:
            return []
        return [MovePlan.from_instruction(mi, kind=self.unit)]

    def reset_worker(self, k: int) -> None:
        self.ctl.reset_pid(k)


class CostRefreshPolicy:
    """Periodic CB re-split from observed costs (§2.5.1 made dynamic).

    Every ``period`` control steps: EMA the signal, derive per-unit
    costs ``c_k = ema_k / |Ω_k|``, compute cost-proportional target
    sizes ``target_k ∝ 1/c_k``, and emit the greedy batch of moves from
    over-target to under-target workers.  Fires only when the max/mean
    cost imbalance exceeds ``tol`` (deadband against churn).
    """

    def __init__(self, k: int, period: int = 50, eta: float = 0.5,
                 tol: float = 0.2, max_move_frac: float = 0.25,
                 unit: str = "node"):
        self.k = k
        self.period = period
        self.eta = eta
        self.tol = tol
        self.max_move_frac = max_move_frac
        self.unit = unit
        self.ema: Optional[np.ndarray] = None
        self.n_moves = 0
        self._since = 0

    def propose(self, signal: LoadSignal) -> List[MovePlan]:
        v = np.maximum(signal.values, 1e-12)
        self.ema = v if self.ema is None else (
            self.ema * (1.0 - self.eta) + v * self.eta)
        self._since += 1
        if self._since < self.period:
            return []
        self._since = 0
        sizes = signal.sizes.astype(np.float64)
        live = sizes > 0
        if live.sum() < 2:
            return []
        if self.ema.max() <= (1.0 + self.tol) * self.ema.mean():
            return []
        per_unit = np.where(live, self.ema / np.maximum(sizes, 1.0), np.inf)
        inv = np.where(live, 1.0 / np.maximum(per_unit, 1e-12), 0.0)
        if inv.sum() <= 0:
            return []
        target = sizes.sum() * inv / inv.sum()
        excess = np.where(live, sizes - target, 0.0)
        plans: List[MovePlan] = []
        for _ in range(self.k):
            i = int(np.argmax(excess))
            j = int(np.argmin(excess))
            units = int(min(excess[i], -excess[j],
                            max(sizes[i] - 1, 0) * self.max_move_frac))
            if i == j or units < 1:
                break
            plans.append(MovePlan(src=i, dst=j, units=units,
                                  kind=self.unit))
            excess[i] -= units
            excess[j] += units
            sizes[i] -= units
            sizes[j] += units
        self.n_moves += len(plans)
        return plans

    def reset_worker(self, k: int) -> None:
        if self.ema is not None:
            self.ema[k] = float(self.ema.mean())
        self._since = 0


class HysteresisPolicy:
    """Slope-EMA with deadband + multi-move batching.

    Same slope update as §2.5.2::

        slope_k := slope_k·(1−η) − log10(value_k + ε')·η

    but the 50% trigger must hold for ``patience`` consecutive steps
    (deadband against transient spikes), the required gap is widened by
    ``deadband`` decades, and on firing up to ``max_moves`` extreme
    pairs (slowest↔fastest, 2nd-slowest↔2nd-fastest, …) move in one
    batch, each under the paper's 10% cap and the Z cooldown.
    """

    def __init__(self, k: int, target_error: float, eta: float = 0.5,
                 z: int = 10, max_move_frac: float = 0.1,
                 deadband: float = 0.1, patience: int = 3,
                 max_moves: int = 2, unit: str = "node"):
        # the paper-exact constants/update come from core.partition so a
        # fix there propagates to every slope policy
        cfg = DynamicControllerConfig(k=k, target_error=target_error,
                                      eta=eta, z=z,
                                      max_move_frac=max_move_frac)
        self.k = k
        self.eta = eta
        self.z = z
        self.max_move_frac = max_move_frac
        self.deadband = deadband
        self.patience = patience
        self.max_moves = max_moves
        self.unit = unit
        self.eps_c = cfg.eps_c
        self.trigger_log10 = cfg.trigger_log10
        self.slope = np.zeros(k, dtype=np.float64)
        self.cooldown = np.zeros(k, dtype=np.int64)
        self.streak = 0
        self.n_moves = 0

    def propose(self, signal: LoadSignal) -> List[MovePlan]:
        self.slope = slope_ema_update(self.slope, signal.values,
                                      self.eta, self.eps_c)
        self.cooldown = np.maximum(self.cooldown - 1, 0)
        eligible = np.nonzero(self.cooldown == 0)[0]
        if eligible.size < 2:
            self.streak = 0
            return []
        order = eligible[np.argsort(self.slope[eligible])]
        s_min = self.slope[order[0]]
        s_max = self.slope[order[-1]]
        if not (s_min < s_max + self.trigger_log10 - self.deadband):
            self.streak = 0
            return []
        self.streak += 1
        if self.streak < self.patience:
            return []
        self.streak = 0
        plans: List[MovePlan] = []
        n_pairs = min(self.max_moves, order.size // 2)
        for p in range(n_pairs):
            i_min = int(order[p])
            i_max = int(order[-1 - p])
            lo, hi = self.slope[i_min], self.slope[i_max]
            if p > 0 and not (lo < hi + self.trigger_log10 - self.deadband):
                break  # inner pairs must independently satisfy the rule
            ratio = (lo + 1.0) / (hi + 1.0) if (hi + 1.0) != 0 else 1.0
            frac = min(max(ratio, 0.0), self.max_move_frac)
            units = int(signal.sizes[i_min] * frac)
            if units < 1:
                continue
            self.cooldown[i_min] = self.z
            self.cooldown[i_max] = self.z
            plans.append(MovePlan(src=i_min, dst=i_max, units=units,
                                  kind=self.unit))
        self.n_moves += len(plans)
        return plans

    def reset_worker(self, k: int) -> None:
        self.slope[k] = 0.0
        self.cooldown[k] = self.z
        self.streak = 0


class PressurePolicy:
    """Hysteretic overload controller driving the degradation ladder.

    Same deadband idiom as :class:`HysteresisPolicy`, but the decision
    space is vertical (shed work / restore quality) instead of
    horizontal (move load between workers): the EMA'd worst-worker
    pressure must sit above ``hi`` for ``patience`` consecutive steps to
    recommend stepping DOWN one rung (+1), or below ``lo`` for
    ``patience`` steps to recommend stepping back UP (−1), with a
    ``z``-step cooldown after every decision so the ladder never
    oscillates faster than the signal can respond.

    ``update(signal) -> int`` is the primary API (the ladder calls it
    once per served request); ``propose`` is the Rebalancer-protocol
    shim — it forwards to ``update``, stashes the decision in
    ``last_delta``, and returns no MovePlans.
    """

    def __init__(self, k: int = 1, target_error: float = 0.0,
                 eta: float = 0.3, z: int = 4, hi: float = 1.0,
                 lo: float = 0.5, patience: int = 2,
                 unit: str = "request", **_ignored):
        if lo >= hi:
            raise ValueError(f"need lo < hi, got lo={lo} hi={hi}")
        self.k = k
        self.eta = eta
        self.z = z
        self.hi = hi
        self.lo = lo
        self.patience = patience
        self.unit = unit
        self.ema: Optional[float] = None
        self.last_delta = 0
        self.n_moves = 0
        self._hi_streak = 0
        self._lo_streak = 0
        self._cooldown = 0

    def update(self, signal: LoadSignal) -> int:
        """One control step: returns −1 (relieve), 0 (hold), +1 (shed)."""
        p = float(signal.values.max()) if signal.values.size else 0.0
        self.ema = p if self.ema is None else (
            self.ema * (1.0 - self.eta) + p * self.eta)
        if self._cooldown > 0:
            self._cooldown -= 1
        if self.ema > self.hi:
            self._hi_streak += 1
            self._lo_streak = 0
        elif self.ema < self.lo:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = 0
            self._lo_streak = 0
        if self._cooldown > 0:
            return 0
        if self._hi_streak >= self.patience:
            self._hi_streak = 0
            self._cooldown = self.z
            self.n_moves += 1
            return 1
        if self._lo_streak >= self.patience:
            self._lo_streak = 0
            self._cooldown = self.z
            self.n_moves += 1
            return -1
        return 0

    def propose(self, signal: LoadSignal) -> List[MovePlan]:
        self.last_delta = self.update(signal)
        return []

    def reset_worker(self, k: int) -> None:
        self.ema = None
        self.last_delta = 0
        self._hi_streak = 0
        self._lo_streak = 0
        self._cooldown = self.z


POLICY_NAMES = ("slope_ema", "cost_refresh", "hysteresis", "pressure")


def make_rebalancer(name: str, k: int, target_error: float,
                    eta: float = 0.5, z: int = 10,
                    unit: str = "node", **kw) -> Rebalancer:
    """Config-string dispatch used by SimulatorConfig/EngineConfig."""
    if name == "slope_ema":
        return SlopeEMAPolicy(k=k, target_error=target_error, eta=eta,
                              z=z, unit=unit, **kw)
    if name == "cost_refresh":
        return CostRefreshPolicy(k=k, eta=eta, unit=unit, **kw)
    if name == "hysteresis":
        return HysteresisPolicy(k=k, target_error=target_error, eta=eta,
                                z=z, unit=unit, **kw)
    if name == "pressure":
        return PressurePolicy(k=k, target_error=target_error, eta=eta,
                              z=z, unit=unit, **kw)
    raise ValueError(
        f"unknown rebalancing policy {name!r}; expected one of "
        f"{POLICY_NAMES}"
    )
