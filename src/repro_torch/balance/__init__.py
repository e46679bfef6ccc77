"""The rebalancing control plane (DESIGN.md §5), the port's copy of
``repro.balance`` as far as the engine needs it.

* :class:`~repro_torch.balance.signals.LoadSignal` — the one measurement
  container (per-PID residuals, per-PID edge-op counts, graph churn).
* :class:`~repro_torch.balance.policies.Rebalancer` — the policy
  protocol: ``propose(LoadSignal) -> [MovePlan]`` + ``reset_worker(k)``.
  :class:`SlopeEMAPolicy` (paper §2.5.2 exact), :class:`CostRefreshPolicy`,
  :class:`HysteresisPolicy` and :class:`PressurePolicy`.
* :class:`~repro_torch.balance.plan.MovePlan` — "move ``units`` from
  worker ``src`` to worker ``dst``", granularity-agnostic.
* :class:`~repro_torch.balance.executors.BucketMoveExecutor` — turns a
  bucket MovePlan into a row permutation of the K-PID engine.
"""
from .plan import MovePlan
from .signals import LoadSignal
from .policies import (
    CostRefreshPolicy,
    HysteresisPolicy,
    PressurePolicy,
    Rebalancer,
    SlopeEMAPolicy,
    make_rebalancer,
)
from .executors import BucketMoveExecutor

__all__ = [
    "LoadSignal",
    "MovePlan",
    "Rebalancer",
    "SlopeEMAPolicy",
    "CostRefreshPolicy",
    "HysteresisPolicy",
    "PressurePolicy",
    "make_rebalancer",
    "BucketMoveExecutor",
]
