"""Per-granularity executors: MovePlan -> actual state mutation (the
port's copy of the bucket executor of ``repro.balance.executors``).

Policies decide; executors act.  Each executor handles exactly one unit
kind and reports how many units actually moved (0 when the plan is
infeasible — the source would be emptied, or no free landing rows
exist), so policies and consumers can account moves truthfully.

* :class:`BucketMoveExecutor` — bucket-granular, drives the K-PID engine:
  plans a row permutation onto the destination PID's inert headroom rows
  and applies it to the engine's state.

The node-granular executor (the simulator's) and the advisory one (the
runtime's) come with the slices that consume them.
"""
from __future__ import annotations

import numpy as np
import torch

from .plan import MovePlan

__all__ = ["BucketMoveExecutor"]


class BucketMoveExecutor:
    """Bucket-row moves inside :class:`repro_torch.core.distributed.
    DistributedEngine`.

    Owns the mutable solve-time layout state: the stable-bucket → row
    map, the operands that move with their rows (selection weights and
    per-slot edge counts, ``[R, S]`` each), the engine's push table for
    the current map, and the :class:`EngineState`.  ``apply`` plans a
    permutation of up to ``plan.units`` real buckets from the source
    PID's tail onto the destination PID's inert rows and runs the
    engine's repartition.  The tile pool and the edge lists stay in
    their home rows; the push table follows the map.
    """

    kind = "bucket"

    def __init__(self, engine, state):
        self.engine = engine
        self.state = state
        self.row_of_bucket = np.array(engine.a.pos_of_bucket, dtype=np.int64)
        self.w = torch.as_tensor(engine.a.w, device=engine.device).to(
            engine.cfg.dtype)
        self.slot_deg = engine.slot_deg0
        self.table = engine.push_table(self.row_of_bucket)

    def chunk_operands(self) -> tuple:
        """Operands in the order :meth:`DistributedEngine.run_chunk`
        expects."""
        return (self.w, self.slot_deg, self.table)

    def sizes(self) -> np.ndarray:
        """Real (non-inert) buckets currently owned per PID."""
        cfg = self.engine.cfg
        n_real = cfg.k * (cfg.buckets_per_dev - cfg.headroom)
        dev_of_bucket = self.row_of_bucket // cfg.buckets_per_dev
        return np.bincount(dev_of_bucket[:n_real], minlength=cfg.k)

    def apply(self, plan: MovePlan, keep_min: int = 1) -> int:
        """Execute ``plan``.  ``keep_min=1`` (rebalancing) never empties
        the source PID."""
        eng = self.engine
        perm, new_map, moved = eng._plan_move(
            self.row_of_bucket, plan.src, plan.dst, plan.units,
            keep_min=keep_min)
        if moved == 0:
            return 0
        self.row_of_bucket = new_map
        self.state, (self.w, self.slot_deg), self.table = eng.repartition(
            self.state, perm, new_map, (self.w, self.slot_deg))
        return moved
