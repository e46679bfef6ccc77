"""Per-granularity executors: MovePlan -> actual state mutation (the
port's copy of the node and bucket executors of
``repro.balance.executors``).

Policies decide; executors act.  Each executor handles exactly one unit
kind and reports how many units actually moved (0 when the plan is
infeasible — the source would be emptied, or no free landing rows
exist), so policies and consumers can account moves truthfully.

* :class:`NodeMoveExecutor` — node-granular, drives the K-PID simulator:
  boundary-node reassignment via
  :func:`repro_torch.core.partition.apply_move`, owner-map update, the
  §2.4 reassignment-cost charging (moved nodes billed to BOTH PIDs), and
  the receiver-threshold re-seed.
* :class:`BucketMoveExecutor` — bucket-granular, drives the K-PID engine:
  plans a row permutation onto the destination PID's inert headroom rows
  and applies it to the engine's state.

The advisory executor (the runtime's) comes with the slice that consumes
it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.partition import apply_move
from .plan import MovePlan

__all__ = ["NodeMoveExecutor", "BucketMoveExecutor"]


class NodeMoveExecutor:
    """Node moves inside :class:`repro_torch.core.simulator.
    DistributedSimulator`.

    Owns the full §2.5.2 move side-effects:

    * tail-boundary reassignment (:func:`apply_move`, never emptying the
      source set),
    * owner-map update for the moved nodes (on the simulator's device),
    * §2.4 cost charging — the number of re-affected nodes is billed to
      BOTH PIDs' ``count_active`` and pushed into their debt (freeze
      artifact),
    * receiver threshold re-seed — the destination may now hold hotter
      fluid than its current T.
    """

    kind = "node"

    def __init__(self, sim):
        self.sim = sim

    def apply(self, plan: MovePlan) -> int:
        sim = self.sim
        new_sets, moved = apply_move(sim.sets, plan.to_instruction())
        if moved == 0:
            return 0
        sim.sets = new_sets
        sim.n_moves += 1
        sim.owner[sim.sets[plan.dst]] = plan.dst
        # §2.4: charge the number of re-affected nodes to both PIDs
        sim.count_active[plan.src] += moved
        sim.count_active[plan.dst] += moved
        sim.debt[plan.src] -= moved
        sim.debt[plan.dst] -= moved
        # thresholds: receiving PID may now hold hotter fluid than its T
        s_dst = sim.sets[plan.dst]
        if s_dst.numel():
            mx = float((sim.f[s_dst].abs() * sim.weights[s_dst]).max())
            if mx > 0:
                sim.t_k[plan.dst] = min(sim.t_k[plan.dst], mx * 1.0001)
        return moved


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
