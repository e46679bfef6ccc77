"""Injection + recovery: wiring a :class:`ChaosPlan` into live solves
(the port of ``repro.chaos.inject``).

Two consumers (DESIGN.md §8):

* the **simulator** takes the plan directly —
  ``DistributedSimulator.run(chaos=plan)`` fires straggler/kill/rescale
  events in its step loop (virtual PIDs, so every event is behavioral:
  budgets shrink, Ω sets hand over, the width changes);
* a **session** takes a :class:`SessionInjector` —
  ``SolverSession.run(chaos=injector)`` calls :meth:`SessionInjector.
  before_grain` once per grain.  ``kill`` raises :class:`ChaosKill`
  (a machine loss is a crash, not a callback); :class:`ChaosRunner`
  implements the production recovery flow around it: periodic
  checkpoints, restore-newest-valid, optional rescale to the surviving
  width, and the recovery-cost accounting of :meth:`ChaosRunner.
  measure`.

Grain/round bookkeeping: the injector counts grains *globally* across
restore attempts (``global_grain``), so a plan keeps firing at the
right absolute position even after a kill truncated one ``run`` loop.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .plan import ChaosEvent, ChaosPlan

__all__ = ["ChaosKill", "SessionInjector", "ChaosRunner",
           "tear_checkpoint"]


class ChaosKill(RuntimeError):
    """PID ``pid`` was lost at grain ``round`` — the in-flight solve
    dies with it; recovery is restore + rescale (DESIGN.md §8)."""

    def __init__(self, pid: int, round: int):
        super().__init__(f"chaos: pid {pid} killed at grain {round}")
        self.pid = pid
        self.round = round


def tear_checkpoint(path: str) -> None:
    """Simulate a write that tore *after* the atomic commit: the step
    directory exists with a complete manifest, but the H leaf's bytes
    are garbage.  Only the §2.2 invariant check can catch this — which
    is exactly what ``SolverSession.restore`` does."""
    leaf = os.path.join(path, "arr_00002.npy")  # h (b, f, h, t key order)
    arr = np.load(leaf)
    np.save(leaf, np.zeros_like(arr))


class SessionInjector:
    """Fires plan events into ``SolverSession.run`` grain boundaries."""

    def __init__(self, plan: ChaosPlan, ckpt_dir: Optional[str] = None):
        self.plan = plan
        self.ckpt_dir = ckpt_dir
        self.global_grain = 0
        self._cursor = 0
        self.log: List[Tuple[int, str]] = []
        # edge pushes charged before a churn_burst re-seeded the session
        # (update_graph resets the phase counters): consumers that sum
        # total work add this back (ChaosRunner does)
        self.absorbed_ops = 0

    def bind(self, session) -> None:
        """Validate the plan against the session's backend up front."""
        from ..api.session import _EngineDriver

        if isinstance(session._driver, _EngineDriver):
            kinds = ("straggler", "kill", "rescale", "churn_burst",
                     "checkpoint_crash")
            k = session._driver.cfg.k
        else:
            # single-process frontier drivers have no pid axis
            kinds = ("kill", "churn_burst", "checkpoint_crash")
            k = 1
        # only the not-yet-fired tail: a bind after recovery (restore +
        # rescale) must not re-judge events that already fired against
        # the pre-disruption width
        remaining = self.plan.events[self._cursor:]
        if (self.ckpt_dir is None
                and any(e.kind == "checkpoint_crash" for e in remaining)):
            raise ValueError(
                "plan schedules checkpoint_crash but the injector has no "
                "ckpt_dir"
            )
        ChaosPlan(remaining, seed=self.plan.seed).validate(k, kinds=kinds)

    def before_grain(self, session) -> None:
        """Advance the GLOBAL grain counter (it spans restore attempts —
        a kill truncates one ``run`` loop, not the plan's timeline) and
        fire every due event via the shared ``ChaosPlan.fire_due``."""
        self.global_grain += 1
        due, self._cursor = self.plan.fire_due(self._cursor,
                                               self.global_grain)
        for ev in due:
            self._fire(session, ev)

    def _fire(self, session, ev: ChaosEvent) -> None:
        self.log.append((self.global_grain, ev.kind))
        if ev.kind == "straggler":
            session._driver.note_straggler(ev.pid, ev.slowdown)
        elif ev.kind == "kill":
            raise ChaosKill(ev.pid, self.global_grain)
        elif ev.kind == "rescale":
            session.rescale(ev.k_new)
        elif ev.kind == "churn_burst":
            from ..graph import rotation_churn

            n_rot = max(1, int(ev.frac * session.problem.n_edges) // 2)
            delta = rotation_churn(session.problem.graph, n_rot,
                                   seed=ev.seed)
            # update_graph rebuilds the driver (phase counters reset to
            # zero): bank the pushes charged so far first
            self.absorbed_ops += session.n_ops
            session.update_graph(delta)
        elif ev.kind == "checkpoint_crash":
            path = session.checkpoint(self.ckpt_dir)
            tear_checkpoint(path)


class ChaosRunner:
    """One fault-tolerant solve under a plan, with the recovery loop.

    The production flow in miniature: checkpoint every
    ``checkpoint_every`` grains; on :class:`ChaosKill` restore the
    newest checkpoint that passes the invariant check and — when the
    backend has a pid axis and ``rescale_on_kill`` — shrink to the
    surviving width before resuming.  ``measure`` also runs an
    undisturbed twin and reports the recovery cost in §2.3 edge
    pushes (the chaos bench's row).
    """

    def __init__(self, problem, method: str, plan: ChaosPlan,
                 ckpt_dir: str, options=None, checkpoint_every: int = 1,
                 rescale_on_kill: bool = True, max_recoveries: int = 8):
        self.problem = problem
        self.method = method
        self.plan = plan
        self.ckpt_dir = ckpt_dir
        self.options = options
        self.checkpoint_every = checkpoint_every
        self.rescale_on_kill = rescale_on_kill
        self.max_recoveries = max_recoveries
        self.kills: List[ChaosKill] = []
        self.injector = SessionInjector(plan, ckpt_dir=ckpt_dir)

    def run(self, until: Optional[float] = None):
        """Returns ``(session, disturbed_ops, wasted_ops)``.

        ``disturbed_ops`` sums ``SolverSession.lifetime_ops`` per
        attempt — THE one §2.3 accounting rule: every edge push charged
        across all attempts, including work a kill destroyed and pushes
        a churn re-seed banked (``update_graph`` folds them into the
        session's lifetime totals, so nothing is counted twice and
        nothing leaks).  ``wasted_ops`` is the part that died
        un-checkpointed (attempt lifetime minus the restored
        checkpoint's recorded lifetime).
        """
        from ..api.session import SolverSession

        session = SolverSession(self.problem, method=self.method,
                                options=self.options)
        # base checkpoint of the seeded state: a kill can fire before
        # the first periodic checkpoint, and recovery needs SOMETHING
        # valid to restore (cold restart = restoring the seed)
        session.checkpoint(self.ckpt_dir)
        total_ops = 0
        wasted_ops = 0
        while True:
            try:
                grains = 0
                for _rep in session.run(until=until, chaos=self.injector):
                    grains += 1
                    if grains % self.checkpoint_every == 0:
                        session.checkpoint(self.ckpt_dir)
                return (session, total_ops + session.lifetime_ops,
                        wasted_ops)
            except ChaosKill as kill:
                self.kills.append(kill)
                if len(self.kills) > self.max_recoveries:
                    raise
                lost = session.lifetime_ops
                total_ops += lost
                k_before = getattr(getattr(session._driver, "cfg", None),
                                   "k", 1)
                try:
                    session = SolverSession.restore(
                        self.ckpt_dir, session.problem,
                        method=self.method, options=self.options)
                    wasted_ops += max(
                        0, lost - (session.restored_from["lifetime_ops"]
                                   or 0))
                except (FileNotFoundError, ValueError):
                    # every step rejected (e.g. all checkpoints pre-date
                    # a churn_burst): production falls back to a COLD
                    # restart of the current problem, it does not die
                    session = SolverSession(session.problem,
                                            method=self.method,
                                            options=self.options)
                    session.checkpoint(self.ckpt_dir)  # fresh base
                    wasted_ops += lost
                if (self.rescale_on_kill and k_before > 1
                        and session.method.startswith("engine")):
                    session.rescale(k_before - 1)

    def measure(self, until: Optional[float] = None) -> dict:
        """Disturbed vs undisturbed twin: the recovery-cost row."""
        from ..api.session import SolverSession

        ref_session = SolverSession(self.problem, method=self.method,
                                    options=self.options)
        ref = ref_session.solve(until=until)
        session, disturbed_ops, wasted = self.run(until=until)
        rep = session.solve(until=until)  # already converged: no-op read
        undisturbed = ref_session.lifetime_ops  # == ref.n_ops: one phase
        return {
            "undisturbed_ops": int(undisturbed),
            "disturbed_ops": int(disturbed_ops),
            "overhead_ops": int(disturbed_ops - undisturbed),
            "overhead_frac": float(
                (disturbed_ops - undisturbed) / max(undisturbed, 1)),
            "wasted_ops": int(wasted),
            "recovered_ops": int(disturbed_ops - wasted),
            "final_attempt_ops": int(session.lifetime_ops),
            "kills": len(self.kills),
            "x_err_l1": float(np.abs(rep.x - ref.x).sum()),
            "converged": bool(rep.converged and ref.converged),
            "chaos_log": list(self.injector.log),
        }
