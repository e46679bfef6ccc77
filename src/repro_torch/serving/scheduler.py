"""The continuous-batching scheduler: queue → lanes → pool, under
pressure control (the port of ``repro.serving.scheduler``).

One :meth:`Scheduler.step` is the whole serving policy, in order:

1. **arrivals** — open-loop requests whose ``arrival_t`` has passed
   move from the future list into the FIFO;
2. **graph updates** — pending deltas flush at a *drain barrier*
   (stop admitting, let lanes finish, swap P, bump ``store_version``)
   unless the active rung defers them (``defer_cap`` bounds staleness);
3. **admission** — queued requests fill free lanes; the
   :class:`~repro_torch.serving.pool.SessionPool` is consulted keyed by
   ``(store_version, cluster)`` and a hit seeds the lane's H on device
   (the §2.2 warm start), a miss seeds H=0;
4. **micro-step** — up to ``rounds_per_tick`` batched rounds (one
   launch of K3's lane form each) advance every active lane; the virtual
   clock charges the executed rounds and §2.3 edge pushes;
5. **retirement** — converged (or round-capped) lanes serve their
   response, bank their H back into the pool, and free the slot;
6. **pressure** — a ``queue-depth`` :class:`~repro_torch.balance.LoadSignal`
   feeds the :class:`~repro_torch.resilience.DegradationLadder`: sustained
   backlog walks down rungs (defer updates → loosen target → round
   caps) and *every* request is still served — overload sheds quality,
   never requests (``dropped`` is structurally zero).

Determinism: with ``arrival_t`` supplied by the caller and the default
virtual clock (``vt``, advanced by ``round_overhead_s`` a round and
``1/op_rate`` an edge push), a serving run is a pure function of
(problem, request stream, knobs) — same schedule, same §2.3 op counts,
same event log, on the card and on the CPU, and the reference's.  The
host wall is not part of it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..balance import LoadSignal, PressurePolicy
from ..resilience import (SERVE_RUNGS, DegradationLadder, EventLog,
                          Quarantine, RequestRejected,
                          validate_graph_update, validate_rhs)

from .batcher import ContinuousBatcher
from .pool import SessionPool
from .queue import Request, RequestQueue

__all__ = ["Scheduler", "ServedRequest"]


@dataclasses.dataclass
class ServedRequest:
    """One completed rank request, for the caller and the bench."""

    request_id: int
    cluster: int
    x: np.ndarray
    residual: float
    converged: bool
    degraded: bool              # round-capped before the certificate
    rung: str
    until_eff: float            # target_error actually served
    pool_hit: bool
    ops: int
    rounds: int
    wait_s: float               # arrival -> lane placement
    latency_s: float            # arrival -> response


class Scheduler:
    """Continuous-batching rank server over one
    :class:`repro_torch.Problem`, on ``device`` (the card unless the
    caller asks for the CPU).

    ``submit`` validates at the door (poison is quarantined and raises
    :class:`~repro_torch.resilience.RequestRejected` — the stream
    continues);
    ``step`` runs one scheduling round; ``run_until_idle`` drives the
    loop until every accepted request is served.  Completed requests
    accumulate in ``results`` in retirement order.
    """

    def __init__(self, problem, *, max_lanes: int = 64,
                 min_lanes: int = 4, rounds_per_tick: int = 32,
                 pool_capacity: int = 32, gamma: float = 1.2,
                 ladder: Optional[DegradationLadder] = None,
                 deadline_s: float = 1.0, queue_cap: int = 64,
                 op_rate: float = 2e6, round_overhead_s: float = 2e-4,
                 defer_cap: int = 16, log: Optional[EventLog] = None,
                 device="cuda"):
        self.problem = problem
        self.batcher = ContinuousBatcher(problem, gamma=gamma,
                                         max_lanes=max_lanes,
                                         min_lanes=min_lanes, device=device)
        self.pool = SessionPool(capacity=pool_capacity)
        self.queue = RequestQueue()
        self.ladder = ladder if ladder is not None else DegradationLadder(
            rungs=SERVE_RUNGS, policy=PressurePolicy())
        self.deadline_s = float(deadline_s)
        self.queue_cap = int(queue_cap)
        self.rounds_per_tick = int(rounds_per_tick)
        self.op_rate = float(op_rate)
        self.round_overhead_s = float(round_overhead_s)
        self.defer_cap = int(defer_cap)
        self.vt = 0.0
        self.log = log if log is not None else EventLog(
            clock=lambda: self.vt)
        self.quarantine = Quarantine()
        self.results: List[ServedRequest] = []
        self.dropped = 0            # structurally zero; reported anyway
        self.deferred_updates: List[object] = []
        self.applied_updates = 0
        self.update_conflicts = 0
        self._future: List[Request] = []   # arrival_t-sorted backlog
        self._draining = False
        self._next_id = 0
        self._steps = 0
        self._latencies: List[float] = []
        self.pool_hits_served = 0

    # ------------------------------------------------------------------ #
    # intake
    # ------------------------------------------------------------------ #
    @property
    def now(self) -> float:
        return self.vt

    def submit(self, b, cluster: int = 0,
               arrival_t: Optional[float] = None,
               request_id: Optional[int] = None,
               until: Optional[float] = None) -> int:
        """Validate and accept one rank request.  Raises
        :class:`RequestRejected` on poison (after quarantining it);
        the scheduler survives and keeps serving."""
        rid = request_id if request_id is not None else self._next_id
        self._next_id = max(self._next_id, rid) + 1
        try:
            b = validate_rhs(b, self.problem.n)
        except RequestRejected as e:
            self.quarantine.record(rid, e.reason)
            self.log.record("request_rejected", request_id=rid,
                            reason=e.reason)
            raise
        t_arr = float(arrival_t) if arrival_t is not None else self.vt
        req = Request(request_id=rid, b=b, cluster=int(cluster),
                      arrival_t=t_arr, until=until)
        if t_arr > self.vt:
            self._future.append(req)
            self._future.sort(key=lambda r: (r.arrival_t, r.request_id))
        else:
            self.queue.push(req)
        return rid

    def submit_update(self, delta,
                      store_version: Optional[int] = None) -> None:
        """Validate and queue one graph delta.  Applied at the next
        drain barrier (immediately if the rung allows; deferred while
        the ladder says so, bounded by ``defer_cap``).  Raises
        :class:`RequestRejected` on poison (after quarantining)."""
        store = self.problem.graph
        try:
            validate_graph_update(
                store, delta, store_version=store_version,
                queued=len(self.deferred_updates),
                check_membership=not self.deferred_updates)
        except RequestRejected as e:
            self.quarantine.record(f"update@{len(self.deferred_updates)}",
                                   e.reason)
            self.log.record("request_rejected", request_id="update",
                            reason=e.reason)
            raise
        self.deferred_updates.append(delta)

    # ------------------------------------------------------------------ #
    # the scheduling loop
    # ------------------------------------------------------------------ #
    def _admit_due_arrivals(self) -> None:
        due = 0
        for req in self._future:
            if req.arrival_t > self.vt:
                break
            self.queue.push(req)
            due += 1
        if due:
            del self._future[:due]

    def _flush_updates_at_barrier(self) -> None:
        """Drain-then-apply: stop admissions once a flush is wanted,
        swap P only when no fluid is in flight."""
        rung = self.ladder.rung
        want_flush = self.deferred_updates and (
            not rung.defer_updates
            or len(self.deferred_updates) >= self.defer_cap)
        if want_flush:
            self._draining = True
        if not self._draining:
            return
        if self.batcher.occupied:
            return  # lanes still draining toward the barrier
        store = self.problem.graph
        for delta in self.deferred_updates:
            try:
                store.apply_delta(delta)
                self.applied_updates += 1
            except Exception as e:  # conflict after deferral: quarantine
                self.update_conflicts += 1
                self.quarantine.record("update", "update-conflict")
                self.log.record("update_conflict",
                                detail=str(e)[:120])
        self.deferred_updates = []
        self.problem = self.problem.with_graph(store)
        self.batcher.graph_switched(self.problem)
        # stale pool entries can never hit again (the key embeds the
        # version) — invalidation just frees their device buffers now
        freed = self.pool.invalidate(
            keep_version=self.problem.store_version)
        self.log.record("update_applied",
                        version=self.problem.store_version,
                        pool_freed=freed)
        self._draining = False

    def _admit(self) -> None:
        rung = self.ladder.rung
        while self.queue.depth and not self._draining:
            if not self.batcher.has_capacity:
                break
            req = self.queue.pop()
            te = (req.until if req.until is not None
                  else self.problem.target_error)
            until_eff = te * rung.target_scale
            tol = until_eff * self.problem.eps
            entry = self.pool.get(self.problem.store_version, req.cluster)
            lane = self.batcher.admit(
                req, now=self.vt, tol=tol, until_eff=until_eff,
                h_seed=None if entry is None else entry.h,
                round_cap=rung.round_cap, rung=rung.name)
            if lane is None:  # saturated race; requeue at the head
                self.queue.push_front(req)
                break
            self.log.record("admit", request_id=req.request_id,
                            lane=lane, pool_hit=entry is not None,
                            rung=rung.name)

    def _retire(self, retired) -> None:
        for r in retired:
            req = r.info.request
            latency = self.vt - req.arrival_t
            self.pool.put(self.problem.store_version, req.cluster,
                          r.h_dev, ops_banked=r.ops)
            served = ServedRequest(
                request_id=req.request_id, cluster=req.cluster, x=r.x,
                residual=r.residual,
                converged=not r.degraded,
                degraded=r.degraded or r.info.rung != "nominal",
                rung=r.info.rung, until_eff=r.info.until_eff,
                pool_hit=r.info.pool_hit, ops=r.ops, rounds=r.rounds,
                wait_s=r.info.admitted_t - req.arrival_t,
                latency_s=latency)
            self.results.append(served)
            self._latencies.append(latency)
            if r.info.pool_hit:
                self.pool_hits_served += 1
            self.log.record("request_served",
                            request_id=req.request_id,
                            latency=round(latency, 6), ops=r.ops,
                            degraded=served.degraded, rung=r.info.rung)

    def _observe_pressure(self) -> None:
        signal = LoadSignal.from_queue(
            oldest_wait_s=self.queue.oldest_wait(self.vt),
            deadline_s=self.deadline_s,
            queue_depth=self.queue.depth + len(self._future),
            queue_cap=self.queue_cap, step=self._steps)
        before = self.ladder.rung.name
        executed = self.ladder.observe(signal)
        if executed > 0:
            self.log.record("degrade", rung=self.ladder.rung.name,
                            pressure=float(signal.values[0]))
        elif executed < 0:
            self.log.record("recover", rung=self.ladder.rung.name,
                            from_rung=before,
                            pressure=float(signal.values[0]))

    def step(self) -> int:
        """One scheduling round; returns the number of requests served
        this step."""
        self._steps += 1
        self._admit_due_arrivals()
        if (self.deferred_updates and not self._future
                and not self.queue.depth and not self.batcher.occupied):
            # nothing left to serve: a defer rung must not starve the
            # update stream forever
            self._draining = True
        self._flush_updates_at_barrier()
        self._admit()
        report = self.batcher.micro(self.rounds_per_tick)
        self.vt += (report.rounds_run * self.round_overhead_s
                    + report.ops_delta / self.op_rate)
        self._retire(report.retired)
        if (report.occupied == 0 and not self.queue.depth
                and self._future):
            # idle gap in the open-loop schedule: jump to next arrival
            self.vt = max(self.vt, self._future[0].arrival_t)
        self._observe_pressure()
        return len(report.retired)

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive ``step`` until every accepted request (and pending
        update) is finished.  Returns requests served."""
        served = 0
        for _ in range(max_steps):
            if not (self._future or self.queue.depth
                    or self.batcher.occupied or self.deferred_updates):
                break
            served += self.step()
        else:
            raise RuntimeError(
                f"run_until_idle did not converge in {max_steps} steps "
                f"(queue={self.queue.depth}, lanes={self.batcher.occupied})")
        return served

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def latency_percentiles(self) -> Dict[str, float]:
        if not self._latencies:
            return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
        arr = np.asarray(self._latencies)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "mean": float(arr.mean())}

    def to_jsonable(self) -> Dict:
        return {
            "steps": self._steps,
            "served": len(self.results),
            "dropped": self.dropped,
            "pool": self.pool.to_jsonable(),
            "queue": self.queue.to_jsonable(),
            "batcher": self.batcher.to_jsonable(),
            "quarantine": self.quarantine.to_jsonable(),
            "applied_updates": self.applied_updates,
            "update_conflicts": self.update_conflicts,
            "rung": self.ladder.rung.name,
            "latency": self.latency_percentiles(),
            "events": self.log.counts(),
        }
