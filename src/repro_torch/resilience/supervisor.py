"""The supervisor: one self-healing serving loop per session (the port of
``repro.resilience.supervisor``).

:class:`SupervisedSession` wraps a :class:`repro_torch.SolverSession` and
upgrades its request-scoped guarantees to service-scoped ones
(DESIGN.md §10):

* **fault absorption** — transient faults (:class:`~repro_torch.chaos.
  ChaosKill`, host I/O errors, torn restores) trigger
  restore-newest-valid + exponential-backoff retry; because the
  supervisor checkpoints at *every* request boundary, a retried
  request replays the identical trajectory the undisturbed stream
  would have taken (determinism is the exactness mechanism, not tight
  tolerances);
* **escalation** — ``trip_after`` consecutive failures trip the
  :class:`CircuitBreaker`: restore, then *rescale to the surviving
  width* (engine backends), then resume;
* **graceful degradation** — every served request feeds a ``latency``
  :class:`~repro_torch.balance.LoadSignal` (virtual clock: §2.3 edge pushes
  over ``op_rate``, inflated by live stragglers) to the
  :class:`DegradationLadder`; overload walks down to cheaper serving
  targets and recovery walks back up, one rung per decision;
* **deadlines / budgets** — a request that exhausts its op budget or
  deadline is served *degraded* (current H, reported residual), never
  dropped;
* **admission** — poison requests (NaN/negative/zero-mass B, stale or
  malformed graph deltas) are rejected per request into the
  :class:`Quarantine`; the session never sees them.

Everything observable lands in the :class:`EventLog` — the soak
harness asserts recovery and ladder behavior from the log alone.

One deliberate difference from the reference: it retries every
``RuntimeError``, and on the card a kernel's launch or build failure and
a CUDA fault are plain ``RuntimeError`` too — retried, they would be
hidden behind a restore and the request served anyway.  The port retries
only what the reference means to retry (:class:`~repro_torch.chaos.
ChaosKill` and ``OSError``; restore's own errors are handled inside the
recovery); any other error propagates on the first attempt.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from ..balance import LoadSignal
from ..chaos.inject import ChaosKill
from ..checkpoint import list_steps
from .admission import (Quarantine, RequestRejected, validate_graph_update,
                        validate_rhs)
from .degrade import DegradationLadder
from .events import EventLog
from .retry import CircuitBreaker, RetryPolicy

__all__ = ["RequestOutcome", "SupervisedSession"]

# faults worth retrying: a PID died (ChaosKill), the host's I/O failed.
# Not RuntimeError at large, as the reference has it: a kernel's or
# torch's CUDA error is one, and must surface, not be served around.
# Poison and programming errors (RequestRejected, TypeError, ValueError)
# fail fast instead of burning the retry budget
_TRANSIENT = (ChaosKill, OSError)


@dataclasses.dataclass
class RequestOutcome:
    """What happened to one request, for the caller and the bench."""

    request_id: object
    kind: str                       # "rank" | "update"
    ok: bool
    rejected: bool = False
    reject_reason: Optional[str] = None
    deferred: bool = False
    x: Optional[np.ndarray] = None
    residual: float = float("nan")
    converged: bool = False
    degraded: bool = False          # served off-nominal (rung > 0 or cut)
    budget_exhausted: bool = False
    deadline_exceeded: bool = False
    rung: str = "nominal"
    ops: int = 0
    rounds: int = 0
    attempts: int = 1
    restores: int = 0
    latency_s: float = 0.0          # virtual (deterministic) latency
    wall_s: float = 0.0


class SupervisedSession:
    """Supervised serving over one solver session (see module doc).

    ``op_rate`` (edge pushes / virtual second) drives the deterministic
    latency clock: service time = attempt pushes / op_rate × the worst
    live straggler factor, plus any backoff the request waited through.
    ``sleep`` is injectable so soaks never wall-sleep through backoff.
    """

    def __init__(self, problem, method: str = "engine:chunk",
                 options=None, *, ckpt_dir: str,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 ladder: Optional[DegradationLadder] = None,
                 deadline_s: Optional[float] = None,
                 op_budget: Optional[int] = None,
                 op_rate: float = 2e6, queue_cap: int = 8,
                 defer_cap: int = 8, keep_checkpoints: int = 4,
                 log: Optional[EventLog] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        from ..api.session import SolverSession

        self.ckpt_dir = ckpt_dir
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.ladder = ladder if ladder is not None else DegradationLadder()
        self.deadline_s = deadline_s
        self.op_budget = op_budget
        self.op_rate = float(op_rate)
        self.queue_cap = queue_cap
        self.defer_cap = defer_cap
        self.keep_checkpoints = keep_checkpoints
        self.vt = 0.0  # virtual clock (seconds)
        self.log = log if log is not None else EventLog(
            clock=lambda: self.vt)
        self._sleep = sleep if sleep is not None else time.sleep
        self.quarantine = Quarantine()
        self.session = SolverSession(problem, method=method,
                                     options=options)
        self.method = method
        self.options = self.session.options
        self._deferred: List = []       # queued GraphDeltas, FIFO
        self._slowdowns: dict = {}      # pid -> live straggler factor
        self.total_ops = 0              # §2.3, across all attempts
        self.wasted_ops = 0             # died un-checkpointed
        self.restores = 0
        self.served = 0
        # recovery base: a fault during the very first request needs a
        # valid step to restore (the seeded state IS one)
        self.session.checkpoint(self.ckpt_dir)
        self._prune_checkpoints()
        self.log.record("start", method=method, n=problem.n,
                        n_edges=problem.n_edges)

    # ------------------------------------------------------------------ #
    # serving
    # ------------------------------------------------------------------ #
    def serve_rank(self, b, request_id=None, chaos=None,
                   queue_depth: int = 0,
                   want_x: bool = True) -> RequestOutcome:
        """Serve one ranking request end to end (see module doc).

        ``chaos`` is a :class:`~repro_torch.chaos.SessionInjector` scheduled
        by the caller's trace; the SAME injector is passed to every
        retry attempt, so a kill fires once at its plan position and
        the retry resumes past it."""
        t0 = time.perf_counter()
        try:
            b = validate_rhs(b, self.session.problem.n)
        except RequestRejected as e:
            return self._reject(request_id, "rank", e, t0)
        backoff_s = 0.0
        req_ops = 0
        restores = 0
        attempt = 1
        while True:
            ops0 = self.session.lifetime_ops
            try:
                self.session.warm_start(b)
                applied = self.ladder.apply(self.session)
                if applied:
                    self.log.record("ladder_override", **applied)
                rung = self.ladder.rung
                scale = rung.target_scale
                until = (None if scale == 1.0
                         else self.session.problem.target_error * scale)
                cut = self._drain(until, rung.round_cap, chaos, ops0)
                break
            except _TRANSIENT as e:
                attempt_ops = self.session.lifetime_ops - ops0
                req_ops += attempt_ops
                self.total_ops += attempt_ops
                self.log.record("fault", request_id=request_id,
                                attempt=attempt, error=type(e).__name__,
                                detail=str(e)[:120])
                tripped = self.breaker.record_failure()
                if attempt >= self.retry.max_attempts:
                    self.log.record("request_failed",
                                    request_id=request_id,
                                    attempts=attempt)
                    return RequestOutcome(
                        request_id=request_id, kind="rank", ok=False,
                        attempts=attempt, restores=restores,
                        ops=req_ops, wall_s=time.perf_counter() - t0)
                restores += 1
                self._recover(escalate=tripped)
                delay = self.retry.delay_s(attempt)
                self._sleep(delay)
                self.vt += delay
                backoff_s += delay
                attempt += 1
        attempt_ops = self.session.lifetime_ops - ops0
        req_ops += attempt_ops
        self.total_ops += attempt_ops
        self.breaker.record_success()
        self.session.checkpoint(self.ckpt_dir)
        self._prune_checkpoints()
        tol = (until if until is not None
               else self.session.problem.target_error
               ) * self.session.problem.eps
        residual = self.session.residual
        converged = residual <= tol
        service_s = (attempt_ops / self.op_rate) * self._straggler_factor()
        latency_s = service_s + backoff_s
        self.vt += service_s
        self.served += 1
        rung_name = self.ladder.rung.name
        degraded = (self.ladder.engaged or cut["budget"] or cut["deadline"]
                    or not converged)
        self.log.record("request_served", request_id=request_id,
                        rung=rung_name, ops=attempt_ops,
                        attempts=attempt, restores=restores,
                        latency_s=round(latency_s, 6),
                        converged=converged, degraded=degraded)
        out = RequestOutcome(
            request_id=request_id, kind="rank", ok=True,
            x=self.session.x if want_x else None,
            residual=residual, converged=converged, degraded=degraded,
            budget_exhausted=cut["budget"],
            deadline_exceeded=cut["deadline"], rung=rung_name,
            ops=req_ops, rounds=self.session.n_rounds, attempts=attempt,
            restores=restores, latency_s=latency_s,
            wall_s=time.perf_counter() - t0)
        self._observe_pressure(latency_s, queue_depth)
        return out

    def serve_update(self, delta, store_version: Optional[int] = None,
                     request_id=None) -> RequestOutcome:
        """Serve one graph-update request: admit, then apply or defer.

        Under a ``defer_updates`` rung the delta queues (the stream
        serves a *stale but real* graph version — exact against the
        effective schedule); the queue flushes on recovery or when it
        exceeds ``defer_cap`` (bounded staleness)."""
        t0 = time.perf_counter()
        deferring = self.ladder.rung.defer_updates
        try:
            # membership is only decidable when nothing is queued ahead
            # of this delta (see admission.validate_graph_update)
            validate_graph_update(
                self.session.problem.graph, delta,
                store_version=store_version,
                queued=len(self._deferred),
                check_membership=not (deferring or self._deferred))
        except RequestRejected as e:
            return self._reject(request_id, "update", e, t0)
        if deferring:
            self._deferred.append(delta)
            self.log.record("update_deferred", request_id=request_id,
                            queued=len(self._deferred))
            if len(self._deferred) > self.defer_cap:
                self.flush_deferred(reason="defer-cap")
            return RequestOutcome(
                request_id=request_id, kind="update", ok=True,
                deferred=True, rung=self.ladder.rung.name,
                wall_s=time.perf_counter() - t0)
        ops = self._apply_update(delta, request_id)
        return RequestOutcome(
            request_id=request_id, kind="update", ok=True, ops=ops,
            rung=self.ladder.rung.name, wall_s=time.perf_counter() - t0)

    def flush_deferred(self, reason: str = "recovered") -> int:
        """Apply every queued delta in arrival order; returns count."""
        n = len(self._deferred)
        if n == 0:
            return 0
        self.log.record("update_flush", count=n, reason=reason)
        while self._deferred:
            delta = self._deferred.pop(0)
            self._apply_update(delta, request_id=None)
        return n

    @property
    def deferred_updates(self) -> int:
        return len(self._deferred)

    # ------------------------------------------------------------------ #
    # elasticity / chaos surface
    # ------------------------------------------------------------------ #
    def rescale(self, k_new: int) -> None:
        """Planned elastic event (capacity change), checkpointed."""
        drains = self.session.rescale(k_new)
        self.session.checkpoint(self.ckpt_dir)
        self._prune_checkpoints()
        self.log.record("rescale", k_new=k_new, drains=len(drains),
                        planned=True)

    def note_straggler(self, pid: int, slowdown: float) -> None:
        """A device slowed down (or healed at ``slowdown=1.0``): feeds
        both the engine's balance signal and the virtual clock."""
        if slowdown <= 1.0:
            self._slowdowns.pop(pid, None)
        else:
            self._slowdowns[pid] = float(slowdown)
        note = getattr(self.session._driver, "note_straggler", None)
        if note is not None:
            note(pid, slowdown)
        self.log.record("straggler", pid=pid, slowdown=slowdown)

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _drain(self, until, round_cap, chaos, ops0) -> dict:
        """Grain loop with budget/deadline cuts: a request that runs
        out of budget is SERVED with whatever H holds (degraded),
        never dropped."""
        cut = {"budget": False, "deadline": False}
        for _rep in self.session.run(until=until, max_rounds=round_cap,
                                     chaos=chaos):
            attempt_ops = self.session.lifetime_ops - ops0
            if (self.op_budget is not None
                    and attempt_ops >= self.op_budget):
                cut["budget"] = True
                break
            if (self.deadline_s is not None
                    and (attempt_ops / self.op_rate)
                    * self._straggler_factor() >= self.deadline_s):
                cut["deadline"] = True
                break
        return cut

    def _apply_update(self, delta, request_id) -> int:
        """Apply + drain one delta, fault-tolerantly.

        The checkpoint right after ``update_graph`` is load-bearing: a
        fault during the drain must restore the *post-update* state
        (the store already advanced, so pre-update checkpoints are
        version-stale and would force a cold restart); re-draining
        from the restored undrained state replays the identical
        schedule — exactness via determinism, same as serve_rank.
        Draining to the nominal target here keeps the served state
        converged, matching a reference that replays
        ``update_graph`` + ``solve`` at each effective apply point."""
        req_ops = 0
        applied = False
        attempt = 1
        while True:
            ops0 = self.session.lifetime_ops
            try:
                if not applied:
                    try:
                        self.session.update_graph(delta)
                    except (TypeError, ValueError) as e:
                        # not transient: the delta conflicts with the
                        # state it finally applies to (possible for a
                        # deferred delta admitted without a membership
                        # check).  update_graph rolled back — quarantine
                        # the delta and keep serving.
                        self.quarantine.record(request_id,
                                               "conflict-at-apply")
                        self.log.record("update_conflict",
                                        request_id=request_id,
                                        detail=str(e)[:120])
                        return 0
                    applied = True
                    self.session.checkpoint(self.ckpt_dir)
                    self._prune_checkpoints()
                for _rep in self.session.run():
                    pass
                break
            except _TRANSIENT as e:
                req_ops += self.session.lifetime_ops - ops0
                self.total_ops += self.session.lifetime_ops - ops0
                self.log.record("fault", request_id=request_id,
                                attempt=attempt, error=type(e).__name__,
                                detail=str(e)[:120])
                tripped = self.breaker.record_failure()
                if attempt >= self.retry.max_attempts:
                    raise
                self._recover(escalate=tripped)
                delay = self.retry.delay_s(attempt)
                self._sleep(delay)
                self.vt += delay
                attempt += 1
        ops = req_ops + self.session.lifetime_ops - ops0
        self.total_ops += self.session.lifetime_ops - ops0
        self.breaker.record_success()
        self.session.checkpoint(self.ckpt_dir)
        self._prune_checkpoints()
        self.log.record("update_applied", request_id=request_id,
                        n_changes=delta.n_changes,
                        store_version=self.session.problem.store_version)
        return ops

    def _recover(self, escalate: bool) -> None:
        """Restore-newest-valid; on escalation also shrink the pid
        axis to the surviving width (the breaker's theory: a device is
        sick, stop scheduling onto it)."""
        from ..api.session import SolverSession

        lost = self.session.lifetime_ops
        k_before = getattr(getattr(self.session, "_driver", None),
                           "cfg", None)
        k_before = getattr(k_before, "k", 1)
        try:
            self.session = SolverSession.restore(
                self.ckpt_dir, self.session.problem, method=self.method,
                options=self.options)
            info = self.session.restored_from
            self.wasted_ops += max(
                0, lost - int(info.get("lifetime_ops") or 0))
            self.log.record("restore", step=info["step"],
                            rejected=len(info["rejected"]),
                            escalated=escalate)
        except (FileNotFoundError, ValueError) as e:
            # nothing valid on disk: production comes up cold, not dead
            self.session = SolverSession(self.session.problem,
                                         method=self.method,
                                         options=self.options)
            self.session.checkpoint(self.ckpt_dir)
            self.wasted_ops += lost
            self.log.record("cold_restart", detail=str(e)[:120],
                            escalated=escalate)
        self.restores += 1
        if escalate:
            self.log.record("breaker_trip",
                            failures=self.breaker.consecutive_failures)
            if k_before > 1 and self.method.startswith("engine"):
                drains = self.session.rescale(k_before - 1)
                self.session.checkpoint(self.ckpt_dir)
                self._prune_checkpoints()
                self.log.record("rescale", k_new=k_before - 1,
                                drains=len(drains), planned=False)
            self.breaker.reset()

    def _straggler_factor(self) -> float:
        return max([1.0] + list(self._slowdowns.values()))

    def _observe_pressure(self, latency_s: float, queue_depth: int):
        """Feed the ladder; flush deferred updates once it climbs back
        to a rung that applies updates again."""
        if self.deadline_s is None:
            return
        sig = LoadSignal.from_latency(latency_s, self.deadline_s,
                                      queue_depth=queue_depth,
                                      queue_cap=self.queue_cap,
                                      step=self.served)
        was_deferring = self.ladder.rung.defer_updates
        executed = self.ladder.observe(sig)
        if executed > 0:
            self.log.record("degrade", rung=self.ladder.rung.name,
                            pressure=round(float(sig.values[0]), 4))
        elif executed < 0:
            self.log.record("recover", rung=self.ladder.rung.name,
                            pressure=round(float(sig.values[0]), 4))
        if (was_deferring and not self.ladder.rung.defer_updates
                and self._deferred):
            self.flush_deferred(reason="recovered")

    def _reject(self, request_id, kind: str, e: RequestRejected,
                t0: float) -> RequestOutcome:
        self.quarantine.record(request_id, e.reason)
        self.log.record("request_rejected", request_id=request_id,
                        request_kind=kind, reason=e.reason,
                        detail=str(e)[:120])
        return RequestOutcome(
            request_id=request_id, kind=kind, ok=False, rejected=True,
            reject_reason=e.reason, rung=self.ladder.rung.name,
            wall_s=time.perf_counter() - t0)

    def _prune_checkpoints(self) -> None:
        import os
        import shutil

        steps = list_steps(self.ckpt_dir)
        for s in steps[:-self.keep_checkpoints]:
            shutil.rmtree(
                os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                ignore_errors=True)
