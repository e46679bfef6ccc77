"""The serving layer's resilience pieces (the port of
``repro.resilience``):

* :mod:`~repro_torch.resilience.admission` — per-request admission
  control: NaN / negative / zero-mass personalization vectors and stale
  or malformed graph deltas are rejected (and quarantined) per request
  without killing the server.
* :class:`DegradationLadder` / :class:`Rung` — graceful degradation driven
  by a :class:`~repro_torch.balance.LoadSignal` through
  :class:`~repro_torch.balance.PressurePolicy`: overload sheds to cheaper
  serving targets (defer graph updates, looser targets, round caps) and
  recovers stepwise.
* :class:`EventLog` — the seq-numbered, JSON-able record of what the
  serving layer did.
* :class:`SupervisedSession` — the supervisor: per-request deadlines and
  op budgets, restore-newest-valid + exponential-backoff retry on
  :class:`~repro_torch.chaos.ChaosKill` and host I/O faults (a CUDA or
  kernel error is not retried: it propagates), and a
  :class:`CircuitBreaker` that escalates repeated failures to
  restore-then-rescale.  :class:`RetryPolicy` draws the reference's
  backoff schedule, float for float.
"""
from .admission import (Quarantine, RequestRejected, validate_graph_update,
                        validate_rhs)
from .degrade import DEFAULT_RUNGS, SERVE_RUNGS, DegradationLadder, Rung
from .events import Event, EventLog
from .retry import CircuitBreaker, RetryPolicy
from .supervisor import RequestOutcome, SupervisedSession

__all__ = [
    "CircuitBreaker",
    "DEFAULT_RUNGS",
    "DegradationLadder",
    "Event",
    "EventLog",
    "Quarantine",
    "RequestOutcome",
    "RequestRejected",
    "RetryPolicy",
    "Rung",
    "SERVE_RUNGS",
    "SupervisedSession",
    "validate_graph_update",
    "validate_rhs",
]
