"""The serving layer's resilience pieces (the port's copy of the part of
``repro.resilience`` the continuous-batching scheduler needs):

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

The supervisor (``SupervisedSession``) and its retry policy come with the
checkpoint and chaos slice.
"""
from .admission import (Quarantine, RequestRejected, validate_graph_update,
                        validate_rhs)
from .degrade import DEFAULT_RUNGS, SERVE_RUNGS, DegradationLadder, Rung
from .events import Event, EventLog

__all__ = [
    "DEFAULT_RUNGS",
    "DegradationLadder",
    "Event",
    "EventLog",
    "Quarantine",
    "RequestRejected",
    "Rung",
    "SERVE_RUNGS",
    "validate_graph_update",
    "validate_rhs",
]
