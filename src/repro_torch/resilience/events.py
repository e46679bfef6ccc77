"""Seq-numbered event log: the serving layer's observable behavior (the
port's copy of ``repro.resilience.events``).

Every decision the serving layer makes — request served, retry fired,
checkpoint restored, ladder rung engaged/relieved, poison quarantined —
lands here as one :class:`Event`.  The soak harness asserts recovery
and degradation behavior FROM this log (not from internal state), so
the log is the contract: if it is not recorded here, it did not
observably happen.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

__all__ = ["Event", "EventLog"]


@dataclasses.dataclass(frozen=True)
class Event:
    """One supervisor decision: ``seq`` is the total order, ``t`` the
    log's clock (wall seconds by default, virtual seconds under the
    soak's deterministic clock)."""

    seq: int
    t: float
    kind: str
    detail: Dict

    def to_jsonable(self) -> Dict:
        return {"seq": self.seq, "t": round(float(self.t), 6),
                "kind": self.kind, **self.detail}


class EventLog:
    """Append-only, seq-numbered; ``clock`` is injectable so the soak
    harness records deterministic virtual timestamps."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._events: List[Event] = []
        self._seq = 0
        self._clock = clock if clock is not None else time.monotonic

    def record(self, kind: str, **detail) -> Event:
        ev = Event(seq=self._seq, t=float(self._clock()), kind=kind,
                   detail=detail)
        self._seq += 1
        self._events.append(ev)
        return ev

    def of_kind(self, *kinds: str) -> List[Event]:
        return [e for e in self._events if e.kind in kinds]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def to_jsonable(self) -> List[Dict]:
        return [e.to_jsonable() for e in self._events]

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self._events)
