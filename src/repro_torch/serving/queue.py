"""Request admission queue for the continuous-batching scheduler (the
port's copy of ``repro.serving.queue``).

A deliberately boring FIFO: the interesting decisions (admission
validation, lane placement, shedding) live in
:class:`~repro_torch.serving.scheduler.Scheduler`.  What the queue *does* own
is the bookkeeping the pressure signal and the benchmark read —
depth, peak depth, and the waiting time of the oldest entry — so
backlog is observable without walking the deque.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Optional

import numpy as np

__all__ = ["Request", "RequestQueue"]


@dataclasses.dataclass
class Request:
    """One rank (personalized-PageRank) request.

    ``cluster`` names the personalization family the RHS drifts around
    — the :class:`~repro_torch.serving.pool.SessionPool` key component that
    makes warm H-state reuse possible across requests of the same
    family.  ``arrival_t`` is scheduler-clock seconds (virtual under
    the benchmark's deterministic clock); ``until`` optionally loosens
    the per-request target_error (the degradation ladder may loosen it
    further).
    """

    request_id: int
    b: np.ndarray
    cluster: int = 0
    arrival_t: float = 0.0
    until: Optional[float] = None
    kind: str = "rank"


class RequestQueue:
    """FIFO of validated :class:`Request`\\ s with backlog accounting."""

    def __init__(self):
        self._q: Deque[Request] = collections.deque()
        self.enqueued = 0
        self.dequeued = 0
        self.depth_peak = 0

    def push(self, req: Request) -> None:
        self._q.append(req)
        self.enqueued += 1
        self.depth_peak = max(self.depth_peak, len(self._q))

    def pop(self) -> Request:
        req = self._q.popleft()
        self.dequeued += 1
        return req

    def push_front(self, req: Request) -> None:
        """Return a popped-but-unplaced request to the head (lane
        saturation race) without recounting it."""
        self._q.appendleft(req)
        self.dequeued -= 1

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    @property
    def depth(self) -> int:
        return len(self._q)

    def oldest_wait(self, now: float) -> float:
        """Seconds the head request has been waiting (0 when empty)."""
        return max(now - self._q[0].arrival_t, 0.0) if self._q else 0.0

    def to_jsonable(self) -> Dict:
        return {"depth": self.depth, "depth_peak": self.depth_peak,
                "enqueued": self.enqueued, "dequeued": self.dequeued}

    def __len__(self) -> int:
        return len(self._q)
