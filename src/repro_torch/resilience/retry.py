"""Retry/backoff and circuit-breaking primitives (the port of
``repro.resilience.retry``).

Deliberately deterministic: the jitter is a hash of ``(seed, attempt)``
so a soak replay retries on the identical schedule, and the breaker is
count-based (consecutive failures / explicit reset) rather than
wall-clock-based, so tests never sleep to observe a state change.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RetryPolicy", "CircuitBreaker"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    Attempt ``a`` (1-based; attempt 1 is the first try, so the first
    *delay* precedes attempt 2) sleeps::

        min(base · mult^(a−1), max) · (1 + jitter·u),   u ~ U[−1, 1)

    where ``u`` is drawn from ``PCG64(seed ⊕ a)`` — same seed, same
    schedule, every replay.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got "
                             f"{self.jitter}")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (>= 1)."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        base = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)
        u = np.random.Generator(
            np.random.PCG64(self.seed ^ (attempt * 0x9E3779B9))
        ).uniform(-1.0, 1.0)
        return float(base * (1.0 + self.jitter * u))


class CircuitBreaker:
    """Consecutive-failure trip wire for the supervisor's escalation.

    Plain retries handle isolated faults; ``trip_after`` *consecutive*
    failures mean the environment itself is sick (a device that keeps
    dying), and the supervisor escalates to its heavy recovery —
    restore + rescale to the surviving width — then calls
    :meth:`reset`.  ``record_success`` closes the streak.
    """

    def __init__(self, trip_after: int = 3):
        if trip_after < 1:
            raise ValueError(f"trip_after must be >= 1, got {trip_after}")
        self.trip_after = trip_after
        self.consecutive_failures = 0
        self.trips = 0

    @property
    def tripped(self) -> bool:
        return self.consecutive_failures >= self.trip_after

    def record_failure(self) -> bool:
        """Count one failure; returns the post-update tripped state."""
        self.consecutive_failures += 1
        return self.tripped

    def record_success(self) -> None:
        self.consecutive_failures = 0

    def reset(self) -> None:
        """Acknowledge the escalated recovery: re-close the circuit."""
        if self.tripped:
            self.trips += 1
        self.consecutive_failures = 0
