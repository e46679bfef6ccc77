"""Deterministic chaos plans: the event taxonomy of DESIGN.md §8 (the
port's copy of ``repro.chaos.plan``).

A :class:`ChaosPlan` is a *seeded, replayable* schedule of disruptions
against a running solve — the elasticity/fault-tolerance counterpart of
the paper's dynamic partition story (the PID set itself changes while
the solve is in flight, the regime of the asynchronous companion
arXiv:1202.6168).  Five event kinds:

====================  =====================================================
``straggler(pid, slowdown)``  the PID computes ``slowdown``× slower from
                              this round on (simulator: budget cut;
                              engine: the control plane's load signal is
                              scaled — the controller sees what a real
                              straggler would make it see)
``kill(pid, round)``          the PID is lost: the simulator reassigns
                              its Ω to survivors; a session raises
                              (recovery = restore + rescale, the
                              production flow)
``rescale(k_new, round)``     grow/shrink the PID set mid-solve
                              (``DistributedEngine.rescale`` /
                              ``DistributedSimulator.rescale``)
``churn_burst(frac, round)``  a burst of link rotations (``frac``·L
                              edges) through ``SolverSession.
                              update_graph`` (sessions only)
``checkpoint_crash(round)``   a checkpoint write that tears mid-flight:
                              the newest step is written then corrupted,
                              so restore MUST reject it and fall back
====================  =====================================================

Events are pinned to a *round* — the consumer's native grain (simulator
time step / session run grain) — so a plan replays bit-identically from
a failure log: ``ChaosPlan.random(seed=...)`` is pure in its arguments
and every derived randomness (churn seeds) is folded from the plan seed.

The port's consumer so far is the simulator (``SIM_KINDS``:
``DistributedSimulator.run(chaos=plan)``); the session-level injector and
the ``churn_burst`` / ``checkpoint_crash`` consumers come with the
checkpoint and resilience slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["ChaosEvent", "ChaosPlan", "EVENT_KINDS"]

EVENT_KINDS = ("straggler", "kill", "rescale", "churn_burst",
               "checkpoint_crash")

# which kinds each consumer can honor (validated up front, not mid-run)
SIM_KINDS = ("straggler", "kill", "rescale")
SESSION_KINDS = EVENT_KINDS


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One disruption, pinned to a round of the consumer's native grain."""

    kind: str
    round: int
    pid: Optional[int] = None  # straggler / kill target
    slowdown: Optional[float] = None  # straggler factor (> 1)
    k_new: Optional[int] = None  # rescale width
    frac: Optional[float] = None  # churn_burst: fraction of L rotated
    seed: int = 0  # derived randomness (churn edge picks)

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown chaos event kind {self.kind!r}; expected one of "
                f"{EVENT_KINDS}"
            )
        if self.round < 0:
            raise ValueError(f"round must be >= 0, got {self.round}")
        if self.kind == "straggler":
            if self.pid is None or self.slowdown is None:
                raise ValueError("straggler needs pid and slowdown")
            if self.slowdown <= 1.0:
                raise ValueError(
                    f"slowdown must be > 1 (got {self.slowdown}); use no "
                    "event for a healthy PID"
                )
        elif self.kind == "kill":
            if self.pid is None:
                raise ValueError("kill needs pid")
        elif self.kind == "rescale":
            if self.k_new is None or self.k_new < 1:
                raise ValueError(f"rescale needs k_new >= 1, got "
                                 f"{self.k_new}")
        elif self.kind == "churn_burst":
            if self.frac is None or not (0.0 < self.frac <= 0.5):
                raise ValueError(
                    f"churn_burst needs frac in (0, 0.5], got {self.frac}"
                )


class ChaosPlan:
    """An ordered, seeded batch of :class:`ChaosEvent`\\ s.

    Construct explicitly (builder methods chain) or via :meth:`random`.
    ``at(round)`` yields the events pinned to that round; ``validate``
    checks the plan against a consumer (k width, supported kinds)
    *before* the solve starts, so an impossible plan fails loudly
    instead of mid-flight.
    """

    def __init__(self, events: Optional[List[ChaosEvent]] = None,
                 seed: int = 0):
        self.seed = int(seed)
        self.events: List[ChaosEvent] = sorted(
            events or [], key=lambda e: (e.round, EVENT_KINDS.index(e.kind))
        )

    # ---- builders ---------------------------------------------------------
    def _add(self, ev: ChaosEvent) -> "ChaosPlan":
        self.events.append(ev)
        self.events.sort(key=lambda e: (e.round, EVENT_KINDS.index(e.kind)))
        return self

    def straggler(self, pid: int, slowdown: float,
                  round: int = 0) -> "ChaosPlan":
        return self._add(ChaosEvent("straggler", round, pid=pid,
                                    slowdown=float(slowdown)))

    def kill(self, pid: int, round: int) -> "ChaosPlan":
        return self._add(ChaosEvent("kill", round, pid=pid))

    def rescale(self, k_new: int, round: int) -> "ChaosPlan":
        return self._add(ChaosEvent("rescale", round, k_new=int(k_new)))

    def churn_burst(self, frac: float, round: int,
                    seed: Optional[int] = None) -> "ChaosPlan":
        s = self.seed + 7919 * round if seed is None else seed
        return self._add(ChaosEvent("churn_burst", round, frac=float(frac),
                                    seed=int(s)))

    def checkpoint_crash(self, round: int) -> "ChaosPlan":
        return self._add(ChaosEvent("checkpoint_crash", round))

    # ---- generation -------------------------------------------------------
    @staticmethod
    def random(seed: int, k: int, rounds: int, n_events: int = 3,
               kinds: Tuple[str, ...] = SIM_KINDS) -> "ChaosPlan":
        """A deterministic plan: same arguments ⇒ same events, always.

        Rescale targets stay in [max(1, k//2), k] so a random plan never
        asks for more PIDs than the consumer started with; kill targets
        avoid PID 0 so at least one worker always survives.
        """
        rng = np.random.default_rng(seed)
        plan = ChaosPlan(seed=seed)
        for i in range(n_events):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            if kind == "kill" and k < 2:
                kind = "straggler"  # a 1-PID world has nobody to die
            rnd = int(rng.integers(1, max(rounds, 2)))
            if kind == "straggler":
                plan.straggler(int(rng.integers(0, k)),
                               float(2 ** rng.integers(1, 4)), round=rnd)
            elif kind == "kill":
                plan.kill(int(rng.integers(1, max(k, 2))), round=rnd)
            elif kind == "rescale":
                plan.rescale(int(rng.integers(max(1, k // 2), k + 1)),
                             round=rnd)
            elif kind == "churn_burst":
                plan.churn_burst(float(rng.uniform(0.002, 0.05)), round=rnd,
                                 seed=int(rng.integers(0, 2**31)))
            else:
                plan.checkpoint_crash(round=rnd)
        return plan

    # ---- consumption ------------------------------------------------------
    def at(self, round: int) -> List[ChaosEvent]:
        return [e for e in self.events if e.round == round]

    def fire_due(self, cursor: int,
                 now: int) -> Tuple[List[ChaosEvent], int]:
        """Events not yet consumed (``>= cursor``) whose round has
        arrived (``<= now``), plus the advanced cursor — THE shared
        firing rule of the simulator step loop and the session
        injector (events are kept sorted by round)."""
        due = []
        while (cursor < len(self.events)
               and self.events[cursor].round <= now):
            due.append(self.events[cursor])
            cursor += 1
        return due, cursor

    def validate(self, k: int, kinds: Tuple[str, ...] = SESSION_KINDS
                 ) -> "ChaosPlan":
        """Check every event against the consumer's width and abilities.

        ``k`` is tracked through rescale events so a straggler/kill
        scheduled after a shrink is validated against the *post-shrink*
        width.
        """
        width = k
        for ev in self.events:
            if ev.kind not in kinds:
                raise ValueError(
                    f"event {ev.kind!r} unsupported here (supported: "
                    f"{kinds})"
                )
            if ev.kind in ("straggler", "kill") and ev.pid >= width:
                raise ValueError(
                    f"{ev.kind} targets pid {ev.pid} but only {width} "
                    f"PIDs exist at round {ev.round}"
                )
            if ev.kind == "rescale":
                width = ev.k_new
        return self

    def __iter__(self) -> Iterator[ChaosEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        evs = ", ".join(
            f"{e.kind}@{e.round}" for e in self.events
        )
        return f"ChaosPlan(seed={self.seed}, [{evs}])"
