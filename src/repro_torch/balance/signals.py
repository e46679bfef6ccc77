"""The one measurement container behind every rebalancing decision
(the port's copy of ``repro.balance.signals``).

Every consumer layer reduces its bookkeeping to the same two vectors —
a positive per-worker load magnitude and the per-worker unit counts —
so policies stay blind to the granularity, exactly as the paper's
controller is blind to the graph structure:

==============  =====================================  ==============
kind            values[k]                              unit
==============  =====================================  ==============
residual        r_k + s_k (fluid left + in flight)     node / bucket
edge-ops        edge operations charged this window    node / bucket
step-time       wall-clock seconds of worker k's step  device
expert-tokens   tokens routed to expert shard k        expert-shard
graph-churn     changed edges owned by worker k        node / bucket
latency         serving pressure (deadline + queue)    request stream
==============  =====================================  ==============

The convention throughout: **larger value = slower / more loaded
worker** (the paper's residual magnitude plays exactly this role in
§2.5.2 — the PID with the largest remaining residual has the lagging
slope and sheds load).

The port produces every kind: residual, edge-ops, graph-churn, latency
(the supervisor's per-request pressure), queue-depth (the serving
scheduler's), step-time (:meth:`LoadSignal.from_step_times`, the
training loop's straggler monitor) and expert-tokens
(:meth:`LoadSignal.from_expert_counts`, fed by the MoE model's
``set_expert_load_sink`` tap to the training loop's expert monitor).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["LoadSignal", "SIGNAL_KINDS"]

SIGNAL_KINDS = ("residual", "edge-ops", "step-time", "expert-tokens",
                "graph-churn", "latency", "queue-depth")


@dataclasses.dataclass
class LoadSignal:
    """Per-worker load measurement at one control step.

    ``values`` — [K] positive magnitudes (larger = more loaded);
    ``sizes`` — [K] load units currently owned by each worker;
    ``kind`` — which measurement produced ``values``;
    ``step`` — producer's control-step counter (simulator time step,
    engine chunk index, runtime step).
    """

    values: np.ndarray
    sizes: np.ndarray
    kind: str = "residual"
    step: int = 0

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=np.float64)
        self.sizes = np.asarray(self.sizes, dtype=np.int64)
        if self.values.shape != self.sizes.shape:
            raise ValueError(
                f"values {self.values.shape} vs sizes {self.sizes.shape}"
            )
        if self.kind not in SIGNAL_KINDS:
            raise ValueError(
                f"unknown signal kind {self.kind!r}; expected one of "
                f"{SIGNAL_KINDS}"
            )

    @property
    def k(self) -> int:
        return int(self.values.shape[0])

    # ------------------------------------------------------------------ #
    # producers
    # ------------------------------------------------------------------ #
    @classmethod
    def from_residuals(cls, r_plus_s: np.ndarray, sizes: np.ndarray,
                       step: int = 0) -> "LoadSignal":
        """§2.5.2's native signal: per-PID ``r_k + s_k``."""
        return cls(values=r_plus_s, sizes=sizes, kind="residual", step=step)

    @classmethod
    def from_edge_ops(cls, ops_delta: np.ndarray, sizes: np.ndarray,
                      step: int = 0) -> "LoadSignal":
        """Edge operations charged since the previous control step."""
        return cls(values=np.maximum(ops_delta, 0), sizes=sizes,
                   kind="edge-ops", step=step)

    @classmethod
    def from_step_times(cls, seconds: np.ndarray,
                        load_units: Optional[np.ndarray] = None,
                        step: int = 0) -> "LoadSignal":
        """Per-host step wall-times (a straggler is a slow PID), as
        fractions of their total (at least 1e-9 s each), so that the slope
        policies see residual-like magnitudes in (0, 1) whatever the step's
        duration; ``load_units`` default to 2**20 a host."""
        seconds = np.maximum(np.asarray(seconds, np.float64), 1e-9)
        if load_units is None:
            load_units = np.full(seconds.shape[0], 1 << 20)
        return cls(values=seconds / seconds.sum(), sizes=load_units,
                   kind="step-time", step=step)

    @classmethod
    def from_graph_churn(cls, churn_counts: np.ndarray,
                         sizes: np.ndarray, step: int = 0) -> "LoadSignal":
        """Changed-edge counts per worker after a graph delta.

        A worker whose nodes absorb the churn pays the view-patch work
        *and* re-diffuses the injected fluid ``(P'−P)·H`` — the paper's
        thesis applied to graph drift: the controller needs only this
        magnitude, no structural analysis.  Counts are normalized to
        fractions: the slope policies' move fraction
        ``(slope_min+1)/(slope_max+1)`` assumes a negative signal
        exponent, and fractions keep the signal independent of scale.
        """
        churn = np.maximum(np.asarray(churn_counts, np.float64), 0.0)
        total = churn.sum()
        if total > 0:
            churn = churn / total
        return cls(values=churn, sizes=sizes, kind="graph-churn", step=step)

    @classmethod
    def from_latency(cls, latency_s: float, deadline_s: float,
                     queue_depth: int = 0, queue_cap: int = 8,
                     step: int = 0) -> "LoadSignal":
        """Serving-tier pressure: deadline headroom plus queue backlog
        (the supervisor's signal, a latency that already happened):

            pressure = latency/deadline + queue_depth/queue_cap

        NOT normalized (overload is absolute, not relative imbalance);
        1.0 means "at the deadline with an empty queue"; ``sizes[0]``
        carries the raw queue depth for event logs.
        """
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got "
                             f"{deadline_s}")
        pressure = (max(float(latency_s), 0.0) / float(deadline_s)
                    + max(int(queue_depth), 0) / max(int(queue_cap), 1))
        return cls(values=np.array([pressure]),
                   sizes=np.array([max(int(queue_depth), 0)]),
                   kind="latency", step=step)

    @classmethod
    def from_queue(cls, oldest_wait_s: float, deadline_s: float,
                   queue_depth: int = 0, queue_cap: int = 8,
                   step: int = 0) -> "LoadSignal":
        """Continuous-batching backlog pressure (the scheduler's signal).

        A batch scheduler needs the leading indicator — how long the
        queue's HEAD has been waiting plus how deep the backlog is — so it
        can shed quality before any request misses its deadline:

            pressure = oldest_wait/deadline + queue_depth/queue_cap

        NOT normalized (overload is absolute, not relative imbalance);
        1.0 ≈ "head request at the deadline with an empty queue";
        ``sizes[0]`` carries the raw depth for event logs.
        """
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got "
                             f"{deadline_s}")
        pressure = (max(float(oldest_wait_s), 0.0) / float(deadline_s)
                    + max(int(queue_depth), 0) / max(int(queue_cap), 1))
        return cls(values=np.array([pressure]),
                   sizes=np.array([max(int(queue_depth), 0)]),
                   kind="queue-depth", step=step)

    @classmethod
    def from_expert_counts(cls, token_counts: np.ndarray,
                           shards_per_expert: Optional[np.ndarray] = None,
                           step: int = 0) -> "LoadSignal":
        """Per-expert routed-token counts (a hot expert is a hot Ω_k).

        Counts are normalized to routing fractions (see
        :meth:`from_step_times` in the reference for why).
        """
        token_counts = np.maximum(
            np.asarray(token_counts, np.float64), 1e-12)
        return cls(values=token_counts / token_counts.sum(),
                   sizes=(shards_per_expert if shards_per_expert is not None
                          else np.ones(token_counts.shape[0],
                                       dtype=np.int64)),
                   kind="expert-tokens", step=step)
