"""Continuous-batching serving tier for personalized-rank requests (the
port of ``repro.serving``).

Many concurrent diffusion computations share one matrix; throughput
comes from keeping the card busy with all of them at once:

* :class:`Scheduler` — queue → lanes → pool control loop with admission
  control, drain-barrier graph updates, and pressure-ladder overload
  shedding, on a deterministic virtual clock;
* :class:`ContinuousBatcher` — slot-level in-flight batching through the
  same batched round ``SolverSession.solve_batch`` runs (pow2 lane
  buckets, per-lane convergence, per-lane §2.3 op accounting; each round
  one launch of K3's lane form);
* :class:`SessionPool` — device-resident warm H-states keyed by
  ``(store_version, personalization-cluster)`` with LRU eviction;
* :class:`RequestQueue` / :class:`Request` — FIFO with the backlog
  accounting the ``queue-depth`` LoadSignal reads.

:func:`solo_reference` is the sequential twin: one warm-started
SolverSession chained across requests, for QPS baselines and per-request
parity checks.
"""
from .batcher import ContinuousBatcher, LaneInfo, MicroReport, RetiredLane
from .pool import PoolEntry, SessionPool
from .queue import Request, RequestQueue
from .scheduler import Scheduler, ServedRequest

__all__ = [
    "ContinuousBatcher",
    "LaneInfo",
    "MicroReport",
    "PoolEntry",
    "Request",
    "RequestQueue",
    "RetiredLane",
    "Scheduler",
    "ServedRequest",
    "SessionPool",
    "solo_reference",
]


def solo_reference(problem, bs, method: str = "frontier:segment_sum",
                   until=None, device="cuda"):
    """Serve ``bs`` ([N, C]) strictly sequentially — the pre-batching
    ``serve rank`` path: one session, warm-started per request.

    Returns ``(x [N, C] float64, ops [C], wall_s)``.  Both this and the
    batched path converge to the same tolerance, so per-request
    solutions agree within ~2× the served target_error.
    """
    import time

    import numpy as np

    from ..api.session import SolverSession

    bs = np.asarray(bs, dtype=np.float64)
    xs = np.zeros_like(bs)
    ops = np.zeros(bs.shape[1], dtype=np.int64)
    t0 = time.perf_counter()
    session = SolverSession(problem, method=method, device=device)
    for c in range(bs.shape[1]):
        session.warm_start(bs[:, c])
        rep = session.solve(until=until)
        xs[:, c] = rep.x
        ops[c] = rep.n_ops
    return xs, ops, time.perf_counter() - t0
