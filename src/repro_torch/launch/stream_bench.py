"""Streaming soak: a supervised serving session under chaos (the port's
copy of the soak machinery of the reference's ``benchmarks/stream_bench.py``,
as :mod:`repro_torch.launch.paper_tables` is of its paper tables).

Drives a timestamped evolving-web trace — drifting personalization
vectors, link churn from a simulated crawler, poison requests — through a
:class:`repro_torch.resilience.SupervisedSession` while a seeded chaos
schedule kills PIDs mid-request, rescales the PID axis and opens a
straggler window, then replays the *effective* schedule (the requests,
update-apply points and rescales that actually executed) through an
undisturbed twin on a separate GraphStore replica.  Determinism is the
exactness oracle: a served solution matches the twin exactly where both
ran at the same width (recovery replays the identical trajectory, so
|Δx|₁ = 0).

Both functions take the torch ``device`` and an optional ``graph``
factory (a callable returning the link graph, a ``CSRGraph`` or
``GraphStore``, called once per replica); the default is the
reference's ``webgraph_like(spec.n, seed=1)``.

  from repro_torch.launch.stream_bench import (StreamSpec, run_stream,
                                               replay_reference, stream_row)
  spec = StreamSpec(n=1024, k=4, requests=24, kill_at=(5,),
                    rescale_at={12: 3}, poison_every=7, stale_update_at=9)
  run = run_stream(spec, ckpt_dir, device="cpu")
  row = stream_row("soak", spec, run, replay_reference(spec, run, "cpu"))
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StreamSpec:
    """One deterministic stream scenario (trace + chaos + config)."""

    n: int = 4096
    k: int = 8
    method: str = "engine:chunk"
    requests: int = 500
    drift: float = 0.003
    churn_every: int = 10           # every i-th request is a graph update
    churn_rot: int = 8              # link rotations per update
    poison_every: int = 0           # every i-th rank request is poison
    stale_update_at: Optional[int] = None  # inject one stale-version update
    kill_at: Tuple[int, ...] = ()   # request indices killed mid-solve
    rescale_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    straggler: Optional[Tuple[int, int, float]] = None  # (start, end, slow)
    queue_burst: int = 6            # queue depth during the straggler window
    defer_cap: int = 64
    deadline_s: Optional[float] = 0.05
    op_rate: float = 2e6
    target_error: Optional[float] = None
    chunk_rounds: int = 32
    seed: int = 0
    sample_every: int = 10          # |dx| checked at every i-th request
    rungs: Optional[tuple] = None   # None = (nominal, defer-updates)
    pressure_hi: float = 1.0
    pressure_lo: float = 0.5


def build_problem(n: int, seed: int = 1, target_error=None,
                  graph: Optional[Callable] = None):
    """The soak's PageRank problem on a fresh GraphStore replica."""
    import repro_torch
    from repro_torch.core import webgraph_like
    from repro_torch.graph import GraphStore

    g = (graph() if graph is not None
         else GraphStore.from_csr(webgraph_like(n, seed=seed)))
    return repro_torch.Problem.pagerank(g, target_error=target_error)


def _options(spec: StreamSpec, device: str):
    import repro_torch

    is_engine = spec.method.startswith("engine")
    return repro_torch.SolverOptions(
        k=spec.k if is_engine else None,
        chunk_rounds=spec.chunk_rounds if is_engine else 4,
        device=device)


def make_trace(spec: StreamSpec, problem) -> List[dict]:
    """The request stream, fully materialized up front so the soak and
    the reference replay consume bit-identical payloads."""
    rng = np.random.default_rng(spec.seed)
    b = np.asarray(problem.b, dtype=np.float64)
    trace: List[dict] = []
    for i in range(spec.requests):
        if (spec.churn_every and i % spec.churn_every
                == spec.churn_every - 1):
            trace.append({"kind": "update", "seed": 5000 + i,
                          "stale": i == spec.stale_update_at})
            continue
        b = np.abs(b * (1.0 + spec.drift * rng.standard_normal(problem.n)))
        poison = bool(spec.poison_every and i % spec.poison_every
                      == spec.poison_every - 1)
        entry = {"kind": "rank", "b": b, "poison": poison}
        if poison:
            bad = b.copy()
            bad[int(rng.integers(problem.n))] = np.nan
            entry["b_poison"] = bad
        trace.append(entry)
    return trace


def run_stream(spec: StreamSpec, ckpt_dir: str, device: str = "cuda",
               graph: Optional[Callable] = None) -> dict:
    """Drive the supervised soak; returns outcomes + the effective log
    + sampled solutions (by trace index), and the host wall of each
    planned rescale (``rescale_s``: ``(index, k_new, seconds)``)."""
    from repro_torch.balance import PressurePolicy
    from repro_torch.chaos import ChaosPlan, SessionInjector
    from repro_torch.graph import rotation_churn
    from repro_torch.resilience import (DegradationLadder, RetryPolicy, Rung,
                                        SupervisedSession)

    problem = build_problem(spec.n, target_error=spec.target_error,
                            graph=graph)
    trace = make_trace(spec, problem)
    rungs = spec.rungs if spec.rungs is not None else (
        Rung("nominal"), Rung("defer-updates", defer_updates=True))
    ladder = DegradationLadder(
        rungs=rungs,
        policy=PressurePolicy(eta=0.6, z=3, hi=spec.pressure_hi,
                              lo=spec.pressure_lo, patience=2))
    sup = SupervisedSession(
        problem, method=spec.method, options=_options(spec, device),
        ckpt_dir=ckpt_dir, ladder=ladder, deadline_s=spec.deadline_s,
        op_rate=spec.op_rate, defer_cap=spec.defer_cap,
        sleep=lambda s: None,
        retry=RetryPolicy(base_delay_s=0.005, max_delay_s=0.02, seed=0))
    # the "crawler": owns its own replica and applies every delta it
    # emits immediately, so queued deltas compose in emission order no
    # matter how long the ladder defers them
    crawler = build_problem(spec.n, graph=graph).graph
    crawler_v0 = crawler.version
    deltas_by_seed: Dict[int, object] = {}
    emitted = 0

    effective: List[tuple] = []
    pending: List[int] = []         # churn seeds awaiting apply events
    samples: Dict[int, np.ndarray] = {}
    outcomes = []
    staleness: List[int] = []       # queued updates at each serve point
    rescale_s: List[tuple] = []
    ev_cursor = 0
    for i, req in enumerate(trace):
        if i in spec.rescale_at:
            t0 = time.perf_counter()
            sup.rescale(spec.rescale_at[i])
            rescale_s.append((i, spec.rescale_at[i],
                              time.perf_counter() - t0))
        if spec.straggler is not None:
            start, end, slow = spec.straggler
            if i == start:
                sup.note_straggler(min(1, spec.k - 1), slow)
            if i == end:
                sup.note_straggler(min(1, spec.k - 1), 1.0)
        in_burst = (spec.straggler is not None
                    and spec.straggler[0] <= i < spec.straggler[1])
        if req["kind"] == "rank":
            if req["poison"]:
                out = sup.serve_rank(req["b_poison"], request_id=i,
                                     want_x=False)
                outcomes.append(out)
                ev_cursor = len(sup.log)
                continue
            chaos = None
            if i in spec.kill_at:
                # target the last pid of the CURRENT width (rescales may
                # have shrunk the session since the trace was authored)
                k_now = getattr(getattr(sup.session, "_driver", None),
                                "cfg", None)
                k_now = getattr(k_now, "k", 1)
                chaos = SessionInjector(ChaosPlan(seed=i).kill(
                    pid=max(k_now - 1, 0), round=2))
            want = (i % spec.sample_every == 0)
            out = sup.serve_rank(
                req["b"], request_id=i, chaos=chaos,
                queue_depth=spec.queue_burst if in_burst else 0,
                want_x=want)
            if out.ok and want:
                samples[i] = out.x
        else:
            delta = rotation_churn(crawler, spec.churn_rot,
                                   seed=req["seed"])
            if req["stale"]:
                # wrong version pin: rejected at admission, so the
                # crawler must NOT count it either — both sides agree
                # the delta never happened
                sv = 0
            else:
                sv = crawler_v0 + emitted  # version this delta targets
                crawler.apply_delta(delta)
                emitted += 1
                deltas_by_seed[req["seed"]] = delta
                pending.append(req["seed"])
            out = sup.serve_update(delta, store_version=sv, request_id=i)
            if out.rejected and not req["stale"] and pending:
                pending.pop()       # never reached the queue after all
        outcomes.append(out)
        staleness.append(sup.deferred_updates)
        # fold the supervisor's new events into the effective schedule
        for ev in list(sup.log)[ev_cursor:]:
            if ev.kind == "request_served":
                effective.append(("rank", ev.detail["request_id"]))
            elif ev.kind == "update_applied":
                effective.append(("update", pending.pop(0)))
            elif ev.kind == "update_conflict":
                pending.pop(0)      # quarantined at apply: not effective
            elif ev.kind == "rescale":
                effective.append(("rescale", ev.detail["k_new"]))
        ev_cursor = len(sup.log)
    # drain anything still deferred so the stream ends caught-up
    sup.flush_deferred(reason="end-of-stream")
    for ev in list(sup.log)[ev_cursor:]:
        if ev.kind == "update_applied":
            effective.append(("update", pending.pop(0)))
        elif ev.kind == "update_conflict":
            pending.pop(0)
    return {
        "sup": sup, "trace": trace, "effective": effective,
        "samples": samples, "outcomes": outcomes,
        "deltas_by_seed": deltas_by_seed, "staleness": staleness,
        "rescale_s": rescale_s,
    }


def replay_reference(spec: StreamSpec, run: dict, device: str = "cuda",
                     graph: Optional[Callable] = None) -> dict:
    """Undisturbed twin on a fresh GraphStore replica: replays the
    soak's effective schedule (requests, update applies, rescales) with
    no chaos, no ladder, no retries — at the NOMINAL target, so lossy
    rungs show up as measured error rather than vanishing into a
    matching degraded reference."""
    import repro_torch

    problem = build_problem(spec.n, target_error=spec.target_error,
                            graph=graph)
    ref = repro_torch.SolverSession(problem, method=spec.method,
                                    options=_options(spec, device))
    b_by_index = {i: e["b"] for i, e in enumerate(run["trace"])
                  if e["kind"] == "rank" and not e["poison"]}
    ref_samples: Dict[int, np.ndarray] = {}
    total_ops = 0
    for entry in run["effective"]:
        kind = entry[0]
        if kind == "rank":
            i = entry[1]
            ref.warm_start(b_by_index[i])
            rep = ref.solve()
            total_ops += rep.n_ops
            if i in run["samples"]:
                ref_samples[i] = rep.x
        elif kind == "update":
            # identical churn seeds on identical store content produce
            # identical deltas: the crawler's own delta is replayed
            delta = run["deltas_by_seed"][entry[1]]
            ref.update_graph(delta)
            rep = ref.solve()
            total_ops += rep.n_ops
        elif kind == "rescale":
            ref.rescale(entry[1])
    return {"ref": ref, "samples": ref_samples,
            "undisturbed_ops": ref.lifetime_ops}


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def stream_row(scenario: str, spec: StreamSpec, run: dict,
               ref: dict) -> dict:
    sup = run["sup"]
    outs = run["outcomes"]
    ranks = [o for o in outs if o.kind == "rank" and not o.rejected]
    served = [o for o in ranks if o.ok]
    dropped = [o for o in ranks if not o.ok]
    rejected = [o for o in outs if o.rejected]
    dxs = {i: float(np.abs(run["samples"][i] - ref["samples"][i]).sum())
           for i in run["samples"] if i in ref["samples"]}
    lat = [o.latency_s for o in served]
    kill_lat = [o.latency_s for o in served if o.restores > 0]
    counts = sup.log.counts()
    stale = run["staleness"]
    return {
        "scenario": scenario,
        "method": spec.method,
        "n": spec.n,
        "k": spec.k,
        "requests": spec.requests,
        "served": len(served),
        "dropped": len(dropped),
        "rejected": len(rejected),
        "applied_updates": counts.get("update_applied", 0),
        "deferred_peak": max(stale) if stale else 0,
        "mean_staleness": round(float(np.mean(stale)), 3) if stale else 0.0,
        "total_ops": int(sup.total_ops),
        "undisturbed_ops": int(ref["undisturbed_ops"]),
        "wasted_ops": int(sup.wasted_ops),
        "max_dx_l1": max(dxs.values()) if dxs else float("nan"),
        "checked_points": len(dxs),
        "p50_latency_s": round(_percentile(lat, 50), 6),
        "p95_latency_s": round(_percentile(lat, 95), 6),
        "recovery_p50_s": round(_percentile(kill_lat, 50), 6),
        "recovery_p95_s": round(_percentile(kill_lat, 95), 6),
        "degraded_frac": round(
            sum(1 for o in served if o.degraded) / max(len(served), 1), 4),
        "kills": counts.get("fault", 0),
        "restores": sup.restores,
        "rescales": counts.get("rescale", 0),
        "degrades": counts.get("degrade", 0),
        "recovers": counts.get("recover", 0),
        "converged": bool(all(o.converged for o in served)),
    }
