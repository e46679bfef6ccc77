"""Registered backend adapters: one per solver tier (DESIGN.md §4).

Each adapter translates the validated :class:`SolverOptions` subset into
its tier's native config and returns the unified :class:`SolveReport`
with the cross-backend field semantics (edge-push ``n_ops``,
``cost_iterations = n_ops/L``, per-round ``trace``, ``move_log``).

The port registers the reference's keys with the reference's
capabilities: ``sequential`` (numpy), ``frontier:segment_sum`` (per-edge
rounds over K3), ``frontier:pallas`` (fused BSR rounds over K1, native on
the card where the reference's is native on the TPU), the K-PID
engine's ``engine:chunk`` (per-edge push over K3) and ``engine:bsr``
(tile push over K2), and ``simulator``, the paper's faithful K-PID
simulator (its push over K7; a fidelity choice, never auto's pick over an
engine).  No backend takes a multi-RHS batch yet: ``solve_batch`` comes
with the serving slice.
"""
from __future__ import annotations

import time

from .options import SolverOptions
from .problem import Problem
from .registry import BackendCapabilities, register_backend
from .report import RoundReport, SolveReport
from .session import SolverSession

_TRACE_CAP = 512  # max records kept from dense per-sweep histories


def _downsample(records, cap: int = _TRACE_CAP):
    if len(records) <= cap:
        return list(records)
    stride = -(-len(records) // cap)
    kept = list(records[::stride])
    if records and (not kept or kept[-1] is not records[-1]):
        kept.append(records[-1])
    return kept


def _reject_batch(problem: Problem, method: str) -> None:
    if problem.is_batched:
        raise ValueError(
            f"backend {method!r} has no multi-RHS path in this port yet; "
            "solve the columns as separate problems"
        )


# --------------------------------------------------------------------------- #
# sequential — paper-exact numpy sweep
# --------------------------------------------------------------------------- #
@register_backend(
    "sequential",
    BackendCapabilities(auto_priority=2),
)
def _solve_sequential(problem: Problem, options: SolverOptions
                      ) -> SolveReport:
    from ..core.diteration import run_sequential

    _reject_batch(problem, "sequential")
    sweeps: list = []
    t0 = time.perf_counter()
    res = run_sequential(
        problem.p, problem.b,
        target_error=problem.target_error, eps=problem.eps,
        weights=problem.node_weights(),
        gamma=options.gamma, max_ops=options.max_ops, trace=sweeps,
    )
    trace = [RoundReport(s, r, o) for s, r, o in _downsample(sweeps)]
    if not trace or trace[-1].n_ops != res.n_ops:
        trace.append(RoundReport(res.n_sweeps, res.residual, res.n_ops))
    return SolveReport(
        x=res.x,
        residual=res.residual,
        n_ops=res.n_ops,
        cost_iterations=res.cost_iterations,
        n_rounds=res.n_sweeps,
        converged=res.residual <= problem.tol,
        method="sequential",
        trace=trace,
        wall_time_s=time.perf_counter() - t0,
        extras={"n_diffusions": res.n_diffusions},
    )


# --------------------------------------------------------------------------- #
# frontier — session-driven (streaming/warm-start machinery)
# --------------------------------------------------------------------------- #
def _session_solve(problem: Problem, options: SolverOptions,
                   method: str) -> SolveReport:
    _reject_batch(problem, method)
    return SolverSession(problem, method=method, options=options).solve()


@register_backend(
    "frontier:segment_sum",
    BackendCapabilities(supports_warm_start=True, auto_priority=10),
)
def _solve_frontier_segment_sum(problem, options):
    return _session_solve(problem, options, "frontier:segment_sum")


@register_backend(
    "frontier:pallas",
    BackendCapabilities(
        supports_warm_start=True,
        device_kinds=("cuda",),  # runs anywhere, but auto only on the
        # card — unless a tuned record proves the BSR path out elsewhere
        auto_priority=40,
        tune_key="frontier_round_bsr",
    ),
)
def _solve_frontier_pallas(problem, options):
    return _session_solve(problem, options, "frontier:pallas")


@register_backend(
    "engine:chunk",
    BackendCapabilities(
        supports_dynamic_partition=True, supports_warm_start=True,
        configurable_k=True, auto_priority=5,
    ),
)
def _solve_engine_chunk(problem, options):
    return _session_solve(problem, options, "engine:chunk")


@register_backend(
    "engine:bsr",
    BackendCapabilities(
        supports_dynamic_partition=True, supports_warm_start=True,
        configurable_k=True, min_auto_n=1 << 17, auto_priority=30,
        tune_key="bsr_gather_spmm",
    ),
)
def _solve_engine_bsr(problem, options):
    return _session_solve(problem, options, "engine:bsr")


# --------------------------------------------------------------------------- #
# simulator — faithful K-PID time-stepped reference (§2.2–2.5)
# --------------------------------------------------------------------------- #
@register_backend(
    "simulator",
    BackendCapabilities(
        supports_dynamic_partition=True, configurable_k=True,
        auto_priority=1,
    ),
)
def _solve_simulator(problem: Problem, options: SolverOptions
                     ) -> SolveReport:
    from ..core.simulator import DistributedSimulator, SimulatorConfig

    _reject_batch(problem, "simulator")
    if problem.weights is not None:
        raise ValueError(
            "the simulator selects weights by mode; set "
            "Problem.weight_mode instead of an explicit weights array"
        )
    cfg = SimulatorConfig(
        k=options.k or 8,
        target_error=problem.target_error,
        eps=problem.eps,
        partition=options.partition,
        dynamic=options.dynamic,
        policy=options.policy,
        signal=options.signal,
        mode=options.mode,
        weight_mode=problem.weight_mode,
        gamma=options.gamma,
        eta=options.eta,
        z=options.z,
        max_steps=options.max_steps,
        record_every=options.record_every,
        device=options.device,
    )
    t0 = time.perf_counter()
    res = DistributedSimulator(problem.p, problem.b, cfg).run()
    records = list(zip(res.hist_steps.tolist(),
                       res.hist_residual.tolist(),
                       res.hist_edge_ops.tolist()))
    trace = [RoundReport(s, r, o) for s, r, o in _downsample(records)]
    if not trace or trace[-1].n_ops != res.n_edge_ops:
        trace.append(
            RoundReport(res.n_steps, res.residual, res.n_edge_ops))
    return SolveReport(
        x=res.h.cpu().numpy(),
        residual=res.residual,
        n_ops=res.n_edge_ops,
        cost_iterations=res.n_edge_ops / max(problem.n_edges, 1),
        n_rounds=res.n_steps,
        converged=res.converged,
        method="simulator",
        trace=trace,
        move_log=list(res.move_log),
        wall_time_s=time.perf_counter() - t0,
        extras={
            # the simulator's own §2.3/§2.4 wall-clock cost model (charged
            # ops incl. exchange/reassignment, the paper's steps·PID_Speed/L
            # table metric):
            "cost_steps_iterations": res.cost_iterations,
            "count_active": res.count_active,
            "count_idle": res.count_idle,
            "n_exchanges": res.n_exchanges,
            "n_moves": res.n_moves,
            "hist_sizes": res.hist_sizes,
            "hist_rs": res.hist_rs,
        },
    )
