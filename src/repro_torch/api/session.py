"""Stateful solving: :class:`SolverSession` + the resumable drivers.

The paper's central object is the fluid pair ``(H, F)`` — the
accumulated history and the residual fluid.  Here it is what travels
between *solves*:

* ``run(until=...)`` — stream :class:`RoundReport`\\ s while draining F
  (the serving loop's progress feed).
* ``warm_start(b_new)`` — keep H, re-seed ``F = B' − (I−P)·H`` (the
  §2.2 residual identity ``X_exact − H = (I−P)^{-1} F`` applied to the
  new RHS).  A nearby B' leaves |F| tiny, so re-solving costs a small
  fraction of a cold solve.

Drivers adapt one warm-startable backend each behind a tiny protocol
(``seed`` / ``advance`` / ``x`` / ``residual`` / ``ops`` / ``rounds`` /
``exhausted`` / ``fluid`` / ``threshold`` / ``set_threshold``) that the
reference's drivers share, so :mod:`repro_torch.interop` can carry a
reference session's state across.  The reference keeps its round loop
on the device (``lax.while_loop``); the port runs a Python loop with the
same round sequence and reads one scalar per round for the ``res > tol``
test (the engine: one per inner round for the any-PID fire flag).
State lives on ``options.device`` in float32, as the reference's does
with x64 off; the op counters are int64.

The frontier drivers advance by rounds; the engine driver
(``engine:chunk`` / ``engine:bsr``) advances one chunk per grain, with
the balance control plane between chunks.

``update_graph``, ``checkpoint``/``restore``, ``rescale`` and
``solve_batch`` come with later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..balance.executors import BucketMoveExecutor
from ..balance.policies import make_rebalancer
from ..core.distributed import (
    DistributedEngine,
    EngineConfig,
    build_engine_arrays,
)
from ..kernels.diffusion import frontier_round_bsr
from ..kernels.edge_sum import csc_edges, edge_sum
from ..kernels.tune import resolved_config
from .options import SolverOptions, engine_dtype
from .problem import Problem
from .report import RoundReport, SolveReport

__all__ = ["SolverSession"]


def _f32(v, device) -> torch.Tensor:
    """Host values as a float32 tensor on ``device`` (the reference's
    JAX arrays are float32 with x64 off; ``torch.as_tensor`` alone
    would keep float64)."""
    return torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)


def _tol32(tol: float) -> float:
    """The stopping tolerance as the reference compares it: a Python
    float against a float32 residual is taken as float32 in JAX."""
    return float(np.float32(tol))


def _edges_of(problem: Problem, device):
    g = problem.p
    src, dst, wgt = g.edge_list()
    return csc_edges(src, dst, wgt, g.n, device)


# --------------------------------------------------------------------------- #
# frontier drivers
# --------------------------------------------------------------------------- #
class _SegmentSumDriver:
    """frontier:segment_sum — per-edge gather→multiply→sum rounds (K3)."""

    def __init__(self, problem: Problem, options: SolverOptions):
        g = problem.p
        self.n = g.n
        self.l = max(g.n_edges, 1)
        self.device = torch.device(options.device)
        self.edges = _edges_of(problem, self.device)
        self.w = _f32(problem.node_weights(), self.device)
        self.out_deg = torch.as_tensor(g.out_degree(), device=self.device)
        self.dang = torch.as_tensor(g.dangling_mask(), device=self.device)
        self.gamma = options.gamma
        self._state = None

    def _zero_ops(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def seed(self, f_nodes: np.ndarray,
             h_nodes: Optional[np.ndarray] = None) -> None:
        f = _f32(f_nodes, self.device)
        h = torch.zeros_like(f) if h_nodes is None else _f32(
            h_nodes, self.device)
        t = (f * self.w).abs().max() * 2.0
        self._state = (f, h, t, self._zero_ops(), 0)

    def warm_seed(self, b_new: np.ndarray) -> float:
        """Device-resident warm start: ``F' = B' − H + P·H`` (``P·H``
        through K3) without moving H to the host; only ``b_new`` is
        uploaded.  Counters reset.  Returns |F'|_1."""
        _f, h, _t, _ops, _rounds = self._state
        f = _f32(b_new, self.device) - h + edge_sum(h, self.edges)
        t = (f * self.w).abs().max() * 2.0
        self._state = (f, h, t, self._zero_ops(), 0)
        return float(f.abs().sum())

    def advance(self, tol: float, round_limit: int) -> None:
        """Run until |F|_1 <= tol or the *total* round count hits the
        limit; resumable (identical round sequence to one long loop)."""
        from ..core.diteration import frontier_step

        f, h, t, ops, rounds = self._state
        tol = _tol32(tol)
        while rounds < round_limit and float(f.abs().sum()) > tol:
            f, h, t, dops = frontier_step(
                f, h, t, self.edges, self.w, self.out_deg, self.dang,
                self.gamma)
            ops = ops + dops
            rounds += 1
        self._state = (f, h, t, ops, rounds)

    def x(self) -> np.ndarray:
        return self._state[1].double().cpu().numpy()

    def residual(self) -> float:
        return float(self._state[0].abs().sum())

    def ops(self) -> int:
        return int(self._state[3])

    def rounds(self) -> int:
        return self._state[4]

    def exhausted(self) -> bool:
        return False

    def move_log(self) -> List[Tuple[int, int, int, int]]:
        return []

    # ---- node-space state (the protocol interop seeds through) ------------
    def fluid(self) -> Tuple[np.ndarray, np.ndarray]:
        """(F, H) as float64 node-space vectors."""
        return (self._state[0].double().cpu().numpy(),
                self._state[1].double().cpu().numpy())

    def threshold(self) -> np.ndarray:
        return np.asarray(float(self._state[2]), dtype=np.float64)

    def set_threshold(self, t: np.ndarray) -> None:
        t = np.asarray(t, dtype=np.float64).reshape(-1)
        if t.shape != (1,):
            return  # saved at a different width (per-device T): keep the
            # re-derived threshold — any schedule is valid
        f, h, _t, ops, rounds = self._state
        self._state = (f, h, _f32(t[0], self.device), ops, rounds)


class _BsrFrontierDriver:
    """frontier:pallas — fused BSR frontier rounds (K1 on the card).

    The name is the reference's registry key; the kernel behind it is
    CUDA C++.  On the CPU it runs the ``block`` oracle, or K1's plain
    twin when ``options.interpret`` asks for the kernel's semantics.
    """

    def __init__(self, problem: Problem, options: SolverOptions):
        g = problem.p
        self.n = g.n
        self.l = max(g.n_edges, 1)
        self.device = dev = torch.device(options.device)
        # kernel config: explicit options > platform tuned record > defaults
        bs, self.buffer_depth, self.occupancy_threshold = resolved_config(
            "frontier_round_bsr",
            platform=dev.type,
            bs=options.bs,
            buffer_depth=options.buffer_depth,
            occupancy_threshold=options.occupancy_threshold,
        )
        # the store's cached BSR view, uploaded once and kept on the card
        self.m = problem.graph.bsr(bs=bs).to_device(dev)
        n_pad = self.m.n_row_blocks * bs
        # destination-sorted edges for the device-resident warm start
        # (P·H through K3 — the BSR pool only exposes fused rounds)
        self.edges = _edges_of(problem, dev)

        def pad(v, dtype):
            out = torch.zeros(n_pad, dtype=dtype, device=dev)
            out[: g.n] = torch.as_tensor(np.asarray(v), dtype=dtype,
                                         device=dev)
            return out

        self.w = pad(problem.node_weights(), torch.float32)
        self.out_deg = pad(g.out_degree(), torch.int64)
        self.dang = pad(g.dangling_mask(), torch.bool)
        self.gamma = options.gamma
        self.backend = ("kernel" if dev.type == "cuda" or options.interpret
                        else "block")
        self._n_pad = n_pad
        self._state = None

    def _padded(self, v) -> torch.Tensor:
        out = torch.zeros(self._n_pad, dtype=torch.float32,
                          device=self.device)
        out[: self.n] = _f32(v, self.device)
        return out

    def _zero_ops(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def seed(self, f_nodes: np.ndarray,
             h_nodes: Optional[np.ndarray] = None) -> None:
        f = self._padded(f_nodes)
        h = (torch.zeros_like(f) if h_nodes is None
             else self._padded(h_nodes))
        t = (f * self.w).abs().max() * 2.0
        self._state = (f, f.abs().sum(), h, t, self._zero_ops(), 0)

    def warm_seed(self, b_new: np.ndarray) -> float:
        """Device-resident warm start over the padded state (see
        :meth:`_SegmentSumDriver.warm_seed`)."""
        _f, _res, h, _t, _ops, _rounds = self._state
        h_n = h[: self.n]
        f = torch.zeros_like(h)
        f[: self.n] = (_f32(b_new, self.device) - h_n
                       + edge_sum(h_n.contiguous(), self.edges))
        res = f.abs().sum()
        t = (f * self.w).abs().max() * 2.0
        self._state = (f, res, h, t, self._zero_ops(), 0)
        return float(res)

    def advance(self, tol: float, round_limit: int) -> None:
        f, res, h, t, ops, rounds = self._state
        tol = _tol32(tol)
        while rounds < round_limit and float(res) > tol:
            f, sent, res = frontier_round_bsr(
                self.m, f, self.w, t, backend=self.backend,
                buffer_depth=self.buffer_depth,
                occupancy_threshold=self.occupancy_threshold)
            # the op's threshold predicate is authoritative (the kernel
            # backend folds t into the weights); sel follows the sent fluid
            sel = sent != 0
            dops = torch.where(sel, self.out_deg,
                               torch.zeros_like(self.out_deg)).sum()
            dops = dops + (sel & self.dang).sum()
            t = torch.where(sel.any(), t, t / self.gamma)
            h = h + sent
            ops = ops + dops
            rounds += 1
        self._state = (f, res, h, t, ops, rounds)

    def x(self) -> np.ndarray:
        return self._state[2][: self.n].double().cpu().numpy()

    def residual(self) -> float:
        return float(self._state[1])

    def ops(self) -> int:
        return int(self._state[4])

    def rounds(self) -> int:
        return self._state[5]

    def exhausted(self) -> bool:
        return False

    def move_log(self) -> List[Tuple[int, int, int, int]]:
        return []

    # ---- node-space state (the protocol interop seeds through) ------------
    def fluid(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self._state[0][: self.n].double().cpu().numpy(),
                self._state[2][: self.n].double().cpu().numpy())

    def threshold(self) -> np.ndarray:
        return np.asarray(float(self._state[3]), dtype=np.float64)

    def round_inputs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The padded fluid ``[n_pad]`` and the threshold T, on the device,
        that the next round hands ``frontier_round_bsr``."""
        f, _res, _h, t, _ops, _rounds = self._state
        return f, t

    def set_threshold(self, t: np.ndarray) -> None:
        t = np.asarray(t, dtype=np.float64).reshape(-1)
        if t.shape != (1,):
            return  # cross-width state: keep the re-derived T
        f, res, h, _t, ops, rounds = self._state
        self._state = (f, res, h, _f32(t[0], self.device), ops, rounds)


# --------------------------------------------------------------------------- #
# engine driver (the K-PID engine, chunk-granular)
# --------------------------------------------------------------------------- #
def _bsr_buckets_per_dev(n: int, k: int, options: SolverOptions) -> int:
    """BSR tiles are dense [S, S] blocks: cap the bucket size (≤ 512)
    so the tile pool stays [R, T, 512, 512] instead of ballooning to
    [R, T, N/K, N/K] on big problems.  Auto-sizing only ever *raises*
    the bucket count the caller configured."""
    max_s = 512
    real_needed = -(-n // (k * max_s))  # ceil
    return max(options.buckets_per_dev, real_needed + options.headroom)


class _EngineDriver:
    """engine:chunk / engine:bsr — the K-PID engine, one chunk per
    advance, with the balance control plane between chunks."""

    def __init__(self, problem: Problem, options: SolverOptions,
                 diffusion_backend: str):
        if problem.weights is not None or problem.weight_mode != "inv_out":
            raise ValueError(
                "engine backends run the default inv_out selection "
                "weights; custom Problem.weights cannot be honored"
            )
        k = options.k or 1
        buckets_per_dev = (_bsr_buckets_per_dev(problem.n, k, options)
                           if diffusion_backend == "bsr"
                           else options.buckets_per_dev)
        self.cfg = EngineConfig(
            k=k,
            target_error=problem.target_error,
            eps=problem.eps,
            buckets_per_dev=buckets_per_dev,
            headroom=options.headroom,
            max_inner=options.max_inner,
            gamma=options.gamma,
            dynamic=options.dynamic,
            policy=options.policy,
            signal=options.signal,
            eta=options.eta,
            z=options.z,
            chunk_rounds=options.chunk_rounds,
            max_chunks=options.max_chunks,
            dtype=engine_dtype(options.dtype),
            diffusion_backend=diffusion_backend,
            device=options.device,
        )
        # the store's cached engine-layout view
        self.arrays = build_engine_arrays(problem.graph, problem.b,
                                          self.cfg)
        self.engine = DistributedEngine(self.arrays, self.cfg)
        self.problem = problem
        self.verbose = options.verbose
        self.l = max(problem.n_edges, 1)
        self._warm = None  # device maps of warm_seed, built at first use

    def seed(self, f_nodes: np.ndarray,
             h_nodes: Optional[np.ndarray] = None) -> None:
        # fresh policy state per solve phase: a warm start is a new
        # convergence trajectory, stale EMA slopes would misfire
        self._fresh_rebalancer()
        self.ex = BucketMoveExecutor(
            self.engine, self.engine.init_state(f_nodes, h_nodes))
        self._resid = float(np.abs(np.asarray(f_nodes)).sum())
        self._chunks = 0
        self._moves: List[Tuple[int, int, int, int]] = []
        self._prev_ops = np.zeros(self.cfg.k, dtype=np.int64)

    def _fresh_rebalancer(self) -> None:
        if self.engine.rebalancer is not None:
            self.engine.rebalancer = make_rebalancer(
                self.cfg.policy or "slope_ema", k=self.cfg.k,
                target_error=self.cfg.target_error, eta=self.cfg.eta,
                z=self.cfg.z, unit="bucket",
            )

    def _warm_maps(self) -> dict:
        """Node ↔ home-slot maps and the node-space edges (K3), built
        once per driver: the layout never changes, only the bucket →
        row map, which is read per call."""
        if self._warm is None:
            a, dev = self.arrays, self.engine.device
            nos = a.node_of_slot  # [R, S], home-row indexed
            valid = nos >= 0
            flat_slot = (np.arange(a.n_rows)[:, None] * a.bucket_size
                         + np.arange(a.bucket_size)[None, :])[valid]
            self._warm = {
                "edges": _edges_of(self.problem, dev),
                "flat_slot": torch.as_tensor(flat_slot, device=dev),
                "node_ids": torch.as_tensor(nos[valid].astype(np.int64),
                                            device=dev),
                "w_home": torch.as_tensor(a.w, device=dev).to(
                    self.cfg.dtype),
            }
        return self._warm

    def warm_seed(self, b_new: np.ndarray) -> float:
        """Device-resident warm start over the bucket layout.

        H never leaves the device: the ``[R, S]`` state is permuted to
        the home layout, flattened to node space, run through ``P·H``
        (K3 over the node-space edge list) and the re-seeded
        ``F' = B' − H + P·H`` scattered back.  Only ``b_new`` is uploaded
        and the scalar |F'|_1 read back.  Counters reset; the rebalancer
        restarts fresh (new convergence trajectory).
        """
        a, cfg, ex = self.arrays, self.cfg, self.ex
        maps = self._warm_maps()
        dev, dt = self.engine.device, cfg.dtype
        r_rows, s_slots = a.n_rows, a.bucket_size
        cur = self.engine.cur_of_home(ex.row_of_bucket)
        inv = torch.empty_like(cur)  # inv[current row] = its home row
        inv[cur] = torch.arange(r_rows, device=dev)
        st = ex.state
        h_home = st.h[cur]
        h_node = torch.zeros(a.n, dtype=dt, device=dev)
        h_node[maps["node_ids"]] = h_home.reshape(-1)[maps["flat_slot"]]
        b_dev = torch.as_tensor(np.asarray(b_new), device=dev).to(dt)
        f_node = b_dev - h_node + edge_sum(h_node, maps["edges"])
        f_home = torch.zeros(r_rows * s_slots, dtype=dt, device=dev)
        f_home[maps["flat_slot"]] = f_node[maps["node_ids"]]
        f_home = f_home.view(r_rows, s_slots)
        fw_cur = (f_home.abs() * maps["w_home"])[inv]
        st.f = f_home[inv]
        st.outbox = torch.zeros_like(st.outbox)
        st.t = fw_cur.view(cfg.k, -1).amax(dim=1) * 2.0 + 1e-30
        st.ops = torch.zeros_like(st.ops)
        st.rounds = 0
        self._fresh_rebalancer()
        self._resid = float(f_node.abs().sum())
        self._chunks = 0
        self._moves = []
        self._prev_ops = np.zeros(cfg.k, dtype=np.int64)
        return self._resid

    def advance(self, tol: float, round_limit: int) -> None:
        """One chunk + one control-plane pass (engine grain)."""
        eng, ex = self.engine, self.ex
        ex.state, stats = eng.run_chunk(ex.state, *ex.chunk_operands())
        r = stats["r"].cpu().numpy()
        s_ = stats["s"].cpu().numpy()
        self._resid = float(stats["residual"]) + float(s_.sum())
        self._chunks += 1
        if self.verbose:
            print(f"chunk {self._chunks}: residual={self._resid:.3e} "
                  f"rounds={ex.state.rounds} moves={len(self._moves)}")
        if self._resid <= tol:
            return
        self._prev_ops = eng.apply_control_plane(
            ex, r, s_, self._chunks, self._prev_ops, self._moves)

    def x(self) -> np.ndarray:
        return self.engine.extract_solution(self.ex.state,
                                            self.ex.row_of_bucket)

    def residual(self) -> float:
        return self._resid

    def ops(self) -> int:
        return int(self.ex.state.ops.sum())

    def rounds(self) -> int:
        return self.ex.state.rounds

    def chunks(self) -> int:
        return self._chunks

    def exhausted(self) -> bool:
        return self._chunks >= self.cfg.max_chunks

    def move_log(self) -> List[Tuple[int, int, int, int]]:
        return list(self._moves)

    # ---- node-space state (the protocol interop seeds through) ------------
    def fluid(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self.engine.gather_nodes(self.ex.state.f,
                                         self.ex.row_of_bucket),
                self.engine.gather_nodes(self.ex.state.h,
                                         self.ex.row_of_bucket))

    def threshold(self) -> np.ndarray:
        return self.ex.state.t.double().cpu().numpy()

    def set_threshold(self, t: np.ndarray) -> None:
        t = np.asarray(t, dtype=np.float64).reshape(-1)
        if t.shape != (self.cfg.k,):
            return  # saved at a different width: keep the re-derived
            # thresholds (any schedule is a valid D-iteration)
        self.ex.state.t = torch.as_tensor(
            t, device=self.engine.device).to(self.cfg.dtype)


_DRIVERS = {
    "frontier:segment_sum": _SegmentSumDriver,
    "frontier:pallas": _BsrFrontierDriver,
    "engine:chunk": lambda p, o: _EngineDriver(p, o, "segment_sum"),
    "engine:bsr": lambda p, o: _EngineDriver(p, o, "bsr"),
}


# --------------------------------------------------------------------------- #
# the session
# --------------------------------------------------------------------------- #
class SolverSession:
    """A long-lived solver owning the (H, F) fluid state of one Problem.

    ``method`` must be a warm-startable registry backend
    (``frontier:segment_sum``, ``frontier:pallas``, ``engine:chunk``,
    ``engine:bsr`` — see ``repro_torch.api.list_backends()``).  The
    session seeds ``F = B, H = 0`` on construction; ``warm_start``
    re-seeds F for a new RHS while keeping H, resetting the per-phase
    op/round counters so reports measure the *current* solve.
    """

    def __init__(self, problem: Problem,
                 method: str = "frontier:segment_sum",
                 options: Optional[SolverOptions] = None, **kw):
        from .registry import get_backend

        be = get_backend(method)
        if not be.caps.supports_warm_start:
            raise ValueError(
                f"backend {method!r} is one-shot; SolverSession needs a "
                "warm-startable backend "
                "(frontier:segment_sum | frontier:pallas | engine:chunk "
                "| engine:bsr)"
            )
        opts = (SolverOptions(**kw) if options is None
                else dataclasses.replace(options, **kw))
        self.options = opts.validated(be.caps, method)
        self.problem = problem
        self.method = method
        self._driver = _DRIVERS[method](problem, self.options)
        self._driver.seed(problem.b)
        # lifetime §2.3 accounting: phase counters reset on every
        # warm_start, so re-seeds bank them here first
        self._ops_banked = 0
        self._rounds_banked = 0

    # ---- state views ------------------------------------------------------
    @property
    def x(self) -> np.ndarray:
        """Current solution estimate H (node space, float64)."""
        return self._driver.x()

    @property
    def residual(self) -> float:
        return self._driver.residual()

    @property
    def n_ops(self) -> int:
        """Edge pushes charged in the current solve phase (§2.3)."""
        return self._driver.ops()

    @property
    def n_rounds(self) -> int:
        return self._driver.rounds()

    @property
    def lifetime_ops(self) -> int:
        """Edge pushes charged across the session's whole life (§2.3):
        every solve phase since construction, including work banked by
        warm_start re-seeds."""
        return self._ops_banked + self._driver.ops()

    @property
    def lifetime_rounds(self) -> int:
        return self._rounds_banked + self._driver.rounds()

    def _bank_phase(self) -> None:
        """Fold the current phase counters into the lifetime totals —
        call ONLY immediately before a re-seed resets them."""
        self._ops_banked += self._driver.ops()
        self._rounds_banked += self._driver.rounds()

    def _tol(self, until: Optional[float]) -> float:
        te = until if until is not None else self.problem.target_error
        return te * self.problem.eps

    def _check_fresh(self) -> None:
        """Refuse to run over a stale graph snapshot: touching
        ``problem.graph`` raises the store-version mismatch.  Sessions
        that never materialized a store skip the check."""
        if self.problem.store is not None:
            self.problem.graph

    # ---- streaming solve --------------------------------------------------
    def run(self, until: Optional[float] = None,
            max_rounds: Optional[int] = None) -> Iterator[RoundReport]:
        """Drain F toward ``until`` (a target_error), streaming one
        :class:`RoundReport` per trace grain (``options.trace_every``
        frontier rounds / one engine chunk).  The final yielded report is
        the converged (or budget-exhausted) state."""
        self._check_fresh()
        tol = self._tol(until)
        cap = max_rounds if max_rounds is not None else (
            self.options.max_rounds)
        d = self._driver
        while True:
            if d.residual() <= tol or d.rounds() >= cap or d.exhausted():
                yield RoundReport(d.rounds(), d.residual(), d.ops())
                return
            if isinstance(d, _EngineDriver):
                d.advance(tol, cap)
            else:
                d.advance(tol, min(d.rounds() + self.options.trace_every,
                                   cap))
            yield RoundReport(d.rounds(), d.residual(), d.ops())

    def solve(self, until: Optional[float] = None,
              max_rounds: Optional[int] = None) -> SolveReport:
        """Run to convergence and return the unified report."""
        t0 = time.perf_counter()
        trace = list(self.run(until=until, max_rounds=max_rounds))
        d = self._driver
        extras = {"session": True, "device": str(self.options.device)}
        if isinstance(d, _EngineDriver):
            extras["chunks"] = d.chunks()
        return SolveReport(
            x=d.x(),
            residual=d.residual(),
            n_ops=d.ops(),
            cost_iterations=d.ops() / d.l,
            n_rounds=d.rounds(),
            converged=d.residual() <= self._tol(until),
            method=self.method,
            trace=trace,
            move_log=d.move_log(),
            wall_time_s=time.perf_counter() - t0,
            extras=extras,
        )

    # ---- warm start (§2.2 residual identity) ------------------------------
    def warm_start(self, b_new: np.ndarray) -> float:
        """Re-seed for a new RHS, reusing the accumulated history H.

        ``F' = B' − (I−P)·H = B' − H + P·H`` — exactly the residual the
        old H leaves against the new system, so |F'| (returned) is small
        whenever B' is near the RHS H was built for, and the follow-up
        ``run``/``solve`` charges correspondingly few edge pushes.
        Phase counters (ops, rounds, trace) reset to zero after banking
        into the lifetime totals.  Every driver re-seeds on the device:
        only ``b_new`` is uploaded and the scalar |F'|_1 read back.
        """
        self._check_fresh()
        b_new = np.asarray(b_new, dtype=np.float64)
        if b_new.shape != (self.problem.n,):
            raise ValueError(
                f"b_new has shape {b_new.shape}, expected "
                f"({self.problem.n},)"
            )
        self._bank_phase()
        resid = self._driver.warm_seed(b_new)
        self.problem = self.problem.with_b(b_new)
        return resid
