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
* ``solve_batch(B)`` — multi-RHS personalized PageRank: ``[C, N]`` lanes
  with per-lane thresholds and convergence masks over the shared edge
  list, each batched round one launch of K3's lane form.
* ``update_graph(delta)`` — keep (H, F), mutate P: the GraphStore patches
  its views incrementally and the fluid re-seeds via
  ``F' = F + (P'−P)·H``, so a churned graph re-solves warm, not cold.

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

* ``checkpoint(root)`` / ``SolverSession.restore(root, problem)`` —
  atomic node-space checkpoints of ``(B, F, H)`` and the thresholds; a
  restore takes the newest step that passes the §2.2 invariant
  ``B = (I−P)H + F`` (checked in float64 on the host) and rejects torn
  or stale ones.  The float32 state survives the float64 round trip
  exactly, so a restored session replays the rounds and pushes of one
  that never stopped, bit for bit.
* ``rescale(k_new)`` — elastic K on the engine backends: the PID axis
  grows or shrinks mid-solve (a shrink drains through the bucket-move
  executor), H is never recomputed.
* ``run(chaos=injector)`` — a :class:`repro_torch.chaos.SessionInjector`
  fires its plan's events before each grain.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..balance.executors import BucketMoveExecutor
from ..balance.policies import make_rebalancer
from ..balance.signals import LoadSignal
from ..checkpoint import list_steps, load_checkpoint, save_checkpoint
from ..core.diteration import threshold_decay
from ..core.distributed import (
    DistributedEngine,
    EngineConfig,
    build_engine_arrays,
)
from ..graph import GraphDelta, invert_delta
from ..kernels.diffusion import frontier_round_bsr
from ..kernels.edge_sum import csc_edges, edge_sum, edge_sum_lanes
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
# the batched multi-RHS round (shared by solve_batch and repro_torch.serving)
# --------------------------------------------------------------------------- #
def _bucket_width(c: int, floor: int = 1) -> int:
    """Smallest power of two >= max(c, floor): the lane-axis bucket.

    Batched solves pad their lane axis to this width with zero lanes, as
    the reference does to replay one compiled trace per bucket; the port
    keeps the widths (and so the serving event sequences) the same."""
    cp = max(int(floor), 1)
    while cp < c:
        cp *= 2
    return cp


@dataclasses.dataclass(frozen=True)
class BatchEdges:
    """What every batched round reads, on one device: the destination-
    sorted edges of the damped matrix (K3's table), the float32 selection
    weights ``w [N]`` and the §2.3 charge of each node, ``max(out_degree,
    1)`` (a dangling node absorbs and is charged one op)."""

    edges: object  # CscEdges
    w: torch.Tensor
    charge: torch.Tensor  # [N] int32

    @staticmethod
    def of(problem: Problem, device) -> "BatchEdges":
        g = problem.p
        dev = torch.device(device)
        charge = np.maximum(g.out_degree(), 1).astype(np.int32)
        return BatchEdges(_edges_of(problem, dev),
                          _f32(problem.node_weights(), dev),
                          torch.as_tensor(charge, device=dev))


def _round(f, h, t, ops, lane_rounds, active, be: BatchEdges, gamma):
    """One batched frontier round over ``[C, N]`` lanes (the reference's
    ``_batch_fns._round``).  Lanes are independent: a lane that is not
    ``active`` (converged, or a zero padding lane) selects nothing, pushes
    nothing and keeps its threshold; the push is one launch of K3's lane
    form, whose lanes do not see each other.  ``gamma`` is a 0-dim tensor
    on the lanes' device (:func:`threshold_decay`)."""
    sel = ((f.abs() * be.w) > t[:, None]) & active[:, None]
    sent = torch.where(sel, f, torch.zeros_like(f))
    h = h + sent
    f = f - sent
    f = f + edge_sum_lanes(sent, be.edges)
    dops = torch.where(sel, be.charge, 0).sum(dim=1, dtype=torch.int64)
    t = torch.where(sel.any(dim=1) | ~active, t,
                    threshold_decay(t, gamma))
    return f, h, t, ops + dops, lane_rounds + active.to(torch.int64)


def _batch_run(f, h, t, ops, lane_rounds, tol_cols, budget: int,
               be: BatchEdges, gamma):
    """Batched rounds until no lane is above its tolerance or ``budget``
    rounds ran: the reference's ``solve`` / ``tick`` while-loops, as a
    Python loop with one host read a round (the any-lane-active flag).
    Returns ``(f, h, t, ops, lane_rounds, rounds_run)``."""
    rounds = 0
    while rounds < budget:
        active = f.abs().sum(dim=1) > tol_cols
        if not bool(active.any()):
            break
        f, h, t, ops, lane_rounds = _round(f, h, t, ops, lane_rounds,
                                           active, be, gamma)
        rounds += 1
    return f, h, t, ops, lane_rounds, rounds


def _batch_warm(b_col: torch.Tensor, h_col: torch.Tensor, be: BatchEdges):
    """``F' = B' − H + P·H`` (§2.2) for one lane, on the device (K3),
    and its starting threshold."""
    f_col = b_col - h_col + edge_sum(h_col, be.edges)
    return f_col, (f_col * be.w).abs().max() * 2.0


def _batch_place(f, h, t, ops, lane_rounds, lane: int, f_col, h_col,
                 t_col) -> None:
    """Seed lane ``lane`` in place: its fluid pair, threshold, counters."""
    f[lane] = f_col
    h[lane] = h_col
    t[lane] = t_col
    ops[lane] = 0
    lane_rounds[lane] = 0


def _batch_clear(f, h, lane: int) -> None:
    """Zero lane ``lane`` in place: an empty lane is inert."""
    f[lane] = 0.0
    h[lane] = 0.0


def _batch_fns() -> dict:
    """The batched lane kernels by the reference's names: ``solve`` runs
    to convergence, ``tick`` is the continuous-batching micro-step (both
    :func:`_batch_run`, bounded by ``max_rounds`` or the tick budget),
    ``warm`` / ``place`` / ``clear`` are the lane-lifecycle helpers
    :mod:`repro_torch.serving` swaps converged lanes for queued requests
    with.  All lane state is ``[C, N]`` (lane-major)."""
    return {"solve": _batch_run, "tick": _batch_run, "warm": _batch_warm,
            "place": _batch_place, "clear": _batch_clear}


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
        self.gamma = torch.tensor(options.gamma, dtype=torch.float32,
                                  device=self.device)
        self._state = None
        self._batch = None  # BatchEdges, built at the first solve_batch

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

    # ---- batched multi-RHS loop (lanes over columns) ----------------------
    def solve_batch(self, b_matrix: np.ndarray, tol: float,
                    max_rounds: int, pad: bool = True):
        """All columns at once: per-column thresholds + convergence masks.

        Converged columns stop diffusing (their frontier is masked), so
        ops accrue per column exactly as in the single-RHS loop.  The
        lane axis is padded to a pow2 bucket (:func:`_bucket_width`) with
        zero-RHS lanes, which never select and never push: the real lanes
        are *bitwise* unaffected (``pad=False`` keeps the exact width).
        Returns ``(x [N, C], ops [C], rounds, res_cols, stats)``.
        """
        c = b_matrix.shape[1]
        cp = _bucket_width(c) if pad else c
        be = self._batch_edges()
        f0 = torch.zeros((cp, self.n), dtype=torch.float32,
                         device=self.device)
        f0[:c] = _f32(np.ascontiguousarray(b_matrix.T), self.device)
        t0 = (f0 * be.w).abs().amax(dim=1) * 2.0
        tol_cols = torch.full((cp,), tol, dtype=torch.float32,
                              device=self.device)
        zeros = torch.zeros(cp, dtype=torch.int64, device=self.device)
        f, h, _t, ops, _lane_rounds, rounds = _batch_run(
            f0, torch.zeros_like(f0), t0, zeros, zeros.clone(), tol_cols,
            max_rounds, be, self.gamma)
        res_cols = f.abs().sum(dim=1).double().cpu().numpy()[:c]
        stats = {"bucket": cp, "padding_waste": float((cp - c) / cp)}
        return (h[:c].T.double().cpu().numpy(), ops.cpu().numpy()[:c],
                rounds, res_cols, stats)

    def _batch_edges(self) -> BatchEdges:
        """The batched round's operands, sharing this driver's K3 table."""
        if self._batch is None:
            charge = (torch.clamp(self.out_deg, min=1)
                      .to(torch.int32))
            self._batch = BatchEdges(self.edges, self.w, charge)
        return self._batch


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
        self.gamma = torch.tensor(options.gamma, dtype=torch.float32,
                                  device=self.device)
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
            t = torch.where(sel.any(), t, threshold_decay(t, self.gamma))
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
            # explicit option > platform tuned record > default depth 1
            pallas_buffer_depth=resolved_config(
                "bsr_gather_spmm", platform=torch.device(options.device).type,
                buffer_depth=options.buffer_depth)[1],
        )
        # the store's cached engine-layout view
        self.arrays = build_engine_arrays(problem.graph, problem.b,
                                          self.cfg)
        self.engine = DistributedEngine(self.arrays, self.cfg)
        self.problem = problem
        self.options = options
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
        # rescale carry-over: a rescale re-inits the counters at the new
        # width, so phase totals accumulate into host offsets
        self._ops_offset = 0
        self._rounds_offset = 0

    def _fresh_rebalancer(self) -> None:
        if self.engine.rebalancer is not None:
            self.engine.rebalancer = make_rebalancer(
                self.cfg.policy or "slope_ema", k=self.cfg.k,
                target_error=self.cfg.target_error, eta=self.cfg.eta,
                z=self.cfg.z, unit="bucket",
            )

    def _warm_maps(self) -> dict:
        """Node ↔ home-slot maps and the node-space edges (K3), built
        once per layout (a rescale drops them): moves change only the
        bucket → row map, which is read per call."""
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
        self._ops_offset = 0
        self._rounds_offset = 0
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
        return self._ops_offset + int(self.ex.state.ops.sum())

    def rounds(self) -> int:
        return self._rounds_offset + self.ex.state.rounds

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

    # ---- elasticity -------------------------------------------------------
    def note_straggler(self, pid: int, slowdown: float) -> None:
        """Signal-level straggler injection: the control plane sees the
        PID's load inflated by ``slowdown`` (a straggling PID cannot be
        slowed from the host, but the controller's view can — it then
        sheds buckets as in production)."""
        scale = (self.engine.load_scale if self.engine.load_scale
                 is not None else np.ones(self.cfg.k))
        scale = np.asarray(scale, dtype=np.float64).copy()
        scale[pid] = slowdown
        self.engine.load_scale = scale

    def rescale(self, k_new: int,
                strict: bool = False) -> List[Tuple[int, int, int]]:
        """Grow/shrink the PID axis mid-solve (H and F travel in node
        space; a shrink drains through the BucketMoveExecutor path when
        the surviving headroom can absorb it).  The new engine builds its
        K3 edge table or K2 visit table for ``k_new`` on the device from
        the store's cached engine-layout view.  Returns the executed
        drain triples; they are also appended to the move log as
        ``(chunk, src, dst, units)``."""
        if k_new == self.cfg.k:
            return []
        prev_ops, prev_rounds = self.ops(), self.rounds()
        bpd = (_bsr_buckets_per_dev(self.problem.n, k_new, self.options)
               if self.cfg.diffusion_backend == "bsr"
               else self.options.buckets_per_dev)
        old_scale = self.engine.load_scale
        self.engine, self.ex, drains = self.engine.rescale(
            self.ex, k_new, self.problem.graph, self.problem.b,
            buckets_per_dev=bpd, strict=strict)
        if old_scale is not None:
            # surviving stragglers stay stragglers across the rebuild;
            # dropped/grown slots are fresh (healthy) capacity
            scale = np.ones(k_new, dtype=np.float64)
            m = min(k_new, old_scale.shape[0])
            scale[:m] = old_scale[:m]
            self.engine.load_scale = scale
        self.cfg = self.engine.cfg
        self.arrays = self.engine.a
        self._warm = None  # the warm start's maps follow the layout
        for src, dst, moved in drains:
            self._moves.append((self._chunks, src, dst, moved))
        self._prev_ops = np.zeros(k_new, dtype=np.int64)
        self._ops_offset = prev_ops
        self._rounds_offset = prev_rounds
        return drains

    def note_graph_churn(self, churn_per_node: np.ndarray) -> None:
        """Feed edge churn to the balance control plane.

        The controller needs only a per-PID load magnitude, never the
        structure: per-node changed-edge counts are mapped onto the PIDs
        owning them through the current bucket layout and run through one
        rebalancer pass as a ``graph-churn`` :class:`LoadSignal`, so a PID
        absorbing the churn can shed buckets *before* the delta re-solve
        starts.
        """
        eng = self.engine
        if eng.rebalancer is None:
            return
        a = eng.a
        churn = np.asarray(churn_per_node, dtype=np.int64)
        valid = a.node_of_slot >= 0
        rows = np.broadcast_to(np.arange(a.n_rows)[:, None],
                               a.node_of_slot.shape)
        row_churn = np.bincount(rows[valid],
                                weights=churn[a.node_of_slot[valid]],
                                minlength=a.n_rows)
        # the node map lives at each bucket's home row, its data at the
        # row it currently occupies
        cur = np.asarray(self.ex.row_of_bucket, dtype=np.int64)
        dev_churn = np.bincount(
            cur // self.cfg.buckets_per_dev,
            weights=row_churn[np.asarray(a.pos_of_bucket, dtype=np.int64)],
            minlength=self.cfg.k)
        if dev_churn.sum() == 0:
            return
        sig = LoadSignal.from_graph_churn(dev_churn, self.ex.sizes(),
                                          step=self._chunks)
        for plan in eng.rebalancer.propose(sig):
            moved = self.ex.apply(plan)
            if moved:
                self._moves.append((self._chunks, plan.src, plan.dst,
                                    moved))


_DRIVERS = {
    "frontier:segment_sum": _SegmentSumDriver,
    "frontier:pallas": _BsrFrontierDriver,
    "engine:chunk": lambda p, o: _EngineDriver(p, o, "segment_sum"),
    "engine:bsr": lambda p, o: _EngineDriver(p, o, "bsr"),
}


def _invariant_violation(problem: Problem, b: np.ndarray, h: np.ndarray,
                         f: np.ndarray, edges=None) -> float:
    """|B − (I−P)·H − F|_1 against the problem's *current* matrix, in
    float64 on the host.

    Zero (up to accumulation rounding) along any valid D-iteration
    schedule — the checkpoint-integrity oracle: a torn write, a corrupted
    leaf, or a checkpoint taken against a different P all violate it by a
    macroscopic margin.  ``edges`` optionally supplies a pre-materialized
    ``(src, dst, w)`` edge list so repeated checks (restore's candidate
    walk) pay the O(L) materialization once.
    """
    src, dst, w = edges if edges is not None else problem.p.edge_list()
    ph = np.bincount(dst, weights=h[src] * w, minlength=problem.n)
    return float(np.abs(b - h + ph - f).sum())


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
        self._b = np.asarray(problem.b, dtype=np.float64)
        # the frontier:segment_sum driver solve_batch runs on when the
        # session's own method is another (built at first use)
        self._batch_driver: Optional[_SegmentSumDriver] = None
        self._ckpt_step = 0
        self.restored_from: Optional[dict] = None
        # lifetime §2.3 accounting: phase counters reset on every
        # warm_start / update_graph, so re-seeds bank them here first
        # (``lifetime_ops`` is the one rule recovery-cost consumers sum)
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
        every solve phase since construction or restore, including work
        banked by warm_start / update_graph re-seeds."""
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
            max_rounds: Optional[int] = None,
            chaos=None) -> Iterator[RoundReport]:
        """Drain F toward ``until`` (a target_error), streaming one
        :class:`RoundReport` per trace grain (``options.trace_every``
        frontier rounds / one engine chunk).  The final yielded report is
        the converged (or budget-exhausted) state.

        ``chaos`` is an optional :class:`repro_torch.chaos.SessionInjector`:
        its plan's events fire *before* each grain (rounds = grain
        indices, starting at 1).  A ``kill`` event raises
        :class:`repro_torch.chaos.ChaosKill` — recovery is the caller's
        restore + rescale flow."""
        self._check_fresh()
        if chaos is not None:
            chaos.bind(self)
        tol = self._tol(until)
        cap = max_rounds if max_rounds is not None else (
            self.options.max_rounds)
        while True:
            d = self._driver
            if d.residual() <= tol or d.rounds() >= cap or d.exhausted():
                yield RoundReport(d.rounds(), d.residual(), d.ops())
                return
            if chaos is not None:
                chaos.before_grain(self)
                d = self._driver  # chaos may have rebuilt the driver
            if isinstance(d, _EngineDriver):
                d.advance(tol, cap)
            else:
                d.advance(tol, min(d.rounds() + self.options.trace_every,
                                   cap))
            yield RoundReport(d.rounds(), d.residual(), d.ops())

    def solve(self, until: Optional[float] = None,
              max_rounds: Optional[int] = None,
              chaos=None) -> SolveReport:
        """Run to convergence and return the unified report."""
        t0 = time.perf_counter()
        trace = list(self.run(until=until, max_rounds=max_rounds,
                              chaos=chaos))
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
        self._b = b_new
        self.problem = self.problem.with_b(b_new)
        return resid

    # ---- graph delta (the F' = F + (P'−P)·H update) -----------------------
    def _reseed_over(self, store, h: np.ndarray) -> float:
        """Re-snapshot the Problem from ``store``, build a fresh driver
        over its (patched) views and seed ``F = B − H + P·H`` with the
        held H.  Returns |F|_1."""
        self.problem = self.problem.with_graph(store)
        src, dst, w = self.problem.p.edge_list()
        ph = np.bincount(dst, weights=h[src] * w, minlength=self.problem.n)
        f_new = self._b - h + ph
        # the old driver's device tables go before the new ones come: the
        # state is on the host, and an engine's tile pool is tens of GB
        self._driver = None
        self._driver = _DRIVERS[self.method](self.problem, self.options)
        self._driver.seed(f_new, h)
        self._batch_driver = None  # its edge list went stale
        return float(np.abs(f_new).sum())

    def update_graph(self, delta) -> float:
        """Apply edge churn to the Problem's GraphStore and re-seed warm.

        The fluid pair survives matrix drift: ``F' = F + (P'−P)·H``,
        evaluated through the invariant ``F = B − (I−P)·H`` — i.e.
        ``F' = B − H + P'·H`` over the *patched* matrix (float64 on the
        host) — so the cost is the store's dirty-view patch, one O(L)
        product and a fresh driver over the patched views (K1's pool,
        K2's visit table, K3's edge table are rebuilt from them), and the
        follow-up ``run``/``solve`` drains only the churn-injected fluid.
        On engine backends the churn also feeds the balance control plane
        as a ``graph-churn`` LoadSignal.  Phase counters reset (banked
        into the lifetime totals); returns ``|F'|_1``.

        **Transactional**: a malformed delta is rejected before any
        mutation (the inverse delta is captured up front and checks that
        every removed / reweighted edge exists; the splice checks the
        rest); a failure *after* the store mutated (view patch, driver
        rebuild, re-seed) rolls the store back through the inverse delta
        and re-seeds the held state over a fresh driver, so the next
        request serves the pre-delta graph.  The exception re-raises
        either way.
        """
        if not isinstance(delta, GraphDelta):
            raise TypeError(
                f"update_graph wants a GraphDelta, got "
                f"{type(delta).__name__}"
            )
        h = self._driver.x()
        if delta.is_empty:
            return self._driver.residual()
        store = self.problem.graph
        inverse = invert_delta(store, delta)  # raises before any mutation
        self._bank_phase()
        applied = False
        try:
            store.apply_delta(delta)  # patches every materialized view
            applied = True
            resid = self._reseed_over(store, h)
        except Exception:
            if applied:
                store.apply_delta(inverse)
            # even a failed apply_delta may have half patched a view the
            # old driver captured (the store rolled its CSR back and
            # dropped its view cache): rebuild over the restored store
            self._reseed_over(store, h)
            raise
        if isinstance(self._driver, _EngineDriver):
            self._driver.note_graph_churn(
                delta.churn_per_node(self.problem.n))
        return resid

    # ---- elasticity: mid-solve PID rescale --------------------------------
    def rescale(self, k_new: int,
                strict: bool = False) -> List[Tuple[int, int, int]]:
        """Grow/shrink the engine's PID axis mid-solve.

        Shrink drains the dying PIDs' buckets through the
        :class:`~repro_torch.balance.executors.BucketMoveExecutor` path
        (survivors' headroom rows absorb the moves, logged in the move
        log; with insufficient headroom the drain is skipped — or raises
        under ``strict=True``), then the axis is rebuilt at ``k_new`` over
        the store's cached engine-layout view; grow rebuilds directly.
        The accumulated (H, F) fluid pair travels in node space — H is
        never recomputed.  The K PIDs share one device, so ``k_new`` is not
        bounded by the cards present.  Returns the executed drain triples
        ``(src, dst, units)``.
        """
        self._check_fresh()
        d = self._driver
        if not isinstance(d, _EngineDriver):
            raise ValueError(
                f"rescale needs an engine backend (engine:chunk | "
                f"engine:bsr); {self.method!r} has no pid axis"
            )
        d.problem = self.problem  # warm starts may have re-snapshotted
        drains = d.rescale(k_new, strict=strict)
        self.options = dataclasses.replace(self.options, k=k_new)
        return drains

    # ---- fault tolerance: atomic checkpoint / verified restore ------------
    def checkpoint(self, root: str) -> str:
        """Persist the session's fluid state under ``root`` atomically.

        One step directory per call (monotonic step counter, atomic
        ``os.replace`` commit via :mod:`repro_torch.checkpoint.store`):
        node-space ``(B, F, H)`` + thresholds as float64 leaves, plus a
        manifest extra carrying method, counters, the move log, and the
        GraphStore version the state was built against.  Returns the
        committed directory path.
        """
        self._check_fresh()
        d = self._driver
        f, h = d.fluid()
        self._ckpt_step += 1
        tree = {"b": self._b, "f": f, "h": h, "t": d.threshold()}
        extra = {
            "method": self.method,
            "n": self.problem.n,
            "n_edges": self.problem.n_edges,
            "store_version": self.problem.store_version,
            "ops": d.ops(),
            "rounds": d.rounds(),
            "lifetime_ops": self.lifetime_ops,
            "lifetime_rounds": self.lifetime_rounds,
            "residual": d.residual(),
            "move_log": [list(m) for m in d.move_log()],
        }
        return save_checkpoint(root, self._ckpt_step, tree, extra)

    @staticmethod
    def _reject_reason(problem: Problem, b: np.ndarray, f: np.ndarray,
                       h: np.ndarray, extra: dict, rtol: float,
                       edges=None) -> Optional[str]:
        """Why a loaded checkpoint cannot resume against ``problem``
        (None = accept).  The decisive oracle is the §2.2 invariant
        ``B = (I−P)H + F`` evaluated against the problem's CURRENT
        matrix: a torn/corrupted leaf or a checkpoint taken before a
        graph delta both violate it macroscopically."""
        if b.shape != (problem.n,):
            return (f"shape mismatch: checkpoint N={b.shape[0]}, "
                    f"problem N={problem.n}")
        if extra.get("n") not in (None, problem.n):
            return f"stale: checkpoint N={extra['n']} != {problem.n}"
        if extra.get("n_edges") not in (None, problem.n_edges):
            return (f"stale: checkpoint graph had {extra['n_edges']} "
                    f"edges, problem has {problem.n_edges}")
        sv = extra.get("store_version")
        if (sv is not None and problem.store is not None
                and problem.graph.version != sv):
            return (f"stale: GraphStore advanced to version "
                    f"{problem.graph.version}, checkpoint captured {sv}")
        viol = _invariant_violation(problem, b, h, f, edges=edges)
        scale = max(1.0, float(np.abs(b).sum() + np.abs(h).sum()))
        if viol > rtol * scale:
            return (f"invariant violated: |B−(I−P)H−F|₁ = {viol:.3e} > "
                    f"{rtol * scale:.3e} (torn or stale checkpoint)")
        return None

    @classmethod
    def restore(cls, root: str, problem: Problem,
                method: Optional[str] = None,
                options: Optional[SolverOptions] = None,
                step: Optional[int] = None,
                invariant_rtol: float = 1e-4, **kw) -> "SolverSession":
        """Resume a session from the newest checkpoint that *verifies*.

        Every candidate step (newest first; exactly ``step`` when given)
        is loaded and checked — ``B − (I−P)H − F ≈ 0`` against
        ``problem``'s current matrix, N/edge-count/store-version
        agreement — and a failing checkpoint is **rejected rather than
        silently resumed**, falling back to the next older complete step.
        Raises with the per-step rejection reasons when nothing survives.
        The restored session keeps the checkpoint's RHS
        (``problem.with_b``), re-seeds ``(F, H)`` and then the thresholds
        (the float32 state comes back exactly from its float64 leaves),
        and records provenance in ``session.restored_from``.
        """
        steps = list_steps(root)
        # adversarial directories: step-like dirs that list_steps refused
        # (torn manifest mid-write, permission-denied, unparsable JSON)
        # surface as rejection provenance instead of disappearing silently
        rejected: List[Tuple[int, str]] = []
        complete = {f"step_{s:09d}" for s in steps}
        try:
            entries = sorted(os.listdir(root))
        except OSError:
            entries = []
        for name in entries:
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and name not in complete):
                try:
                    s_bad = int(name.split("_", 1)[1])
                except ValueError:
                    s_bad = -1
                rejected.append(
                    (s_bad, "incomplete or unreadable manifest"))
        if step is not None:
            if step not in steps:
                raise FileNotFoundError(
                    f"no complete checkpoint for step {step} under {root}"
                )
            candidates = [step]
        else:
            candidates = steps[::-1]
        if not candidates:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
        tree_like = {
            "b": np.zeros(problem.n), "f": np.zeros(problem.n),
            "h": np.zeros(problem.n), "t": np.zeros(()),
        }
        edges = problem.p.edge_list()  # once, not per candidate (O(L))
        for s in candidates:
            try:
                tree, _, extra = load_checkpoint(root, tree_like, s)
            except Exception as e:  # noqa: BLE001 - provenance, not fatal
                rejected.append((s, f"unreadable: {e}"))
                continue
            b, f, h = tree["b"], tree["f"], tree["h"]
            reason = cls._reject_reason(problem, b, f, h, extra,
                                        invariant_rtol, edges=edges)
            if reason is not None:
                rejected.append((s, reason))
                continue
            session = cls(problem.with_b(b),
                          method=method or extra["method"],
                          options=options, **kw)
            session._driver.seed(f, h)
            session._driver.set_threshold(tree["t"])
            session._ckpt_step = s
            session.restored_from = {
                "step": s,
                "ops": extra.get("ops", 0),
                "rounds": extra.get("rounds", 0),
                "lifetime_ops": extra.get("lifetime_ops",
                                          extra.get("ops", 0)),
                "move_log": [tuple(m) for m in extra.get("move_log", [])],
                "rejected": rejected,
            }
            return session
        detail = "; ".join(f"step {s}: {r}" for s, r in rejected)
        raise ValueError(f"no valid checkpoint under {root}: {detail}")

    # ---- batched multi-RHS ------------------------------------------------
    def solve_batch(self, b_matrix: np.ndarray,
                    until: Optional[float] = None,
                    pad: bool = True) -> SolveReport:
        """Solve every column of ``b_matrix`` ([N, C]) over the shared P.

        Runs the batched frontier loop (per-column thresholds and
        convergence masks, K3's lane form) whatever the session's method:
        the batch serving path is frontier-native by design.  The
        session's own (H, F) state is untouched.  The lane axis is padded
        to a pow2 bucket (``pad=False`` opts out); the padding
        bookkeeping lands in ``extras`` (``bucket``, ``padding_waste``).
        """
        self._check_fresh()
        b_matrix = np.asarray(b_matrix, dtype=np.float64)
        if b_matrix.ndim != 2 or b_matrix.shape[0] != self.problem.n:
            raise ValueError(
                f"b_matrix must be [N, C] with N={self.problem.n}, got "
                f"{b_matrix.shape}"
            )
        if isinstance(self._driver, _SegmentSumDriver):
            batch_driver = self._driver
        else:
            if self._batch_driver is None:
                self._batch_driver = _SegmentSumDriver(self.problem,
                                                       self.options)
            batch_driver = self._batch_driver
        t0 = time.perf_counter()
        tol = self._tol(until)
        x, ops, rounds, res_cols, stats = batch_driver.solve_batch(
            b_matrix, _tol32(tol), self.options.max_rounds, pad=pad)
        n_ops = int(ops.astype(np.int64).sum())
        return SolveReport(
            x=x,
            residual=float(res_cols.max()),
            n_ops=n_ops,
            cost_iterations=n_ops / max(self.problem.n_edges, 1),
            n_rounds=rounds,
            converged=bool((res_cols <= tol).all()),
            method="frontier:segment_sum",
            trace=[RoundReport(rounds, float(res_cols.max()), n_ops)],
            wall_time_s=time.perf_counter() - t0,
            extras={"batch": b_matrix.shape[1],
                    "bucket": stats["bucket"],
                    "padding_waste": stats["padding_waste"],
                    "ops_per_column": ops.tolist(),
                    "residual_per_column": res_cols.tolist(),
                    "device": str(self.options.device)},
        )
