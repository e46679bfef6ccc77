"""In-flight (continuous) batching over the batched frontier round.

The lane axis of the ``[C, N]`` batch state is a set of *slots*, not a
batch: each lane carries one request's fluid pair ``(F, H)`` plus its
own threshold, tolerance, and §2.3 op counter.  ``micro()`` advances
every occupied lane a bounded number of frontier rounds (each round one
launch of K3's lane form over all lanes); a lane whose residual
certificate clears its tolerance retires *individually* — its H column
leaves for the session pool, the lane zeroes, and a queued request is
placed into it on the next tick while the other lanes keep diffusing.
That is the continuous-batching loop with convergence playing the role
of end-of-sequence.

The lane axis only ever *doubles* (pow2 growth up to ``max_lanes``), as
in the reference, whose traces it bounds; the port keeps the same widths
so that the lane schedule, and with it every event of a serving run, is
the reference's.  The round is :func:`repro_torch.api.session._batch_fns`
— the very one ``SolverSession.solve_batch`` runs: the serving tier adds
lifecycle, not arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.session import BatchEdges, _batch_fns, _bucket_width

from .queue import Request

__all__ = ["ContinuousBatcher", "LaneInfo", "MicroReport", "RetiredLane"]


@dataclasses.dataclass
class LaneInfo:
    """Host-side view of one occupied lane."""

    request: Request
    admitted_t: float
    pool_hit: bool
    tol: float
    until_eff: float
    round_cap: Optional[int] = None
    rung: str = "nominal"


@dataclasses.dataclass
class RetiredLane:
    """One request leaving its lane (converged or round-capped)."""

    info: LaneInfo
    x: np.ndarray          # served solution (host, float64)
    h_dev: torch.Tensor    # the lane's H column, still on the device
    residual: float
    ops: int
    rounds: int
    degraded: bool         # round_cap struck before the certificate


@dataclasses.dataclass
class MicroReport:
    """What one ``micro()`` call did."""

    rounds_run: int
    ops_delta: int
    retired: List[RetiredLane]
    occupied: int          # lanes busy during this call
    width: int             # current pow2 lane-axis width
    active_after: int      # lanes still unconverged


class ContinuousBatcher:
    """Slot-level batch state + lifecycle over one graph snapshot.

    The state lives on ``device`` (``"cuda"`` unless the caller asks for
    the CPU): ``f``, ``h`` ``[W, N]`` float32, ``t`` ``[W]`` float32,
    ``ops`` and ``lane_rounds`` ``[W]`` int64.
    """

    def __init__(self, problem, gamma: float = 1.2, max_lanes: int = 64,
                 min_lanes: int = 4, device="cuda"):
        if max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        self.gamma = float(gamma)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device; "
                               "pass device='cpu' to serve on the CPU")
        self._gamma = torch.tensor(self.gamma, dtype=torch.float32,
                                   device=self.device)
        self.max_lanes = _bucket_width(max_lanes)
        self.min_lanes = min(_bucket_width(min_lanes), self.max_lanes)
        self.graph_switches = 0
        self._bind(problem)
        # lifetime accounting (occupancy + padding)
        self.ticks = 0
        self.rounds_total = 0
        self.ops_total = 0
        self.lane_rounds_total = 0   # occupied-lane rounds actually used
        self.width_rounds_total = 0  # lane-axis slots paid for
        self.retired_total = 0

    # ------------------------------------------------------------------ #
    # state plumbing
    # ------------------------------------------------------------------ #
    def _bind(self, problem) -> None:
        """(Re)build the device edge table + empty lane state for
        ``problem``'s current graph snapshot."""
        self.problem = problem
        self.n = problem.n
        self.be = BatchEdges.of(problem, self.device)
        self.width = self.min_lanes
        self.lanes: List[Optional[LaneInfo]] = [None] * self.width
        self.f = torch.zeros((self.width, self.n), dtype=torch.float32,
                             device=self.device)
        self.h = torch.zeros_like(self.f)
        self.t = torch.zeros(self.width, dtype=torch.float32,
                             device=self.device)
        self.ops = torch.zeros(self.width, dtype=torch.int64,
                               device=self.device)
        self.lane_rounds = torch.zeros_like(self.ops)
        self._tol_cols = np.zeros(self.width, dtype=np.float64)
        self._ops_host = np.zeros(self.width, dtype=np.int64)

    def _grow(self) -> None:
        new = min(self.width * 2, self.max_lanes)
        if new == self.width:
            return
        pad = new - self.width

        def grown(x: torch.Tensor) -> torch.Tensor:
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

        self.f, self.h = grown(self.f), grown(self.h)
        self.t, self.ops = grown(self.t), grown(self.ops)
        self.lane_rounds = grown(self.lane_rounds)
        self.lanes.extend([None] * pad)
        self._tol_cols = np.concatenate([self._tol_cols, np.zeros(pad)])
        self._ops_host = np.concatenate(
            [self._ops_host, np.zeros(pad, dtype=np.int64)])
        self.width = new

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    @property
    def occupied(self) -> int:
        return sum(1 for la in self.lanes if la is not None)

    @property
    def has_capacity(self) -> bool:
        return (any(la is None for la in self.lanes)
                or self.width < self.max_lanes)

    def free_lane(self) -> Optional[int]:
        for i, la in enumerate(self.lanes):
            if la is None:
                return i
        if self.width < self.max_lanes:
            prev = self.width
            self._grow()
            return prev
        return None

    def admit(self, req: Request, now: float, tol: float,
              until_eff: float, h_seed=None,
              round_cap: Optional[int] = None,
              rung: str = "nominal") -> Optional[int]:
        """Place ``req`` into a free lane (growing the pow2 width if
        needed).  ``h_seed`` is a pooled device H column — the §2.2 warm
        start runs on the device either way (``h_seed=None`` seeds H=0,
        which degenerates to the cold path F=B).  Returns the lane index,
        or None when saturated at ``max_lanes``."""
        lane = self.free_lane()
        if lane is None:
            return None
        b_col = torch.as_tensor(np.asarray(req.b), dtype=torch.float32,
                                device=self.device)
        h_col = (torch.zeros(self.n, dtype=torch.float32, device=self.device)
                 if h_seed is None else h_seed)
        fns = _batch_fns()
        f_col, t_col = fns["warm"](b_col, h_col, self.be)
        fns["place"](self.f, self.h, self.t, self.ops, self.lane_rounds,
                     lane, f_col, h_col, t_col)
        self._tol_cols[lane] = tol
        self._ops_host[lane] = 0
        self.lanes[lane] = LaneInfo(
            request=req, admitted_t=now, pool_hit=h_seed is not None,
            tol=float(tol), until_eff=float(until_eff),
            round_cap=round_cap, rung=rung)
        return lane

    def micro(self, budget: int) -> MicroReport:
        """One continuous-batching micro-step: up to ``budget`` frontier
        rounds for every active lane, then per-lane retirement checks."""
        occupied = self.occupied
        if occupied == 0:
            return MicroReport(0, 0, [], 0, self.width, 0)
        fns = _batch_fns()
        tol_dev = torch.as_tensor(self._tol_cols, dtype=torch.float32,
                                  device=self.device)
        ops_before = int(self._ops_host.sum())
        (self.f, self.h, self.t, self.ops, self.lane_rounds,
         rounds_run) = fns["tick"](
            self.f, self.h, self.t, self.ops, self.lane_rounds, tol_dev,
            budget, self.be, self._gamma)
        resid = self.f.abs().sum(dim=1).double().cpu().numpy()
        self._ops_host = self.ops.cpu().numpy()
        lane_rounds = self.lane_rounds.cpu().numpy()
        ops_delta = int(self._ops_host.sum()) - ops_before

        retired: List[RetiredLane] = []
        active_after = 0
        for lane, info in enumerate(self.lanes):
            if info is None:
                continue
            converged = resid[lane] <= self._tol_cols[lane]
            capped = (info.round_cap is not None
                      and lane_rounds[lane] >= info.round_cap)
            if not (converged or capped):
                active_after += 1
                continue
            h_dev = self.h[lane].clone()  # the lane is zeroed in place below
            retired.append(RetiredLane(
                info=info,
                x=h_dev.double().cpu().numpy(),
                h_dev=h_dev,
                residual=float(resid[lane]),
                ops=int(self._ops_host[lane]),
                rounds=int(lane_rounds[lane]),
                degraded=bool(capped and not converged),
            ))
            fns["clear"](self.f, self.h, lane)
            self.lanes[lane] = None
            self._tol_cols[lane] = 0.0

        self.ticks += 1
        self.rounds_total += rounds_run
        self.ops_total += ops_delta
        self.lane_rounds_total += occupied * rounds_run
        self.width_rounds_total += self.width * rounds_run
        self.retired_total += len(retired)
        return MicroReport(rounds_run, ops_delta, retired, occupied,
                           self.width, active_after)

    def graph_switched(self, problem) -> None:
        """Rebind to a patched graph snapshot.  Only legal at a drain
        barrier — in-flight fluid was diffused through the old P and its
        §2.3 accounting would silently go stale."""
        if self.occupied:
            raise RuntimeError(
                f"graph_switched with {self.occupied} lanes in flight; "
                "drain first")
        self.graph_switches += 1
        self._bind(problem)

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    @property
    def mean_occupancy(self) -> float:
        """Occupied-lane fraction of the lane-axis slots actually paid
        for across all executed rounds (the padding-waste complement)."""
        return (self.lane_rounds_total / self.width_rounds_total
                if self.width_rounds_total else 0.0)

    def to_jsonable(self) -> Dict:
        return {"width": self.width, "max_lanes": self.max_lanes,
                "occupied": self.occupied, "ticks": self.ticks,
                "rounds_total": self.rounds_total,
                "ops_total": self.ops_total,
                "retired_total": self.retired_total,
                "mean_occupancy": round(self.mean_occupancy, 4),
                "graph_switches": self.graph_switches}
