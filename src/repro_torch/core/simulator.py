"""Time-stepped K-PID simulator of the distributed D-iteration on one torch
device (the port of ``repro.core.simulator``).

Implements the paper's §2.2–§2.5 as the reference does, step for step:

* K virtual machines (PIDs); PID_k owns the node set Ω_k and the column block
  C_k(P).  Per time step each PID executes ``PID_Speed = N/K`` elementary
  operations (§2.3).
* Local diffusion pushes fluid only to children INSIDE Ω_k; fluid destined
  to other PIDs accumulates in PID_k's outbox and is delivered at
  fluid-exchange time (§2.2.1–2.2.2).
* Threshold schedule: diffuse node i when ``|F_i|·w_i > T_k`` (cyclic sweep);
  if a full sweep finds nothing, ``T_k := T_k/γ`` (γ = 1.2).  Default weight
  ``w_i = 1/#out_i``.
* Exchange trigger ``s_k > r_k/2`` (eq. 1); receivers re-seed
  ``T_k' := min(T_k'·(r_k'+received)/r_k', received)``.
* Idle rule ``r_k < max(s_k/10, target_error·ε/K/10)``; unused budget goes to
  ``count_idle`` (§2.2.1, §2.3).
* Cost accounting (§2.4): one op per local edge push (min 1 per diffusion);
  at exchange the sender is charged one op per (dirty node × remote edge),
  the receiver one op per node update received; a reassignment charges the
  number of moved nodes to both PIDs.  Costs can exceed the per-step budget:
  the PID is then "frozen" (debt carried into following steps).
* Dynamic partition (§2.5.2): a :mod:`repro_torch.balance` policy (default
  ``SlopeEMAPolicy``) runs every time step on the per-PID residual signal
  and its ``MovePlan``\\ s are executed by the node-granular
  :class:`~repro_torch.balance.executors.NodeMoveExecutor`.

Two schedule modes: ``"sequential"`` (paper-exact: nodes within a sweep
diffuse one at a time, later diffusions see earlier pushes) and ``"batch"``
(every eligible node of a sweep, up to the budget, diffuses against the
start-of-sweep fluid).  Cost accounting is identical per edge.

What lives where.  The node-length state is on the simulator's device as
tensors: the fluid ``f`` and the ``[K, N]`` outboxes (views of one buffer),
the solution ``h``, the owner map, the dirty flags, the weights and the
CSR.  The node sets are int64 tensors there too.  The reference's
``touched`` lists are not kept: an outbox entry is nonzero only if a push
touched it since the last exchange, so the exchange's ``np.unique`` of
them, less the zero entries, is the outbox's nonzero indices in ascending
order.  The per-PID control scalars (``t_k``, ``debt``, the counters) stay
host float64 / int64, so their arithmetic is the reference's; ``s_k`` is
added to on the device, in push order, and read with the rest.

The batch schedule runs the PIDs' local steps of a time step side by side
(they touch disjoint fluid and outboxes): a round is one sweep of every
PID that still has budget (:class:`_Sweep`, a CUDA graph on the card), one
read of the device (two when a threshold decayed), and one K7 push for
all of them.

The push — the reference's messages and its ``np.add.at`` into ``f`` and
into the outbox — is K7 (:mod:`repro_torch.kernels.sim_push`:
``sim_messages``, then ``sim_push``): in message order per destination,
with no float atomics, so a run on the card replays bit for bit and ``h`` gets
``np.add.at``'s bits for the same schedule.  The sums the
schedule reads (``r_k``, ``s_k``, the residual) are ``torch.sum``:
deterministic, but not numpy's pairwise order, so they may differ from the
reference's in the last bits; a decision that sits on such a tie could go
the other way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..balance.executors import NodeMoveExecutor
# the module, not its names: balance.policies imports core.partition, whose
# package imports this module, so its names may not exist yet here
from ..balance import policies as _policies
from ..balance.signals import LoadSignal
from ..kernels.sim_push import sim_messages, sim_push
from .diteration import default_weights
from .partition import cb_partition, uniform_partition

__all__ = [
    "SimulatorConfig",
    "SimResult",
    "DistributedSimulator",
    "run_cost_experiment",
]

GAMMA = 1.2


def _device(device) -> torch.device:
    """``device`` as a torch device; ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch sees no CUDA device; pass "
            "device='cpu' to run the simulator on the CPU")
    return dev


@dataclasses.dataclass
class SimulatorConfig:
    k: int
    target_error: float
    eps: float  # ε: 1 - damping for PageRank systems (§2.2.1)
    partition: str = "uniform"  # uniform | cb
    dynamic: bool = False  # enable §2.5.2 controller (slope_ema policy)
    policy: Optional[str] = None  # repro_torch.balance policy name
    # (overrides ``dynamic``): slope_ema | cost_refresh | hysteresis
    signal: str = "residual"  # rebalancing signal: residual | edge-ops
    mode: str = "sequential"  # sequential | batch
    weight_mode: str = "inv_out"  # w_i choice (§2.2.1)
    gamma: float = GAMMA
    eta: float = 0.5  # slope EMA factor
    z: int = 10  # reassignment cooldown
    pid_speed: Optional[int] = None  # default N/K
    max_steps: int = 2_000_000
    record_every: int = 1  # metric recording stride (time steps)
    charge_exchange: bool = True  # False reproduces the *neglected-cost* mode
    seed: int = 0
    device: str = "cuda"  # torch device of the state; never falls back

    def __post_init__(self):
        _device(self.device)


@dataclasses.dataclass
class SimResult:
    h: torch.Tensor  # [N] float64 solution estimate, on the simulator's device
    converged: bool
    n_steps: int  # wall time steps
    cost_iterations: float  # n_steps * PID_Speed / L   (paper's table metric)
    count_active: np.ndarray  # [K]
    count_idle: np.ndarray  # [K]
    n_exchanges: int
    n_moves: int  # dynamic reassignment events
    residual: float  # |F|_1 + in-flight at exit
    # histories, sampled every record_every steps:
    hist_steps: np.ndarray  # [T] wall step index
    hist_rs: np.ndarray  # [T, K]  r_k + s_k
    hist_sizes: np.ndarray  # [T, K] |Ω_k|
    hist_residual: np.ndarray  # [T] global residual upper bound
    # executed rebalancing decisions: (time step, src, dst, units moved)
    move_log: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    # unified §2.3 edge-push accounting (``max(out_degree, 1)`` per
    # diffusion) — the cross-backend ``SolveReport.n_ops`` field
    n_edge_ops: int = 0
    hist_edge_ops: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )
    # chaos events fired during the run: (step, kind)
    chaos_log: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list
    )
    # diffusions with at least one out-edge: each one is one K7 push
    n_pushes: int = 0

    @property
    def cost_per_pid(self) -> np.ndarray:
        return (self.count_active + self.count_idle) / max(
            1, self.count_active.shape[0]
        )


def _pad_hist(rows: List[np.ndarray], dtype=np.float64) -> np.ndarray:
    """Stack per-step [K] records whose K may have changed mid-run
    (chaos rescale): right-pad each row with zeros to the widest K."""
    if not rows:
        return np.zeros((0, 0), dtype=dtype)
    width = max(r.shape[0] for r in rows)
    out = np.zeros((len(rows), width), dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


@dataclasses.dataclass
class _Layout:
    """The node sets as the rows of a ``[K, L]`` table (L at least the
    largest set; a row's tail pads with the spare node N, whose fluid is
    0), with the per-node operands of a sweep in that shape (refilled
    when the sets change)."""

    sets: List[torch.Tensor]  # the sets it was built from
    idx: torch.Tensor  # [K, L] int64 node at each slot, N in the padding
    w: torch.Tensor  # [K, L] float64 selection weight (0 in the padding)
    deg: torch.Tensor  # [K, L] int64 out-degree (0 in the padding)
    cost: torch.Tensor  # [K, L] int64 max(out-degree, 1)
    dangling: torch.Tensor  # [K, L] bool out-degree 0 (not the padding)
    ldeg: torch.Tensor  # [K, L] int64 out-edges to the node's own PID
    rdeg: torch.Tensor  # [K, L] int64 out-edges to other PIDs
    ldeg_node: torch.Tensor  # [N] int64 ldeg by node id
    sweep: Optional["_Sweep"] = None  # built at the first batch round


class _Sweep:
    """The batch schedule's sweep of every PID at once, on one layout:
    |F| and |F|·w in the layout's shape, each PID's r_k and max |F_i|·w_i,
    its eligible nodes (over ``T_k``) and the budget-limited prefix of them
    that diffuses (``take``: every eligible node whose eligible
    predecessors in its PID cost less than ``ceil(budget_k)``, the
    reference's ``elig[:searchsorted(cumsum(max(deg, 1)), budget) + 1]``),
    and that prefix's counts.  ``T_k`` and the ceilings are operands at
    fixed addresses; on the card the whole sweep is captured once in a
    CUDA graph and replayed each round (one launch for some thirty
    kernels), elsewhere it runs eagerly.  The kernels are the same either
    way, so are the bits."""

    def __init__(self, sim: "DistributedSimulator", lay: _Layout):
        self.sim, self.lay = sim, lay
        self.state = sim._state  # the buffer a captured sweep reads
        self.t = torch.zeros(sim.k, dtype=torch.float64, device=sim.device)
        self.ceil = torch.zeros_like(self.t)  # 0: the PID does not select
        self.graph = None
        if sim.device.type == "cuda":
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._compute()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._compute()

    def _compute(self) -> None:
        lay, sim = self.lay, self.sim
        fa, fw = sim._fluid(lay)
        elig = fw > self.t[:, None]
        lens = torch.where(elig, lay.cost, 0)
        # one scan over the rows laid end to end, less each row's base
        excl = torch.cumsum(lens.view(-1), 0).view(lens.shape) - lens
        take = elig & (excl - excl[:, :1] < self.ceil[:, None])
        fresh = take & ~torch.take(sim._dirty, lay.idx)
        # per PID, among take: nodes, out-edges, dangling nodes, local
        # out-edges, remote out-edges of nodes not dirty yet
        stats = torch.stack([
            take.sum(1), torch.where(take, lay.deg, 0).sum(1),
            (take & lay.dangling).sum(1),
            torch.where(take, lay.ldeg, 0).sum(1),
            torch.where(fresh, lay.rdeg, 0).sum(1)])
        self.take = take
        # [K] r_k, [K] max |F_i|·w_i, [5·K] the counts
        self.out = torch.cat([sim._r(fa), fw.amax(1),
                              stats.view(-1).double()])

    def __call__(self, ceil: List[int]) -> None:
        """The sweep under the simulator's current ``T_k`` and the
        ceilings ``ceil``: ``take`` and ``out`` hold it."""
        sim = self.sim
        self.t.copy_(sim._pinned(sim.t_k), non_blocking=True)
        self.ceil.copy_(sim._pinned(ceil), non_blocking=True)
        if self.graph is None:
            self._compute()
        else:
            self.graph.replay()


class DistributedSimulator:
    """Time-stepped simulation of K PIDs running the D-iteration on (P, B),
    with its state on ``cfg.device``.

    ``g`` is a CSR view (``indptr``, ``indices``, ``weights``, ``n``) or a
    GraphStore, whose ``csr()`` is read.  ``rebalancer`` injects any
    :class:`repro_torch.balance.policies.Rebalancer`; when omitted it is
    built from ``cfg.policy`` (or ``cfg.dynamic``, which means the
    paper-exact ``slope_ema``).
    """

    def __init__(self, g, b, cfg: SimulatorConfig,
                 rebalancer: Optional[_policies.Rebalancer] = None):
        if hasattr(g, "csr"):
            g = g.csr()
        if cfg.signal not in ("residual", "edge-ops"):
            raise ValueError(
                f"unknown rebalancing signal {cfg.signal!r}; expected "
                "'residual' or 'edge-ops'"
            )
        self.g = g
        self.cfg = cfg
        dev = self.device = _device(cfg.device)
        n, k = g.n, cfg.k
        self.n, self.k = n, k
        self.n_edges = int(g.indices.shape[0])
        self.speed = cfg.pid_speed or max(1, n // k)
        weights = default_weights(g, cfg.weight_mode)
        self._w_host = np.asarray(weights, dtype=np.float64)
        self.weights = torch.as_tensor(self._w_host, device=dev)
        self._indptr_host = np.asarray(g.indptr, dtype=np.int64)
        self.indptr = torch.as_tensor(self._indptr_host, device=dev)
        self.indices = torch.as_tensor(
            np.asarray(g.indices, dtype=np.int64), device=dev)
        self.edge_w = torch.as_tensor(
            np.asarray(g.weights, dtype=np.float64), device=dev)
        self.deg = self.indptr[1:] - self.indptr[:-1]
        self._nodes = torch.arange(n, device=dev)
        self._src_of_edge = torch.repeat_interleave(
            self._nodes, self.deg, output_size=self.n_edges)

        # --- partition state -------------------------------------------------
        if cfg.partition == "uniform":
            self.sets: List[torch.Tensor] = uniform_partition(n, k, dev)
        elif cfg.partition == "cb":
            self.sets = cb_partition(np.diff(self._indptr_host), k, dev)
        else:
            raise ValueError(f"unknown partition {cfg.partition!r}")
        self.owner = torch.empty(n, dtype=torch.int32, device=dev)
        for i, s in enumerate(self.sets):
            self.owner[s] = i
        self._lay: Optional[_Layout] = None

        # --- fluid state ------------------------------------------------------
        self.h = torch.zeros(n, dtype=torch.float64, device=dev)
        self._alloc_state(torch.as_tensor(np.asarray(b, dtype=np.float64),
                                          device=dev))
        # node diffused since the last exchange (a spare False at N)
        self._dirty = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        self.dirty = self._dirty[:n]
        self.pending_send_cost = np.zeros(k, dtype=np.int64)

        # --- scheduling state -------------------------------------------------
        self.t_k = self._seed_thresholds()
        self.debt = np.zeros(k, dtype=np.float64)  # frozen-PID carryover
        # chaos state: per-PID speed multiplier (1 = healthy,
        # 1/slowdown = straggler, 0 = dead)
        self.speed_factor = np.ones(k, dtype=np.float64)
        self.chaos_log: List[Tuple[int, str]] = []

        # --- counters ---------------------------------------------------------
        self.count_active = np.zeros(k, dtype=np.int64)
        self.count_idle = np.zeros(k, dtype=np.int64)
        self.n_edge_ops = 0  # locality-blind §2.3 edge pushes (SolveReport)
        self.n_exchanges = 0
        self.n_moves = 0
        self.n_pushes = 0  # K7 pushes

        # --- rebalancing control plane ---------------------------------------
        self._rebalancer_injected = rebalancer is not None
        if rebalancer is not None:
            self.rebalancer: Optional[_policies.Rebalancer] = rebalancer
        elif cfg.policy or cfg.dynamic:
            self.rebalancer = _policies.make_rebalancer(
                cfg.policy or "slope_ema", k=k,
                target_error=cfg.target_error, eta=cfg.eta, z=cfg.z,
                unit="node",
            )
        else:
            self.rebalancer = None
        self.executor = NodeMoveExecutor(self)
        self.move_log: List[Tuple[int, int, int, int]] = []
        self._prev_active = np.zeros(k, dtype=np.int64)

        self.tol = cfg.target_error * cfg.eps

    def _alloc_state(self, f: torch.Tensor) -> None:
        """The fluid and the K outboxes as views of one buffer, what K7
        pushes into: node d's fluid at d, a spare 0 at N (the padding of
        the layout reads it), PID k's outbox entry for d at N + 1 + k·N +
        d; and ``s_k``."""
        n, k, dev = self.n, self.k, self.device
        if (k + 1) * n + 1 >= 2**31:
            raise ValueError(f"K={k} PIDs over N={n} nodes: K7's keys into "
                             "the state buffer are int32")
        self._pids = torch.arange(k, device=dev)
        self._state = torch.zeros((k + 1) * n + 1, dtype=torch.float64,
                                  device=dev)
        self._state[:n] = f
        self.f = self._state[:n]
        self.outbox = self._state[n + 1:].view(k, n)
        self._touched_any = [False] * k  # a remote push since the exchange
        # |outbox_k|_1: added to on the device, in push order; ``s_abs`` is
        # its host copy as of the last read
        self._s_abs = torch.zeros(k, dtype=torch.float64, device=dev)
        self.s_abs = np.zeros(k, dtype=np.float64)

    def _seed_thresholds(self) -> np.ndarray:
        """T_k := 2·max_{i∈Ω_k} |F_i|·w_i (1 for an empty set), + 1e-300."""
        t0 = self.f.abs() * self.weights
        maxes = [t0[s].max() for s in self.sets if s.numel()]
        it = iter(torch.stack(maxes).tolist() if maxes else [])
        return np.array([(next(it) * 2.0 if s.numel() else 1.0) + 1e-300
                         for s in self.sets])

    def _layout(self) -> _Layout:
        """The layout of the current sets.  When a move, a kill or a
        rescale replaced them (a set is recognised by identity: the layout
        keeps the tensors it was built from) it is refilled in place, so
        that a captured sweep stays valid, unless the sets outgrew its
        width or K changed: then it is rebuilt, 25 % wider than the
        largest set."""
        lay = self._lay
        if (lay is not None and len(lay.sets) == len(self.sets)
                and all(a is b for a, b in zip(lay.sets, self.sets))):
            return lay
        dev, n = self.device, self.n
        # out-edges that stay in the node's own PID: a prefix count over
        # the CSR, differenced at the row bounds
        same = torch.zeros(self.n_edges + 1, dtype=torch.int64, device=dev)
        torch.cumsum(self.owner[self.indices] == self.owner[self._src_of_edge],
                     0, out=same[1:])
        ldeg = same[self.indptr[1:]] - same[self.indptr[:-1]]
        width = max(max(s.numel() for s in self.sets), 1)
        if (lay is None or lay.idx.shape[0] != self.k
                or lay.idx.shape[1] < width):
            shape = (self.k, width + width // 4)

            def empty(dtype):
                return torch.empty(shape, dtype=dtype, device=dev)

            lay = self._lay = _Layout(
                sets=[], idx=empty(torch.int64), w=empty(torch.float64),
                deg=empty(torch.int64), cost=empty(torch.int64),
                dangling=empty(torch.bool), ldeg=empty(torch.int64),
                rdeg=empty(torch.int64), ldeg_node=ldeg)
        lay.sets, lay.ldeg_node = list(self.sets), ldeg
        lay.idx.fill_(n)
        for k, s in enumerate(self.sets):
            lay.idx[k, : s.numel()] = s
        for out, x, pad in ((lay.w, self.weights, 0.0),
                            (lay.deg, self.deg, 0),
                            (lay.dangling, self.deg == 0, False),
                            (lay.ldeg, ldeg, 0),
                            (lay.rdeg, self.deg - ldeg, 0)):
            # a node-indexed operand in the layout's shape, 0 in the padding
            out.copy_(torch.cat([x, torch.full((1,), pad, dtype=x.dtype,
                                                device=dev)])[lay.idx])
        torch.clamp(lay.deg, min=1, out=lay.cost)
        return lay

    # --------------------------------------------------------------------- #
    # local quantities
    # --------------------------------------------------------------------- #
    def _fluid(self, lay: _Layout) -> Tuple[torch.Tensor, torch.Tensor]:
        """|F| and |F|·w in the layout's shape."""
        fa = torch.take(self._state, lay.idx).abs()
        return fa, fa * lay.w

    @staticmethod
    def _r(fa: torch.Tensor) -> torch.Tensor:
        """``[K]`` r_k = |F_{Ω_k}|_1: the one way r_k is computed, so it
        has the same bits everywhere."""
        return fa.sum(1)

    def _read(self, scalars: list, extra: Optional[torch.Tensor] = None,
              with_s_abs: bool = True) -> List[float]:
        """One read of the device: ``scalars`` (0-d float64 tensors), then
        ``extra`` (flattened, as float64), then ``s_k`` into the host
        copy."""
        pieces = [torch.stack(scalars)] if scalars else []
        if extra is not None:
            pieces.append(extra.reshape(-1).double())
        if with_s_abs:
            pieces.append(self._s_abs)
        vals = torch.cat(pieces).tolist()
        if with_s_abs:
            self.s_abs[:] = vals[len(vals) - self.k:]
            return vals[: len(vals) - self.k]
        return vals

    def _pinned(self, values, dtype=torch.float64) -> torch.Tensor:
        """Host values as a tensor that can be copied to the device without
        waiting for it: pinned when the device is a card (the caching host
        allocator keeps the block until the copy is done)."""
        t = torch.tensor(values, dtype=dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _upload(self, values, dtype=torch.float64) -> torch.Tensor:
        """Host values on the device, copied asynchronously."""
        return self._pinned(values, dtype).to(self.device, non_blocking=True)

    def r_of(self, k: int) -> float:
        return self._r_all()[k]

    def _r_all(self) -> List[float]:
        """``[r_of(k) for k]`` in one read of the device, ``s_k`` with it."""
        return self._r_all_with([])

    def global_residual(self) -> float:
        r = self._read([self.f.abs().sum()])[0]
        return r + float(self.s_abs.sum())

    def _idle(self, k: int, r_k: float) -> bool:
        thr = max(
            self.s_abs[k] / 10.0,
            self.cfg.target_error * self.cfg.eps / self.k / 10.0,
        )
        return r_k < thr

    def _set_s_abs(self, k: int, value: float) -> None:
        self._s_abs[k] = value
        self.s_abs[k] = value

    # --------------------------------------------------------------------- #
    # local diffusion (one time step)
    # --------------------------------------------------------------------- #
    def _push(self, sel: torch.Tensor, pid: torch.Tensor,
              sent: torch.Tensor, n_e: int, counts: List[int],
              remote: List[int]) -> None:
        """The diffusion's push of the nodes ``sel`` (pushed by the PIDs
        ``pid`` with the fluid ``sent``; ``n_e`` out-edges, ``counts[k]``
        of them PID k's, the PIDs ``remote`` with remote ones): K7's
        messages, then their ``np.add.at`` into ``f`` where the pushing
        PID owns the destination and into its outbox elsewhere (the state
        buffer); s_k grows by PID k's remote |·|, summed in message
        order."""
        key, msg, rabs = sim_messages(sel, pid, sent, self.deg, self.indptr,
                                      self.indices, self.edge_w, self.owner,
                                      n_e)
        sim_push(self._state, key, msg)
        self.n_pushes += 1
        if remote:
            # each PID's segment summed alone (0 where none is remote); the
            # lengths sum to n_e by construction, so segment_reduce's checks
            # of them (a read of the device each push) are skipped
            self._s_abs += torch.segment_reduce(
                rabs, "sum", lengths=self._upload(counts, torch.int64),
                unsafe=True)
            for k in remote:
                self._touched_any[k] = True

    def _diffuse_node(self, k: int, i: int, was_dirty: bool,
                      n_local: int) -> int:
        """Paper-exact single-node diffusion; returns ops charged now."""
        f = self.f
        sent = f[i: i + 1].clone()
        self.h[i] += sent[0]
        f[i] = 0.0
        lo, hi = int(self._indptr_host[i]), int(self._indptr_host[i + 1])
        self.n_edge_ops += max(hi - lo, 1)
        ops = 0
        if hi > lo:
            n_remote = (hi - lo) - n_local
            counts = [0] * self.k
            counts[k] = hi - lo
            self._push(self._nodes[i: i + 1], self._pids[k: k + 1], sent,
                       hi - lo, counts, [k] if n_remote else [])
            ops += n_local
            if n_remote and not was_dirty:
                self.pending_send_cost[k] += n_remote
        if ops == 0:
            ops = 1  # dangling / all-remote: charge the diffusion itself
        self.dirty[i] = True
        return ops

    def _diffuse_batch(self, lay: _Layout, take: torch.Tensor,
                       stats: Dict[int, Tuple[int, ...]]) -> None:
        """Jacobi-within-sweep diffusion of the nodes ``take`` marks (a
        mask in the layout's shape), every diffusing PID's at once: they
        touch disjoint fluid and outboxes.  ``stats[k]`` is PID k's
        (nodes, out-edges, dangling nodes, local out-edges, remote
        out-edges of nodes not dirty yet) among them."""
        n_sel = sum(st[0] for st in stats.values())
        n_e = sum(st[1] for st in stats.values())
        # the marked nodes PID by PID, each PID's in its set's order; their
        # count is known, so no read of the device
        slot = torch.nonzero_static(take.view(-1), size=n_sel).squeeze(1)
        sel = lay.idx.view(-1).index_select(0, slot)
        f = self.f
        sent = f.index_select(0, sel)
        self.h.index_copy_(0, sel, self.h.index_select(0, sel) + sent)
        f.index_fill_(0, sel, 0.0)
        self.dirty.index_fill_(0, sel, True)
        if not n_e:
            return
        counts = [0] * self.k
        for k, st in stats.items():
            counts[k] = st[1]
        self._push(sel, torch.div(slot, lay.idx.shape[1],
                                  rounding_mode="floor"), sent, n_e, counts,
                   [k for k, st in stats.items() if st[1] > st[3]])

    def _sweep_gate(self, k: int, r_k: float, fw_max: float, budget,
                    guard: Dict[int, int]) -> bool:
        """The reference's sweeps of PID k that find no eligible node, on
        the host: each one a guard tick and ``T_k := T_k/γ`` (r_k and the
        fluid are unchanged).  False when the PID goes idle (its budget
        then counted idle), True when a sweep finds an eligible node."""
        while True:
            guard[k] += 1
            if self._idle(k, r_k) or guard[k] > 10_000:
                self.count_idle[k] += int(budget)
                return False
            if fw_max > self.t_k[k]:
                return True
            self.t_k[k] /= self.cfg.gamma

    def _budgets(self) -> Dict[int, float]:
        """Each live PID's budget for this step; the PIDs with nothing to
        do are settled here."""
        budgets = {}
        for k in range(self.k):
            if self.speed_factor[k] <= 0.0:
                continue  # dead machine: no budget, no idle accrual
            budget = self.speed * self.speed_factor[k] + self.debt[k]
            self.debt[k] = 0.0
            if self.sets[k].numel() == 0:
                self.count_idle[k] += int(max(budget, 0))
            elif budget > 0:
                budgets[k] = budget
            else:
                self.debt[k] = min(budget, 0.0)  # frozen this step
        return budgets

    def _local_steps_batch(self) -> None:
        """One time step of every PID under the batch schedule, in
        lockstep: each round is one sweep of every PID that still has
        budget, read from the device once (twice when a threshold
        decayed).  The PIDs touch disjoint fluid and outboxes in their
        local steps, so running them side by side changes no sum."""
        budgets = self._budgets()
        guard = dict.fromkeys(budgets, 0)
        lay = self._layout()
        if lay.sweep is None or lay.sweep.state is not self._state:
            lay.sweep = _Sweep(self, lay)
        sweep, k_all = lay.sweep, self.k

        def ceilings():
            # integer costs: c < budget  <=>  c < ceil(budget)
            ceil = [0] * k_all
            for k, b in budgets.items():
                ceil[k] = math.ceil(b)
            return ceil

        while budgets:
            active = sorted(budgets)
            t_before = {k: self.t_k[k] for k in active}
            sweep(ceilings())
            vals = self._read([], sweep.out)
            for k in active:
                if not self._sweep_gate(k, vals[k], vals[k_all + k],
                                        budgets[k], guard):
                    del budgets[k]  # idle for the rest of the step
            if not budgets:
                break
            st = vals[2 * k_all:]
            if any(self.t_k[k] != t_before[k] for k in budgets):
                sweep(ceilings())
                st = self._read([], sweep.out[2 * k_all:], with_s_abs=False)
            elif len(budgets) < len(active):
                sweep(ceilings())  # the same sweep, less the idle PIDs
            stats = {k: tuple(int(st[r * k_all + k]) for r in range(5))
                     for k in budgets}
            self._diffuse_batch(lay, sweep.take, stats)
            for k, (n_sel, n_e, n_dangling, n_local, fresh_remote) in (
                    stats.items()):
                self.n_edge_ops += n_e + n_dangling  # Σ max(out-degree, 1)
                self.pending_send_cost[k] += fresh_remote
                # nodes with zero local pushes still cost ≥1 each
                ops = max(n_local + n_dangling, n_sel)
                self.count_active[k] += ops
                budgets[k] -= ops
                if budgets[k] <= 0:
                    # freeze: negative budget carries over
                    self.debt[k] = min(budgets.pop(k), 0.0)

    def _local_step_sequential(self, k: int, budget) -> None:
        """One time step of PID k under the paper-exact schedule: node by
        node, each diffusion seeing the earlier ones."""
        lay = self._layout()
        guard = {k: 0}
        while budget > 0:
            fa, fw = self._fluid(lay)
            r_k, fw_max = self._read([self._r(fa)[k], fw[k].max()])
            if not self._sweep_gate(k, r_k, fw_max, budget, guard):
                return
            for i in lay.idx[k][fw[k] > self.t_k[k]].tolist():
                f_i, dirty_i, local_i = self._read(
                    [self.f[i], self.dirty[i].double(),
                     lay.ldeg_node[i].double()], with_s_abs=False)
                if abs(f_i) * self._w_host[i] <= self.t_k[k]:
                    continue  # consumed earlier this sweep
                ops = self._diffuse_node(k, i, bool(dirty_i), int(local_i))
                self.count_active[k] += ops
                budget -= ops
                if budget <= 0:
                    break
        self.debt[k] = min(budget, 0.0)  # freeze: negative budget carries over

    def _local_steps(self) -> None:
        if self.cfg.mode == "batch":
            self._local_steps_batch()
            return
        for k, budget in self._budgets().items():
            self._local_step_sequential(k, budget)

    # --------------------------------------------------------------------- #
    # fluid exchange (§2.2.2)
    # --------------------------------------------------------------------- #
    def _exchange(self, k: int) -> None:
        if not self._touched_any[k]:
            self._set_s_abs(k, 0.0)
            return
        # the touched entries' nonzero values, by ascending index
        idx = torch.nonzero(self.outbox[k]).squeeze(1)
        vals = self.outbox[k][idx]
        self.outbox[k].zero_()  # cheap O(N) but only at exchange
        self._touched_any[k] = False
        self._set_s_abs(k, 0.0)
        # release dirty flags of MY nodes (ΔH baseline resets: H_old := H)
        self.dirty &= self.owner != k
        if self.cfg.charge_exchange:
            self.count_active[k] += int(self.pending_send_cost[k])
            self.debt[k] -= float(self.pending_send_cost[k])
        self.pending_send_cost[k] = 0
        if idx.numel() == 0:
            return
        self.n_exchanges += 1
        # deliver to receivers
        recv_owner = self.owner[idx]
        self.f[idx] = self.f[idx] + vals
        vals_abs = vals.abs()
        per = []
        for kp in range(self.k):
            m = recv_owner == kp
            per += [torch.where(m, vals_abs, 0.0).sum(),
                    m.sum(dtype=torch.float64)]
        got = self._r_all_with(per)
        for kp in range(self.k):
            received, n_updates = got[2 * kp], int(got[2 * kp + 1])
            if n_updates == 0 or kp == k:
                # a node moved to us since the push was queued: local fluid
                continue
            if self.cfg.charge_exchange:
                self.count_active[kp] += n_updates
                self.debt[kp] -= float(n_updates)
            r_kp = got[2 * self.k + kp]
            if received > 0.0:
                if r_kp > 0.0:
                    self.t_k[kp] = min(
                        self.t_k[kp] * (r_kp + received) / r_kp, received
                    )
                else:
                    self.t_k[kp] = received

    def _r_all_with(self, scalars: list) -> List[float]:
        """``scalars`` and then ``[r_of(k) for k]``, in one read."""
        return self._read(scalars, self._r(self._fluid(self._layout())[0]))

    def _exchange_due(self) -> None:
        """Exchange check (eq. 1), PID by PID: ``s_k > r_k / 2``."""
        r = self._r_all()  # s_k with it
        for k in range(self.k):
            if self.s_abs[k] > 0:
                if r is None:
                    r = self._r_all()
                if self.s_abs[k] > r[k] / 2.0:
                    self._exchange(k)
                    r = None  # the exchange moved fluid

    # --------------------------------------------------------------------- #
    # dynamic partition (§2.5.2) via the repro_torch.balance control plane
    # --------------------------------------------------------------------- #
    def _load_signal(self, step: int) -> LoadSignal:
        sizes = np.array([s.numel() for s in self.sets], dtype=np.int64)
        if self.cfg.signal == "edge-ops":
            delta = self.count_active - self._prev_active
            self._prev_active = self.count_active.copy()
            return LoadSignal.from_edge_ops(delta, sizes, step=step)
        rs = np.array(self._r_all()) + self.s_abs
        return LoadSignal.from_residuals(rs, sizes, step=step)

    def _repartition(self, step: int) -> None:
        for plan in self.rebalancer.propose(self._load_signal(step)):
            # liveness is the simulator's knowledge, not the policy's: a
            # dead machine neither sheds nor receives
            if (self.speed_factor[plan.src] <= 0.0
                    or self.speed_factor[plan.dst] <= 0.0):
                continue
            moved = self.executor.apply(plan)
            if moved:
                self.move_log.append((step, plan.src, plan.dst, moved))

    # --------------------------------------------------------------------- #
    # chaos hooks: straggler / kill / rescale (repro_torch.chaos)
    # --------------------------------------------------------------------- #
    def kill_pid(self, pid: int, step: int = 0) -> None:
        """Machine loss: PID ``pid`` stops computing and its Ω is handed
        to the surviving PIDs (balanced contiguous chunks, smallest
        survivors first).  Its in-flight outbox is flushed first —
        *capacity* is lost, not fluid.  Receivers are charged the §2.4
        reassignment cost."""
        if self.speed_factor[pid] <= 0.0:
            return
        self._exchange(pid)
        self.speed_factor[pid] = 0.0
        if self.rebalancer is not None:
            self.rebalancer.reset_worker(pid)  # its slope history died
        doomed = self.sets[pid]
        self.sets[pid] = doomed[:0]
        survivors = [kk for kk in range(self.k)
                     if self.speed_factor[kk] > 0.0]
        if not survivors:
            raise ValueError("kill would leave no live PID")
        if doomed.numel() == 0:
            return
        order = sorted(survivors, key=lambda kk: (self.sets[kk].numel(), kk))
        for kk, chunk in zip(order, torch.tensor_split(doomed, len(order))):
            if chunk.numel() == 0:
                continue
            self.sets[kk] = torch.cat([self.sets[kk], chunk])
            self.owner[chunk] = kk
            self.count_active[kk] += chunk.numel()
            self.debt[kk] -= float(chunk.numel())
            mx = float((self.f[chunk].abs() * self.weights[chunk]).max())
            if mx > 0:
                self.t_k[kk] = min(self.t_k[kk], mx * 1.0001)
            self.move_log.append((step, pid, kk, int(chunk.numel())))
            self.n_moves += 1

    def rescale(self, k_new: int, step: int = 0) -> None:
        """Elastic rescale: repartition the live node sets over ``k_new``
        PIDs mid-solve.  All outboxes flush first, then the live Ω's
        concatenate in PID order and split into ``k_new`` contiguous
        near-equal chunks.  Per-PID controller state (thresholds, debt,
        policy slopes) is re-seeded; cumulative counters carry over where
        the PID survives."""
        if k_new < 1:
            raise ValueError(f"k_new must be >= 1, got {k_new}")
        k_old = self.k
        if k_new == k_old:
            return
        for kk in range(k_old):
            self._exchange(kk)
        nodes = torch.cat(self.sets)  # empty sets add nothing
        self.sets = [c.clone() for c in torch.tensor_split(nodes, k_new)]
        for i, s in enumerate(self.sets):
            self.owner[s] = i

        def _resize(a, fill=0):
            out = np.full(k_new, fill, dtype=a.dtype)
            m = min(k_new, k_old)
            out[:m] = a[:m]
            return out

        self.k = k_new
        # never mutate the caller's config object
        self.cfg = dataclasses.replace(self.cfg, k=k_new)
        self.speed = self.cfg.pid_speed or max(1, self.n // k_new)
        self.count_active = _resize(self.count_active)
        self.count_idle = _resize(self.count_idle)
        self._prev_active = _resize(self._prev_active)
        self.debt = np.zeros(k_new, dtype=np.float64)
        # surviving DEGRADED machines stay degraded; dead slots are
        # replaced by fresh capacity, as is any grown width
        old_sf = self.speed_factor
        self.speed_factor = np.ones(k_new, dtype=np.float64)
        m = min(k_new, k_old)
        keep = old_sf[:m] > 0.0
        self.speed_factor[:m][keep] = old_sf[:m][keep]
        self._alloc_state(self.f.clone())  # the outboxes are empty
        self.pending_send_cost = np.zeros(k_new, dtype=np.int64)
        self.t_k = self._seed_thresholds()
        if self.rebalancer is not None:
            # policy state is per-worker and cannot survive a width
            # change; a caller-injected instance is not swapped silently
            if self._rebalancer_injected:
                raise ValueError(
                    "rescale cannot resize a caller-injected rebalancer;"
                    " construct the simulator from cfg.policy, or swap "
                    "sim.rebalancer yourself before the rescale event"
                )
            self.rebalancer = _policies.make_rebalancer(
                self.cfg.policy or "slope_ema", k=k_new,
                target_error=self.cfg.target_error, eta=self.cfg.eta,
                z=self.cfg.z, unit="node",
            )
        self.move_log.append((step, -1, -1, k_new))  # rescale marker

    def _fire_chaos(self, plan, cursor: int, step: int) -> int:
        """Fire every due event (``ChaosPlan.fire_due``); returns the
        advanced cursor."""
        due, cursor = plan.fire_due(cursor, step)
        for ev in due:
            if ev.kind == "straggler":
                self.speed_factor[ev.pid] = 1.0 / ev.slowdown
            elif ev.kind == "kill":
                self.kill_pid(ev.pid, step=step)
            elif ev.kind == "rescale":
                self.rescale(ev.k_new, step=step)
            self.chaos_log.append((step, ev.kind))
        return cursor

    # --------------------------------------------------------------------- #
    # main loop
    # --------------------------------------------------------------------- #
    def run(self, chaos=None) -> SimResult:
        """Run to convergence.  ``chaos`` is an optional
        :class:`repro_torch.chaos.ChaosPlan` whose straggler/kill/rescale
        events fire in the step loop (rounds = simulator time steps); the
        plan is validated against this simulator's width up front.
        """
        if chaos is not None:
            from ..chaos.plan import SIM_KINDS

            chaos.validate(self.k, kinds=SIM_KINDS)
        chaos_cursor = 0
        cfg = self.cfg
        hist_steps: List[int] = []
        hist_rs: List[np.ndarray] = []
        hist_sizes: List[np.ndarray] = []
        hist_res: List[float] = []
        hist_eops: List[int] = []
        step = 0
        speed_steps = 0  # Σ per-step nominal PID_Speed (a rescale changes it)
        converged = False
        while step < cfg.max_steps:
            step += 1
            if chaos is not None:
                chaos_cursor = self._fire_chaos(chaos, chaos_cursor, step)
            speed_steps += self.speed
            self._local_steps()
            self._exchange_due()
            if self.rebalancer is not None:
                self._repartition(step)
            if step % cfg.record_every == 0:
                f_l1, *r = self._r_all_with([self.f.abs().sum()])
                residual = f_l1 + float(self.s_abs.sum())
                hist_steps.append(step)
                hist_rs.append(np.array(r) + self.s_abs)
                hist_sizes.append(np.array([s.numel() for s in self.sets],
                                           dtype=np.int64))
                hist_res.append(residual)
                hist_eops.append(self.n_edge_ops)
            else:
                residual = self.global_residual()
            if residual <= self.tol:
                converged = True
                break
        return SimResult(
            h=self.h.clone(),
            converged=converged,
            n_steps=step,
            cost_iterations=speed_steps / max(1, self.n_edges),
            count_active=self.count_active.copy(),
            count_idle=self.count_idle.copy(),
            n_exchanges=self.n_exchanges,
            n_moves=self.n_moves,
            residual=self.global_residual(),
            hist_steps=np.array(hist_steps, dtype=np.int64),
            hist_rs=(_pad_hist(hist_rs) if hist_rs
                     else np.zeros((0, self.k))),
            hist_sizes=(
                _pad_hist(hist_sizes, dtype=np.int64) if hist_sizes
                else np.zeros((0, self.k))
            ),
            hist_residual=np.array(hist_res, dtype=np.float64),
            move_log=list(self.move_log),
            n_edge_ops=self.n_edge_ops,
            hist_edge_ops=np.array(hist_eops, dtype=np.int64),
            chaos_log=list(self.chaos_log),
            n_pushes=self.n_pushes,
        )


def run_cost_experiment(
    g,
    b: np.ndarray,
    eps: float,
    ks: Tuple[int, ...] = (1, 2, 4, 8, 16),
    partitions: Tuple[str, ...] = ("uniform", "cb"),
    dynamics: Tuple[bool, ...] = (False, True),
    target_error: Optional[float] = None,
    mode: str = "sequential",
    max_steps: int = 2_000_000,
    device: str = "cuda",
) -> Dict[Tuple[int, str, bool], float]:
    """Paper Tables 1–3 protocol: normalized cost for each (K, partition, dyn).

    ``target_error`` defaults to 1/N as in §3.1.
    """
    te = target_error if target_error is not None else 1.0 / g.n
    out: Dict[Tuple[int, str, bool], float] = {}
    for k in ks:
        for part in partitions:
            for dyn in dynamics:
                cfg = SimulatorConfig(
                    k=k,
                    target_error=te,
                    eps=eps,
                    partition=part,
                    dynamic=dyn,
                    mode=mode,
                    max_steps=max_steps,
                    record_every=50,
                    device=device,
                )
                res = DistributedSimulator(g, b, cfg).run()
                out[(k, part, dyn)] = res.cost_iterations
    return out
