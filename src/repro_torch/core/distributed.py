"""The K-PID D-iteration engine with dynamic bucket moves (the port of
``repro.core.distributed``).

The reference runs one PID per JAX device (``shard_map`` over a ``pid``
axis).  The port runs the paper's K PIDs as a **leading axis on one
device**: the state is ``f``, ``h``: ``[K, B_loc, S]`` (stored as
``[R, S]`` rows, R = K·B_loc), ``outbox``: ``[K, R·S]``, ``t``, ``ops``:
``[K]``, and K is not bounded by the number of cards.  Every piece of
arithmetic the reference does per device is kept:

* **Bucket-granular state** — nodes are packed into fixed-size buckets
  (the ``GraphStore`` engine-layout view); every PID owns a fixed number
  of bucket rows, some of them inert headroom.  The
  :mod:`repro_torch.balance` control plane moves whole buckets between
  PIDs (``MovePlan`` kind ``bucket``, executed by
  :class:`~repro_torch.balance.executors.BucketMoveExecutor`).
* **Frontier-batched local diffusion** — every local node above its
  PID's threshold diffuses at once; the push is K2 over the tile pool
  (``engine:bsr``, the port of ``bsr_gather_spmm_pallas``) or K3 over the
  real edges (``engine:chunk``).  One launch serves all K PIDs.
* **The exchange** — the reference's ``psum_scatter``: PID d receives
  ``Σ_k outbox[k, slice_d]``, summed in the fixed order k = 0…K−1.  The
  paper's ``s_k > r_k/2`` rule decides *when*, with any-PID-fires
  semantics (the reference's ``pmax``).
* **Threshold schedule** — per-PID T with γ decay and the receive-time
  re-seed ``T := min(T·(r+recv)/r, recv)``.

A bucket move permutes only what is small — ``f``, ``h``, ``w`` and the
per-slot edge counts, all ``[R, S]`` — and rebuilds the K2 visit table or
the K3 edge table from the new bucket → row map, on the device.  The tile
pool (the real tiles only, ``[V, S, S]``: 12.9 GB at N=2²¹, k=4) and the
edge lists stay in their home rows; the reference's ``_repart`` gathers
them through the move's permutation instead, which the sums do not
notice.

Determinism: no atomics, stable sorts for every table, a fixed K order in
the exchange — a run replays bit for bit.  The round loop runs in Python
and reads the any-PID fire flag once per inner round from the device (the
reference keeps it in a ``lax.while_loop``).

Elastic K: :meth:`DistributedEngine.rescale` grows or shrinks the PID
axis mid-solve; a shrink first drains the dying PIDs' buckets onto the
survivors' headroom rows through the executor
(:meth:`~DistributedEngine.drain_for_shrink`).  The PIDs share one
device, so K is not bounded by the cards present.  A ``torch.distributed``
path across cards comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..balance.executors import BucketMoveExecutor
from ..balance.plan import MovePlan
from ..balance.policies import Rebalancer, make_rebalancer
from ..balance.signals import LoadSignal
from ..graph.views import dense_tiles, tile_groups
from ..kernels.diffusion import engine_tile_push, engine_visit_table
from ..kernels.edge_sum import edge_sum, engine_edge_table
from .diteration import threshold_decay

__all__ = [
    "EngineConfig",
    "EngineArrays",
    "EngineState",
    "DistributedEngine",
    "build_engine_arrays",
]

GAMMA = 1.2


@dataclasses.dataclass
class EngineConfig:
    k: int  # PIDs on the leading axis
    target_error: float
    eps: float
    buckets_per_dev: int = 8  # owned bucket rows per PID (incl. headroom)
    headroom: int = 2  # inert bucket rows per PID for load moves
    max_inner: int = 8  # max local rounds between exchanges
    gamma: float = GAMMA
    dynamic: bool = False  # enable the control plane (slope_ema policy)
    policy: Optional[str] = None  # balance policy name (overrides
    # ``dynamic``): slope_ema | cost_refresh | hysteresis
    signal: str = "residual"  # rebalancing signal: residual | edge-ops
    eta: float = 0.5
    z: int = 10
    chunk_rounds: int = 4  # exchange cycles per chunk
    max_chunks: int = 4096
    dtype: torch.dtype = torch.float32
    diffusion_backend: str = "segment_sum"  # per-edge push (K3) | "bsr":
    # bucket-tiled dense blocks (K2)
    device: str = "cuda"
    pallas_buffer_depth: int = 1  # K2's tile-ring depth on the bsr
    # backend (the reference's name for its tile-pool DMA pipeline depth)


@dataclasses.dataclass
class EngineArrays:
    """Static bucket-major arrays fed to the engine (host numpy).

    R = K * buckets_per_dev rows, S = bucket_size slots per row,
    E = edge capacity per row.  Row r is owned by PID r // buckets_per_dev.
    ``pos_of_bucket`` maps a *stable bucket id* to its home row; edge
    destinations are stored as (stable bucket id, in-bucket slot) so
    bucket moves only update the small position map.

    Tiled arrays (``engine:bsr``) group each row's real edges into dense
    ``[S, S]`` tiles, one per destination bucket ``tile_dst[r, t]``
    (``t < t_counts[r]``); :attr:`tiles` materializes that pool on the
    host, while the engine fills it on its own device.
    """

    f0: np.ndarray  # [R, S] initial fluid
    w: np.ndarray  # [R, S] selection weights (0 = inert slot)
    src_slot: np.ndarray  # [R, E] in-bucket source slot of each edge
    dst_bucket: np.ndarray  # [R, E] destination stable bucket id
    dst_slot: np.ndarray  # [R, E] destination in-bucket slot
    wgt: np.ndarray  # [R, E] edge weight (0 = padding edge)
    pos_of_bucket: np.ndarray  # [R] stable bucket id -> home row
    node_of_slot: np.ndarray  # [R, S] global node id or -1 (home rows)
    n: int
    n_edges: int
    tile_dst: Optional[np.ndarray] = None  # [R, T] int32
    slot_out_deg: Optional[np.ndarray] = None  # [R, S] int32 real edges
    # per slot — the bsr path's §2.3 op counter
    t_counts: Optional[np.ndarray] = None  # [R] int32 real tiles per row
    tile_dtype: Optional[np.dtype] = None

    @property
    def n_rows(self) -> int:
        return int(self.f0.shape[0])

    @property
    def bucket_size(self) -> int:
        return int(self.f0.shape[1])

    @property
    def edge_cap(self) -> int:
        return int(self.wgt.shape[1])

    @property
    def tiles(self) -> Optional[np.ndarray]:
        """The dense ``[R, T, S, S]`` host pool, built on each access
        (small problems and tests); None when untiled."""
        if self.tile_dst is None:
            return None
        return dense_tiles(self.src_slot, self.dst_bucket, self.dst_slot,
                           self.wgt, self.bucket_size, self.tile_dtype)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def build_engine_arrays(
    g,
    b: np.ndarray,
    cfg: EngineConfig,
    order: Optional[np.ndarray] = None,
) -> EngineArrays:
    """Bucketize (P, B) into the engine's fixed-shape layout.

    ``g`` is a :class:`repro_torch.graph.GraphStore` or a
    :class:`~repro_torch.core.graph.CSRGraph` (wrapped into a throwaway
    store).  The graph-derived half comes from the store's cached
    engine-layout view; only the RHS-dependent ``f0`` is built here.
    Real buckets fill ``buckets_per_dev - headroom`` rows per PID; the
    remaining rows are inert landing slots for dynamic bucket moves.
    """
    from ..graph import GraphStore

    store = g if isinstance(g, GraphStore) else GraphStore.from_csr(g)
    lay = store.engine_layout(
        cfg.k, cfg.buckets_per_dev, cfg.headroom,
        tiled=cfg.diffusion_backend != "segment_sum",
        dtype=_numpy_dtype(cfg.dtype), order=order,
    )
    f0 = np.zeros((lay.n_rows, lay.bucket_size), dtype=np.float64)
    valid = lay.node_of_slot >= 0
    f0[valid] = np.asarray(b, dtype=np.float64)[lay.node_of_slot[valid]]
    return EngineArrays(
        f0=f0,
        w=lay.w,
        src_slot=lay.src_slot,
        dst_bucket=lay.dst_bucket,
        dst_slot=lay.dst_slot,
        wgt=lay.wgt,
        pos_of_bucket=lay.pos_of_bucket,
        node_of_slot=lay.node_of_slot,
        n=lay.n,
        n_edges=lay.n_edges,
        tile_dst=lay.tile_dst,
        slot_out_deg=lay.slot_out_deg,
        t_counts=lay.t_counts,
        tile_dtype=lay.tile_dtype,
    )


def _tile_engine_edges(
    src_slot: np.ndarray,  # [R, E]
    dst_bucket: np.ndarray,  # [R, E] stable bucket ids
    dst_slot: np.ndarray,  # [R, E]
    wgt: np.ndarray,  # [R, E] (0 = padding)
    s: int,
    dtype: np.dtype,
) -> Tuple[np.ndarray, np.ndarray]:
    """Group each row's edge buffer into dense [S, S] per-destination tiles.

    The tile capacity T is the max distinct destination buckets of any
    row; unused tile slots stay zero with ``tile_dst = 0``.  Host numpy,
    as the reference's; the engine itself fills its pool on its device.
    """
    tile_dst, _, _ = tile_groups(dst_bucket, wgt)
    return dense_tiles(src_slot, dst_bucket, dst_slot, wgt, s,
                       dtype), tile_dst


@dataclasses.dataclass
class EngineState:
    """Solver state on the engine's device.

    ``f``/``h`` are ``[R, S]`` in *current* row order (PID p owns rows
    ``p·B_loc … (p+1)·B_loc − 1``); ``outbox`` is ``[K, R·S]`` (each PID's
    full-length outbox); ``t``/``ops`` are ``[K]``.  The bucket → row map
    is the executor's (``BucketMoveExecutor.row_of_bucket``).
    """

    f: torch.Tensor
    h: torch.Tensor
    outbox: torch.Tensor
    t: torch.Tensor
    ops: torch.Tensor  # [K] int64 edge pushes per PID
    rounds: int


class DistributedEngine:
    """The K-PID solver for ``X = P X + B`` on one device."""

    def __init__(
        self,
        arrays: EngineArrays,
        cfg: EngineConfig,
        rebalancer: Optional[Rebalancer] = None,
    ):
        if cfg.signal not in ("residual", "edge-ops"):
            raise ValueError(
                f"unknown rebalancing signal {cfg.signal!r}; expected "
                "'residual' or 'edge-ops'"
            )
        if cfg.diffusion_backend not in ("segment_sum", "bsr"):
            raise ValueError(
                f"unknown diffusion backend {cfg.diffusion_backend!r}; "
                "expected 'segment_sum' or 'bsr'"
            )
        if cfg.diffusion_backend == "bsr" and arrays.tile_dst is None:
            raise ValueError(
                "diffusion_backend='bsr' needs tiled arrays — build them "
                "with build_engine_arrays(..., cfg) using the same config"
            )
        self.a = arrays
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self._gamma = torch.tensor(cfg.gamma, dtype=cfg.dtype, device=self.device)
        if rebalancer is not None:
            self.rebalancer: Optional[Rebalancer] = rebalancer
        elif cfg.policy or cfg.dynamic:
            self.rebalancer = make_rebalancer(
                cfg.policy or "slope_ema", k=cfg.k,
                target_error=cfg.target_error, eta=cfg.eta, z=cfg.z,
                unit="bucket",
            )
        else:
            self.rebalancer = None
        # straggler injection hook: a [K] factor multiplying the load
        # signal the control plane sees (None = healthy).  A straggling
        # PID cannot be slowed from here, but its *signal* can — the
        # controller then sheds load as it would in production
        # (repro_torch.chaos.SessionInjector sets this)
        self.load_scale: Optional[np.ndarray] = None
        self._upload_static()

    # ------------------------------------------------------------------ #
    # static operands on the device
    # ------------------------------------------------------------------ #
    def _upload_static(self) -> None:
        """The real edges (K3) or the tile pool and its real tiles (K2),
        in home-row layout; they never move."""
        a, cfg, dev = self.a, self.cfg, self.device
        s = a.bucket_size
        lng = lambda v: torch.as_tensor(np.asarray(v, dtype=np.int64),
                                        device=dev)
        self._home_of_bucket = lng(a.pos_of_bucket)
        rows, cols = np.nonzero(a.wgt != 0)
        # per-slot real-edge counts: the §2.3 op counter (the tiled layout
        # carries them; for the per-edge path they are counted here, as
        # the reference's chunk counts them in-graph)
        slot_deg = (a.slot_out_deg if a.slot_out_deg is not None
                    else np.bincount(rows * s + a.src_slot[rows, cols],
                                     minlength=a.n_rows * s
                                     ).reshape(a.n_rows, s))
        self.slot_deg0 = lng(slot_deg)
        if cfg.diffusion_backend == "bsr":
            _, _, t_of_edge = tile_groups(a.dst_bucket, a.wgt)
            t_cap = a.tile_dst.shape[1]
            # the pool holds the real tiles only, in (home row, slot)
            # order: row r's tiles start at t_base[r].  The reference's
            # [R, T] pool grows with the busiest row's T, which a graph
            # delta can raise for every row at once (random rotations at
            # N=2**21: T 3 -> 14, a 60 GB pool for 16k real tiles)
            t_counts = np.asarray(a.t_counts, dtype=np.int64)
            t_base = np.cumsum(t_counts) - t_counts
            self.pool = torch.zeros((max(1, int(t_counts.sum())), s * s),
                                    dtype=cfg.dtype, device=dev)
            # each (tile, dst slot, src slot) holds one edge of the
            # canonical (deduplicated) graph, so the writes never collide;
            # rows go in chunks of at most 2**28 pool entries, which keeps
            # the index math small
            tile = t_base[rows] + t_of_edge
            offset = a.dst_slot[rows, cols] * s + a.src_slot[rows, cols]
            val = a.wgt[rows, cols]
            per_chunk = max(1, (1 << 28) // (t_cap * s * s))
            bounds = np.searchsorted(
                rows, np.arange(0, a.n_rows + per_chunk, per_chunk))
            for c, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                if hi == lo:
                    continue
                base = int(t_base[c * per_chunk])
                block = self.pool[base:]
                block[lng(tile[lo:hi] - base), lng(offset[lo:hi])] = (
                    torch.as_tensor(val[lo:hi], device=dev).to(cfg.dtype))
            self.pool = self.pool.view(-1, s, s)
            t_rows = np.repeat(np.arange(a.n_rows), t_counts)
            t_slots = np.arange(t_rows.size) - np.repeat(t_base, t_counts)
            self._tiles = (lng(t_rows), lng(t_slots),
                           lng(a.tile_dst[t_rows, t_slots]))
            self._t_cap = t_cap
        else:
            self._edges = (lng(rows), lng(cols), lng(a.src_slot[rows, cols]),
                           lng(a.dst_bucket[rows, cols]),
                           lng(a.dst_slot[rows, cols]),
                           torch.as_tensor(a.wgt[rows, cols],
                                           device=dev).to(cfg.dtype))

    def cur_of_home(self, row_of_bucket: np.ndarray) -> torch.Tensor:
        """``[R]`` current row of each home row, on the device."""
        rob = torch.as_tensor(np.asarray(row_of_bucket, dtype=np.int64),
                              device=self.device)
        cur = torch.empty_like(rob)
        cur[self._home_of_bucket] = rob
        return cur

    def push_table(self, row_of_bucket: np.ndarray):
        """The K2 visit table or the K3 edge table for the bucket → row
        map ``row_of_bucket``, built on the device (stable sorts)."""
        a, cfg = self.a, self.cfg
        rob = torch.as_tensor(np.asarray(row_of_bucket, dtype=np.int64),
                              device=self.device)
        cur_of_home = self.cur_of_home(row_of_bucket)
        if cfg.diffusion_backend == "bsr":
            t_row, t_slot, t_dst = self._tiles
            return engine_visit_table(t_row, t_slot, t_dst, cur_of_home, rob,
                                      cfg.k, cfg.buckets_per_dev,
                                      self._t_cap)
        rows, cols, src_slot, dst_bucket, dst_slot, wgt = self._edges
        return engine_edge_table(rows, cols, src_slot, dst_bucket, dst_slot,
                                 wgt, cur_of_home, rob, cfg.k,
                                 cfg.buckets_per_dev, a.bucket_size,
                                 a.edge_cap)

    # ------------------------------------------------------------------ #
    # state init
    # ------------------------------------------------------------------ #
    def init_state(
        self,
        f_nodes: Optional[np.ndarray] = None,
        h_nodes: Optional[np.ndarray] = None,
    ) -> EngineState:
        """Fresh state in the *initial* bucket layout.

        ``f_nodes``/``h_nodes`` optionally seed the fluid and history
        from node-space vectors (the warm-start and interop paths).
        Defaults reproduce the cold start ``F = B, H = 0``.
        """
        a, cfg, dev = self.a, self.cfg, self.device
        dt = cfg.dtype
        f0 = a.f0 if f_nodes is None else self._to_slots(f_nodes)
        h0 = (np.zeros(a.f0.shape) if h_nodes is None
              else self._to_slots(h_nodes))
        fw = np.abs(f0) * a.w
        t0 = fw.reshape(cfg.k, -1).max(axis=1) * 2.0 + 1e-30
        put = lambda x: torch.as_tensor(x, device=dev).to(dt)
        return EngineState(
            f=put(f0),
            h=put(h0),
            outbox=torch.zeros((cfg.k, a.n_rows * a.bucket_size), dtype=dt,
                               device=dev),
            t=put(t0),
            ops=torch.zeros(cfg.k, dtype=torch.int64, device=dev),
            rounds=0,
        )

    def _to_slots(self, v_nodes: np.ndarray) -> np.ndarray:
        """Scatter a node-space [N] vector into the initial [R, S] layout."""
        a = self.a
        out = np.zeros(a.f0.shape, dtype=np.float64)
        valid = a.node_of_slot >= 0
        out[valid] = np.asarray(v_nodes, dtype=np.float64)[
            a.node_of_slot[valid]
        ]
        return out

    # ------------------------------------------------------------------ #
    # the chunk: cfg.chunk_rounds × (adaptive local rounds + exchange)
    # ------------------------------------------------------------------ #
    def _push(self, table, sent: torch.Tensor) -> torch.Tensor:
        """Every PID's full-length contribution ``[K, R·S]`` (current row
        space) of this round's sent fluid ``[R, S]``."""
        k = self.cfg.k
        if self.cfg.diffusion_backend == "bsr":
            return engine_tile_push(
                self.pool, table, sent,
                buffer_depth=self.cfg.pallas_buffer_depth).reshape(k, -1)
        return edge_sum(sent.reshape(-1), table).reshape(k, -1)

    def _local_round(self, st: EngineState, w, slot_deg, dang, table):
        """One frontier round on every PID's ``[B_loc, S]`` rows.

        ``dang`` is the dangling-slot mask (real node, zero real edges)
        charged one op per selected round — the §2.3 accounting every
        other tier uses (edge pushes plus one per selected dangling node).
        """
        cfg = self.cfg
        k = cfg.k
        f = st.f.view(k, -1)
        sel = (f.abs() * w.view(k, -1)) > st.t[:, None]
        any_sel = sel.any(dim=1)
        sent = torch.where(sel, f, torch.zeros_like(f))
        h = st.h + sent.view_as(st.h)
        f = f - sent
        contrib = self._push(table, sent.view_as(st.f))
        diag = torch.arange(k, device=f.device)
        per_pid = contrib.view(k, k, -1)
        f = f + per_pid[diag, diag]  # the "mine" slices
        per_pid[diag, diag] = 0
        st.outbox = st.outbox + contrib
        st.t = torch.where(any_sel, st.t,
                           threshold_decay(st.t, self._gamma))
        # every slot's real edges all fire when the slot is selected; the
        # counters are int64, so no wraparound to undo (the reference's
        # are int32)
        st.ops = st.ops + (torch.where(sel, slot_deg.view(k, -1), 0).sum(1)
                           + (sel & dang.view(k, -1)).sum(1))
        st.f = f.view_as(st.h)
        st.h = h

    def _exchange_cycle(self, st: EngineState, w, slot_deg, dang,
                        table) -> None:
        """Local rounds until ``max_inner`` or until any PID fires
        (``s_k > r_k/2``), then the fluid exchange.  Every PID runs the
        same number of rounds; the fire flag is read once per round."""
        cfg = self.cfg
        k = cfg.k
        i = 0
        while True:
            self._local_round(st, w, slot_deg, dang, table)
            i += 1
            if i >= cfg.max_inner:
                break
            r_k = st.f.view(k, -1).abs().sum(dim=1)
            s_k = st.outbox.abs().sum(dim=1)
            if bool((s_k > r_k / 2.0).any()):
                break
        # ---- fluid exchange: PID d receives sum_k outbox[k, slice_d] ----
        f = st.f.view(k, -1)
        r_before = f.abs().sum(dim=1)
        ob = st.outbox.view(k, k, -1)
        delta = ob[0]
        for src in range(1, k):  # fixed order: bit-exact replay
            delta = delta + ob[src]
        f = f + delta
        received = delta.abs().sum(dim=1)
        st.t = torch.where(
            received > 0,
            torch.minimum(
                torch.where(r_before > 0,
                            st.t * (r_before + received) / r_before,
                            received),
                received),
            st.t)
        st.f = f.view_as(st.h)
        st.outbox = torch.zeros_like(st.outbox)
        st.rounds += i

    def run_chunk(self, state: EngineState, w, slot_deg,
                  table) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        """``chunk_rounds`` exchange cycles; returns the new state and the
        per-PID stats ``r`` (|F| per PID), ``s`` (|outbox| per PID) and the
        ``residual`` |F|_1.  The state is updated in place."""
        cfg = self.cfg
        dang = (w != 0) & (slot_deg == 0)
        for _ in range(cfg.chunk_rounds):
            self._exchange_cycle(state, w, slot_deg, dang, table)
        stats = {
            "r": state.f.view(cfg.k, -1).abs().sum(dim=1),
            "s": state.outbox.abs().sum(dim=1),
            "residual": state.f.abs().sum(),
        }
        return state, stats

    # ------------------------------------------------------------------ #
    # bucket repartition (dynamic strategy)
    # ------------------------------------------------------------------ #
    def repartition(self, state: EngineState, row_perm: np.ndarray,
                    new_pos: np.ndarray, operands):
        """Apply a row permutation (``new[i] = old[row_perm[i]]``) to the
        state and the moving operands ``(w, slot_deg)``; rebuild the push
        table for the new bucket → row map ``new_pos``."""
        perm = torch.as_tensor(np.asarray(row_perm, dtype=np.int64),
                               device=self.device)
        state.f = state.f[perm]
        state.h = state.h[perm]
        moved = tuple(x[perm] for x in operands)
        return state, moved, self.push_table(new_pos)

    # ------------------------------------------------------------------ #
    # outer solve loop (host-driven controller)
    # ------------------------------------------------------------------ #
    def solve(self, verbose: bool = False):
        cfg = self.cfg
        ex = BucketMoveExecutor(self, self.init_state())
        tol = cfg.target_error * cfg.eps
        history = []
        move_log = []
        prev_ops = np.zeros(cfg.k, dtype=np.int64)
        resid = float("inf")
        chunk_i = -1
        for chunk_i in range(cfg.max_chunks):
            ex.state, stats = self.run_chunk(ex.state, *ex.chunk_operands())
            r = stats["r"].cpu().numpy()
            s_ = stats["s"].cpu().numpy()
            resid = float(stats["residual"]) + float(s_.sum())
            history.append((ex.state.rounds, resid, (r + s_).copy()))
            if verbose:
                print(f"chunk {chunk_i}: residual={resid:.3e} "
                      f"rounds={ex.state.rounds}")
            if resid <= tol:
                break
            prev_ops = self.apply_control_plane(
                ex, r, s_, chunk_i, prev_ops, move_log)
        x = self.extract_solution(ex.state, ex.row_of_bucket)
        ops = ex.state.ops.cpu().numpy()
        return x, {
            "residual": resid,
            "chunks": chunk_i + 1,
            "rounds": ex.state.rounds,
            "moves": len(move_log),
            "move_log": move_log,
            "history": history,
            "converged": resid <= tol,
            "ops": ops,
            "n_edge_ops": int(ops.sum()),
        }

    def apply_control_plane(self, ex, r: np.ndarray, s_: np.ndarray,
                            step: int, prev_ops: np.ndarray,
                            move_log: list) -> np.ndarray:
        """One rebalancer pass on post-chunk stats (shared by ``solve``
        and the API session driver).  Builds the configured LoadSignal,
        applies every proposed MovePlan through ``ex``, appends executed
        moves to ``move_log`` as ``(step, src, dst, units)``, and returns
        the updated cumulative-ops baseline."""
        if self.rebalancer is None:
            return prev_ops
        sizes = ex.sizes()
        scale = (self.load_scale if self.load_scale is not None
                 else np.ones(self.cfg.k))
        if self.cfg.signal == "edge-ops":
            ops = ex.state.ops.cpu().numpy()
            # the counters are int64 and cumulative over the solve: the
            # chunk's ops are a plain difference (the reference's int32
            # counters need a wraparound mask here)
            sig = LoadSignal.from_edge_ops((ops - prev_ops) * scale, sizes,
                                           step=step)
            prev_ops = ops
        else:
            sig = LoadSignal.from_residuals((r + s_) * scale, sizes,
                                            step=step)
        for plan in self.rebalancer.propose(sig):
            moved = ex.apply(plan)
            if moved:
                move_log.append((step, plan.src, plan.dst, moved))
        return prev_ops

    def gather_nodes(self, values, row_of_bucket: np.ndarray) -> np.ndarray:
        """Gather a bucket-space [R, S] state array back to node space:
        a bucket id's data lives at its *current* row while the node map
        indexes its *home* row."""
        a = self.a
        v = np.asarray(values.double().cpu() if torch.is_tensor(values)
                       else values, dtype=np.float64).reshape(
                           a.n_rows, a.bucket_size)
        home = np.empty_like(v)
        home[np.asarray(a.pos_of_bucket)] = v[np.asarray(row_of_bucket)]
        x = np.zeros(a.n, dtype=np.float64)
        valid = a.node_of_slot >= 0
        x[a.node_of_slot[valid]] = home[valid]
        return x

    def extract_solution(self, state: EngineState,
                         row_of_bucket: np.ndarray) -> np.ndarray:
        """Gather H back to node space."""
        return self.gather_nodes(state.h, row_of_bucket)

    def _plan_move(self, row_of_bucket: np.ndarray, src_dev: int,
                   dst_dev: int, n_move: int, keep_min: int = 1
                   ) -> Tuple[Optional[np.ndarray], np.ndarray, int]:
        """Plan a row permutation moving up to ``n_move`` real buckets from
        PID ``src_dev`` to free (inert) rows of PID ``dst_dev``.

        ``keep_min`` is the floor of real buckets left on the source —
        1 for rebalancing moves (a PID never empties itself), 0 for the
        rescale drain (a dying PID hands everything over).

        Returns ``(perm, new_row_of_bucket, moved)`` with
        ``perm[i] = old row whose contents land in new row i``.
        """
        cfg = self.cfg
        b_loc = cfg.buckets_per_dev
        n_real = cfg.k * (b_loc - cfg.headroom)
        dev_of_bucket = row_of_bucket // b_loc
        src_real = np.nonzero(dev_of_bucket[:n_real] == src_dev)[0]
        inert_ids = np.arange(n_real, row_of_bucket.shape[0])
        dst_free = inert_ids[dev_of_bucket[inert_ids] == dst_dev]
        moved = int(min(n_move, max(src_real.size - keep_min, 0),
                        dst_free.size))
        if moved == 0:
            return None, row_of_bucket, 0
        new_map = row_of_bucket.copy()
        perm = np.arange(row_of_bucket.shape[0], dtype=np.int64)
        for bid, q in zip(src_real[-moved:], dst_free[:moved]):
            p_row, q_row = int(new_map[bid]), int(new_map[q])
            perm[q_row], perm[p_row] = p_row, q_row
            new_map[bid], new_map[q] = q_row, p_row
        return perm, new_map, moved

    # ------------------------------------------------------------------ #
    # mid-solve PID rescale (elastic scale-up / PID loss)
    # ------------------------------------------------------------------ #
    def _free_rows_per_device(self, row_of_bucket: np.ndarray) -> np.ndarray:
        """Inert (landing-capable) bucket rows currently on each PID."""
        cfg = self.cfg
        n_real = cfg.k * (cfg.buckets_per_dev - cfg.headroom)
        dev_of_bucket = np.asarray(row_of_bucket) // cfg.buckets_per_dev
        return np.bincount(dev_of_bucket[n_real:], minlength=cfg.k)

    def drain_for_shrink(self, ex, k_new: int):
        """Evacuate every real bucket owned by PIDs >= ``k_new`` onto the
        survivors' inert headroom rows, one bucket at a time to the
        survivor with the most free rows (deterministic, load-levelling).

        Runs through the :class:`~repro_torch.balance.executors.
        BucketMoveExecutor` path — the same permutation the dynamic
        partition uses — so the drain IS a sequence of executed
        ``MovePlan``\\ s, returned as ``(src, dst, moved)`` triples.
        Raises when the surviving headroom cannot absorb the evacuation.
        """
        cfg = self.cfg
        sizes = ex.sizes()
        need = int(sizes[k_new:].sum())
        free = self._free_rows_per_device(ex.row_of_bucket)
        have = int(free[:k_new].sum())
        if need > have:
            raise ValueError(
                f"cannot shrink to k={k_new}: {need} real buckets must "
                f"evacuate but survivors have only {have} free headroom "
                f"rows (raise EngineConfig.headroom)"
            )
        drains = []
        for d in range(k_new, cfg.k):
            while ex.sizes()[d] > 0:
                free = self._free_rows_per_device(ex.row_of_bucket)
                free[k_new:] = -1  # dying PIDs never receive
                dst = int(np.argmax(free))
                moved = ex.apply(
                    MovePlan(src=d, dst=dst, units=1, kind="bucket"),
                    keep_min=0)
                assert moved == 1, (d, dst, moved)
                drains.append((d, dst, moved))
        return drains

    def rescale(self, ex, k_new: int, g, b: np.ndarray,
                buckets_per_dev: Optional[int] = None,
                strict: bool = False):
        """Grow/shrink the PID axis mid-solve without recomputing H.

        Shrink first *drains* the dying PIDs through the executor path
        (:meth:`drain_for_shrink` — headroom rows absorb the moves); then
        the axis is rebuilt at ``k_new`` over the store's cached
        engine-layout view (K3's edge table or K2's visit table built
        anew on the device) and the fluid pair ``(F, H)`` is carried
        over in node space (the invariant ``B = (I−P)H + F`` travels with
        it).  Grow is the same rebuild without a drain.

        When the survivors' headroom cannot absorb the evacuation the
        drain is skipped and the state rides the node-space carry alone
        (``strict=True`` raises instead).  The PIDs share this engine's
        device, so ``k_new`` is not bounded by the cards present.

        Returns ``(engine, executor, drains)`` — a NEW engine at
        ``k_new`` PIDs with a freshly seeded policy, its executor in the
        cold-start bucket layout of ``k_new``, and the executed drain
        triples.
        """
        cfg = self.cfg
        if k_new == cfg.k:
            return self, ex, []
        if k_new < 1:
            raise ValueError(f"k_new must be >= 1, got {k_new}")
        drains = []
        if k_new < cfg.k:
            need = int(ex.sizes()[k_new:].sum())
            have = int(self._free_rows_per_device(
                ex.row_of_bucket)[:k_new].sum())
            if need <= have or strict:
                drains = self.drain_for_shrink(ex, k_new)
        f_nodes = self.gather_nodes(ex.state.f, ex.row_of_bucket)
        h_nodes = self.gather_nodes(ex.state.h, ex.row_of_bucket)
        new_cfg = dataclasses.replace(
            cfg, k=k_new,
            buckets_per_dev=(buckets_per_dev if buckets_per_dev is not None
                             else cfg.buckets_per_dev))
        arrays = build_engine_arrays(g, b, new_cfg)
        engine = DistributedEngine(arrays, new_cfg)
        new_ex = BucketMoveExecutor(engine,
                                    engine.init_state(f_nodes, h_nodes))
        return engine, new_ex, drains
