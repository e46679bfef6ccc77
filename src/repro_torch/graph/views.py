"""View builders over the canonical CSR.

Every backend representation the solvers consume is derived here from
one canonical out-adjacency CSR (edges sorted by ``(src, dst)``,
deduplicated):

* :func:`build_canonical_csr` — the canonical arrays themselves;
* :func:`build_bsr` / :class:`BsrTiles` — the frontier kernel's BSR tile
  pool plus its block-row occupancy map;
* :func:`build_bucketed` — the engine's slotted bucket layout
  (:class:`repro_torch.core.graph.BucketedGraph`);
* :func:`build_engine_layout` / :class:`EngineLayout` — the graph-derived
  half of the engine's arrays, including the stable-id tile grouping of
  ``engine:bsr``.

These functions are vectorized over buckets, rows and edges where the
reference loops in Python; ``tests/test_torch_engine.py`` holds their
arrays equal to the reference's.  The incremental patchers of
``repro.graph.views`` arrive with the graph-delta slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .delta import edge_keys as _edge_keys

__all__ = [
    "BsrTiles",
    "EngineLayout",
    "build_canonical_csr",
    "build_bsr",
    "build_bucketed",
    "build_engine_layout",
    "tile_groups",
    "dense_tiles",
]


def build_canonical_csr(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, weights) sorted by (src, dst).

    Parallel (src, dst) entries are merged by summing their weights —
    the same multigraph semantics as ``CSRGraph.to_dense`` — so any
    multigraph CSR canonicalizes to an equivalent simple graph.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    keys = _edge_keys(src, dst)
    if keys.size:
        first = np.ones(keys.size, dtype=bool)
        first[1:] = keys[1:] != keys[:-1]
        if not first.all():
            w = np.add.reduceat(w, np.nonzero(first)[0])
            src, dst = src[first], dst[first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int32), w


@dataclasses.dataclass
class BsrTiles:
    """Host-side BSR of P: sorted block keys + the occupancy map.

    ``blocks[t]`` is the dense ``[bs, bs]`` tile of block row
    ``block_row[t]`` / block column ``block_col[t]`` with tiles sorted
    by ``block_row * nb + block_col`` (the :func:`repro_torch.kernels.
    diffusion.ref.csr_to_bsr` layout).
    """

    blocks: np.ndarray  # [n_blocks, bs, bs] float32
    block_row: np.ndarray  # [n_blocks] int32
    block_col: np.ndarray  # [n_blocks] int32
    n_row_blocks: int
    bs: int

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def row_occupied(self) -> np.ndarray:
        occ = np.zeros(self.n_row_blocks, dtype=bool)
        occ[self.block_row] = True
        return occ

    def keys(self) -> np.ndarray:
        return (self.block_row.astype(np.int64) * self.n_row_blocks
                + self.block_col.astype(np.int64))

    def to_device(self, device):
        """Upload as the kernel-facing :class:`BsrMatrix` on ``device``."""
        from ..kernels.diffusion import BsrMatrix

        return BsrMatrix(self.blocks, self.block_row, self.block_col,
                         self.n_row_blocks, self.bs, device=device)


def build_bsr(indptr, indices, weights, n: int, bs: int) -> BsrTiles:
    from ..kernels.diffusion.ref import csr_to_bsr

    blocks, br, bc, nrb = csr_to_bsr(
        np.asarray(indptr), np.asarray(indices), np.asarray(weights), n, bs)
    return BsrTiles(blocks=blocks, block_row=br, block_col=bc,
                    n_row_blocks=nrb, bs=bs)


# --------------------------------------------------------------------------- #
# bucketed view (engine slotted layout)
# --------------------------------------------------------------------------- #
def build_bucketed(csr_graph, n_buckets: int,
                   order: Optional[np.ndarray] = None):
    """Pack the graph into ``n_buckets`` equal buckets of slots.

    Bucket ``b``'s edge buffer lists the out-edges of its slots in slot
    order, each node's edges in CSR order, then zero padding up to the
    largest bucket's edge count.
    """
    from ..core.graph import BucketedGraph

    g = csr_graph
    if order is None:
        order = np.arange(g.n, dtype=np.int64)
    bucket_size = -(-g.n // n_buckets)  # ceil
    n_slots = n_buckets * bucket_size

    node_of_slot = np.full(n_slots, -1, dtype=np.int32)
    node_of_slot[: g.n] = order
    slot_of_node = np.empty(g.n, dtype=np.int32)
    slot_of_node[order] = np.arange(g.n, dtype=np.int32)

    deg = np.zeros(n_slots, dtype=np.int64)
    valid = node_of_slot >= 0
    deg[valid] = g.out_degree()[node_of_slot[valid]]
    out_deg = deg.astype(np.int32).reshape(n_buckets, bucket_size)
    edge_cap = max(1, int(out_deg.sum(axis=1).max()))

    # every edge once, enumerated in (slot, CSR) order
    total = int(deg.sum())
    edge = np.arange(total, dtype=np.int64)
    slot = np.repeat(np.arange(n_slots, dtype=np.int64), deg)
    first = np.cumsum(deg) - deg  # first edge of each slot
    bucket = slot // bucket_size
    pos = edge - first[bucket * bucket_size]  # cursor in the bucket buffer
    csr = g.indptr[node_of_slot[slot]] + (edge - first[slot])

    src_slot = np.zeros((n_buckets, edge_cap), dtype=np.int32)
    dst = np.zeros((n_buckets, edge_cap), dtype=np.int32)
    wgt = np.zeros((n_buckets, edge_cap), dtype=np.float32)
    src_slot[bucket, pos] = slot % bucket_size
    dst[bucket, pos] = slot_of_node[g.indices[csr]]
    wgt[bucket, pos] = g.weights[csr]
    return BucketedGraph(
        node_of_slot=node_of_slot.reshape(n_buckets, bucket_size),
        slot_of_node=slot_of_node,
        src_slot=src_slot,
        dst=dst,
        wgt=wgt,
        out_deg=out_deg,
        n=g.n,
        n_edges=g.n_edges,
    )


# --------------------------------------------------------------------------- #
# engine layout view (the engine's arrays minus the RHS-dependent f0)
# --------------------------------------------------------------------------- #
def tile_groups(dst_bucket: np.ndarray, wgt: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group each row's real edges (``wgt != 0``) by destination bucket.

    Returns ``(tile_dst [R, T], t_counts [R], t_of_edge)``: row ``r``'s
    tiles ``t < t_counts[r]`` push into the stable buckets
    ``tile_dst[r, t]`` in ascending order (unused slots hold 0), T is the
    largest ``t_counts`` (at least 1), and ``t_of_edge`` gives the tile
    slot of every real edge in row-major ``np.nonzero(wgt != 0)`` order.
    """
    r = wgt.shape[0]
    rows, cols = np.nonzero(wgt != 0)
    key = rows.astype(np.int64) * r + dst_bucket[rows, cols]
    uniq, inv = np.unique(key, return_inverse=True)
    u_row = uniq // r
    t_counts = np.bincount(u_row, minlength=r).astype(np.int32)
    u_t = np.arange(uniq.size) - (np.cumsum(t_counts) - t_counts)[u_row]
    tile_dst = np.zeros((r, max(1, int(t_counts.max(initial=0)))),
                        dtype=np.int32)
    tile_dst[u_row, u_t] = uniq % r
    return tile_dst, t_counts, u_t[inv.reshape(-1)]


def dense_tiles(src_slot: np.ndarray, dst_bucket: np.ndarray,
                dst_slot: np.ndarray, wgt: np.ndarray, s: int,
                dtype) -> np.ndarray:
    """The dense ``[R, T, S, S]`` tile pool on the host:
    ``tiles[r, t][dst_slot, src_slot] = weight`` of row ``r``'s edges into
    bucket ``tile_dst[r, t]``.  Tests and small problems only: the
    engine fills its pool on its own device from the real edges."""
    tile_dst, _, t_of_edge = tile_groups(dst_bucket, wgt)
    rows, cols = np.nonzero(wgt != 0)
    tiles = np.zeros((wgt.shape[0], tile_dst.shape[1], s, s), dtype=dtype)
    np.add.at(tiles, (rows, t_of_edge, dst_slot[rows, cols],
                      src_slot[rows, cols]), wgt[rows, cols])
    return tiles


@dataclasses.dataclass
class EngineLayout:
    """Graph-derived half of the engine's arrays (DESIGN.md §3/§7).

    Rows are *initial* bucket positions (``pos_of_bucket`` maps stable
    bucket id -> home row).  Tiled layouts (``engine:bsr``) carry the
    stable-id tile grouping: ``tile_dst`` / ``t_counts`` and the
    per-slot real-edge counts; the dense tile pool itself is
    :attr:`tiles`, built on demand.
    """

    w: np.ndarray  # [R, S] float64 selection weights (0 = inert slot)
    src_slot: np.ndarray  # [R, E] int32
    dst_bucket: np.ndarray  # [R, E] int32 stable bucket id
    dst_slot: np.ndarray  # [R, E] int32
    wgt: np.ndarray  # [R, E] float64 (0 = padding edge)
    pos_of_bucket: np.ndarray  # [R] int32
    node_of_slot: np.ndarray  # [R, S] int32
    n: int
    n_edges: int
    k: int
    buckets_per_dev: int
    headroom: int
    tile_dst: Optional[np.ndarray] = None  # [R, T] int32
    slot_out_deg: Optional[np.ndarray] = None  # [R, S] int32
    t_counts: Optional[np.ndarray] = None  # [R] int32 distinct dst buckets
    tile_dtype: Optional[np.dtype] = None  # dtype of :attr:`tiles`

    @property
    def n_rows(self) -> int:
        return int(self.w.shape[0])

    @property
    def bucket_size(self) -> int:
        return int(self.w.shape[1])

    @property
    def tiles(self) -> Optional[np.ndarray]:
        """The dense ``[R, T, S, S]`` host pool (see :func:`dense_tiles`),
        materialized on each access; None for an untiled layout."""
        if self.tile_dst is None:
            return None
        return dense_tiles(self.src_slot, self.dst_bucket, self.dst_slot,
                           self.wgt, self.bucket_size, self.tile_dtype)


def build_engine_layout(
    store,
    k: int,
    buckets_per_dev: int,
    headroom: int,
    tiled: bool,
    dtype: np.dtype,
    order: Optional[np.ndarray] = None,
) -> EngineLayout:
    """Bucketize the store's graph into the engine's fixed-shape layout.

    Real buckets fill ``buckets_per_dev - headroom`` rows per device;
    the rest are inert landing rows for dynamic bucket moves.  Derives
    from the store's bucketed view.
    """
    from ..core.diteration import default_weights

    real_per_dev = buckets_per_dev - headroom
    if real_per_dev < 1:
        raise ValueError("headroom must leave >= 1 real bucket per device")
    n_real = k * real_per_dev
    bg = store.bucketed(n_real, order=order)
    g = store.csr()
    s = bg.bucket_size
    e = bg.edge_cap
    r = k * buckets_per_dev

    bids = np.arange(n_real)
    rows = (bids // real_per_dev) * buckets_per_dev + bids % real_per_dev
    inert = np.setdiff1d(np.arange(r), rows)  # ascending: (device, slot)
    pos_of_bucket = np.zeros(r, dtype=np.int32)
    pos_of_bucket[bids] = rows
    pos_of_bucket[n_real:] = inert
    node_of_slot = np.full((r, s), -1, dtype=np.int32)
    node_of_slot[rows] = bg.node_of_slot
    w = np.zeros((r, s), dtype=np.float64)
    valid = node_of_slot >= 0
    w[valid] = default_weights(g)[node_of_slot[valid]]
    src_slot = np.zeros((r, e), dtype=np.int32)
    dst_bucket = np.zeros((r, e), dtype=np.int32)
    dst_slot = np.zeros((r, e), dtype=np.int32)
    wgt = np.zeros((r, e), dtype=np.float64)
    src_slot[rows] = bg.src_slot
    dst_bucket[rows] = bg.dst // s  # stable id
    dst_slot[rows] = bg.dst % s
    wgt[rows] = bg.wgt
    layout = EngineLayout(
        w=w, src_slot=src_slot, dst_bucket=dst_bucket, dst_slot=dst_slot,
        wgt=wgt, pos_of_bucket=pos_of_bucket, node_of_slot=node_of_slot,
        n=g.n, n_edges=g.n_edges, k=k, buckets_per_dev=buckets_per_dev,
        headroom=headroom,
    )
    if tiled:
        layout.tile_dst, layout.t_counts, _ = tile_groups(dst_bucket, wgt)
        layout.tile_dtype = np.dtype(dtype)
        real_rows, real_cols = np.nonzero(wgt != 0)
        layout.slot_out_deg = np.bincount(
            real_rows * s + src_slot[real_rows, real_cols],
            minlength=r * s).astype(np.int32).reshape(r, s)
    return layout
