"""View builders and incremental patchers over the canonical CSR.

Every backend representation the solvers consume is derived here from
one canonical out-adjacency CSR (edges sorted by ``(src, dst)``,
deduplicated), and can be *patched* under a
:class:`~repro_torch.graph.delta.GraphDelta` instead of rebuilt:

* :func:`build_canonical_csr` / :func:`splice_csr` — the canonical
  arrays themselves; the splice removes, inserts and reweights edges
  keeping the ``(src, dst)`` order, so its result is bit-identical to a
  build over the mutated edge list;
* :func:`build_bsr` / :func:`patch_bsr` / :class:`BsrTiles` — the frontier
  kernel's BSR tile pool plus its block-row occupancy map; the patcher
  rewrites only the *dirty tiles* (block keys holding a changed edge),
  drops tiles that empty out and inserts new ones in key order;
* :func:`build_bucketed` / :func:`patch_bucketed` — the engine's slotted
  bucket layout (:class:`repro_torch.core.graph.BucketedGraph`); only the
  buckets owning a changed source node are refilled (the edge capacity
  re-derived, the buffers re-padded when it moves);
* :func:`build_engine_layout` / :func:`patch_engine_layout` /
  :class:`EngineLayout` — the graph-derived half of the engine's arrays,
  including the stable-id tile grouping of ``engine:bsr``; dirty rows
  follow dirty buckets, and their tile grouping is re-derived
  (:func:`_retile_rows`) unless the tile capacity T moves.

These functions are vectorized over buckets, rows and edges where the
reference loops in Python; ``tests/test_torch_engine.py`` and
``tests/test_torch_graph_delta.py`` hold their arrays equal to the
reference's, and every patched view equal to a rebuild, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .delta import GraphDelta, edge_keys as _edge_keys

__all__ = [
    "BsrTiles",
    "EngineLayout",
    "build_canonical_csr",
    "splice_csr",
    "build_bsr",
    "patch_bsr",
    "build_bucketed",
    "patch_bucketed",
    "build_engine_layout",
    "patch_engine_layout",
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


def splice_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    n: int,
    delta: GraphDelta,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply ``delta`` to canonical CSR arrays; returns fresh arrays.

    Keeps the (src, dst) sort order, so the result is bit-identical to
    :func:`build_canonical_csr` over the mutated edge list.  Raises
    when an added edge already exists or a removed/reweighted one
    does not.  Vectorized throughout (a 12M-edge splice is a few
    array passes).
    """
    edge_src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keys = _edge_keys(edge_src, indices.astype(np.int64))
    weights = weights.copy()

    def find(pk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        pos = np.searchsorted(keys, pk)
        if not keys.size:
            return pos, np.zeros(pk.size, dtype=bool)
        return pos, keys[np.minimum(pos, keys.size - 1)] == pk

    def locate(pairs: np.ndarray, what: str) -> np.ndarray:
        pos, ok = find(_edge_keys(pairs[:, 0], pairs[:, 1]))
        if not ok.all():
            bad = pairs[~ok][0]
            raise ValueError(
                f"{what} edge ({bad[0]}, {bad[1]}) does not exist")
        return pos

    if delta.reweighted.shape[0]:
        weights[locate(delta.reweighted, "reweighted")] = delta.reweighted_w
    keep = np.ones(keys.size, dtype=bool)
    if delta.removed.shape[0]:
        keep[locate(delta.removed, "removed")] = False
    kept_keys = keys[keep]
    new_idx, new_w, new_src = indices[keep], weights[keep], edge_src[keep]
    if delta.added.shape[0]:
        if (delta.added >= n).any() or (delta.added < 0).any():
            raise ValueError("added edge endpoint out of range")
        aorder = np.lexsort((delta.added[:, 1], delta.added[:, 0]))
        apairs = delta.added[aorder]
        ak = _edge_keys(apairs[:, 0], apairs[:, 1])
        _, exists = find(ak)
        if exists.any():
            bad = apairs[exists][0]
            raise ValueError(
                f"added edge ({bad[0]}, {bad[1]}) already exists "
                "(use reweighted)")
        ins = np.searchsorted(kept_keys, ak)
        new_idx = np.insert(new_idx, ins, apairs[:, 1].astype(np.int32))
        new_w = np.insert(new_w, ins, delta.added_w[aorder])
        new_src = np.insert(new_src, ins, apairs[:, 0])
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_src, minlength=n), out=new_indptr[1:])
    return new_indptr, new_idx, new_w


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


def _bsr_tile_from_csr(indptr, indices, weights, n, bs, br, bc):
    """Rebuild one [bs, bs] tile (block row br, block col bc) from CSR."""
    lo_node = bc * bs
    hi_node = min((bc + 1) * bs, n)
    lo, hi = indptr[lo_node], indptr[hi_node]
    dst = indices[lo:hi].astype(np.int64)
    m = (dst // bs) == br
    tile = np.zeros((bs, bs), dtype=np.float32)
    if m.any():
        src = np.repeat(
            np.arange(lo_node, hi_node, dtype=np.int64),
            np.diff(indptr[lo_node:hi_node + 1]))
        # the same accumulate-into-float32 as csr_to_bsr (bit parity)
        tile[dst[m] % bs, src[m] % bs] += weights[lo:hi][m]
    return tile


def patch_bsr(view: BsrTiles, indptr, indices, weights, n: int,
              delta: GraphDelta) -> BsrTiles:
    """Rewrite only the dirty tiles of ``view`` for the PATCHED csr.

    Dirty tiles = block keys containing any changed edge.  Tiles that
    become all-zero are dropped (matching a build from scratch); new
    nonzero tiles are inserted in key order.  The clean tiles move into
    the new pool as runs of consecutive slices, one copy each (the
    pool is gigabytes at N=2**21).  Returns a new :class:`BsrTiles`; the
    old one is left as it was.
    """
    bs, nb = view.bs, view.n_row_blocks
    src, dst = delta.touched_edges()
    if src.size == 0:
        return view
    dirty = np.unique((dst // bs) * nb + (src // bs))
    old_keys = view.keys()
    clean = ~np.isin(old_keys, dirty)
    # a view built over ZERO edges is one all-zero placeholder tile
    # (csr_to_bsr's degenerate form), not a real tile — never carry it
    # into a merge.  Detected exactly via the pre-patch edge count (a
    # genuine zero-weight edge's tile is indistinguishable by bytes).
    n_pre = int(indptr[-1]) - delta.added.shape[0] + delta.removed.shape[0]
    if n_pre == 0:
        clean[:] = False
    fresh_keys, fresh_tiles = [], []
    for key in dirty:
        tile = _bsr_tile_from_csr(indptr, indices, weights, n, bs,
                                  int(key // nb), int(key % nb))
        if np.any(tile):
            fresh_keys.append(key)
            fresh_tiles.append(tile)
    clean_idx = np.nonzero(clean)[0]
    keys = np.sort(np.concatenate(
        [old_keys[clean_idx], np.asarray(fresh_keys, dtype=np.int64)]))
    if keys.size == 0:  # degenerate all-zero matrix, csr_to_bsr's form
        return BsrTiles(blocks=np.zeros((1, bs, bs), dtype=np.float32),
                        block_row=np.zeros(1, dtype=np.int32),
                        block_col=np.zeros(1, dtype=np.int32),
                        n_row_blocks=nb, bs=bs)
    # the clean tiles keep their order: they move as maximal runs that are
    # consecutive in both the old pool and the new one.  Every write goes
    # in ascending position, fresh tiles between the runs: the new pool's
    # pages are first touched in order (scattered first touches of a
    # gigabyte pool cost several times the copy)
    out_pos = np.searchsorted(keys, old_keys[clean_idx])
    cut = np.nonzero((np.diff(clean_idx) != 1) | (np.diff(out_pos) != 1))[0]
    starts = np.concatenate([[0], cut + 1]).astype(np.int64)
    ends = np.concatenate([cut + 1, [clean_idx.size]]).astype(np.int64)
    writes = sorted(
        [(int(out_pos[a]), int(clean_idx[a]), int(b - a), None)
         for a, b in zip(starts.tolist(), ends.tolist()) if b > a]
        + [(pos, 0, 1, tile) for pos, tile in zip(
            np.searchsorted(keys, fresh_keys).tolist(), fresh_tiles)],
        key=lambda w: w[0])
    blocks = np.empty((keys.size, bs, bs), dtype=np.float32)
    for pos, old, count, tile in writes:
        if tile is None:
            blocks[pos:pos + count] = view.blocks[old:old + count]
        else:
            blocks[pos] = tile
    return BsrTiles(
        blocks=blocks,
        block_row=(keys // nb).astype(np.int32),
        block_col=(keys % nb).astype(np.int32),
        n_row_blocks=nb, bs=bs,
    )


# --------------------------------------------------------------------------- #
# bucketed view (engine slotted layout)
# --------------------------------------------------------------------------- #
def _fill_buckets(bg, buckets: np.ndarray, indptr, indices,
                  weights) -> None:
    """Refill the edge buffers and out-degrees of ``buckets`` from the
    (patched) CSR: bucket ``b``'s buffer lists the out-edges of its slots
    in slot order, each node's edges in CSR order, then zero padding."""
    s = bg.bucket_size
    buckets = np.asarray(buckets, dtype=np.int64)
    bg.src_slot[buckets] = 0
    bg.dst[buckets] = 0
    bg.wgt[buckets] = 0.0
    nos = bg.node_of_slot[buckets].reshape(-1)
    deg = np.zeros(nos.size, dtype=np.int64)
    valid = nos >= 0
    deg[valid] = indptr[nos[valid] + 1] - indptr[nos[valid]]
    bg.out_deg[buckets] = deg.reshape(-1, s)
    # every edge of these buckets once, in (bucket, slot, CSR) order
    edge = np.arange(int(deg.sum()), dtype=np.int64)
    slot = np.repeat(np.arange(nos.size, dtype=np.int64), deg)
    first = np.cumsum(deg) - deg  # first edge of each slot
    local = slot // s  # index into ``buckets``
    pos = edge - first[local * s]  # cursor in the bucket buffer
    csr = indptr[nos[slot]] + (edge - first[slot])
    row = buckets[local]
    bg.src_slot[row, pos] = slot % s
    bg.dst[row, pos] = bg.slot_of_node[indices[csr]]
    bg.wgt[row, pos] = weights[csr]


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
    edge_cap = max(1, int(deg.reshape(n_buckets, bucket_size)
                          .sum(axis=1).max()))
    bg = BucketedGraph(
        node_of_slot=node_of_slot.reshape(n_buckets, bucket_size),
        slot_of_node=slot_of_node,
        src_slot=np.zeros((n_buckets, edge_cap), dtype=np.int32),
        dst=np.zeros((n_buckets, edge_cap), dtype=np.int32),
        wgt=np.zeros((n_buckets, edge_cap), dtype=np.float32),
        out_deg=np.zeros((n_buckets, bucket_size), dtype=np.int32),
        n=g.n,
        n_edges=g.n_edges,
    )
    _fill_buckets(bg, np.arange(n_buckets), g.indptr, g.indices, g.weights)
    return bg


def patch_bucketed(bg, indptr, indices, weights, n_edges: int,
                   delta: GraphDelta):
    """Refill only the buckets owning a changed source node, in place.

    The edge capacity is re-derived from the patched out-degrees; when it
    moves, the buffers are re-padded (clean buckets copied, dirty ones
    refilled) — the result is always bit-identical to
    :func:`build_bucketed` on the patched graph.
    """
    changed = delta.touched_sources()
    if changed.size == 0:
        return bg
    dirty = np.unique(bg.slot_of_node[changed] // bg.bucket_size)
    flat = bg.out_deg.reshape(-1)  # a view: out_deg is contiguous
    flat[bg.slot_of_node[changed]] = indptr[changed + 1] - indptr[changed]
    new_cap = max(1, int(bg.out_deg.sum(axis=1).max()))
    if new_cap != bg.edge_cap:
        keep = min(new_cap, bg.edge_cap)
        for name in ("src_slot", "dst", "wgt"):
            old = getattr(bg, name)
            fresh = np.zeros((bg.n_buckets, new_cap), dtype=old.dtype)
            fresh[:, :keep] = old[:, :keep]
            setattr(bg, name, fresh)
    _fill_buckets(bg, dirty, indptr, indices, weights)
    bg.n_edges = n_edges
    return bg


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
    def n_real(self) -> int:
        """Real (graph-holding) buckets; the rest are inert headroom."""
        return self.k * (self.buckets_per_dev - self.headroom)

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


def _retile_rows(layout: EngineLayout, rows: np.ndarray) -> None:
    """Re-derive the tile grouping of ``rows`` in place: each row's
    ``tile_dst`` lists its distinct destination buckets ascending, zero
    after them, as :func:`tile_groups` builds it (``t_counts`` and the
    capacity T are the caller's)."""
    for row in rows:
        mask = layout.wgt[row] != 0
        uniq = np.unique(layout.dst_bucket[row][mask])
        layout.tile_dst[row] = 0
        layout.tile_dst[row, : uniq.size] = uniq


def patch_engine_layout(layout: EngineLayout, store, delta: GraphDelta,
                        order: Optional[np.ndarray] = None) -> EngineLayout:
    """Refresh the dirty rows of ``layout`` from the store's PATCHED views,
    in place.

    Dirty rows are the home rows of buckets owning a changed source node.
    Their selection weights (1/out-degree), edge buffers and, for a tiled
    layout, tile grouping and per-slot edge counts are re-derived: the
    grouping per dirty row (:func:`_retile_rows`) unless the tile capacity
    T (the most distinct destination buckets of any row) moves, in which
    case it is regrouped whole.  The dense pool (:attr:`EngineLayout.tiles`)
    and the engine's device tables derive from these arrays, so they
    follow.  ``order`` must be the node order the layout was BUILT with
    (the store's cache remembers it): its bucketed view carries the
    matching slot assignment.
    """
    from ..core.diteration import default_weights

    changed = delta.touched_sources()
    if changed.size == 0:
        return layout
    bg = store.bucketed(layout.n_real, order=order)
    s = layout.bucket_size
    dirty = np.unique(bg.slot_of_node[changed] // s)
    rows = layout.pos_of_bucket[dirty].astype(np.int64)
    if bg.edge_cap != layout.wgt.shape[1]:
        e = bg.edge_cap
        keep = min(e, layout.wgt.shape[1])
        for name in ("src_slot", "dst_bucket", "dst_slot", "wgt"):
            old = getattr(layout, name)
            fresh = np.zeros((layout.n_rows, e), dtype=old.dtype)
            fresh[:, :keep] = old[:, :keep]
            setattr(layout, name, fresh)
    nos = layout.node_of_slot[rows]
    valid = nos >= 0
    w = np.zeros(nos.shape, dtype=np.float64)
    w[valid] = default_weights(store.csr())[nos[valid]]
    layout.w[rows] = w
    layout.src_slot[rows] = bg.src_slot[dirty]
    layout.dst_bucket[rows] = bg.dst[dirty] // s
    layout.dst_slot[rows] = bg.dst[dirty] % s
    layout.wgt[rows] = bg.wgt[dirty]
    layout.n_edges = store.n_edges
    if layout.tile_dst is None:
        return layout
    for row in rows:
        mask = layout.wgt[row] != 0
        layout.t_counts[row] = np.unique(layout.dst_bucket[row][mask]).size
        layout.slot_out_deg[row] = np.bincount(
            layout.src_slot[row][mask], minlength=s)
    if max(1, int(layout.t_counts.max())) != layout.tile_dst.shape[1]:
        layout.tile_dst, layout.t_counts, _ = tile_groups(layout.dst_bucket,
                                                          layout.wgt)
    else:
        _retile_rows(layout, rows)
    return layout
