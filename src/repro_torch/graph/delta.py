"""Edge churn as data: :class:`GraphDelta` + the PageRank churn helper
(the port's copy of ``repro.graph.delta``, numpy only).

A delta describes one batch of mutations to the diffusion matrix P
(out-adjacency: edge ``i -> j`` carries ``P[j, i]``):

* ``added``      — edges that do not exist yet, with their weights;
* ``removed``    — existing edges to drop;
* ``reweighted`` — existing edges whose weight changes.

The companion papers (arXiv:1202.3108 §"update equation",
arXiv:1301.3007) show the D-iteration fluid state survives matrix
drift: with ``F = B − (I−P)·H`` invariant along any schedule, changing
``P → P'`` re-seeds the residual as ``F' = F + (P'−P)·H`` — only the
*changed entries* of P contribute, so an incremental re-solve touches
O(|delta|) state instead of restarting cold.  :class:`GraphDelta` is
the unit that flows through :meth:`repro_torch.graph.GraphStore.apply_delta`
and :meth:`repro_torch.api.SolverSession.update_graph`.

For PageRank systems the link-level churn is *not* the P-level churn:
``P[j, i] = damping / out_deg(i)``, so adding or removing one link of
page ``i`` reweights every surviving out-edge of ``i``.
:func:`pagerank_edge_churn` expands link churn into the full P-level
:class:`GraphDelta` (added + removed + the implied reweighting).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["GraphDelta", "edge_keys", "invert_delta",
           "pagerank_edge_churn", "rotation_churn"]


def edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """THE composite edge identity: ``src << 32 | dst`` (int64).

    Single definition shared by the delta layer, the CSR splice, and
    the loaders — node ids are int32-ranged, so the key is
    collision-free and order-preserving under (src, dst) lexsort.
    """
    return np.asarray(src, np.int64) << 32 | np.asarray(dst, np.int64)


def _as_edge_array(pairs, name: str) -> np.ndarray:
    arr = np.asarray(pairs, dtype=np.int64)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"{name} must be [[src, dst], ...], got shape "
                         f"{arr.shape}")
    return arr


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of edge mutations on the diffusion matrix P.

    ``added``/``removed``/``reweighted`` are ``[*, 2]`` int64
    ``(src, dst)`` pairs; ``added_w``/``reweighted_w`` the matching
    weights.  Pairs must be unique within and across the three groups
    (an edge is added *or* removed *or* reweighted, once).
    """

    added: np.ndarray
    added_w: np.ndarray
    removed: np.ndarray
    reweighted: np.ndarray
    reweighted_w: np.ndarray

    def __post_init__(self):
        if self.added.shape[0] != self.added_w.shape[0]:
            raise ValueError("added / added_w length mismatch")
        if self.reweighted.shape[0] != self.reweighted_w.shape[0]:
            raise ValueError("reweighted / reweighted_w length mismatch")
        keys = np.concatenate([
            self._keys(self.added), self._keys(self.removed),
            self._keys(self.reweighted),
        ])
        if keys.size and np.unique(keys).size != keys.size:
            raise ValueError(
                "duplicate (src, dst) pairs across added/removed/reweighted"
            )

    @staticmethod
    def _keys(pairs: np.ndarray) -> np.ndarray:
        return edge_keys(pairs[:, 0], pairs[:, 1])

    @staticmethod
    def make(
        added_edges=None,
        removed_edges=None,
        reweighted=None,
    ) -> "GraphDelta":
        """Build a delta from loose inputs.

        ``added_edges``/``reweighted`` are ``(src, dst, w)`` triples
        (``[*, 3]`` array or tuple of three arrays); ``removed_edges``
        is ``(src, dst)`` pairs.
        """

        def split_weighted(x, name):
            if x is None:
                return (np.zeros((0, 2), np.int64),
                        np.zeros(0, np.float64))
            if isinstance(x, tuple):
                src, dst, w = x
                pairs = np.stack(
                    [np.asarray(src, np.int64), np.asarray(dst, np.int64)],
                    axis=1)
                return pairs, np.asarray(w, np.float64)
            arr = np.asarray(x)
            if arr.ndim != 2 or arr.shape[1] != 3:
                raise ValueError(f"{name} must be (src, dst, w) triples")
            return (arr[:, :2].astype(np.int64),
                    arr[:, 2].astype(np.float64))

        added, added_w = split_weighted(added_edges, "added_edges")
        rew, rew_w = split_weighted(reweighted, "reweighted")
        if removed_edges is None:
            removed = np.zeros((0, 2), np.int64)
        elif isinstance(removed_edges, tuple):
            src, dst = removed_edges
            removed = np.stack(
                [np.asarray(src, np.int64), np.asarray(dst, np.int64)],
                axis=1)
        else:
            removed = _as_edge_array(removed_edges, "removed_edges")
        return GraphDelta(added=added, added_w=added_w, removed=removed,
                          reweighted=rew, reweighted_w=rew_w)

    # ---- derived -----------------------------------------------------------
    @property
    def n_changes(self) -> int:
        return int(self.added.shape[0] + self.removed.shape[0]
                   + self.reweighted.shape[0])

    @property
    def is_empty(self) -> bool:
        return self.n_changes == 0

    def touched_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) arrays over every changed edge (all three groups)."""
        pairs = np.concatenate([self.added, self.removed, self.reweighted])
        return pairs[:, 0], pairs[:, 1]

    def touched_sources(self) -> np.ndarray:
        """Unique source nodes whose out-edge sets / weights change."""
        src, _ = self.touched_edges()
        return np.unique(src)

    def churn_per_node(self, n: int) -> np.ndarray:
        """[N] count of changed edges charged to each source node.

        This is the per-node magnitude the balance control plane
        consumes (``LoadSignal.from_graph_churn``): a PID whose nodes
        absorb the churn pays the view-patch + re-diffusion work.
        """
        src, _ = self.touched_edges()
        return np.bincount(src, minlength=n).astype(np.int64)


def invert_delta(store, delta: GraphDelta) -> GraphDelta:
    """The delta that undoes ``delta``, captured BEFORE it is applied.

    Must be called against the store state the delta would mutate: the
    inverse re-adds ``removed`` edges and restores ``reweighted`` edges
    at their *current* weights, which only exist pre-apply.  This is the
    rollback token :meth:`repro_torch.api.SolverSession.update_graph` captures
    so a failure after :meth:`GraphStore.apply_delta` (view patch,
    driver rebuild, re-seed) can restore the store instead of leaving
    the session serving over half-mutated views.
    """
    csr = store.csr()
    src_e, dst_e, w_e = csr.edge_list()
    sorted_keys = edge_keys(src_e, dst_e)

    def old_weights(pairs: np.ndarray, group: str) -> np.ndarray:
        if pairs.shape[0] == 0:
            return np.zeros(0, np.float64)
        keys = GraphDelta._keys(pairs)
        pos = np.searchsorted(sorted_keys, keys)
        ok = (pos < sorted_keys.size) & (sorted_keys[
            np.minimum(pos, sorted_keys.size - 1)] == keys)
        if not ok.all():
            bad = pairs[~ok][0]
            raise ValueError(
                f"cannot invert: {group} edge ({bad[0]}, {bad[1]}) "
                f"does not exist in the store")
        return w_e[pos].astype(np.float64)

    return GraphDelta(
        added=delta.removed,
        added_w=old_weights(delta.removed, "removed"),
        removed=delta.added,
        reweighted=delta.reweighted,
        reweighted_w=old_weights(delta.reweighted, "reweighted"),
    )


def pagerank_edge_churn(
    store,
    added_links=None,
    removed_links=None,
    damping: Optional[float] = None,
) -> GraphDelta:
    """Expand *link-graph* churn into the P-level :class:`GraphDelta`.

    ``store`` holds the PageRank diffusion matrix
    ``P[j, i] = damping / out_deg(i)``.  Adding/removing links of page
    ``i`` changes its out-degree, hence the weight of every surviving
    out-edge of ``i`` — those become ``reweighted`` entries; the links
    themselves become ``added`` (at the new uniform weight) / ``removed``.

    ``damping`` defaults to the value already baked into the store's
    weights (``w · out_deg`` of any existing edge) — passing a value
    that disagrees with the matrix would silently mix dampings.
    """
    added = _as_edge_array(
        added_links if added_links is not None else [], "added_links")
    removed = _as_edge_array(
        removed_links if removed_links is not None else [], "removed_links")
    g = store.csr()
    out_deg = g.out_degree()
    if damping is None:
        lead = np.nonzero(out_deg > 0)[0]
        if lead.size == 0:
            raise ValueError(
                "cannot derive damping from an edgeless store; pass it")
        i0 = int(lead[0])
        damping = float(g.out_neighbors(i0)[1][0] * out_deg[i0])
    new_deg = out_deg.copy()
    np.add.at(new_deg, added[:, 0], 1)
    np.subtract.at(new_deg, removed[:, 0], 1)
    if (new_deg < 0).any():
        raise ValueError("removed_links exceed a node's out-degree")
    touched = np.unique(np.concatenate([added[:, 0], removed[:, 0]]))
    rem_keys = GraphDelta._keys(removed)
    rew_src, rew_dst, rew_w = [], [], []
    for i in touched:
        js, _ = g.out_neighbors(int(i))
        if js.size == 0:
            continue
        keys = edge_keys(np.full(js.size, i), js)
        survive = ~np.isin(keys, rem_keys)
        js = js[survive]
        if js.size == 0 or new_deg[i] == 0:
            continue
        rew_src.append(np.full(js.size, i, dtype=np.int64))
        rew_dst.append(js.astype(np.int64))
        rew_w.append(np.full(js.size, damping / new_deg[i]))
    if rew_src:
        rew = np.stack([np.concatenate(rew_src),
                        np.concatenate(rew_dst)], axis=1)
        rw = np.concatenate(rew_w)
    else:
        rew = np.zeros((0, 2), np.int64)
        rw = np.zeros(0, np.float64)
    if (new_deg[added[:, 0]] == 0).any():  # pragma: no cover - impossible
        raise ValueError("added link on a node with new out-degree 0")
    aw = damping / new_deg[added[:, 0]].astype(np.float64) \
        if added.size else np.zeros(0, np.float64)
    return GraphDelta(added=added, added_w=aw, removed=removed,
                      reweighted=rew, reweighted_w=rw)


def rotation_churn(
    store,
    n_rotations: int,
    seed: int = 0,
    rank: Optional[np.ndarray] = None,
    exclude_top: float = 0.0,
) -> GraphDelta:
    """Link-rotation churn: pages swap one outlink for a fresh target.

    The canonical evolving-web workload (and the delta-re-solve test
    scenario): ``n_rotations`` edge-sampled source pages each drop one
    existing outlink and gain one new uniform-random outlink at the
    same weight — out-degrees are preserved, so a PageRank system needs
    no column renormalization and the delta is exactly ``2·n_rotations``
    changed edges.

    ``rank``/``exclude_top`` optionally keep the top fraction of nodes
    (by ``rank``, e.g. a PageRank estimate) churn-free — mirroring real
    crawls, where established hubs are stable and link churn lives in
    the long tail.  Since a rotation at page ``i`` injects
    ``|ΔP_col(i)|·H_i ≈ 1.7/d_i · H_i`` of fluid and edge sampling
    picks ``i`` with probability ``d_i/L``, each page's expected
    contribution is ``∝ H_i`` — so excluding the top rank mass directly
    bounds the injected fluid ``|F'−F|``.
    """
    rng = np.random.default_rng(seed)
    csr = store.csr()
    src_e, dst_e, w_e = csr.edge_list()
    # canonical CSR => keys already sorted: membership via searchsorted
    # instead of boxing all L keys into a Python set (this runs on the
    # serving path, per graph-update request)
    sorted_keys = edge_keys(src_e, dst_e)
    fresh: set = set()  # keys added by THIS delta

    def is_edge(key: int) -> bool:
        i = int(np.searchsorted(sorted_keys, key))
        return (i < sorted_keys.size and sorted_keys[i] == key) \
            or key in fresh

    ok = np.ones(src_e.shape[0], dtype=bool)
    if exclude_top > 0.0:
        if rank is None:
            raise ValueError("exclude_top needs a rank array")
        hot = np.argsort(-rank)[: int(exclude_top * csr.n)]
        ok = ~np.isin(src_e, hot)
    cand = np.nonzero(ok)[0]
    take = rng.choice(cand, size=min(n_rotations, cand.size),
                      replace=False)
    removed, added, used = [], [], set()
    for e in take:
        s, d_old = int(src_e[e]), int(dst_e[e])
        if (s << 32) | d_old in used:
            continue
        for _ in range(64):  # rejection-sample a fresh destination
            d_new = int(rng.integers(0, csr.n))
            key = (s << 32) | d_new
            if d_new != s and not is_edge(key):
                removed.append((s, d_old))
                used.add((s << 32) | d_old)
                added.append((s, d_new, float(w_e[e])))
                fresh.add(key)
                break
    return GraphDelta.make(
        added_edges=np.array(added, dtype=np.float64).reshape(-1, 3),
        removed_edges=np.array(removed, dtype=np.int64).reshape(-1, 2),
    )
