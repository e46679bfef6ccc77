""":class:`GraphStore` — the sparse substrate every backend derives from.

The store owns the canonical out-adjacency CSR (edges sorted by
``(src, dst)``, deduplicated) and derives backend representations as
cached **views**:

====================  ====================================================
``csr()``             out-adjacency :class:`repro_torch.core.graph.CSRGraph`
``bsr(bs)``           frontier BSR tile pool + block-row occupancy map
``bucketed(nb)``      engine slotted layout (:class:`BucketedGraph`)
``engine_layout(…)``  engine arrays minus f0, optionally BSR-tiled
====================  ====================================================

:meth:`GraphStore.apply_delta` mutates the canonical CSR through an
order-preserving splice and **patches every materialized view in place**
(dirty BSR tiles, dirty buckets, dirty engine rows only), then bumps
``version``.  Patched views are bit-identical to a rebuild
(``tests/test_torch_graph_delta.py``).  The fluid state survives the
mutation too: with ``F = B − (I−P)·H`` invariant, ``P → P'`` re-seeds
``F' = F + (P'−P)·H`` — :meth:`repro_torch.api.SolverSession.update_graph`
is the serving path's consumer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from . import views as _views
from .delta import GraphDelta, edge_keys

__all__ = ["GraphStore"]


def _order_token(order: Optional[np.ndarray]):
    # exact bytes, not hash(bytes): a cache-key collision would hand out a
    # view built for a different node order — silently wrong solutions
    if order is None:
        return None
    return np.asarray(order).tobytes()


class GraphStore:
    """Canonical sparse matrix + cached, delta-patchable backend views."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 weights: np.ndarray, n: int):
        self._indptr = np.asarray(indptr, dtype=np.int64)
        self._indices = np.asarray(indices, dtype=np.int32)
        self._weights = np.asarray(weights, dtype=np.float64)
        self.n = int(n)
        self.version = 0
        # view cache: key -> (view, the node order it was built with)
        self._views: Dict[tuple, tuple] = {}
        self._csr = None

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(src, dst, w, n: int) -> "GraphStore":
        indptr, indices, weights = _views.build_canonical_csr(
            np.asarray(src), np.asarray(dst), np.asarray(w), n)
        return GraphStore(indptr, indices, weights, n)

    @staticmethod
    def from_csr(g) -> "GraphStore":
        """Wrap a :class:`CSRGraph`, normalizing row order to canonical."""
        src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
        return GraphStore.from_edges(src, g.indices, g.weights, g.n)

    @staticmethod
    def from_edge_file(path: str, n: Optional[int] = None,
                       weighted: bool = False,
                       comments: str = "#") -> "GraphStore":
        """Load a SNAP-style edge-list text file (``src dst`` per line).

        Lines starting with ``comments`` are skipped; with
        ``weighted=True`` a third column supplies edge weights
        (default 1.0).  Self-loops are dropped and duplicate edges
        deduplicated (first weight wins), matching the synthetic
        generators' conventions.  ``n`` defaults to ``max(id) + 1``.
        """
        data = np.loadtxt(path, comments=comments, ndmin=2,
                          dtype=np.float64)
        if data.size == 0:
            raise ValueError(f"edge file {path!r} holds no edges")
        if data.shape[1] < (3 if weighted else 2):
            raise ValueError(
                f"edge file {path!r} needs {'3' if weighted else '2'} "
                f"columns, found {data.shape[1]}")
        src = data[:, 0].astype(np.int64)
        dst = data[:, 1].astype(np.int64)
        w = (data[:, 2].astype(np.float64) if weighted
             else np.ones(src.shape[0]))
        if (src < 0).any() or (dst < 0).any():
            raise ValueError(f"edge file {path!r} holds negative node ids")
        n_eff = int(max(src.max(), dst.max())) + 1 if n is None else int(n)
        if n is not None and ((src >= n).any() or (dst >= n).any()):
            raise ValueError(f"edge file {path!r} holds ids >= n={n}")
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
        _, uniq = np.unique(edge_keys(src, dst), return_index=True)
        return GraphStore.from_edges(src[uniq], dst[uniq], w[uniq], n_eff)

    # ------------------------------------------------------------------ #
    # canonical accessors
    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return int(self._indices.shape[0])

    def csr(self):
        """The canonical view as a :class:`CSRGraph` (shares arrays)."""
        from ..core.graph import CSRGraph

        if self._csr is None:
            self._csr = CSRGraph(indptr=self._indptr, indices=self._indices,
                                 weights=self._weights, n=self.n)
        return self._csr

    def out_degree(self) -> np.ndarray:
        return np.diff(self._indptr).astype(np.int64)

    def dangling_mask(self) -> np.ndarray:
        return np.diff(self._indptr) == 0

    # ------------------------------------------------------------------ #
    # derived views (cached)
    # ------------------------------------------------------------------ #
    def bsr(self, bs: int = 128) -> "_views.BsrTiles":
        key = ("bsr", int(bs))
        hit = self._views.get(key)
        if hit is None:
            view = _views.build_bsr(self._indptr, self._indices,
                                    self._weights, self.n, int(bs))
            self._views[key] = (view, None)
            return view
        return hit[0]

    def bucketed(self, n_buckets: int, order: Optional[np.ndarray] = None):
        key = ("bucket", int(n_buckets), _order_token(order))
        hit = self._views.get(key)
        if hit is None:
            view = _views.build_bucketed(self.csr(), int(n_buckets),
                                         order=order)
            self._views[key] = (view, order)
            return view
        return hit[0]

    def engine_layout(
        self,
        k: int,
        buckets_per_dev: int,
        headroom: int,
        tiled: bool = False,
        dtype=np.float32,
        order: Optional[np.ndarray] = None,
    ) -> "_views.EngineLayout":
        key = ("engine", int(k), int(buckets_per_dev), int(headroom),
               bool(tiled), np.dtype(dtype).str, _order_token(order))
        hit = self._views.get(key)
        if hit is None:
            view = _views.build_engine_layout(
                self, int(k), int(buckets_per_dev), int(headroom),
                bool(tiled), np.dtype(dtype), order=order)
            self._views[key] = (view, order)
            return view
        return hit[0]

    def materialized_views(self) -> Tuple[tuple, ...]:
        """Cache keys of the views currently materialized (testing aid)."""
        return tuple(sorted(self._views, key=repr))

    # ------------------------------------------------------------------ #
    # the delta layer
    # ------------------------------------------------------------------ #
    def apply_delta(self, delta: GraphDelta) -> "GraphStore":
        """Mutate the canonical CSR and patch every materialized view.

        CSR splice first (order-preserving, so the arrays equal a
        canonical build over the mutated edge list), then each cached
        view is patched touching only its dirty tiles / buckets / rows:
        bucketed views before engine layouts (an engine layout derives
        from its bucketed view).  Bumps ``version``; returns ``self``.

        Bucketed views and engine layouts are patched **in place**: a
        consumer that captured one before the delta sees the patched
        arrays.  Problems pin the version they snapshot
        (``Problem.store_version``) and ``SolverSession`` refuses to run
        over a stale snapshot, so callers re-snapshot through
        ``problem.with_graph(store)`` (``SolverSession.update_graph`` does
        both steps at once).

        Transactional: a failed view patch rolls the CSR back to its
        pre-splice arrays and drops the whole view cache (a view may be
        half patched), then re-raises; the version does not move.
        """
        if not isinstance(delta, GraphDelta):
            raise TypeError(f"apply_delta wants a GraphDelta, got "
                            f"{type(delta).__name__}")
        if delta.is_empty:
            return self
        old_csr = (self._indptr, self._indices, self._weights, self._csr)
        self._indptr, self._indices, self._weights = _views.splice_csr(
            self._indptr, self._indices, self._weights, self.n, delta)
        self._csr = None  # old CSRGraph wrappers keep the old arrays
        try:
            # bucketed views first: engine layouts read them while patching
            for kind in ("bucket", "bsr", "engine"):
                for key, (view, order) in list(self._views.items()):
                    if key[0] != kind:
                        continue
                    if kind == "bucket":
                        patched = _views.patch_bucketed(
                            view, self._indptr, self._indices,
                            self._weights, self.n_edges, delta)
                    elif kind == "bsr":
                        patched = _views.patch_bsr(
                            view, self._indptr, self._indices,
                            self._weights, self.n, delta)
                    else:
                        patched = _views.patch_engine_layout(
                            view, self, delta, order=order)
                    self._views[key] = (patched, order)
        except Exception:
            (self._indptr, self._indices,
             self._weights, self._csr) = old_csr
            self._views.clear()
            raise
        self.version += 1
        return self
