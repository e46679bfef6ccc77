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

The port has the read side of ``repro.graph.GraphStore``, with the same
view caching keys; ``apply_delta`` (and with it ``version`` ever moving
past 0) comes with the graph-delta slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from . import views as _views
from .delta import edge_keys

__all__ = ["GraphStore"]


def _order_token(order: Optional[np.ndarray]):
    # exact bytes, not hash(bytes): a cache-key collision would hand out a
    # view built for a different node order — silently wrong solutions
    if order is None:
        return None
    return np.asarray(order).tobytes()


class GraphStore:
    """Canonical sparse matrix + cached backend views."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 weights: np.ndarray, n: int):
        self._indptr = np.asarray(indptr, dtype=np.int64)
        self._indices = np.asarray(indices, dtype=np.int32)
        self._weights = np.asarray(weights, dtype=np.float64)
        self.n = int(n)
        self.version = 0
        self._views: Dict[tuple, object] = {}
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
        view = self._views.get(key)
        if view is None:
            view = _views.build_bsr(self._indptr, self._indices,
                                    self._weights, self.n, int(bs))
            self._views[key] = view
        return view

    def bucketed(self, n_buckets: int, order: Optional[np.ndarray] = None):
        key = ("bucket", int(n_buckets), _order_token(order))
        view = self._views.get(key)
        if view is None:
            view = _views.build_bucketed(self.csr(), int(n_buckets),
                                         order=order)
            self._views[key] = view
        return view

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
        view = self._views.get(key)
        if view is None:
            view = _views.build_engine_layout(
                self, int(k), int(buckets_per_dev), int(headroom),
                bool(tiled), np.dtype(dtype), order=order)
            self._views[key] = view
        return view

    def materialized_views(self) -> Tuple[tuple, ...]:
        """Cache keys of the views currently materialized (testing aid)."""
        return tuple(sorted(self._views, key=repr))
