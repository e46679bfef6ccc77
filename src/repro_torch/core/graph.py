"""Graph containers + generators for the D-iteration system (numpy).

The port's own copy of ``repro.core.graph``: the same seed gives the same
arrays byte for byte, so the parity tests can feed both packages one
graph.  The D-iteration solves ``X = P @ X + B`` where column ``i`` of
``P`` holds the outgoing diffusion weights of node ``i`` (``P[j, i]`` =
weight of edge i -> j).  The graph is therefore stored in *out-adjacency*
form (CSC of P == CSR of P^T): for each node, the list of its
out-neighbors and the corresponding column weights.

:class:`CSRGraph` is the compressed out-adjacency (indptr / indices /
weights) every solver consumes; :class:`repro_torch.graph.GraphStore`
derives the frontier kernel's BSR tile pool from it.
:class:`BucketedGraph` is the engine's bucket-major fixed-shape layout
(static shapes, bucket-granular dynamic repartition).

Generators reproduce the paper's synthetic data (§3.1: power-law 1/k^alpha for
in- and out-degree, alpha = 1.5), a web-graph stand-in matched to Table 4
(L/N ratio, dangling-node fraction), and the host-ordered block graph the
BSR kernels run at scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CSRGraph",
    "BucketedGraph",
    "bucketize",
    "power_law_graph",
    "webgraph_like",
    "host_block_graph",
    "pagerank_system",
    "random_dd_system",
]


@dataclasses.dataclass
class CSRGraph:
    """Out-adjacency of the diffusion matrix P (column-major of P).

    ``indices[indptr[i]:indptr[i+1]]`` are the out-neighbors ``j`` of node
    ``i`` and ``weights[...]`` the matching ``P[j, i]`` entries.
    """

    indptr: np.ndarray  # [N+1] int64
    indices: np.ndarray  # [L] int32
    weights: np.ndarray  # [L] float64
    n: int

    # ---- derived quantities -------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def in_degree(self) -> np.ndarray:
        deg = np.zeros(self.n, dtype=np.int64)
        np.add.at(deg, self.indices, 1)
        return deg

    def out_neighbors(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.weights[lo:hi]

    def dangling_mask(self) -> np.ndarray:
        return np.diff(self.indptr) == 0

    # ---- conversions ---------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Dense P with P[j, i] = weight of edge i -> j.  Small graphs only.

        Parallel edges accumulate (np.add.at — the same summation every
        solver's scatter applies; fancy ``+=`` would silently drop
        duplicates).
        """
        p = np.zeros((self.n, self.n), dtype=np.float64)
        for i in range(self.n):
            js, ws = self.out_neighbors(i)
            np.add.at(p, (js, np.full(js.size, i)), ws)
        return p

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w) arrays of length L (src repeated per out-edge)."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        return src, self.indices.astype(np.int32), self.weights

    def reorder(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel nodes so that new node ``k`` is old node ``perm[k]``.

        Used for the paper's node-ordering experiments (Tables 2/3: nodes
        ordered by out-degree / in-degree before partitioning).
        """
        perm = np.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n)
        counts = np.diff(self.indptr)[perm]
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        indices = np.empty_like(self.indices)
        weights = np.empty_like(self.weights)
        for new_i, old_i in enumerate(perm):
            lo, hi = self.indptr[old_i], self.indptr[old_i + 1]
            nlo = indptr[new_i]
            indices[nlo : nlo + (hi - lo)] = inv[self.indices[lo:hi]]
            weights[nlo : nlo + (hi - lo)] = self.weights[lo:hi]
        return CSRGraph(indptr=indptr, indices=indices, weights=weights, n=self.n)

    @staticmethod
    def from_edges(
        src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int
    ) -> "CSRGraph":
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(
            indptr=indptr,
            indices=dst.astype(np.int32),
            weights=w.astype(np.float64),
            n=n,
        )


# ------------------------------------------------------------------------------
# Bucket-major fixed-shape layout (the engine)
# ------------------------------------------------------------------------------
@dataclasses.dataclass
class BucketedGraph:
    """Bucket-major edge-list layout with static shapes.

    Nodes are packed into ``n_buckets`` buckets of ``bucket_size`` slots
    (padded with inert slots).  Each bucket carries a fixed-capacity edge
    buffer; edge ``e`` of bucket ``b`` reads fluid from local slot
    ``src_slot[b, e]`` and pushes to *global flattened slot* ``dst[b, e]``
    with weight ``wgt[b, e]``.  Padding edges have ``wgt == 0`` and point at
    slot 0 (harmless: zero contribution).

    The *bucket* is the unit of dynamic repartition: the slope controller
    moves whole buckets between PIDs, so every array here can stay
    statically shaped while ownership changes (DESIGN.md §3).
    """

    node_of_slot: np.ndarray  # [n_buckets, bucket_size] int32 global node id or -1
    slot_of_node: np.ndarray  # [N] int32 flattened slot id of each node
    src_slot: np.ndarray  # [n_buckets, edge_cap] int32 (local slot in bucket)
    dst: np.ndarray  # [n_buckets, edge_cap] int32 (global flattened slot)
    wgt: np.ndarray  # [n_buckets, edge_cap] float32
    out_deg: np.ndarray  # [n_buckets, bucket_size] int32 true out-degree
    n: int
    n_edges: int

    @property
    def n_buckets(self) -> int:
        return int(self.node_of_slot.shape[0])

    @property
    def bucket_size(self) -> int:
        return int(self.node_of_slot.shape[1])

    @property
    def edge_cap(self) -> int:
        return int(self.dst.shape[1])

    @property
    def n_slots(self) -> int:
        return self.n_buckets * self.bucket_size


def bucketize(
    g: CSRGraph,
    n_buckets: int,
    order: Optional[np.ndarray] = None,
) -> BucketedGraph:
    """Pack ``g`` into ``n_buckets`` equal buckets (node order preserved).

    ``order`` optionally permutes nodes before packing.  Edge buffers are
    sized to the max per-bucket edge count (padded elsewhere) — per-bucket
    skew is exactly what the dynamic controller then balances at runtime.
    Built by :func:`repro_torch.graph.views.build_bucketed`;
    ``GraphStore.bucketed(n_buckets)`` caches its result.
    """
    from ..graph.views import build_bucketed

    return build_bucketed(g, n_buckets, order=order)


# ------------------------------------------------------------------------------
# Generators
# ------------------------------------------------------------------------------
def _power_law_degrees(n: int, alpha: float, d_min: int, d_max: int, rng) -> np.ndarray:
    """Sample degrees from P(k) ∝ 1/k^alpha on [d_min, d_max] (inverse CDF)."""
    ks = np.arange(d_min, d_max + 1, dtype=np.float64)
    pmf = ks ** (-alpha)
    pmf /= pmf.sum()
    return rng.choice(ks.astype(np.int64), size=n, p=pmf)


def power_law_graph(
    n: int,
    alpha: float = 1.5,
    d_min: int = 0,
    d_max: Optional[int] = None,
    seed: int = 0,
    dedupe: bool = True,
) -> CSRGraph:
    """Synthetic graph per paper §3.1: power-law 1/k^alpha in- and out-degree.

    Out-degrees are sampled from the power law; each out-stub is wired to a
    destination drawn proportionally to a power-law in-degree weight
    (configuration-model style).  ``d_min = 0`` keeps a realistic dangling
    fraction (paper Table 4: 0.8–4.1%).  Weights are unnormalized adjacency
    (1.0); use :func:`pagerank_system` to build (P, B).
    """
    rng = np.random.default_rng(seed)
    if d_max is None:
        d_max = max(4, int(np.sqrt(n) * 4))
    out_deg = _power_law_degrees(n, alpha, max(d_min, 0) + 1, d_max, rng) - (
        1 if d_min == 0 else 0
    )
    # in-degree attractiveness, power-law as well
    in_w = _power_law_degrees(n, alpha, 1, d_max, rng).astype(np.float64)
    in_p = in_w / in_w.sum()

    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)
    dst = rng.choice(n, size=src.shape[0], p=in_p)
    # drop self loops
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if dedupe:
        key = src * n + dst
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
    w = np.ones(src.shape[0], dtype=np.float64)
    return CSRGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), w, n)


def webgraph_like(
    n: int,
    links_per_node: float = 12.9,
    dangling_frac: float = 0.041,
    seed: int = 1,
) -> CSRGraph:
    """uk-2007-05 stand-in matched to paper Table 4 (L/N, dangling fraction).

    Power-law degrees with a locality bias (web graphs link mostly within a
    host neighborhood) so partitions see realistic locality, plus an explicit
    dangling set.
    """
    rng = np.random.default_rng(seed)
    target_l = int(n * links_per_node)
    alpha = 1.5
    d_max = max(8, int(np.sqrt(n) * 8))
    out_deg = _power_law_degrees(n, alpha, 1, d_max, rng)
    out_deg = np.round(out_deg * (target_l / out_deg.sum())).astype(np.int64)
    out_deg = np.maximum(out_deg, 1)
    dangling = rng.choice(n, size=int(n * dangling_frac), replace=False)
    out_deg[dangling] = 0

    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)
    # locality bias: 80% of links land within +/- n/100 of the source
    local = rng.random(src.shape[0]) < 0.8
    span = max(2, n // 100)
    offs = rng.integers(-span, span + 1, size=src.shape[0])
    dst_local = np.clip(src + offs, 0, n - 1)
    in_w = _power_law_degrees(n, alpha, 1, d_max, rng).astype(np.float64)
    dst_global = rng.choice(n, size=src.shape[0], p=in_w / in_w.sum())
    dst = np.where(local, dst_local, dst_global)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]
    w = np.ones(src.shape[0], dtype=np.float64)
    return CSRGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), w, n)


def host_block_graph(
    n: int,
    host_size: int = 128,
    links_per_node: float = 8.0,
    intra_frac: float = 0.92,
    span_hosts: int = 2,
    dangling_frac: float = 0.02,
    alpha: float = 1.5,
    seed: int = 0,
) -> CSRGraph:
    """Host-ordered web-graph stand-in with block-compressible structure.

    Real web crawls sorted URL-lexicographically (e.g. uk-2007-05) put the
    bulk of their links inside the source's host and its neighbours — the
    locality WebGraph compression and the BSR diffusion kernel both exploit.
    Nodes are grouped into consecutive hosts of ``host_size``;
    ``intra_frac`` of the links stay inside the source's host, the rest land
    within ``±span_hosts`` hosts.  With BSR block size ``bs == host_size``
    the tiling therefore has at most ``2 * span_hosts + 1`` blocks per block
    column — dense MXU tiles instead of scattered singletons.

    Out-degrees are power-law ``1/k^alpha`` rescaled to ``links_per_node``;
    ``dangling_frac`` of the nodes keep zero out-degree (paper Table 4).
    """
    rng = np.random.default_rng(seed)
    d_max = max(8, int(np.sqrt(n)))
    out_deg = _power_law_degrees(n, alpha, 1, d_max, rng)
    target_l = int(n * links_per_node)
    out_deg = np.round(out_deg * (target_l / out_deg.sum())).astype(np.int64)
    out_deg = np.maximum(out_deg, 1)
    if dangling_frac > 0:
        dangling = rng.choice(n, size=int(n * dangling_frac), replace=False)
        out_deg[dangling] = 0

    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)
    host = src // host_size
    n_hosts = -(-n // host_size)
    intra = rng.random(src.shape[0]) < intra_frac
    # intra-host: uniform slot inside the source's host block
    dst_intra = host * host_size + rng.integers(0, host_size, src.shape[0])
    # inter-host: a nearby host (crawl-order neighbourhood)
    hop = rng.integers(-span_hosts, span_hosts + 1, src.shape[0])
    h2 = np.clip(host + hop, 0, n_hosts - 1)
    dst_inter = h2 * host_size + rng.integers(0, host_size, src.shape[0])
    dst = np.where(intra, dst_intra, dst_inter)
    dst = np.minimum(dst, n - 1)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]
    w = np.ones(src.shape[0], dtype=np.float64)
    return CSRGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), w, n)


def pagerank_system(
    g: CSRGraph, damping: float = 0.85
) -> Tuple[CSRGraph, np.ndarray]:
    """PageRank instance of X = P X + B on graph ``g``.

    P[j, i] = damping / out_deg(i) for each edge i->j; B = (1-damping)/N.
    Dangling fluid is absorbed into history (standard D-iteration treatment;
    DESIGN.md §1).  Returns (P_graph, B).
    """
    out_deg = g.out_degree().astype(np.float64)
    src, dst, _ = g.edge_list()
    w = damping / out_deg[src]
    p = CSRGraph.from_edges(src, dst, w, g.n)
    b = np.full(g.n, (1.0 - damping) / g.n, dtype=np.float64)
    return p, b


def random_dd_system(
    n: int, density: float = 0.05, rho: float = 0.8, seed: int = 0,
    signed: bool = True,
) -> Tuple[CSRGraph, np.ndarray]:
    """Random diagonally-dominant system (spectral radius <= rho) for tests.

    Entries may be signed (the paper's general case, §2).  Column sums of |P|
    are scaled to ``rho`` so convergence of the diffusion is guaranteed.
    """
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, False)
    vals = rng.standard_normal((n, n)) if signed else rng.random((n, n))
    p = np.where(mask, vals, 0.0)
    col_norm = np.abs(p).sum(axis=0)
    scale = np.where(col_norm > 0, rho / np.maximum(col_norm, 1e-12), 0.0)
    p = p * scale[None, :]
    # to out-adjacency CSR: edges i->j where p[j, i] != 0
    dst, src = np.nonzero(p)  # p[dst, src]
    w = p[dst, src]
    g = CSRGraph.from_edges(
        src.astype(np.int32), dst.astype(np.int32), w.astype(np.float64), n
    )
    b = rng.standard_normal(n) if signed else rng.random(n)
    return g, b.astype(np.float64)
