"""The :class:`Problem` spec — what the solver front door consumes.

A ``Problem`` is the full statement of one D-iteration instance
``X = P·X + B`` (DESIGN.md §1/§4): the diffusion matrix ``P`` (a
:class:`repro_torch.core.graph.CSRGraph` in out-adjacency form), the source
vector ``B``, the residual-to-error factor ``eps`` (``1 − damping`` for
PageRank systems, ``1 − rho`` in general), the stopping target, the
node-selection weights of §2.2.1, and — for the serving path — an
optional batch of extra right-hand sides (personalized PageRank
preference vectors).

Constructors:

* :meth:`Problem.pagerank` — builds ``(P, B)`` from a raw link graph
  with damping δ, optionally with a ``[N, C]`` personalization batch.
* :meth:`Problem.linear` — wraps an arbitrary spectral-radius<1 system
  (the paper's general signed case, §2).

A Problem *holds* the sparse substrate: ``problem.graph`` is the
:class:`repro_torch.graph.GraphStore` owning P, ``problem.p`` its
(snapshot) CSR view.  The Problem is the port's copy of
``repro.api.Problem``: host numpy data, no device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ..core.diteration import default_weights
from ..core.graph import CSRGraph, pagerank_system
from ..graph import GraphStore

__all__ = ["Problem"]


def _as_store_and_csr(g) -> tuple:
    """Normalize a GraphStore | CSRGraph into (store, csr_view)."""
    if isinstance(g, GraphStore):
        return g, g.csr()
    return None, g  # store created lazily by Problem.graph


@dataclasses.dataclass(frozen=True)
class Problem:
    """One solver instance of ``X = P·X + B``.

    ``p`` is the diffusion matrix in out-adjacency CSR form
    (``P[j, i]`` = weight of edge i → j), ``b`` the primary RHS,
    ``eps`` the residual-to-error factor (stopping rule:
    ``|F|_1 <= target_error * eps``, paper §2.2/§3), ``b_batch`` an
    optional ``[N, C]`` matrix of additional RHS columns for multi-RHS
    serving (each column is an independent system over the same P).
    """

    p: CSRGraph
    b: np.ndarray
    eps: float
    target_error: float
    weights: Optional[np.ndarray] = None  # node-selection w_i (§2.2.1)
    weight_mode: str = "inv_out"
    b_batch: Optional[np.ndarray] = None  # [N, C] extra personalization RHS
    kind: str = "linear"  # "pagerank" | "linear" (provenance tag)
    damping: Optional[float] = None  # set for pagerank problems
    store: Optional[GraphStore] = None  # the mutable substrate owning p
    store_version: Optional[int] = None  # store.version this p snapshots

    def __post_init__(self):
        if self.b.shape != (self.p.n,):
            raise ValueError(
                f"b has shape {self.b.shape}, expected ({self.p.n},)"
            )
        if not (0.0 < self.eps <= 1.0):
            raise ValueError(f"eps must be in (0, 1], got {self.eps}")
        if self.target_error <= 0:
            raise ValueError(
                f"target_error must be > 0, got {self.target_error}"
            )
        if self.weights is not None and self.weights.shape != (self.p.n,):
            raise ValueError(
                f"weights has shape {self.weights.shape}, "
                f"expected ({self.p.n},)"
            )
        if self.b_batch is not None and (
            self.b_batch.ndim != 2 or self.b_batch.shape[0] != self.p.n
        ):
            raise ValueError(
                f"b_batch must be [N, C] with N={self.p.n}, "
                f"got {self.b_batch.shape}"
            )
        if self.store is not None and self.store_version is None:
            object.__setattr__(self, "store_version", self.store.version)

    # ---- derived ----------------------------------------------------------
    @property
    def graph(self) -> GraphStore:
        """The mutable :class:`GraphStore` behind ``p`` (created lazily).

        ``p`` stays the immutable CSR *snapshot* this Problem was
        stated over.  A Problem whose store's ``version`` moved past
        the one it captured is stale — its ``p``/``b`` no longer
        describe the store's matrix — and raises here rather than
        silently solving a mixed system.
        """
        if self.store is None:
            store = GraphStore.from_csr(self.p)
            object.__setattr__(self, "store", store)
            object.__setattr__(self, "store_version", store.version)
        elif self.store.version != self.store_version:
            raise ValueError(
                f"stale Problem snapshot: its GraphStore advanced to "
                f"version {self.store.version} but this Problem captured "
                f"version {self.store_version}; re-snapshot with "
                "problem.with_graph(store)"
            )
        return self.store

    @property
    def n(self) -> int:
        return self.p.n

    @property
    def n_edges(self) -> int:
        return self.p.n_edges

    @property
    def is_batched(self) -> bool:
        return self.b_batch is not None

    @property
    def tol(self) -> float:
        """The |F|_1 stopping tolerance (``target_error * eps``)."""
        return self.target_error * self.eps

    def node_weights(self) -> np.ndarray:
        """Resolved selection weights (explicit array wins over the mode)."""
        if self.weights is not None:
            return self.weights
        return default_weights(self.p, self.weight_mode)

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def pagerank(
        g: Union[CSRGraph, GraphStore],
        damping: float = 0.85,
        target_error: Optional[float] = None,
        personalization: Optional[np.ndarray] = None,
        weight_mode: str = "inv_out",
    ) -> "Problem":
        """PageRank instance on link graph ``g`` (paper's flagship case).

        ``P[j, i] = damping/out_deg(i)``, ``B = (1-damping)/N``,
        ``eps = 1 - damping``; ``target_error`` defaults to the paper's
        ``1/N`` (§3.1).  ``personalization`` is an optional ``[N, C]``
        matrix of preference distributions (columns); each becomes an
        extra RHS ``(1-damping) * pref_c`` for multi-RHS serving.

        ``g`` is the raw *link* graph — a :class:`CSRGraph` or a
        :class:`repro_torch.graph.GraphStore` (e.g. from
        ``GraphStore.from_edge_file``); the Problem's own ``store``
        holds the derived diffusion matrix P.
        """
        if isinstance(g, GraphStore):
            g = g.csr()
        p, b = pagerank_system(g, damping=damping)
        te = target_error if target_error is not None else 1.0 / g.n
        b_batch = None
        if personalization is not None:
            pref = np.asarray(personalization, dtype=np.float64)
            if pref.ndim != 2 or pref.shape[0] != g.n:
                raise ValueError(
                    f"personalization must be [N, C] with N={g.n}, "
                    f"got {pref.shape}"
                )
            b_batch = (1.0 - damping) * pref
        return Problem(
            p=p, b=b, eps=1.0 - damping, target_error=te,
            weight_mode=weight_mode, b_batch=b_batch,
            kind="pagerank", damping=damping,
        )

    @staticmethod
    def linear(
        p: Union[CSRGraph, GraphStore],
        b: np.ndarray,
        eps: Optional[float] = None,
        rho: Optional[float] = None,
        target_error: float = 1e-6,
        weights: Optional[np.ndarray] = None,
        weight_mode: str = "inv_out",
        b_batch: Optional[np.ndarray] = None,
    ) -> "Problem":
        """General system ``X = P·X + B`` with spectral radius(P) < 1.

        Provide either ``eps`` directly or ``rho`` (then
        ``eps = 1 - rho``) — the residual-to-error bound of §2.2.
        """
        if eps is None and rho is None:
            raise ValueError("provide eps or rho (eps = 1 - rho)")
        if eps is None:
            eps = 1.0 - rho
        store, p = _as_store_and_csr(p)
        return Problem(
            p=p, b=np.asarray(b, dtype=np.float64), eps=float(eps),
            target_error=float(target_error), weights=weights,
            weight_mode=weight_mode, b_batch=b_batch, kind="linear",
            store=store,
        )

    def with_b(self, b_new: np.ndarray) -> "Problem":
        """Same system, new primary RHS (the warm-start re-seed case)."""
        return dataclasses.replace(
            self, b=np.asarray(b_new, dtype=np.float64)
        )

    def with_graph(self, graph: Union[GraphStore, CSRGraph]) -> "Problem":
        """Same RHS/targets, new (or mutated) diffusion matrix.

        The twin of :meth:`with_b`: ``problem.with_graph(store)``
        re-snapshots ``p`` from the store's CSR view while *sharing*
        the store and its cached backend views.
        """
        store, p = _as_store_and_csr(graph)
        if p.n != self.p.n:
            raise ValueError(
                f"with_graph cannot change N ({self.p.n} -> {p.n}); "
                "state vectors B/H/F are node-indexed"
            )
        return dataclasses.replace(
            self, p=p, store=store,
            store_version=store.version if store is not None else None)
