"""Reference D-iteration solvers (single process).

Three tiers, all solving ``X = P X + B`` with spectral radius(P) < 1:

* :func:`run_sequential` — numpy, paper-exact greedy/threshold schedule,
  one node per elementary step.  Ground truth for schedule semantics.
* :func:`frontier_step` — one *frontier-batched* round in torch: every
  node above the threshold diffuses simultaneously (gather -> multiply ->
  per-destination sum through the deterministic ``edge_sum`` kernel),
  threshold decays by gamma when the frontier empties.  The resumable
  solve loops built on it live in :mod:`repro_torch.api.session`.
* :func:`jacobi_solve` — the classical baseline the paper normalizes
  against (one unit = one matrix-vector product).

Convergence/stopping: ``|F|_1 / eps <= target_error`` where
``eps = 1 - damping`` for PageRank systems and ``eps = 1 - rho`` in general —
the residual-to-error bound used throughout the paper (§2.2, §3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.edge_sum import CscEdges, edge_sum
from .graph import CSRGraph

__all__ = [
    "DiterationResult",
    "run_sequential",
    "frontier_step",
    "jacobi_solve",
    "residual_l1",
    "default_weights",
    "threshold_decay",
    "GAMMA",
]

GAMMA = 1.2  # paper default threshold decay


def threshold_decay(t: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``t / γ`` rounded as the reference's ``t / gamma`` is: an IEEE
    division in ``t``'s dtype, on either device.

    ``gamma`` is γ as a 0-dim tensor of ``t``'s dtype on its device, made
    once by the caller (driver, batcher or engine).  PyTorch on the card
    turns a division by a Python scalar into a product with its reciprocal
    (computed on the host), a bit off the quotient in about a quarter of
    the values; a division by a tensor on the card divides.
    """
    return t / gamma


@dataclasses.dataclass
class DiterationResult:
    x: np.ndarray  # the solution estimate H
    residual: float  # |F|_1 at exit
    n_ops: int  # elementary edge-push operations (paper cost unit)
    n_diffusions: int  # node diffusions
    n_sweeps: int  # threshold sweeps / frontier rounds
    cost_iterations: float  # n_ops / L (paper's normalized iteration count)


def default_weights(g: CSRGraph, mode: str = "inv_out") -> np.ndarray:
    """Node selection weights w_i (paper §2.2.1).

    greedy: w=1; inv_out: 1/#out (paper default); inv_out_in: 1/(#out*#in).
    """
    out = np.maximum(g.out_degree(), 1).astype(np.float64)
    if mode == "greedy":
        return np.ones(g.n)
    if mode == "inv_out":
        return 1.0 / out
    if mode == "inv_out_in":
        inn = np.maximum(g.in_degree(), 1).astype(np.float64)
        return 1.0 / (out * inn)
    raise ValueError(f"unknown weight mode {mode!r}")


def residual_l1(f: np.ndarray) -> float:
    return float(np.abs(f).sum())


# ------------------------------------------------------------------------------
# Paper-exact sequential schedule (numpy)
# ------------------------------------------------------------------------------
def run_sequential(
    g: CSRGraph,
    b: np.ndarray,
    target_error: float,
    eps: float,
    weights: Optional[np.ndarray] = None,
    gamma: float = GAMMA,
    max_ops: int = 10**9,
    trace: Optional[List[Tuple[int, float, int]]] = None,
) -> DiterationResult:
    """Single-PID D-iteration with the paper's cyclic threshold sweep.

    Elementary op = one edge push (cost model §2.3); dangling diffusions are
    charged one op.  Stops when |F|_1 <= target_error * eps.  ``trace``,
    when given, collects one ``(sweep, |F|_1, cumulative_ops)`` record per
    threshold sweep (the registry's per-round trace).
    """
    if weights is None:
        weights = default_weights(g)
    f = np.array(b, dtype=np.float64)
    h = np.zeros(g.n, dtype=np.float64)
    tol = target_error * eps
    t_k = float(np.abs(f * weights).max()) * 2.0 + 1e-300
    n_ops = 0
    n_diff = 0
    n_sweeps = 0
    indptr, indices, wgts = g.indptr, g.indices, g.weights
    while residual_l1(f) > tol and n_ops < max_ops:
        # one cyclic sweep at the current threshold
        eligible = np.nonzero(np.abs(f) * weights > t_k)[0]
        n_sweeps += 1
        if eligible.size == 0:
            t_k /= gamma
            continue
        for i in eligible:
            sent = f[i]
            if abs(sent) * weights[i] <= t_k:
                continue  # consumed by an earlier diffusion this sweep
            h[i] += sent
            f[i] = 0.0
            lo, hi = indptr[i], indptr[i + 1]
            if hi > lo:
                np.add.at(f, indices[lo:hi], sent * wgts[lo:hi])
                n_ops += hi - lo
            else:
                n_ops += 1  # dangling: absorb, charge one op
            n_diff += 1
        if trace is not None:
            trace.append((n_sweeps, residual_l1(f), n_ops))
    return DiterationResult(
        x=h,
        residual=residual_l1(f),
        n_ops=n_ops,
        n_diffusions=n_diff,
        n_sweeps=n_sweeps,
        cost_iterations=n_ops / max(g.n_edges, 1),
    )


# ------------------------------------------------------------------------------
# Frontier-batched schedule (torch)
# ------------------------------------------------------------------------------
def frontier_step(
    f: torch.Tensor,
    h: torch.Tensor,
    t_k: torch.Tensor,
    edges: CscEdges,
    weights: torch.Tensor,
    out_deg: torch.Tensor,
    dangling: torch.Tensor,
    gamma: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frontier round: diffuse every node with |F_i| w_i > T simultaneously.

    Returns (f, h, t, ops) — ``ops`` charges one op per edge push plus one op
    per *dangling* selected node (absorb-and-charge, matching
    :func:`run_sequential`'s §2.3 accounting exactly: a diffused node costs
    ``max(out_degree, 1)``).  Zero selected nodes -> threshold decays by
    gamma (:func:`threshold_decay`; ``gamma`` a 0-dim tensor on ``t_k``'s
    device), matching the sweep semantics.  ``edges``
    is the destination-sorted edge list the ``edge_sum`` kernel walks;
    ``out_deg`` [N] int64
    and ``dangling`` [N] bool describe the same edges by source, so
    ``sum(out_deg[sel])`` counts exactly the reference's ``sum(sel[src])``.
    ``ops`` is int64: at N=2**21 a solve pushes more than 2**31 edges.
    """
    sel = (f.abs() * weights) > t_k  # [N] frontier mask
    sent = torch.where(sel, f, torch.zeros_like(f))
    h = h + sent
    f = f - sent
    f = f + edge_sum(sent, edges)
    ops = torch.where(sel, out_deg, torch.zeros_like(out_deg)).sum()
    ops = ops + (sel & dangling).sum()
    t_new = torch.where(sel.any(), t_k, threshold_decay(t_k, gamma))
    return f, h, t_new, ops


# ------------------------------------------------------------------------------
# Classical baselines (the paper's comparison unit)
# ------------------------------------------------------------------------------
def jacobi_solve(
    g: CSRGraph,
    b: np.ndarray,
    target_error: float,
    eps: float,
    max_iters: int = 100_000,
) -> Tuple[np.ndarray, int]:
    """Jacobi / power iteration X <- P X + B; returns (x, n_matvecs).

    One matvec costs L edge ops — the unit the paper's ``cost_iterations``
    is normalized to, so D-iteration cost tables are directly comparable.
    """
    src, dst, w = g.edge_list()
    x = np.zeros(g.n, dtype=np.float64)
    tol = target_error * eps
    for it in range(1, max_iters + 1):
        px = np.zeros(g.n, dtype=np.float64)
        np.add.at(px, dst, x[src] * w)
        x_new = px + b
        if np.abs(x_new - x).sum() <= tol:
            return x_new, it
        x = x_new
    return x, max_iters
