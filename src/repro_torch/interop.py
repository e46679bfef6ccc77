"""Carry state across from the JAX reference, as numpy arrays.

Nothing here imports the reference: callers hand over the arrays its
objects expose, so the tests can make both packages compute the same
thing from the same state.

* :func:`problem_from_arrays` builds the port's :class:`Problem` from a
  reference ``Problem``'s ``p.indptr`` / ``p.indices`` / ``p.weights`` /
  ``n`` / ``b`` / ``eps`` / ``target_error`` / ``weight_mode`` /
  ``weights``.
* :func:`seed_session` seeds a port :class:`SolverSession` with the
  ``(F, H)`` of a reference session driver's ``fluid()`` and the
  threshold of its ``threshold()``, through the driver protocol
  (``seed``, ``set_threshold``) both packages share.  The session's
  phase counters restart at zero.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .api import Problem, SolverSession
from .core.graph import CSRGraph

__all__ = ["problem_from_arrays", "seed_session"]


def problem_from_arrays(indptr, indices, edge_weights, n: int, b, eps: float,
                        target_error: float, weight_mode: str = "inv_out",
                        weights: Optional[np.ndarray] = None) -> Problem:
    """The port's Problem over the same P (out-adjacency CSR), B and
    stopping rule.  ``edge_weights`` are P's entries; ``weights`` are the
    optional node-selection weights (§2.2.1)."""
    p = CSRGraph(indptr=np.asarray(indptr, dtype=np.int64),
                 indices=np.asarray(indices, dtype=np.int32),
                 weights=np.asarray(edge_weights, dtype=np.float64),
                 n=int(n))
    return Problem.linear(
        p, np.asarray(b, dtype=np.float64), eps=eps,
        target_error=target_error, weight_mode=weight_mode,
        weights=None if weights is None else np.asarray(weights,
                                                        dtype=np.float64))


def seed_session(session: SolverSession, f: np.ndarray, h: np.ndarray,
                 t) -> None:
    """Re-seed ``session`` with node-space ``(F, H)`` and threshold ``t``."""
    session._driver.seed(np.asarray(f, dtype=np.float64),
                         np.asarray(h, dtype=np.float64))
    session._driver.set_threshold(np.asarray(t, dtype=np.float64))
