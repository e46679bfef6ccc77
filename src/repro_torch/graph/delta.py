"""The composite edge identity shared by the canonical CSR and the loaders.

The port carries only :func:`edge_keys` of ``repro.graph.delta`` so far;
``GraphDelta`` and the churn helpers come with the graph-delta slice.
"""
from __future__ import annotations

import numpy as np

__all__ = ["edge_keys"]


def edge_keys(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """THE composite edge identity: ``src << 32 | dst`` (int64).

    Node ids are int32-ranged, so the key is collision-free and
    order-preserving under (src, dst) lexsort.
    """
    return np.asarray(src, np.int64) << 32 | np.asarray(dst, np.int64)
