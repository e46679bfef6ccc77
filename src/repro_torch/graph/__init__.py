"""The sparse substrate behind every backend.

:class:`GraphStore` owns the canonical out-adjacency CSR and derives each
backend's representation as a cached view (CSR, the frontier kernel's BSR
tile pool :class:`BsrTiles`, the bucketed layout, the engine layout
:class:`EngineLayout`); :class:`GraphDelta` describes edge churn and
:meth:`GraphStore.apply_delta` patches every materialized view
incrementally (dirty tiles / buckets / rows only).
"""
from .delta import (GraphDelta, edge_keys, invert_delta, pagerank_edge_churn,
                    rotation_churn)
from .store import GraphStore
from .views import BsrTiles, EngineLayout

__all__ = [
    "BsrTiles",
    "EngineLayout",
    "GraphDelta",
    "GraphStore",
    "edge_keys",
    "invert_delta",
    "pagerank_edge_churn",
    "rotation_churn",
]
