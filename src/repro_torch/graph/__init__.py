"""The sparse substrate behind every backend.

:class:`GraphStore` owns the canonical out-adjacency CSR and derives each
backend's representation as a cached view: the CSR itself and the
frontier kernel's BSR tile pool (:class:`BsrTiles`).
"""
from .store import GraphStore
from .views import BsrTiles

__all__ = ["BsrTiles", "GraphStore"]
