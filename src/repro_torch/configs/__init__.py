"""Architecture configs and shape cells of the port's substrates.

* ``fm``      — the FM recsys model and its four cells.
* ``gin_tu``  — GIN at the shared GNN shapes (``gnn_common.SHAPE_DIMS``).
"""
