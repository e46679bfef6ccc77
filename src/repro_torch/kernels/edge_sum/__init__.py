from .kernel import (  # noqa: F401
    CscEdges,
    csc_edges,
    edge_sum,
    edge_sum_lanes,
    edge_sum_lanes_plain,
    edge_sum_plain,
    engine_edge_table,
)
