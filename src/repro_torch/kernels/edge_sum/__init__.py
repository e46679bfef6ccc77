from .kernel import (  # noqa: F401
    CscEdges,
    csc_edges,
    edge_sum,
    edge_sum_plain,
)
