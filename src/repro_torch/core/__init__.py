"""The paper's contribution, as far as the port has come.

Layers:
  graph        — CSR container + generators (paper §3 data), numpy
  diteration   — reference solvers (sequential paper-exact, frontier torch)
"""
from .graph import (
    CSRGraph,
    host_block_graph,
    pagerank_system,
    power_law_graph,
    random_dd_system,
    webgraph_like,
)
from .diteration import (
    GAMMA,
    DiterationResult,
    default_weights,
    frontier_step,
    jacobi_solve,
    residual_l1,
    run_sequential,
)
