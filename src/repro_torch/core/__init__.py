"""The paper's contribution, as far as the port has come.

Layers:
  graph        — CSR container + generators (paper §3 data), numpy;
                 the engine's bucket-major layout
  diteration   — reference solvers (sequential paper-exact, frontier torch)
  partition    — the §2.5.2 dynamic partition controller
  distributed  — the K-PID engine (bucket-granular dynamic partition)
"""
from .graph import (
    BucketedGraph,
    CSRGraph,
    bucketize,
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
