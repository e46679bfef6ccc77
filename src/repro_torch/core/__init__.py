"""The paper's contribution, as far as the port has come.

Layers:
  graph        — CSR container + generators (paper §3 data), numpy;
                 the engine's bucket-major layout
  diteration   — reference solvers (sequential paper-exact, frontier torch)
  partition    — §2.5.1 static partitions + the §2.5.2 dynamic controller
  simulator    — the faithful K-PID time-stepped simulator (node-granular
                 dynamic partition; its push is K7)
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
from .partition import (
    DynamicController,
    DynamicControllerConfig,
    MoveInstruction,
    apply_move,
    cb_partition,
    partition_bounds_to_sets,
    uniform_partition,
)
from .simulator import (
    DistributedSimulator,
    SimResult,
    SimulatorConfig,
    run_cost_experiment,
)
