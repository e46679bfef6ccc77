from .ops import (  # noqa: F401
    BsrMatrix,
    EngineVisits,
    engine_tile_push,
    engine_visit_table,
    bsr_spmm,
    frontier_round_bsr,
    prepare_bsr,
)
from .ref import (  # noqa: F401
    bsr_spmm_ref,
    csr_to_bsr,
    dense_to_bsr,
    frontier_round_ref,
)
from .kernel import (  # noqa: F401
    bsr_spmm_kernel,
    bsr_spmm_plain,
    bsr_spmm_route,
    bulk_ctas_per_sm,
    launch_bsr_spmm,
    ROUTES,
    DEPTHS,
    frontier_round_bsr_kernel,
    frontier_round_bsr_plain,
    frontier_round_bsr_route,
    launch_frontier_round_bsr,
    FRONTIER_ROUTES,
    FRONTIER_DEPTHS,
)
