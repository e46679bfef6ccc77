"""Tuning of the BSR diffusion kernels K1 and K2.

``run_sweep`` times (bs, buffer_depth, occupancy threshold) on the card
(or the plain versions on the CPU) and persists the winner as a versioned
JSON record; ``records`` load those at dispatch time, so that
``solve(method="auto")`` ranks backends by measured throughput and the
session drivers resolve their kernel config (``resolved_config``) from
the same records.  ``model`` is the cost model and the one source of the
kernels' shared-memory rule.
"""
from .model import (  # noqa: F401
    PLATFORM_SPECS,
    HwSpec,
    KernelCost,
    ctas_per_sm,
    dma_compute_ratio,
    frontier_round_cost,
    gather_spmm_cost,
    ideal_time_s,
    ring_stages,
    roofline_fraction,
    route,
    simt_smem_bytes,
    smem_bytes,
    smem_ok,
)
from .records import (  # noqa: F401
    DEFAULT_BS,
    DEFAULT_BUFFER_DEPTH,
    DEFAULT_OCCUPANCY_THRESHOLD,
    KERNELS,
    RECORD_VERSION,
    TunedConfig,
    best_config,
    clear_cache,
    load_record,
    record_path,
    resolved_config,
    save_record,
    tune_dir,
    validate_record,
)
from .sweep import run_sweep  # noqa: F401
