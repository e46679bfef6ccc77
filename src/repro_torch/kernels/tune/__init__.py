"""Tuned kernel configs: the read side (records written by a later slice)."""
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
    tune_dir,
)
