"""Optimizer: AdamW with float32 master weights and moments, gradient
clipping by global norm and the learning-rate schedules, and gradient
compression (int8, error-feedback top-k): the port of ``repro.optim``."""
from .adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup,
)
from .compression import (  # noqa: F401
    CompressionState,
    compress_int8,
    decompress_int8,
    ef_topk_compress,
    ef_topk_init,
)
