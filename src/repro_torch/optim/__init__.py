"""Optimizer: AdamW with float32 master weights and moments, gradient
clipping by global norm and the learning-rate schedules (the port of
``repro.optim``; its gradient compression waits, ROADMAP)."""
from .adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup,
)
