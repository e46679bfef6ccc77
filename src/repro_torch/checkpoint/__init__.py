"""Atomic checkpoints with retention and an async writer (the port of
``repro.checkpoint``; the on-disk format is the reference's)."""
from .store import (  # noqa: F401
    CheckpointManager,
    latest_step,
    list_steps,
    load_checkpoint,
    save_checkpoint,
)
