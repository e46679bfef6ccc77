"""The training runtime: the step loop with checkpoints and auto-resume,
and its straggler and expert-load monitors (the port of
``repro.runtime``)."""
from .loop import (  # noqa: F401
    ExpertLoadMonitor,
    StragglerMonitor,
    TrainLoop,
    TrainLoopConfig,
)
