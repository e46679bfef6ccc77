"""The solver front door of the port (DESIGN.md §4).

The same public surface as ``repro.api`` for the tiers ported so far:

>>> import repro_torch
>>> problem = repro_torch.Problem.pagerank(g, damping=0.85)
>>> report = repro_torch.solve(problem)                  # on the card
>>> report = repro_torch.solve(problem, method="frontier:segment_sum",
...                            device="cpu")
>>> session = repro_torch.SolverSession(problem, "frontier:pallas")
>>> session.solve(); session.warm_start(b2); session.solve()
>>> report = repro_torch.solve(problem, method="engine:bsr", k=4,
...                            policy="slope_ema")   # K PIDs, bucket moves

The backend registry (``list_backends()``) maps the reference's string
keys to solver tiers with capability records; everything returns the
unified :class:`SolveReport`.  ``frontier:pallas`` keeps its name, but
the kernel behind it is a CUDA C++ kernel for Hopper; the engine's K
PIDs run as a leading axis on one device.
"""
from ..graph import GraphStore

from .options import SolverOptions
from .problem import Problem
from .registry import (
    BackendCapabilities,
    get_backend,
    list_backends,
    register_backend,
    solve,
)
from .report import RoundReport, SolveReport
from .session import SolverSession

__all__ = [
    "BackendCapabilities",
    "GraphStore",
    "Problem",
    "RoundReport",
    "SolveReport",
    "SolverOptions",
    "SolverSession",
    "get_backend",
    "list_backends",
    "register_backend",
    "solve",
]
