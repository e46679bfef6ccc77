"""repro_torch — the D-iteration solver in PyTorch with CUDA kernels for
Hopper, beside the JAX package ``repro`` it is tested against.

The public solver surface lives in :mod:`repro_torch.api` and is
re-exported lazily here, so ``import repro_torch`` loads no kernel and
needs neither ``nvcc`` nor a card:

>>> import repro_torch
>>> report = repro_torch.solve(repro_torch.Problem.pagerank(g))

The substrates ported so far live beside it: FM recsys serving, the
GIN forward and qwen1.5-0.5b prefill / decode serving
(:mod:`repro_torch.models`, with ``configs``, ``data``, ``launch.steps``
and ``launch.serve``).
"""
_API_NAMES = (
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
)

__all__ = list(_API_NAMES)


def __getattr__(name):
    if name in _API_NAMES:
        from repro_torch import api

        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES))
