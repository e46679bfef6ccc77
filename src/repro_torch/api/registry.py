"""String-keyed backend registry + the ``solve()`` front door.

Every solver tier registers under a stable key with a capability
record; ``solve(problem, method="auto")`` picks the fastest *eligible*
backend for the problem/options/hardware at hand (DESIGN.md §4).

Registered keys (see :mod:`repro_torch.api.backends`), the reference's
keys for the tiers this port has so far:

========================  =================================================
``sequential``            paper-exact numpy sweep (ground-truth schedule)
``frontier:segment_sum``  frontier-batched torch, per-edge push (K3)
``frontier:pallas``       frontier-batched over the fused BSR round (K1).
                          The name is the reference's; the kernel behind
                          it is CUDA C++ (``csrc/diffusion.cu``).
``engine:chunk``          K-PID engine, per-edge push (K3), bucket moves
``engine:bsr``            K-PID engine, BSR tile push (K2), bucket moves
``simulator``             faithful K-PID time-stepped simulator (push K7),
                          node moves; the paper's Tables 1–3
========================  =================================================

The engine runs its K PIDs on one device, so unlike the reference
auto-dispatch never excludes it for lack of devices.  Auto-dispatch reads the platform from ``options.device``
(``"cuda"`` / ``"cpu"``) where the reference reads
``jax.default_backend()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from .options import SolverOptions
from .problem import Problem
from .report import SolveReport

__all__ = [
    "BackendCapabilities",
    "register_backend",
    "get_backend",
    "list_backends",
    "solve",
]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a backend can honor — consulted by validation and auto-dispatch.

    ``device_kinds`` lists the torch device types the backend is *at
    home* on; it still runs elsewhere (all backends are portable) but auto
    dispatch prefers native ground.  ``min_auto_n`` gates auto-dispatch
    to sizes where the backend's fixed costs amortize.

    ``tune_key`` names the autotunable kernel behind the backend (a key
    of :data:`repro_torch.kernels.tune.KERNELS`).  When a persisted tuned
    record exists for (tune_key, current platform), auto-dispatch treats
    the backend as native there and ranks it by the record's *measured*
    throughput — measurement beats the hardcoded ``auto_priority``
    (DESIGN.md §9).  Without a record the historical priority ordering
    applies unchanged.
    """

    supports_dynamic_partition: bool = False
    supports_batch: bool = False  # multi-RHS solve_batch ([C, N] lanes)
    supports_warm_start: bool = False  # SolverSession-resumable state
    configurable_k: bool = False  # honors SolverOptions.k > 1
    device_kinds: Tuple[str, ...] = ("cpu", "cuda")
    min_auto_n: int = 0
    auto_priority: int = 0  # higher wins among eligible backends
    tune_key: Optional[str] = None  # autotuned kernel behind this backend


@dataclasses.dataclass(frozen=True)
class _Backend:
    name: str
    fn: Callable[[Problem, SolverOptions], SolveReport]
    caps: BackendCapabilities


_REGISTRY: Dict[str, _Backend] = {}


def register_backend(name: str, caps: BackendCapabilities):
    """Decorator: register ``fn(problem, options) -> SolveReport``."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = _Backend(name=name, fn=fn, caps=caps)
        return fn

    return deco


def _ensure_loaded() -> None:
    if not _REGISTRY:  # adapters self-register on first import
        from . import backends  # noqa: F401


def get_backend(name: str) -> _Backend:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown solver backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}"
        ) from None


def list_backends() -> Dict[str, BackendCapabilities]:
    """Registry snapshot: key -> capabilities (the capability matrix)."""
    _ensure_loaded()
    return {k: b.caps for k, b in sorted(_REGISTRY.items())}


def _tuned_throughput(caps: BackendCapabilities,
                      platform: str) -> Optional[float]:
    """Measured GFLOP/s from the backend's tuned record, if one exists."""
    if caps.tune_key is None:
        return None
    from ..kernels.tune import best_config

    rec = best_config(caps.tune_key, platform)
    return None if rec is None else rec.throughput_gflops


def _auto_select(problem: Problem, options: SolverOptions) -> str:
    """Pick the fastest eligible backend (documented, deterministic).

    Eligibility: honors the requested k/dynamic/batch; native to the
    options' device type; problem size above the backend's auto floor.

    Ranking is measurement-first: a backend whose ``tune_key`` has a
    persisted tuned record for this platform counts as native here and
    ranks by the record's measured throughput; every measured backend
    outranks every unmeasured one, and unmeasured backends keep the
    ``auto_priority`` ordering.  With no records on disk — the default
    state — dispatch is the priority rule: ``frontier:pallas`` on the
    card, ``frontier:segment_sum`` on the CPU.
    """
    import torch

    platform = torch.device(options.device).type
    _ensure_loaded()
    want_k = options.k is not None and options.k > 1
    best: Optional[_Backend] = None
    best_key: Tuple[float, float] = (-1.0, -1.0)
    for be in _REGISTRY.values():
        caps = be.caps
        measured = _tuned_throughput(caps, platform)
        if platform not in caps.device_kinds and measured is None:
            continue
        if problem.n < caps.min_auto_n:
            continue
        if problem.is_batched and not caps.supports_batch:
            continue
        if want_k and not caps.configurable_k:
            continue
        if (options.dynamic or options.policy) and (
            not caps.supports_dynamic_partition
        ):
            continue
        key = ((1.0, measured) if measured is not None
               else (0.0, float(caps.auto_priority)))
        if best is None or key > best_key:
            best, best_key = be, key
    if best is None:
        raise ValueError(
            "no registered backend honors this request (multi-RHS "
            "batches run on frontier:segment_sum alone, with k unset); "
            f"registered: {sorted(_REGISTRY)}")
    return best.name


def solve(
    problem: Problem,
    method: str = "auto",
    options: Optional[SolverOptions] = None,
    **kw,
) -> SolveReport:
    """The single solver front door: ``repro_torch.solve(problem)``.

    ``method`` is a registry key or ``"auto"``; extra keyword arguments
    are folded into ``options`` (``solve(p, k=8, dynamic=True)``).
    Options are validated against the chosen backend's capabilities —
    inconsistent flags raise instead of being silently dropped.
    """
    # keywords go in at construction: a default ``SolverOptions()`` asks
    # for the card, which a ``device="cpu"`` keyword must override
    opts = (SolverOptions(**kw) if options is None
            else dataclasses.replace(options, **kw))
    if method in ("auto", None):
        # normalize first so auto-selection sees policy => dynamic
        opts = opts.validated()
        method = _auto_select(problem, opts)
    be = get_backend(method)
    opts = opts.validated(be.caps, method)
    return be.fn(problem, opts)
