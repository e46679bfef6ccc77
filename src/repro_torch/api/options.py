"""One ``SolverOptions`` shape for every backend (DESIGN.md §4).

The port's copy of ``repro.api.SolverOptions`` plus ``device``: the
single validated front-door config.  It carries the fields that the
backends registered in this port read — the frontier's, the engine's and
the balance controller's, with the reference's defaults; the
simulator's (``partition``, ``mode``, ``max_steps``, ``record_every``)
come with the simulator backend.  Backend adapters translate the
relevant subset into their native config and *reject* — rather than
silently ignore — flags the chosen backend cannot honor.
``validated(caps)`` is the one choke point: the CLI and
``repro_torch.solve`` both pass through it.

``device`` names the torch device the solve runs on.  It defaults to
the card, ``"cuda"``; constructing options for ``"cuda"`` on a machine
without one raises instead of falling back to the CPU.  Callers ask
for the CPU explicitly (``device="cpu"``), as the tests do.  The
engine's ``dtype`` is float32 on the card (the kernels are float32
only); the CPU's plain versions also run float64.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["SolverOptions", "GAMMA"]

GAMMA = 1.2  # paper default threshold decay

_POLICIES = ("slope_ema", "cost_refresh", "hysteresis")
_SIGNALS = ("residual", "edge-ops")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def engine_dtype(dtype) -> torch.dtype:
    """The engine's compute dtype from ``SolverOptions.dtype``: None (the
    default float32), a torch dtype, a numpy dtype or its name."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = None
    if name not in _DTYPES:
        raise ValueError(
            f"unknown engine dtype {dtype!r}; expected one of "
            f"{tuple(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass
class SolverOptions:
    """Backend-agnostic solver knobs.

    Fields are grouped by which backends consume them; ``validated``
    raises when a field is set inconsistently (e.g. ``dynamic`` with
    ``k=1``) or targets a backend that cannot honor it (e.g. ``k`` on
    the single-process reference solvers).
    """

    # ---- shared -----------------------------------------------------------
    k: Optional[int] = None  # PIDs / devices (None = backend default)
    dynamic: bool = False  # §2.5.2 dynamic partition controller
    policy: Optional[str] = None  # balance policy name (implies dynamic)
    signal: str = "residual"  # rebalancing signal
    gamma: float = GAMMA
    max_rounds: int = 1_000_000  # frontier rounds / sweeps cap
    max_ops: int = 10**9  # sequential-backend op budget
    verbose: bool = False  # engine progress, one line per chunk
    # ---- frontier (segment_sum / pallas) ----------------------------------
    # kernel-config knobs default to None = "tuned record for this platform
    # if one exists, else the historical default" (bs=128, depth=1, thr=0);
    # an explicit value always wins over the tuned record.
    bs: Optional[int] = None  # BSR block size for frontier:pallas
    buffer_depth: Optional[int] = None  # validated; no effect on K1 yet
    occupancy_threshold: Optional[float] = None  # defer sparse block cols
    # run the kernel semantics (K1's wt-folded predicate) on the CPU,
    # through K1's plain twin — the counterpart of the reference's
    # Pallas interpret mode
    interpret: bool = False
    trace_every: int = 32  # rounds per trace record (streaming grain)
    # ---- engine -----------------------------------------------------------
    buckets_per_dev: int = 8
    headroom: int = 2
    max_inner: int = 8
    chunk_rounds: int = 4
    max_chunks: int = 4096
    dtype: Any = None  # engine compute dtype (None = float32)
    # ---- balance controller -----------------------------------------------
    eta: float = 0.5
    z: int = 10
    # ---- placement --------------------------------------------------------
    device: str = "cuda"  # torch device of the solve; never falls back

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} but torch sees no CUDA device; "
                "pass device='cpu' to run the plain versions on the CPU")

    def validated(self, caps=None, method: str = "?") -> "SolverOptions":
        """Normalize + cross-check; returns a fresh validated copy.

        ``caps`` is the target backend's
        :class:`repro_torch.api.registry.BackendCapabilities`; when given, the
        check also rejects options the backend cannot honor (the
        historical failure mode was *silently ignoring* them — e.g.
        ``--k`` on the engine path of ``launch/solve.py``).
        """
        opt = dataclasses.replace(self)
        if opt.policy is not None:
            if opt.policy not in _POLICIES:
                raise ValueError(
                    f"unknown policy {opt.policy!r}; expected one of "
                    f"{_POLICIES}"
                )
            # a policy is only meaningful with the dynamic controller on:
            # the help text has always claimed --policy implies --dynamic
            opt.dynamic = True
        if opt.signal not in _SIGNALS:
            raise ValueError(
                f"unknown signal {opt.signal!r}; expected one of {_SIGNALS}"
            )
        if (engine_dtype(opt.dtype) != torch.float32
                and torch.device(opt.device).type == "cuda"):
            raise ValueError(
                f"dtype={opt.dtype!r}: the kernels on the card are float32 "
                "only; other dtypes run on device='cpu'")
        if opt.k is not None and opt.k < 1:
            raise ValueError(f"k must be >= 1, got {opt.k}")
        if opt.bs is not None and opt.bs < 1:
            raise ValueError(f"bs must be >= 1, got {opt.bs}")
        if opt.buffer_depth is not None and opt.buffer_depth < 1:
            raise ValueError(
                f"buffer_depth must be >= 1, got {opt.buffer_depth}"
            )
        if opt.occupancy_threshold is not None and not (
            0.0 <= opt.occupancy_threshold < 1.0
        ):
            raise ValueError(
                "occupancy_threshold must be in [0, 1), got "
                f"{opt.occupancy_threshold}"
            )
        if opt.dynamic and opt.k == 1:
            raise ValueError(
                "dynamic partition needs k >= 2 (one PID has nothing to "
                "rebalance); drop --dynamic/--policy or raise k"
            )
        if caps is not None:
            if opt.k is not None and opt.k > 1 and not caps.configurable_k:
                raise ValueError(
                    f"backend {method!r} is single-process; k={opt.k} "
                    "cannot be honored (use 'engine:chunk' or 'engine:bsr')"
                )
            if opt.dynamic and not caps.supports_dynamic_partition:
                raise ValueError(
                    f"backend {method!r} has no dynamic partition; drop "
                    "--dynamic/--policy or pick 'engine:chunk'/'engine:bsr'"
                )
        return opt
