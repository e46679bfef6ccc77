"""Versioned on-disk records of tuned kernel configs.

One JSON file per (kernel, platform) pair under the tune directory
(``$REPRO_TORCH_TUNE_DIR`` or ``results/tuned_torch/``; kept apart from
the JAX package's records, whose ``cpu`` platform key means another
code path).  The platform is the torch device type (``"cuda"`` /
``"cpu"``).  :func:`save_record` writes what :func:`.sweep.run_sweep`
measures (``python -m repro_torch.kernels.tune``).  The backend registry
ranks a backend whose ``tune_key`` has a record for the options' device
by *measured* throughput, and the drivers resolve their kernel config
from the same record (:func:`resolved_config`): ``frontier:pallas`` its
bs, K1 depth and occupancy threshold, ``engine:bsr`` its K2 depth
(``EngineConfig.pallas_buffer_depth``).  No record is committed, so the
defaults rule: bs=128, depth=1, occupancy threshold 0.

Records are versioned; a version mismatch is treated as "no record".
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Dict, Optional, Tuple

RECORD_VERSION = 1
KERNELS = ("frontier_round_bsr", "bsr_gather_spmm")
ENV_VAR = "REPRO_TORCH_TUNE_DIR"
DEFAULT_DIR = "results/tuned_torch"

__all__ = [
    "RECORD_VERSION",
    "KERNELS",
    "ENV_VAR",
    "TunedConfig",
    "tune_dir",
    "record_path",
    "validate_record",
    "save_record",
    "load_record",
    "best_config",
    "clear_cache",
    "resolved_config",
]

# defaults used whenever no tuned record (or explicit option) says otherwise
DEFAULT_BS = 128
DEFAULT_BUFFER_DEPTH = 1
DEFAULT_OCCUPANCY_THRESHOLD = 0.0

_REQUIRED_KEYS = (
    "version", "kernel", "platform", "device_kind", "torch_version",
    "created_utc", "timing_path", "problem", "best", "sweep",
)
_BEST_KEYS = (
    "bs", "buffer_depth", "occupancy_threshold", "measured_us",
    "throughput_gflops", "roofline_fraction", "smem_bytes",
)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """The winning config of a sweep, as dispatch and drivers consume it."""

    kernel: str
    platform: str
    bs: int
    buffer_depth: int
    occupancy_threshold: float
    measured_us: float
    throughput_gflops: float


_CACHE: Dict[Tuple[str, str, str], Optional[dict]] = {}


def tune_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(ENV_VAR, DEFAULT_DIR))


def record_path(kernel: str, platform: str) -> pathlib.Path:
    return tune_dir() / f"{kernel}__{platform}.json"


def validate_record(record: dict) -> None:
    missing = [k for k in _REQUIRED_KEYS if k not in record]
    if missing:
        raise ValueError(f"tune record missing keys: {missing}")
    bad = [k for k in _BEST_KEYS if k not in record["best"]]
    if bad:
        raise ValueError(f"tune record 'best' missing keys: {bad}")
    if record["kernel"] not in KERNELS:
        raise ValueError(f"unknown kernel {record['kernel']!r}")


def save_record(record: dict) -> pathlib.Path:
    """Validate + write; returns the path.  Invalidates the read cache."""
    validate_record(record)
    path = record_path(record["kernel"], record["platform"])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2, sort_keys=True) + "\n")
    clear_cache()
    return path


def load_record(kernel: str, platform: str) -> Optional[dict]:
    """Read (cached) a record; None if absent, unreadable or stale-versioned."""
    key = (kernel, platform, str(tune_dir()))
    if key in _CACHE:
        return _CACHE[key]
    rec: Optional[dict] = None
    path = record_path(kernel, platform)
    try:
        rec = json.loads(path.read_text())
        validate_record(rec)
        if rec.get("version") != RECORD_VERSION:
            rec = None
    except (OSError, ValueError, KeyError):
        rec = None
    _CACHE[key] = rec
    return rec


def best_config(kernel: str, platform: str) -> Optional[TunedConfig]:
    rec = load_record(kernel, platform)
    if rec is None:
        return None
    b = rec["best"]
    return TunedConfig(
        kernel=kernel,
        platform=platform,
        bs=int(b["bs"]),
        buffer_depth=int(b["buffer_depth"]),
        occupancy_threshold=float(b["occupancy_threshold"]),
        measured_us=float(b["measured_us"]),
        throughput_gflops=float(b["throughput_gflops"]),
    )


def clear_cache() -> None:
    """Drop the read cache (tests repoint ``$REPRO_TORCH_TUNE_DIR``
    mid-process)."""
    _CACHE.clear()


def resolved_config(
    kernel: str,
    *,
    platform: str,
    bs: Optional[int] = None,
    buffer_depth: Optional[int] = None,
    occupancy_threshold: Optional[float] = None,
) -> Tuple[int, int, float]:
    """Merge explicit options over the tuned record over the defaults.

    The precedence drivers rely on: an explicitly-set ``SolverOptions``
    field always wins; otherwise the platform's tuned record; otherwise
    the defaults (bs=128, depth=1, threshold=0).  ``platform`` is the
    torch device type the driver runs on.
    """
    rec = best_config(kernel, platform)
    return (
        bs if bs is not None else (rec.bs if rec else DEFAULT_BS),
        buffer_depth if buffer_depth is not None
        else (rec.buffer_depth if rec else DEFAULT_BUFFER_DEPTH),
        occupancy_threshold if occupancy_threshold is not None
        else (rec.occupancy_threshold if rec
              else DEFAULT_OCCUPANCY_THRESHOLD),
    )
