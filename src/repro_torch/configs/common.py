"""Shape-cell records: what one (architecture × input shape) cell holds.

A cell names its step kind, its inputs as plain ``(shape, dtype)`` pairs
and its bookkeeping ``meta``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

__all__ = ["ShapeCell", "ArchSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | serve | retrieval
    inputs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # recsys
    model_cfg: Any
    cells: Dict[str, ShapeCell]
