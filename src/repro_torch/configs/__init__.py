"""Architecture configs and shape cells of the port's substrates.

* ``fm``           — the FM recsys model and its four cells.
* ``gin_tu``       — GIN at the shared GNN shapes (``gnn_common.SHAPE_DIMS``).
* ``qwen1_5_0_5b`` — the dense LM qwen1.5-0.5b and its serving cells
  (``common.lm_cells``); ``smoke.lm_shrink`` reduces it for the CPU.

``get_arch(arch_id)`` -> ArchSpec for the ids in ``ARCH_IDS``.
"""
from __future__ import annotations

import importlib

from .common import ArchSpec

_MODULES = {"qwen1.5-0.5b": "qwen1_5_0_5b", "fm": "fm"}

ARCH_IDS = list(_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__).spec()
