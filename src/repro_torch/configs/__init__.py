"""Architecture configs and shape cells of the port's substrates.

* ``fm``           — the FM recsys model and its four cells.
* ``gin_tu``, ``meshgraphnet``, ``egnn``, ``dimenet`` — the GNN archs at
  the shared GNN shapes (``gnn_common.SHAPE_DIMS``) and their train cells.
* ``qwen1_5_0_5b`` — the dense LM qwen1.5-0.5b and its serving cells
  (``common.lm_cells``); ``smoke.lm_shrink`` reduces it for the CPU.
* ``qwen2_moe_a2_7b``, ``granite_moe_1b_a400m`` — the MoE LMs (60 routed
  experts top-4 + 4 shared, padded to 64; 32 experts top-8) and their
  serving cells.

``get_arch(arch_id)`` -> ArchSpec for the ids in ``ARCH_IDS``; the
reference's other ids (``PENDING``) raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import importlib

from .common import ArchSpec

_MODULES = {"qwen1.5-0.5b": "qwen1_5_0_5b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "granite-moe-1b-a400m": "granite_moe_1b_a400m",
            "meshgraphnet": "meshgraphnet", "egnn": "egnn",
            "gin-tu": "gin_tu", "dimenet": "dimenet", "fm": "fm"}

ARCH_IDS = list(_MODULES)
# the reference's archs still to port, by ROADMAP §1 item
PENDING = {"command-r-plus-104b": "7 (a)", "mistral-large-123b": "7 (a)"}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in PENDING:
        raise NotImplementedError(f"{arch_id} is not ported yet (ROADMAP §1, "
                                  f"item {PENDING[arch_id]})")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__).spec()
