"""Step callables per (family × cell kind): the recsys serving steps.

:func:`build_cell_step` returns ``step(batch) -> tensor`` for a cell of
:mod:`repro_torch.configs.fm`: ``serve`` runs ``forward_logits`` on
``batch["ids"]``, ``retrieval`` runs ``retrieval_score`` on
``batch["user_ids"]`` / ``batch["cand_ids"]``.  Steps run under
``torch.inference_mode`` on the model's device.  The train kinds, the GNN
train cells and the LM kinds wait (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..configs.common import ArchSpec, ShapeCell
from ..models import recsys

__all__ = ["build_cell_step"]


def build_cell_step(spec: ArchSpec, cell: ShapeCell,
                    model: torch.nn.Module) -> Callable[[Dict], torch.Tensor]:
    if spec.family == "recsys" and cell.kind == "serve":

        @torch.inference_mode()
        def step(batch):
            return recsys.forward_logits(model, batch["ids"])

        return step
    if spec.family == "recsys" and cell.kind == "retrieval":

        @torch.inference_mode()
        def step(batch):
            return recsys.retrieval_score(model, batch["user_ids"],
                                          batch["cand_ids"])

        return step
    raise NotImplementedError(
        f"{spec.family} {cell.kind} steps are not ported yet (ROADMAP §1, "
        "'Next')")
