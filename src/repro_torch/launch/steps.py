"""Step callables per (family × cell kind): recsys and LM serving steps.

:func:`build_cell_step` returns ``step(batch)`` for a cell of
:mod:`repro_torch.configs`:

* recsys ``serve`` runs ``forward_logits`` on ``batch["ids"]``;
  ``retrieval`` runs ``retrieval_score`` on ``batch["user_ids"]`` /
  ``batch["cand_ids"]``; both return the scores.
* lm ``prefill`` runs ``prefill_step`` on ``batch["tokens"]`` with a cache
  of ``batch["max_seq"]`` slots (default: the prompt's length) and
  returns ``(cache, logits)``; ``decode`` runs one ``decode_step`` on
  ``batch["tokens"]`` over ``batch["cache_k"]`` / ``batch["cache_v"]`` at
  ``batch["pos"]`` (the reference's keys), writing the cache in place, and
  returns ``(logits, cache)``; with ``batch["cache_k_scale"]`` /
  ``batch["cache_v_scale"]`` (the reference's int8 cell keys) the cache is
  the int8 KV cache.

Steps run under ``torch.inference_mode`` on the model's device.  The
train kinds wait (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..configs.common import ArchSpec, ShapeCell
from ..models import recsys, transformer

__all__ = ["build_cell_step"]


def build_cell_step(spec: ArchSpec, cell: ShapeCell,
                    model: torch.nn.Module) -> Callable[[Dict], object]:
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
    if spec.family == "lm" and cell.kind == "prefill":

        @torch.inference_mode()
        def step(batch):
            return transformer.prefill_step(model, batch["tokens"],
                                            max_seq=batch.get("max_seq"))

        return step
    if spec.family == "lm" and cell.kind == "decode":

        @torch.inference_mode()
        def step(batch):
            cache = {"k": batch["cache_k"], "v": batch["cache_v"],
                     "pos": batch["pos"]}
            if "cache_k_scale" in batch:
                cache["k_scale"] = batch["cache_k_scale"]
                cache["v_scale"] = batch["cache_v_scale"]
            return transformer.decode_step(model, cache, batch["tokens"])

        return step
    raise NotImplementedError(
        f"{spec.family} {cell.kind} steps are not ported yet (ROADMAP §1, "
        "item 7)")
