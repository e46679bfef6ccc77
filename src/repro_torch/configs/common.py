"""Shape-cell records: what one (architecture × input shape) cell holds.

A cell names its step kind, its inputs as plain ``(shape, dtype)`` pairs
and its bookkeeping ``meta``.  :func:`lm_cells` gives an LM config its
serving cells.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

__all__ = ["ShapeCell", "ArchSpec", "lm_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | serve | retrieval | prefill | decode
    inputs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # recsys | lm
    model_cfg: Any
    cells: Dict[str, ShapeCell]
    source: str = ""  # provenance of the published config


def lm_cells(cfg) -> Dict[str, ShapeCell]:
    """The reference's ``prefill_32k`` (32 prompts of 32,768 tokens) and
    ``decode_32k`` (128 sequences, one new token against a 32,768-slot
    cache) for an LM config.  ``train_4k`` and ``long_500k`` wait with
    training and the sequence-sharded cache (ROADMAP)."""
    tok = torch.int32
    cache = ((cfg.n_layers, 128, 32768, cfg.n_kv_heads, cfg.head_dim),
             cfg.dtype)
    return {
        "prefill_32k": ShapeCell(
            name="prefill_32k", kind="prefill",
            inputs={"tokens": ((32, 32768), tok)},
            meta={"tokens": 32 * 32768, "batch": 32, "seq": 32768}),
        "decode_32k": ShapeCell(
            name="decode_32k", kind="decode",
            inputs={"tokens": ((128,), tok), "cache_k": cache,
                    "cache_v": cache, "pos": ((), tok)},
            meta={"tokens": 128, "batch": 128, "seq": 32768,
                  "note": "decode-only, one new token vs 32k cache"}),
    }
