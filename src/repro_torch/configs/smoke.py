"""Reduced same-family configs for CPU runs of the LM entry points.

:func:`lm_shrink` narrows an LM config the way the reference's
``configs.smoke._lm_shrink`` does (2 layers, d=64, heads / 8, Dh 16,
vocab 128, float32, cross-entropy chunks of 16 tokens, one microbatch):
the GQA ratio and the QKV bias survive, and a MoE stays a MoE with its
shared experts (at most 8 experts, top 2, ``d_ff_expert`` 16, padded to
8), so the reduced model runs the same code paths as the published one.
:func:`smoke_setup` is the reference's for the LM archs: the reduced
config and a tiny batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..data import lm_token_batch
from . import get_arch

__all__ = ["lm_shrink", "smoke_setup"]


def lm_shrink(cfg):
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, 8), top_k=min(moe.top_k, 2),
            d_ff_expert=16, pad_experts_to=8)
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=max(2, cfg.n_heads // 8),
        n_kv_heads=max(1, cfg.n_kv_heads // 8),
        d_head=16,
        d_ff=96,
        vocab=128,
        moe=moe,
        dtype=torch.float32,
        ce_chunk=16,
        n_microbatches=1,
    )


def smoke_setup(arch_id: str) -> Tuple[Any, Dict[str, np.ndarray], str]:
    """``(reduced model cfg, tiny batch, family)`` for an LM arch: the
    batch is ``lm_token_batch(0, 2, 32, vocab)`` (numpy).  The GNN and
    recsys families' training waits (ROADMAP §1, item 7 (b))."""
    spec = get_arch(arch_id)
    if spec.family != "lm":
        raise NotImplementedError(
            f"{arch_id}: {spec.family} training is not ported yet (ROADMAP "
            "§1, item 7 (b))")
    cfg = lm_shrink(spec.model_cfg)
    return cfg, lm_token_batch(0, 2, 32, cfg.vocab), "lm"
