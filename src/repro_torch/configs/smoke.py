"""Reduced same-family configs for CPU runs of the LM entry points.

:func:`lm_shrink` narrows an LM config the way the reference's
``configs.smoke._lm_shrink`` does (2 layers, d=64, heads / 8, Dh 16,
vocab 128, float32; the training knobs wait with training): the GQA
ratio and the QKV bias survive, and a MoE stays a MoE with its shared
experts (at most 8 experts, top 2, ``d_ff_expert`` 16, padded to 8), so
the reduced model runs the same code paths as the published one.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["lm_shrink"]


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
    )
