"""Reduced same-family configs for CPU runs of the LM entry points.

:func:`lm_shrink` narrows an LM config the way the reference's
``configs.smoke._lm_shrink`` does (2 layers, d=64, heads / 8, Dh 16,
vocab 128, float32; the training knobs wait with training): the GQA
ratio and the QKV bias survive, so the reduced model runs the same code
paths as the published one.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["lm_shrink"]


def lm_shrink(cfg):
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=max(2, cfg.n_heads // 8),
        n_kv_heads=max(1, cfg.n_kv_heads // 8),
        d_head=16,
        d_ff=96,
        vocab=128,
        dtype=torch.float32,
    )
