"""Reduced same-family configs for CPU runs of the training entry points.

:func:`lm_shrink` narrows an LM config the way the reference's
``configs.smoke._lm_shrink`` does (2 layers, d=64, heads / 8, Dh 16,
vocab 128, float32, cross-entropy chunks of 16 tokens, one microbatch):
the GQA ratio and the QKV bias survive, and a MoE stays a MoE with its
shared experts (at most 8 experts, top 2, ``d_ff_expert`` 16, padded to
8), so the reduced model runs the same code paths as the published one.
:func:`smoke_setup` is the reference's: the reduced config and a tiny
batch of an LM, GIN or FM arch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..data import criteo_like_batch, lm_token_batch, molecule_batch
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
    """``(reduced model cfg, tiny batch (numpy), family)``, the reference's:
    an LM arch :func:`lm_shrink`'s config and ``lm_token_batch(0, 2, 32,
    vocab)``; a GNN arch at most 3 layers, d 16, d_feat 8, 4 bilinear,
    spherical and radial channels, on ``molecule_batch(4, 10, 20,
    d_feat=8, ...)``: ``gin-tu`` a node task of 5 classes (labels from
    ``default_rng(0)``), ``meshgraphnet`` a node regression (``[N,
    d_out]`` labels from it), ``egnn`` and ``dimenet`` (with triplets) a
    graph regression; ``fm`` 6 fields of 100 rows, D 8, on
    ``criteo_like_batch(0, 32, 6, 100)``.  The archs still to port raise
    (``configs.PENDING``)."""
    spec = get_arch(arch_id)
    rng = np.random.default_rng(0)
    if spec.family == "lm":
        cfg = lm_shrink(spec.model_cfg)
        return cfg, lm_token_batch(0, 2, 32, cfg.vocab), "lm"
    if spec.family == "gnn":
        cfg = dataclasses.replace(
            spec.model_cfg, n_layers=min(spec.model_cfg.n_layers, 3),
            d_hidden=16, d_feat=8, n_bilinear=4, n_spherical=4, n_radial=4)
        arch = cfg.arch
        mol = dict(nodes_per_graph=10, edges_per_graph=20, d_feat=8)
        if arch in ("dimenet", "egnn"):
            cfg = dataclasses.replace(cfg, task="graph", n_classes=0)
            return cfg, molecule_batch(4, with_triplets=arch == "dimenet",
                                       **mol), "gnn"
        raw = molecule_batch(4, graph_labels=False, **mol)
        n = raw["x"].shape[0]
        if arch == "gin":
            cfg = dataclasses.replace(cfg, task="node", n_classes=5,
                                      d_out=5)
            raw["labels"] = rng.integers(0, 5, n).astype(np.int32)
        else:  # meshgraphnet: node regression
            cfg = dataclasses.replace(cfg, task="node", n_classes=0)
            raw["labels"] = rng.standard_normal((n, cfg.d_out)).astype(
                np.float32)
        return cfg, raw, "gnn"
    cfg = dataclasses.replace(spec.model_cfg, n_fields=6,
                              vocab_per_field=100, embed_dim=8)
    return cfg, criteo_like_batch(0, 32, cfg.n_fields,
                                  cfg.vocab_per_field), "recsys"
