"""Gradient compression for data parallelism across pods (the port of
``repro.optim.compression``): two composable schemes, as pure functions
over tensors and trees of them (``optim.adamw``'s trees).

* **int8 quantisation**: per-tensor symmetric int8 with a float32 scale,
  ``max|x| / 127 + 1e-12``; ``q = clip(round(x / scale), -127, 127)``
  (round half to even, as ``jnp.round``).  Divisions are by 0-dim tensors
  on ``x``'s device, so that the card divides as IEEE does (a division
  by a Python float there multiplies by a host reciprocal).
* **error-feedback top-k**: each leaf sends the entries of ``g + r``
  whose magnitude reaches its ``k``-th largest (``k = max(1, ⌊size ·
  k_frac⌋)``; ties at that threshold are all sent, the reference's
  ``|acc| >= thresh`` rule) and keeps the rest as the next residual, so
  that ``sent + residual == g + r`` holds exactly.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .adamw import tree_leaves, tree_map

__all__ = [
    "compress_int8",
    "decompress_int8",
    "CompressionState",
    "ef_topk_init",
    "ef_topk_compress",
]


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 0-dim)`` of ``x``."""
    xf = x.float()
    scale = (xf.abs().max() / torch.tensor(127.0, device=x.device)
             + torch.tensor(1e-12, device=x.device))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


class CompressionState(NamedTuple):
    residual: Any  # error-feedback memory, the gradients' tree in float32


def ef_topk_init(grads: Any) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _topk_one(g: torch.Tensor, r: torch.Tensor, k_frac: float):
    acc = g.float() + r
    k = max(1, int(acc.numel() * k_frac))
    thresh = torch.topk(acc.abs().reshape(-1), k).values[-1]
    sent = acc * (acc.abs() >= thresh).float()
    return sent.to(g.dtype), acc - sent


def ef_topk_compress(grads: Any, state: CompressionState,
                     k_frac: float = 0.1) -> Tuple[Any, CompressionState]:
    """Per-leaf magnitude top-k with error feedback: ``(sent, new
    state)``, ``sent`` dense (the unsent entries 0) in the gradients'
    dtype."""
    pairs = [_topk_one(g, r, k_frac) for g, r in zip(
        tree_leaves(grads), tree_leaves(state.residual), strict=True)]
    sent, resid = (iter([p[i] for p in pairs]) for i in (0, 1))
    return (tree_map(lambda _: next(sent), grads),
            CompressionState(residual=tree_map(lambda _: next(resid),
                                               grads)))
