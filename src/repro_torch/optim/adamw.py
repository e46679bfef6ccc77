"""AdamW with float32 master weights, as plain functions over a tree of
tensors (the port of ``repro.optim.adamw``).

Mixed-precision contract, the reference's: model parameters may be bf16;
the optimizer keeps a float32 master copy and float32 moments, and
returns new parameters in the model's dtype.  A tree is a tensor, a
dict of trees or a list of trees (the models' ``param_tree``: GIN's
holds lists), dicts walked in sorted key order and lists in order, the
reference's leaf order.  The state is ``{"master", "m", "v", "step"}``, ``step`` an
int32 0-dim tensor on the parameters' device, so that a checkpoint holds
the reference's leaves.

:func:`adamw_update` updates ``master``, ``m`` and ``v`` **in place**
(the reference returns new ones; here that saves three float32 copies of
the model) and returns the state with the new ``step``.  Its arithmetic
is the reference's, op for op in float32, the schedule and the bias
corrections computed on the device from ``step``; ``torch.optim.AdamW``
is not used (its clip, schedule and bias correction differ).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """A tree's leaves in the reference's order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure, in that order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    if isinstance(trees[0], (list, tuple)):
        return [tree_map(fn, *nodes) for nodes in zip(*trees, strict=True)]
    return fn(*trees)


def adamw_init(params: Any) -> Dict[str, Any]:
    """Float32 master copies of ``params`` and zero moments; step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def linear_warmup(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """``min(1, (step + 1) / max(warmup, 1))`` in float32."""
    return torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)


def cosine_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    warm = linear_warmup(step, cfg)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return warm * cos


def _lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    if cfg.schedule == "cosine":
        return cfg.lr * cosine_schedule(step, cfg)
    if cfg.schedule == "linear":
        t = torch.clamp(step / max(cfg.total_steps, 1), 0.0, 1.0)
        return cfg.lr * linear_warmup(step, cfg) * (
            1 - (1 - cfg.min_lr_frac) * t)
    return cfg.lr * linear_warmup(step, cfg)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / max(|g|, 1e-9))`` and the
    global norm ``|g|`` (float32 sums of squares, leaf by leaf, in the
    tree's order)."""
    sq = [g.float().square().sum() for g in tree_leaves(grads)]
    gn = torch.sqrt(sum(sq[1:], sq[0]))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(grads: Any, opt_state: Dict[str, Any], cfg: AdamWConfig,
                 param_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns ``(new_params in param_dtype, opt_state, {"lr",
    "grad_norm"})``; ``opt_state``'s master and moments are updated in
    place."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), device=opt_state["step"].device)
    step = opt_state["step"] + 1
    lr = _lr_at(step, cfg)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, m, v, g):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        p.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p))
        return p.to(param_dtype, copy=True)

    new_params = tree_map(upd, opt_state["master"], opt_state["m"],
                      opt_state["v"], grads)
    return (new_params, dict(opt_state, step=step),
            {"lr": lr, "grad_norm": gnorm})
