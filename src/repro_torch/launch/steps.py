"""Step callables per (family × cell kind): LM, FM and GNN training,
recsys and LM serving steps.

:func:`build_cell_step` returns, for a ``train`` cell, ``step(params,
opt_state, batch) -> (params, opt_state, metrics)`` (:func:`lm_train_step`
with the cell's overrides, :func:`fm_train_step` or
:func:`gnn_train_step`), and for a serving cell ``step(batch)``:

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

Serving steps run under ``torch.inference_mode`` on the model's device;
the train steps outside it.  Every GNN cell is a train cell.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.common import ArchSpec, ShapeCell
from ..models import gnn, recsys, transformer
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import tree_leaves, tree_map

__all__ = ["build_cell_step", "lm_train_step", "fm_train_step",
           "gnn_train_step"]


def _adamw_step(model: torch.nn.Module, ocfg: AdamWConfig,
                param_dtype: torch.dtype, loss_and_grads: Callable
                ) -> Callable:
    """``step(params, opt_state, batch)``: ``params`` (the model's
    ``param_tree()``, or a restored copy of it) loaded into the model,
    ``loss_and_grads(batch, leaves)`` over the tree's leaves, then
    :func:`adamw_update`, whose new parameters are copied into the model.
    Returns ``(params, opt_state, {"loss", "lr", "grad_norm"})``, the
    metrics 0-dim tensors.  Sets the parameters' ``requires_grad``."""
    model.requires_grad_(True)

    def step(params: Any, opt_state: Dict[str, Any], batch):
        model.load_param_tree(params)
        tree = model.param_tree()
        leaves = tree_leaves(tree)
        loss, grads = loss_and_grads(batch, leaves)
        it = iter(grads)
        new_params, opt_state, metrics = adamw_update(
            tree_map(lambda _: next(it), tree), opt_state, ocfg,
            param_dtype=param_dtype)
        with torch.no_grad():
            for dst, src in zip(leaves, tree_leaves(new_params)):
                dst.copy_(src)
        return tree, opt_state, {"loss": loss, **metrics}

    return step


def lm_train_step(model: transformer.Transformer, ocfg: AdamWConfig,
                  cfg: Optional[transformer.TransformerConfig] = None
                  ) -> Callable:
    """The reference's LM train step on ``model`` (``cfg``: the model's
    config, or one with other training knobs): ``step(params, opt_state,
    batch)`` with ``params`` the model's :meth:`param_tree` (or a restored
    copy of it, loaded into the model first) and ``opt_state``
    :func:`~repro_torch.optim.adamw_init`'s.  It takes the gradient of
    :func:`~repro_torch.models.transformer.train_loss` (the parameters'
    dtype: bf16 for a bf16 model), or with ``n_microbatches > 1`` that of
    each microbatch in turn (its own forward and backward), accumulated in
    float32 and divided by their number; then :func:`adamw_update`, whose
    new parameters are copied into the model.  Returns ``(params,
    opt_state, {"loss", "lr", "grad_norm"})``, the metrics 0-dim tensors.
    Sets the parameters' ``requires_grad``."""
    cfg = cfg or model.cfg
    nm = cfg.n_microbatches
    cfg_mb = dataclasses.replace(cfg, n_microbatches=1)

    def loss_and_grads(tokens, labels, leaves):
        loss = transformer.train_loss(model, {"tokens": tokens,
                                              "labels": labels}, cfg_mb)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def microbatched(batch, leaves):
        tokens = transformer._tokens(model, batch["tokens"])
        labels = transformer._tokens(model, batch["labels"])
        if nm <= 1:
            return loss_and_grads(tokens, labels, leaves)
        b = tokens.shape[0]
        if b % nm:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"n_microbatches {nm}")
        mb = b // nm
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(nm):
            sl = slice(i * mb, (i + 1) * mb)
            mb_loss, mb_grads = loss_and_grads(tokens[sl], labels[sl],
                                               leaves)
            loss = loss + mb_loss
            for acc, g in zip(grads, mb_grads):
                acc.add_(g.float())
            del mb_grads
        return loss / nm, [g.div_(nm) for g in grads]

    return _adamw_step(model, ocfg, cfg.dtype, microbatched)


def _loss_step(model, ocfg: AdamWConfig, loss_fn) -> Callable:
    def loss_and_grads(batch, leaves):
        loss = loss_fn(model, batch)
        # a leaf the loss does not reach (EGNN's last coordinate MLP) gets
        # zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    return _adamw_step(model, ocfg, model.cfg.dtype, loss_and_grads)


def fm_train_step(model: recsys.FM, ocfg: AdamWConfig) -> Callable:
    """The reference's recsys train step on ``model``: the gradient of
    :func:`~repro_torch.models.recsys.loss_fn` (K4 and its backward, the
    table gradients on ``embedding_bwd``), then AdamW over
    ``model.param_tree()`` (``table``, ``lin_table``, ``bias``); ``batch``
    holds ``ids`` and ``labels``.  Returns ``step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "lr", "grad_norm"})``."""
    return _loss_step(model, ocfg, recsys.loss_fn)


def gnn_train_step(model: torch.nn.Module, ocfg: AdamWConfig) -> Callable:
    """The reference's GNN train step on ``model`` (any arch of
    :func:`~repro_torch.models.gnn.init_params`): the gradient of
    :func:`~repro_torch.models.gnn.loss_fn` (GIN's aggregation backwards
    on K5 over the transposed graph; the other archs' aggregations on K5
    with gather backwards, their row gathers' gradients on
    ``embedding_bwd``), then AdamW over ``model.param_tree()``.  ``batch``
    raw or ``gnn.prepare_batch``'s for the arch (a prepared batch sorts
    nothing).  The same signature as :func:`fm_train_step`'s."""
    return _loss_step(model, ocfg, gnn.loss_fn)


def build_cell_step(spec: ArchSpec, cell: ShapeCell,
                    model: torch.nn.Module,
                    ocfg: Optional[AdamWConfig] = None) -> Callable:
    """The step of ``cell`` on ``model``; ``ocfg`` (default
    ``AdamWConfig()``) for a train cell."""
    ocfg = ocfg or AdamWConfig()
    if spec.family == "lm" and cell.kind == "train":
        cfg = dataclasses.replace(model.cfg, **cell.overrides)
        return lm_train_step(model, ocfg, cfg)
    if spec.family == "recsys" and cell.kind == "train":
        return fm_train_step(model, ocfg)
    if spec.family == "gnn" and cell.kind == "train":
        return gnn_train_step(model, ocfg)
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
    raise ValueError((spec.family, cell.kind))
