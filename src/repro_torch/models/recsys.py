"""Factorization Machine recsys model (Rendle, ICDM'10) with huge tables.

y(x) = w0 + Σ_f w[x_f] + Σ_{f<g} ⟨v[x_f], v[x_g]⟩        (x_f categorical)

* One fused embedding table ``[n_fields · vocab_per_field, D]`` with static
  per-field offsets; the lookup is a row gather (``index_select`` with
  int32 rows: the 39M-row table fits int32).
* The pairwise term runs on K4 (:func:`repro_torch.kernels.fm.fm_interaction`)
  for tensors on the card, its plain version on the CPU.
* :func:`retrieval_score` scores one user context against N candidate
  items: FM's interaction with a candidate factorises into
  ⟨u_sum, v_c⟩ + const(c), so retrieval is one ``[N, D]`` matvec.

Training: :func:`loss_fn` is the reference's binary cross-entropy.  The
parameters are built without ``requires_grad`` (serving); the train step
(``launch.steps.fm_train_step``) sets it, and where a gradient is wanted
the lookups go through :func:`~repro_torch.kernels.segment.
embedding_gather` (its backward ``csrc/embedding_bwd.cu`` over the rows
sorted by row id, one sort a batch for both tables: the dense table
gradients, summed in a fixed order) and the pairwise term through
:func:`~repro_torch.kernels.fm.fm_interaction_train` (K4 and its
backward).  :meth:`FM.param_tree` is the reference's pytree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from ..kernels.fm import (fm_interaction, fm_interaction_ref,
                          fm_interaction_train)
from ..kernels.segment import (embedding_gather, segment_sum_ref,
                               segment_sum_sorted)

__all__ = ["FMConfig", "FM", "forward_logits", "loss_fn", "retrieval_score"]


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    dtype: torch.dtype = torch.float32

    @property
    def n_rows(self) -> int:
        return self.n_fields * self.vocab_per_field


class FM(nn.Module):
    """The FM parameters (``table``, ``lin_table``, ``bias``) on one device.

    ``seed`` draws ``table`` from N(0, 1/D) with a ``torch.Generator`` on
    that device; ``lin_table`` and ``bias`` start at 0, as in the
    reference.
    """

    def __init__(self, cfg: FMConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        table = torch.randn((cfg.n_rows, cfg.embed_dim), generator=gen,
                            dtype=torch.float32, device=dev)
        table.mul_(1.0 / math.sqrt(cfg.embed_dim))
        self.table = nn.Parameter(table.to(cfg.dtype), requires_grad=False)
        self.lin_table = nn.Parameter(
            torch.zeros(cfg.n_rows, dtype=cfg.dtype, device=dev),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros((), dtype=cfg.dtype, device=dev),
                                 requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def forward(self, ids) -> torch.Tensor:
        return forward_logits(self, ids)

    def param_tree(self) -> Dict[str, torch.Tensor]:
        """The parameters as the reference's pytree, ``{"bias",
        "lin_table", "table"}``: the module's own tensors."""
        return {"bias": self.bias, "lin_table": self.lin_table,
                "table": self.table}

    @torch.no_grad()
    def load_param_tree(self, tree: Dict[str, torch.Tensor]) -> None:
        """Copy a :meth:`param_tree`-shaped tree (a restored checkpoint's)
        into the parameters."""
        for name, dst in self.param_tree().items():
            if tree[name] is not dst:
                dst.copy_(tree[name])


def _ids(model: FM, ids) -> torch.Tensor:
    return torch.as_tensor(ids, device=model.device).to(torch.int32)


def forward_logits(model: FM, ids, *, kernels: bool = True) -> torch.Tensor:
    """ids: ``[B, F]`` per-field ids -> logits ``[B]`` float32.  With a
    gradient wanted, the ops with their backwards (module docstring);
    ``kernels=False`` runs the plain versions (K4's and the lookups'
    gradients') on any device."""
    cfg = model.cfg
    ids = _ids(model, ids)
    b, f = ids.shape
    offs = torch.arange(f, dtype=torch.int32,
                        device=ids.device) * cfg.vocab_per_field
    rows = (ids + offs[None, :]).reshape(-1)
    if torch.is_grad_enabled() and model.table.requires_grad:
        order = torch.sort(rows, stable=True).indices
        seg_sum = segment_sum_sorted if kernels else segment_sum_ref
        v = embedding_gather(model.table, rows, order, segment_sum=seg_sum)
        lin = embedding_gather(model.lin_table, rows, order, bag=f,
                               segment_sum=seg_sum)
        pair = fm_interaction_train(v.reshape(b, f, cfg.embed_dim),
                                    plain=not kernels)
    else:
        v = model.table.index_select(0, rows).reshape(b, f, cfg.embed_dim)
        lin = model.lin_table.index_select(0, rows).reshape(b, f).sum(-1)
        pair = (fm_interaction if kernels else fm_interaction_ref)(v)
    return (model.bias + lin + pair).to(torch.float32)


def loss_fn(model: FM, batch, *, kernels: bool = True) -> torch.Tensor:
    """Binary cross-entropy on click labels, the reference's formula:
    ``mean(max(z, 0) − z·y + log1p(exp(−|z|)))`` of the logits z."""
    logits = forward_logits(model, batch["ids"], kernels=kernels)
    y = torch.as_tensor(batch["labels"], device=logits.device).to(
        torch.float32)
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))


def retrieval_score(model: FM, user_ids, cand_ids) -> torch.Tensor:
    """Score ONE user context against N candidate items (retrieval_cand).

    user_ids: ``[F-1]`` context features; cand_ids: ``[N]`` ids in the last
    field.  Score vs candidate c = const(u) + w[c] + ⟨Σ_f v_f, v_c⟩: the
    user's own pair term is one K4 sample, the candidates one matvec.
    """
    cfg = model.cfg
    f = cfg.n_fields
    user_ids, cand_ids = _ids(model, user_ids), _ids(model, cand_ids)
    offs = torch.arange(f - 1, dtype=torch.int32,
                        device=user_ids.device) * cfg.vocab_per_field
    u_rows = user_ids + offs
    vu = model.table.index_select(0, u_rows)  # [F-1, D]
    u_sum = vu.sum(0)  # [D]
    u_pair = fm_interaction(vu[None])[0]
    u_lin = model.lin_table.index_select(0, u_rows).sum()
    c_rows = cand_ids + (f - 1) * cfg.vocab_per_field
    vc = model.table.index_select(0, c_rows)  # [N, D]
    scores = (model.bias + u_lin + u_pair
              + model.lin_table.index_select(0, c_rows) + vc @ u_sum)
    return scores.to(torch.float32)
