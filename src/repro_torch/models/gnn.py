"""GNN forward on the sorted segment sum: GIN (Xu et al., ICLR'19).

Message passing reduces edge messages by destination.  The port keeps the
edges in destination-sorted order (:func:`prepare_batch`, once per
batch) so that each layer's aggregation is one launch of K5
(:func:`repro_torch.kernels.segment.segment_sum_sorted`) in its gather
form: K5 reads ``h[src[e]]`` itself and folds the edge mask in as the
per-row weight, so no ``[E, d]`` message buffer is ever made, and no
atomics run.

Batch convention (the reference's; numpy arrays or tensors):

    batch = {
      "x":        [N, F]   node features,
      "src","dst":[E]      directed edges (messages flow src -> dst),
      "node_mask":[N]      1.0 = real node,
      "edge_mask":[E]      1.0 = real edge,
      "labels":   task-dependent,
    }

The other archs (MeshGraphNet, EGNN, DimeNet), the locality-partitioned
halo batch and training (``loss_fn``) wait (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as fn
from torch import nn

from ..kernels.segment import chunk_plan, row_ranges, segment_sum_sorted

__all__ = ["GNNConfig", "GIN", "init_params", "prepare_batch", "forward",
           "graph_pool"]

_NOT_PORTED = ("is not ported yet (ROADMAP §1, items 7 (b)-(d): training, "
               "the remaining GNN archs and the halo path)")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # gin; meshgraphnet | egnn | dimenet wait
    n_layers: int
    d_hidden: int
    d_feat: int  # input node feature dim
    d_out: int = 1
    n_classes: int = 0  # >0 => classification
    dtype: torch.dtype = torch.float32
    task: str = "node"  # node | graph


class MLP(nn.Module):
    """``x @ w + b`` per layer, SiLU between layers (and after the last
    with ``final_act``); weights in the reference's ``[in, out]`` layout."""

    def __init__(self, dims: Sequence[int], gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        dev = gen.device
        self.w = nn.ParameterList(
            nn.Parameter((torch.randn((a, b), generator=gen, device=dev)
                          / math.sqrt(a)).to(dtype), requires_grad=False)
            for a, b in zip(dims[:-1], dims[1:]))
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(b, dtype=dtype, device=dev),
                         requires_grad=False)
            for b in dims[1:])

    def forward(self, x: torch.Tensor, final_act: bool = False):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1 or final_act:
                x = fn.silu(x)
        return x


class GIN(nn.Module):
    """GIN parameters: ``embed`` (d_feat → d), per layer ``eps[l]`` and a
    two-layer ``mlps[l]``, and ``readout`` (d → d → classes or d_out)."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_hidden, cfg.dtype
        self.embed = MLP((cfg.d_feat, d), gen, dt)
        self.eps = nn.Parameter(
            torch.zeros(cfg.n_layers, dtype=dt, device=gen.device),
            requires_grad=False)
        self.mlps = nn.ModuleList(MLP((d, d, d), gen, dt)
                                  for _ in range(cfg.n_layers))
        self.readout = MLP((d, d, cfg.n_classes or cfg.d_out), gen, dt)

    @property
    def device(self) -> torch.device:
        return self.eps.device


def init_params(cfg: GNNConfig, *, seed: int = 0, device="cuda") -> GIN:
    """The model's parameters on ``device``, drawn from a seeded
    ``torch.Generator`` there (weights N(0, 1/fan_in), biases and eps 0)."""
    if cfg.arch != "gin":
        raise NotImplementedError(f"arch {cfg.arch!r} {_NOT_PORTED}")
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return GIN(cfg, gen)


def prepare_batch(batch: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device`` plus its destination-sorted edge
    order: ``agg_src`` / ``agg_dst`` (int32) and ``agg_w`` (the edge mask,
    or None) in a stable sort by destination, and K5's row ranges
    ``agg_ptr`` and work plan ``agg_plan``.  A forward over a prepared
    batch sorts and builds nothing."""
    if "src_slot" in batch:
        raise NotImplementedError(f"the halo batch {_NOT_PORTED}")
    dev = torch.device(device)
    out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    dst = out["dst"].to(torch.int32)
    seg, order = torch.sort(dst, stable=True)
    em = out.get("edge_mask")
    out["agg_src"] = out["src"].to(torch.int32)[order]
    out["agg_dst"] = seg
    out["agg_w"] = None if em is None else em[order].contiguous()
    out["agg_ptr"] = row_ranges(seg, out["x"].shape[0])
    out["agg_plan"] = chunk_plan(out["agg_ptr"], seg.shape[0])
    return out


def forward(model: GIN, batch: Dict, *,
            segment_sum=segment_sum_sorted) -> torch.Tensor:
    """Node outputs ``[N, n_classes or d_out]``.  ``batch`` may be raw
    (numpy) or :func:`prepare_batch`'s; ``segment_sum`` is the aggregation's
    reduction, called in its gather form (``chip_smoke.py`` passes the
    plain version to check K5 in place)."""
    if "agg_plan" not in batch:
        batch = prepare_batch(batch, model.device)
    x = batch["x"]
    n = x.shape[0]
    src, seg, w, ptr, plan = (batch["agg_src"], batch["agg_dst"],
                              batch["agg_w"], batch["agg_ptr"],
                              batch["agg_plan"])
    h = model.embed(x, final_act=True)
    for l in range(model.cfg.n_layers):
        # sum over in-edges of w·h[src]: the messages are never built
        agg = segment_sum(h, seg, n, weights=w, ptr=ptr, rows=src, plan=plan)
        h = model.mlps[l]((1.0 + model.eps[l]) * h + agg, final_act=True)
    return model.readout(h)


def graph_pool(node_vals: torch.Tensor, graph_ids: torch.Tensor,
               n_graphs: int, node_mask=None) -> torch.Tensor:
    """Sum node values per graph (``[N, d] -> [n_graphs, d]``), masked."""
    ids, order = torch.sort(graph_ids.to(torch.int32), stable=True)
    return segment_sum_sorted(
        node_vals, ids, n_graphs, rows=order,
        weights=None if node_mask is None else node_mask[order])
