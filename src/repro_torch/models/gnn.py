"""GNN forward and training on the sorted segment sum: GIN (Xu et al.,
ICLR'19).

Message passing reduces edge messages by destination.  The port keeps the
edges in destination-sorted order (:func:`prepare_batch`, once per
batch) so that each layer's aggregation is one launch of K5
(:func:`repro_torch.kernels.segment.segment_sum_sorted`) in its gather
form: K5 reads ``h[src[e]]`` itself and folds the edge mask in as the
per-row weight, so no ``[E, d]`` message buffer is ever made, and no
atomics run.  :func:`prepare_batch` also sorts the edges by source once,
the transposed graph: where a gradient is wanted each aggregation is
:func:`~repro_torch.kernels.segment.gather_aggregate`, whose backward is
K5's gather form over that view, again with no buffer and no atomics.
:func:`loss_fn` is the reference's (node and graph tasks, classification
and regression); :meth:`GIN.param_tree` its pytree.  The parameters are
built without ``requires_grad``; the train step sets it.

Batch convention (the reference's; numpy arrays or tensors):

    batch = {
      "x":        [N, F]   node features,
      "src","dst":[E]      directed edges (messages flow src -> dst),
      "node_mask":[N]      1.0 = real node,
      "edge_mask":[E]      1.0 = real edge,
      "labels":   task-dependent,
    }

The other archs (MeshGraphNet, EGNN, DimeNet) and the
locality-partitioned halo batch wait (ROADMAP §1, items 7 (c), (d)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as fn
from torch import nn

from ..kernels.segment import (gather_aggregate, segment_sum_ref,
                               segment_sum_sorted)
from ..optim.adamw import tree_leaves

__all__ = ["GNNConfig", "GIN", "init_params", "prepare_batch", "forward",
           "graph_pool", "loss_fn"]

_NOT_PORTED = {
    "arch": "is not ported yet (ROADMAP §1, item 7 (c): the remaining GNN "
            "archs)",
    "halo": "is not ported yet (ROADMAP §1, item 7 (d): the halo path)"}


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

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the reference's pytree: ``embed``, ``eps``,
        ``mlps`` (a list) and ``readout``, each MLP ``{"b": [...], "w":
        [...]}`` of the module's own tensors."""
        def mlp(m):
            return {"b": list(m.b), "w": list(m.w)}

        return {"embed": mlp(self.embed), "eps": self.eps,
                "mlps": [mlp(m) for m in self.mlps],
                "readout": mlp(self.readout)}

    @torch.no_grad()
    def load_param_tree(self, tree: Dict[str, Any]) -> None:
        """Copy a :meth:`param_tree`-shaped tree (a restored checkpoint's)
        into the parameters."""
        for dst, src in zip(tree_leaves(self.param_tree()),
                            tree_leaves(tree), strict=True):
            if src is not dst:
                dst.copy_(src)


def init_params(cfg: GNNConfig, *, seed: int = 0, device="cuda") -> GIN:
    """The model's parameters on ``device``, drawn from a seeded
    ``torch.Generator`` there (weights N(0, 1/fan_in), biases and eps 0)."""
    if cfg.arch != "gin":
        raise NotImplementedError(f"arch {cfg.arch!r} {_NOT_PORTED['arch']}")
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return GIN(cfg, gen)


def prepare_batch(batch: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device`` plus its destination-sorted edge
    order, ``agg_src`` / ``agg_dst`` (int32) and ``agg_w`` (the edge mask,
    or None) in a stable sort by destination, and the transposed view
    for the aggregation's backward, ``aggT_seg`` (the sources, sorted) /
    ``aggT_rows`` (int32, the destinations) and ``aggT_w`` in a stable
    sort by source.  A forward or a gradient over a prepared batch sorts
    nothing."""
    if "src_slot" in batch:
        raise NotImplementedError(f"the halo batch {_NOT_PORTED['halo']}")
    dev = torch.device(device)
    out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    src, dst = out["src"].to(torch.int32), out["dst"].to(torch.int32)
    em = out.get("edge_mask")
    for seg_key, rows_key, w_key, by, other in (
            ("agg_dst", "agg_src", "agg_w", dst, src),
            ("aggT_seg", "aggT_rows", "aggT_w", src, dst)):
        out[seg_key], order = torch.sort(by, stable=True)
        out[rows_key] = other[order]
        out[w_key] = None if em is None else em[order].contiguous()
    return out


def forward(model: GIN, batch: Dict, *,
            segment_sum=segment_sum_sorted) -> torch.Tensor:
    """Node outputs ``[N, n_classes or d_out]``.  ``batch`` may be raw
    (numpy) or :func:`prepare_batch`'s; ``segment_sum`` is the aggregation's
    reduction, called in its gather form (``chip_smoke.py`` passes the
    plain version to check K5 in place)."""
    if "agg_dst" not in batch:
        batch = prepare_batch(batch, model.device)
    x = batch["x"]
    n = x.shape[0]
    view = dict(weights=batch["agg_w"], rows=batch["agg_src"],
                t_seg=batch["aggT_seg"], t_rows=batch["aggT_rows"],
                t_weights=batch["aggT_w"], segment_sum=segment_sum)
    seg = batch["agg_dst"]
    h = model.embed(x, final_act=True)
    for l in range(model.cfg.n_layers):
        # sum over in-edges of w·h[src]: the messages are never built
        agg = gather_aggregate(h, seg, n, **view)
        h = model.mlps[l]((1.0 + model.eps[l]) * h + agg, final_act=True)
    return model.readout(h)


class _GraphPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node_vals, graph_ids, n_graphs, node_mask, segment_sum):
        gid = graph_ids.long()
        ctx.save_for_backward(gid, node_mask)
        ids, order = torch.sort(graph_ids.to(torch.int32), stable=True)
        return segment_sum(
            node_vals, ids, n_graphs, rows=order,
            weights=None if node_mask is None else node_mask[order])

    @staticmethod
    def backward(ctx, g):
        gid, node_mask = ctx.saved_tensors
        n_graphs = g.shape[0]
        # a gather: each node lies in one graph (none outside [0, n_graphs))
        w = ((gid >= 0) & (gid < n_graphs)).to(g.dtype)
        if node_mask is not None:
            w = w * node_mask
        grad = g.index_select(0, gid.clamp(0, max(n_graphs - 1, 0)))
        return grad * w[:, None], None, None, None, None


def graph_pool(node_vals: torch.Tensor, graph_ids: torch.Tensor,
               n_graphs: int, node_mask=None, *,
               segment_sum=segment_sum_sorted) -> torch.Tensor:
    """Sum node values per graph (``[N, d] -> [n_graphs, d]``), masked;
    K5's gather form over the nodes sorted by graph.  Its gradient is the
    gather ``g[graph_ids]·mask``."""
    return _GraphPool.apply(node_vals, graph_ids, n_graphs, node_mask,
                            segment_sum)


def loss_fn(model: GIN, batch: Dict, *, kernels: bool = True
            ) -> torch.Tensor:
    """The reference's GNN loss: for a graph task the per-graph sums of
    the outputs (masked by ``node_mask``) against ``labels`` by softmax
    cross-entropy (classes) or squared error; for a node task the same
    per node, averaged over the ``node_mask``'s nodes where it is given.
    ``batch`` raw or :func:`prepare_batch`'s; ``kernels=False`` runs K5's
    plain version (and its plain backwards) on any device."""
    if "agg_dst" not in batch:
        batch = prepare_batch(batch, model.device)
    seg_sum = segment_sum_sorted if kernels else segment_sum_ref
    out = forward(model, batch, segment_sum=seg_sum)
    nm = batch.get("node_mask")
    labels = batch["labels"]
    cfg = model.cfg
    if cfg.task == "graph":
        pooled = graph_pool(out, batch["graph_ids"], labels.shape[0], nm,
                            segment_sum=seg_sum).float()
        if cfg.n_classes:
            gold = pooled.gather(1, labels.long()[:, None])[:, 0]
            return torch.mean(torch.logsumexp(pooled, -1) - gold)
        return torch.mean((pooled[:, 0] - labels.float()) ** 2)
    if cfg.n_classes:
        logits = out.float()
        gold = logits.gather(1, labels.long()[:, None])[:, 0]
        per = torch.logsumexp(logits, -1) - gold
        if nm is not None:
            return torch.sum(per * nm) / torch.clamp(nm.sum(), min=1.0)
        return torch.mean(per)
    err = (out - labels.to(out.dtype)) ** 2
    if nm is not None:
        return (torch.sum(err.mean(-1) * nm)
                / torch.clamp(nm.sum(), min=1.0)).float()
    return torch.mean(err).float()
