"""GNN forward and training on the sorted segment sum: GIN (Xu et al.,
ICLR'19), MeshGraphNet (Pfaff et al., ICLR'21), EGNN (Satorras et al.,
ICML'21) and DimeNet (Klicpera et al., ICLR'20).

Message passing reduces edge messages by destination.  The port sorts the
batch once (:func:`prepare_batch`) and runs every reduction on K5
(:func:`repro_torch.kernels.segment.segment_sum_sorted`), with no atomics:

* GIN's aggregation is one launch of K5's gather form over the
  destination-sorted edges: K5 reads ``h[src[e]]`` itself and folds the
  edge mask in as the per-row weight, so no ``[E, d]`` message buffer is
  made.  Where a gradient is wanted it is
  :func:`~repro_torch.kernels.segment.gather_aggregate`, whose backward is
  K5's gather form over the transposed view (the edges sorted by source).
* The other archs build their messages (``[E, d]``; DimeNet's triplet
  messages ``[T, d]``) and reduce them with
  :func:`~repro_torch.kernels.segment.segment_aggregate`: K5's gather form
  with ``rows`` the destination sort's permutation (MeshGraphNet's and
  EGNN's aggregations, EGNN's ``[E, 3]`` position update, DimeNet's node
  outputs), or its contiguous form over the triplets, which
  :func:`prepare_batch` stores sorted by target edge (DimeNet's triplet
  aggregation, ``trip_mask`` the weight).  Their backward is the gather
  ``w·g[ids]``.
* Every row gather that needs a gradient (``h[src]``, ``h[dst]``, EGNN's
  updated ``pos[src]`` / ``pos[dst]``, ``atom_embed[z]``, ``hz[src]``,
  ``hz[dst]``, ``m[trip_f]``) is
  :func:`~repro_torch.kernels.segment.embedding_gather`, whose backward
  is ``csrc/embedding_bwd.cu`` over the rows in the index's stable sort,
  made once a batch; autograd's own backward of a gather would sum by
  float atomics.
* DimeNet's bilinear ``einsum("tb,td,bdh->th", sp, m[trip_f], w_bil)`` is
  :func:`triplet_bilinear`: one ``[T, d] @ [d, d]`` product a bilinear
  channel, weighted by ``sp[:, b]`` and summed in turn; its backward
  recomputes those products, so no ``[T, nb·d]`` tensor is made or kept
  (its plain version, the einsum, makes one).

:func:`loss_fn` is the reference's (node and graph tasks, classification
and regression; a label past the head's width reads NaN, as JAX's
``take_along_axis`` fills it); :meth:`param_tree` each model's pytree.
The parameters are built without ``requires_grad``; the train step sets
it.

Batch convention (the reference's; numpy arrays or tensors):

    batch = {
      "x":        [N, F]   node features,
      "pos":      [N, 3]   coordinates (MeshGraphNet, EGNN, DimeNet),
      "z":        [N]      atom types (DimeNet),
      "src","dst":[E]      directed edges (messages flow src -> dst),
      "edge_attr":[E, Fe]  edge features (MeshGraphNet; optional),
      "node_mask":[N]      1.0 = real node,
      "edge_mask":[E]      1.0 = real edge,
      "graph_ids":[N]      graph id per node (graph tasks),
      "labels":   task-dependent,
      "trip_e":   [T]      DimeNet: target edge of a triplet,
      "trip_f":   [T]      DimeNet: its incoming edge,
      "trip_mask":[T]
    }

The locality-partitioned halo batch waits (ROADMAP §1, item 7 (d)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as fn
from torch import nn

from ..kernels.segment import (embedding_gather, gather_aggregate,
                               segment_aggregate, segment_sum_ref,
                               segment_sum_sorted)
from ..optim.adamw import tree_leaves

__all__ = ["GNNConfig", "GIN", "MeshGraphNet", "EGNN", "DimeNet",
           "init_params", "prepare_batch", "forward", "graph_pool",
           "loss_fn", "layer_norm", "bessel_rbf", "legendre",
           "triplet_bilinear"]

_NOT_PORTED = {
    "halo": "is not ported yet (ROADMAP §1, item 7 (d): the halo path)"}


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # meshgraphnet | egnn | gin | dimenet
    n_layers: int
    d_hidden: int
    d_feat: int  # input node feature dim
    d_edge: int = 0  # input edge feature dim (meshgraphnet)
    d_out: int = 1
    n_classes: int = 0  # >0 => classification
    # gin
    eps_learnable: bool = True
    # dimenet
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    n_atom_types: int = 16
    cutoff: float = 5.0
    dtype: torch.dtype = torch.float32
    task: str = "node"  # node | graph


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``_mlp(..., norm=True)``: the population variance,
    ``rsqrt(var + 1e-6)``, no affine."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6)


class MLP(nn.Module):
    """``x @ w + b`` per layer, SiLU between layers (and after the last
    with ``final_act``), then :func:`layer_norm` with ``norm``; weights in
    the reference's ``[in, out]`` layout."""

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

    def forward(self, x: torch.Tensor, final_act: bool = False,
                norm: bool = False):
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1 or final_act:
                x = fn.silu(x)
        return layer_norm(x) if norm else x

    def tree(self) -> Dict[str, list]:
        return {"b": list(self.b), "w": list(self.w)}


def _param(t: torch.Tensor, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(t.to(dtype), requires_grad=False)


class _Model(nn.Module):
    """What the four archs share: the config, the device, and the pytree
    (:meth:`param_tree`, in the reference's key order) loaded back by
    :meth:`load_param_tree`."""

    cfg: GNNConfig

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def param_tree(self) -> Dict[str, Any]:
        raise NotImplementedError

    @torch.no_grad()
    def load_param_tree(self, tree: Dict[str, Any]) -> None:
        """Copy a :meth:`param_tree`-shaped tree (a restored checkpoint's)
        into the parameters."""
        for dst, src in zip(tree_leaves(self.param_tree()),
                            tree_leaves(tree), strict=True):
            if src is not dst:
                dst.copy_(src)


class GIN(_Model):
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

    def param_tree(self) -> Dict[str, Any]:
        """``embed``, ``eps``, ``mlps`` (a list) and ``readout``, each MLP
        ``{"b": [...], "w": [...]}`` of the module's own tensors."""
        return {"embed": self.embed.tree(), "eps": self.eps,
                "mlps": [m.tree() for m in self.mlps],
                "readout": self.readout.tree()}


class MeshGraphNet(_Model):
    """``node_enc`` (d_feat → d → d), ``edge_enc`` (d_edge or 4 → d → d),
    per layer ``edge_mlps[l]`` (3d → d → d) and ``node_mlps[l]`` (2d → d
    → d), ``decoder`` (d → d → d_out); every MLP but the decoder
    layer-normed."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt, n = cfg.d_hidden, cfg.dtype, cfg.n_layers
        self.node_enc = MLP((cfg.d_feat, d, d), gen, dt)
        self.edge_enc = MLP((cfg.d_edge or 4, d, d), gen, dt)
        self.edge_mlps = nn.ModuleList(MLP((3 * d, d, d), gen, dt)
                                       for _ in range(n))
        self.node_mlps = nn.ModuleList(MLP((2 * d, d, d), gen, dt)
                                       for _ in range(n))
        self.decoder = MLP((d, d, cfg.d_out), gen, dt)

    def param_tree(self) -> Dict[str, Any]:
        return {"decoder": self.decoder.tree(),
                "edge_enc": self.edge_enc.tree(),
                "edge_mlps": [m.tree() for m in self.edge_mlps],
                "node_enc": self.node_enc.tree(),
                "node_mlps": [m.tree() for m in self.node_mlps]}


class EGNN(_Model):
    """``embed`` (d_feat → d), per layer ``edge_mlps[l]`` (2d + 1 → d →
    d), ``coord_mlps[l]`` (d → d → 1) and ``node_mlps[l]`` (2d → d → d),
    ``readout`` (d → d → d_out)."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt, n = cfg.d_hidden, cfg.dtype, cfg.n_layers
        self.embed = MLP((cfg.d_feat, d), gen, dt)
        self.edge_mlps = nn.ModuleList(MLP((2 * d + 1, d, d), gen, dt)
                                       for _ in range(n))
        self.coord_mlps = nn.ModuleList(MLP((d, d, 1), gen, dt)
                                        for _ in range(n))
        self.node_mlps = nn.ModuleList(MLP((2 * d, d, d), gen, dt)
                                       for _ in range(n))
        self.readout = MLP((d, d, cfg.d_out), gen, dt)

    def param_tree(self) -> Dict[str, Any]:
        return {"coord_mlps": [m.tree() for m in self.coord_mlps],
                "edge_mlps": [m.tree() for m in self.edge_mlps],
                "embed": self.embed.tree(),
                "node_mlps": [m.tree() for m in self.node_mlps],
                "readout": self.readout.tree()}


class DimeNetBlock(nn.Module):
    """One interaction block: ``sbf_proj`` (ns·nr → nb), the bilinear
    ``w_bil [nb, d, d]`` (N(0, 1/(nb·d))), ``msg_mlp`` (2d → d → d) and
    ``out_mlp`` (d → d)."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        d, dt, nb = cfg.d_hidden, cfg.dtype, cfg.n_bilinear
        self.sbf_proj = MLP((cfg.n_spherical * cfg.n_radial, nb), gen, dt)
        self.w_bil = _param(torch.randn((nb, d, d), generator=gen,
                                        device=gen.device)
                            / math.sqrt(nb * d), dt)
        self.msg_mlp = MLP((2 * d, d, d), gen, dt)
        self.out_mlp = MLP((d, d), gen, dt)

    def tree(self) -> Dict[str, Any]:
        return {"msg_mlp": self.msg_mlp.tree(),
                "out_mlp": self.out_mlp.tree(),
                "sbf_proj": self.sbf_proj.tree(), "w_bil": self.w_bil}


class DimeNet(_Model):
    """``atom_embed [n_atom_types, d]`` (N(0, 0.01)), ``rbf_proj`` (nr →
    d), ``edge_embed`` (3d → d), ``n_layers`` :class:`DimeNetBlock`\\ s and
    ``readout`` (d → d → d_out)."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_hidden, cfg.dtype
        self.atom_embed = _param(torch.randn(
            (cfg.n_atom_types, d), generator=gen, device=gen.device) * 0.1,
            dt)
        self.rbf_proj = MLP((cfg.n_radial, d), gen, dt)
        self.edge_embed = MLP((3 * d, d), gen, dt)
        self.blocks = nn.ModuleList(DimeNetBlock(cfg, gen)
                                    for _ in range(cfg.n_layers))
        self.readout = MLP((d, d, cfg.d_out), gen, dt)

    def param_tree(self) -> Dict[str, Any]:
        return {"atom_embed": self.atom_embed,
                "blocks": [b.tree() for b in self.blocks],
                "edge_embed": self.edge_embed.tree(),
                "rbf_proj": self.rbf_proj.tree(),
                "readout": self.readout.tree()}


_ARCHS = {"gin": GIN, "meshgraphnet": MeshGraphNet, "egnn": EGNN,
          "dimenet": DimeNet}


def init_params(cfg: GNNConfig, *, seed: int = 0, device="cuda") -> _Model:
    """The arch's model on ``device``, its parameters drawn from a seeded
    ``torch.Generator`` there (weights N(0, 1/fan_in), biases and eps 0,
    DimeNet's ``atom_embed`` N(0, 0.01) and ``w_bil`` N(0, 1/(nb·d)))."""
    if cfg.arch not in _ARCHS:
        raise ValueError(f"unknown GNN arch {cfg.arch!r}")
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return _ARCHS[cfg.arch](cfg, gen)


def prepare_batch(batch: Dict, device="cuda",
                  arch: str = "gin") -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device`` plus its sorts, each made once:

    * ``agg_src`` / ``agg_dst`` (int32) and ``agg_w`` (the edge mask, or
      None) in a stable sort by destination, and the transposed view,
      ``aggT_seg`` (the sources, sorted) / ``aggT_rows`` (int32, the
      destinations) and ``aggT_w`` in a stable sort by source;
    * with ``graph_ids``, ``pool_ids`` / ``pool_order`` / ``pool_w``: the
      graph ids' stable sort, its permutation and the node mask in it;
    * for an arch other than GIN, ``dst_order`` / ``src_order``: the two
      sorts' permutations (the aggregations' rows, the gathers' orders),
      ``z_order`` (the stable sort of ``z``) and the triplets stably
      sorted by ``trip_e`` (``trip_e``, ``trip_f``, ``trip_mask``
      replaced, in that order), with ``trip_f_order``.

    A forward or a gradient over a prepared batch sorts nothing."""
    if "src_slot" in batch:
        raise NotImplementedError(f"the halo batch {_NOT_PORTED['halo']}")
    dev = torch.device(device)
    out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
           if v is not None}
    src, dst = out["src"].to(torch.int32), out["dst"].to(torch.int32)
    em = out.get("edge_mask")
    orders = {}
    for seg_key, rows_key, w_key, by, other in (
            ("agg_dst", "agg_src", "agg_w", dst, src),
            ("aggT_seg", "aggT_rows", "aggT_w", src, dst)):
        out[seg_key], order = torch.sort(by, stable=True)
        out[rows_key] = other[order]
        out[w_key] = None if em is None else em[order].contiguous()
        orders[seg_key] = order
    if "graph_ids" in out:
        out["pool_ids"], order = torch.sort(out["graph_ids"].to(torch.int32),
                                            stable=True)
        out["pool_order"] = order
        nm = out.get("node_mask")
        out["pool_w"] = None if nm is None else nm[order].contiguous()
    if arch == "gin":
        return out
    out["dst_order"], out["src_order"] = orders["agg_dst"], orders["aggT_seg"]
    if "z" in out:
        out["z_order"] = torch.sort(out["z"], stable=True)[1]
    if "trip_e" in out:
        out["trip_e"], perm = torch.sort(out["trip_e"].to(torch.int32),
                                         stable=True)
        out["trip_f"] = out["trip_f"].to(torch.int32)[perm]
        if "trip_mask" in out:
            out["trip_mask"] = out["trip_mask"][perm].contiguous()
        out["trip_f_order"] = torch.sort(out["trip_f"], stable=True)[1]
    return out


def _prepared(model: _Model, batch: Dict) -> Dict:
    key = "agg_dst" if model.cfg.arch == "gin" else "dst_order"
    if key in batch:
        return batch
    return prepare_batch(batch, model.device, model.cfg.arch)


class _Ops:
    """A prepared batch's gathers and aggregations, on the kernels or (with
    ``segment_sum=segment_sum_ref``) on their plain versions."""

    def __init__(self, batch: Dict, segment_sum):
        self.batch, self.segment_sum = batch, segment_sum
        self.plain = segment_sum is segment_sum_ref

    def rows(self, table: torch.Tensor, key: str) -> torch.Tensor:
        """``table[batch[key]]``, its gradient on ``embedding_bwd``."""
        return embedding_gather(table, self.batch[key],
                                self.batch[key + "_order"],
                                segment_sum=self.segment_sum)

    def agg(self, msgs: torch.Tensor, n: int,
            masked: bool = True) -> torch.Tensor:
        """Edge messages summed by destination (times the edge mask)."""
        b = self.batch
        em = b.get("edge_mask") if masked else None
        return segment_aggregate(
            msgs, b["dst"], n, weights=em, order=b["dst_order"],
            sorted_ids=b["agg_dst"],
            sorted_weights=b["agg_w"] if em is not None else None,
            segment_sum=self.segment_sum)


def _forward_gin(model: GIN, batch: Dict, segment_sum) -> torch.Tensor:
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


def _forward_meshgraphnet(model: MeshGraphNet, b: Dict, ops: _Ops):
    x, src, dst = b["x"], b["src"], b["dst"]
    n = x.shape[0]
    e = b.get("edge_attr")
    if e is None:
        pos = b.get("pos")
        if pos is not None:
            rel = pos.index_select(0, src) - pos.index_select(0, dst)
            dist = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
            e = torch.cat([rel, dist], -1)
        else:
            e = torch.ones((src.shape[0], 4), dtype=x.dtype,
                           device=x.device)
    h = model.node_enc(x, norm=True)
    he = model.edge_enc(e, norm=True)
    for l in range(model.cfg.n_layers):
        he_in = torch.cat([he, ops.rows(h, "src"), ops.rows(h, "dst")], -1)
        he = he + model.edge_mlps[l](he_in, norm=True)
        agg = ops.agg(he, n)
        h = h + model.node_mlps[l](torch.cat([h, agg], -1), norm=True)
    return model.decoder(h)


def _forward_egnn(model: EGNN, b: Dict, ops: _Ops):
    """``(h, pos)`` after the layers; ``pos`` carries the gradient of the
    coordinate MLPs into the next layer's distances."""
    x, pos = b["x"], b["pos"]
    n = x.shape[0]
    em = b.get("edge_mask")
    h = model.embed(x, final_act=True)
    for l in range(model.cfg.n_layers):
        rel = ops.rows(pos, "src") - ops.rows(pos, "dst")  # [E, 3]
        d2 = torch.sum(rel * rel, -1, keepdim=True)
        m_in = torch.cat([ops.rows(h, "src"), ops.rows(h, "dst"), d2], -1)
        m = model.edge_mlps[l](m_in, final_act=True)
        cw = model.coord_mlps[l](m)  # [E, 1]
        if em is not None:
            cw = cw * em[:, None]
        denom = 1.0 + torch.abs(d2)  # normalized coordinate update
        pos = pos + ops.agg(rel / denom * cw, n, masked=False) / 8
        agg = ops.agg(m, n)
        h = h + model.node_mlps[l](torch.cat([h, agg], -1))
    return h, pos


def bessel_rbf(d: torch.Tensor, cutoff: float, n_radial: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """DimeNet's radial basis ``sqrt(2/c)·sin(nπd/c)/d`` (``d`` clamped at
    1e-6), times the envelope ``(cos(πd/c) + 1)/2`` inside the cutoff, 0
    past it; ``[E] -> [E, n_radial]``."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    x = d[:, None] / cutoff
    rbf = (math.sqrt(2.0 / cutoff) * torch.sin(n[None] * math.pi * x)
           / d[:, None])
    env = torch.where(x < 1.0, 0.5 * (torch.cos(math.pi * x) + 1.0), 0.0)
    return (rbf * env).to(dtype)


def legendre(cos_a: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """``P_l(cos α)``, l = 0 .. n_spherical - 1, by the recurrence;
    ``[T] -> [T, n_spherical]``."""
    outs = [torch.ones_like(cos_a), cos_a]
    for l in range(2, n_spherical):
        outs.append(((2 * l - 1) * cos_a * outs[-1] - (l - 1) * outs[-2])
                    / l)
    return torch.stack(outs[:n_spherical], -1)


class _TripletBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sp, msrc, w):
        ctx.save_for_backward(sp, msrc, w)
        out = msrc.new_zeros((msrc.shape[0], w.shape[2]))
        for b in range(w.shape[0]):
            out.addcmul_(sp[:, b, None], msrc @ w[b])
        return out

    @staticmethod
    def backward(ctx, g):
        sp, msrc, w = ctx.saved_tensors
        grad_sp = torch.empty_like(sp)
        grad_m = torch.zeros_like(msrc)
        grad_w = torch.empty_like(w)
        for b in range(w.shape[0]):
            gw = g @ w[b].T  # [T, d]
            grad_sp[:, b] = torch.sum(msrc * gw, -1)
            grad_m.addcmul_(sp[:, b, None], gw)
            grad_w[b] = msrc.T @ (sp[:, b, None] * g)
        return grad_sp, grad_m, grad_w


def triplet_bilinear(sp: torch.Tensor, msrc: torch.Tensor, w: torch.Tensor,
                     *, plain: bool = False) -> torch.Tensor:
    """DimeNet's ``einsum("tb,td,bdh->th", sp, msrc, w)``: ``Σ_b sp[:, b]
    ⊙ (msrc @ w[b])``, one ``[T, d]`` product at a time, the backward
    recomputing them (no ``[T, nb·d]`` tensor made or saved).  ``plain``
    runs the einsum itself (the plain version; it makes one)."""
    if plain:
        return torch.einsum("tb,td,bdh->th", sp, msrc, w)
    return _TripletBilinear.apply(sp, msrc, w)


def _forward_dimenet(model: DimeNet, b: Dict, ops: _Ops):
    cfg = model.cfg
    src, dst = b["src"], b["dst"]  # directed edges j -> i
    pos = b["pos"]
    n, e_count = pos.shape[0], src.shape[0]
    trip_e, trip_f = b["trip_e"], b["trip_f"]
    tm = b.get("trip_mask")

    rel = pos.index_select(0, src) - pos.index_select(0, dst)
    dist = torch.linalg.vector_norm(rel + 1e-9, dim=-1)  # [E]
    rbf = bessel_rbf(dist, cfg.cutoff, cfg.n_radial, pos.dtype)  # [E, nr]
    rbf_h = model.rbf_proj(rbf)  # [E, d]

    hz = ops.rows(model.atom_embed, "z")  # [N, d]
    m = model.edge_embed(torch.cat([ops.rows(hz, "src"), ops.rows(hz, "dst"),
                                    rbf_h], -1), final_act=True)  # [E, d]

    # the angle at j between edge e = (j -> i) and its incoming f = (k -> j)
    v1 = rel.index_select(0, trip_e)
    v2 = rel.index_select(0, trip_f)
    cos_a = torch.sum(v1 * v2, -1) / (
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1) + 1e-9)
    leg = legendre(cos_a, cfg.n_spherical)  # [T, ns]
    rbf_t = bessel_rbf(dist.index_select(0, trip_f), cfg.cutoff,
                       cfg.n_radial, pos.dtype)  # [T, nr]
    sbf = (leg[:, :, None] * rbf_t[:, None, :]).reshape(trip_e.shape[0], -1)

    node_out = torch.zeros((n, cfg.d_hidden), dtype=m.dtype, device=m.device)
    for blk in model.blocks:
        sp = blk.sbf_proj(sbf)  # [T, nb]
        inter = triplet_bilinear(sp, ops.rows(m, "trip_f"), blk.w_bil,
                                 plain=ops.plain)
        # the triplets come sorted by target edge: K5's contiguous form
        agg_t = segment_aggregate(inter, trip_e, e_count, weights=tm,
                                  segment_sum=ops.segment_sum)  # [E, d]
        m = m + blk.msg_mlp(torch.cat([m, agg_t], -1), final_act=True)
        node_out = node_out + ops.agg(blk.out_mlp(m), n)
    return model.readout(node_out)  # [N, d_out]


def forward(model: _Model, batch: Dict, *,
            segment_sum=segment_sum_sorted) -> torch.Tensor:
    """Node outputs ``[N, n_classes or d_out]`` (GIN; the others ``[N,
    d_out]``).  ``batch`` may be raw (numpy) or :func:`prepare_batch`'s
    for the model's arch; ``segment_sum`` is the reductions' K5
    (``chip_smoke.py`` passes the plain version to check it in place;
    :func:`segment_sum_ref` also brings the plain backwards and DimeNet's
    plain bilinear)."""
    batch = _prepared(model, batch)
    arch = model.cfg.arch
    if arch == "gin":
        return _forward_gin(model, batch, segment_sum)
    ops = _Ops(batch, segment_sum)
    if arch == "meshgraphnet":
        return _forward_meshgraphnet(model, batch, ops)
    if arch == "egnn":
        h, _pos = _forward_egnn(model, batch, ops)
        return model.readout(h)
    return _forward_dimenet(model, batch, ops)


def graph_pool(node_vals: torch.Tensor, graph_ids: torch.Tensor,
               n_graphs: int, node_mask=None, *,
               segment_sum=segment_sum_sorted,
               order: Optional[torch.Tensor] = None,
               sorted_ids: Optional[torch.Tensor] = None,
               sorted_weights: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Sum node values per graph (``[N, d] -> [n_graphs, d]``), masked;
    K5's gather form over the nodes sorted by graph (``order``,
    ``sorted_ids``, ``sorted_weights``: :func:`prepare_batch`'s
    ``pool_order``, ``pool_ids``, ``pool_w``; sorted here when not
    given).  Its gradient is the gather ``g[graph_ids]·mask``."""
    if order is None:
        sorted_ids, order = torch.sort(graph_ids.to(torch.int32),
                                       stable=True)
        sorted_weights = None
    return segment_aggregate(node_vals, graph_ids, n_graphs,
                             weights=node_mask, order=order,
                             sorted_ids=sorted_ids,
                             sorted_weights=sorted_weights,
                             segment_sum=segment_sum)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logits, labels[:, None], -1)[:, 0]`` as JAX runs
    it: a negative label counts from the end, and one outside the row
    reads NaN.  The gather itself stays in range (on the card an
    out-of-range gather is a device assert)."""
    c = logits.shape[-1]
    idx = labels.long()
    idx = torch.where(idx < 0, idx + c, idx)
    ok = (idx >= 0) & (idx < c)
    gold = logits.gather(1, idx.clamp(0, max(c - 1, 0))[:, None])[:, 0]
    return torch.where(ok, gold, torch.nan)


def loss_fn(model: _Model, batch: Dict, *, kernels: bool = True
            ) -> torch.Tensor:
    """The reference's GNN loss: for a graph task the per-graph sums of
    the outputs (masked by ``node_mask``) against ``labels`` by softmax
    cross-entropy (classes) or squared error; for a node task the same
    per node, averaged over the ``node_mask``'s nodes where it is given.
    A class label past the head's width gives NaN, as in the reference
    (MeshGraphNet's, EGNN's and DimeNet's heads are ``d_out`` wide).
    ``batch`` raw or :func:`prepare_batch`'s; ``kernels=False`` runs K5's
    plain version, the plain backwards and DimeNet's plain bilinear on any
    device."""
    batch = _prepared(model, batch)
    seg_sum = segment_sum_sorted if kernels else segment_sum_ref
    out = forward(model, batch, segment_sum=seg_sum)
    nm = batch.get("node_mask")
    labels = batch["labels"]
    cfg = model.cfg
    if cfg.task == "graph":
        pooled = graph_pool(out, batch["graph_ids"], labels.shape[0], nm,
                            segment_sum=seg_sum,
                            order=batch.get("pool_order"),
                            sorted_ids=batch.get("pool_ids"),
                            sorted_weights=batch.get("pool_w")).float()
        if cfg.n_classes:
            gold = _gold(pooled, labels)
            return torch.mean(torch.logsumexp(pooled, -1) - gold)
        return torch.mean((pooled[:, 0] - labels.float()) ** 2)
    if cfg.n_classes:
        logits = out.float()
        per = torch.logsumexp(logits, -1) - _gold(logits, labels)
        if nm is not None:
            return torch.sum(per * nm) / torch.clamp(nm.sum(), min=1.0)
        return torch.mean(per)
    err = (out - labels.to(out.dtype)) ** 2
    if nm is not None:
        return (torch.sum(err.mean(-1) * nm)
                / torch.clamp(nm.sum(), min=1.0)).float()
    return torch.mean(err).float()
