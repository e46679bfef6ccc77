"""Public segment ops: the sorted segment sum and embedding-bag on K5.

``segment_sum_sorted`` is K5 for tensors on the card and its plain
version on the CPU.  ``embedding_bag`` reduces each bag with the same
segment sum in its gather form, the table rows read through the ids and
the bag weights folded into K5 (mode ``"sum"``); modes ``"mean"`` and
``"max"`` take the plain version, as in the reference.

The MoE FFN's two gathers with their gradients, for training (each a
``torch.autograd.Function`` only where a gradient is wanted; plain ops
otherwise, as in serving):

* :func:`moe_combine` is the combine ``out[t] = Σ w·eo[row]`` through a
  given forward (K5, or its plain version) whose backward is
  :func:`~repro_torch.kernels.segment.backward.moe_combine_bwd`; a
  dropped slot names row -1, which no forward or backward reads, so that
  it adds exact zeros whatever the experts' outputs hold, as the
  reference's ``where(keep, ...)`` does;
* :func:`moe_dispatch` is the dispatch gather ``buf = x[src]`` (row ``t``
  of ``x`` padded with a zero row), whose backward ``grad_x[t] = Σ_{kept
  slots of t} grad_buf[dest]`` is its own kernel
  (:func:`~repro_torch.kernels.segment.dispatch_bwd.dispatch_bwd_kernel`:
  a token's kept slots summed in registers in slot order, written once in
  the model's dtype; a dropped slot reads nothing): deterministic, where
  autograd through ``index_select`` would sum by atomics.  Its launches
  count under ``LAUNCHES["moe_dispatch_bwd"]``, apart from the combine's.

Both take the combine's forward op (``combine``), which carries their
backwards: the plain forward :func:`segment_sum_ref` brings the plain
backwards (:func:`segment_sum_bwd_ref`, :func:`dispatch_bwd_ref`), any
other the kernels (which on the CPU run those same plain versions).

Two more gathers whose rows repeat, so that neither the combine's
backward nor atomics (``index_add_``, autograd's backward of
``index_select``, not deterministic on the card) may sum them; their
backwards sum them over the rows sorted by the row they read:

* :func:`embedding_gather` is the FM table lookup ``table[rows]`` (or its
  sum over bags of ``bag`` consecutive rows, FM's linear term), whose
  backward is its own kernel (:func:`~repro_torch.kernels.segment.
  embedding_bwd.embedding_bwd_kernel`) over ``g`` with ``seg =
  rows[order]`` for the stable sort ``order`` of ``rows``, reading row
  ``order // bag`` of ``g``: the whole dense table gradient, 0 where no
  row was read, each output row written once.  Counted under
  ``LAUNCHES["embedding_gather_bwd"]``.
* :func:`gather_aggregate` is one GIN aggregation (K5's gather form over
  the destination-sorted edges), whose backward is the same kernel over
  the transposed graph (the edges sorted by source): ``grad_h[r] =
  Σ_{e: src[e] = r} w[e]·g[dst[e]]``, no ``[E, D]`` buffer.  Counted
  under ``LAUNCHES["gnn_agg_bwd"]``.

:func:`segment_aggregate` sums rows that are made, one a segment member
(edge messages by destination, triplet messages by target edge, node
values by graph), on K5 over the rows in the ids' stable sort: its gather
form with ``rows`` the sort's permutation, or its contiguous form where
the rows come sorted.  Each row lies in one segment, so its backward is a
gather, ``grad[e] = w[e]·g[ids[e]]``: no reduction, no atomics.

Each takes the reduction it runs (``segment_sum``): the plain version
:func:`segment_sum_ref` brings the plain backward, any other the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

import torch.nn.functional as fn

from .backward import moe_combine_bwd
from .dispatch_bwd import dispatch_bwd_kernel, dispatch_bwd_ref
from .embedding_bwd import embedding_bwd_kernel, embedding_bwd_ref
from .kernel import segment_sum_kernel
from .ref import embedding_bag_ref, segment_sum_bwd_ref, segment_sum_ref

__all__ = ["segment_sum_sorted", "embedding_bag", "pad_sorted_edges",
           "moe_combine", "moe_dispatch", "embedding_gather",
           "gather_aggregate", "segment_aggregate"]

SENTINEL = 2**30  # id of padding rows: outside every segment


def pad_sorted_edges(data: torch.Tensor, seg_ids: torch.Tensor, tile: int):
    """Pad E to a multiple of ``tile``; pad ids get the ``2**30`` sentinel
    (zero rows that K5 skips)."""
    e = data.shape[0]
    e_pad = -(-e // tile) * tile
    if e_pad != e:
        data = torch.cat([data, data.new_zeros((e_pad - e,)
                                               + tuple(data.shape[1:]))])
        seg_ids = torch.cat([seg_ids, torch.full(
            (e_pad - e,), SENTINEL, dtype=torch.int32,
            device=seg_ids.device)])
    return data, seg_ids


def segment_sum_sorted(data: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int, *,
                       weights: Optional[torch.Tensor] = None,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = Σ_{e: seg[e] = s} w[e]·data[r(e)]`` for ``seg_ids``
    sorted ascending; ``-> [n_segments, D]``.  ``r(e) = rows[e]`` when
    ``rows`` is given (the gather form, ``data [*, D]``), else ``e``
    (``data [E, D]``).  ``weights`` multiply the rows first (absent: 1)."""
    def c(t):
        return None if t is None else t.contiguous()

    return segment_sum_kernel(data.contiguous(), seg_ids.contiguous(),
                              n_segments, c(weights), c(rows))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """``out[b] = reduce_l table[ids[b, l]] (· weights[b, l])``."""
    if mode != "sum":
        return embedding_bag_ref(table, ids, weights, mode)
    b, l = ids.shape
    dev = ids.device
    seg = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(l)
    return segment_sum_sorted(
        table, seg, b, weights=None if weights is None else weights.reshape(-1),
        rows=ids.reshape(-1))


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plain(combine) -> bool:
    """The plain forward brings the plain backwards."""
    return combine is segment_sum_ref


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, weights, seg_ids, n, rows, slot, combine, plain):
        ctx.save_for_backward(data, weights, seg_ids, rows, slot)
        ctx.plain = plain
        return combine(data, seg_ids, n, weights=weights, rows=rows)

    @staticmethod
    def backward(ctx, g):
        data, weights, seg_ids, rows, slot = ctx.saved_tensors
        g = g.float()
        if ctx.plain:
            grad_w, grad_data = segment_sum_bwd_ref(g, data, seg_ids, weights,
                                                    rows)
        else:
            grad_w, grad_data = moe_combine_bwd(g, data, seg_ids, weights,
                                                rows, slot)
        return grad_data, grad_w, None, None, None, None, None, None


def moe_combine(data: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
                *, weights: torch.Tensor, rows: torch.Tensor,
                slot: torch.Tensor,
                combine=segment_sum_sorted) -> torch.Tensor:
    """``combine(data, seg_ids, n_segments, weights=, rows=)`` (K5's
    contract, float32 out) with the gradient of ``data`` and ``weights``:
    ``slot [R]`` maps each row of ``data`` to the slot that names it with
    a weight (``E`` or more where none); the kernel backward on the card,
    the plain one with the plain ``combine`` or on the CPU."""
    if not _wants_grad(data, weights):
        return combine(data, seg_ids, n_segments, weights=weights, rows=rows)
    return _Combine.apply(data, weights, seg_ids, n_segments, rows, slot,
                          combine, _plain(combine))


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dest, keep, plain):
        ctx.save_for_backward(dest, keep)
        ctx.n, ctx.plain = x.shape[0], plain
        return fn.pad(x, (0, 0, 0, 1)).index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        dest, keep = ctx.saved_tensors
        bwd = dispatch_bwd_ref if ctx.plain else dispatch_bwd_kernel
        return bwd(g.contiguous(), dest, keep, ctx.n), None, None, None, None


def moe_dispatch(x: torch.Tensor, src: torch.Tensor, *,
                 seg_ids: Optional[torch.Tensor] = None,
                 dest: Optional[torch.Tensor] = None,
                 keep: Optional[torch.Tensor] = None,
                 combine=segment_sum_sorted) -> torch.Tensor:
    """``buf[i] = x[src[i]]`` with ``x [T, D]`` padded by a zero row at
    ``T`` (``src[i] = T`` for an empty buffer row).  With a gradient
    wanted, ``dest`` (each slot's buffer row, int64) and ``keep`` (the
    kept slots, bool), both ``[T·k]`` with token ``t``'s slots at ``t·k``
    to ``t·k + k - 1``, give its backward, :func:`dispatch_bwd_kernel`
    (its plain version with the plain ``combine`` or on the CPU).
    ``seg_ids``, each slot's token, is that layout, which the backward
    takes as given: it is not read."""
    if not _wants_grad(x):
        return fn.pad(x, (0, 0, 0, 1)).index_select(0, src)
    return _Dispatch.apply(x, src, dest, keep, _plain(combine))


class _EmbeddingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows, order, bag, plain):
        ctx.save_for_backward(rows, order)
        ctx.shape, ctx.dtype, ctx.bag, ctx.plain = (table.shape, table.dtype,
                                                    bag, plain)
        return _gather(table, rows, bag)

    @staticmethod
    def backward(ctx, g):
        rows, order = ctx.saved_tensors
        if order is None:
            seg, order = torch.sort(rows, stable=True)
        else:
            seg = rows.index_select(0, order)
        g = g.float().reshape(g.shape[0], -1).contiguous()
        bwd = embedding_bwd_ref if ctx.plain else embedding_bwd_kernel
        grad = bwd(g, seg, order, ctx.shape[0], ctx.bag)
        return grad.reshape(ctx.shape).to(ctx.dtype), None, None, None, None


def _gather(table, rows, bag):
    out = table.index_select(0, rows)
    if bag == 1:
        return out
    return out.reshape((-1, bag) + tuple(table.shape[1:])).sum(1)


def embedding_gather(table: torch.Tensor, rows: torch.Tensor,
                     order: Optional[torch.Tensor] = None, *, bag: int = 1,
                     segment_sum=segment_sum_sorted) -> torch.Tensor:
    """``table[rows]`` (``[E, *]``), or with ``bag > 1`` its sums over
    ``E / bag`` bags of consecutive rows, with the gradient of ``table``
    where one is wanted: :func:`embedding_bwd_kernel` (its plain version
    with ``segment_sum=segment_sum_ref``) over the rows in the stable
    sort ``order`` of ``rows`` (made here when not given; one sort can
    serve every table looked up by the same rows)."""
    if not _wants_grad(table):
        return _gather(table, rows, bag)
    return _EmbeddingGather.apply(table, rows, order, bag,
                                  _plain(segment_sum))


class _GatherAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, seg_ids, n, weights, rows, t_seg, t_rows, t_weights,
                segment_sum, plain):
        ctx.save_for_backward(t_seg, t_rows, t_weights)
        ctx.n_in, ctx.dtype, ctx.plain = h.shape[0], h.dtype, plain
        return segment_sum(h, seg_ids, n, weights=weights, rows=rows)

    @staticmethod
    def backward(ctx, g):
        t_seg, t_rows, t_weights = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.plain:
            gh = segment_sum_ref(g, t_seg, ctx.n_in, t_weights, t_rows)
        else:
            gh = segment_sum_kernel(g, t_seg, ctx.n_in, t_weights, t_rows,
                                    count="gnn_agg_bwd")
        return (gh.to(ctx.dtype),) + (None,) * 9


def gather_aggregate(h: torch.Tensor, seg_ids: torch.Tensor,
                     n_segments: int, *, weights: Optional[torch.Tensor],
                     rows: torch.Tensor, t_seg: torch.Tensor,
                     t_rows: torch.Tensor,
                     t_weights: Optional[torch.Tensor],
                     segment_sum=segment_sum_sorted) -> torch.Tensor:
    """``segment_sum(h, seg_ids, n_segments, weights=, rows=)`` (one GIN
    aggregation over the destination-sorted edges) with the gradient of
    ``h`` where one is wanted: K5's gather form over the same edges sorted
    by their source (``t_seg``: the sources, sorted; ``t_rows``: the
    destinations in that order; ``t_weights``: the weights in that order),
    or its plain version with ``segment_sum=segment_sum_ref``.  The
    weights (the edge mask) get no gradient."""
    if not _wants_grad(h):
        return segment_sum(h, seg_ids, n_segments, weights=weights,
                           rows=rows)
    return _GatherAggregate.apply(h, seg_ids, n_segments, weights, rows,
                                  t_seg, t_rows, t_weights, segment_sum,
                                  _plain(segment_sum))


class _SegmentAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, n, weights, order, sorted_ids, sorted_weights,
                segment_sum):
        ctx.save_for_backward(ids, weights)
        ctx.n, ctx.dtype = n, data.dtype
        return segment_sum(data, sorted_ids, n, weights=sorted_weights,
                           rows=order)

    @staticmethod
    def backward(ctx, g):
        ids, weights = ctx.saved_tensors
        n = ctx.n
        # a gather: each row lies in one segment (none outside [0, n))
        keep = ((ids >= 0) & (ids < n)).to(g.dtype)
        if weights is not None:
            keep = keep * weights
        grad = g.index_select(0, ids.clamp(0, max(n - 1, 0)))
        return ((grad * keep[:, None]).to(ctx.dtype),) + (None,) * 7


def segment_aggregate(data: torch.Tensor, ids: torch.Tensor,
                      n_segments: int, *,
                      weights: Optional[torch.Tensor] = None,
                      order: Optional[torch.Tensor] = None,
                      sorted_ids: Optional[torch.Tensor] = None,
                      sorted_weights: Optional[torch.Tensor] = None,
                      segment_sum=segment_sum_sorted) -> torch.Tensor:
    """``out[s] = Σ_{e: ids[e] = s} w[e]·data[e]`` (``data [E, D]``, ``w``
    absent: 1) ``-> [n_segments, D]`` float32, with the gradient of
    ``data`` where one is wanted: ``w[e]·g[ids[e]]``, 0 for ids outside
    ``[0, n_segments)``.  With ``order`` (the stable sort of ``ids``) the
    reduction runs in its gather form, ``rows = order``, over
    ``sorted_ids = ids[order]`` and ``sorted_weights = w[order]`` (made
    here when not given); without, ``ids`` must come sorted and it runs
    the contiguous form.  ``segment_sum`` is K5 or its plain version; the
    weights (a mask) get no gradient."""
    if order is None:
        sorted_ids, sorted_weights = ids, weights
    else:
        if sorted_ids is None:
            sorted_ids = ids.index_select(0, order)
        if sorted_weights is None and weights is not None:
            sorted_weights = weights.index_select(0, order)
    if not _wants_grad(data):
        return segment_sum(data, sorted_ids, n_segments,
                           weights=sorted_weights, rows=order)
    return _SegmentAggregate.apply(data, ids, n_segments, weights, order,
                                   sorted_ids, sorted_weights, segment_sum)
