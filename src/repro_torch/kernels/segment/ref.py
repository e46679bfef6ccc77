"""Plain torch versions of the segment ops (K5's contract, its backward
in the MoE combine, embedding-bag)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum_ref", "segment_sum_bwd_ref", "embedding_bag_ref"]

_PIECE = 2**26  # elements of data summed by one index_add_


def segment_sum_ref(data: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int,
                    weights: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = Σ_{e: seg[e] = s} w[e]·data[r(e)]`` with ``r(e) = e``, or
    ``rows[e]`` when ``rows`` (``[E]``) is given: the rows are gathered
    first.  Ids outside ``[0, n_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them.  ``weights`` (``[E]``, optional)
    multiply the rows before the sum.  A ``rows[e]`` outside ``[0, R)``
    (``data [R, D]``; the MoE's dropped slots name -1) reads as a zero
    row, as K5 reads it, whatever ``data`` holds.  bfloat16 rows are summed in
    float32, as K5's bf16-row form sums them."""
    # out-of-range rows land in a spare last row, dropped after the sum (no
    # masked copy of data)
    keep = (seg_ids >= 0) & (seg_ids < n_segments)
    idx = torch.where(keep, seg_ids.long(), n_segments)
    dtype = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    if weights is not None:
        dtype = torch.promote_types(dtype, weights.dtype)
    out = torch.zeros((n_segments + 1,) + tuple(data.shape[1:]),
                      dtype=dtype, device=data.device)
    # the rows in pieces of at most _PIECE elements, added in row order:
    # no [E, D] copy of the gathered, weighted rows (15.8 GB at GIN's
    # ogb_products layer), and on the CPU the bits of one index_add_
    e = seg_ids.shape[0]
    step = max(1, _PIECE // max(1, data[:1].numel()))
    for lo in range(0, e, step):
        hi = min(lo + step, e)
        if rows is None:
            piece = data[lo:hi].to(dtype)
        else:
            r = rows[lo:hi]
            named = (r >= 0) & (r < data.shape[0])
            piece = data.index_select(0, torch.where(named, r, 0)).to(dtype)
            piece.masked_fill_(~named[:, None], 0)
        if weights is not None:
            piece = piece * weights[lo:hi, None]
        out.index_add_(0, idx[lo:hi], piece)
    return out[:n_segments]


def segment_sum_bwd_ref(g: torch.Tensor, data: torch.Tensor,
                        seg_ids: torch.Tensor, weights: torch.Tensor,
                        rows: torch.Tensor):
    """The gradients of ``out = segment_sum_ref(data, seg_ids, n, weights,
    rows)`` for ``g = dL/dout`` (``[n, D]`` float32): ``grad_w[e] =
    <data[rows[e]], g[seg[e]]>`` (float32) and ``grad_data[r] = Σ_{e:
    rows[e] = r} w[e]·g[seg[e]]`` (an ``index_add_`` in float32, cast to
    data's dtype; 0 where no row names r).  A slot whose row lies outside
    ``[0, R)`` (a dropped MoE slot) reads no row and adds to none: its
    ``grad_w`` is 0."""
    n_rows = data.shape[0]
    named = (rows >= 0) & (rows < n_rows)
    ge = g.index_select(0, seg_ids.long())
    grad_w = (data.index_select(0, torch.where(named, rows, 0)).float()
              * ge).sum(-1).masked_fill_(~named, 0)
    # slots that name no row land in a spare last row, dropped after
    grad_data = torch.zeros((n_rows + 1,) + tuple(data.shape[1:]),
                            dtype=torch.float32, device=data.device)
    grad_data.index_add_(0, torch.where(named, rows.long(), n_rows),
                         ge * weights[:, None])
    return grad_w, grad_data[:n_rows].to(data.dtype)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum") -> torch.Tensor:
    """``out[b] = reduce_l table[ids[b, l]] (· weights[b, l])``.

    ids: ``[B, L]`` (pad with any valid row and weight 0).
    """
    emb = table[ids.long()]  # [B, L, D]
    if weights is not None:
        emb = emb * weights[..., None]
    if mode == "sum":
        return emb.sum(dim=1)
    if mode == "mean":
        denom = (weights.sum(dim=1, keepdim=True) if weights is not None
                 else torch.full((ids.shape[0], 1), ids.shape[1],
                                 dtype=emb.dtype, device=emb.device))
        return emb.sum(dim=1) / torch.clamp(denom, min=1e-9)
    if mode == "max":
        return emb.max(dim=1).values
    raise ValueError(mode)
