"""Plain torch versions of the segment ops (K5's contract, embedding-bag)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["segment_sum_ref", "embedding_bag_ref"]


def segment_sum_ref(data: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int,
                    weights: Optional[torch.Tensor] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = Σ_{e: seg[e] = s} w[e]·data[r(e)]`` with ``r(e) = e``, or
    ``rows[e]`` when ``rows`` (``[E]``) is given: the rows are gathered
    first.  Ids outside ``[0, n_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them.  ``weights`` (``[E]``, optional)
    multiply the rows before the sum."""
    if rows is not None:
        data = data.index_select(0, rows)
    if weights is not None:
        data = data * weights[:, None]
    # out-of-range rows land in a spare last row, dropped after the sum (no
    # masked copy of data)
    keep = (seg_ids >= 0) & (seg_ids < n_segments)
    idx = torch.where(keep, seg_ids.long(), n_segments)
    out = torch.zeros((n_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, idx, data)[:n_segments]


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
