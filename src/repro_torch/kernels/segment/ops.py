"""Public segment ops: the sorted segment sum and embedding-bag on K5.

``segment_sum_sorted`` is K5 for tensors on the card and its plain
version on the CPU.  ``embedding_bag`` reduces each bag with the same
segment sum in its gather form, the table rows read through the ids and
the bag weights folded into K5 (mode ``"sum"``); modes ``"mean"`` and
``"max"`` take the plain version, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import segment_sum_kernel
from .ref import embedding_bag_ref

__all__ = ["segment_sum_sorted", "embedding_bag", "pad_sorted_edges"]

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
