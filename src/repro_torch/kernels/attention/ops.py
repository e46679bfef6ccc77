"""Public attention op: K6 on the card, its plain version on the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_kernel

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of q ``[B, Hq, Sq, Dh]`` over k / v ``[B, Hkv, Sk,
    Dh]`` (GQA: q head ``h`` reads kv head ``h // (Hq // Hkv)``), the
    reference's layout.  ``causal`` keeps keys at positions ``<=`` the
    query's (both counted from 0, the Pallas kernel's convention; the same
    as the bottom-right alignment of ``attention_ref`` when ``Sq == Sk``);
    ``kv_len`` masks the keys at index ``>= kv_len``.  Any ``Sq`` / ``Sk``:
    nothing is padded, so bidirectional attention over a ragged ``Sk`` is
    exact.

    The result is ``[B, Hq, Sq, Dh]``, laid out in memory as ``[B, Sq, Hq,
    Dh]`` so that the model's ``transpose(1, 2)`` back to its own layout
    is contiguous.
    """
    b, hq, sq, dh = q.shape
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    return flash_attention_kernel(q, k, v, causal=causal, kv_len=kv_len,
                                  out=out)
