"""Plain torch version of K6's contract: exact softmax attention with GQA.

:func:`attention_plain` is what the wrapper runs for CPU tensors and what
``chip_smoke.py`` holds K6 to on the card.  It keeps the Pallas kernel's
precision (scores, softmax and the PV product in float32; p rounded to
v's dtype before the product; the output in q's dtype) and its masks:
keys at index ``>= kv_len`` are masked, and ``causal`` keeps the keys
with ``q_pos >= k_pos``, positions counted from 0 on both sides
(``q_start`` shifts the queries: ``q`` holds rows ``q_start, q_start +
1, ...`` of the full query sequence).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_plain"]

NEG_INF = -1.0e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, kv_len: Optional[int] = None,
                    q_start: int = 0) -> torch.Tensor:
    """q ``[B, Hq, Sq, Dh]``, k / v ``[B, Hkv, Sk, Dh]`` -> ``[B, Hq, Sq,
    Dh]``; materialises the ``[B, Hq, Sq, Sk]`` float32 scores."""
    _, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(dh))
    kpos = torch.arange(sk, device=q.device)
    keep = kpos < (sk if kv_len is None else kv_len)
    if causal:
        qpos = q_start + torch.arange(sq, device=q.device)
        keep = keep & (qpos[:, None] >= kpos[None, :])
    s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
