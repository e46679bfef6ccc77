"""Plain torch version of K6's contract: exact softmax attention with GQA.

:func:`attention_plain` is what the wrapper runs for CPU tensors and what
``chip_smoke.py`` holds K6 to on the card.  It keeps the Pallas kernel's
precision (scores, softmax and the PV product in float32; p rounded to
v's dtype before the product; the output in q's dtype) and its masks:
keys at index ``>= kv_len`` are masked, and ``causal`` keeps the keys
with ``q_pos >= k_pos``, positions counted from 0 on both sides
(``q_start`` shifts the queries: ``q`` holds rows ``q_start, q_start +
1, ...`` of the full query sequence).  With ``lse`` it also returns
each query row's logsumexp in base 2 of the scores times ``scale ·
log2(e)``, the ``L`` that K6's training forward writes for its backward.
Over an int8 K/V cache (with
``k_scale`` / ``v_scale``, one float32 scale a (row, head, token)) it
dequantises first, as the reference's int8 decode step does: ``(k ·
k_scale)`` in float32, rounded to q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_plain", "attention_bwd_plain", "dequantize"]

NEG_INF = -1.0e30
LOG2E = 1.4426950408889634


def dequantize(x: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """int8 ``x [..., Dh]`` times its float32 ``scale [...]``, in float32,
    then rounded to ``dtype``."""
    return (x.float() * scale[..., None]).to(dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, kv_len: Optional[int] = None,
                    q_start: int = 0, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None, lse: bool = False):
    """q ``[B, Hq, Sq, Dh]``, k / v ``[B, Hkv, Sk, Dh]`` -> ``[B, Hq, Sq,
    Dh]``; materialises the ``[B, Hq, Sq, Sk]`` float32 scores.  k / v
    int8 with their scales ``[B, Hkv, Sk]`` are dequantised first.  With
    ``lse``, returns ``(o, L)``, L float32 ``[B, Hq, Sq]``:
    ``log2(sum_j exp(s_ij))``, s the scaled scores over the kept keys."""
    if k_scale is not None:
        k, v = dequantize(k, k_scale, q.dtype), dequantize(v, v_scale,
                                                           q.dtype)
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
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if lse:
        return o, torch.logsumexp(s, dim=-1) * LOG2E
    return o


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool):
    """The gradients ``(dq, dk, dv)`` of ``o = attention_plain(q, k, v,
    causal=causal)`` for ``do = dL/do`` (q, o, do ``[B, Hq, Sq, Dh]``, k,
    v ``[B, Hkv, Sk, Dh]``), in float32 and cast to the inputs' dtypes:
    ``L = logsumexp(s)``, ``P = exp(s - L)``, ``D = rowsum(do · o)``,
    ``dv = Pᵀ do``, ``dS = P · (do vᵀ - D)``, ``dq = dS k · scale``,
    ``dk = dSᵀ q · scale``, dk and dv of a kv head summed over its group's
    q heads.  ``o`` is the forward's output as it was returned."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
              - (dof * of).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale

    def per_kv_head(t):
        return t.reshape(b, hkv, group, sk, dh).sum(2)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
