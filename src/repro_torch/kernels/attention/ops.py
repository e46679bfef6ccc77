"""Public attention ops: K6 on the card, its plain version on the CPU.

:func:`flash_attention` is the forward (serving).
:func:`flash_attention_train` is the same forward with a gradient: a
``torch.autograd.Function`` whose backward is K6's backward kernel
(:func:`~repro_torch.kernels.attention.backward.flash_attention_bwd`; its
plain version on the CPU); where that backward runs its ``wgmma`` route,
the forward is the training forward
(:func:`~repro_torch.kernels.attention.kernel.flash_attention_lse`),
whose logsumexp is saved beside ``(q, k, v, o)`` for it (a recomputation
under remat writes it again).  :func:`attention_train_plain` is its plain
twin, the plain forward and the plain backward on any device, for
comparisons on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from .backward import bwd_route, flash_attention_bwd
from .kernel import flash_attention_kernel, flash_attention_lse
from .ref import attention_bwd_plain, attention_plain

__all__ = ["flash_attention", "flash_attention_train", "attention_train_plain"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_len: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention of q ``[B, Hq, Sq, Dh]`` over k / v ``[B, Hkv, Sk,
    Dh]`` (GQA: q head ``h`` reads kv head ``h // (Hq // Hkv)``), the
    reference's layout.  ``causal`` keeps keys at positions ``<=`` the
    query's (both counted from 0, the Pallas kernel's convention; the same
    as the bottom-right alignment of ``attention_ref`` when ``Sq == Sk``);
    ``kv_len`` masks the keys at index ``>= kv_len``.  Any ``Sq`` / ``Sk``:
    nothing is padded, so bidirectional attention over a ragged ``Sk`` is
    exact.  With ``k_scale`` / ``v_scale`` (float32 ``[B, Hkv, Sk]``)
    k / v are an int8 cache, one scale a (row, head, token): K6's int8
    decode form (``Sq <= 64``) dequantises each tile as it loads it.

    The result is ``[B, Hq, Sq, Dh]``, laid out in memory as ``[B, Sq, Hq,
    Dh]`` so that the model's ``transpose(1, 2)`` back to its own layout
    is contiguous.
    """
    b, hq, sq, dh = q.shape
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    return flash_attention_kernel(q, k, v, causal=causal, kv_len=kv_len,
                                  out=out, k_scale=k_scale, v_scale=v_scale)


class _Attention(torch.autograd.Function):
    """Causal / bidirectional GQA attention whose backward is K6's backward
    (``plain``: the plain versions of both)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, plain: bool):
        lse = None
        if plain:
            o = attention_plain(q, k, v, causal=causal)
        elif q.device.type == "cuda" and bwd_route(
                q.dtype, q.shape[3], q.shape[2]) == "wgmma":
            o, lse = flash_attention_lse(q, k, v, causal=causal)
        else:
            o = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.plain = causal, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.plain:
            dq, dk, dv = attention_bwd_plain(q, k, v, o, do,
                                             causal=ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do,
                                             causal=ctx.causal, lse=lse)
        return dq, dk, dv, None, None


def _train(q, k, v, causal, kv_len, plain):
    if kv_len is not None:
        raise ValueError("training attends over whole sequences (no kv_len)")
    return _Attention.apply(q, k, v, causal, plain)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention` (no ``kv_len``, no int8 cache) with K6's
    backward as its gradient."""
    return _train(q, k, v, causal, kv_len, False)


def attention_train_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_train` on the plain versions of K6's forward
    and backward, on any device."""
    return _train(q, k, v, causal, kv_len, True)
