"""Public FM interaction ops: K4 on the card, its plain version on the CPU.

:func:`fm_interaction` is serving's op (no gradient);
:func:`fm_interaction_train` is the same forward as a
``torch.autograd.Function`` whose backward is K4's
(:func:`~repro_torch.kernels.fm.kernel.fm_interaction_bwd_kernel`), for
training.
"""
from __future__ import annotations

import torch

from .kernel import fm_interaction_bwd_kernel, fm_interaction_kernel
from .ref import fm_interaction_bwd_ref, fm_interaction_ref

__all__ = ["fm_interaction", "fm_interaction_train"]


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """FM pairwise term of ``v [B, F, D]`` (field embeddings already scaled
    by the feature values); returns ``[B]`` for any ``B``."""
    return fm_interaction_kernel(v.contiguous())


class _Interaction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, plain):
        ctx.save_for_backward(v)
        ctx.plain = plain
        return fm_interaction_ref(v) if plain else fm_interaction_kernel(v)

    @staticmethod
    def backward(ctx, dy):
        (v,) = ctx.saved_tensors
        bwd = fm_interaction_bwd_ref if ctx.plain else (
            fm_interaction_bwd_kernel)
        return bwd(v, dy.contiguous()), None


def fm_interaction_train(v: torch.Tensor, *,
                         plain: bool = False) -> torch.Tensor:
    """:func:`fm_interaction` with its gradient: K4 and K4's backward (on
    the CPU their plain versions), or with ``plain`` the plain versions
    on any device."""
    return _Interaction.apply(v.contiguous(), plain)
