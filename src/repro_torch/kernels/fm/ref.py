"""Plain torch versions of the FM pairwise interaction (K4's contract)."""
from __future__ import annotations

import torch

__all__ = ["fm_interaction_ref", "fm_interaction_naive"]


def fm_interaction_ref(v: torch.Tensor) -> torch.Tensor:
    """Sum-square trick, ``[B, F, D] -> [B]``."""
    s1 = v.sum(dim=1)
    s2 = (v * v).sum(dim=1)
    return 0.5 * (s1 * s1 - s2).sum(dim=-1)


def fm_interaction_naive(v: torch.Tensor) -> torch.Tensor:
    """O(F²) literal pairwise sum — the definition, for tiny tests."""
    inter = torch.einsum("bfd,bgd->bfg", v, v)
    f = v.shape[1]
    mask = torch.triu(torch.ones((f, f), dtype=torch.bool, device=v.device),
                      diagonal=1)
    return (inter * mask[None]).sum(dim=(1, 2))
