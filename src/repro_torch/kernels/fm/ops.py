"""Public FM interaction op: K4 on the card, its plain version on the CPU."""
from __future__ import annotations

import torch

from .kernel import fm_interaction_kernel

__all__ = ["fm_interaction"]


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """FM pairwise term of ``v [B, F, D]`` (field embeddings already scaled
    by the feature values); returns ``[B]`` for any ``B``."""
    return fm_interaction_kernel(v.contiguous())
