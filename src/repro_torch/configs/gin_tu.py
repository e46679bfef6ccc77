"""gin-tu [gnn] — 5 layers, d_hidden=64, sum aggregator, learnable eps
(``GIN.eps``, one per layer).  [arXiv:1810.00826; paper]

The locality-partitioned halo cell (``ogb_products_halo``) waits for the
port of ``parallel/`` (ROADMAP).
"""
import dataclasses

from ..models.gnn import GNNConfig
from .gnn_common import shape_overrides

ARCH_ID = "gin-tu"


def model_cfg() -> GNNConfig:
    return GNNConfig(
        name=ARCH_ID,
        arch="gin",
        n_layers=5,
        d_hidden=64,
        d_feat=1433,  # per-shape override
        n_classes=7,
    )


def cfg_for(shape: str) -> GNNConfig:
    """``model_cfg()`` with one shape's overrides (``SHAPE_DIMS`` key)."""
    return dataclasses.replace(model_cfg(), **shape_overrides(shape))
