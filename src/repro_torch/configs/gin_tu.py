"""gin-tu [gnn] — 5 layers, d_hidden=64, sum aggregator, learnable eps
(``GIN.eps``, one per layer).  [arXiv:1810.00826; paper]

``spec()`` holds the four train cells of ``gnn_common``.  The
locality-partitioned halo cell (``ogb_products_halo``) waits for the
port of ``parallel/`` (ROADMAP §1, item 7 (d)).
"""
import dataclasses

from ..models.gnn import GNNConfig
from .common import ArchSpec
from .gnn_common import gnn_cells, shape_overrides

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


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="gnn", model_cfg=cfg,
                    cells=gnn_cells(cfg), source="arXiv:1810.00826; paper")
