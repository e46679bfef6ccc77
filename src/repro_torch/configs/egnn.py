"""egnn [gnn] — 4 layers, d_hidden=64, E(n)-equivariant coordinate
updates.  [arXiv:2102.09844; paper]

``spec()`` holds the four train cells of ``gnn_common`` (with ``pos``).
Its readout is ``d_out`` (1) wide, so the classification cells' loss is
NaN, as the reference's; only ``molecule`` trains.
"""
import dataclasses

from ..models.gnn import GNNConfig
from .common import ArchSpec
from .gnn_common import gnn_cells, shape_overrides

ARCH_ID = "egnn"


def model_cfg() -> GNNConfig:
    return GNNConfig(
        name=ARCH_ID,
        arch="egnn",
        n_layers=4,
        d_hidden=64,
        d_feat=1433,  # per-shape override
        d_out=1,
    )


def cfg_for(shape: str) -> GNNConfig:
    """``model_cfg()`` with one shape's overrides (``SHAPE_DIMS`` key)."""
    return dataclasses.replace(model_cfg(), **shape_overrides(shape))


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="gnn", model_cfg=cfg,
                    cells=gnn_cells("egnn", cfg),
                    source="arXiv:2102.09844; paper")
