"""dimenet [gnn] — 6 interaction blocks, d_hidden=128, n_bilinear=8,
n_spherical=7, n_radial=6, 16 atom types, cutoff 5; directional messages
with triplet aggregation, triplets capped at 8 per edge.
[arXiv:2003.03123; unverified]

``spec()`` holds the four train cells of ``gnn_common`` (with ``pos``,
``z`` and the triplets, ``T = 8·E``).  Its readout is ``d_out`` (1)
wide, so the classification cells' loss is NaN, as the reference's; only
``molecule`` trains.
"""
import dataclasses

from ..models.gnn import GNNConfig
from .common import ArchSpec
from .gnn_common import gnn_cells, shape_overrides

ARCH_ID = "dimenet"


def model_cfg() -> GNNConfig:
    return GNNConfig(
        name=ARCH_ID,
        arch="dimenet",
        n_layers=6,  # interaction blocks
        d_hidden=128,
        d_feat=16,  # per-shape override
        n_bilinear=8,
        n_spherical=7,
        n_radial=6,
        d_out=1,
        task="graph",
    )


def cfg_for(shape: str) -> GNNConfig:
    """``model_cfg()`` with one shape's overrides (``SHAPE_DIMS`` key)."""
    return dataclasses.replace(model_cfg(), **shape_overrides(shape))


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="gnn", model_cfg=cfg,
                    cells=gnn_cells("dimenet", cfg),
                    source="arXiv:2003.03123; unverified")
