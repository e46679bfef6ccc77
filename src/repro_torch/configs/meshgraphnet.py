"""meshgraphnet [gnn] — 15 message-passing layers, d_hidden=128, sum
aggregator, 2-layer MLPs, layer-normed; edge features the relative
position and its length (``d_edge`` 4).  [arXiv:2010.03409; unverified]

``spec()`` holds the four train cells of ``gnn_common`` (with ``pos``).
Its decoder is ``d_out`` (2) wide, so the classification cells'
labels (7, 41 and 47 classes) read past it and the loss is NaN, as the
reference's; their forwards are defined.
"""
import dataclasses

from ..models.gnn import GNNConfig
from .common import ArchSpec
from .gnn_common import gnn_cells, shape_overrides

ARCH_ID = "meshgraphnet"


def model_cfg() -> GNNConfig:
    return GNNConfig(
        name=ARCH_ID,
        arch="meshgraphnet",
        n_layers=15,
        d_hidden=128,
        d_feat=1433,  # per-shape override
        d_edge=4,  # rel-pos + distance
        d_out=2,
    )


def cfg_for(shape: str) -> GNNConfig:
    """``model_cfg()`` with one shape's overrides (``SHAPE_DIMS`` key)."""
    return dataclasses.replace(model_cfg(), **shape_overrides(shape))


def spec() -> ArchSpec:
    cfg = model_cfg()
    return ArchSpec(arch_id=ARCH_ID, family="gnn", model_cfg=cfg,
                    cells=gnn_cells("meshgraphnet", cfg),
                    source="arXiv:2010.03409; unverified")
