"""Shared GNN shapes (the four assigned shapes of every GNN arch).

  full_graph_sm   N=2,708  E=10,556  d_feat=1,433   (cora-scale full batch)
  minibatch_lg    reddit-scale sampled training (padded fanout-(15,10)
                  subgraph: 169,984 node / 168,960 edge budget)
  ogb_products    N=2,449,029  E=61,859,140  d_feat=100 (full-batch-large)
  molecule        128 graphs x (30 nodes, 64 edges), batched block-diagonal

``n``/``e`` are PADDED (nodes % 32 == 0, edges % 512 == 0; masks carry
validity); the real sizes are kept in ``n_real``/``e_real``.
"""
from __future__ import annotations

from typing import Any, Dict

# (n_nodes, n_edges, d_feat, n_classes)
SHAPE_DIMS = {
    "full_graph_sm": dict(n=2720, e=10752, n_real=2708, e_real=10556,
                          d_feat=1433, classes=7),
    "minibatch_lg": dict(n=169_984, e=168_960, n_real=169_984,
                         e_real=168_960, d_feat=602, classes=41),
    "ogb_products": dict(n=2_449_056, e=61_859_328, n_real=2_449_029,
                         e_real=61_859_140, d_feat=100, classes=47),
    "molecule": dict(n=128 * 30, e=128 * 64, n_real=128 * 30,
                     e_real=128 * 64, d_feat=16, classes=0, graphs=128),
}


def shape_overrides(shape: str) -> Dict[str, Any]:
    """The model-config fields a shape sets: input width, classes, task."""
    dims = SHAPE_DIMS[shape]
    ov: Dict[str, Any] = {"d_feat": dims["d_feat"]}
    if dims.get("graphs"):
        return ov | {"n_classes": 0, "task": "graph", "d_out": 1}
    return ov | {"n_classes": dims["classes"], "task": "node"}
