"""Shared GNN shapes (the four assigned shapes of every GNN arch).

  full_graph_sm   N=2,708  E=10,556  d_feat=1,433   (cora-scale full batch)
  minibatch_lg    reddit-scale sampled training (padded fanout-(15,10)
                  subgraph: 169,984 node / 168,960 edge budget)
  ogb_products    N=2,449,029  E=61,859,140  d_feat=100 (full-batch-large)
  molecule        128 graphs x (30 nodes, 64 edges), batched block-diagonal

``n``/``e`` are PADDED (nodes % 32 == 0, edges % 512 == 0; masks carry
validity); the real sizes are kept in ``n_real``/``e_real``.  DimeNet's
triplets are capped at 8 incoming edges per directed edge, so a cell's
``T = 8·E`` (``trip_mask`` carries validity).  :func:`gnn_cells` gives a
GNN config its four train cells.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import ShapeCell

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


TRIP_PER_EDGE = 8


def gnn_cells(arch: str, base_cfg) -> Dict[str, ShapeCell]:
    """The reference's four train cells of one GNN arch: the padded full
    batch's inputs (``pos`` for MeshGraphNet, EGNN and DimeNet; ``z`` and
    the triplets for DimeNet), the shape's overrides, its sizes in
    ``meta`` (DimeNet's also ``n_triplets``)."""
    f32, i32 = torch.float32, torch.int32
    needs_pos = arch in ("egnn", "dimenet", "meshgraphnet")
    needs_trip = arch == "dimenet"
    cells = {}
    for name, dims in SHAPE_DIMS.items():
        n, e, graphs = dims["n"], dims["e"], dims.get("graphs")
        t = e * TRIP_PER_EDGE
        inputs = {"x": ((n, dims["d_feat"]), f32), "src": ((e,), i32),
                  "dst": ((e,), i32), "node_mask": ((n,), f32),
                  "edge_mask": ((e,), f32)}
        if needs_pos:
            inputs["pos"] = ((n, 3), f32)
        if needs_trip:
            inputs |= {"z": ((n,), i32), "trip_e": ((t,), i32),
                       "trip_f": ((t,), i32), "trip_mask": ((t,), f32)}
        if graphs:
            inputs |= {"graph_ids": ((n,), i32), "labels": ((graphs,), f32)}
        elif dims["classes"]:
            inputs["labels"] = ((n,), i32)
        else:
            inputs["labels"] = ((n, base_cfg.d_out), f32)
        cells[name] = ShapeCell(
            name=name, kind="train", inputs=inputs,
            overrides=shape_overrides(name),
            meta={"n_nodes": n, "n_edges": e, "n_real": dims["n_real"],
                  "e_real": dims["e_real"],
                  **({"n_triplets": t} if needs_trip else {})})
    return cells
