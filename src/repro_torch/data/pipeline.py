"""Deterministic synthetic batches for the port's substrates (numpy).

The port's own copy of ``repro.data.pipeline``'s LM, recsys and
full-graph GNN generators: the same arguments give the same arrays byte
for byte, so the parity tests can feed both packages one batch.

* LM: Zipf tokens, labels the next token.
* RecSys: criteo-like power-law categorical ids + click labels.
* GNN: the full-graph batch of a :class:`~repro_torch.core.CSRGraph`
  (with EGNN's / DimeNet's coordinates and DimeNet's triplets,
  :func:`build_triplets`), its padding to a cell's static node / edge /
  triplet counts, and batched small graphs (:func:`molecule_batch`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.graph import CSRGraph

__all__ = ["lm_token_batch", "criteo_like_batch", "make_gnn_batch",
           "pad_gnn_batch", "molecule_batch", "build_triplets"]


def lm_token_batch(step: int, batch: int, seq: int, vocab: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """Zipf tokens; labels = next token (teacher forcing)."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    toks = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_gnn_batch(
    g: CSRGraph,
    d_feat: int,
    n_classes: int = 0,
    with_pos: bool = False,
    with_triplets: bool = False,
    max_trip_per_edge: int = 8,
    d_out: int = 1,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Full-graph batch with features/labels (the graph itself is the
    batch).  Edges come in the graph's source-major order; ``with_pos``
    adds coordinates and atom types (EGNN / DimeNet), ``with_triplets``
    DimeNet's triplets (:func:`build_triplets`, at most
    ``max_trip_per_edge`` a directed edge)."""
    rng = np.random.default_rng(seed)
    src, dst, _ = g.edge_list()
    batch = {
        "x": rng.standard_normal((g.n, d_feat)).astype(np.float32),
        "src": src.astype(np.int32),
        "dst": dst.astype(np.int32),
        "node_mask": np.ones(g.n, np.float32),
        "edge_mask": np.ones(src.shape[0], np.float32),
    }
    if n_classes:
        batch["labels"] = rng.integers(0, n_classes, g.n).astype(np.int32)
    else:
        batch["labels"] = rng.standard_normal((g.n, d_out)).astype(np.float32)
    if with_pos:
        batch["pos"] = rng.standard_normal((g.n, 3)).astype(np.float32)
        batch["z"] = rng.integers(0, 10, g.n).astype(np.int32)
    if with_triplets:
        te, tf = build_triplets(src, dst, g.n, max_trip_per_edge, seed)
        batch["trip_e"], batch["trip_f"] = te, tf
        batch["trip_mask"] = np.ones(te.shape[0], np.float32)
    return batch


def build_triplets(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   max_per_edge: int = 8, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """DimeNet triplets: for edge e=(j->i), incoming edges f=(k->j), k != i.

    Capped at ``max_per_edge`` incoming edges per target edge (a random
    choice of them past the cap).  Returns (trip_e, trip_f).
    """
    rng = np.random.default_rng(seed)
    e_count = src.shape[0]
    # incoming edge ids per node (f = (k -> j) indexed by dst == j)
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    starts = np.searchsorted(sorted_dst, np.arange(n_nodes))
    ends = np.searchsorted(sorted_dst, np.arange(n_nodes) + 1)
    trip_e, trip_f = [], []
    for e in range(e_count):
        j = src[e]
        lo, hi = starts[j], ends[j]
        if hi <= lo:
            continue
        incoming = order[lo:hi]
        incoming = incoming[src[incoming] != dst[e]]  # k != i
        if incoming.size > max_per_edge:
            incoming = rng.choice(incoming, max_per_edge, replace=False)
        trip_e.extend([e] * incoming.size)
        trip_f.extend(incoming.tolist())
    if not trip_e:
        trip_e, trip_f = [0], [0]
    return (np.asarray(trip_e, np.int32), np.asarray(trip_f, np.int32))


def molecule_batch(
    n_graphs: int,
    nodes_per_graph: int = 30,
    edges_per_graph: int = 64,
    d_feat: int = 16,
    with_triplets: bool = False,
    graph_labels: bool = True,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Batched small graphs (molecule shape): block-diagonal edge list,
    ``graph_ids`` per node, and a label per graph (``graph_labels``) or a
    ``[N, 1]`` one per node."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per_graph
    e = n_graphs * edges_per_graph
    src = np.concatenate([
        rng.integers(0, nodes_per_graph, edges_per_graph) + i * nodes_per_graph
        for i in range(n_graphs)
    ]).astype(np.int32)
    dst = np.concatenate([
        rng.integers(0, nodes_per_graph, edges_per_graph) + i * nodes_per_graph
        for i in range(n_graphs)
    ]).astype(np.int32)
    batch = {
        "x": rng.standard_normal((n, d_feat)).astype(np.float32),
        "pos": (rng.standard_normal((n, 3)) * 2.0).astype(np.float32),
        "z": rng.integers(0, 10, n).astype(np.int32),
        "src": src,
        "dst": dst,
        "node_mask": np.ones(n, np.float32),
        "edge_mask": np.ones(e, np.float32),
        "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32),
                               nodes_per_graph),
        "labels": rng.standard_normal(n_graphs).astype(np.float32)
        if graph_labels else rng.standard_normal((n, 1)).astype(np.float32),
    }
    if with_triplets:
        te, tf = build_triplets(src, dst, n, 8, seed)
        batch["trip_e"], batch["trip_f"] = te, tf
        batch["trip_mask"] = np.ones(te.shape[0], np.float32)
    return batch


def pad_gnn_batch(batch: Dict[str, np.ndarray], n: int, e: int,
                  t: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad a node batch to ``n`` nodes, ``e`` edges and (with ``t``) ``t``
    triplets; masks carry validity.

    Padding nodes are zero rows; padding edge ``i`` is the self loop
    ``i mod n_real`` with ``edge_mask`` 0, spread over the real nodes so
    that no one destination collects the padding; padding triplet ``i``
    pairs real edge ``i mod e_real`` with itself, ``trip_mask`` 0, spread
    over the real edges the same way.  A graph task's per-graph labels
    stay as they are; a mask the batch lacks starts as ones.
    """
    n_real, e_real = batch["x"].shape[0], batch["src"].shape[0]
    t_real = batch["trip_e"].shape[0] if "trip_e" in batch else 0
    masks = {"node_mask": n_real, "edge_mask": e_real}
    if "trip_e" in batch:
        masks["trip_mask"] = t_real
    batch = {**{k: np.ones(m, np.float32) for k, m in masks.items()},
             **batch}
    if n < n_real or e < e_real or (t is not None and t < t_real):
        raise ValueError(f"cannot pad {n_real} nodes / {e_real} edges / "
                         f"{t_real} triplets to {n} / {e} / {t}")
    loops = (np.arange(e - e_real) % n_real).astype(np.int32)
    t_pad = 0 if t is None else t - t_real
    pairs = (np.arange(t_pad) % max(e_real, 1)).astype(np.int32)
    out = {}
    for key, val in batch.items():
        if key in ("src", "dst"):
            out[key] = np.concatenate([val, loops])
        elif key in ("edge_mask", "edge_attr"):
            pad = np.zeros((e - e_real,) + val.shape[1:], val.dtype)
            out[key] = np.concatenate([val, pad])
        elif key in ("trip_e", "trip_f"):
            out[key] = np.concatenate([val, pairs.astype(val.dtype)])
        elif key == "trip_mask":
            out[key] = np.concatenate([val, np.zeros(t_pad, val.dtype)])
        elif val.shape[:1] == (n_real,):
            pad = np.zeros((n - n_real,) + val.shape[1:], val.dtype)
            out[key] = np.concatenate([val, pad])
        elif key == "labels" and "graph_ids" in batch:
            out[key] = val
        else:
            raise ValueError(f"{key}: neither a node, an edge nor a "
                             "triplet array")
    return out


def criteo_like_batch(step: int, batch: int, n_fields: int,
                      vocab_per_field: int, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """Power-law categorical ids (hot head, long tail) + click labels."""
    rng = np.random.default_rng(seed * 7_777_777 + step)
    ids = (rng.zipf(1.2, size=(batch, n_fields)) - 1) % vocab_per_field
    ctr_logit = (ids[:, 0] % 17 - 8) / 4.0
    labels = (rng.random(batch) < 1 / (1 + np.exp(-ctr_logit))).astype(
        np.int32
    )
    return {"ids": ids.astype(np.int32), "labels": labels}
