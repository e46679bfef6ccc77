"""Deterministic synthetic batches for the port's substrates (numpy).

The port's own copy of ``repro.data.pipeline``'s LM, recsys and
full-graph GNN generators: the same arguments give the same arrays byte
for byte, so the parity tests can feed both packages one batch.

* LM: Zipf tokens, labels the next token.
* RecSys: criteo-like power-law categorical ids + click labels.
* GNN: the full-graph batch of a :class:`~repro_torch.core.CSRGraph`,
  and its padding to a cell's static node / edge counts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.graph import CSRGraph

__all__ = ["lm_token_batch", "criteo_like_batch", "make_gnn_batch",
           "pad_gnn_batch"]


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
    *,
    d_out: int = 1,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Full-graph batch with features/labels (the graph itself is the
    batch).  Edges come in the graph's source-major order.  The
    coordinates and triplets of EGNN / DimeNet wait with those archs
    (ROADMAP)."""
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
    return batch


def pad_gnn_batch(batch: Dict[str, np.ndarray], n: int,
                  e: int) -> Dict[str, np.ndarray]:
    """Pad a node batch to ``n`` nodes and ``e`` edges; masks carry validity.

    Padding nodes are zero rows; padding edge ``i`` is the self loop
    ``i mod n_real`` with ``edge_mask`` 0, spread over the real nodes so
    that no one destination collects the padding.
    """
    n_real, e_real = batch["x"].shape[0], batch["src"].shape[0]
    if n < n_real or e < e_real:
        raise ValueError(f"cannot pad {n_real} nodes / {e_real} edges to "
                         f"{n} / {e}")
    loops = (np.arange(e - e_real) % n_real).astype(np.int32)
    out = {}
    for key, val in batch.items():
        if key in ("src", "dst"):
            out[key] = np.concatenate([val, loops])
        elif key == "edge_mask":
            out[key] = np.concatenate([val, np.zeros(e - e_real, val.dtype)])
        elif val.shape[:1] == (n_real,):
            pad = np.zeros((n - n_real,) + val.shape[1:], val.dtype)
            out[key] = np.concatenate([val, pad])
        else:
            raise ValueError(f"{key}: neither a node nor an edge array")
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
