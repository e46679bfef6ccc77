"""The paper's technique applied beyond the solver: the dynamic partition
controller as a load balancer for skewed GNN edge shards.

A power-law graph is bucketised into edge shards; shard costs are wildly
imbalanced (degree skew).  The slope controller — fed only the observed
per-shard work, exactly as it is fed per-PID residuals in the paper —
rebalances buckets until the max/mean shard cost ratio collapses.  A GIN
model then trains a few steps on the graph to show the surrounding
pipeline (its aggregations on K5 on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.gnn_partition
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import power_law_graph
from repro_torch.core.partition import (
    DynamicController,
    DynamicControllerConfig,
    apply_move,
    uniform_partition,
)
from repro_torch.data import make_gnn_batch
from repro_torch.models import gnn
from repro_torch.optim import clip_by_global_norm

K = 8


def skewed_graph():
    """power_law_graph(4000, seed=3) ordered by out-degree: an
    adversarially skewed uniform partition."""
    g = power_law_graph(4000, seed=3)
    order = np.argsort(-g.out_degree(), kind="stable")
    return g.reorder(order)


def balance(g, steps: int = 60, verbose: bool = True):
    """The slope controller over the edge shards' costs for ``steps``
    steps; returns ``(moves [(src, dst, n_move)], max/mean at each
    printed step, the final max/mean)``."""
    deg = np.maximum(g.out_degree(), 1)
    sets = uniform_partition(g.n, K)
    ctl = DynamicController(
        DynamicControllerConfig(k=K, target_error=1e-6, z=3))
    moves, shown = [], []
    for step in range(steps):
        costs = np.array([deg[s.numpy()].sum() for s in sets],
                         dtype=np.float64)
        imb = costs.max() / costs.mean()
        if step % 10 == 0:
            shown.append(float(imb))
            if verbose:
                print(f"  step {step:3d}: shard costs max/mean = {imb:.2f} "
                      f"(sizes {[int(s.numel()) for s in sets]})")
        move = ctl.update(costs, np.array([s.numel() for s in sets]))
        if move is not None:
            moves.append((move.src, move.dst, move.n_move))
            sets, _ = apply_move(sets, move)
    costs = np.array([deg[s.numpy()].sum() for s in sets], dtype=np.float64)
    return moves, shown, float(costs.max() / costs.mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.gnn_partition")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = skewed_graph()
    print("balancing edge shards with the paper's slope controller:")
    moves, shown, final = balance(g)
    print(f"  final:     shard costs max/mean = {final:.2f}")

    print("\ntraining GIN on the balanced graph:")
    cfg = gnn.GNNConfig(name="demo", arch="gin", n_layers=3, d_hidden=32,
                        d_feat=16, n_classes=5)
    batch = gnn.prepare_batch(make_gnn_batch(g, d_feat=16, n_classes=5),
                              dev)
    model = gnn.init_params(cfg, seed=0, device=dev)
    params = [p for _, p in model.named_parameters()]
    for p in params:
        p.requires_grad_(True)
    losses = []
    for i in range(10):
        loss = gnn.loss_fn(model, batch)
        grads, _ = clip_by_global_norm(
            list(torch.autograd.grad(loss, params)), 1.0)
        with torch.no_grad():
            for p, g_ in zip(params, grads):
                p.sub_(1e-3 * g_)
        losses.append(float(loss.detach()))
        if i % 3 == 0:
            print(f"  step {i}: loss = {losses[-1]:.4f}")
    print("done.")
    return {"moves": moves, "imbalance": shown, "final_imbalance": final,
            "losses": losses}


if __name__ == "__main__":
    main()
