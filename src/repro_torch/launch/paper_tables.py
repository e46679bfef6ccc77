"""Paper Tables 1/2/3: computation cost vs K under three node orderings,
on the port's simulator (the counterpart of the reference's
``benchmarks/paper_tables.py``).

Protocol (§3.1): synthetic power-law graph (α = 1.5), N = 1000, target
error 1/N, PageRank system (damping 0.85, ε = 0.15); K ∈ {1, 2, 4, 8, 16}
× {Uniform, CB} × {static, dynamic}, the paper-exact sequential schedule;
node order random (Table 1), by out-degree (Table 2), by in-degree
(Table 3).  The graph is regenerated from its seed (the paper's exact
instance is not published), so absolute costs differ from the paper's
single draw.

  PYTHONPATH=src python -m repro_torch.launch.paper_tables            # card
  PYTHONPATH=src python -m repro_torch.launch.paper_tables --device cpu --quick

Writes ``table1.csv`` … ``table3.csv`` under ``--out`` (default
``build/paper_tables/`` at the repository root) and prints one line per
run.  ``--quick`` runs K ∈ {1, 4} only.
"""
from __future__ import annotations

import argparse
import csv
import os
import pathlib
import time
from typing import Dict, Tuple

import numpy as np

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
           / "paper_tables")
KS = (1, 2, 4, 8, 16)
ORDERS = (("random", "table1"), ("out_degree", "table2"),
          ("in_degree", "table3"))


def ordered_system(order: str, n: int = 1000, seed: int = 0):
    """The protocol's PageRank system ``(P, B)`` on
    ``power_law_graph(n, alpha=1.5)`` with its nodes in ``order``
    (``random``: as generated; ``out_degree`` / ``in_degree``: by
    decreasing degree, stable)."""
    from repro_torch.core import pagerank_system, power_law_graph

    g = power_law_graph(n, alpha=1.5, seed=seed)
    if order == "out_degree":
        g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    elif order == "in_degree":
        g = g.reorder(np.argsort(-g.in_degree(), kind="stable"))
    elif order != "random":
        raise ValueError(f"unknown node order {order!r}")
    return pagerank_system(g, damping=0.85)


def run_table(order: str, n: int = 1000, seed: int = 0,
              mode: str = "sequential", ks=KS, device: str = "cuda",
              verbose: bool = True) -> Dict[Tuple, float]:
    """``{(K, partition, dynamic): cost_iterations}`` for one node order."""
    from repro_torch.core import DistributedSimulator, SimulatorConfig

    p, b = ordered_system(order, n, seed)
    out = {}
    for k in ks:
        for part in ("uniform", "cb"):
            for dyn in (False, True):
                cfg = SimulatorConfig(
                    k=k, target_error=1.0 / n, eps=0.15, partition=part,
                    dynamic=dyn, mode=mode, record_every=100, device=device,
                )
                t0 = time.perf_counter()
                res = DistributedSimulator(p, b, cfg).run()
                out[(k, part, dyn)] = res.cost_iterations
                if verbose:
                    print(f"  order={order} K={k} {part} "
                          f"{'dyn' if dyn else 'sta'}: "
                          f"{res.cost_iterations:.2f} "
                          f"({time.perf_counter() - t0:.1f}s, "
                          f"conv={res.converged})")
    return out


def write_csv(table: Dict, path) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["K", "unif_static", "unif_dynamic", "cb_static",
                    "cb_dynamic"])
        for k in sorted({key[0] for key in table}):
            w.writerow([
                k,
                f"{table[(k, 'uniform', False)]:.3f}",
                f"{table[(k, 'uniform', True)]:.3f}",
                f"{table[(k, 'cb', False)]:.3f}",
                f"{table[(k, 'cb', True)]:.3f}",
            ])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="K in {1, 4} only")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the simulator (cuda | cpu)")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the CSV files")
    args = ap.parse_args(argv)
    tables = {}
    for order, name in ORDERS:
        print(f"[{name}] node order: {order}")
        t = run_table(order, ks=(1, 4) if args.quick else KS,
                      device=args.device)
        write_csv(t, os.path.join(args.out, f"{name}.csv"))
        tables[name] = t
    return tables


if __name__ == "__main__":
    main()
