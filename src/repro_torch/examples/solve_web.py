"""End-to-end driver (the paper's kind): distributed PageRank on a web-scale
stand-in graph with the dynamic partition strategy.

The paper's headline experiment shape through the ``repro_torch.solve``
front door: a web graph (uk-2007-05 stand-in, Table 4-matched), K PIDs on
the ``simulator`` backend, uniform start, dynamic rebalancing; then the
speed-up vs K=1 (the paper's ``steps·PID_Speed/L`` wall-clock metric, kept
in ``report.extras["cost_steps_iterations"]``) and the partition
evolution.

Run:  PYTHONPATH=src python -m repro_torch.examples.solve_web [--n 50000]
      [--k 16] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import repro_torch
from repro_torch.core import webgraph_like


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.solve_web")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"building web-like graph N={args.n} (uk-2007-05 stand-in) ...")
    g = webgraph_like(args.n, seed=1)
    problem = repro_torch.Problem.pagerank(g, target_error=1.0 / g.n)
    print(f"  L = {g.n_edges} (L/N = {g.n_edges / g.n:.1f})")

    opts = dict(mode="batch", record_every=100, device=args.device)
    out = {"n": g.n, "links": int(g.n_edges)}

    t0 = time.time()
    base = repro_torch.solve(problem, method="simulator", k=1, **opts)
    base_cost = base.extras["cost_steps_iterations"]
    print(f"[K=1 ]  cost = {base_cost:.2f}  ({time.time() - t0:.1f}s wall)")
    out["base"] = {"cost": base_cost, "converged": base.converged}

    for dyn in (False, True):
        t0 = time.time()
        res = repro_torch.solve(problem, method="simulator", k=args.k,
                                dynamic=dyn, **opts)
        cost = res.extras["cost_steps_iterations"]
        wall = time.time() - t0
        tag = "dyn " if dyn else "stat"
        print(f"[K={args.k} {tag}] cost = {cost:.2f}  "
              f"speedup = {base_cost / cost:.2f}x  "
              f"moves = {len(res.move_log)}  ({wall:.1f}s wall)")
        row = {"cost": cost, "speedup": base_cost / cost,
               "moves": len(res.move_log), "converged": res.converged,
               "wall_s": wall}
        sizes = res.extras["hist_sizes"]
        if dyn and sizes.size:
            print(f"  partition sizes: start={sizes[0].tolist()[:8]} "
                  f"-> end={sizes[-1].tolist()[:8]}")
            row["sizes"] = (sizes[0].tolist(), sizes[-1].tolist())
        out["dynamic" if dyn else "static"] = row
    return out


if __name__ == "__main__":
    main()
