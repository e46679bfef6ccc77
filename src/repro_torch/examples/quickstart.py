"""Quickstart: solve PageRank with the D-iteration, three ways.

The three tiers of the architecture are three ``method=`` strings on the
same :func:`repro_torch.solve` front door:

1. ``sequential``  — reference solver (paper §2.1 pseudo-code).
2. ``simulator``   — faithful K-PID simulator with the dynamic
                     partition (§2.2–2.5).
3. ``engine:chunk``— the distributed engine, one PID a card (its K PIDs
                     share one device; 1 on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--n 2000]
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import jacobi_solve, power_law_graph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    n = args.n
    print(f"generating power-law graph (alpha=1.5), N={n} ...")
    g = power_law_graph(n, alpha=1.5, seed=0)
    problem = repro_torch.Problem.pagerank(g, damping=0.85,
                                           target_error=1.0 / n)
    dangling = int(g.dangling_mask().sum())
    print(f"  L = {g.n_edges} links, {dangling} dangling")

    # --- 1. reference solver -----------------------------------------------
    ref = repro_torch.solve(problem, method="sequential", device=dev)
    print(f"[sequential]  cost = {ref.cost_iterations:.2f} "
          f"matvec-equivalents, |F| = {ref.residual:.2e}")
    _x_jac, iters = jacobi_solve(problem.p, problem.b, target_error=1.0 / n,
                                 eps=0.15)
    print(f"[jacobi]      cost = {iters} matvecs  "
          f"(D-iteration is {iters / ref.cost_iterations:.1f}x cheaper)")

    # --- 2. K-PID simulator with dynamic partition --------------------------
    sim = repro_torch.solve(problem, method="simulator", k=8, dynamic=True,
                            mode="sequential", record_every=50, device=dev)
    sim_err = float(np.abs(sim.x - ref.x).max())
    print(f"[simulator]   K=8 dynamic: cost = {sim.cost_iterations:.2f}, "
          f"moves = {len(sim.move_log)}, "
          f"exchanges = {sim.extras['n_exchanges']}, "
          f"max|Δx| vs sequential = {sim_err:.2e}")

    # --- 3. the engine: one PID a card -------------------------------------
    k = torch.cuda.device_count() if torch.device(dev).type == "cuda" else 1
    eng = repro_torch.solve(problem, method="engine:chunk", k=k,
                            dynamic=k > 1, device=dev)
    eng_err = float(np.abs(eng.x - ref.x).max())
    print(f"[engine]      K={k} devices: converged={eng.converged} "
          f"rounds={eng.n_rounds} max|Δx| = {eng_err:.2e}")

    top = np.argsort(-ref.x)[:5].tolist()
    print("top-5 PageRank nodes:", top)
    return {
        "n": n, "links": int(g.n_edges), "dangling": dangling,
        "sequential": {"cost": ref.cost_iterations,
                       "residual": ref.residual,
                       "converged": ref.converged},
        "jacobi_iters": int(iters),
        "simulator": {"cost": sim.cost_iterations,
                      "moves": len(sim.move_log),
                      "exchanges": int(sim.extras["n_exchanges"]),
                      "converged": sim.converged,
                      "max_abs_dx": sim_err},
        "engine": {"k": k, "converged": eng.converged,
                   "rounds": eng.n_rounds, "max_abs_dx": eng_err},
        "top5": top,
    }


if __name__ == "__main__":
    main()
