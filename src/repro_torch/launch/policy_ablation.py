"""Policy ablation: static vs dynamic cost tables per rebalancing policy,
on the port's simulator (the counterpart of the reference's
``benchmarks/policy_ablation.py``).

The paper's static-vs-dynamic protocol (Tables 1–3, §3.1) for every
:mod:`repro_torch.balance` policy: synthetic power-law graph (α = 1.5),
PageRank system (damping 0.85, ε = 0.15), target error 1/N, K ∈ {2, 4, 8},
node order random or by out-degree, the sequential schedule.  For each
(K, order) cell the table reports the normalized cost
(``cost_iterations``) and the moves of:

  static          — no rebalancing (baseline)
  slope_ema       — paper §2.5.2 exact (through the control plane)
  cost_refresh    — periodic CB re-split from observed edge-op costs
  hysteresis      — slope-EMA + deadband + multi-move batching

  PYTHONPATH=src python -m repro_torch.launch.policy_ablation         # card
  PYTHONPATH=src python -m repro_torch.launch.policy_ablation --device cpu \\
      --quick

Writes ``policy_ablation_<order>.csv`` under ``--out`` (default
``build/paper_tables/`` at the repository root) and prints the tables.
``--quick`` runs N = 400 and K ∈ {2, 4}.
"""
from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Dict, Tuple

from .paper_tables import OUT_DIR, ordered_system

KS = (2, 4, 8)
POLICIES = (None, "slope_ema", "cost_refresh", "hysteresis")


def _cfg(k: int, n: int, policy, mode: str, device: str):
    from repro_torch.core import SimulatorConfig

    return SimulatorConfig(
        k=k, target_error=1.0 / n, eps=0.15, partition="uniform",
        policy=policy, dynamic=False, mode=mode, record_every=100,
        # cost_refresh balances observed work, not residual magnitude
        signal="edge-ops" if policy == "cost_refresh" else "residual",
        device=device,
    )


def run_ablation(order: str, n: int = 1000, seed: int = 0,
                 mode: str = "sequential", ks=KS, policies=POLICIES,
                 device: str = "cuda", verbose: bool = True
                 ) -> Dict[Tuple, dict]:
    """``{(K, policy or "static"): {cost, moves, converged, steps}}``."""
    from repro_torch.core import DistributedSimulator

    p, b = ordered_system(order, n, seed)
    out: Dict[Tuple, dict] = {}
    for k in ks:
        for policy in policies:
            t0 = time.perf_counter()
            res = DistributedSimulator(
                p, b, _cfg(k, n, policy, mode, device)).run()
            out[(k, policy or "static")] = {
                "cost": res.cost_iterations,
                "moves": res.n_moves,
                "converged": res.converged,
                "steps": res.n_steps,
            }
            if verbose:
                print(f"  order={order} K={k} {policy or 'static':>12}: "
                      f"cost={res.cost_iterations:8.2f} "
                      f"moves={res.n_moves:3d} "
                      f"({time.perf_counter() - t0:.1f}s, "
                      f"conv={res.converged})")
    return out


def write_csv(table: Dict[Tuple, dict], path,
              policies=POLICIES) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    names = [p or "static" for p in policies]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["K"] + [f"{nm}_{fld}" for nm in names
                            for fld in ("cost", "moves")])
        for k in sorted({key[0] for key in table}):
            row = [k]
            for nm in names:
                cell = table[(k, nm)]
                row += [f"{cell['cost']:.3f}", cell["moves"]]
            w.writerow(row)


def print_table(order: str, table: Dict[Tuple, dict],
                policies=POLICIES) -> None:
    names = [p or "static" for p in policies]
    print(f"\n[{order}] normalized cost (moves)")
    print("K   " + "".join(f"{nm:>22}" for nm in names))
    for k in sorted({key[0] for key in table}):
        cells = []
        for nm in names:
            c = table[(k, nm)]
            cells.append(f"{c['cost']:>15.2f} ({c['moves']:>3d})")
        print(f"{k:<4}" + "".join(cells))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="N = 400, K in {2, 4}")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the simulator (cuda | cpu)")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the CSV files")
    args = ap.parse_args(argv)
    ks = (2, 4) if args.quick else KS
    n = 400 if args.quick else 1000
    tables = {}
    for order in ("random", "out_degree"):
        print(f"[policy_ablation] node order: {order}")
        t = run_ablation(order, n=n, ks=ks, device=args.device)
        write_csv(t, os.path.join(args.out, f"policy_ablation_{order}.csv"))
        print_table(order, t)
        tables[order] = t
    return tables


if __name__ == "__main__":
    main()
