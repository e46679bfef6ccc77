#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # N = 2**21, on the card
    python3 chip_smoke.py --n 65536       # a smaller graph
    python3 chip_smoke.py --device cpu    # rehearsal: plain versions, no result

Phases, each printed on its own lines (any failure exits non-zero):

1. Device: name, count, and the card's name and power limit from nvidia-smi.
2. Build: compiles every CUDA source of the port (one nvcc per file, in
   parallel) and loads the libraries.
3. Kernels: K1 frontier_round_bsr, K2 bsr_spmm and K3 edge_sum on the card
   against their plain torch versions, at the main path's shapes (the
   N-node host_block_graph tile pool at bs=128, C in {1, 8}, occupancy
   threshold in {0, 0.5}, and the same pool with every other block row
   emptied).  ``sent`` must agree exactly, sums within
   |delta|_1 <= 1e-5 |plain|_1 (fluid values are around 1/N, so the bound is
   relative), and two launches must give bit-identical results.
4. Main path: ``repro_torch.solve(Problem.pagerank(host_block_graph(N)),
   method="frontier:pallas")`` on the card must converge with K1 launched
   once per round, and land within |x - x'|_1 <= 1e-5 of the same problem
   solved by ``frontier:segment_sum`` (K3).
5. Requests: one ``SolverSession(problem, "frontier:pallas")`` solves cold,
   its state is held to the invariant |B - (I-P)H - F|_1 <= 1e-4 (|B|_1 +
   |H|_1) in float64 on the host and, through the public ``bsr_spmm`` op
   (K2), in float32 on the card; then it serves 4 drifted right-hand sides
   through ``warm_start`` + ``solve``.  Each must converge, the first with
   fewer edge pushes than the cold solve.
6. Numbers: rounds, ops, wall times, launch counts of the main path
   (phases 4 and 5, counters zeroed just before and read just after; K2
   runs only in the invariant check, off the solve loop, so its main-path
   count is 0 and its check launch is reported apart), and
   each kernel's CUDA-event time at the main path's shapes beside its bound
   (the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s f32, counted
   for this run's inputs), its plain version's time and a one-call library
   yardstick (torch.sparse.mm on a sparse_bsr tensor for K2, index_add_ for
   K3, none for K1).

The line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BS = 128
REL_L1 = 1e-5
# the kernels the solve loop and warm starts launch; K2 (bsr_spmm) is the
# module's public op, off the loop, and is checked and timed on its own
ON_PATH = ("frontier_round_bsr", "edge_sum")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_l1(a, b) -> float:
    a = a.double()
    b = b.double()
    return float((a - b).abs().sum() / max(float(b.abs().sum()), 1e-300))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean milliseconds per call: CUDA events on the card, the host clock
    in a CPU rehearsal."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = n_flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2**21,
                    help="nodes of the host_block_graph (default 2**21)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for a rehearsal of the "
                    "control flow on the plain versions, which prints no "
                    "result")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch
    from repro_torch.core import host_block_graph
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import _build
    from repro_torch.kernels.diffusion import (
        BsrMatrix, bsr_spmm, bsr_spmm_kernel, bsr_spmm_plain,
        frontier_round_bsr, frontier_round_bsr_kernel,
        frontier_round_bsr_plain)
    from repro_torch.kernels.edge_sum import (
        csc_edges, edge_sum, edge_sum_plain)

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    timer = Timer(torch, dev)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    print("== phase 1: device")
    if on_card:
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi()
    else:
        kind, count, smi = "cpu (rehearsal)", 0, "cpu (rehearsal), n/a"
    print(f"device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # ---- 2. build ----------------------------------------------------------
    print("== phase 2: build")
    if on_card:
        t0 = time.perf_counter()
        libs = _build.build_all()
        for name in libs:
            _build.library(name)
        print(f"built and loaded {sorted(libs)} in "
              f"{time.perf_counter() - t0:.3f} s")
    else:
        print("rehearsal: no build")

    # ---- 3. kernels against their plain versions ---------------------------
    print("== phase 3: kernels")
    t0 = time.perf_counter()
    g = host_block_graph(args.n, seed=args.seed)
    problem = repro_torch.Problem.pagerank(g)
    tiles = problem.graph.bsr(BS)
    print(f"graph: N={g.n} links={g.n_edges} tiles={tiles.n_blocks} "
          f"({tiles.n_blocks * BS * BS * 4 / 1e9:.3f} GB) block rows="
          f"{tiles.n_row_blocks}; host build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m = tiles.to_device(dev)
    if on_card:
        torch.cuda.synchronize()
    print(f"tile pool uploaded in {time.perf_counter() - t0:.1f} s")
    n_pad = m.n_row_blocks * BS
    w_nodes = problem.node_weights()
    w = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    w[: g.n] = torch.as_tensor(w_nodes, dtype=torch.float32, device=dev)

    def fluid(c: int) -> torch.Tensor:
        # around 1/N like the solver's fluid, with a per-block-row scale so
        # that some block columns fall under the occupancy threshold
        f = rng.standard_normal((n_pad, c)) / g.n
        f *= 10.0 ** rng.uniform(-1, 1, size=(n_pad // BS, 1, 1)).repeat(
            BS, axis=1).reshape(n_pad, 1)
        f[g.n:] = 0.0
        return torch.as_tensor(f, dtype=torch.float32, device=dev)

    def k1_inputs(mat, f, t, tau):
        """What ops.frontier_round_bsr hands K1, plus its sent."""
        c = f.shape[1]
        wt = (w / t).to(torch.float32)
        sel = f.abs() * wt[:, None] > 1.0
        blk = sel.reshape(-1, BS * c)
        if tau > 0:
            col_active = (blk.float().mean(dim=1) > tau).to(torch.int32)
        else:
            col_active = blk.any(dim=1).to(torch.int32)
        return (mat.blocks, mat.block_col, mat.row_ptr, col_active,
                f.reshape(-1, BS, c).contiguous(),
                wt.reshape(-1, BS).contiguous())

    # the same tiles on the CPU, for the cross-device predicate check
    m_cpu = BsrMatrix(tiles.blocks, tiles.block_row, tiles.block_col,
                      tiles.n_row_blocks, BS, device="cpu")
    timing_inputs = {}
    for c in (1, 8):
        for tau in (0.0, 0.5):
            f = fluid(c)
            fw = (f.abs() * w[:, None]).flatten()
            t = torch.quantile(fw[fw > 0].float().cpu()[:2**24], 0.5).to(dev)
            f_new, sent, res = frontier_round_bsr(
                m, f, w, t, backend="kernel", occupancy_threshold=tau)
            # the same round through the CPU's plain path: the predicate
            # (and with it sent) must agree exactly across devices
            if on_card and c == 1:
                _, sent_cpu, _ = frontier_round_bsr(
                    m_cpu, f.cpu(), w.cpu(), t.cpu(), backend="kernel",
                    occupancy_threshold=tau)
                if not torch.equal(sent.cpu(), sent_cpu):
                    fail(f"K1 sent differs card vs cpu (C={c}, tau={tau})")
            ins = k1_inputs(m, f, t, tau)
            out_k, l1_k = frontier_round_bsr_kernel(*ins)
            out_k2, l1_k2 = frontier_round_bsr_kernel(*ins)
            out_p, l1_p = frontier_round_bsr_plain(*ins)
            armed = int(ins[3].sum())
            e_f, e_l1 = rel_l1(out_k, out_p), rel_l1(l1_k, l1_p)
            same = torch.equal(out_k, out_k2) and torch.equal(l1_k, l1_k2)
            print(f"K1 C={c} tau={tau}: armed columns {armed}/"
                  f"{m.n_row_blocks}, sent nodes {int((sent != 0).sum())}, "
                  f"rel L1 f_new {e_f:.3e} row_l1 {e_l1:.3e}, "
                  f"bit-identical relaunch {same}")
            if not (e_f <= REL_L1 and e_l1 <= REL_L1 and same):
                fail(f"K1 C={c} tau={tau}")
            if not torch.equal(f_new.reshape(out_k.shape), out_k):
                fail("K1 through ops.frontier_round_bsr differs from the "
                     "direct launch")
            if c == 1 and tau == 0.0:
                timing_inputs["k1"] = (ins, float((out_k - out_p).abs()
                                                  .max()))
    del m_cpu
    # the same pool with every other block row emptied
    keep = tiles.block_row % 2 == 0
    m_odd = BsrMatrix(tiles.blocks[keep], tiles.block_row[keep],
                      tiles.block_col[keep], tiles.n_row_blocks, BS,
                      device=dev)
    f = fluid(1)
    fw = (f.abs() * w[:, None]).flatten()
    t = torch.quantile(fw[fw > 0].float().cpu()[:2**24], 0.5).to(dev)
    ins = k1_inputs(m_odd, f, t, 0.0)
    out_k, l1_k = frontier_round_bsr_kernel(*ins)
    out_p, l1_p = frontier_round_bsr_plain(*ins)
    empty = ~m_odd.row_occupied
    kept = torch.where(f.abs() * (w / t)[:, None] > 1.0,
                       torch.zeros_like(f), f).reshape(out_k.shape)
    ok_empty = torch.equal(out_k[empty], kept[empty])
    e_f = rel_l1(out_k, out_p)
    print(f"K1 interleaved empty rows: {int(empty.sum())} empty, kept "
          f"fluid exact {ok_empty}, rel L1 {e_f:.3e}")
    if not (ok_empty and e_f <= REL_L1):
        fail("K1 interleaved empty rows")
    for c in (1, 8):
        x = fluid(c).reshape(-1, BS, c)
        for name, mat in (("full", m), ("empty rows", m_odd)):
            a = bsr_spmm_kernel(mat.blocks, mat.visit_block, mat.block_col,
                                mat.row_ptr, x)
            a2 = bsr_spmm_kernel(mat.blocks, mat.visit_block, mat.block_col,
                                 mat.row_ptr, x)
            p = bsr_spmm_plain(mat.blocks, mat.visit_block, mat.block_col,
                               mat.row_ptr, x)
            e = rel_l1(a, p)
            zero = bool((a[~mat.row_occupied] == 0).all())
            same = torch.equal(a, a2)
            print(f"K2 C={c} {name}: rel L1 {e:.3e}, empty rows exactly 0 "
                  f"{zero}, bit-identical relaunch {same}")
            if not (e <= REL_L1 and zero and same):
                fail(f"K2 C={c} {name}")
            if c == 1 and name == "full":
                timing_inputs["k2"] = (
                    (mat.blocks, mat.visit_block, mat.block_col, mat.row_ptr,
                     x), float((a - p).abs().max()))
    del m_odd
    src, dst, wgt = problem.p.edge_list()
    edges = csc_edges(src, dst, wgt, g.n, dev)
    x = fluid(1)[: g.n, 0].contiguous()
    a, a2 = edge_sum(x, edges), edge_sum(x, edges)
    p = edge_sum_plain(x, edges.indptr, edges.src, edges.wgt)
    e = rel_l1(a, p)
    same = torch.equal(a, a2)
    print(f"K3: {edges.n_edges} edges, rel L1 {e:.3e}, bit-identical "
          f"relaunch {same}")
    if not (e <= REL_L1 and same):
        fail("K3")
    timing_inputs["k3"] = ((x, edges), float((a - p).abs().max()))
    print("kernels agree with their plain versions: frontier_round_bsr, "
          "bsr_spmm, edge_sum")

    # ---- 4. main path ------------------------------------------------------
    print("== phase 4: main path")
    reset_launches()
    rep = repro_torch.solve(problem, method="frontier:pallas",
                            device=args.device)
    k1_solve = LAUNCHES["frontier_round_bsr"]
    main_launches = dict(LAUNCHES)
    print(f"frontier:pallas: converged {rep.converged} residual "
          f"{rep.residual:.6e} rounds {rep.n_rounds} ops {rep.n_ops} "
          f"cost {rep.cost_iterations:.4f} wall {rep.wall_time_s:.3f} s; "
          f"K1 launches {k1_solve}")
    if not rep.converged:
        fail("frontier:pallas did not converge")
    if on_card and k1_solve != rep.n_rounds:
        fail(f"K1 launched {k1_solve} times in {rep.n_rounds} rounds")
    reset_launches()
    rep_ss = repro_torch.solve(problem, method="frontier:segment_sum",
                               device=args.device)
    for k, v in LAUNCHES.items():
        main_launches[k] += v
    dx = float(np.abs(rep.x - rep_ss.x).sum())
    print(f"frontier:segment_sum: converged {rep_ss.converged} residual "
          f"{rep_ss.residual:.6e} rounds {rep_ss.n_rounds} ops "
          f"{rep_ss.n_ops} wall {rep_ss.wall_time_s:.3f} s; K3 launches "
          f"{LAUNCHES['edge_sum']}; |x_pallas - x_segment_sum|_1 {dx:.3e}")
    if not rep_ss.converged or dx > 1e-5:
        fail("frontier:segment_sum cross-path check")
    if on_card and LAUNCHES["edge_sum"] != rep_ss.n_rounds:
        fail("K3 not launched once per segment_sum round")

    # ---- 5. a few requests -------------------------------------------------
    print("== phase 5: requests")
    reset_launches()
    session = repro_torch.SolverSession(problem, "frontier:pallas",
                                        device=args.device)
    cold = session.solve()
    for k, v in LAUNCHES.items():
        main_launches[k] += v
    # the invariant check is not part of the main path: its K2 launch is
    # counted apart, and the counts are zeroed again before the requests
    reset_launches()
    f_nodes, h_nodes = session._driver.fluid()
    b = problem.b
    ph = np.bincount(dst, weights=h_nodes[src] * wgt, minlength=g.n)
    viol = float(np.abs(b - h_nodes + ph - f_nodes).sum())
    scale = float(np.abs(b).sum() + np.abs(h_nodes).sum())
    h_dev = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    h_dev[: g.n] = torch.as_tensor(h_nodes, dtype=torch.float32, device=dev)
    ph_dev = bsr_spmm(m, h_dev)[: g.n]
    viol_dev = float((torch.as_tensor(b, dtype=torch.float32, device=dev)
                      - h_dev[: g.n] + ph_dev
                      - torch.as_tensor(f_nodes, dtype=torch.float32,
                                        device=dev)).abs().sum())
    print(f"cold: converged {cold.converged} rounds {cold.n_rounds} ops "
          f"{cold.n_ops} wall {cold.wall_time_s:.3f} s; invariant "
          f"|B-(I-P)H-F|_1 = {viol:.3e} (float64 host), {viol_dev:.3e} "
          f"(float32 card via bsr_spmm), bound {1e-4 * scale:.3e}")
    if not cold.converged or viol > 1e-4 * scale or viol_dev > 1e-4 * scale:
        fail("cold session solve / invariant")
    check_launches = LAUNCHES["bsr_spmm"]
    if on_card and check_launches != 1:
        fail(f"the invariant check launched K2 {check_launches} times")
    reset_launches()
    warm_ops = []
    for i in range(4):
        b_new = np.abs(b * (1.0 + 0.05 * rng.standard_normal(g.n)))
        resid0 = session.warm_start(b_new)
        warm = session.solve()
        warm_ops.append(warm.n_ops)
        print(f"request {i}: |F'|_1 {resid0:.6e} converged {warm.converged} "
              f"rounds {warm.n_rounds} ops {warm.n_ops} wall "
              f"{warm.wall_time_s:.3f} s")
        if not warm.converged:
            fail(f"request {i} did not converge")
    if not warm_ops[0] < cold.n_ops:
        fail(f"first warm solve used {warm_ops[0]} ops, cold {cold.n_ops}")
    for k, v in LAUNCHES.items():
        main_launches[k] += v
    print(f"main path launches (phases 4-5): {json.dumps(main_launches)}; "
          f"K2 launches of the invariant check {check_launches}")
    if on_card:
        missing = [k for k in ON_PATH if main_launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")

    # ---- 6. numbers --------------------------------------------------------
    print("== phase 6: numbers")
    print(f"main path: N={g.n} links={g.n_edges} pallas rounds "
          f"{rep.n_rounds} ops {rep.n_ops} solve wall {rep.wall_time_s:.3f} s"
          f"; segment_sum rounds {rep_ss.n_rounds} ops {rep_ss.n_ops} wall "
          f"{rep_ss.wall_time_s:.3f} s; cold session {cold.wall_time_s:.3f} "
          f"s; warm requests ops {warm_ops}")
    rows = []
    ins, err = timing_inputs["k1"]
    blocks, block_col, row_ptr, col_active, f3, wt = ins
    armed = col_active.bool()
    tiles_read = int(armed[block_col.long()].sum())
    nrb, _, c = f3.shape
    k1_bytes = (tiles_read * BS * BS * 4 + block_col.numel() * 4
                + row_ptr.numel() * 8 + col_active.numel() * 4
                + f3.numel() * 4 * 2 + wt.numel() * 4 + nrb * 4)
    b_ms, b_by = bound_ms(k1_bytes, 2.0 * tiles_read * BS * BS * c)
    print(f"K1 timing input: {int(armed.sum())}/{nrb} block columns armed, "
          f"{tiles_read}/{block_col.numel()} tiles read "
          f"({tiles_read / block_col.numel():.4f} of the pool)")
    rows.append({
        "name": "frontier_round_bsr", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:376",
        "launches": main_launches["frontier_round_bsr"],
        "max_abs_err": err,
        "ms": timer(lambda: frontier_round_bsr_kernel(*ins), 20),
        "plain_ms": timer(lambda: frontier_round_bsr_plain(*ins), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "armed_tile_fraction": tiles_read / block_col.numel(),
    })
    ins, err = timing_inputs["k2"]
    blocks, visit_block, visit_col, row_ptr, x3 = ins
    k2_bytes = (blocks.numel() * 4 + visit_block.numel() * 8
                + row_ptr.numel() * 8 + x3.numel() * 4 * 2)
    b_ms, b_by = bound_ms(k2_bytes, 2.0 * blocks.numel() * x3.shape[2])
    lib_ms = None
    if on_card:
        a_bsr = torch.sparse_bsr_tensor(row_ptr, visit_col.long(), blocks,
                                        size=(n_pad, n_pad))
        x2 = x3.reshape(n_pad, 1)
        lib_ms = timer(lambda: torch.sparse.mm(a_bsr, x2), 20)
        lib_err = float((torch.sparse.mm(a_bsr, x2).reshape(x3.shape)
                         - bsr_spmm_kernel(*ins)).abs().max())
        print(f"torch.sparse.mm (sparse_bsr) vs K2: max abs diff "
              f"{lib_err:.3e}")
    rows.append({
        "name": "bsr_spmm", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:70",
        "launches": main_launches["bsr_spmm"],
        "check_launches": check_launches,
        "max_abs_err": err,
        "ms": timer(lambda: bsr_spmm_kernel(*ins), 20),
        "plain_ms": timer(lambda: bsr_spmm_plain(*ins), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    (x, edges), err = timing_inputs["k3"]
    n_e = edges.n_edges
    k3_bytes = edges.indptr.numel() * 8 + n_e * 8 + x.numel() * 4 * 2
    b_ms, b_by = bound_ms(k3_bytes, 2.0 * n_e)
    dst_t = torch.repeat_interleave(
        torch.arange(g.n, device=dev), torch.diff(edges.indptr))
    src_t = edges.src.long()
    rows.append({
        "name": "edge_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/edge_sum.cu",
        "replaces": "src/repro/core/diteration.py:221",
        "launches": main_launches["edge_sum"],
        "max_abs_err": err,
        "ms": timer(lambda: edge_sum(x, edges), 50),
        "plain_ms": timer(lambda: edge_sum_plain(
            x, edges.indptr, edges.src, edges.wgt), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.zeros_like(x).index_add_(
            0, dst_t, x[src_t] * edges.wgt), 20),
    })
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']}) launches {r['launches']} on {smi}")
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    if not on_card:
        print("rehearsal on the CPU done: no device numbers, no result")
        return 3
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
