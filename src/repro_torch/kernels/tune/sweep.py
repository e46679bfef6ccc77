"""Tuning sweep of the BSR diffusion kernels K1 and K2.

Sweeps (block size ``bs``, ``buffer_depth``, occupancy threshold), marks
configs whose launch has no body (:func:`.model.route`: a ring that does
not fit the platform's shared-memory budget, or a depth the source has no
instance of) infeasible and never times them, times the rest and persists
the winner as a versioned JSON record (:mod:`.records`) that the backend
registry and the session drivers read.

Timing path per device:

* **cuda** — the kernels themselves (``timing_path="cuda"``): K1
  (``launch_frontier_round_bsr``) on the operands the frontier op hands
  it, K2 (``launch_bsr_spmm``) over the identity visit table of the pool,
  each at the row's ring depth, warmed once, then CUDA events around
  ``iters`` launches.  These launches are counted nowhere.
* **cpu** — the plain versions (``timing_path="plain"``), which is what
  runs there.  They have no ring, so all depths share one measurement per
  (bs, threshold) and the shallowest feasible depth wins the tie.

The winner is ``min(measured_us, buffer_depth, -bs)``, the reference's
rule.
"""
from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import Optional, Sequence

import numpy as np
import torch

from . import records
from .model import (
    PLATFORM_SPECS,
    ctas_per_sm,
    dma_compute_ratio,
    frontier_round_cost,
    gather_spmm_cost,
    ideal_time_s,
    roofline_fraction,
    route,
    simt_smem_bytes,
    smem_bytes,
)

__all__ = ["run_sweep"]


def _problem(n: int, bs: int, c: int, density: float, seed: int,
             device="cpu"):
    """A host-ordered web graph + mid-convergence frontier at ``density``:
    ``(BsrMatrix, f [n_pad, C], w [n_pad], t)`` on ``device``.

    The reference's arrays for the same arguments.  Each ``bs`` gets a
    graph of its own (``host_block_graph(host_size=bs)``), as in the
    reference, so a host is one block row at every tile size.
    """
    from ...core import host_block_graph, pagerank_system
    from ..diffusion import prepare_bsr

    g = host_block_graph(n, host_size=bs, links_per_node=8.0,
                         intra_frac=0.92, span_hosts=2, seed=seed + 1)
    p, _b = pagerank_system(g)
    m = prepare_bsr(p.indptr, p.indices, p.weights, p.n, bs=bs,
                    device=device)
    n_pad = m.n_row_blocks * bs
    rng = np.random.default_rng(seed)
    n_blocks = n_pad // bs
    n_hot = max(1, int(round(density * n_blocks)))
    hot = rng.choice(n_blocks, size=n_hot, replace=False)
    f = np.full((n_pad, c), 0.25, dtype=np.float32)
    for b in hot:
        f[b * bs: (b + 1) * bs] = 2.0
    f *= rng.choice([-1.0, 1.0], size=(n_pad, c))
    f[p.n:] = 0.0
    w = np.zeros(n_pad, np.float32)
    w[: p.n] = 1.0
    dev = torch.device(device)
    return (m, torch.from_numpy(f).to(dev), torch.from_numpy(w).to(dev),
            torch.tensor(1.0, dtype=torch.float32, device=dev))


def _n_active_blocks(m, f, w, t, occ_threshold: float) -> int:
    """Tiles whose block column is armed under the given threshold."""
    sel = (f.abs() * w[:, None] > t).cpu().numpy()
    blk = sel.reshape(m.n_row_blocks, -1)
    if occ_threshold > 0.0:
        col_active = blk.mean(axis=1) > occ_threshold
    else:
        col_active = blk.any(axis=1)
    return int(col_active[m.block_col.cpu().numpy()].sum())


def _k1_operands(m, f, w, t, occ: float):
    """What ``ops.frontier_round_bsr`` hands K1 for the fluid ``f``."""
    c = f.shape[1]
    wt = (w / t).to(torch.float32)
    blk = (f.abs() * wt[:, None] > 1.0).reshape(-1, m.bs * c)
    if occ > 0.0:
        col_active = (blk.float().mean(dim=1) > occ).to(torch.int32)
    else:
        col_active = blk.any(dim=1).to(torch.int32)
    return (m.blocks, m.block_col, m.row_ptr, col_active,
            f.reshape(-1, m.bs, c).contiguous(),
            wt.reshape(-1, m.bs).contiguous())


def _timeit(fn, iters: int, cuda: bool) -> float:
    """Microseconds a call: one warm call, then ``iters`` calls between
    CUDA events (the host clock on the CPU)."""
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters * 1e3


def _measure(kernel, m, f, w, t, depth, occ, cuda, iters,
             plain_cache) -> float:
    """One timed config; the plain versions' timings are shared across
    depths."""
    from ..diffusion.kernel import (
        bsr_spmm_plain,
        frontier_round_bsr_plain,
        launch_bsr_spmm,
        launch_frontier_round_bsr,
    )

    if not cuda and occ in plain_cache:
        return plain_cache[occ]
    if kernel == "frontier_round_bsr":
        ins = _k1_operands(m, f, w, t, occ)
        if cuda:
            def fn():
                return launch_frontier_round_bsr(*ins, buffer_depth=depth)
        else:
            def fn():
                return frontier_round_bsr_plain(*ins)
    else:  # bsr_gather_spmm over the identity visit table of the pool
        ins = (m.blocks, m.visit_block, m.block_col, m.row_ptr,
               f.reshape(m.n_row_blocks, m.bs, -1).contiguous())
        if cuda:
            def fn():
                return launch_bsr_spmm(*ins, buffer_depth=depth)
        else:
            def fn():
                return bsr_spmm_plain(*ins)
    us = _timeit(fn, iters, cuda)
    if not cuda:
        plain_cache[occ] = us
    return us


def _winner(timed: Sequence[dict]) -> dict:
    """The fastest timed row; a tie goes to the shallower ring, then to
    the larger tile (the reference's rule)."""
    return min(timed, key=lambda r: (r["measured_us"], r["buffer_depth"],
                                     -r["bs"]))


def run_sweep(
    kernel: str = "frontier_round_bsr",
    *,
    n: int = 4096,
    c: int = 1,
    density: float = 0.25,
    bs_list: Sequence[int] = (32, 64, 128),
    depths: Sequence[int] = (1, 2, 4),
    occupancy_thresholds: Sequence[float] = (0.0,),
    iters: int = 3,
    seed: int = 0,
    save: bool = True,
    platform: Optional[str] = None,
    verbose: bool = True,
    device: str = "cuda",
) -> dict:
    """Run the sweep on ``device`` and (optionally) persist the winning
    config record under ``platform`` (default: the device's type)."""
    if kernel not in records.KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}; expected one of {records.KERNELS}"
        )
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("run_sweep(device='cuda') needs a card; pass "
                           "device='cpu' to time the plain versions")
    if platform is None:
        platform = dev.type
    spec = PLATFORM_SPECS.get(platform, PLATFORM_SPECS["cpu"])
    rows = []
    for bs in bs_list:
        m, f, w, t = _problem(n, bs, c, density, seed, dev)
        plain_cache: dict = {}  # (occ) -> measured us, shared across depths
        for occ in occupancy_thresholds:
            n_act = _n_active_blocks(m, f, w, t, occ)
            if kernel == "frontier_round_bsr":
                cost = frontier_round_cost(m.n_row_blocks, bs, c, n_act)
            else:
                cost = gather_spmm_cost(m.n_row_blocks, bs, c, m.n_blocks)
            ideal_s, bound = ideal_time_s(cost, spec)
            for depth in depths:
                body = route(kernel, bs, c, depth, spec=spec)
                row = {
                    "bs": bs,
                    "buffer_depth": depth,
                    "occupancy_threshold": occ,
                    "feasible": body is not None,
                    "route": body,
                    "smem_bytes": (simt_smem_bytes(kernel, bs, c)
                                   if body == "simt"
                                   else smem_bytes(kernel, bs, c, depth)),
                    "ctas_per_sm": (ctas_per_sm(kernel, bs, c, depth)
                                    if body == "bulk" else None),
                    "n_blocks_active": n_act,
                    "bound": bound,
                    "dma_compute_ratio": round(
                        dma_compute_ratio(cost, spec), 3),
                    "measured_us": None,
                    "gb_per_s": None,
                    "throughput_gflops": None,
                    "roofline_fraction": None,
                }
                if body is not None:
                    us = _measure(kernel, m, f, w, t, depth, occ, cuda,
                                  iters, plain_cache)
                    row["measured_us"] = round(us, 2)
                    row["gb_per_s"] = round(
                        cost.total_bytes / (us * 1e-6) / 1e9, 3)
                    row["throughput_gflops"] = round(
                        cost.flops / (us * 1e-6) / 1e9, 4)
                    row["roofline_fraction"] = round(
                        roofline_fraction(us * 1e-6, ideal_s), 6)
                rows.append(row)
                if verbose:
                    shown = (f"{row['measured_us']} us, {row['gb_per_s']} "
                             f"GB/s, roofline {row['roofline_fraction']} "
                             f"({spec.name}), "
                             + (f"{body} body" if cuda else "plain version")
                             if body is not None else "infeasible")
                    print(f"[tune:{kernel}] bs={bs} depth={depth} occ={occ}"
                          f": {shown}; smem {row['smem_bytes']} bytes"
                          + (f", {row['ctas_per_sm']} CTA(s)/SM"
                             if body == "bulk" else ""), flush=True)
        del m, f, w, t
        if cuda:
            torch.cuda.empty_cache()
    timed = [r for r in rows if r["measured_us"] is not None]
    if not timed:
        raise RuntimeError(
            "no feasible config in the sweep — every (bs, depth) exceeded "
            f"the {spec.name} shared-memory budget of {spec.smem_budget} "
            "bytes or the deepest ring instanced"
        )
    win = _winner(timed)
    record = {
        "version": records.RECORD_VERSION,
        "kernel": kernel,
        "platform": platform,
        "device_kind": (torch.cuda.get_device_name(dev) if cuda
                        else dev.type),
        "torch_version": torch.__version__,
        "created_utc": datetime.now(timezone.utc).isoformat(),
        "timing_path": "cuda" if cuda else "plain",
        "problem": {"n": n, "c": c, "density": density, "seed": seed,
                    "iters": iters},
        "best": {
            "bs": win["bs"],
            "buffer_depth": win["buffer_depth"],
            "occupancy_threshold": win["occupancy_threshold"],
            "measured_us": win["measured_us"],
            "throughput_gflops": win["throughput_gflops"],
            "roofline_fraction": win["roofline_fraction"],
            "smem_bytes": win["smem_bytes"],
        },
        "sweep": rows,
    }
    if save:
        path = records.save_record(record)
        if verbose:
            print(f"[tune:{kernel}] best bs={win['bs']} "
                  f"depth={win['buffer_depth']} -> {path}")
    return record
