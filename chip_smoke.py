#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # N = 2**21, on the card
    python3 chip_smoke.py --n 65536       # a smaller graph
    python3 chip_smoke.py --device cpu --n 16384 --fm-vocab 1000 \
        --gin-nodes 5000 --lm-reduced   # rehearsal: plain versions, no result

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
   relative), and two launches must give bit-identical results; K1's and
   K2's bulk routes (the ones their rules pick at bs=128) must give the
   bits of their simt bodies, launched apart.  K1 also at its input (b):
   the operands of round 3,001 of the ``frontier:pallas`` cold solve (a
   ``SolverSession`` with ``max_rounds=3000``), its armed share printed.
4. Main path: ``repro_torch.solve(Problem.pagerank(host_block_graph(N)),
   method="frontier:pallas")`` on the card must converge with K1 launched
   once per round, and land within |x - x'|_1 <= 1e-5 of the same problem
   solved by ``frontier:segment_sum`` (K3).
5. Requests: one ``SolverSession(problem, "frontier:pallas")`` solves cold,
   its state is held to the invariant |B - (I-P)H - F|_1 <= 1e-4 (|B|_1 +
   |H|_1) in float64 on the host and, through the public ``bsr_spmm`` op
   (K2), in float32 on the card; then it serves 4 drifted right-hand sides
   through ``warm_start`` + ``solve``.  Each must converge, the first with
   fewer edge pushes than the cold solve.  Every K1 launch of phases 4-5
   must run on the bulk route (the wrapper's ``FRONTIER_ROUTES``, printed
   as ``{bulk: n, simt: 0}``).
6. Engine kernels: the K-PID engine's layout at N, k=4 (the sizing rule
   of ``engine:bsr``: 512-slot buckets), built through ``SolverSession``
   (its wall time printed); K2 over the engine's visit table (the port of
   bsr_gather_spmm_pallas) and K3 over the engine's edge table against
   their plain versions on random fluid: relative L1 <= 1e-5, bit-identical
   relaunch, and K2's bulk route the bits of its simt body.
7. Engine main path, N, k=4, policy slope_ema: cold ``engine:bsr`` and
   ``engine:chunk`` solves must converge within |x - x_segment_sum|_1 <=
   1e-5 (2·target_error below N = 2e5: two converged schedules may differ
   by that much) and the invariant of phase 5, with K2 launched once per
   ``engine:bsr`` round and K3 once per ``engine:chunk`` round; one
   ``engine:bsr`` solve with a forced MovePlan(0 -> 3, 2 buckets) after its
   first chunk, under the same gates; one warm request (the drift of phase
   5) on the cold ``engine:bsr`` session, which must converge with fewer
   edge pushes than the cold solve.  Every K2 launch of phases 4-7 must
   run on the bulk route (the wrapper's ``ROUTES``), and at the default N
   and seed each ``engine:bsr`` solve and the ``frontier:pallas`` solve of
   phase 4 must keep their recorded rounds and edge pushes (``RECORDED``).
8. Replay: power_law_graph(1600, seed=7) ordered by out-degree, k=8,
   40 buckets per PID (8 headroom), dynamic with eta=0.9, target 1e-8, on
   both engine backends: converged, max |x - x_dense| < 1e-5 against a
   dense numpy solve, a non-empty move log, the same log on both; its K2
   launches all on the route K2's rule gives its 7-slot tiles (simt).
9. FM serving: the ``fm`` config at full width (39 fields x 10^6 rows, a
   39,000,000 x 10 float32 table drawn from a seeded generator on the
   card) through ``launch.steps``: 8 ``serve_p99`` requests (B=512), one
   ``serve_bulk`` batch (B=262,144) and one ``retrieval_cand`` query
   against 10^6 candidates, each timed with its host batch made before.
   Gates: finite logits; K4 (fm_interaction) launched once per forward
   (and once per retrieval, for the user's own pair term); K4 against its
   plain version on the serve_bulk gather, relative L1 <= 1e-5 and a
   bit-identical relaunch; ``retrieval_score`` equal to ``forward_logits``
   on the same 1,000 candidates within 1e-4.  Prints the wall per request
   and the gather / K4 split.
10. GIN forward: ``gin-tu`` at the ``ogb_products`` cell on a synthetic
   ``power_law_graph`` (2,449,029 nodes, alpha chosen to stay under the
   cell's 61,859,328 edges, padded to it with edge_mask-0 edges and to
   2,449,056 nodes): two forwards over the destination-sorted batch, each
   layer's aggregation K5 in its gather form (rows = the sources, data =
   the node states).  Gates: K5 (segment_sum) launched 5 times per
   forward, every launch in the gather form and followed by one launch
   of its carry kernel; the forward's device memory peak above what
   earlier phases hold under E·d·4 bytes (no [E, d] message buffer);
   the [N, 47] output finite and within relative L1 <= 1e-5 of the same
   forward with K5 replaced by its plain version; K5 against its plain
   version on layer 0's messages (contiguous form) and on layer 0's node
   states (gather form), relative L1 <= 1e-5 and a bit-identical
   relaunch each, and,
   exactly, on a small integer-valued case with sentinel ids and mask-0
   rows in both forms.  Prints N, E, the real E, the host build times,
   K5's chunk count and longest segment, the forward's wall and its
   device memory peak.
11. Numbers: rounds, ops, wall times, launch counts of the main path
   (phases 4 and 5, and phase 7, counters zeroed just before each solve
   and read just after; K2 runs in phase 5 only in the invariant check,
   off the solve loop, so its count there is 0 and its check launch is
   reported apart), and each kernel's CUDA-event time at the main path's
   shapes beside its bound (the larger of bytes over 3.35 TB/s and flops
   over 67 TFLOP/s f32, or 989 TFLOP/s for K6's bf16, counted for this
   run's inputs), its plain version's time and a one-call library
   yardstick (torch.sparse.mm on a sparse_bsr tensor for K2, index_add_
   for K3, none for K1).  The K1 and K2 rows also carry the body that ran
   them (``kernel``) and their TB/s (K2's also the library call's); K1's
   row carries its armed tile share, its ratio to K2's time over the same
   pool (``k2_ratio``) and, under ``late_*`` keys, its numbers at input
   (b).  K1 at inputs (a) and (b) and K2 are timed by one rule (``timing``:
   the least of two 20-call means, in turns, the second round reversed);
   every other row is one mean.  The engine's
   K2 and K3 get rows of their own (``bsr_gather_spmm``: the engine:bsr
   rounds of phase 7;
   ``engine_edge_sum``: the engine:chunk rounds); the ``edge_sum`` row
   counts K3 over the node-space edge list (phases 4-5 and the engine's
   warm seed).  K4 and K5 get rows at the FM serve_bulk and GIN layer
   shapes, their launches those of phases 9 and 10 by form (the
   forward runs the gather form only): ``segment_sum``, the contiguous
   form on layer 0's messages, unweighted beside its library yardstick
   ``torch.segment_reduce`` (and weighted, as GIN weights them, with
   ``index_add_`` beside it; both bounds printed in phase 10);
   ``segment_sum_gather``, one GIN layer's aggregation, beside
   ``torch.sparse.mm`` of a ``sparse_csr`` (ptr, src, mask) matrix, its
   bound counting each input byte once (phase 10 prints beside it the
   time of its rows read with no reuse); none for K4.
12. LM serving: qwen1.5-0.5b at full width and depth (24 layers,
   619,570,176 parameters, 1.24 GB bf16 drawn from a seeded generator on
   the card) through ``launch.steps``' prefill / decode kinds, counters
   zeroed just before: request A, 8 prompts x 2,048 tokens
   (``lm_token_batch(0, ...)``) and 32 greedy decode steps over a
   2,080-slot cache; request B, 1 prompt x 32,768 tokens and 16 steps over
   a 32,784-slot cache (prefill_32k / decode_32k at batch 1).  Gates: K6
   (flash_attention) launched 24 times in each prefill and 24 x steps in
   each decode loop, counted apart; each prefill's 24 launches run by
   ``flash_prefill_wgmma_kernel`` (the wrapper's ``ROUTES["wgmma"]``, the
   route ``prefill_route`` gives bf16 at Dh 64), none by another prefill
   kernel; every decode step run with the split
   count ``split_count`` gives at its kv_len (``SPLITS``, added to by the
   wrapper at each launch; the decode kernel combines its splits in the
   same launch); finite logits;
   K6 against its plain version in bf16 on layer 0's q / k / v at each
   prefill (B's on its last 1,024 queries) and at each request's last
   decode step (``kv_len``), max abs err <= 3e-2 and a bit-identical
   relaunch (mean |plain| and relative L1 printed beside it); each
   decode's inputs cast to float32, K6 within rtol 1e-5 / atol 1e-6 of the
   plain version, B's on the split path; a float32 copy of the weights
   through A's prefill and 8
   decode steps teacher-forced on A's tokens, with K6 and with the plain
   attention, logits within relative L1 1e-4.  Prints the prefill walls
   (cold, and warm once more), the wall per decode step and tok/s, the
   device memory peak and a torch.profiler trace of one decode step of
   each request; K6's rows (A's prefill layer and decode step, B's decode
   step and prefill layer, ``scaled_dot_product_attention`` as the
   library yardstick) join phase 11's in the kernels line, each with the
   launches counted at its shape in this phase and the ``kernel`` that ran
   it (``wgmma`` for the prefill rows, ``decode``), the prefill rows' TFLOP/s
   (K6's and the library's, the pairs under the causal mask counted)
   printed on a line of their own; the decode rows also with
   the ``splits`` the last decode step ran with, and with K6 and the
   library call timed by CUDA graph replay as well (``graph_ms``,
   ``library_graph_ms``: without the host's cost per call, which is of the
   kernels' order); ``ms`` and ``library_ms`` are eager in every row.
13. Simulator: the paper's K-PID simulator (``repro_torch.core.
   DistributedSimulator``) on the card, its push on K7 (sim_messages, the
   messages; sim_push, their sum), at N, K=8, the batch schedule, target
   1/N, the K7 counters zeroed just before each run and read just after.
   Uniform partition, static and dynamic: each must converge, hold the
   §2.2 invariant with F counting the fluid and every outbox, land within
   |h - x_segment_sum|_1 <= 1e-5 of phase 4's solution (2·target_error
   below N = 2e5) and launch each K7 kernel once per push.  A replay of
   the dynamic run through ``repro_torch.solve(problem, "simulator",
   ...)``: equal steps, edge ops, exchanges and move log, and h bit for
   bit.  Both runs again with every whole push timed by CUDA events (its
   stream time), held equal to the clean runs; the static one keeps its
   largest push, the dynamic one the push nearest the static run's median
   by messages, and the dynamic one replays both pushes whole to count
   their device kernels and copies (torch.profiler) and time them back to
   back.  Table 2's protocol at scale: the same graph ordered by
   out-degree, static and dynamic (converged, the invariant; the costs and
   moves printed).  The paper-exact sequential schedule at the paper's N =
   1000 (out-degree order, K=16, dynamic): converged, the invariant.  Every
   run's (steps, edge ops, exchanges, pushes, moves) must equal
   ``SIM_RECORDED`` (the N = 2**21 runs at the default N and seed).  K7
   against its plain versions on CPU copies, ``torch.equal`` and a
   bit-identical relaunch, at the largest and the median push (each one's
   longest bucket printed) and on synthetic pushes: the messages for 600
   nodes of the N = 1000 graph (some with no out-edge) and none (no
   launch); the sum with repeated keys, all remote and empty (no launch).
   Their rows join the kernels line, at the largest push, their launches
   those of the static and dynamic runs, with the median push's numbers
   beside (``median_ms``, ...): ``sim_messages`` (no library call computes
   it) and ``sim_push`` (the whole wrapper as ``ms``, ``index_add_``,
   which is also its plain version, as the library call, the longest
   bucket, a whole push's device kernels and copies and stream time);
   each bound counts each input read once and each output written once,
   flops over 34 TFLOP/s float64.

The line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
F64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
BS = 128
REL_L1 = 1e-5
# the kernels the frontier solve loop and warm starts launch; K2 (bsr_spmm)
# is the module's public op, off that loop, and is checked and timed on its
# own
ON_PATH = ("frontier_round_bsr", "edge_sum")
# the kernels of the engine path: K2 (engine:bsr rounds) and K3
# (engine:chunk rounds, warm starts)
ENGINE_PATH = ("bsr_spmm", "edge_sum")
ENGINE_OPTS = {"k": 4, "policy": "slope_ema"}
# (rounds, edge pushes) of the default run's solves (N = 2**21, seed 0), as
# every earlier run of this script gave them: K1 and K2 keep their sums'
# order, so they may not move
RECORDED = {"frontier:pallas": (3974, 267820931),
            "engine:bsr cold": (3392, 267629992),
            "engine:bsr forced move": (3520, 270165051),
            "engine:bsr warm": (1888, 107390909)}
# the simulator's push: its messages, then their sum
K7 = ("sim_messages", "sim_push")
# (steps, edge ops, exchanges, pushes, moves) of phase 13's runs as every
# earlier run of this script on the card gave them (the N = 2**21 ones at
# the default N and seed): K7 keeps np.add.at's order, so they may not move
SIM_RECORDED = {
    "batch K=8 uniform static": (129, 270550648, 17, 6102, 0),
    "batch K=8 uniform dynamic": (129, 270550648, 17, 6102, 0),
    "out-degree order K=8 static": (373, 344636619, 1380, 26675, 0),
    "out-degree order K=8 dynamic": (216, 291079727, 684, 24411, 49),
    "sequential N=1000 out-degree K=16 uniform dynamic": (79, 39324, 444,
                                                          5976, 48),
}
# K1's input (b) is the round after this many of the frontier:pallas solve
LATE_ROUNDS = 3000
GIN_SHAPE = "ogb_products"
# power_law_graph exponent of the GIN graph: its seed-0 graph at 2,449,029
# nodes has 61,209,125 edges, under the cell's 61,859,328 (alpha 1.65
# expects 64.1M edge stubs, over it)
GIN_ALPHA = 1.655
LM_ARCH = "qwen1.5-0.5b"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_l1(a, b) -> float:
    a = a.double()
    b = b.double()
    return float((a - b).abs().sum() / max(float(b.abs().sum()), 1e-300))


def invariant(b, f_nodes, h_nodes, src, dst, wgt):
    """|B - (I-P)H - F|_1 in float64 on the host, and its bound."""
    ph = np.bincount(dst, weights=h_nodes[src] * wgt, minlength=b.size)
    viol = float(np.abs(b - h_nodes + ph - f_nodes).sum())
    return viol, 1e-4 * float(np.abs(b).sum() + np.abs(h_nodes).sum())


def random_fluid(torch, rng, n, n_pad, c, dev):
    """[n_pad, C] fluid around 1/N like the solver's, with a per-block-row
    scale so that some block columns fall under the occupancy threshold;
    the padding rows 0."""
    f = rng.standard_normal((n_pad, c)) / n
    f *= 10.0 ** rng.uniform(-1, 1, size=(n_pad // BS, 1, 1)).repeat(
        BS, axis=1).reshape(n_pad, 1)
    f[n:] = 0.0
    return torch.as_tensor(f, dtype=torch.float32, device=dev)


def median_threshold(torch, f, w):
    """The median of the nonzero |f|·w (the first 2**24 of them)."""
    fw = (f.abs() * w[:, None]).flatten()
    return torch.quantile(fw[fw > 0].float().cpu()[:2**24], 0.5).to(f.device)


def k1_operands(torch, mat, f, w, t, tau):
    """What ops.frontier_round_bsr hands K1 for the fluid f [n_pad, C]."""
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


def late_round(torch, repro_torch, problem, device):
    """K1's input (b): the operands of round ``LATE_ROUNDS + 1`` of the
    frontier:pallas cold solve, from a session stopped after
    ``LATE_ROUNDS`` rounds, built from its driver's state as
    ops.frontier_round_bsr builds them.  Returns ``(operands, rounds
    run)``."""
    session = repro_torch.SolverSession(problem, "frontier:pallas",
                                        device=device, max_rounds=LATE_ROUNDS)
    session.solve()
    drv = session._driver
    f, t = drv.round_inputs()
    return (k1_operands(torch, drv.m, f[:, None], drv.w, t,
                        drv.occupancy_threshold), drv.rounds())


def armed_tiles(col_active, block_col) -> int:
    """The tiles K1 reads: those of armed block columns."""
    return int(col_active.bool()[block_col.long()].sum())


def k1_bytes(ins) -> int:
    """The bytes K1 must move for its operands ``ins``: the armed tiles, its
    index arrays, f read and written, wt and row_l1."""
    blocks, block_col, row_ptr, col_active, f3, wt = ins
    return (armed_tiles(col_active, block_col) * BS * BS * 4
            + block_col.numel() * 4 + row_ptr.numel() * 8
            + col_active.numel() * 4 + f3.numel() * 4 * 2 + wt.numel() * 4
            + f3.shape[0] * 4)


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

    def graphed(self, fn, iters: int) -> float:
        """Mean device milliseconds per call with the host's launch cost out
        of the way: ``iters`` calls captured in one CUDA graph (after two
        warm-up calls on a side stream), the graph replayed 3 times.  The
        host clock in a CPU rehearsal."""
        if not self.cuda:
            return self(fn, iters)
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        return self(graph.replay, 3, warmup=1) / iters


def least(timer, fns, iters):
    """{name: (least, greatest)} of two ``iters``-call means for each of
    ``fns``, timed in turns: the second round in reverse order, so that
    every function is timed once early and once late."""
    got = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k].append(timer(fns[k], iters))
    return {k: (min(v), max(v)) for k, v in got.items()}


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = n_flops / flops_per_s * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def device_share(torch, what, fn, untraced_ms=None):
    """One call of ``fn`` under torch.profiler: its wall, the device time of
    its kernels and their share of that wall (the profiler's own host cost
    included, so the share reads low), the share of ``untraced_ms`` (the
    same work's wall without the profiler) where given, and the kernels
    that took most."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # the kernels' own rows (the ops that launched them carry their time too)
    stats = sorted(((getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e3,
                     e.count, e.key) for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA),
                   reverse=True)
    stats = [st for st in stats if st[0] > 0]
    busy = sum(st[0] for st in stats)
    if busy == 0:
        print(f"{what} under torch.profiler: wall {wall:.3f} ms, device time "
              "not measured (the trace holds none)")
        return
    top = ", ".join(f"{key[:48]} x{n} {ms:.3f} ms" for ms, n, key in stats[:6])
    plain = ("" if untraced_ms is None else
             f", {100 * busy / untraced_ms:.1f} % of the {untraced_ms:.3f} ms "
             "untraced wall")
    print(f"{what} under torch.profiler: wall {wall:.3f} ms, device kernels "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} % of the traced wall"
          f"{plain}); top: {top}")


class _Captured(Exception):
    """Stops a forward at its first attention call (``first_attention``)."""


def first_attention(run):
    """The inputs of the first attention call of ``run(attention)``: layer
    0's q, k, v (views, as the model hands them to K6) and masks.  The
    forward stops there."""
    got = {}

    def capture(q, k, v, *, causal, kv_len=None):
        got.update(q=q, k=k, v=v, causal=causal, kv_len=kv_len)
        raise _Captured

    try:
        run(capture)
    except _Captured:
        return got
    fail("the forward never called its attention")


def lm_serving(args, torch, dev, timer, sync):
    """Phase 12: qwen1.5-0.5b served through ``launch.steps`` (requests A
    and B), K6 held to its plain version, the float32 whole-path check and
    K6's rows for the kernels line.  Returns ``(rows, summary)``."""
    import copy

    import torch.nn.functional as fn

    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.attention import attention_plain, flash_attention
    from repro_torch.kernels.attention.kernel import (
        ROUTES, SPLITS, decode_geometry, prefill_route, split_count)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import transformer

    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch(LM_ARCH)
    cfg = lm_shrink(spec.model_cfg) if args.lm_reduced else spec.model_cfg
    # (lm_token_batch step, batch, prompt tokens, decode steps): A batched
    # chat, B the 32k prompt of prefill_32k / decode_32k at batch 1
    requests = {"A": (0, 8, 64 if args.lm_reduced else 2048, 32),
                "B": (1, 1, 512 if args.lm_reduced else 32768, 16)}
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, seed=args.seed, device=dev)
    sync()
    n_par = sum(p.numel() for p in model.parameters())
    width = model.embed.element_size()
    print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff="
          f"{cfg.d_ff}, vocab {cfg.vocab}, {model.embed.dtype}: {n_par} "
          f"parameters ({n_par * width / 1e9:.3f} GB), drawn on the device "
          f"in {time.perf_counter() - t0:.3f} s")
    if n_par != cfg.n_params:
        fail(f"{n_par} parameters where the config counts {cfg.n_params}")
    prefill = build_cell_step(spec, spec.cells["prefill_32k"], model)
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)

    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if on_card else 0)
    # the kernel a prefill of this config runs on (reads csrc/attention.cu)
    route = prefill_route(cfg.dtype, cfg.head_dim) if on_card else None
    if on_card and not args.lm_reduced and route != "wgmma":
        fail(f"{cfg.name}'s prefill routes to {route}, not the wgmma kernel")

    def counted():
        # K6 launches, the split counts they ran with, summed, and the
        # prefill launches by route
        return (LAUNCHES["flash_attention"], SPLITS["flash_attention"],
                *ROUTES.values())

    def serve(name, step, b, s, n_steps):
        tokens = lm_token_batch(step, b, s, cfg.vocab, seed=args.seed)["tokens"]
        before = counted()
        held = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cache, logits = prefill({"tokens": tokens, "max_seq": s + n_steps})
        sync()
        t_pre = time.perf_counter() - t0
        after_prefill = counted()
        finite = logits.isfinite().all()
        toks = logits.argmax(-1)
        gen, walls, step_splits = [toks], [], []
        for _ in range(n_steps):
            last = (toks, cache["pos"])
            splits_before = SPLITS["flash_attention"]
            t0 = time.perf_counter()
            logits, cache = decode({"tokens": toks, "cache_k": cache["k"],
                                    "cache_v": cache["v"],
                                    "pos": cache["pos"]})
            toks = logits.argmax(-1)
            sync()
            walls.append(time.perf_counter() - t0)
            step_splits.append(SPLITS["flash_attention"] - splits_before)
            finite &= logits.isfinite().all()
            gen.append(toks)
        after_decode = counted()
        # (launches, splits) of the prefill and of the decode loop
        pre = [a - c for a, c in zip(after_prefill, before)]
        dec = [a - c for a, c in zip(after_decode, after_prefill)]
        k6 = pre[0] + dec[0]
        peak = ((torch.cuda.max_memory_allocated() - held) / 1e9 if on_card
                else 0.0)
        kv_gb = cache["k"].numel() * 2 * cache["k"].element_size() / 1e9
        step_ms = 1e3 * sum(walls) / len(walls)
        print(f"request {name}: {b} x {s} tokens, prefill wall "
              f"{t_pre * 1e3:.3f} ms; {n_steps} decode steps over a "
              f"{s + n_steps}-slot cache ({kv_gb:.3f} GB): wall per step "
              f"{step_ms:.3f} ms (first {walls[0] * 1e3:.3f}, min "
              f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}), "
              f"{b * 1e3 / step_ms:.1f} tok/s; K6 launches {k6} (prefill "
              f"{pre[0]}, decode {dec[0]}); device memory peak {peak:.3f} "
              f"GB above the {held / 1e9:.3f} GB held")
        if not bool(finite):
            fail(f"request {name}: logits not finite")
        if on_card:
            # decode step i attends over kv_len = s + i + 1 keys in each
            # layer, split as split_count says; prefill launches add none
            geometry = decode_geometry(cfg.dtype, cfg.head_dim)
            policy = [cfg.n_layers * split_count(
                b, cfg.n_heads, cfg.n_kv_heads, 1, s + i + 1, n_sm, geometry)
                for i in range(n_steps)]
            ran = [n // cfg.n_layers for n in step_splits]
            routes = dict(zip(ROUTES, pre[2:]))
            print(f"request {name}: decode splits per (batch row, kv head) "
                  f"as launched {min(ran)}-{max(ran)}, at most "
                  f"{b * cfg.n_kv_heads * max(ran)} CTAs per launch; "
                  f"prefill splits {pre[1]}; prefill launches by kernel "
                  f"{routes}")
            want = [cfg.n_layers, cfg.n_layers * n_steps, 0, policy,
                    {r: cfg.n_layers if r == route else 0 for r in ROUTES},
                    [0] * len(ROUTES)]
            got = [pre[0], dec[0], pre[1], step_splits, routes, dec[2:]]
            if got != want:
                fail(f"request {name}: K6 (prefill launches, decode "
                     f"launches, prefill splits, splits per decode step, "
                     f"prefill launches by kernel, decode launches counted "
                     f"as prefill) {got}, not {want}")
        return {"tokens": tokens, "cache": cache, "last": last,
                "splits": step_splits[-1] // cfg.n_layers,
                "gen": torch.stack(gen, 1), "prefill_s": t_pre,
                "step_ms": step_ms, "tok_s": b * 1e3 / step_ms,
                "launches": k6, "prefill_launches": pre, "decode_launches":
                dec, "peak_gb": peak, "b": b, "s": s}

    reset_launches()
    with torch.inference_mode():
        served = {name: serve(name, *shape)
                  for name, shape in requests.items()}
    path_launches = counted()
    print(f"LM path K6 launches: {path_launches[0]}, with {path_launches[1]} "
          f"decode splits in all")
    if on_card and path_launches[0] == 0:
        fail("K6 was never launched on the LM path")
    # each request's first prefill carries one-time costs (allocator
    # growth, library set-up for new shapes): time each once more, warm,
    # then trace one decode step after it
    with torch.inference_mode():
        for name, r in served.items():
            t0 = time.perf_counter()
            cache, logits = prefill({"tokens": r["tokens"],
                                     "max_seq": r["s"] + 1})
            sync()
            r["warm_prefill_s"] = time.perf_counter() - t0
            print(f"request {name}: prefill again, warm: "
                  f"{r['warm_prefill_s'] * 1e3:.3f} ms")
            if on_card:
                device_share(torch, f"request {name} decode step", lambda: (
                    decode({"tokens": logits.argmax(-1),
                            "cache_k": cache["k"], "cache_v": cache["v"],
                            "pos": cache["pos"]})), r["step_ms"])
            del cache, logits

    # ---- checks, off the path: K6 against its plain version --------------
    def check(tag, ins, q_start=None):
        """K6 on layer 0's inputs against the plain version; with
        ``q_start`` only the queries from there on are compared."""
        q, k, v = ins["q"], ins["k"], ins["v"]
        kw = {"causal": ins["causal"], "kv_len": ins["kv_len"]}
        out, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v,
                                                                     **kw)
        if q_start is None:
            plain = attention_plain(q, k, v, **kw)
        else:
            plain = attention_plain(q[:, :, q_start:], k, v, q_start=q_start,
                                    **kw)
            out = out[:, :, q_start:]
            again = again[:, :, q_start:]
        err = float((out.float() - plain.float()).abs().max())
        # the scale the bf16 error is read against: one bf16 ulp of the
        # largest output is 2**-7 of its power of two
        scale = float(plain.float().abs().max())
        same = torch.equal(out, again)
        print(f"K6 {tag}: q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{str(q.dtype)[6:]} causal {kw['causal']} kv_len "
              f"{kw['kv_len']}"
              f"{'' if q_start is None else f', from query {q_start} on'}"
              f": max abs err {err:.3e} (bound 3e-2) at max |plain| "
              f"{scale:.3e}, mean |plain| "
              f"{float(plain.float().abs().mean()):.3e}, relative L1 "
              f"{rel_l1(out, plain):.3e}, bit-identical relaunch {same}")
        if not (err <= 3e-2 and same):
            fail(f"K6 against its plain version at {tag}")
        return err

    caps, errs = {}, {}
    with torch.inference_mode():
        for name, r in served.items():
            caps[name + " prefill"] = first_attention(
                lambda att: transformer.prefill_step(
                    model, r["tokens"], attention=att))
            toks, pos = r["last"]
            caps[name + " decode"] = first_attention(
                lambda att: transformer.decode_step(
                    model, {"k": r["cache"]["k"], "v": r["cache"]["v"],
                            "pos": pos}, toks, attention=att))
        errs["A prefill"] = check("A prefill", caps["A prefill"])
        s_b = requests["B"][2]
        errs["B prefill"] = check("B prefill", caps["B prefill"],
                                  q_start=max(0, s_b - 1024))
        errs["A decode"] = check("A decode", caps["A decode"])
        errs["B decode"] = check("B decode", caps["B decode"])

        # ---- each decode's inputs in float32: K6 held tight --------------
        for name in ("A", "B"):
            ins = caps[name + " decode"]
            q, k, v = (ins[n].float() for n in "qkv")
            kw = {"causal": ins["causal"], "kv_len": ins["kv_len"]}
            splits_before = SPLITS["flash_attention"]
            out = flash_attention(q, k, v, **kw)
            ran = SPLITS["flash_attention"] - splits_before
            plain = attention_plain(q, k, v, **kw)
            diff = (out - plain).abs()
            over = int((diff > 1e-6 + 1e-5 * plain.abs()).sum())
            print(f"K6 {name} decode in float32: q {tuple(q.shape)} kv_len "
                  f"{kw['kv_len']}, {ran} split(s): max abs err "
                  f"{float(diff.max()):.3e} at mean |plain| "
                  f"{float(plain.abs().mean()):.3e} (max "
                  f"{float(plain.abs().max()):.3e}), relative L1 "
                  f"{rel_l1(out, plain):.3e}; {over} of {plain.numel()} "
                  f"outside rtol 1e-5 / atol 1e-6")
            if over or (on_card and name == "B" and ran < 2):
                fail(f"K6 {name} decode in float32 against its plain "
                     f"version (or B's not on the split path)")
            del q, k, v, out, plain, diff

        # ---- the whole path in float32: K6 against the plain attention ---
        a = served["A"]
        del served["B"]["cache"]
        m32 = copy.deepcopy(model).float()
        m32.cfg = dataclasses.replace(cfg, dtype=torch.float32)

        def teacher_forced(attention, n=8):
            cache, lg = transformer.prefill_step(
                m32, a["tokens"], max_seq=a["s"] + n, attention=attention)
            out = [lg]
            for i in range(n):
                lg, cache = transformer.decode_step(
                    m32, cache, a["gen"][:, i], attention=attention)
                out.append(lg)
            return torch.stack(out)

        t0 = time.perf_counter()
        l_k6 = teacher_forced(flash_attention)
        l_plain = teacher_forced(attention_plain)
        sync()
        e32 = rel_l1(l_k6, l_plain)
        print(f"float32 copy of the weights, request A prefill + 8 "
              f"teacher-forced decode steps, K6 against the plain "
              f"attention: logits {tuple(l_k6.shape)} finite "
              f"{bool(l_k6.isfinite().all())}, relative L1 {e32:.3e} "
              f"(bound 1e-4); {time.perf_counter() - t0:.1f} s")
        if not (bool(l_k6.isfinite().all()) and e32 <= 1e-4):
            fail("float32 logits with K6 disagree with the plain attention")
        del m32, l_k6, l_plain

        # ---- K6's rows: time, bound, plain version, library yardstick ----
        rows = []

        def row(name, tag, kernel, launches, iters, plain_iters, plain_fn=None,
                splits=None):
            # launches: this run's (launches, splits) at the shape.  With
            # splits (decode): K6 and the library call are also timed by
            # CUDA graph replay, where a call's host cost (tens of
            # microseconds, the kernel's order) does not starve the card
            ins = caps[tag]
            q, k, v = ins["q"], ins["k"], ins["v"]
            causal, kv_len = ins["causal"], ins["kv_len"]
            b, hq, sq, dh = q.shape
            sk = kv_len or k.shape[2]
            if causal:  # the (query, key) pairs under the mask
                pairs = sq * (sq + 1) // 2 if sq == sk else sq * sk
            else:
                pairs = sq * sk
            n_flops = 4.0 * b * hq * dh * pairs
            n_bytes = (2 * q.numel() + 2 * b * k.shape[1] * sk * dh) * (
                q.element_size())
            b_ms, b_by = bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S
                                  if q.dtype == torch.bfloat16
                                  else F32_FLOPS_PER_S)
            kw = {"causal": causal, "kv_len": kv_len}
            ks, vs = k[:, :, :sk], v[:, :, :sk]

            def lib_fn():
                return fn.scaled_dot_product_attention(q, ks, vs,
                                                       is_causal=causal)

            def k6_fn():
                return flash_attention(q, k, v, **kw)

            plain_fn = plain_fn or (lambda: attention_plain(q, k, v, **kw))
            out = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/attention.cu",
                "replaces": "src/repro/kernels/attention/kernel.py:75",
                "kernel": kernel,
                "launches": launches[0], "max_abs_err": errs[tag],
                "ms": timer(k6_fn, iters),
                "plain_ms": timer(plain_fn, plain_iters, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timer(lib_fn, iters),
                "shape": [b, hq, sq, sk, dh], "dtype": str(q.dtype)[6:],
                "causal": causal,
            }
            if splits is None and on_card:  # prefill: the rate reached
                print(f"K6 {tag} ({kernel}): {n_flops / out['ms'] / 1e9:.1f} "
                      f"TFLOP/s in {out['ms']:.4f} ms; library "
                      f"{n_flops / out['library_ms'] / 1e9:.1f} TFLOP/s in "
                      f"{out['library_ms']:.4f} ms; bound {b_ms:.4f} ms "
                      f"({n_flops / b_ms / 1e9:.1f} TFLOP/s)")
            if splits is not None:
                out.update(splits=splits,
                           graph_ms=timer.graphed(k6_fn, iters),
                           library_graph_ms=timer.graphed(lib_fn, iters))
            return out

        ra, rb = served["A"], served["B"]
        rows.append(row("flash_attention", "A prefill", route,
                        ra["prefill_launches"], 20, 5))
        rows.append(row("flash_attention_decode", "A decode", "decode",
                        ra["decode_launches"], 50, 10, splits=ra["splits"]))
        rows.append(row("flash_attention_decode_32k", "B decode", "decode",
                        rb["decode_launches"], 20, 5, splits=rb["splits"]))
        cb = caps["B prefill"]

        def plain_chunked(chunk=1024):
            # the whole layer's plain version, 1,024 queries at a time (one
            # [1, 16, 32768, 32768] float32 score matrix would be 69 GB)
            q = cb["q"]
            for lo in range(0, q.shape[2], chunk):
                attention_plain(q[:, :, lo:lo + chunk], cb["k"], cb["v"],
                                causal=True, q_start=lo)

        rows.append(row("flash_attention_prefill_32k", "B prefill", route,
                        rb["prefill_launches"], 3, 1,
                        plain_fn=plain_chunked))
    summary = "; ".join(
        f"request {n}: {r['b']} x {r['s']} prefill {r['prefill_s']:.3f} s "
        f"(warm {r['warm_prefill_s']:.3f} s), "
        f"{r['step_ms']:.3f} ms per decode step ({r['tok_s']:.1f} tok/s), "
        f"peak {r['peak_gb']:.3f} GB" for n, r in served.items())
    del caps, served, model
    if on_card:
        torch.cuda.empty_cache()
    return rows, f"LM ({cfg.name}): {summary}"


def simulator_phase(args, torch, dev, timer, g, problem, x_ref):
    """Phase 13: the K-PID simulator on the card (K7), its gates and K7's
    rows for the kernels line.  Returns ``(rows, summary)``."""
    import repro_torch
    from repro_torch.core import DistributedSimulator, SimulatorConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.sim_push import (
        sim_messages, sim_messages_plain, sim_push, sim_push_plain)
    from repro_torch.launch.paper_tables import ordered_system

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    class TimedSimulator(DistributedSimulator):
        """The simulator with each whole push (K7's messages, K7's sum and
        the remote |.| sums: ``_push``) timed on the card by a pair of CUDA
        events and its messages counted (``sizes``); the inputs of its
        largest push (``capture="largest"``), or of the first push nearest
        ``capture`` messages (an int), are copied, before the first event,
        for K7's checks."""

        def __init__(self, *a, capture=None, **kw):
            super().__init__(*a, **kw)
            self.capture, self.kept, self.events = capture, None, []
            self.sizes = []

        def _push(self, sel, pid, sent, n_e, counts, remote):
            self.sizes.append(n_e)
            if self.capture == "largest":
                better = self.kept is None or n_e > self.kept["n_e"]
            else:
                better = self.kept is None or (abs(n_e - self.capture)
                                               < abs(self.kept["n_e"]
                                                     - self.capture))
            if better:
                self.kept = dict(n_e=n_e, state=self._state.clone(),
                                 messages=(
                    sel.clone(), pid.clone(), sent.clone(), self.deg,
                    self.indptr, self.indices, self.edge_w,
                    self.owner.clone(), n_e),
                    push=(sel.clone(), pid.clone(), sent.clone(), n_e,
                          list(counts), list(remote)))
            if not on_card:
                return super()._push(sel, pid, sent, n_e, counts, remote)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            super()._push(sel, pid, sent, n_e, counts, remote)
            stop.record()
            self.events.append((start, stop))

        def push_ms(self):
            return (sum(a.elapsed_time(z) for a, z in self.events)
                    if on_card else None)

    def held(what, sim, res, p, b):
        """Convergence and the §2.2 invariant, F counting f and every
        outbox."""
        s_, d_, w_ = p.edge_list()
        f_all = (sim.f + sim.outbox.sum(0)).cpu().numpy()
        viol, bound = invariant(np.asarray(b), f_all, sim.h.cpu().numpy(),
                                s_, d_, w_)
        print(f"{what}: invariant |B-(I-P)H-F|_1 = {viol:.3e} (bound "
              f"{bound:.3e})")
        if not res.converged or viol > bound:
            fail(f"simulator {what}: converged {res.converged}, invariant "
                 f"{viol:.3e} > {bound:.3e}")

    def go(what, p, b, cls=DistributedSimulator, sim_kw=None, **kw):
        """One simulator run, the K7 counters zeroed just before and read
        just after, gated on each K7 kernel launched once per push and on
        the recorded counters (``SIM_RECORDED``)."""
        t0 = time.perf_counter()
        sim = cls(p, b, SimulatorConfig(**kw), **(sim_kw or {}))
        sync()
        setup = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        res = sim.run()
        sync()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in K7}
        print(f"{what}: converged {res.converged} wall {wall:.3f} s (set-up "
              f"{setup:.3f} s) steps {res.n_steps} n_edge_ops "
              f"{res.n_edge_ops} exchanges {res.n_exchanges} moves "
              f"{res.n_moves} cost_iterations {res.cost_iterations:.4f} "
              f"pushes {res.n_pushes}, K7 launches {json.dumps(launches)}")
        if on_card and not all(v == res.n_pushes > 0
                               for v in launches.values()):
            fail(f"simulator {what}: K7 launched {launches} times for "
                 f"{res.n_pushes} pushes")
        want = SIM_RECORDED.get(what)
        if want is not None and (what.startswith("sequential") or (
                problem.n == 2**21 and args.seed == 0)):
            got = (res.n_steps, res.n_edge_ops, res.n_exchanges,
                   res.n_pushes, res.n_moves)
            print(f"{what}: (steps, edge ops, exchanges, pushes, moves) "
                  f"{got}, recorded {want}")
            if got != want:
                fail(f"simulator {what} moved from its recorded counters")
        return sim, res, wall, launches

    def run(what, p, b, x=None, **kw):
        """:func:`go`, then convergence, the invariant and, where ``x`` is
        given, the distance to it."""
        sim, res, wall, launches = go(what, p, b, **kw)
        held(what, sim, res, p, b)
        if x is not None:
            # 2·target_error below N = 2e5: two converged schedules may
            # differ by that much
            tol = max(1e-5, 2 * problem.target_error)
            dx = float(np.abs(res.h.cpu().numpy() - x).sum())
            print(f"{what}: |h - x_segment_sum|_1 {dx:.3e} (bound {tol:.1e})")
            if dx > tol:
                fail(f"simulator {what}: |h - x_segment_sum|_1 {dx:.3e}")
        return sim, res, wall, launches

    def same_run(res, steps, ops, exchanges, move_log, h):
        return (steps == res.n_steps and ops == res.n_edge_ops
                and exchanges == res.n_exchanges and move_log == res.move_log
                and torch.equal(h, res.h.cpu()))

    t_phase = time.perf_counter()
    opts = dict(k=8, target_error=problem.target_error, eps=problem.eps,
                partition="uniform", mode="batch", record_every=100,
                device=args.device)
    p, b = problem.p, problem.b
    # the main path's runs carry no instrumentation: their walls are clean
    _, res_s, wall_s, n_s = run("batch K=8 uniform static", p, b, x_ref,
                                dynamic=False, **opts)
    _, res_d, wall_d, n_d = run("batch K=8 uniform dynamic", p, b, x_ref,
                                dynamic=True, **opts)
    # replay through the front door
    reset_launches()
    t0 = time.perf_counter()
    rep = repro_torch.solve(problem, "simulator", k=8, dynamic=True,
                            mode="batch", record_every=100,
                            device=args.device)
    sync()
    wall_r = time.perf_counter() - t0
    n_r = {k: LAUNCHES[k] for k in K7}
    same = same_run(res_d, rep.n_rounds, rep.n_ops,
                    rep.extras["n_exchanges"], rep.move_log,
                    torch.from_numpy(rep.x))
    print(f"replay (repro_torch.solve, dynamic): wall {wall_r:.3f} s steps "
          f"{rep.n_rounds} n_edge_ops {rep.n_ops} exchanges "
          f"{rep.extras['n_exchanges']} moves {len(rep.move_log)}; equal to "
          f"the dynamic run (steps, ops, exchanges, move log, h bits) {same}")
    if not same or (on_card and set(n_r.values()) != {res_d.n_pushes}):
        fail("simulator replay differs from the dynamic run")
    def whole_push(sim, push, reps=10):
        """A whole push (``_push``: K7's messages, K7's sum, the remote |.|
        sums) replayed ``reps`` times on ``sim``: its device kernels and
        copies a push (torch.profiler) and its stream time a push, back to
        back (CUDA events); ``(None, None)`` off the card."""
        if not on_card:
            return None, None
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def one():
            DistributedSimulator._push(sim, *push)

        one()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                one()
            sync()
        n = sum(e.count for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA)
        return n / reps, timer(one, reps)

    # K7's device time: both runs again with each push timed by CUDA events
    # (the static one keeping its largest push, the dynamic one the push
    # nearest the static run's median by messages), held to the clean runs
    push_ms, push_share, kept, whole = {}, {}, {}, {}
    median_n_e = None
    for what, res, wall, dyn in (("static", res_s, wall_s, False),
                                 ("dynamic", res_d, wall_d, True)):
        sim_t, res_t, wall_t, _ = go(
            f"batch K=8 uniform {what}, each push timed", p, b,
            cls=TimedSimulator,
            sim_kw=dict(capture=median_n_e if dyn else "largest"),
            dynamic=dyn, **opts)
        if not same_run(res, res_t.n_steps, res_t.n_edge_ops,
                        res_t.n_exchanges, res_t.move_log, res_t.h.cpu()):
            fail(f"simulator {what}: the timed run differs from the clean one")
        push_ms[what] = sim_t.push_ms()
        if push_ms[what] is not None:
            push_share[what] = push_ms[what] / 1e3 / wall
            print(f"{what}: the pushes' stream time (K7's messages, sum, "
                  f"remote |.| sums; the host's gaps inside a push included) "
                  f"{push_ms[what]:.3f} ms over {len(sim_t.events)} pushes, "
                  f"{push_ms[what] / len(sim_t.events):.4f} ms a push, "
                  f"{push_share[what]:.4f} of the clean run's {wall:.3f} s "
                  f"wall ({push_ms[what] / 1e3 / wall_t:.4f} of the timed "
                  f"run's {wall_t:.3f} s); equal to the clean run")
        if not dyn:
            kept["largest"] = sim_t.kept
            median_n_e = sorted(sim_t.sizes)[len(sim_t.sizes) // 2]
            print(f"static: pushes by messages: median {median_n_e}, largest "
                  f"{max(sim_t.sizes)}, smallest {min(sim_t.sizes)}")
        else:
            kept["median"] = sim_t.kept
            for at in ("largest", "median"):
                whole[at] = whole_push(sim_t, kept[at]["push"])
                print(f"a whole push at the {at} push ({kept[at]['n_e']} "
                      f"messages): {whole[at][0]} device kernels and copies, "
                      f"{whole[at][1]} ms of stream time back to back")
        del sim_t
    # Table 2's protocol at scale: the same graph ordered by out-degree
    t0 = time.perf_counter()
    g_out = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    prob_out = repro_torch.Problem.pagerank(g_out)
    print(f"out-degree order: host build {time.perf_counter() - t0:.1f} s")
    costs = {}
    for dyn in (False, True):
        _, r, wall, _ = run(
            f"out-degree order K=8 {'dynamic' if dyn else 'static'}",
            prob_out.p, prob_out.b, dynamic=dyn, **opts)
        costs[dyn] = (r.cost_iterations, r.n_moves, wall)
    # the paper-exact sequential schedule at the paper's N = 1000
    p1, b1 = ordered_system("out_degree")
    _, res_q, wall_q, n_q = run(
        "sequential N=1000 out-degree K=16 uniform dynamic", p1, b1,
        k=16, target_error=1e-3, eps=0.15, partition="uniform",
        dynamic=True, mode="sequential", record_every=100,
        device=args.device)

    # ---- K7 against its plain version (launches here are not the path's) --
    def k7_at(at):
        """K7 at the static run's largest or the dynamic run's median push,
        as the runs made them: each kernel held to its plain version on CPU
        copies, ``torch.equal``, and relaunched bit-identically; the push's
        nodes, messages, distinct targets and longest bucket."""
        c = kept[at]
        m_args = c["messages"]
        m_cpu = [a.cpu() if torch.is_tensor(a) else a for a in m_args]
        got_m = [sim_messages(*m_args) for _ in range(2)]
        want_m = sim_messages_plain(*m_cpu)
        ok_m = all(torch.equal(a.cpu(), w) and torch.equal(a, a2)
                   for a, a2, w in zip(got_m[0], got_m[1], want_m))
        key, msg = got_m[0][0], got_m[0][1]
        outs = []
        for _ in range(2):
            got = c["state"].clone()
            sim_push(got, key, msg)
            outs.append(got)
        want = c["state"].cpu()
        sim_push_plain(want, key.cpu(), msg.cpu())
        ok = torch.equal(outs[0].cpu(), want) and torch.equal(outs[0], outs[1])
        targets, counts = torch.unique(key, return_counts=True)
        out = dict(m_args=m_args, key=key, msg=msg, state=c["state"],
                   err_m=float((got_m[0][1].cpu() - want_m[1]).abs().max()),
                   err=float((outs[0].cpu() - want).abs().max()),
                   nodes=m_args[0].numel(), messages=m_args[-1],
                   targets=int(targets.numel()), longest=int(counts.max()))
        print(f"K7 at the {at} push ({out['nodes']} nodes, {out['messages']} "
              f"messages, {int((key < problem.n).sum())} of them local, "
              f"{out['targets']} distinct targets, the longest bucket "
              f"{out['longest']}): messages (key, msg, |remote msg|) equal to "
              f"the plain version on the CPU and relaunch bit-identical "
              f"{ok_m}; the sum likewise {ok}")
        if not (ok_m and ok):
            fail(f"K7 differs from its plain version at the {at} push")
        return out

    at = {w: k7_at(w) for w in ("largest", "median")}
    # the paper's N = 1000 graph: nodes with no out-edge among the selected,
    # every PID's, and an empty selection (no launch)
    gen = np.random.default_rng(args.seed + 7)
    csr = [torch.as_tensor(a, device=dev) for a in (
        np.diff(p1.indptr), p1.indptr, p1.indices.astype(np.int64),
        p1.weights)]
    owner_syn = torch.as_tensor(gen.integers(0, 4, p1.n).astype(np.int32),
                                device=dev)
    for what, n_sel in (("mixed", 600), ("empty", 0)):
        sel_syn = torch.as_tensor(gen.choice(p1.n, n_sel, replace=False),
                                  device=dev)
        pid_syn = torch.as_tensor(gen.integers(0, 4, n_sel), device=dev)
        sent_syn = torch.as_tensor(gen.standard_normal(n_sel), device=dev)
        n_e_syn = int(csr[0][sel_syn].sum())
        before = LAUNCHES["sim_messages"]
        args_syn = (sel_syn, pid_syn, sent_syn, *csr, owner_syn, n_e_syn)
        got_syn = sim_messages(*args_syn)
        want_syn = sim_messages_plain(*[a.cpu() if torch.is_tensor(a) else a
                                        for a in args_syn])
        ok = all(torch.equal(a.cpu(), w) for a, w in zip(got_syn, want_syn))
        if n_sel == 0:
            ok = ok and LAUNCHES["sim_messages"] == before
        dangling = int((csr[0][sel_syn] == 0).sum())
        print(f"K7 messages, synthetic, {what} ({n_sel} nodes, {dangling} "
              f"without an out-edge, {n_e_syn} messages): equal to the plain "
              f"version {ok}")
        if not ok:
            fail(f"K7's messages, synthetic ({what})")
    n_syn = 4096
    for what, e, lo in (("repeated keys", 200_000, 0),
                        ("all remote", 20_000, n_syn), ("empty", 0, 0)):
        k_syn = torch.as_tensor(gen.choice(np.arange(lo, 4 * n_syn), 300)[
            gen.integers(0, 300, e)].astype(np.int32), device=dev)
        m_syn = torch.as_tensor(gen.standard_normal(e) * 10.0 ** gen.uniform(
            -9, 2, e), device=dev)
        s_syn = torch.as_tensor(gen.standard_normal(4 * n_syn), device=dev)
        got = s_syn.clone()
        before = LAUNCHES["sim_push"]
        sim_push(got, k_syn, m_syn)
        want_syn = s_syn.cpu()
        sim_push_plain(want_syn, k_syn.cpu(), m_syn.cpu())
        ok = torch.equal(got.cpu(), want_syn)
        if e == 0:
            ok = ok and LAUNCHES["sim_push"] == before
        print(f"K7 synthetic push, {what} ({e} messages): equal to its plain "
              f"version {ok}")
        if not ok:
            fail(f"K7 synthetic push ({what})")

    # ---- K7's numbers at the captured pushes -------------------------------
    def numbers(c):
        """Both kernels at one push: ms (the whole wrapper, 50-call means),
        the plain versions' ms and the bounds; ``index_add_``, which is also
        sim_push's plain version, as its library call."""
        n_sel, n_e = c["nodes"], c["messages"]
        # each node (id, PID, fluid, out-degree, row start) read once, each
        # message's edge (destination, weight, its owner) read once, each
        # message (key, value, |remote value|) written once; a multiply each
        m_bound = bound_ms(n_sel * 40 + n_e * 20 + n_e * 20, n_e,
                           flops_per_s=F64_FLOPS_PER_S)
        state, key, msg = c["state"].clone(), c["key"], c["msg"]
        # each message (int32 key, float64 value) read once, each distinct
        # target read and written once; one float64 add a message
        p_bound = bound_ms(
            key.numel() * (key.element_size() + msg.element_size())
            + c["targets"] * 2 * state.element_size(), key.numel(),
            flops_per_s=F64_FLOPS_PER_S)
        return (dict(ms=timer(lambda: sim_messages(*c["m_args"]), 50),
                     plain_ms=timer(lambda: sim_messages_plain(*c["m_args"]),
                                    20),
                     bound=m_bound),
                dict(ms=timer(lambda: sim_push(state, key, msg), 50),
                     plain_ms=timer(lambda: sim_push_plain(state, key, msg),
                                    50),
                     library_ms=timer(lambda: state.index_add_(0, key, msg),
                                      50),
                     bound=p_bound))

    (m_l, p_l), (m_m, p_m) = numbers(at["largest"]), numbers(at["median"])
    big, mid = at["largest"], at["median"]
    print(f"K7 at the median push ({mid['messages']} messages): sim_messages "
          f"{m_m['ms']:.4f} ms (bound {m_m['bound'][0]:.4f}, plain "
          f"{m_m['plain_ms']:.4f}), sim_push {p_m['ms']:.4f} ms (bound "
          f"{p_m['bound'][0]:.4f}, index_add_ {p_m['library_ms']:.4f}); a "
          f"whole push: {whole['largest'][0]} / {whole['median'][0]} device "
          f"kernels and copies, {whole['largest'][1]} / {whole['median'][1]} "
          "ms of stream time back to back (largest / median)")
    rows = [{
        "name": "sim_messages", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_push.cu",
        "replaces": "src/repro/core/simulator.py:300",
        "launches": n_s["sim_messages"] + n_d["sim_messages"],
        "max_abs_err": big["err_m"],
        "ms": m_l["ms"], "plain_ms": m_l["plain_ms"],
        "bound_ms": m_l["bound"][0], "bound_by": m_l["bound"][1],
        "library_ms": None,
        "nodes": big["nodes"], "messages": big["messages"],
        # the same at the median push (by messages)
        "median_ms": m_m["ms"], "median_plain_ms": m_m["plain_ms"],
        "median_bound_ms": m_m["bound"][0], "median_nodes": mid["nodes"],
        "median_messages": mid["messages"],
    }, {
        "name": "sim_push", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_push.cu",
        "replaces": "src/repro/core/simulator.py:304",
        "launches": n_s["sim_push"] + n_d["sim_push"],
        "max_abs_err": big["err"],
        # the whole kernel path: the wrapper and its one launch
        "ms": p_l["ms"], "plain_ms": p_l["plain_ms"],
        "bound_ms": p_l["bound"][0], "bound_by": p_l["bound"][1],
        "library_ms": p_l["library_ms"],
        "messages": big["messages"], "targets": big["targets"],
        "longest_bucket": big["longest"],
        "median_ms": p_m["ms"], "median_plain_ms": p_m["plain_ms"],
        "median_bound_ms": p_m["bound"][0],
        "median_library_ms": p_m["library_ms"],
        "median_messages": mid["messages"], "median_targets": mid["targets"],
        "median_longest_bucket": mid["longest"],
        # the whole push (messages, sum, remote |.| sums): summed over a run
        # and its share of the clean run's wall; its device kernels and
        # copies and its stream time, replayed at the two pushes
        "push_device_ms": push_ms, "push_wall_share": push_share,
        "push_launches": {k: v[0] for k, v in whole.items()},
        "push_stream_ms": {k: v[1] for k, v in whole.items()},
    }]
    summary = (
        f"simulator (N={problem.n}, K=8, batch): static {wall_s:.3f} s "
        f"{res_s.n_steps} steps cost {res_s.cost_iterations:.4f}, dynamic "
        f"{wall_d:.3f} s {res_d.n_steps} steps cost "
        f"{res_d.cost_iterations:.4f} {res_d.n_moves} moves, replay "
        f"{wall_r:.3f} s; out-degree order static cost {costs[False][0]:.4f}"
        f" ({costs[False][2]:.3f} s), dynamic {costs[True][0]:.4f} "
        f"({costs[True][1]} moves, {costs[True][2]:.3f} s); sequential "
        f"N=1000 K=16 {wall_q:.3f} s cost {res_q.cost_iterations:.4f} "
        f"({res_q.n_pushes} pushes); the pushes' device share of the wall "
        f"{json.dumps(push_share)}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows, summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2**21,
                    help="nodes of the host_block_graph (default 2**21)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fm-vocab", type=int, default=1_000_000,
                    help="FM rows per field (default 10**6, the fm config)")
    ap.add_argument("--gin-nodes", type=int, default=None,
                    help="nodes of the GIN graph (default: the ogb_products "
                    "cell's 2,449,029, padded to the cell's N and E)")
    ap.add_argument("--lm-reduced", action="store_true",
                    help="phase 12 on the reduced LM config (2 layers, "
                    "float32) with 64- and 512-token prompts")
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
        FRONTIER_ROUTES, ROUTES as K2_ROUTES, BsrMatrix, bsr_spmm,
        bsr_spmm_kernel, bsr_spmm_plain, bsr_spmm_route, frontier_round_bsr,
        frontier_round_bsr_kernel, frontier_round_bsr_plain,
        launch_bsr_spmm, launch_frontier_round_bsr)
    from repro_torch.kernels.edge_sum import (
        csc_edges, edge_sum, edge_sum_plain)
    from repro_torch.balance import MovePlan
    from repro_torch.core import pagerank_system, power_law_graph
    from repro_torch.kernels.diffusion import engine_tile_push
    from repro_torch.configs import fm as fm_config
    from repro_torch.configs import gin_tu
    from repro_torch.configs.gnn_common import SHAPE_DIMS
    from repro_torch.data import (
        criteo_like_batch, make_gnn_batch, pad_gnn_batch)
    from repro_torch.kernels.fm import fm_interaction_kernel, fm_interaction_ref
    from repro_torch.kernels.segment import (
        CHUNK_ROWS, FORMS, segment_sum_ref, segment_sum_sorted)
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import gnn, recsys

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
        return random_fluid(torch, rng, g.n, n_pad, c, dev)

    def simt_bits(ins, out, l1):
        """K1's bulk output against its simt body's, launched apart (counted
        nowhere): the same bits.  True in a rehearsal."""
        if not on_card:
            return True
        out_s, l1_s, _ = launch_frontier_round_bsr(*ins, route="simt")
        return torch.equal(out, out_s) and torch.equal(l1, l1_s)

    # the same tiles on the CPU, for the cross-device predicate check
    m_cpu = BsrMatrix(tiles.blocks, tiles.block_row, tiles.block_col,
                      tiles.n_row_blocks, BS, device="cpu")
    timing_inputs = {}
    for c in (1, 8):
        for tau in (0.0, 0.5):
            f = fluid(c)
            t = median_threshold(torch, f, w)
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
            ins = k1_operands(torch, m, f, w, t, tau)
            out_k, l1_k = frontier_round_bsr_kernel(*ins)
            out_k2, l1_k2 = frontier_round_bsr_kernel(*ins)
            out_p, l1_p = frontier_round_bsr_plain(*ins)
            armed = int(ins[3].sum())
            e_f, e_l1 = rel_l1(out_k, out_p), rel_l1(l1_k, l1_p)
            same = torch.equal(out_k, out_k2) and torch.equal(l1_k, l1_k2)
            simt = simt_bits(ins, out_k, l1_k)
            print(f"K1 C={c} tau={tau}: armed columns {armed}/"
                  f"{m.n_row_blocks}, sent nodes {int((sent != 0).sum())}, "
                  f"rel L1 f_new {e_f:.3e} row_l1 {e_l1:.3e}, "
                  f"bit-identical relaunch {same}, route "
                  f"{launch_frontier_round_bsr(*ins)[2] if on_card else None}"
                  f", the simt body's bits {simt}")
            if not (e_f <= REL_L1 and e_l1 <= REL_L1 and same and simt):
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
    t = median_threshold(torch, f, w)
    ins = k1_operands(torch, m_odd, f, w, t, 0.0)
    out_k, l1_k = frontier_round_bsr_kernel(*ins)
    out_p, l1_p = frontier_round_bsr_plain(*ins)
    empty = ~m_odd.row_occupied
    kept = torch.where(f.abs() * (w / t)[:, None] > 1.0,
                       torch.zeros_like(f), f).reshape(out_k.shape)
    ok_empty = torch.equal(out_k[empty], kept[empty])
    e_f = rel_l1(out_k, out_p)
    simt = simt_bits(ins, out_k, l1_k)
    print(f"K1 interleaved empty rows: {int(empty.sum())} empty, kept "
          f"fluid exact {ok_empty}, rel L1 {e_f:.3e}, the simt body's bits "
          f"{simt}")
    if not (ok_empty and e_f <= REL_L1 and simt):
        fail("K1 interleaved empty rows")
    # input (b): a late round of the cold solve
    t0 = time.perf_counter()
    ins, late_rounds = late_round(torch, repro_torch, problem, args.device)
    out_k, l1_k = frontier_round_bsr_kernel(*ins)
    out_p, l1_p = frontier_round_bsr_plain(*ins)
    e_f, e_l1 = rel_l1(out_k, out_p), rel_l1(l1_k, l1_p)
    simt = simt_bits(ins, out_k, l1_k)
    n_tiles = ins[1].numel()
    print(f"K1 late round (input b: after {late_rounds} rounds of "
          f"frontier:pallas, {time.perf_counter() - t0:.1f} s): armed "
          f"columns {int(ins[3].sum())}/{m.n_row_blocks}, armed tiles "
          f"{armed_tiles(ins[3], ins[1])}/{n_tiles}, rel L1 f_new {e_f:.3e} "
          f"row_l1 {e_l1:.3e}, the simt body's bits {simt}")
    if not (e_f <= REL_L1 and e_l1 <= REL_L1 and simt):
        fail("K1 late round")
    timing_inputs["k1_late"] = (ins, float((out_k - out_p).abs().max()))
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
            # the simt body, launched apart (counted nowhere): the same bits
            simt = (torch.equal(a, launch_bsr_spmm(
                mat.blocks, mat.visit_block, mat.block_col, mat.row_ptr, x,
                route="simt")[0]) if on_card else True)
            print(f"K2 C={c} {name}: rel L1 {e:.3e}, empty rows exactly 0 "
                  f"{zero}, bit-identical relaunch {same}, route "
                  f"{bsr_spmm_route(BS, c)}, the simt body's bits {simt}")
            if not (e <= REL_L1 and zero and same and simt):
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

    def recorded(name, rep):
        """Prints a solve's rounds and pushes beside the recorded ones; at
        the default N and seed they must agree."""
        want = RECORDED[name]
        print(f"{name}: rounds {rep.n_rounds} pushes {rep.n_ops} (recorded "
              f"at N=2**21, seed 0: rounds {want[0]} pushes {want[1]})")
        if (args.n == 2**21 and args.seed == 0
                and (rep.n_rounds, rep.n_ops) != want):
            fail(f"{name} moved from its recorded rounds and pushes")

    # ---- 4. main path ------------------------------------------------------
    print("== phase 4: main path")
    k2_routes0 = dict(K2_ROUTES)  # K2's launches by body, phases 4-7
    k1_routes0 = dict(FRONTIER_ROUTES)  # K1's, phases 4-5
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
    recorded("frontier:pallas", rep)
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
    viol, bound = invariant(b, f_nodes, h_nodes, src, dst, wgt)
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
          f"(float32 card via bsr_spmm), bound {bound:.3e}")
    if not cold.converged or viol > bound or viol_dev > bound:
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
    k1_routes = {k: v - k1_routes0[k] for k, v in FRONTIER_ROUTES.items()}
    print(f"main path launches (phases 4-5): {json.dumps(main_launches)}; "
          f"K2 launches of the invariant check {check_launches}; K1's by "
          f"body {json.dumps(k1_routes)}")
    if on_card and k1_routes != {
            "bulk": main_launches["frontier_round_bsr"], "simt": 0}:
        fail(f"K1 launches of phases 4-5 not all on the bulk body: "
             f"{k1_routes}")
    if on_card:
        missing = [k for k in ON_PATH if main_launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- 6. engine kernels at the engine's shapes --------------------------
    print("== phase 6: engine kernels")
    t0 = time.perf_counter()
    s_bsr = repro_torch.SolverSession(problem, "engine:bsr",
                                      device=args.device, **ENGINE_OPTS)
    sync()
    build_bsr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_chk = repro_torch.SolverSession(problem, "engine:chunk",
                                      device=args.device, **ENGINE_OPTS)
    sync()
    build_chk_s = time.perf_counter() - t0
    eng, visits = s_bsr._driver.engine, s_bsr._driver.ex.table
    ecfg, ea = eng.cfg, eng.a
    k_e, r_e, s_e = ecfg.k, ea.n_rows, ea.bucket_size
    pool_tiles = eng.pool.shape[0]
    print(f"engine:bsr layout: k={k_e} R={r_e} rows (B_loc="
          f"{ecfg.buckets_per_dev}, headroom {ecfg.headroom}) S={s_e} "
          f"T={pool_tiles // r_e}; tile pool {pool_tiles} tiles "
          f"({pool_tiles * s_e * s_e * 4 / 1e9:.3f} GB), visits (real "
          f"tiles) {visits.n_visits} = sum t_counts "
          f"{int(ea.t_counts.sum())}; build wall {build_bsr_s:.3f} s")
    edges_e = s_chk._driver.ex.table
    ca = s_chk._driver.engine.a
    print(f"engine:chunk layout: R={ca.n_rows} S={ca.bucket_size} "
          f"E={ca.edge_cap}: {ca.n_rows * ca.edge_cap} edge slots, "
          f"{edges_e.n_edges} real edges (links {g.n_edges}); build wall "
          f"{build_chk_s:.3f} s")
    if visits.n_visits != int(ea.t_counts.sum()) or (
            edges_e.n_edges != g.n_edges):
        fail("the engine tables do not hold exactly the real tiles/edges")
    sent_e = torch.as_tensor(
        rng.standard_normal((r_e, s_e)) / g.n * (ea.w != 0),
        dtype=torch.float32, device=dev)
    x3_e = sent_e[:, :, None].contiguous()

    def k2_engine_plain(chunk: int = 1024):
        """K2's plain twin over visit chunks (the whole table would gather
        a copy of every visited tile at once)."""
        out = torch.zeros((k_e * r_e, s_e, 1), dtype=torch.float32,
                          device=dev)
        v = visits.n_visits
        for lo in range(0, v, chunk):
            hi = min(lo + chunk, v)
            ptr = visits.row_ptr.clamp(lo, hi) - lo
            out += bsr_spmm_plain(eng.pool, visits.visit_block[lo:hi],
                                  visits.visit_col[lo:hi], ptr, x3_e)
        return out[..., 0]

    a2 = engine_tile_push(eng.pool, visits, sent_e)
    a2b = engine_tile_push(eng.pool, visits, sent_e)
    p2 = k2_engine_plain()
    e2, same2 = rel_l1(a2, p2), torch.equal(a2, a2b)
    # the simt body over the same visits (launched apart, counted nowhere)
    simt2 = (torch.equal(a2, launch_bsr_spmm(
        eng.pool, visits.visit_block, visits.visit_col, visits.row_ptr,
        x3_e, route="simt")[0][..., 0]) if on_card else True)
    print(f"K2 engine visit table: {visits.n_visits} visits into "
          f"{k_e * r_e} output rows, rel L1 {e2:.3e}, bit-identical "
          f"relaunch {same2}, route {bsr_spmm_route(s_e, 1)}, the simt "
          f"body's bits {simt2}")
    if not (e2 <= REL_L1 and same2 and simt2):
        fail("K2 over the engine visit table")
    # the engine:chunk layout has its own sizing (buckets_per_dev)
    xe = torch.as_tensor(
        (rng.standard_normal((ca.n_rows, ca.bucket_size)) / g.n
         * (ca.w != 0)).reshape(-1), dtype=torch.float32, device=dev)
    a3, a3b = edge_sum(xe, edges_e), edge_sum(xe, edges_e)
    p3 = edge_sum_plain(xe, edges_e.indptr, edges_e.src, edges_e.wgt)
    e3, same3 = rel_l1(a3, p3), torch.equal(a3, a3b)
    print(f"K3 engine edge table: {edges_e.n_edges} edges into "
          f"{edges_e.n} outputs, rel L1 {e3:.3e}, bit-identical relaunch "
          f"{same3}")
    if not (e3 <= REL_L1 and same3):
        fail("K3 over the engine edge table")
    timing_inputs["k2e"] = float((a2 - p2).abs().max())
    timing_inputs["k3e"] = float((a3 - p3).abs().max())
    del a2, a2b, p2, a3, a3b, p3

    # ---- 7. engine main path -----------------------------------------------
    print("== phase 7: engine main path")
    engine_launches = {k: 0 for k in LAUNCHES}

    def bank():
        for k, v in LAUNCHES.items():
            engine_launches[k] += v

    def engine_gates(name, session, rep, kernel, b_vec):
        f_e, h_e = session._driver.fluid()
        viol, bound = invariant(b_vec, f_e, h_e, src, dst, wgt)
        print(f"{name}: converged {rep.converged} residual "
              f"{rep.residual:.6e} rounds {rep.n_rounds} chunks "
              f"{rep.extras['chunks']} ops {rep.n_ops} moves "
              f"{len(rep.move_log)} wall {rep.wall_time_s:.3f} s; "
              f"{kernel} launches {LAUNCHES[kernel]}; invariant "
              f"{viol:.3e} (bound {bound:.3e})")
        if not rep.converged or viol > bound:
            fail(f"{name}: not converged or invariant broken")
        if on_card and LAUNCHES[kernel] != rep.n_rounds:
            fail(f"{name}: {kernel} launched {LAUNCHES[kernel]} times in "
                 f"{rep.n_rounds} rounds")

    reset_launches()
    rep_bsr = s_bsr.solve()
    engine_gates("engine:bsr cold", s_bsr, rep_bsr, "bsr_spmm", problem.b)
    recorded("engine:bsr cold", rep_bsr)
    bank()
    reset_launches()
    rep_chk = s_chk.solve()
    engine_gates("engine:chunk cold", s_chk, rep_chk, "edge_sum", problem.b)
    # K3 over the engine's edge table: the engine:chunk rounds only (the
    # warm request's K3 launch runs over the node-space edge list)
    k3_engine_launches = LAUNCHES["edge_sum"]
    bank()
    # two converged schedules each sit within target_error of the answer
    # in L1 (|x - x*|_1 <= |F|_1/eps), so they may differ by twice that:
    # below 1e-5 from N = 2e5 on (9.5e-7 at N = 2**21)
    dx_bound = max(1e-5, 2.0 * problem.target_error)
    for name, rep_e in (("engine:bsr", rep_bsr), ("engine:chunk", rep_chk)):
        dx = float(np.abs(rep_e.x - rep_ss.x).sum())
        print(f"{name}: |x - x_segment_sum|_1 {dx:.3e} (bound "
              f"{dx_bound:.1e}); move log {rep_e.move_log[:6]}")
        if dx > dx_bound:
            fail(f"{name} cross-path check")
    del s_chk
    reset_launches()
    s_fm = repro_torch.SolverSession(problem, "engine:bsr",
                                     device=args.device, **ENGINE_OPTS)
    list(s_fm.run(max_rounds=1))  # the first chunk
    first_rounds = s_fm.n_rounds
    moved = s_fm._driver.ex.apply(MovePlan(src=0, dst=3, units=2,
                                           kind="bucket"))
    sizes = s_fm._driver.ex.sizes().tolist()
    print(f"forced move after the first chunk ({first_rounds} rounds): "
          f"{moved} buckets 0 -> 3, real buckets per PID now {sizes}")
    if moved != 2:
        fail(f"the forced move moved {moved} buckets")
    rep_fm = s_fm.solve()
    engine_gates("engine:bsr forced move", s_fm, rep_fm, "bsr_spmm",
                 problem.b)
    recorded("engine:bsr forced move", rep_fm)
    dx = float(np.abs(rep_fm.x - rep_ss.x).sum())
    print(f"engine:bsr forced move: |x - x_segment_sum|_1 {dx:.3e}")
    if dx > dx_bound:
        fail("engine:bsr forced move cross-path check")
    bank()
    del s_fm
    if on_card:
        torch.cuda.empty_cache()
    reset_launches()
    b_new = np.abs(problem.b * (1.0 + 0.05 * rng.standard_normal(g.n)))
    resid0 = s_bsr.warm_start(b_new)
    warm_e = s_bsr.solve()
    k3_warm_launches = LAUNCHES["edge_sum"]
    print(f"engine:bsr warm request: |F'|_1 {resid0:.6e}; K3 launches "
          f"(P.H) {k3_warm_launches}")
    if on_card and k3_warm_launches != 1:
        fail(f"the engine warm seed launched K3 {k3_warm_launches} times")
    engine_gates("engine:bsr warm", s_bsr, warm_e, "bsr_spmm", b_new)
    recorded("engine:bsr warm", warm_e)
    if not warm_e.n_ops < rep_bsr.n_ops:
        fail(f"engine warm request used {warm_e.n_ops} ops, cold "
             f"{rep_bsr.n_ops}")
    bank()
    print(f"engine path launches (phase 7): {json.dumps(engine_launches)}")
    k2_routes = {k: v - k2_routes0[k] for k, v in K2_ROUTES.items()}
    print(f"K2 launches by body, phases 4-7: {k2_routes}")
    if on_card:
        missing = [k for k in ENGINE_PATH if engine_launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the engine path: {missing}")
        if k2_routes["simt"] or k2_routes["bulk"] < (
                check_launches + engine_launches["bsr_spmm"]):
            fail(f"K2 launches of phases 4-7 not all on the bulk route: "
                 f"{k2_routes}")

    # ---- 8. replay: moves fire ---------------------------------------------
    print("== phase 8: replay")
    g_r = power_law_graph(1600, seed=7)
    g_r = g_r.reorder(np.argsort(-g_r.out_degree(), kind="stable"))
    p_r, b_r = pagerank_system(g_r)
    x_dense = np.linalg.solve(np.eye(g_r.n) - p_r.to_dense(), b_r)
    prob_r = repro_torch.Problem.pagerank(g_r, target_error=1e-8)
    logs = {}
    k2_routes0 = dict(K2_ROUTES)
    reset_launches()
    for method in ("engine:chunk", "engine:bsr"):
        rep_r = repro_torch.solve(prob_r, method=method, device=args.device,
                                  k=8, dynamic=True, buckets_per_dev=40,
                                  headroom=8, eta=0.9)
        err = float(np.abs(rep_r.x - x_dense).max())
        logs[method] = rep_r.move_log
        print(f"replay {method}: converged {rep_r.converged} rounds "
              f"{rep_r.n_rounds} ops {rep_r.n_ops} max |x - x_dense| "
              f"{err:.3e} moves {rep_r.move_log}")
        if not (rep_r.converged and err < 1e-5 and rep_r.move_log):
            fail(f"replay {method}")
    if logs["engine:chunk"] != logs["engine:bsr"]:
        fail("the two engine backends made different moves")
    # the replay's tiles are as wide as its buckets: K2's rule picks the
    # body (7 slots: simt, the bulk copies need bs % 4 == 0)
    k2_routes = {k: v - k2_routes0[k] for k, v in K2_ROUTES.items()}
    slots = repro_torch.SolverSession(
        prob_r, "engine:bsr", device=args.device, k=8, buckets_per_dev=40,
        headroom=8)._driver.engine.a.bucket_size
    replay_route = bsr_spmm_route(slots, 1)
    print(f"replay K2 launches by body: {k2_routes} (the rule's route for "
          f"its {slots}-slot tiles: {replay_route})")
    if on_card and k2_routes != {
            k: LAUNCHES["bsr_spmm"] if k == replay_route else 0
            for k in K2_ROUTES}:
        fail(f"replay K2 launches {LAUNCHES['bsr_spmm']} not all on "
             f"{replay_route}: {k2_routes}")

    # ---- 9. FM serving -----------------------------------------------------
    print("== phase 9: FM serving")
    spec = fm_config.spec()
    fm_cfg = dataclasses.replace(spec.model_cfg,
                                 vocab_per_field=args.fm_vocab)
    nf, dim = fm_cfg.n_fields, fm_cfg.embed_dim
    t0 = time.perf_counter()
    fm_model = recsys.FM(fm_cfg, seed=args.seed, device=dev)
    sync()
    print(f"fm: table {fm_cfg.n_rows} x {dim} "
          f"({fm_cfg.n_rows * dim * 4 / 1e9:.3f} GB f32) + lin_table, drawn "
          f"on the device in {time.perf_counter() - t0:.3f} s")
    steps = {name: build_cell_step(spec, spec.cells[name], fm_model)
             for name in ("serve_p99", "serve_bulk", "retrieval_cand")}
    t0 = time.perf_counter()
    p99 = [criteo_like_batch(i, spec.cells["serve_p99"].meta["batch"], nf,
                             args.fm_vocab, seed=args.seed) for i in range(8)]
    bulk = criteo_like_batch(8, spec.cells["serve_bulk"].meta["batch"], nf,
                             args.fm_vocab, seed=args.seed)
    n_cand = spec.cells["retrieval_cand"].meta["n_candidates"]
    query = {"user_ids": criteo_like_batch(9, 1, nf, args.fm_vocab,
                                           seed=args.seed)["ids"][0, :nf - 1],
             "cand_ids": (np.arange(n_cand) % args.fm_vocab).astype(np.int32)}
    print(f"host batches (8 x {p99[0]['ids'].shape}, "
          f"{bulk['ids'].shape}, {n_cand} candidates) made in "
          f"{time.perf_counter() - t0:.1f} s")

    def request(name, batch, n_out):
        before = LAUNCHES["fm_interaction"]
        t0 = time.perf_counter()
        out = steps[name](batch)
        sync()
        wall = time.perf_counter() - t0
        k4 = LAUNCHES["fm_interaction"] - before
        if out.shape != (n_out,) or not bool(out.isfinite().all()):
            fail(f"{name}: logits not finite or of shape {tuple(out.shape)}")
        if on_card and k4 != 1:
            fail(f"{name}: K4 launched {k4} times in one forward")
        return out, wall

    reset_launches()
    p99_walls = [request("serve_p99", b, b["ids"].shape[0])[1] for b in p99]
    bulk_logits, bulk_wall = request("serve_bulk", bulk, bulk["ids"].shape[0])
    scores, retr_wall = request("retrieval_cand", query, n_cand)
    fm_launches = LAUNCHES["fm_interaction"]
    print(f"serve_p99 walls (ms): "
          f"{[round(w * 1e3, 3) for w in p99_walls]}; serve_bulk wall "
          f"{bulk_wall * 1e3:.3f} ms; retrieval_cand wall "
          f"{retr_wall * 1e3:.3f} ms; K4 launches {fm_launches}")
    # checks, off the path: K4 against its plain version on the bulk gather
    offs = torch.arange(nf, dtype=torch.int32, device=dev) * args.fm_vocab
    bulk_ids = torch.as_tensor(bulk["ids"], device=dev)
    bulk_rows = (bulk_ids + offs).reshape(-1)
    v = fm_model.table.index_select(0, bulk_rows).reshape(-1, nf, dim)
    y, y2, y_plain = (fm_interaction_kernel(v), fm_interaction_kernel(v),
                      fm_interaction_ref(v))
    e4, same4 = rel_l1(y, y_plain), torch.equal(y, y2)
    print(f"K4 on the serve_bulk gather {tuple(v.shape)}: rel L1 {e4:.3e}, "
          f"bit-identical relaunch {same4}")
    if not (e4 <= REL_L1 and same4):
        fail("K4 against its plain version")
    n_check = 1000
    full = np.concatenate(
        [np.broadcast_to(query["user_ids"], (n_check, nf - 1)),
         query["cand_ids"][:n_check, None]], axis=1)
    d_id = float((steps["serve_p99"]({"ids": full})
                  - scores[:n_check]).abs().max())
    print(f"retrieval_score vs forward_logits on {n_check} candidates: "
          f"max abs diff {d_id:.3e}")
    if d_id > 1e-4:
        fail("retrieval_score disagrees with forward_logits")
    p99_rows = (torch.as_tensor(p99[0]["ids"], device=dev) + offs).reshape(-1)
    v_p99 = fm_model.table.index_select(0, p99_rows).reshape(-1, nf, dim)
    split = {
        "gather_p99_ms": timer(lambda: fm_model.table.index_select(
            0, p99_rows), 50),
        "k4_p99_ms": timer(lambda: fm_interaction_kernel(v_p99), 50),
        "gather_bulk_ms": timer(lambda: fm_model.table.index_select(
            0, bulk_rows), 20),
    }
    # v read once, y written once; three flops per element and per column
    b_ms, b_by = bound_ms(v.numel() * 4 + v.shape[0] * 4,
                          3.0 * v.numel() + 3.0 * v.shape[0] * v.shape[2])
    k4_row = {
        "name": "fm_interaction", "route": "cuda",
        "source": "src/repro_torch/csrc/fm.cu",
        "replaces": "src/repro/kernels/fm/kernel.py:32",
        "launches": fm_launches,
        "max_abs_err": float((y - y_plain).abs().max()),
        "ms": timer(lambda: fm_interaction_kernel(v), 50),
        "plain_ms": timer(lambda: fm_interaction_ref(v), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": list(v.shape), **split,
    }
    print(f"gather / K4 split (ms): serve_p99 {split['gather_p99_ms']:.4f} / "
          f"{split['k4_p99_ms']:.4f}; serve_bulk "
          f"{split['gather_bulk_ms']:.4f} / {k4_row['ms']:.4f}")
    del fm_model, steps, v, v_p99, y, y2, y_plain, bulk_logits, scores
    if on_card:
        torch.cuda.empty_cache()

    # ---- 10. GIN forward ---------------------------------------------------
    print("== phase 10: GIN forward")
    dims = SHAPE_DIMS[GIN_SHAPE]
    gin_cfg = gin_tu.cfg_for(GIN_SHAPE)
    n_nodes = args.gin_nodes or dims["n_real"]
    t0 = time.perf_counter()
    g_gin = power_law_graph(n_nodes, alpha=GIN_ALPHA, seed=args.seed)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gb = make_gnn_batch(g_gin, gin_cfg.d_feat, n_classes=gin_cfg.n_classes,
                        seed=args.seed)
    batch_s = time.perf_counter() - t0
    if n_nodes == dims["n_real"]:
        gin_n, gin_e = dims["n"], dims["e"]
    else:  # the cells' padding rule: nodes % 32, edges % 512
        gin_n, gin_e = -(-g_gin.n // 32) * 32, -(-g_gin.n_edges // 512) * 512
    e_real = g_gin.n_edges
    if e_real > gin_e:
        fail(f"the GIN graph has {e_real} edges, over the cell's {gin_e}")
    gb = pad_gnn_batch(gb, gin_n, gin_e)
    del g_gin
    t0 = time.perf_counter()
    prepared = gnn.prepare_batch(gb, dev)
    sync()
    prep_s = time.perf_counter() - t0
    del gb
    gin = gnn.init_params(gin_cfg, seed=args.seed, device=dev)
    print(f"gin-tu {GIN_SHAPE}: N={gin_n} ({n_nodes} real) E={gin_e} "
          f"({e_real} real, alpha {GIN_ALPHA}) d_feat={gin_cfg.d_feat} "
          f"d_hidden={gin_cfg.d_hidden} layers={gin_cfg.n_layers} classes="
          f"{gin_cfg.n_classes}; host build graph {graph_s:.1f} s, batch "
          f"{batch_s:.1f} s; upload + destination sort {prep_s:.1f} s")
    src_s, seg_s, w_s, ptr_s, plan_s = (
        prepared["agg_src"], prepared["agg_dst"], prepared["agg_w"],
        prepared["agg_ptr"], prepared["agg_plan"])
    print(f"K5 plan: {plan_s.numel() - 1} chunks of {CHUNK_ROWS} rows; "
          f"longest segment {int(torch.diff(ptr_s).max())} rows")
    held = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    forms_before = dict(FORMS)
    gin_walls = []
    for i in range(2):
        t0 = time.perf_counter()
        out = gnn.forward(gin, prepared)
        sync()
        gin_walls.append(time.perf_counter() - t0)
        if on_card and LAUNCHES["segment_sum"] != gin_cfg.n_layers * (i + 1):
            fail(f"K5 launched {LAUNCHES['segment_sum']} times in {i + 1} "
                 "forwards")
    gin_launches = LAUNCHES["segment_sum"]
    carry_launches = LAUNCHES["segment_sum_carry"]
    gin_forms = {k: v - forms_before[k] for k, v in FORMS.items()}
    peak = (torch.cuda.max_memory_allocated() / 1e9 - held if on_card
            else 0.0)
    msg_gb = gin_e * gin_cfg.d_hidden * 4 / 1e9
    if out.shape != (gin_n, gin_cfg.n_classes) or not bool(
            out.isfinite().all()):
        fail(f"GIN output not finite or of shape {tuple(out.shape)}")
    print(f"forward walls {[round(w, 4) for w in gin_walls]} s; K5 launches "
          f"{gin_launches} (carry kernel {carry_launches}, by form "
          f"{gin_forms}); device memory "
          f"peak {peak:.3f} GB above the {held:.3f} GB held by earlier "
          f"phases (an [E, d] message buffer would be {msg_gb:.3f} GB); "
          f"|out|_1 / N {float(out.abs().sum()) / gin_n:.4e}")
    if on_card and (carry_launches != gin_launches
                    or gin_forms["gather"] != gin_launches):
        fail(f"K5 launched {gin_launches} times, {gin_forms} by form, its "
             f"carry kernel {carry_launches} times: the forward must run "
             "the gather form, each launch followed by one carry")
    if peak * 1e9 >= gin_e * gin_cfg.d_hidden * 4:
        fail(f"the GIN forward's memory peak {peak:.3f} GB holds an [E, d] "
             "message buffer")

    def plain_agg(data, seg, n, weights=None, ptr=None, rows=None,
                  plan=None):
        return segment_sum_ref(data, seg, n, weights, rows)

    out_plain = gnn.forward(gin, prepared, segment_sum=plain_agg)
    e_fwd = rel_l1(out, out_plain)
    print(f"forward with K5 vs with its plain version: rel L1 {e_fwd:.3e}")
    if e_fwd > REL_L1:
        fail("GIN forward with K5 disagrees with the plain version")
    del out, out_plain
    h0 = gin.embed(prepared["x"], final_act=True)
    n_e, dh = gin_e, h0.shape[1]
    # the contiguous form on layer 0's messages, weighted as GIN weights
    # them and unweighted as torch.segment_reduce sums them
    msgs = h0.index_select(0, src_s)
    a5, a5b = (segment_sum_sorted(msgs, seg_s, gin_n, weights=w_s, ptr=ptr_s,
                                  plan=plan_s) for _ in range(2))
    p5 = segment_sum_ref(msgs, seg_s, gin_n, w_s)
    e5, same5 = rel_l1(a5, p5), torch.equal(a5, a5b)
    print(f"K5 on layer 0's messages {tuple(msgs.shape)}: rel L1 {e5:.3e}, "
          f"bit-identical relaunch {same5}")
    if not (e5 <= REL_L1 and same5):
        fail("K5 against its plain version")
    err5 = float((a5 - p5).abs().max())
    del a5b, p5
    # integer-valued rows and weights sum exactly in any order, in both forms
    seg_i = np.sort(rng.integers(0, 300, 10_000)).astype(np.int32)
    seg_i[-100:] = 2**30
    small = [torch.as_tensor(a, device=dev) for a in (
        rng.integers(-8, 8, (10_000, 64)).astype(np.float32), seg_i,
        rng.integers(0, 3, 10_000).astype(np.float32),
        rng.integers(0, 2_000, 10_000).astype(np.int32))]
    exact = torch.equal(segment_sum_sorted(small[0], small[1], 300,
                                           weights=small[2]),
                        segment_sum_ref(small[0], small[1], 300, small[2]))
    table = small[0][:2_000]
    exact_g = torch.equal(
        segment_sum_sorted(table, small[1], 300, weights=small[2],
                           rows=small[3]),
        segment_sum_ref(table, small[1], 300, small[2], small[3]))
    print(f"K5 with 2**30 sentinel ids and mask-0 rows (integer-valued): "
          f"equal to the plain version {exact}, gather form {exact_g}")
    if not (exact and exact_g):
        fail("K5 on sentinel / mask-0 rows")
    b_ms, b_by = bound_ms(msgs.numel() * 4 + ptr_s.numel() * 8
                          + gin_n * dh * 4, msgs.numel())
    bw_ms, _ = bound_ms(msgs.numel() * 4 + n_e * 4 + ptr_s.numel() * 8
                        + gin_n * dh * 4, 2.0 * msgs.numel())
    print(f"contiguous form bound: {b_ms:.4f} ms unweighted, {bw_ms:.4f} ms "
          "weighted")
    lib_ms = idx_ms = None
    if on_card:
        lengths = torch.diff(ptr_s)
        lo, hi = int(ptr_s[0]), int(ptr_s[-1])
        lib_ms = timer(lambda: torch.segment_reduce(
            msgs[lo:hi], "sum", lengths=lengths), 5)
        lib_err = float((torch.segment_reduce(msgs[lo:hi], "sum",
                                              lengths=lengths)
                         - segment_sum_sorted(msgs, seg_s, gin_n, ptr=ptr_s,
                                              plan=plan_s)).abs().max())
        print(f"torch.segment_reduce vs K5 (unweighted): max abs diff "
              f"{lib_err:.3e}")
        seg_l = seg_s.long()
        idx_ms = timer(lambda: torch.zeros_like(a5).index_add_(
            0, seg_l, msgs * w_s[:, None]), 5)
        del seg_l
    k5_row = {
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        # the forward runs the gather form only (segment_sum_gather's row)
        "launches": gin_forms["contiguous"], "form": "contiguous",
        "max_abs_err": err5,
        # unweighted, like the library call
        "ms": timer(lambda: segment_sum_sorted(msgs, seg_s, gin_n, ptr=ptr_s,
                                               plan=plan_s), 10),
        "plain_ms": timer(lambda: segment_sum_ref(msgs, seg_s, gin_n), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        # weighted by the edge mask, as the forward weights its messages
        "weighted_ms": timer(lambda: segment_sum_sorted(
            msgs, seg_s, gin_n, weights=w_s, ptr=ptr_s, plan=plan_s), 10),
        "index_add_ms": idx_ms,
        "gather_ms": timer(lambda: h0.index_select(0, src_s), 5),
        "shape": [n_e, dh, gin_n],
    }
    del msgs, a5
    if on_card:
        torch.cuda.empty_cache()
    # the gather form: one GIN layer's aggregation, as the forward runs it
    g5, g5b = (segment_sum_sorted(h0, seg_s, gin_n, weights=w_s, ptr=ptr_s,
                                  rows=src_s, plan=plan_s) for _ in range(2))
    pg = segment_sum_ref(h0, seg_s, gin_n, w_s, src_s)
    eg, sameg = rel_l1(g5, pg), torch.equal(g5, g5b)
    print(f"K5 gather form on layer 0 (h {tuple(h0.shape)}, rows = src): "
          f"rel L1 {eg:.3e}, bit-identical relaunch {sameg}")
    if not (eg <= REL_L1 and sameg):
        fail("K5's gather form against its plain version")
    errg = float((g5 - pg).abs().max())
    del g5b, pg
    gb_ms, gb_by = bound_ms(h0.numel() * 4 * 2 + n_e * 4 * 2
                            + ptr_s.numel() * 8, 2.0 * n_e * dh)
    rows_ms = n_e * dh * 4 / HBM_BYTES_PER_S * 1e3
    print(f"gather form bound: {gb_ms:.4f} ms counting each input byte once; "
          f"its {n_e * dh * 4 / 1e9:.3f} GB of rows at 3.35 TB/s, none "
          f"reused in L2: {rows_ms:.4f} ms")
    lib_g = None
    if on_card:
        lo, hi = int(ptr_s[0]), int(ptr_s[-1])
        a_csr = torch.sparse_csr_tensor(
            ptr_s - lo, src_s[lo:hi].long(), w_s[lo:hi],
            size=(gin_n, h0.shape[0]))
        lib_g = timer(lambda: torch.sparse.mm(a_csr, h0), 5)
        print(f"torch.sparse.mm (sparse_csr) vs K5 gather form: max abs "
              f"diff {float((torch.sparse.mm(a_csr, h0) - g5).abs().max()):.3e}")
        del a_csr
    k5g_row = {
        "name": "segment_sum_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/kernel.py:50",
        "launches": gin_forms["gather"], "carry_launches": carry_launches,
        "form": "gather",
        "max_abs_err": errg,
        "ms": timer(lambda: segment_sum_sorted(
            h0, seg_s, gin_n, weights=w_s, ptr=ptr_s, rows=src_s,
            plan=plan_s), 10),
        "plain_ms": timer(lambda: segment_sum_ref(h0, seg_s, gin_n, w_s,
                                                  src_s), 3),
        "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": lib_g,
        "shape": [n_e, dh, gin_n],
    }
    gin_summary = (f"GIN (gin-tu {GIN_SHAPE}): N={gin_n} E={gin_e} "
                   f"({e_real} real) forward walls "
                   f"{[round(w, 4) for w in gin_walls]} s, peak {peak:.3f} GB "
                   f"above the earlier phases' {held:.3f} GB")
    del h0, g5, prepared, gin, small, table
    if on_card:
        torch.cuda.empty_cache()

    # ---- 11. numbers -------------------------------------------------------
    print("== phase 11: numbers")
    print(f"main path: N={g.n} links={g.n_edges} pallas rounds "
          f"{rep.n_rounds} ops {rep.n_ops} solve wall {rep.wall_time_s:.3f} s"
          f"; segment_sum rounds {rep_ss.n_rounds} ops {rep_ss.n_ops} wall "
          f"{rep_ss.wall_time_s:.3f} s; cold session {cold.wall_time_s:.3f} "
          f"s; warm requests ops {warm_ops}")
    print(f"engine path (k={k_e}): layout builds {build_bsr_s:.3f} s (bsr) "
          f"{build_chk_s:.3f} s (chunk); engine:bsr cold rounds "
          f"{rep_bsr.n_rounds} chunks {rep_bsr.extras['chunks']} ops "
          f"{rep_bsr.n_ops} wall {rep_bsr.wall_time_s:.3f} s; engine:chunk "
          f"cold rounds {rep_chk.n_rounds} chunks {rep_chk.extras['chunks']} "
          f"ops {rep_chk.n_ops} wall {rep_chk.wall_time_s:.3f} s; forced "
          f"move rounds {rep_fm.n_rounds} wall {rep_fm.wall_time_s:.3f} s; "
          f"warm rounds {warm_e.n_rounds} ops {warm_e.n_ops} wall "
          f"{warm_e.wall_time_s:.3f} s")
    rows = []

    def k1_numbers(what, ins):
        """K1's bytes, bound and armed tile share at the operands ``ins``."""
        _, block_col, _, col_active, f3, _ = ins
        tiles_read = armed_tiles(col_active, block_col)
        n_bytes = k1_bytes(ins)
        b_ms, b_by = bound_ms(n_bytes,
                              2.0 * tiles_read * BS * BS * f3.shape[2])
        print(f"K1 {what}: {int(col_active.sum())}/{f3.shape[0]} block "
              f"columns armed, {tiles_read}/{block_col.numel()} tiles read "
              f"({tiles_read / block_col.numel():.4f} of the pool)")
        return n_bytes, b_ms, b_by, tiles_read / block_col.numel()

    ins_a, err_a = timing_inputs["k1"]
    ins_b, err_b = timing_inputs["k1_late"]
    ins, err = timing_inputs["k2"]
    # K1 at inputs (a) and (b) and K2 over the same pool, timed by one rule
    # so that their ratio is like for like: each the least of two 20-call
    # means, in turns, the second round reversed
    pool_rule = ("least of two 20-call means, in turns with the other "
                 "frontier_round_bsr input and bsr_spmm")
    times = least(timer, {
        "k1": lambda: frontier_round_bsr_kernel(*ins_a),
        "k1_late": lambda: frontier_round_bsr_kernel(*ins_b),
        "k2": lambda: bsr_spmm_kernel(*ins)}, 20)
    print("K1 (a), K1 (b), K2 over the pool, ms (least, greatest of two): "
          + ", ".join(f"{times[k][0]:.4f} [{times[k][1]:.4f}]"
                      for k in ("k1", "k1_late", "k2")))
    bytes_a, b_ms, b_by, share_a = k1_numbers("timing input (a)", ins_a)
    bytes_b, b_ms_b, _, share_b = k1_numbers(
        f"late round (input b, after {late_rounds} rounds)", ins_b)
    k1_ms, late_ms, k2_ms = (times[k][0] for k in ("k1", "k1_late", "k2"))
    rows.append({
        "name": "frontier_round_bsr", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:376",
        "launches": main_launches["frontier_round_bsr"],
        "max_abs_err": err_a,
        "ms": k1_ms,
        "plain_ms": timer(lambda: frontier_round_bsr_plain(*ins_a), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "timing": pool_rule,
        "kernel": (launch_frontier_round_bsr(*ins_a)[2] if on_card
                   else None),
        "tb_per_s": bytes_a / k1_ms / 1e9,
        "armed_tile_fraction": share_a,
        # against K2's bulk body over the same pool, timed alike
        "k2_ratio": k1_ms / k2_ms,
        # input (b), a late round: the same kernel and launches
        "late_ms": late_ms,
        "late_plain_ms": timer(lambda: frontier_round_bsr_plain(*ins_b), 5),
        "late_bound_ms": b_ms_b, "late_max_abs_err": err_b,
        "late_kernel": (launch_frontier_round_bsr(*ins_b)[2] if on_card
                        else None),
        "late_tb_per_s": bytes_b / late_ms / 1e9,
        "late_armed_tile_fraction": share_b,
    })
    print(f"K1 at input (a) / K2 over the same pool: {k1_ms:.4f} / "
          f"{k2_ms:.4f} ms = {rows[0]['k2_ratio']:.4f}")
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
        "ms": k2_ms,
        "plain_ms": timer(lambda: bsr_spmm_plain(*ins), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "timing": pool_rule,
        "kernel": launch_bsr_spmm(*ins)[1] if on_card else None,
        "tb_per_s": k2_bytes / k2_ms / 1e9,
        "library_tb_per_s": lib_ms and k2_bytes / lib_ms / 1e9,
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
        "launches": main_launches["edge_sum"] + k3_warm_launches,
        "max_abs_err": err,
        "ms": timer(lambda: edge_sum(x, edges), 50),
        "plain_ms": timer(lambda: edge_sum_plain(
            x, edges.indptr, edges.src, edges.wgt), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.zeros_like(x).index_add_(
            0, dst_t, x[src_t] * edges.wgt), 20),
    })
    # K2 at the engine's shapes: one launch pushes every PID's sent fluid
    # through the real tiles (bsr_gather_spmm's port)
    v = visits.n_visits
    k2e_bytes = (v * s_e * s_e * 4 + v * 8 + visits.row_ptr.numel() * 8
                 + x3_e.numel() * 4 + k_e * r_e * s_e * 4)
    b_ms, b_by = bound_ms(k2e_bytes, 2.0 * v * s_e * s_e)
    lib_ms = None
    if on_card:
        a_bsr = torch.sparse_bsr_tensor(
            visits.row_ptr, visits.visit_col.long(),
            eng.pool[visits.visit_block.long()],
            size=(k_e * r_e * s_e, r_e * s_e))
        x2 = x3_e.reshape(r_e * s_e, 1)
        lib_ms = timer(lambda: torch.sparse.mm(a_bsr, x2), 10)
        lib_err = float((torch.sparse.mm(a_bsr, x2).reshape(k_e * r_e, s_e)
                         - engine_tile_push(eng.pool, visits, sent_e))
                        .abs().max())
        print(f"torch.sparse.mm (sparse_bsr) vs K2 at the engine's shapes: "
              f"max abs diff {lib_err:.3e}")
        del a_bsr
    k2_ms = timer(lambda: engine_tile_push(eng.pool, visits, sent_e), 20)
    rows.append({
        "name": "bsr_gather_spmm", "route": "cuda",
        "source": "src/repro_torch/csrc/diffusion.cu",
        "replaces": "src/repro/kernels/diffusion/kernel.py:182",
        "launches": engine_launches["bsr_spmm"],
        "max_abs_err": timing_inputs["k2e"],
        "ms": k2_ms,
        "plain_ms": timer(k2_engine_plain, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "kernel": launch_bsr_spmm(
            eng.pool, visits.visit_block, visits.visit_col, visits.row_ptr,
            x3_e)[1] if on_card else None,
        "tb_per_s": k2e_bytes / k2_ms / 1e9,
        "library_tb_per_s": lib_ms and k2e_bytes / lib_ms / 1e9,
        "visits": v,
    })
    # K3 at the engine's shapes: the engine:chunk per-edge push
    n_e, n_out = edges_e.n_edges, edges_e.n
    k3e_bytes = (edges_e.indptr.numel() * 8 + n_e * 8 + xe.numel() * 4
                 + n_out * 4)
    b_ms, b_by = bound_ms(k3e_bytes, 2.0 * n_e)
    dst_e = torch.repeat_interleave(
        torch.arange(n_out, device=dev), torch.diff(edges_e.indptr))
    src_e = edges_e.src.long()
    rows.append({
        "name": "engine_edge_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/edge_sum.cu",
        "replaces": "src/repro/core/distributed.py:514",
        "launches": k3_engine_launches,
        "max_abs_err": timing_inputs["k3e"],
        "ms": timer(lambda: edge_sum(xe, edges_e), 50),
        "plain_ms": timer(lambda: edge_sum_plain(
            xe, edges_e.indptr, edges_e.src, edges_e.wgt), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(lambda: torch.zeros(
            n_out, dtype=torch.float32, device=dev).index_add_(
                0, dst_e, xe[src_e] * edges_e.wgt), 20),
    })
    rows += [k4_row, k5_row, k5g_row]
    print(f"FM (fm, vocab {args.fm_vocab}/field): serve_p99 walls (ms) "
          f"{[round(w * 1e3, 3) for w in p99_walls]}, serve_bulk "
          f"{bulk_wall * 1e3:.3f} ms, retrieval_cand {retr_wall * 1e3:.3f} ms")
    print(gin_summary)

    def show(rows):
        for r in rows:
            print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
                  f"ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']}) launches {r['launches']}"
                  + (f"; by CUDA graph replay {r['graph_ms']:.4f} ms, library "
                     f"{r['library_graph_ms']:.4f} ms, {r['splits']} split(s)"
                     if "graph_ms" in r else "")
                  + (f"; {r['kernel']} body, {r['tb_per_s']:.3f} TB/s"
                     if "tb_per_s" in r else "")
                  + (f"; input (b) {r['late_ms']:.4f} ms (bound "
                     f"{r['late_bound_ms']:.4f} ms), "
                     f"{r['late_armed_tile_fraction']:.4f} of the tiles "
                     f"armed, {r['late_tb_per_s']:.3f} TB/s"
                     if "late_ms" in r else "") + f" on {smi}")

    show(rows)
    print(f"phases 1-11 wall {time.perf_counter() - t_start:.1f} s")

    # ---- 12. LM serving ----------------------------------------------------
    print("== phase 12: LM serving")
    t0 = time.perf_counter()
    lm_rows, lm_summary = lm_serving(args, torch, dev, timer, sync)
    print(lm_summary)
    show(lm_rows)
    rows += lm_rows
    print(f"phase 12 wall {time.perf_counter() - t0:.1f} s")

    # ---- 13. simulator -----------------------------------------------------
    print("== phase 13: simulator")
    sim_rows, sim_summary = simulator_phase(args, torch, dev, timer, g,
                                            problem, rep_ss.x)
    print(sim_summary)
    show(sim_rows)
    rows += sim_rows
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
