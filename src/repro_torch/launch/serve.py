"""Serving CLI: ``lm`` and ``rank`` modes (the port of
``repro.launch.serve``), each with ``--device`` (default ``cuda``: it
serves on the card unless the CPU is asked for).

* ``lm`` (the default) — batched prefill + greedy decode through
  :mod:`repro_torch.launch.steps` (the ``prefill_32k`` / ``decode_32k``
  cells' step kinds).  The model is the reduced config of
  ``configs.smoke.lm_shrink`` (float32, 2 layers), as in the reference;
  weights come from a seeded generator (no checkpoint is read).

* ``rank`` — personalized-PageRank serving.  By default the request
  stream flows through the continuous-batching
  :class:`repro_torch.serving.Scheduler`: rank requests share the card in
  lanes of one batched round (K3's lane form), warm H-states are pooled
  per cluster, and every ``--churn-every`` requests a link-rotation delta
  of ``--churn`` × L edges is applied at a drain barrier.
  ``--no-batching`` (or a ``--method`` other than
  ``frontier:segment_sum``) serves the same seeded stream sequentially on
  one warm-started :class:`repro_torch.SolverSession` (deltas through
  ``update_graph``) and ends with one ``solve_batch`` of ``--batch``
  personalized columns.  Poison requests (``--poison-every``) and bad
  deltas are rejected into a quarantine without stopping the stream.
  ``--ckpt-dir``, ``--resume``, ``--rescale-at`` and ``--rescale-k`` wait
  for the checkpoint and elastic-K slices (ROADMAP §1, items 5 and 6)
  and stop with an error.

  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen1.5-0.5b \
      --device cpu --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve rank --n 20000
  PYTHONPATH=src python -m repro_torch.launch.serve rank --device cpu \
      --n 2000 --churn 0.01 --churn-every 3 [--no-batching]
"""
import argparse
import sys
import time

import numpy as np


def lm_main(argv):
    import torch

    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.launch.steps import build_cell_step
    from repro_torch.models import transformer as lm

    ap = argparse.ArgumentParser(prog="serve [lm]")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda | cpu)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        ap.error(f"{args.arch} is a {spec.family} arch: serving applies to "
                 "the LM archs")
    if args.gen < 1:
        ap.error("--gen must be at least 1")
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    cfg = lm_shrink(spec.model_cfg)
    model = lm.init_params(cfg, seed=0, device=args.device)
    prefill = build_cell_step(spec, spec.cells["prefill_32k"], model)
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)
    prompts = lm_token_batch(0, args.batch, args.prompt, cfg.vocab)["tokens"]

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cache, logits = prefill({"tokens": prompts,
                             "max_seq": args.prompt + args.gen})
    sync()
    print(f"[{args.arch}] prefill {args.batch}x{args.prompt}: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    toks = logits.argmax(-1)
    outs = [toks]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode({"tokens": toks, "cache_k": cache["k"],
                                "cache_v": cache["v"], "pos": cache["pos"]})
        toks = logits.argmax(-1)
        outs.append(toks)
    sync()
    dt = time.perf_counter() - t0
    print(f"decode {args.gen - 1} steps: {dt * 1e3:.1f} ms "
          f"({args.batch * (args.gen - 1) / max(dt, 1e-9):.0f} tok/s)")
    print("generated ids:",
          np.stack([t.cpu().numpy() for t in outs], 1)[0][:12].tolist())


def rank_main(argv):
    ap = argparse.ArgumentParser(prog="serve rank")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--method", default="frontier:segment_sum",
                    help="warm-startable registry key")
    ap.add_argument("--requests", type=int, default=8,
                    help="warm-start requests to serve after the cold "
                    "solve")
    ap.add_argument("--batch", type=int, default=8,
                    help="personalization columns for the solve_batch "
                    "demo")
    ap.add_argument("--drift", type=float, default=0.02,
                    help="per-request fractional perturbation of B")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="graph-update request: fraction of edges "
                    "link-rotated per update (0 disables)")
    ap.add_argument("--churn-every", type=int, default=3,
                    help="serve a graph-update request every this many "
                    "warm requests")
    ap.add_argument("--poison-every", type=int, default=0,
                    help="inject a poison (NaN) personalization vector "
                    "every this many requests to exercise admission "
                    "control (0 disables)")
    ap.add_argument("--target-error", type=float, default=None)
    ap.add_argument("--k", type=int, default=None,
                    help="engine methods: PIDs on the pid axis")
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet (ROADMAP §1, item 5)")
    ap.add_argument("--resume", action="store_true",
                    help="not ported yet (ROADMAP §1, item 5)")
    ap.add_argument("--rescale-at", type=int, default=None,
                    help="not ported yet (ROADMAP §1, item 6)")
    ap.add_argument("--rescale-k", type=int, default=None,
                    help="not ported yet (ROADMAP §1, item 6)")
    ap.add_argument("--no-batching", action="store_true",
                    help="serve the stream strictly sequentially on one "
                    "warm-started session")
    ap.add_argument("--max-lanes", type=int, default=16,
                    help="continuous batching: lane-axis cap (pow2)")
    ap.add_argument("--rounds-per-tick", type=int, default=32,
                    help="continuous batching: frontier rounds per "
                    "scheduler micro-step")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.churn > 0 and args.churn_every < 1:
        ap.error("--churn-every must be >= 1 when --churn is set")
    if args.ckpt_dir or args.resume:
        ap.error("--ckpt-dir / --resume: checkpointed serving is not "
                 "ported yet (ROADMAP §1, item 5)")
    if args.rescale_at is not None or args.rescale_k is not None:
        ap.error("--rescale-at / --rescale-k: elastic K is not ported yet "
                 "(ROADMAP §1, item 6)")
    import torch

    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    # the scheduler is frontier-native: other methods keep the
    # sequential session path
    if args.no_batching or args.method != "frontier:segment_sum":
        return _rank_sequential(args)
    return _rank_batched(args)


def _rank_batched(args):
    """Default rank serving: the request stream flows through the
    continuous-batching :class:`repro_torch.serving.Scheduler` — the same
    seeded stream (drift chain, poison schedule, churn deltas) as the
    sequential path, but rank requests between graph updates are served
    concurrently in lanes.  Graph updates are natural drain barriers: the
    scheduler flushes each delta against the post-predecessor store,
    exactly the sequential ordering."""
    import repro_torch
    from repro_torch.core import webgraph_like
    from repro_torch.graph import rotation_churn
    from repro_torch.resilience import RequestRejected
    from repro_torch.serving import Scheduler

    rng = np.random.default_rng(0)
    g = webgraph_like(args.n, seed=1)
    problem = repro_torch.Problem.pagerank(g, target_error=args.target_error)
    print(f"N={g.n} L={g.n_edges} method={args.method} "
          f"target_error={problem.target_error:.2e} device={args.device}")
    sch = Scheduler(problem, max_lanes=args.max_lanes,
                    rounds_per_tick=args.rounds_per_tick, device=args.device)
    print(f"[mode ] continuous batching: max_lanes={sch.batcher.max_lanes}"
          f" rounds_per_tick={sch.rounds_per_tick} "
          f"pool_capacity={sch.pool.capacity}")

    printed = 0

    def drain_and_report():
        nonlocal printed
        sch.run_until_idle()
        for r in sch.results[printed:]:
            print(f"[served {r.request_id}] |res|={r.residual:.2e} "
                  f"{r.ops} ops, {r.rounds} rounds, "
                  f"pool_hit={r.pool_hit}, lat={r.latency_s:.3f}s"
                  + (f" [degraded rung={r.rung}]" if r.degraded else ""))
        printed = len(sch.results)

    t0 = time.perf_counter()
    b = problem.b
    for req in range(args.requests):
        if args.churn > 0 and req % args.churn_every == args.churn_every - 1:
            drain_and_report()  # the update's drain barrier
            n_rot = max(1, int(args.churn * sch.problem.n_edges) // 2)
            delta = rotation_churn(sch.problem.graph, n_rot,
                                   seed=1000 + req)
            try:
                sch.submit_update(
                    delta, store_version=sch.problem.store_version)
                sch.run_until_idle()  # flush: apply at the barrier
                print(f"[update {req}] {delta.n_changes} changed edges "
                      f"applied, store at version "
                      f"{sch.problem.store_version}")
            except RequestRejected as e:
                print(f"[quarantine {req}] update rejected: {e}")
            continue
        b = np.abs(b * (1.0 + args.drift * rng.standard_normal(g.n)))
        b_req = b
        if args.poison_every and req % args.poison_every == (
                args.poison_every - 1):
            b_req = b.copy()
            b_req[rng.integers(g.n)] = np.nan  # a client sent garbage
        try:
            sch.submit(b_req, cluster=0, request_id=req)
        except RequestRejected as e:
            print(f"[quarantine {req}] rank request rejected: {e}")
    drain_and_report()
    wall = time.perf_counter() - t0
    if sch.quarantine.total:
        print(f"[quarantine] {sch.quarantine.total} rejected: "
              f"{sch.quarantine.to_jsonable()['by_reason']}")
    served = len(sch.results)
    lat = sch.latency_percentiles()
    print(f"[stats] served={served} dropped={sch.dropped} "
          f"qps={served / max(wall, 1e-9):.2f} "
          f"pool_hit_rate={sch.pool.hit_rate:.2f} "
          f"occupancy={sch.batcher.mean_occupancy:.2f} "
          f"p50={lat['p50']:.3f}s p99={lat['p99']:.3f}s "
          f"rung={sch.ladder.rung.name}")


def _rank_sequential(args):
    """The sequential rank loop: one warm-started session, strictly one
    request at a time; graph updates through ``update_graph``."""
    import repro_torch
    from repro_torch.core import webgraph_like
    from repro_torch.graph import rotation_churn
    from repro_torch.resilience import (Quarantine, RequestRejected,
                                        validate_graph_update, validate_rhs)

    rng = np.random.default_rng(0)
    g = webgraph_like(args.n, seed=1)
    problem = repro_torch.Problem.pagerank(g, target_error=args.target_error)
    options = repro_torch.SolverOptions(k=args.k, device=args.device)
    print(f"N={g.n} L={g.n_edges} method={args.method} "
          f"target_error={problem.target_error:.2e} device={args.device}")
    session = repro_torch.SolverSession(problem, method=args.method,
                                        options=options)
    t0 = time.perf_counter()
    cold = session.solve()
    baseline_ops = cold.n_ops
    print(f"[cold ] {cold.n_ops} edge pushes, {cold.n_rounds} "
          f"rounds, {time.perf_counter() - t0:.2f}s — the serving baseline")

    quarantine = Quarantine()
    b = problem.b
    for req in range(args.requests):
        if args.churn > 0 and req % args.churn_every == args.churn_every - 1:
            # a graph-update request: the crawl delivered link churn
            n_rot = max(1, int(args.churn * session.problem.n_edges) // 2)
            delta = rotation_churn(session.problem.graph, n_rot,
                                   seed=1000 + req)
            t0 = time.perf_counter()
            try:
                # admission: a delta built against a stale store version
                # or naming edges the store doesn't hold never reaches
                # the session
                validate_graph_update(
                    session.problem.graph, delta,
                    store_version=session.problem.store_version)
                resid0 = session.update_graph(delta)
            except RequestRejected as e:
                quarantine.record(req, e.reason)
                print(f"[quarantine {req}] update rejected: {e}")
                continue
            except Exception as e:  # noqa: BLE001 - the stream goes on
                # update_graph rolled the store back: the session still
                # serves the pre-delta graph
                quarantine.record(req, "update-failed")
                print(f"[quarantine {req}] update failed, rolled back: "
                      f"{e}")
                continue
            rep = session.solve()
            print(f"[update {req}] {delta.n_changes} changed edges "
                  f"|F0|={resid0:.2e} {rep.n_ops} ops "
                  f"({1.0 - rep.n_ops / max(baseline_ops, 1):.0%} saved "
                  f"vs cold), {rep.n_rounds} rounds, "
                  f"{time.perf_counter() - t0:.2f}s")
            continue
        # a drifting teleport vector: what a freshness-weighted or
        # user-conditioned ranking update looks like between requests
        b = np.abs(b * (1.0 + args.drift * rng.standard_normal(g.n)))
        b_req = b
        if args.poison_every and req % args.poison_every == (
                args.poison_every - 1):
            b_req = b.copy()
            b_req[rng.integers(g.n)] = np.nan  # a client sent garbage
        t0 = time.perf_counter()
        try:
            b_ok = validate_rhs(b_req, g.n)
        except RequestRejected as e:
            quarantine.record(req, e.reason)
            print(f"[quarantine {req}] rank request rejected: {e}")
            continue
        resid0 = session.warm_start(b_ok)
        rep = session.solve()
        print(f"[warm {req}] |F0|={resid0:.2e} {rep.n_ops} ops "
              f"({1.0 - rep.n_ops / max(baseline_ops, 1):.0%} saved vs "
              f"cold), {rep.n_rounds} rounds, "
              f"{time.perf_counter() - t0:.2f}s")
    if quarantine.total:
        print(f"[quarantine] {quarantine.total} rejected: "
              f"{quarantine.to_jsonable()['by_reason']}")

    # personalized batch: C independent teleport columns, one batched run
    hot = rng.choice(g.n, size=args.batch, replace=False)
    pref = np.zeros((g.n, args.batch))
    pref[hot, np.arange(args.batch)] = 1.0
    t0 = time.perf_counter()
    batch = session.solve_batch((1.0 - problem.damping) * pref)
    dt = time.perf_counter() - t0
    print(f"[batch] {args.batch} personalized columns in one batched "
          f"solve: {batch.n_ops} ops, {batch.n_rounds} rounds, {dt:.2f}s "
          f"({args.batch / max(dt, 1e-9):.1f} rankings/s), "
          f"converged={batch.converged}")
    for c in range(min(3, args.batch)):
        top = np.argsort(-batch.x[:, c])[:3]
        print(f"  persona {c} (seed node {hot[c]}): top-3 {top.tolist()}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "rank":
        return rank_main(argv[1:])
    if argv and argv[0] == "lm":
        argv = argv[1:]
    return lm_main(argv)


if __name__ == "__main__":
    main()
