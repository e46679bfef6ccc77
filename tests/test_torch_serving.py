"""Port parity for batched multi-RHS solves and the serving tier: K3's
lane form, ``SolverSession.solve_batch``, the continuous batcher, the
scheduler (pool hits, eviction, graph updates at a drain barrier,
overload degradation, poison quarantine) and ``serve rank``.

The same seeded inputs go through the reference (``repro``) and the port
on the CPU:

* ``edge_sum_lanes_plain`` against the reference's vmapped
  ``segment_sum`` (float32 sums: rtol/atol 1e-6), and each lane bit-equal
  to K3's plain version on its row;
* ``solve_batch``: the reference's ``ops_per_column`` and rounds exactly,
  ``x`` within |Δx|₁ <= 1e-6, and pad / no-pad bit parity;
* the batcher's retire and refill order and the scheduler's event logs
  (virtual times, ops, pool hits, rungs) equal to the reference's;
* the ``serve rank`` CLI (``--device cpu``, batched and ``--no-batching``)
  prints the reference's op counts.
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.serving as rs
import repro_torch
import repro_torch.serving as ts
from repro.core import webgraph_like
from repro.graph import GraphStore as RefStore, rotation_churn as ref_churn
from repro_torch.graph import GraphStore, rotation_churn
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.edge_sum import (csc_edges, edge_sum_lanes,
                                         edge_sum_lanes_plain,
                                         edge_sum_plain)
from repro_torch.resilience import RequestRejected

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))
N = 300


@pytest.fixture(scope="module")
def graph():
    return webgraph_like(N, seed=1)


def _problems(g, target_error=None):
    """The same PageRank problem on each side, each in its own store."""
    return (repro.Problem.pagerank(RefStore.from_csr(g),
                                   target_error=target_error),
            repro_torch.Problem.pagerank(GraphStore.from_csr(g),
                                         target_error=target_error))


def drifting_bs(problem, count, drift=0.05, seed=0):
    rng = np.random.default_rng(seed)
    b = np.asarray(problem.b, dtype=np.float64)
    out = []
    for _ in range(count):
        b = np.abs(b * (1.0 + drift * rng.standard_normal(problem.n)))
        out.append(b)
    return out


# --------------------------------------------------------------------------- #
# K3's lane form (plain version)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("c,seed", [(1, 0), (3, 1), (8, 2), (16, 3)])
def test_edge_sum_lanes_plain_matches_vmapped_segment_sum(c, seed):
    rng = np.random.default_rng(seed)
    n, n_edges = 400, 3000
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n // 2, n_edges)  # upper half: no in-edges
    wgt = rng.random(n_edges)
    x = rng.standard_normal((c, n)).astype(np.float32)
    x[1::3] = 0.0  # zero lanes
    seg = jax.vmap(lambda m: jax.ops.segment_sum(m, jnp.asarray(dst),
                                                 num_segments=n))
    ref = np.asarray(seg(jnp.asarray(x)[:, src]
                         * jnp.asarray(wgt, jnp.float32)[None, :]))
    edges = csc_edges(src, dst, wgt, n, "cpu")
    xt = torch.from_numpy(x)
    got = edge_sum_lanes(xt, edges)
    assert got.dtype == torch.float32 and got.shape == (c, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert bool((got[:, n // 2:] == 0).all())
    assert bool((got[1::3] == 0).all())
    for lane in range(c):
        assert torch.equal(got[lane], edge_sum_plain(
            xt[lane].contiguous(), edges.indptr, edges.src, edges.wgt))
    assert torch.equal(got, edge_sum_lanes_plain(xt, edges.indptr,
                                                 edges.src, edges.wgt))


def test_edge_sum_lanes_without_edges():
    edges = csc_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                      np.zeros(0), 5, "cpu")
    got = edge_sum_lanes(torch.ones(2, 5), edges)
    assert got.shape == (2, 5) and bool((got == 0).all())


# --------------------------------------------------------------------------- #
# solve_batch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("c", [1, 3, 5])
def test_solve_batch_matches_reference(graph, c):
    pr, pt = _problems(graph)
    bs = np.stack(drifting_bs(pr, c), axis=1)
    ref = repro.SolverSession(pr).solve_batch(bs)
    before = dict(LAUNCHES)
    got = repro_torch.SolverSession(pt, device="cpu").solve_batch(bs)
    assert LAUNCHES == before, "a CPU batch launched a kernel"
    raw = repro_torch.SolverSession(pt, device="cpu").solve_batch(
        bs, pad=False)
    assert got.converged and got.x.shape == (N, c)
    assert got.extras["ops_per_column"] == ref.extras["ops_per_column"]
    assert got.n_rounds == ref.n_rounds and got.n_ops == ref.n_ops
    assert np.abs(got.x - ref.x).sum() <= 1e-6
    # zero padding is bitwise invisible to the real lanes
    assert np.array_equal(got.x, raw.x)
    assert got.extras["ops_per_column"] == raw.extras["ops_per_column"]
    cp = 1 << (c - 1).bit_length()
    assert got.extras["bucket"] == ref.extras["bucket"] == cp
    assert got.extras["padding_waste"] == pytest.approx((cp - c) / cp)
    assert raw.extras["bucket"] == c and raw.extras["padding_waste"] == 0.0


def test_batched_problem_solves_through_the_front_door(graph):
    pref = np.zeros((N, 4))
    pref[[3, 50, 120, 299], np.arange(4)] = 1.0
    pt = repro_torch.Problem.pagerank(graph, personalization=pref)
    pr = repro.Problem.pagerank(graph, personalization=pref)
    got = repro_torch.solve(pt, device="cpu")  # auto: frontier:segment_sum
    ref = repro.solve(pr, method="frontier:segment_sum")
    assert got.method == "frontier:segment_sum" and got.converged
    assert got.extras["ops_per_column"] == ref.extras["ops_per_column"]
    assert np.abs(got.x - ref.x).sum() <= 1e-6
    for method in ("frontier:pallas", "engine:chunk", "simulator"):
        with pytest.raises(ValueError, match="multi-RHS"):
            repro_torch.solve(pt, method=method, device="cpu")
    with pytest.raises(ValueError, match="no registered backend"):
        repro_torch.solve(pt, device="cpu", k=2)


def test_solve_batch_on_an_engine_session(graph):
    """solve_batch is frontier-native whatever the session's method, and
    leaves the session's own state alone."""
    _, pt = _problems(graph)
    session = repro_torch.SolverSession(pt, method="engine:chunk",
                                        device="cpu", k=2)
    cold = session.solve()
    bs = np.stack(drifting_bs(pt, 2), axis=1)
    got = session.solve_batch(bs)
    want = repro_torch.SolverSession(pt, device="cpu").solve_batch(bs)
    assert got.method == "frontier:segment_sum"
    assert np.array_equal(got.x, want.x)
    assert np.array_equal(session.x, cold.x)


# --------------------------------------------------------------------------- #
# SessionPool and RequestQueue (host bookkeeping, same code as the reference)
# --------------------------------------------------------------------------- #
def test_pool_lru_versioning_and_eviction():
    pool = ts.SessionPool(capacity=1)
    pool.put(0, 0, h="hA")
    pool.put(0, 1, h="hB")          # evicts (0, 0)
    assert pool.get(0, 0) is None and pool.get(0, 1).h == "hB"
    assert pool.evictions == 1 and len(pool) == 1
    pool = ts.SessionPool(capacity=2)
    pool.put(0, 0, h="a")
    pool.put(0, 1, h="b")
    assert pool.get(0, 0).h == "a"  # refreshes (0,0): (0,1) is now LRU
    pool.put(0, 2, h="c")
    assert pool.get(0, 1) is None and pool.get(0, 0).h == "a"
    pool = ts.SessionPool(capacity=4)
    pool.put(0, 7, h="old")
    assert pool.get(1, 7) is None   # same cluster, bumped version: miss
    assert pool.invalidate(keep_version=1) == 1
    assert pool.get(0, 7) is None and len(pool) == 0
    e = pool.put(None, 4, h="x")
    assert e.store_version == 0 and pool.get(0, 4) is e
    with pytest.raises(ValueError):
        ts.SessionPool(capacity=0)


def test_queue_backlog_accounting_and_signal():
    from repro.balance import LoadSignal as RefSignal
    from repro_torch.balance import LoadSignal

    q = ts.RequestQueue()
    q.push(ts.Request(0, b=None, arrival_t=1.0))
    q.push(ts.Request(1, b=None, arrival_t=2.0))
    assert q.depth == 2 and q.depth_peak == 2
    assert q.oldest_wait(5.0) == pytest.approx(4.0)
    first = q.pop()
    q.push_front(first)
    assert q.pop().request_id == 0 and q.pop().request_id == 1
    assert q.enqueued == 2 and q.dequeued == 2
    sig = LoadSignal.from_queue(oldest_wait_s=0.02, deadline_s=0.01,
                                queue_depth=4, queue_cap=8, step=3)
    ref = RefSignal.from_queue(oldest_wait_s=0.02, deadline_s=0.01,
                               queue_depth=4, queue_cap=8, step=3)
    assert sig.kind == ref.kind == "queue-depth"
    assert np.array_equal(sig.values, ref.values)
    assert np.array_equal(sig.sizes, ref.sizes)
    with pytest.raises(ValueError):
        LoadSignal.from_queue(0.0, deadline_s=0.0)


# --------------------------------------------------------------------------- #
# ContinuousBatcher: slot lifecycle against the reference
# --------------------------------------------------------------------------- #
def _staggered(mod, problem, **kw):
    """test_serving.py's staggered retire and refill, as (request id,
    lane, ops, rounds, micro call) per retirement."""
    tol = problem.target_error * problem.eps
    bs = drifting_bs(problem, 3)
    bat = mod.ContinuousBatcher(problem, max_lanes=2, min_lanes=2, **kw)
    lanes = [bat.admit(mod.Request(0, bs[0]), now=0.0, tol=tol * 1e3,
                       until_eff=problem.target_error * 1e3),
             bat.admit(mod.Request(1, bs[1]), now=0.0, tol=tol,
                       until_eff=problem.target_error)]
    assert bat.occupied == 2 and not bat.has_capacity
    log, refilled = [], False
    for call in range(2000):
        rep = bat.micro(8)
        log += [(r.info.request.request_id, r.ops, r.rounds, call,
                 r.degraded) for r in rep.retired]
        if log and not refilled:
            lanes.append(bat.admit(mod.Request(2, bs[2]), now=1.0, tol=tol,
                                   until_eff=problem.target_error))
            refilled = True
        if bat.occupied == 0:
            break
    return lanes, log, bat.to_jsonable(), bat.mean_occupancy


def test_batcher_retire_and_refill_match_reference(graph):
    pr, pt = _problems(graph)
    ref = _staggered(rs, pr)
    got = _staggered(ts, pt, device="cpu")
    assert got[0] == ref[0] == [0, 1, 0]  # the freed lane 0 takes request 2
    assert got[1] == ref[1]
    assert got[1][0][0] == 0, "the loose lane should retire first, alone"
    assert sorted(r[0] for r in got[1]) == [0, 1, 2]
    assert not any(r[4] for r in got[1])  # none degraded
    assert got[2] == ref[2] and got[3] == ref[3]


def test_batcher_graph_switch_requires_drain(graph):
    _, pt = _problems(graph)
    tol = pt.target_error * pt.eps
    bat = ts.ContinuousBatcher(pt, max_lanes=2, device="cpu")
    bat.admit(ts.Request(0, np.asarray(pt.b)), now=0.0, tol=tol,
              until_eff=pt.target_error)
    with pytest.raises(RuntimeError, match="drain"):
        bat.graph_switched(pt)


def test_batcher_refuses_a_missing_card(graph):
    if torch.cuda.is_available():
        pytest.skip("the card is there")
    _, pt = _problems(graph)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.ContinuousBatcher(pt)


# --------------------------------------------------------------------------- #
# Scheduler: event logs against the reference
# --------------------------------------------------------------------------- #
def _run_scenario(name, mod, problem, churn, **kw):
    """One of test_serving.py's scheduler scenarios; returns the
    scheduler."""
    if name == "parity":
        sch = mod.Scheduler(problem, max_lanes=4, rounds_per_tick=16,
                            deadline_s=1e9, **kw)
        for i, b in enumerate(drifting_bs(problem, 6)):
            sch.submit(b, cluster=i % 2, request_id=i)
            sch.run_until_idle()
    elif name == "eviction":
        sch = mod.Scheduler(problem, max_lanes=2, pool_capacity=1,
                            deadline_s=1e9, **kw)
        for i, cluster in enumerate([0, 1, 0, 0]):
            sch.submit(drifting_bs(problem, 1, seed=10 + i)[0],
                       cluster=cluster, request_id=i)
            sch.run_until_idle()
    elif name == "update":
        sch = mod.Scheduler(problem, max_lanes=2, deadline_s=1e9, **kw)
        sch.submit(drifting_bs(problem, 1)[0], cluster=0, request_id=0)
        sch.run_until_idle()
        v0 = sch.problem.graph.version
        sch.submit_update(churn(sch.problem.graph, 2, seed=42),
                          store_version=v0)
        sch.run_until_idle()
        for rid, seed in ((1, 9), (2, 11)):
            sch.submit(drifting_bs(problem, 1, seed=seed)[0], cluster=0,
                       request_id=rid)
            sch.run_until_idle()
    elif name == "overload":
        sch = mod.Scheduler(problem, max_lanes=2, rounds_per_tick=8,
                            deadline_s=0.005, queue_cap=4, **kw)
        for i, b in enumerate(drifting_bs(problem, 12)):
            sch.submit(b, cluster=i % 2, request_id=i, arrival_t=i * 1e-4)
        sch.run_until_idle()
    else:  # poison
        sch = mod.Scheduler(problem, max_lanes=2, deadline_s=1e9, **kw)
        bad = np.asarray(problem.b, dtype=np.float64).copy()
        bad[17] = np.nan
        with pytest.raises(Exception) as err:
            sch.submit(bad, request_id=0)
        assert type(err.value).__name__ == "RequestRejected"
        stale = churn(sch.problem.graph, 2, seed=1)
        with pytest.raises(Exception):
            sch.submit_update(stale, store_version=5)
        sch.submit(drifting_bs(problem, 1)[0], request_id=1)
        sch.run_until_idle()
    return sch


@pytest.mark.parametrize("name", ["parity", "eviction", "update",
                                  "overload", "poison"])
def test_scheduler_matches_reference(graph, name):
    pr, pt = _problems(graph)
    ref = _run_scenario(name, rs, pr, ref_churn)
    before = dict(LAUNCHES)
    got = _run_scenario(name, ts, pt, rotation_churn, device="cpu")
    assert LAUNCHES == before, "a CPU serving run launched a kernel"
    assert got.log.to_jsonable() == ref.log.to_jsonable()
    assert got.to_jsonable() == ref.to_jsonable()
    assert got.quarantine.entries == ref.quarantine.entries
    by_id = {r.request_id: r for r in ref.results}
    assert [r.request_id for r in got.results] == [
        r.request_id for r in ref.results]
    for r in got.results:
        want = by_id[r.request_id]
        assert (r.ops, r.rounds, r.pool_hit, r.converged, r.degraded,
                r.rung) == (want.ops, want.rounds, want.pool_hit,
                            want.converged, want.degraded, want.rung)
        assert np.abs(r.x - want.x).sum() <= 1e-6
    assert got.dropped == 0
    if name == "parity":
        hits = [r.pool_hit for r in sorted(got.results,
                                           key=lambda r: r.request_id)]
        assert hits == [False, False, True, True, True, True]
        xs, _, _ = ts.solo_reference(
            pt, np.stack(drifting_bs(pt, 6), axis=1), device="cpu")
        for r in got.results:
            dx = float(np.abs(r.x - xs[:, r.request_id]).sum())
            assert dx <= 2.0 * pt.target_error, (r.request_id, dx)
    elif name == "update":
        assert got.applied_updates == 1 and got.pool.invalidations >= 1
        assert {r.request_id: r.pool_hit for r in got.results} == {
            0: False, 1: False, 2: True}
    elif name == "overload":
        assert any(r.degraded for r in got.results)
        assert got.log.counts().get("degrade", 0) >= 1


# --------------------------------------------------------------------------- #
# serve rank: the CLI against the reference's
# --------------------------------------------------------------------------- #
_TIMES = re.compile(r"(, )?[0-9.]+s( —|\)|$)|qps=[0-9.]+ |"
                    r"\([0-9.]+ rankings/s\), ")


def _cli(module, *args):
    r = subprocess.run(
        [sys.executable, "-m", module, "rank", "--n", "300", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


def _numbers(out, tags):
    """The lines of ``out`` starting with one of ``tags``, wall times
    and host rates taken out."""
    return [_TIMES.sub("", ln) for ln in out.splitlines()
            if ln.startswith(tags)]


@pytest.mark.parametrize("mode", ["batched", "no-batching"])
def test_serve_rank_cli_matches_reference(mode):
    args = ["--requests", "5", "--batch", "2", "--churn", "0.01",
            "--churn-every", "3", "--poison-every", "4", "--max-lanes", "4"]
    if mode == "no-batching":
        args.append("--no-batching")
    ref = _cli("repro.launch.serve", *args)
    got = _cli("repro_torch.launch.serve", *args, "--device", "cpu")
    if mode == "batched":
        tags = ("[served", "[update", "[quarantine", "[mode")
        assert "[mode ] continuous batching" in got
        assert re.search(r"\[stats\] served=3 dropped=0", got)
    else:
        tags = ("[cold", "[warm", "[update", "[quarantine", "  persona")
        assert "[batch] 2 personalized columns" in got
        batch = re.compile(r"\[batch\].*?(\d+) ops, (\d+) rounds")
        assert batch.search(got).groups() == batch.search(ref).groups()
    want = _numbers(ref, tags)
    assert want and _numbers(got, tags) == want


def test_serve_rank_refuses_unported_flags():
    for flags in (["--ckpt-dir", "x"], ["--resume"],
                  ["--rescale-at", "1", "--rescale-k", "2"]):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "rank",
             "--device", "cpu", *flags],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": SRC})
        assert r.returncode == 2, r.stdout
        assert re.search(r"ROADMAP §1, item [56]", r.stderr), r.stderr


def test_rank_request_validation():
    _, pt = _problems(webgraph_like(50, seed=0))
    sch = ts.Scheduler(pt, device="cpu")
    for bad, reason in ((np.full(50, np.nan), "non-finite"),
                        (-np.ones(50), "negative-mass"),
                        (np.zeros(50), "zero-mass"),
                        (np.ones(49), "bad-shape")):
        with pytest.raises(RequestRejected) as err:
            sch.submit(bad)
        assert err.value.reason == reason
    assert sch.quarantine.total == 4
