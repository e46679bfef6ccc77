"""Port parity for the supervised serving loop: ``RetryPolicy`` /
``CircuitBreaker``, ``SupervisedSession`` against the reference's in
process (frontier:segment_sum and engine:chunk at k=1), the no-fallback
rule for device errors, and — with the reference on 4 fake XLA devices in
one module-scoped subprocess — the breaker's escalation to ``rescale(3)``
and a short chaos stream through ``launch.stream_bench``.  Everything
runs on the CPU on seeded ``webgraph_like`` graphs (n <= 512).

Requests are drifted personalization vectors, as served traffic is.  A
uniformly scaled B puts many nodes on the same |F|·w, and the port's
float32 sums (K3's order) and the reference's (XLA's segment_sum) then
break those ties differently: the op counts of such a solve differ by
under 1 % (9,640 against 9,569 pushes at n=192), with x within the
target error of each other.  Drifted requests have no such ties, and the
counts are equal.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import repro
import repro.chaos
import repro.graph
import repro.resilience
import repro_torch
import repro_torch.chaos
import repro_torch.graph
import repro_torch.resilience
from repro.balance import LoadSignal as RefSignal
from repro.core import webgraph_like
from repro_torch.balance import LoadSignal
from repro_torch.resilience import (CircuitBreaker, RetryPolicy,
                                    SupervisedSession)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ROOT = os.path.dirname(SRC)


# --------------------------------------------------------------------------- #
# retry / breaker / latency signal
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("params", [
    {},
    {"base_delay_s": 0.1, "multiplier": 2.0, "max_delay_s": 0.5,
     "jitter": 0.5, "seed": 3},
    {"base_delay_s": 0.005, "max_delay_s": 0.02, "seed": 0},
    {"base_delay_s": 1e-4, "max_delay_s": 1e-3, "jitter": 0.0, "seed": 7},
])
def test_retry_delays_equal_reference(params):
    """The backoff schedule, float for float: the same PCG64 draw."""
    mine = RetryPolicy(**params)
    ref = repro.resilience.RetryPolicy(**params)
    assert [mine.delay_s(a) for a in range(1, 13)] == [
        ref.delay_s(a) for a in range(1, 13)]


@pytest.mark.parametrize("bad", [{"max_attempts": 0}, {"jitter": 1.0},
                                 {"jitter": -0.1}])
def test_retry_validation_equals_reference(bad):
    with pytest.raises(ValueError) as mine:
        RetryPolicy(**bad)
    with pytest.raises(ValueError) as ref:
        repro.resilience.RetryPolicy(**bad)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="attempt must be >= 1"):
        RetryPolicy().delay_s(0)


def test_circuit_breaker_states_equal_reference():
    """One sequence of failures, successes and resets: the same tripped
    states, streaks and trip counts."""
    ops = "fffrffsfffrfff"
    states = []
    for br in (CircuitBreaker(trip_after=3),
               repro.resilience.CircuitBreaker(trip_after=3)):
        seq = []
        for op in ops:
            if op == "f":
                seq.append(br.record_failure())
            elif op == "s":
                br.record_success()
            else:
                br.reset()
            seq.append((br.tripped, br.consecutive_failures, br.trips))
        states.append(seq)
    assert states[0] == states[1]
    assert states[0][-1] == (True, 3, 2)
    with pytest.raises(ValueError):
        CircuitBreaker(trip_after=0)


def test_latency_signal_equals_reference():
    for args in ((0.5, 1.0, 4, 8), (0.02, 0.05, 0, 8), (3.0, 0.05, 9, 4)):
        a, b = LoadSignal.from_latency(*args), RefSignal.from_latency(*args)
        assert a.kind == b.kind == "latency"
        assert np.array_equal(a.values, b.values)
        assert np.array_equal(a.sizes, b.sizes)
    with pytest.raises(ValueError):
        LoadSignal.from_latency(1.0, 0.0)


# --------------------------------------------------------------------------- #
# the supervisor against the reference's, in process
# --------------------------------------------------------------------------- #
N = 192
PKGS = {
    "ref": types.SimpleNamespace(
        api=repro, res=repro.resilience, chaos=repro.chaos,
        graph=repro.graph, opts=lambda **kw: repro.SolverOptions(**kw)),
    "port": types.SimpleNamespace(
        api=repro_torch, res=repro_torch.resilience, chaos=repro_torch.chaos,
        graph=repro_torch.graph,
        opts=lambda **kw: repro_torch.SolverOptions(device="cpu", **kw)),
}


def _problem(pkg, n=N):
    return pkg.api.Problem.pagerank(
        pkg.graph.GraphStore.from_csr(webgraph_like(n, seed=1)))


def _sup(pkg, method, td, **kw):
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("retry", pkg.res.RetryPolicy(base_delay_s=1e-4,
                                               max_delay_s=1e-3))
    k = 1 if method.startswith("engine") else None
    return pkg.res.SupervisedSession(_problem(pkg), method=method,
                                     options=pkg.opts(k=k), ckpt_dir=td,
                                     **kw)


def _drift(b, seed):
    rng = np.random.default_rng(seed)
    return np.abs(b * (1 + 0.01 * rng.standard_normal(b.shape[0])))


def _plain(pkg, method):
    k = 1 if method.startswith("engine") else None
    return pkg.api.SolverSession(_problem(pkg), method=method,
                                 options=pkg.opts(k=k))


def _kill_retry(pkg, method, td):
    sup = _sup(pkg, method, td)
    plain = _plain(pkg, method)
    rng = np.random.default_rng(0)
    b = np.asarray(sup.session.problem.b)
    dx = []
    for i in range(4):
        b = np.abs(b * (1 + 0.01 * rng.standard_normal(N)))
        chaos = (pkg.chaos.SessionInjector(pkg.chaos.ChaosPlan().kill(
            0, round=1)) if i == 2 else None)
        out = sup.serve_rank(b, request_id=i, chaos=chaos)
        assert out.ok and (out.attempts, out.restores) == (
            (2, 1) if i == 2 else (1, 0))
        plain.warm_start(b)
        plain.solve()
        dx.append(float(np.abs(out.x - plain.x).sum()))
    assert dx == [0.0] * 4  # the retry replays the undisturbed trajectory
    # the kill fired before the first grain: nothing was wasted
    assert sup.total_ops == plain.lifetime_ops and sup.wasted_ops == 0
    return sup


def _poison(pkg, method, td):
    sup = _sup(pkg, method, td)
    b = _drift(np.asarray(sup.session.problem.b), 1)
    bad = b.copy()
    bad[5] = np.nan
    out = sup.serve_rank(bad, request_id="p")
    assert out.rejected and out.reject_reason == "non-finite"
    assert sup.serve_rank(b, request_id="ok").converged
    assert sup.quarantine.by_reason == {"non-finite": 1}
    return sup


def _defer_flush(pkg, method, td):
    sup = _sup(pkg, method, td)
    plain = _plain(pkg, method)
    sup.ladder.index = 1  # the defer-updates rung
    d = pkg.graph.rotation_churn(sup.session.problem.graph, 3, seed=7)
    out = sup.serve_update(d, store_version=sup.session.problem.store_version,
                           request_id="u")
    assert out.deferred and sup.deferred_updates == 1
    b = _drift(np.asarray(sup.session.problem.b), 2)
    o1 = sup.serve_rank(b, request_id=0)  # served on the STALE graph
    plain.warm_start(b)
    plain.solve()
    assert float(np.abs(o1.x - plain.x).sum()) == 0.0
    sup.ladder.index = 0
    assert sup.flush_deferred() == 1 and sup.deferred_updates == 0
    plain.update_graph(pkg.graph.rotation_churn(plain.problem.graph, 3,
                                                seed=7))
    plain.solve()
    b2 = _drift(b, 3)
    o2 = sup.serve_rank(b2, request_id=1)
    plain.warm_start(b2)
    plain.solve()
    assert float(np.abs(o2.x - plain.x).sum()) == 0.0
    return sup


def _stale_conflict(pkg, method, td):
    sup = _sup(pkg, method, td)
    g = sup.session.problem.graph
    d = pkg.graph.rotation_churn(g, 2, seed=5)
    out = sup.serve_update(d, store_version=999, request_id="s")
    assert out.rejected and out.reject_reason == "stale-store-version"
    src, dst, _ = g.csr().edge_list()
    keys = set(zip(src.tolist(), dst.tolist()))
    cand = next((s, t) for s in range(N) for t in range(N)
                if (s, t) not in keys)
    z2, z1 = np.zeros((0, 2), np.int64), np.zeros(0)
    ghost = pkg.graph.GraphDelta(added=z2, added_w=z1,
                                 removed=np.asarray([cand], np.int64),
                                 reweighted=z2, reweighted_w=z1)
    assert sup.serve_update(ghost, request_id="g").reject_reason == (
        "missing-edge")
    sup.ladder.index = 1  # deferring: no membership check at admission
    assert sup.serve_update(ghost, request_id="g2").deferred
    sup.ladder.index = 0
    sup.flush_deferred()
    assert sup.quarantine.by_reason.get("conflict-at-apply") == 1
    assert sup.serve_rank(_drift(np.asarray(sup.session.problem.b), 4),
                          request_id="after").ok
    return sup


def _op_budget(pkg, method, td):
    sup = _sup(pkg, method, td, op_budget=1)
    out = sup.serve_rank(_drift(np.asarray(sup.session.problem.b), 5),
                         request_id=0)
    assert out.ok and out.budget_exhausted and out.degraded
    return sup


def _cold_restart(pkg, method, td):
    sup = _sup(pkg, method, td)
    b = _drift(np.asarray(sup.session.problem.b), 6)
    assert sup.serve_rank(b, request_id=0).ok
    for name in sorted(os.listdir(td)):  # rot: every leaf vanishes
        step = os.path.join(td, name)
        for leaf in os.listdir(step):
            if leaf.endswith(".npy"):
                os.remove(os.path.join(step, leaf))
    chaos = pkg.chaos.SessionInjector(pkg.chaos.ChaosPlan().kill(0, round=1))
    out = sup.serve_rank(_drift(b, 7), request_id=1, chaos=chaos)
    assert out.ok and out.converged
    assert sup.log.counts().get("cold_restart", 0) == 1
    return sup


SCENARIOS = {"kill-retry": _kill_retry, "poison": _poison,
             "defer-flush": _defer_flush, "stale-conflict": _stale_conflict,
             "op-budget": _op_budget, "cold-restart": _cold_restart}


def _log(sup):
    """The event log's kinds, request ids and ops, in order."""
    return [(e.kind, e.detail.get("request_id"), e.detail.get("ops"))
            for e in sup.log]


@pytest.mark.parametrize("method", ["frontier:segment_sum", "engine:chunk"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisor_matches_reference(tmp_path, scenario, method):
    """The same stream through both supervisors: equal event logs (kinds,
    request ids, ops), quarantine, op and restore accounting."""
    run = SCENARIOS[scenario]
    ref = run(PKGS["ref"], method, str(tmp_path / "ref"))
    got = run(PKGS["port"], method, str(tmp_path / "port"))
    assert _log(got) == _log(ref)
    assert got.quarantine.entries == ref.quarantine.entries
    assert (got.total_ops, got.wasted_ops, got.restores, got.served) == (
        ref.total_ops, ref.wasted_ops, ref.restores, ref.served)


def test_device_errors_are_not_retried(tmp_path):
    """A RuntimeError inside a driver's advance (what a failed kernel
    launch or a CUDA fault raises) propagates out of serve_rank on the
    first attempt: no fault absorbed, no restore, nothing served."""
    sup = _sup(PKGS["port"], "frontier:segment_sum", str(tmp_path))
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    sup.session._driver.advance = broken
    with pytest.raises(RuntimeError, match="CUDA error"):
        sup.serve_rank(np.asarray(sup.session.problem.b), request_id=0)
    assert len(calls) == 1
    counts = sup.log.counts()
    assert counts.get("restore", 0) == counts.get("fault", 0) == 0
    assert counts.get("request_served", 0) == 0 and sup.restores == 0
    # a ChaosKill or a host I/O error still is retried
    for err in (repro_torch.chaos.ChaosKill(0, 1),
                OSError(5, "Input/output error")):
        fresh = _sup(PKGS["port"], "frontier:segment_sum",
                     str(tmp_path / type(err).__name__))
        drv, real = fresh.session._driver, fresh.session._driver.advance
        state = {"raised": False}

        def flaky(*a, _err=err, **kw):
            if not state["raised"]:
                state["raised"] = True
                raise _err
            return real(*a, **kw)

        drv.advance = flaky
        out = fresh.serve_rank(np.asarray(fresh.session.problem.b),
                               request_id=0)
        assert out.ok and out.attempts == 2 and out.restores == 1


def test_updates_do_not_retry_device_errors(tmp_path):
    """The same rule on the update path: a RuntimeError while draining
    an applied delta propagates on the first attempt."""
    sup = _sup(PKGS["port"], "frontier:segment_sum", str(tmp_path))
    delta = repro_torch.graph.rotation_churn(sup.session.problem.graph, 2,
                                             seed=1)
    real = repro_torch.SolverSession.run

    def broken(self, *a, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")
        yield  # pragma: no cover - a generator, as run is

    repro_torch.SolverSession.run = broken
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            sup.serve_update(delta, request_id="u")
    finally:
        repro_torch.SolverSession.run = real
    assert sup.log.counts().get("fault", 0) == 0 and sup.restores == 0


# --------------------------------------------------------------------------- #
# the reference on 4 fake devices: breaker escalation and a chaos stream
# --------------------------------------------------------------------------- #
STREAM = dict(n=512, k=4, requests=24, churn_every=6, poison_every=7,
              stale_update_at=17, kill_at=(3, 14), rescale_at={9: 3, 19: 4},
              straggler=(10, 13, 6.0), sample_every=2, chunk_rounds=2,
              seed=0)

REF_SCRIPT = textwrap.dedent(
    """
    import os, sys, json, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {root!r})
    import numpy as np
    import repro
    from repro.chaos import ChaosPlan, SessionInjector
    from repro.core import webgraph_like
    from repro.graph import GraphStore
    from repro.resilience import (CircuitBreaker, RetryPolicy,
                                  SupervisedSession)
    from benchmarks.stream_bench import (StreamSpec, replay_reference,
                                         run_stream, stream_row)

    out = {{}}
    prob = repro.Problem.pagerank(GraphStore.from_csr(
        webgraph_like(512, seed=1)))
    with tempfile.TemporaryDirectory() as td:
        sup = SupervisedSession(
            prob, method="engine:chunk",
            options=repro.SolverOptions(k=4, chunk_rounds=1), ckpt_dir=td,
            retry=RetryPolicy(max_attempts=5, base_delay_s=1e-4,
                              max_delay_s=1e-3),
            breaker=CircuitBreaker(trip_after=3), sleep=lambda s: None)
        plan = (ChaosPlan(seed=0).kill(3, round=1).kill(3, round=2)
                .kill(3, round=3))
        o = sup.serve_rank(np.asarray(prob.b), request_id=0,
                           chaos=SessionInjector(plan))
        out["breaker"] = dict(
            ok=o.ok, attempts=o.attempts, restores=o.restores, ops=o.ops,
            x=o.x.tolist(), k=sup.session._driver.cfg.k,
            trips=sup.breaker.trips,
            log=[[e.kind, e.detail.get("k_new"), e.detail.get("drains")]
                 for e in sup.log])

    spec = StreamSpec(**{stream!r})
    with tempfile.TemporaryDirectory() as ckpt:
        run = run_stream(spec, ckpt)
    ref = replay_reference(spec, run)
    out["row"] = stream_row("soak", spec, run, ref)
    out["effective"] = [list(e) for e in run["effective"]]
    out["log"] = [[e.kind, e.detail.get("request_id"), e.detail.get("ops")]
                  for e in run["sup"].log]
    out["samples"] = {{str(i): x.tolist() for i, x in
                       run["samples"].items()}}
    out["ref_samples"] = {{str(i): x.tolist() for i, x in
                           ref["samples"].items()}}
    with open({path!r}, "w") as f:
        json.dump(out, f)
    print("REF_OK")
    """
)


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference on 4 fake XLA devices, run once for the module."""
    path = str(tmp_path_factory.mktemp("resilience") / "ref4.json")
    r = subprocess.run(
        [sys.executable, "-c",
         REF_SCRIPT.format(src=SRC, root=ROOT, path=path, stream=STREAM)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REF_OK" in r.stdout
    with open(path) as f:
        return json.load(f)


def test_breaker_escalates_to_rescale_like_reference(ref4, tmp_path):
    """Three kills in one request trip the breaker on the third: restore,
    then rescale to the surviving width (k=3), then serve — the
    reference's attempts, ops, event log and x."""
    pkg = PKGS["port"]
    prob = _problem(pkg, 512)
    sup = SupervisedSession(
        prob, method="engine:chunk", options=pkg.opts(k=4, chunk_rounds=1),
        ckpt_dir=str(tmp_path),
        retry=RetryPolicy(max_attempts=5, base_delay_s=1e-4,
                          max_delay_s=1e-3),
        breaker=CircuitBreaker(trip_after=3), sleep=lambda s: None)
    plan = (repro_torch.chaos.ChaosPlan(seed=0).kill(3, round=1)
            .kill(3, round=2).kill(3, round=3))
    out = sup.serve_rank(np.asarray(prob.b), request_id=0,
                         chaos=repro_torch.chaos.SessionInjector(plan))
    want = ref4["breaker"]
    assert out.ok and out.converged and out.attempts == 4
    assert (out.attempts, out.restores, out.ops) == (
        want["attempts"], want["restores"], want["ops"])
    assert (sup.session._driver.cfg.k, sup.breaker.trips) == (
        want["k"], want["trips"]) == (3, 1)
    assert [[e.kind, e.detail.get("k_new"), e.detail.get("drains")]
            for e in sup.log] == want["log"]
    assert np.abs(out.x - np.asarray(want["x"])).sum() <= 1e-8


def test_short_stream_matches_reference(ref4, tmp_path):
    """A 24-request stream at n=512, k=4 — two kills, a 4 -> 3 -> 4
    rescale, a straggler window, poison and a stale update — through the
    port's stream_bench: the reference's effective schedule, event log
    and row, and every sampled x within 1e-8 of the reference's (and of
    its undisturbed twin's)."""
    from repro_torch.launch.stream_bench import (StreamSpec,
                                                 replay_reference,
                                                 run_stream, stream_row)

    spec = StreamSpec(**STREAM)
    run = run_stream(spec, str(tmp_path), device="cpu")
    ref = replay_reference(spec, run, device="cpu")
    row = stream_row("soak", spec, run, ref)
    assert [list(e) for e in run["effective"]] == ref4["effective"]
    assert [[e.kind, e.detail.get("request_id"), e.detail.get("ops")]
            for e in run["sup"].log] == ref4["log"]
    want = ref4["row"]
    for key in ("served", "dropped", "rejected", "applied_updates",
                "total_ops", "undisturbed_ops", "wasted_ops",
                "checked_points", "kills", "restores", "rescales",
                "converged"):
        assert row[key] == want[key], key
    assert (row["kills"], row["rescales"], row["dropped"]) == (2, 2, 0)
    assert abs(row["max_dx_l1"] - want["max_dx_l1"]) <= 1e-8
    assert sorted(run["samples"]) == sorted(int(i) for i in
                                            ref4["samples"])
    for i, x in run["samples"].items():
        assert np.abs(x - np.asarray(ref4["samples"][str(i)])).sum() <= 1e-8
        assert np.abs(ref["samples"][i] - np.asarray(
            ref4["ref_samples"][str(i)])).sum() <= 1e-8
    q = run["sup"].quarantine.by_reason
    assert q == {"non-finite": 3, "stale-store-version": 1}
