"""Port parity for the chaos harness: ``SessionInjector`` in live solves,
``ChaosRunner``'s recovery flow and its recovery-cost row, and elastic K
(``drain_for_shrink`` / ``rescale``) — against the JAX reference on the
same seeded ``webgraph_like`` inputs (n <= 1024), on the CPU.

The frontier cases run both packages in process.  The engine cases at
k=4 need the reference on 4 fake XLA devices: one subprocess, run once
for the module, saves its results; the port runs its K PIDs on one
device in process and must give the same drain list, move log, chaos
log, kills and op counts, and x within 1e-8.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.chaos import ChaosRunner as RefRunner
from repro.core import webgraph_like
from repro_torch.chaos import (ChaosKill, ChaosPlan, ChaosRunner,
                               SessionInjector, tear_checkpoint)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _pair(n=1024, seed=1, **kw):
    g = webgraph_like(n, seed=seed)
    return (repro.Problem.pagerank(g, **kw),
            repro_torch.Problem.pagerank(g, **kw))


def _session(problem, method="frontier:segment_sum", **kw):
    return repro_torch.SolverSession(problem, method=method, device="cpu",
                                     **kw)


# --------------------------------------------------------------------------- #
# the injector in a live solve
# --------------------------------------------------------------------------- #
def test_injector_kill_raises_chaoskill():
    _, pt = _pair()
    with pytest.raises(ChaosKill, match="killed at grain 2") as err:
        for _ in _session(pt).run(
                chaos=SessionInjector(ChaosPlan().kill(0, round=2))):
            pass
    assert (err.value.pid, err.value.round) == (0, 2)
    assert isinstance(err.value, RuntimeError)


def test_injector_validates_at_bind():
    """checkpoint_crash needs a ckpt_dir; single-process frontier drivers
    refuse PID events; rescale needs an engine — the reference's
    errors, raised before any grain runs."""
    _, pt = _pair(256)
    session = _session(pt)
    with pytest.raises(ValueError, match="no .*ckpt_dir"):
        list(session.run(chaos=SessionInjector(
            ChaosPlan().checkpoint_crash(round=1))))
    with pytest.raises(ValueError, match="unsupported"):
        list(session.run(chaos=SessionInjector(
            ChaosPlan().straggler(0, 2.0, round=1))))
    with pytest.raises(ValueError, match="rescale needs an engine"):
        session.rescale(2)
    assert session.n_rounds == 0


def test_tear_checkpoint_is_caught_by_the_invariant(tmp_path):
    """tear_checkpoint zeroes the H leaf; restore rejects the step with
    its invariant reason and, with no fallback left, raises."""
    _, pt = _pair(512)
    session = _session(pt)
    list(session.run(max_rounds=64))
    path = session.checkpoint(str(tmp_path))
    f, h = session._driver.fluid()
    tear_checkpoint(path)
    assert not np.load(os.path.join(path, "arr_00002.npy")).any()
    np.testing.assert_array_equal(
        np.load(os.path.join(path, "arr_00001.npy")), f)
    assert h.any()
    with pytest.raises(ValueError, match="invariant violated"):
        repro_torch.SolverSession.restore(str(tmp_path), pt, device="cpu")


def test_injector_churn_burst_banks_ops():
    """A churn burst rebuilds the driver mid-run (the run loop re-reads
    it) and banks the pushes charged so far."""
    _, pt = _pair(512)
    inj = SessionInjector(ChaosPlan(seed=3).churn_burst(0.01, round=3,
                                                        seed=4))
    session = _session(pt)
    rep = session.solve(chaos=inj)
    assert rep.converged and inj.log == [(3, "churn_burst")]
    assert inj.absorbed_ops > 0
    assert session.lifetime_ops == inj.absorbed_ops + session.n_ops
    assert session.problem.store_version == 1


# --------------------------------------------------------------------------- #
# ChaosRunner against the reference's, in process (frontier)
# --------------------------------------------------------------------------- #
PLANS = {
    # kill, restore, churn burst, torn checkpoint, kill again
    "kill-churn-crash-kill": (
        lambda: ChaosPlan(seed=0).kill(0, round=4)
        .churn_burst(0.01, round=7, seed=5).checkpoint_crash(round=9)
        .kill(0, round=12), 2),
    # every checkpoint pre-dates the churn: a cold restart
    "kill-after-churn-cold": (
        lambda: ChaosPlan(seed=0).churn_burst(0.01, round=3, seed=1)
        .kill(0, round=4), 10 ** 6),
}


@pytest.mark.parametrize("plan,method", [
    ("kill-churn-crash-kill", "frontier:segment_sum"),
    ("kill-after-churn-cold", "frontier:pallas"),
])
def test_chaos_runner_matches_reference(tmp_path, plan, method):
    """ChaosRunner.measure: the recovery-cost row (undisturbed, disturbed,
    wasted and recovered ops, kills, chaos log) equals the reference's;
    x within 1e-8 of it."""
    from repro.chaos import ChaosPlan as RefPlan

    make, every = PLANS[plan]
    pr, pt = _pair(256)
    ref_plan = RefPlan(make().events, seed=make().seed)
    ref = RefRunner(pr, method, ref_plan, ckpt_dir=str(tmp_path / "ref"),
                    checkpoint_every=every).measure()
    runner = ChaosRunner(pt, method, make(), ckpt_dir=str(tmp_path / "port"),
                         options=repro_torch.SolverOptions(device="cpu"),
                         checkpoint_every=every)
    got = runner.measure()
    assert got["converged"] and ref["converged"]
    assert got["kills"] >= 1
    for key in ("undisturbed_ops", "disturbed_ops", "overhead_ops",
                "wasted_ops", "recovered_ops", "final_attempt_ops",
                "kills", "chaos_log"):
        assert got[key] == ref[key], key
    assert abs(got["x_err_l1"] - ref["x_err_l1"]) <= 1e-8


# --------------------------------------------------------------------------- #
# elastic K and the engine runner: the reference on 4 fake devices
# --------------------------------------------------------------------------- #
REF_SCRIPT = textwrap.dedent(
    """
    import os, sys, json, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import numpy as np
    import repro
    from repro.chaos import ChaosPlan, ChaosRunner, SessionInjector
    from repro.core import webgraph_like

    out = {{}}
    g = webgraph_like(1024, seed=1)
    problem = repro.Problem.pagerank(g)

    # rescale 4 -> 3 (strict executor drain) -> 4, mid-solve
    opts = repro.SolverOptions(k=4, buckets_per_dev=12, headroom=4)
    s = repro.SolverSession(problem, method="engine:chunk", options=opts)
    for i, _ in enumerate(s.run()):
        if i >= 1:
            break
    out["ops_before"] = s.n_ops
    out["drains"] = [list(d) for d in s.rescale(3, strict=True)]
    out["sizes_k3"] = s._driver.ex.sizes().tolist()
    for i, _ in enumerate(s.run()):
        if i >= 1:
            break
    out["ops_k3"] = s.n_ops
    out["grow"] = [list(d) for d in s.rescale(4)]
    rep = s.solve()
    out["rescale"] = dict(rounds=rep.n_rounds, ops=rep.n_ops,
                          move_log=[list(m) for m in rep.move_log],
                          x=rep.x.tolist(), k=s._driver.cfg.k,
                          options_k=s.options.k)

    # the runner: straggler, torn checkpoint, kill -> restore -> k-1
    plan = (ChaosPlan(seed=0).straggler(1, 4.0, round=2)
            .checkpoint_crash(round=3).kill(pid=3, round=5))
    with tempfile.TemporaryDirectory() as ckpt:
        runner = ChaosRunner(problem, "engine:chunk", plan, ckpt_dir=ckpt,
                             options=repro.SolverOptions(k=4,
                                                         chunk_rounds=1),
                             checkpoint_every=2)
        m = runner.measure()
    m["chaos_log"] = [list(e) for e in m["chaos_log"]]
    out["runner"] = m

    # the straggler signal sheds load away from the slow pid
    opts = repro.SolverOptions(k=4, policy="hysteresis",
                               buckets_per_dev=24, headroom=4)
    s = repro.SolverSession(repro.Problem.pagerank(g, target_error=2.5e-7),
                            method="engine:chunk", options=opts)
    rep = s.solve(chaos=SessionInjector(
        ChaosPlan().straggler(pid=2, slowdown=64.0, round=2)))
    out["straggler"] = dict(move_log=[list(m) for m in rep.move_log],
                            rounds=rep.n_rounds, ops=rep.n_ops,
                            x=rep.x.tolist(),
                            scale=s._driver.engine.load_scale.tolist())
    with open({path!r}, "w") as f:
        json.dump(out, f)
    print("REF_OK")
    """
)


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference on 4 fake XLA devices, run once for the module."""
    path = str(tmp_path_factory.mktemp("chaos") / "ref4.json")
    r = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT.format(src=SRC, path=path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REF_OK" in r.stdout
    with open(path) as f:
        return json.load(f)


def _problem(**kw):
    return repro_torch.Problem.pagerank(webgraph_like(1024, seed=1), **kw)


def test_rescale_4_3_4_matches_reference(ref4):
    """A mid-solve shrink 4 -> 3 drains the dying PID's 8 buckets
    through the executor, in the reference's order; the grow back needs
    no drain; the solve finishes on the reference's rounds, pushes, move
    log and x, with the counters carried across both rebuilds."""
    s = _session(_problem(), method="engine:chunk", k=4,
                 buckets_per_dev=12, headroom=4)
    for i, _ in enumerate(s.run()):
        if i >= 1:
            break
    assert s.n_ops == ref4["ops_before"]
    drains = s.rescale(3, strict=True)
    assert [list(d) for d in drains] == ref4["drains"]
    assert len(drains) == 8 and all(src == 3 and dst < 3
                                    for src, dst, _ in drains)
    d = s._driver
    assert d.cfg.k == 3 and s.options.k == 3
    assert d.ex.sizes().tolist() == ref4["sizes_k3"] == [8, 8, 8]
    assert np.array_equal(d.ex.row_of_bucket, d.engine.a.pos_of_bucket)
    for i, _ in enumerate(s.run()):
        if i >= 1:
            break
    assert s.n_ops == ref4["ops_k3"]
    assert s.rescale(4) == [] and ref4["grow"] == []
    rep = s.solve()
    want = ref4["rescale"]
    assert rep.converged
    assert (rep.n_rounds, rep.n_ops) == (want["rounds"], want["ops"])
    assert [list(m) for m in rep.move_log] == want["move_log"]
    assert (s._driver.cfg.k, s.options.k) == (want["k"], want["options_k"])
    assert np.abs(rep.x - np.asarray(want["x"])).sum() <= 1e-8


def test_rescale_without_headroom_skips_or_raises():
    """A shrink the survivors' headroom cannot absorb rides the
    node-space carry alone, or raises under strict=True."""
    s = _session(_problem(), method="engine:chunk", k=4, headroom=0)
    with pytest.raises(ValueError, match="cannot shrink to k=2"):
        s.rescale(2, strict=True)
    assert s.rescale(2) == [] and s._driver.cfg.k == 2
    with pytest.raises(ValueError, match="k_new must be >= 1"):
        s.rescale(0)
    rep = s.solve()
    ref = _session(_problem()).solve()
    assert rep.converged
    assert np.abs(rep.x - ref.x).sum() <= 2 * s.problem.target_error


def test_engine_chaos_runner_matches_reference(ref4, tmp_path):
    """ChaosRunner on engine:chunk k=4: a straggler, a torn checkpoint
    and a kill, recovered by restore + rescale to k=3 — the reference's
    row, chaos log and kills."""
    plan = (ChaosPlan(seed=0).straggler(1, 4.0, round=2)
            .checkpoint_crash(round=3).kill(pid=3, round=5))
    runner = ChaosRunner(_problem(), "engine:chunk", plan,
                         ckpt_dir=str(tmp_path),
                         options=repro_torch.SolverOptions(
                             device="cpu", k=4, chunk_rounds=1),
                         checkpoint_every=2)
    got = runner.measure()
    want = ref4["runner"]
    assert got["converged"] and got["kills"] == 1
    got["chaos_log"] = [list(e) for e in got["chaos_log"]]
    for key in ("undisturbed_ops", "disturbed_ops", "overhead_ops",
                "wasted_ops", "recovered_ops", "final_attempt_ops",
                "kills", "chaos_log"):
        assert got[key] == want[key], key
    assert abs(got["x_err_l1"] - want["x_err_l1"]) <= 1e-8


def test_engine_straggler_signal_matches_reference(ref4):
    """A straggler event scales PID 2's load signal by 64; the hysteresis
    controller sheds buckets away from it on the reference's schedule."""
    s = _session(_problem(target_error=2.5e-7), method="engine:chunk",
                 k=4, policy="hysteresis", buckets_per_dev=24, headroom=4)
    rep = s.solve(chaos=SessionInjector(
        ChaosPlan().straggler(pid=2, slowdown=64.0, round=2)))
    want = ref4["straggler"]
    assert rep.converged
    assert s._driver.engine.load_scale.tolist() == want["scale"]
    assert [list(m) for m in rep.move_log] == want["move_log"]
    assert any(m[1] == 2 for m in rep.move_log)
    assert (rep.n_rounds, rep.n_ops) == (want["rounds"], want["ops"])
    assert np.abs(rep.x - np.asarray(want["x"])).sum() <= 1e-8
