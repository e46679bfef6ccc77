"""Port parity for the simulator slice: repro_torch's K-PID simulator, its
static partitions, its node moves and its chaos plan, on the CPU (K7's
plain push), against the reference's on the same seeded graphs.

The instances are tests/test_simulator.py's (``small_pagerank``: K 1/2/4/8
× uniform/cb, dynamic, batch, the neglected exchange cost),
``skewed_pagerank``'s out-degree order at K=8 and 16 with the three
policies, and tests/test_chaos.py's simulator chaos plans on
``webgraph_like(1024, seed=1)``.  Each asserts the counters exactly —
steps, edge ops, exchanges, moves, the move log, ``count_active``,
``count_idle``, ``hist_sizes`` — and |Δh|_1 <= 1e-10, plus the
reference's own behavioural assertions.  Exact counters need the same
schedule: the port reads its sums through ``torch.sum`` where the
reference reads numpy's pairwise sums, and no case here has a decision on
a tie between the two.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro.core as ref_core
import repro_torch
import repro_torch.core as core
from repro.balance.executors import NodeMoveExecutor as RefNodeMoveExecutor
from repro.balance.plan import MovePlan as RefMovePlan
from repro.chaos.plan import ChaosPlan as RefChaosPlan
from repro.core import webgraph_like
from repro.core.partition import MoveInstruction as RefMoveInstruction
from repro_torch.balance import MovePlan, NodeMoveExecutor
from repro_torch.chaos import ChaosPlan
from repro_torch.core.partition import MoveInstruction
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.sim_push import sim_messages, sim_push

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

EPS = 0.15


def _pair(p, b, **kw):
    """The reference's run and the port's on the CPU, one config."""
    kw.setdefault("target_error", 1e-6)
    kw.setdefault("eps", EPS)
    kw.setdefault("record_every", 25)
    ref = ref_core.DistributedSimulator(
        p, b, ref_core.SimulatorConfig(**kw)).run()
    got = core.DistributedSimulator(
        p, b, core.SimulatorConfig(device="cpu", **kw)).run()
    _same(ref, got)
    return ref, got


def _same(ref, got):
    assert got.converged == ref.converged
    assert (got.n_steps, got.n_edge_ops, got.n_exchanges, got.n_moves) == (
        ref.n_steps, ref.n_edge_ops, ref.n_exchanges, ref.n_moves)
    assert got.move_log == ref.move_log
    assert got.chaos_log == ref.chaos_log
    np.testing.assert_array_equal(got.count_active, ref.count_active)
    np.testing.assert_array_equal(got.count_idle, ref.count_idle)
    np.testing.assert_array_equal(got.hist_sizes, ref.hist_sizes)
    np.testing.assert_array_equal(got.hist_steps, ref.hist_steps)
    assert got.cost_iterations == ref.cost_iterations
    assert float(np.abs(got.h.numpy() - ref.h).sum()) <= 1e-10


# --------------------------------------------------------------------------- #
# tests/test_simulator.py's instances
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("partition", ["uniform", "cb"])
def test_sequential_matches_reference(small_pagerank, k, partition):
    p, b, x = small_pagerank
    _, got = _pair(p, b, k=k, partition=partition)
    assert got.converged
    np.testing.assert_allclose(got.h.numpy(), x, atol=1e-5)
    assert got.n_exchanges > 0 or k == 1
    # active + idle per PID ~ steps × PID_Speed (cost model §2.3)
    speed = p.n // k
    per_pid = got.count_active + got.count_idle
    assert np.all(per_pid <= got.n_steps * speed + 3 * speed)


@pytest.mark.parametrize("dynamic", [False, True])
def test_dynamic_matches_reference(small_pagerank, dynamic):
    p, b, x = small_pagerank
    _, got = _pair(p, b, k=4, dynamic=dynamic)
    assert got.converged
    np.testing.assert_allclose(got.h.numpy(), x, atol=1e-5)


def test_batch_mode_matches_reference(small_pagerank):
    p, b, x = small_pagerank
    _, got = _pair(p, b, k=4, mode="batch", dynamic=True)
    assert got.converged
    np.testing.assert_allclose(got.h.numpy(), x, atol=1e-5)


def test_charge_exchange_matches_reference(small_pagerank):
    """Charging the exchange cost can only slow convergence (C1); K=4 at
    1/N converges in fewer wall steps than K=1 (C3)."""
    p, b, _ = small_pagerank
    _, free = _pair(p, b, k=8, charge_exchange=False, target_error=1.0 / p.n)
    _, paid = _pair(p, b, k=8, charge_exchange=True, target_error=1.0 / p.n)
    assert paid.cost_iterations >= free.cost_iterations - 1e-9
    _, r1 = _pair(p, b, k=1, target_error=1.0 / p.n)
    _, r4 = _pair(p, b, k=4, target_error=1.0 / p.n)
    assert r1.converged and r1.cost_iterations < 25
    assert r4.cost_iterations < r1.cost_iterations


@pytest.mark.parametrize("k", [8, 16])
def test_skewed_order_matches_reference(skewed_pagerank, k):
    """Paper Tables 2/3: dynamic rescues badly-ordered partitions."""
    p, b, _ = skewed_pagerank
    _, sta = _pair(p, b, k=k, dynamic=False, target_error=1.0 / p.n)
    _, dyn = _pair(p, b, k=k, dynamic=True, target_error=1.0 / p.n)
    assert sta.converged and dyn.converged
    if k == 16:
        assert dyn.cost_iterations < sta.cost_iterations
    else:
        assert dyn.n_moves >= 1
        assert dyn.hist_sizes.shape[1] == 8
        assert dyn.hist_sizes[-1].std() > 0


@pytest.mark.parametrize("policy,signal", [
    ("cost_refresh", "edge-ops"), ("hysteresis", "residual"),
])
def test_policies_match_reference(skewed_pagerank, policy, signal):
    p, b, _ = skewed_pagerank
    _, got = _pair(p, b, k=8, policy=policy, signal=signal,
                   target_error=1.0 / p.n)
    assert got.converged


# --------------------------------------------------------------------------- #
# tests/test_chaos.py's simulator plans, each package's own ChaosPlan
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def web1024():
    return repro.Problem.pagerank(webgraph_like(1024, seed=1))


def _chaos_pair(problem, make_plan, dynamic=True):
    kw = dict(k=4, target_error=problem.target_error, eps=problem.eps,
              mode="batch", dynamic=dynamic, record_every=50)
    ref_sim = ref_core.DistributedSimulator(
        problem.p, problem.b, ref_core.SimulatorConfig(**kw))
    sim = core.DistributedSimulator(
        problem.p, problem.b, core.SimulatorConfig(device="cpu", **kw))
    ref = ref_sim.run(chaos=None if make_plan is None
                      else make_plan(RefChaosPlan))
    got = sim.run(chaos=None if make_plan is None else make_plan(ChaosPlan))
    _same(ref, got)
    assert got.chaos_log == ref.chaos_log
    assert sim.speed_factor.tolist() == ref_sim.speed_factor.tolist()
    assert [s.tolist() for s in sim.sets] == [s.tolist()
                                              for s in ref_sim.sets]
    return sim, got


PLANS = {
    "replay": lambda P: P(seed=1).straggler(1, 4.0, round=3).kill(
        2, round=10).rescale(2, round=25),
    "kill": lambda P: P().kill(3, round=5),
    "rescale": lambda P: P().rescale(2, round=8),
    "straggler_rescale": lambda P: P().straggler(1, 4.0, round=3).rescale(
        2, round=8),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_chaos_plans_match_reference(web1024, name):
    sim, res = _chaos_pair(web1024, PLANS[name])
    assert res.converged
    tol = 2 * web1024.target_error
    if name == "replay":  # the same plan replays bit for bit
        _, again = _chaos_pair(web1024, PLANS[name])
        assert torch.equal(again.h, res.h)
        assert again.chaos_log == res.chaos_log
    elif name == "kill":
        _, base = _chaos_pair(web1024, None)
        assert sim.sets[3].numel() == 0 and sim.speed_factor[3] == 0.0
        assert all(sim.sets[k].numel() > 0 for k in range(3))
        handovers = [m for m in res.move_log if m[1] == 3]
        assert handovers and sum(m[3] for m in handovers) > 0
        assert float((res.h - base.h).abs().sum()) <= tol
    elif name == "rescale":
        _, base = _chaos_pair(web1024, None)
        assert sim.k == 2 and len(sim.sets) == 2
        assert sorted(torch.cat(sim.sets).tolist()) == list(range(1024))
        assert float((res.h - base.h).abs().sum()) <= tol
        assert res.hist_rs.ndim == 2 and res.hist_sizes.ndim == 2
    else:
        assert sim.speed_factor.tolist() == [1.0, 0.25]


def test_straggler_dynamic_beats_static_like_reference(web1024):
    """A 4× straggler costs the static partition more wall steps than
    the dynamic one (§2.5.2 under degradation)."""

    def straggle(P):
        return P().straggler(1, 4.0, round=5)

    overhead = {}
    for dyn in (True, False):
        _, base = _chaos_pair(web1024, None, dynamic=dyn)
        _, hit = _chaos_pair(web1024, straggle, dynamic=dyn)
        assert hit.converged
        overhead[dyn] = hit.n_steps - base.n_steps
    assert overhead[False] > overhead[True], overhead


def test_chaos_plan_validates_like_reference():
    with pytest.raises(ValueError, match="unsupported here"):
        ChaosPlan().churn_burst(0.01, round=2).validate(
            4, kinds=("straggler", "kill", "rescale"))
    with pytest.raises(ValueError, match="only 2 PIDs"):
        ChaosPlan().rescale(2, round=1).kill(3, round=2).validate(4)
    a = ChaosPlan.random(seed=5, k=8, rounds=20, n_events=6)
    b = RefChaosPlan.random(seed=5, k=8, rounds=20, n_events=6)
    assert [dataclasses.asdict(e) for e in a] == [
        dataclasses.asdict(e) for e in b]


# --------------------------------------------------------------------------- #
# static partitions, apply_move, NodeMoveExecutor (tests/test_partition.py,
# tests/test_balance.py:109)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (100, 64), (5000, 64),
                                 (64, 64)])
def test_uniform_partition_matches_reference(n, k):
    got = core.uniform_partition(n, k)
    want = ref_core.uniform_partition(n, k)
    assert [s.tolist() for s in got] == [s.tolist() for s in want]
    assert all(s.dtype == torch.int64 for s in got)


@pytest.mark.parametrize("n,k,seed", [(10, 1, 0), (100, 16, 42),
                                      (2000, 16, 3), (11, 16, 7)])
def test_cb_partition_matches_reference(n, k, seed):
    deg = np.random.default_rng(seed).zipf(1.6, n).astype(np.int64)
    got = core.cb_partition(deg, k)
    want = ref_core.cb_partition(deg, k)
    assert [s.tolist() for s in got] == [s.tolist() for s in want]
    assert core.partition_bounds_to_sets([0, 3, 3, 9])[1].numel() == 0


@pytest.mark.parametrize("sizes,n_move", [((50, 10), 5), ((3, 57), 99)])
def test_apply_move_matches_reference(sizes, n_move):
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    ref_sets = [np.arange(bounds[i], bounds[i + 1]) for i in range(2)]
    sets = [torch.from_numpy(s) for s in ref_sets]
    new, moved = core.apply_move(sets, MoveInstruction(0, 1, n_move))
    ref_new, ref_moved = ref_core.apply_move(
        ref_sets, RefMoveInstruction(0, 1, n_move))
    assert moved == ref_moved and moved == min(n_move, sizes[0] - 1)
    assert [s.tolist() for s in new] == [s.tolist() for s in ref_new]


def test_node_move_executor_matches_reference(small_pagerank):
    p, b, _ = small_pagerank
    kw = dict(k=4, target_error=1e-6, eps=EPS)
    ref = ref_core.DistributedSimulator(p, b, ref_core.SimulatorConfig(**kw))
    sim = core.DistributedSimulator(p, b, core.SimulatorConfig(device="cpu",
                                                               **kw))
    ex, ref_ex = NodeMoveExecutor(sim), RefNodeMoveExecutor(ref)
    size0 = sim.sets[0].numel()
    for src, dst, units in ((0, 2, 10), (0, 1, 10_000)):
        moved = ex.apply(MovePlan(src=src, dst=dst, units=units,
                                  kind="node"))
        assert moved == ref_ex.apply(RefMovePlan(src=src, dst=dst,
                                                 units=units, kind="node"))
        assert [s.tolist() for s in sim.sets] == [s.tolist()
                                                  for s in ref.sets]
        assert sim.owner.tolist() == ref.owner.tolist()
        np.testing.assert_array_equal(sim.count_active, ref.count_active)
        np.testing.assert_array_equal(sim.debt, ref.debt)
        np.testing.assert_array_equal(sim.t_k, ref.t_k)
        if units == 10:
            assert moved == 10 and sim.sets[0].numel() == size0 - 10
            assert bool((sim.owner[sim.sets[2]] == 2).all())
            assert sim.debt[0] == -10 and sim.debt[2] == -10
    # a plan that would empty the source is clipped, never emptied
    assert sim.sets[0].numel() == 1 and sim.n_moves == 2 == ref.n_moves


# --------------------------------------------------------------------------- #
# K7's plain version, the simulator's config and its front door
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,e,n_dst", [(1, 5, 1), (300, 4000, 40),
                                       (5000, 200_000, 900), (1000, 4097, 1),
                                       (5000, 100_000, 3)])
def test_sim_push_plain_is_np_add_at(n, e, n_dst):
    """K7's plain version gives np.add.at's bits for a diffusion's two
    scatters, repeated destinations and all (the fluid and PID 1's outbox
    as views of one state buffer), hubs of thousands of messages among
    them, and launches nothing for CPU tensors."""
    rng = np.random.default_rng(n + e)
    owner = rng.integers(0, 3, n).astype(np.int32)
    dst = rng.choice(n, n_dst)[rng.integers(0, n_dst, e)]
    msg = rng.standard_normal(e) * 10.0 ** rng.uniform(-9, 2, e)
    f, outbox = rng.standard_normal(n), rng.standard_normal(n)
    local = owner[dst] == 1
    want_f, want_o = f.copy(), outbox.copy()
    np.add.at(want_f, dst[local], msg[local])
    np.add.at(want_o, dst[~local], msg[~local])
    state = torch.from_numpy(np.concatenate([f, outbox]))
    key = torch.from_numpy(np.where(local, dst, n + dst).astype(np.int32))
    before = dict(LAUNCHES)
    sim_push(state, key, torch.from_numpy(msg))
    assert LAUNCHES == before
    assert np.array_equal(state[:n].numpy(), want_f)
    assert np.array_equal(state[n:].numpy(), want_o)


def test_sim_push_plain_adds_in_message_order_for_unsorted_keys():
    """K7's contract on CPU tensors, the one the card tests hold the kernel
    to: keys in no order, each repeated, with values whose sum changes with
    the add order (1e16, 1, -1e16, u per key: u in message order, 0
    backwards), give np.add.at's bits."""
    rng = np.random.default_rng(22)
    keys = np.repeat(rng.permutation(500)[:200], 4)
    keys = np.concatenate([keys, np.full(40, 499)])[
        rng.permutation(840)]  # interleaved, not ascending
    msg = np.empty(keys.size)
    for d in np.unique(keys):
        at = np.flatnonzero(keys == d)
        run = np.tile([1e16, 1.0, -1e16, 0.0], at.size // 4)
        run[3::4] = rng.standard_normal(at.size // 4)
        msg[at] = run
    state = rng.standard_normal(500)
    want, backwards = state.copy(), state.copy()
    np.add.at(want, keys, msg)
    np.add.at(backwards, keys[::-1], msg[::-1])
    assert not np.array_equal(want, backwards)  # the order shows
    got = torch.from_numpy(state.copy())
    sim_push(got, torch.from_numpy(keys.astype(np.int32)),
             torch.from_numpy(msg))
    assert np.array_equal(got.numpy(), want)


def _k7_probe():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / (
        "k7_probe.py")
    spec = importlib.util.spec_from_file_location("k7_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["sim_push", "sim_messages"])
def test_k7_probe_phases_match_the_hooks(kernel):
    """tools/k7_probe.py's `phases` build names the slots that each
    kernel's hooks in csrc/sim_push.cu fill: the slot of its K7_START, then
    one up at each K7_STAMP.  Its stamp header defines both hooks, which
    the .cu declares empty, so the probe cannot rot."""
    import re

    probe = _k7_probe()
    src = (probe.ROOT / "src" /
           "repro_torch" / "csrc" / "sim_push.cu").read_text()
    for hook in ("K7_START", "K7_STAMP"):
        assert f"#define {hook}" in src and f"#define {hook}" in probe.STAMPS
    body = src[src.index(f"\n{kernel}_kernel("):]
    body = body[:body.index("\n}\n")]
    first = int(re.search(r"K7_START\((\d+)\);", body).group(1))
    stamps = body.count("K7_STAMP;")
    assert set(probe.PHASES[kernel]) == set(range(first, first + stamps))


def test_sim_push_takes_int32_keys_only():
    """K7's keys are int32, as ``sim_messages`` makes them: an int64 key
    is refused on every device, before anything is added."""
    state = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="int32"):
        sim_push(state, torch.tensor([1, 1, 3]), torch.ones(3,
                                                         dtype=torch.float64))
    assert torch.equal(state, torch.zeros(8, dtype=torch.float64))


def test_sim_messages_plain_is_the_references_expansion(small_pagerank):
    """K7's messages on the CPU: the reference's ``np.repeat(sent, lens) *
    w[edges]`` bit for bit, each keyed to the fluid (a local destination)
    or the pushing PID's outbox, and |msg| for the remote ones only."""
    p, _, _ = small_pagerank
    rng = np.random.default_rng(3)
    n, k = p.n, 4
    sel = rng.choice(n, 120, replace=False)
    pid = rng.integers(0, k, sel.size)
    sent = rng.standard_normal(sel.size)
    owner = rng.integers(0, k, n).astype(np.int32)
    lens = p.indptr[sel + 1] - p.indptr[sel]
    edges = np.concatenate([np.arange(p.indptr[i], p.indptr[i + 1])
                            for i in sel])
    msg = np.repeat(sent, lens) * p.weights[edges]
    dst, push_pid = p.indices[edges].astype(np.int64), np.repeat(pid, lens)
    local = owner[dst] == push_pid
    key, got, rabs = sim_messages(
        torch.from_numpy(sel), torch.from_numpy(pid), torch.from_numpy(sent),
        torch.from_numpy(np.diff(p.indptr)), torch.from_numpy(p.indptr),
        torch.from_numpy(p.indices.astype(np.int64)),
        torch.from_numpy(p.weights), torch.from_numpy(owner), int(lens.sum()))
    assert np.array_equal(got.numpy(), msg)
    assert np.array_equal(key.numpy(),
                          np.where(local, dst, n + 1 + push_pid * n + dst))
    assert np.array_equal(rabs.numpy(), np.where(local, 0.0, np.abs(msg)))


def test_simulator_refuses_what_it_cannot_honor(small_pagerank,
                                                monkeypatch):
    p, b, _ = small_pagerank
    with pytest.raises(ValueError, match="unknown rebalancing signal"):
        core.DistributedSimulator(p, b, core.SimulatorConfig(
            k=2, target_error=1e-6, eps=EPS, signal="nope", device="cpu"))
    with pytest.raises(ValueError, match="unknown partition"):
        core.DistributedSimulator(p, b, core.SimulatorConfig(
            k=2, target_error=1e-6, eps=EPS, partition="nope",
            device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.SimulatorConfig(k=2, target_error=1e-6, eps=EPS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.solve(repro_torch.Problem.pagerank(webgraph_like(
            50, seed=0)), "simulator", k=2)
