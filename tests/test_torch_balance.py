"""Port parity for the balance control plane: one recorded LoadSignal
sequence drives each policy of both packages, which must propose the
identical MovePlan list at every step (and, for the pressure policy,
the identical rung decisions).  Everything is numpy float64 on both
sides, so the decisions are compared exactly.
"""
import numpy as np
import pytest

import repro.balance as rb
import repro_torch.balance as tb


def _signals(kind: str, k: int = 8, steps: int = 80, seed: int = 3):
    """A residual-like sequence where PIDs converge at different rates
    (the slow ones shed load), sizes following the proposed moves."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.6, 0.95, size=k)
    base = rng.uniform(0.5, 2.0, size=k)
    sizes = np.full(k, 30, dtype=np.int64)
    for step in range(steps):
        values = base * rates ** step * rng.lognormal(0.0, 0.3, size=k)
        if kind == "edge-ops":
            values = np.round(values * 1e6)
        yield step, values, sizes


POLICIES = [
    ("slope_ema", {}, "residual"),
    ("cost_refresh", {"period": 5}, "edge-ops"),
    ("hysteresis", {"patience": 2}, "residual"),
    ("pressure", {"hi": 0.8, "lo": 0.3}, "residual"),
]


@pytest.mark.parametrize("name,kw,kind", POLICIES,
                         ids=[p[0] for p in POLICIES])
def test_policy_proposes_identical_move_plans(name, kw, kind):
    ref = rb.make_rebalancer(name, k=8, target_error=1e-6, eta=0.7, z=4,
                             unit="bucket", **kw)
    got = tb.make_rebalancer(name, k=8, target_error=1e-6, eta=0.7, z=4,
                             unit="bucket", **kw)
    n_plans = 0
    for step, values, sizes in _signals(kind):
        make = ("from_edge_ops" if kind == "edge-ops" else "from_residuals")
        p_ref = ref.propose(getattr(rb.LoadSignal, make)(values, sizes,
                                                         step=step))
        p_got = got.propose(getattr(tb.LoadSignal, make)(values, sizes,
                                                         step=step))
        assert [(p.src, p.dst, p.units, p.kind) for p in p_got] == [
            (p.src, p.dst, p.units, p.kind) for p in p_ref], step
        if name == "pressure":
            assert got.last_delta == ref.last_delta, step
        for p in p_ref:  # the sizes follow the plans, as an executor's
            moved = min(p.units, int(sizes[p.src]) - 1)
            sizes = sizes.copy()
            sizes[p.src] -= moved
            sizes[p.dst] += moved
        n_plans += len(p_ref) + (name == "pressure" and ref.last_delta != 0)
    assert n_plans > 0, f"{name}: the sequence fired no decision"
    assert got.n_moves == ref.n_moves


def test_reset_worker_and_signal_validation_match():
    for name in ("slope_ema", "hysteresis", "cost_refresh", "pressure"):
        ref = rb.make_rebalancer(name, k=4, target_error=1e-6)
        got = tb.make_rebalancer(name, k=4, target_error=1e-6)
        ref.reset_worker(2)
        got.reset_worker(2)
    with pytest.raises(ValueError, match="unknown rebalancing policy"):
        tb.make_rebalancer("nope", k=4, target_error=1e-6)
    with pytest.raises(ValueError, match="unknown signal kind"):
        tb.LoadSignal(values=np.ones(2), sizes=np.ones(2), kind="nope")
    with pytest.raises(ValueError, match="units must be"):
        tb.MovePlan(src=0, dst=1, units=0, kind="bucket")
    churn = tb.LoadSignal.from_graph_churn(np.array([3, 1, 0, 4]),
                                           np.ones(4, dtype=np.int64))
    ref_churn = rb.LoadSignal.from_graph_churn(np.array([3, 1, 0, 4]),
                                               np.ones(4, dtype=np.int64))
    assert np.array_equal(churn.values, ref_churn.values)
    assert churn.kind == ref_churn.kind == "graph-churn"
