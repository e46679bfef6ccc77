"""Port parity for SolverSession: warm starts, the kernel-semantics solve
(K1's plain twin against the reference's Pallas kernel in interpret mode),
and a reference session's mid-solve state carried into the port through
``repro_torch.interop``.  Everything runs on the CPU.
"""
import numpy as np
import pytest

import repro
import repro_torch
from repro.core import webgraph_like
from repro_torch.interop import problem_from_arrays, seed_session
import torch

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


@pytest.mark.parametrize("method,opts", [
    ("frontier:segment_sum", {}),
    ("frontier:pallas", {}),
    ("frontier:pallas", {"interpret": True, "bs": 64}),
])
def test_warm_start_strictly_fewer_ops(method, opts):
    """test_api.py's warm-start contract, on the port (CPU)."""
    n = 2000 if not opts else 512
    g = webgraph_like(n, seed=1)
    problem = repro_torch.Problem.pagerank(
        g, target_error=1e-6 if not opts else None)
    options = repro_torch.SolverOptions(device="cpu", **opts)
    session = repro_torch.SolverSession(problem, method=method,
                                        options=options)
    first = session.solve()
    rng = np.random.default_rng(7)
    b_new = np.abs(problem.b * (1.0 + 0.05 * rng.standard_normal(g.n)))
    cold = repro_torch.SolverSession(problem.with_b(b_new), method=method,
                                     options=options).solve()
    assert cold.converged
    resid0 = session.warm_start(b_new)
    warm = session.solve()
    assert warm.converged
    assert resid0 < np.abs(b_new).sum()
    assert warm.n_ops < cold.n_ops, (method, warm.n_ops, cold.n_ops)
    assert session.lifetime_ops == first.n_ops + warm.n_ops
    assert session.lifetime_rounds == first.n_rounds + warm.n_rounds
    np.testing.assert_allclose(warm.x, cold.x, atol=1e-5 if not opts
                               else 1e-3)


def test_kernel_semantics_solve_matches_reference_interpret():
    """frontier:pallas with interpret=True on both sides: K1's twin
    against the Pallas kernel in interpret mode, through a whole solve."""
    g = webgraph_like(300, seed=2)
    ref = repro.solve(repro.Problem.pagerank(g), method="frontier:pallas",
                      interpret=True, bs=64)
    got = repro_torch.solve(repro_torch.Problem.pagerank(g),
                            method="frontier:pallas", device="cpu",
                            interpret=True, bs=64)
    assert got.converged
    assert np.abs(got.x - ref.x).sum() <= 1e-6
    assert got.cost_iterations == pytest.approx(ref.cost_iterations,
                                                rel=0.01)


def test_frontier_round_inputs_are_the_next_rounds_operands():
    """frontier:pallas's round_inputs, mid-solve: the padded device fluid
    (the node-space fluid, zero in the padding) and T, and one round of
    ``frontier_round_bsr`` from them gives the driver's next state."""
    from repro_torch.kernels.diffusion import frontier_round_bsr

    g = webgraph_like(300, seed=2)
    session = repro_torch.SolverSession(
        repro_torch.Problem.pagerank(g), method="frontier:pallas",
        device="cpu", interpret=True, bs=64, max_rounds=20)
    session.solve()
    drv = session._driver
    f, t = drv.round_inputs()
    assert drv.rounds() == 20
    assert f.shape == (drv.m.n_row_blocks * 64,)
    np.testing.assert_array_equal(f[: g.n].double().numpy(), drv.fluid()[0])
    assert not f[g.n:].any()
    assert float(t) == float(drv.threshold())
    f_next, _, _ = frontier_round_bsr(
        drv.m, f, drv.w, t, backend=drv.backend,
        buffer_depth=drv.buffer_depth,
        occupancy_threshold=drv.occupancy_threshold)
    drv.advance(0.0, 21)
    assert drv.rounds() == 21
    assert torch.equal(drv.round_inputs()[0], f_next)


@pytest.mark.parametrize("method", ["frontier:segment_sum",
                                    "frontier:pallas"])
def test_interop_carries_mid_solve_state(method):
    """A reference session's mid-solve (F, H, T) seeds a port session;
    both finish within |Δx|_1 <= 1e-6 of each other."""
    g = webgraph_like(600, seed=3)
    ref_problem = repro.Problem.pagerank(g, target_error=1e-6)
    ref = repro.SolverSession(ref_problem, method="frontier:segment_sum")
    list(ref.run(max_rounds=40))
    assert not ref.run().__next__().residual <= ref_problem.tol
    f, h = ref._driver.fluid()
    t = ref._driver.threshold()
    p = ref_problem.p
    problem = problem_from_arrays(
        p.indptr, p.indices, p.weights, p.n, ref_problem.b,
        ref_problem.eps, ref_problem.target_error)
    session = repro_torch.SolverSession(problem, method=method, device="cpu")
    seed_session(session, f, h, t)
    assert session.n_ops == 0 and session.n_rounds == 0
    f_port, h_port = session._driver.fluid()
    np.testing.assert_allclose(h_port, h, rtol=1e-6, atol=0)
    assert float(session._driver.threshold()) == pytest.approx(float(t))
    rep = session.solve()
    ref_rep = ref.solve()
    assert rep.converged and ref_rep.converged
    assert np.abs(rep.x - ref_rep.x).sum() <= 1e-6


@pytest.mark.parametrize("method", ["engine:bsr", "engine:chunk"])
def test_engine_warm_start_matches_reference(method):
    """engine warm start at k=1 (the reference's in-process width): the
    re-seeded |F'|_1 within 1e-6 relative of the reference's, then the
    warm solve lands on the reference's answer with fewer edge pushes
    than the cold one."""
    g = webgraph_like(1500, seed=4)
    ref_problem = repro.Problem.pagerank(g, target_error=1e-6)
    problem = repro_torch.Problem.pagerank(g, target_error=1e-6)
    ref = repro.SolverSession(ref_problem, method=method, k=1)
    got = repro_torch.SolverSession(problem, method=method, k=1,
                                    device="cpu")
    cold, ref_cold = got.solve(), ref.solve()
    assert cold.converged and ref_cold.converged
    rng = np.random.default_rng(9)
    b_new = np.abs(problem.b * (1.0 + 0.05 * rng.standard_normal(g.n)))
    resid, ref_resid = got.warm_start(b_new), ref.warm_start(b_new)
    assert resid == pytest.approx(ref_resid, rel=1e-6)
    assert got.n_ops == 0 and got.n_rounds == 0
    warm, ref_warm = got.solve(), ref.solve()
    assert warm.converged and warm.n_ops < cold.n_ops
    assert np.abs(warm.x - ref_warm.x).sum() <= 1e-6
    assert got.lifetime_ops == cold.n_ops + warm.n_ops


def test_engine_session_k4_dynamic_warm_start():
    """k=4 with the controller on: a session solves, moves buckets, and a
    warm request after the moves re-seeds from the moved layout."""
    from repro.core import power_law_graph

    g = power_law_graph(1600, seed=7)
    g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    problem = repro_torch.Problem.pagerank(g, target_error=1e-8)
    session = repro_torch.SolverSession(
        problem, method="engine:bsr", device="cpu", k=4, dynamic=True,
        buckets_per_dev=24, headroom=8, eta=0.9)
    cold = session.solve()
    assert cold.converged and cold.move_log
    assert cold.extras["chunks"] == len(cold.trace) - 1
    b_new = problem.b * 1.02
    session.warm_start(b_new)
    warm = session.solve()
    assert warm.converged and warm.n_ops < cold.n_ops
    dense = np.linalg.solve(np.eye(g.n) - problem.p.to_dense(), b_new)
    assert np.abs(warm.x - dense).max() < 1e-5
