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
