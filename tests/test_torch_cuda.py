"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA card and nvcc, and skips itself (inside a
fixture) without one.  The file imports neither JAX nor the reference, so
it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -o markers=cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports the JAX reference.)
Tolerances: float32 sums taken in another order than the twin's, on
values of order 1: rtol 1e-5 with atol 1e-6 (1e-5 for the products, whose
sums run over more terms); relaunches must be bit-identical (no atomics).
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels.diffusion as td
from repro_torch.core import pagerank_system, power_law_graph
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.edge_sum import csc_edges, edge_sum

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _round_inputs(n, c, seed, bs, device):
    rng = np.random.default_rng(seed)
    p, _ = pagerank_system(power_law_graph(n, seed=seed))
    m = td.prepare_bsr(p.indptr, p.indices, p.weights, p.n, bs=bs,
                       device=device)
    n_pad = m.n_row_blocks * bs
    f = np.zeros((n_pad, c), np.float32)
    f[: p.n] = rng.standard_normal((p.n, c))
    w = np.zeros(n_pad, np.float32)
    w[: p.n] = 1.0 / np.maximum(np.diff(p.indptr), 1)
    t = np.float32(np.quantile((np.abs(f) * w[:, None]).ravel(), 0.5))
    return p, m, f, w, t


@pytest.mark.cuda
@pytest.mark.parametrize("c,tau", [(1, 0.0), (3, 0.5), (8, 0.0)])
@pytest.mark.parametrize("bs", [8, 16, 64, 128])
def test_frontier_round_kernel_matches_plain(cuda_device, bs, c, tau):
    p, m, f, w, t = _round_inputs(700, c, 4, bs, cuda_device)
    m_cpu = td.prepare_bsr(p.indptr, p.indices, p.weights, p.n, bs=bs,
                           device="cpu")
    f_d, w_d = torch.from_numpy(f).to(cuda_device), torch.from_numpy(w).to(
        cuda_device)
    t_d = torch.tensor(t, device=cuda_device)
    before = LAUNCHES["frontier_round_bsr"]
    fo, so, ro = td.frontier_round_bsr(m, f_d, w_d, t_d,
                                       occupancy_threshold=tau)
    assert LAUNCHES["frontier_round_bsr"] == before + 1
    fo2, _, ro2 = td.frontier_round_bsr(m, f_d, w_d, t_d,
                                        occupancy_threshold=tau)
    torch.cuda.synchronize()
    assert torch.equal(fo, fo2) and torch.equal(ro, ro2)
    fc, sc, rc = td.frontier_round_bsr(
        m_cpu, torch.from_numpy(f), torch.from_numpy(w), torch.tensor(t),
        backend="kernel", occupancy_threshold=tau)
    assert torch.equal(so.cpu(), sc)
    np.testing.assert_allclose(fo.cpu().numpy(), fc.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(ro) - float(rc)) <= 1e-5 * max(float(rc), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,cols", [(8, 1), (64, 4), (128, 8)])
def test_bsr_spmm_kernel_matches_plain_with_empty_rows(cuda_device, bs,
                                                       cols):
    rng = np.random.default_rng(11)
    dense = np.zeros((4 * bs, 4 * bs), np.float32)
    dense[:bs] = rng.standard_normal((bs, 4 * bs))
    dense[2 * bs: 3 * bs] = rng.standard_normal((bs, 4 * bs))
    blocks, br, bc = td.dense_to_bsr(dense, bs)
    m = td.BsrMatrix(blocks, br, bc, 4, bs, device=cuda_device)
    m_cpu = td.BsrMatrix(blocks, br, bc, 4, bs, device="cpu")
    x = rng.standard_normal((4 * bs, cols)).astype(np.float32)
    got = td.bsr_spmm(m, torch.from_numpy(x).to(cuda_device))
    again = td.bsr_spmm(m, torch.from_numpy(x).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    plain = td.bsr_spmm(m_cpu, torch.from_numpy(x))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert bool((got[bs: 2 * bs] == 0).all())
    assert bool((got[3 * bs:] == 0).all())


@pytest.mark.cuda
def test_block_backend_refuses_the_card(cuda_device):
    _, m, f, w, t = _round_inputs(150, 1, 1, 8, cuda_device)
    with pytest.raises(ValueError, match="CPU oracle"):
        td.frontier_round_bsr(
            m, torch.from_numpy(f[:, 0]).to(cuda_device),
            torch.from_numpy(w).to(cuda_device),
            torch.tensor(t, device=cuda_device), backend="block")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_sum_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed)
    n, n_edges = 5000, 60000
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n // 2, n_edges)  # upper half: no in-edges
    wgt = rng.random(n_edges)
    x = rng.standard_normal(n).astype(np.float32)
    e_d = csc_edges(src, dst, wgt, n, cuda_device)
    x_d = torch.from_numpy(x).to(cuda_device)
    before = LAUNCHES["edge_sum"]
    got = edge_sum(x_d, e_d)
    again = edge_sum(x_d, e_d)
    torch.cuda.synchronize()
    assert LAUNCHES["edge_sum"] == before + 2
    assert torch.equal(got, again)
    assert bool((got[n // 2:] == 0).all())
    plain = edge_sum(torch.from_numpy(x), csc_edges(src, dst, wgt, n, "cpu"))
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["frontier:pallas",
                                    "frontier:segment_sum"])
def test_solve_on_the_card_matches_the_cpu(cuda_device, method):
    import repro_torch

    problem = repro_torch.Problem.pagerank(
        repro_torch.core.host_block_graph(8192, seed=2))
    before = dict(LAUNCHES)
    card = repro_torch.solve(problem, method=method)
    cpu = repro_torch.solve(problem, method=method, device="cpu",
                            interpret=True)
    assert card.converged and cpu.converged
    assert np.abs(card.x - cpu.x).sum() <= 1e-6
    assert card.cost_iterations == pytest.approx(cpu.cost_iterations,
                                                 rel=0.01)
    kernel = ("frontier_round_bsr" if method == "frontier:pallas"
              else "edge_sum")
    assert LAUNCHES[kernel] - before[kernel] == card.n_rounds
