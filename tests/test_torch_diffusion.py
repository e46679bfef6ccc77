"""Port parity for the BSR diffusion kernels K1 (fused frontier round) and
K2 (BSR product).

On the CPU the port's wrappers run their plain torch twins; these are held
against the reference's Pallas kernels run in interpret mode, with
``tests/test_kernels.py``'s bounds: ``sent`` exactly, ``f_new`` at
rtol=atol=2e-4 and the residual at 1e-3 relative.  The reference's
``block`` oracle is held against the port's ``block`` backend the same
way.  The CUDA kernels are held against the twins in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.diffusion as rd
from repro.core import CSRGraph, pagerank_system, power_law_graph
from repro.kernels.diffusion.ref import dense_to_bsr
import repro_torch.kernels.diffusion as td
from repro_torch.kernels import LAUNCHES

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


def _matrices(p, bs):
    m_ref = rd.prepare_bsr(p.indptr, p.indices, p.weights, p.n, bs=bs)
    m = td.prepare_bsr(p.indptr, p.indices, p.weights, p.n, bs=bs,
                       device="cpu")
    return m_ref, m


def _round_inputs(n, c, seed, t_quantile, bs):
    """test_kernels.py's _check_frontier_round fixture."""
    rng = np.random.default_rng(seed)
    if n == 1:  # single node, no edges (all-dangling degenerate graph)
        p = CSRGraph(indptr=np.zeros(2, np.int64),
                     indices=np.zeros(0, np.int32),
                     weights=np.zeros(0, np.float64), n=1)
    else:
        p, _ = pagerank_system(power_law_graph(n, seed=seed))
    m_ref, m = _matrices(p, bs)
    n_pad = m.n_row_blocks * bs
    f = np.zeros((n_pad, c), np.float32)
    f[: p.n] = rng.standard_normal((p.n, c))
    w = np.zeros(n_pad, np.float32)
    w[: p.n] = 1.0 / np.maximum(np.diff(p.indptr), 1)
    fw = (np.abs(f) * w[:, None]).ravel()
    if t_quantile >= 1.0:
        t = float(fw.max()) * 2.0 + 1.0  # empty frontier
    else:
        t = max(float(np.quantile(fw, t_quantile)), 1e-6)
    f_in = f[:, 0] if c == 1 else f
    return m_ref, m, f_in, w, np.float32(t)


def _compare(m_ref, m, f, w, t, backend, tau=0.0):
    ref_backend = "pallas" if backend == "kernel" else "block"
    fr, sr, rr = rd.frontier_round_bsr(
        m_ref, jnp.asarray(f), jnp.asarray(w), jnp.float32(t),
        backend=ref_backend,
        interpret=True if ref_backend == "pallas" else None,
        occupancy_threshold=tau)
    fo, so, ro = td.frontier_round_bsr(
        m, torch.from_numpy(f), torch.from_numpy(w), torch.tensor(t),
        backend=backend, occupancy_threshold=tau)
    assert fo.dtype == torch.float32
    np.testing.assert_array_equal(so.numpy(), np.asarray(sr))
    np.testing.assert_allclose(fo.numpy(), np.asarray(fr), rtol=2e-4,
                               atol=2e-4)
    rr = float(rr)
    assert abs(float(ro) - rr) <= 1e-3 * max(rr, 1.0), (float(ro), rr)
    return fo, so


CASES = [
    (1, 1, 0, 0.0),  # single-node graph
    (2, 1, 3, 0.5),
    (150, 1, 1, 0.0),  # full frontier
    (150, 1, 1, 1.0),  # empty frontier: f must pass through unchanged
    (300, 3, 7, 0.5),
    (257, 1, 11, 0.9),  # sparse frontier (occupancy skip exercised)
]


@pytest.mark.parametrize("backend", ["kernel", "block"])
@pytest.mark.parametrize("bs", [8, 64])
@pytest.mark.parametrize("n,c,seed,t_quantile", CASES)
def test_frontier_round_matches_reference(n, c, seed, t_quantile, bs,
                                          backend):
    """K1's twin vs the Pallas kernel (interpret); block vs block."""
    _compare(*_round_inputs(n, c, seed, t_quantile, bs), backend)


@pytest.mark.parametrize("backend", ["kernel", "block"])
@pytest.mark.parametrize("c", [1, 3])
def test_frontier_round_occupancy_threshold(c, backend):
    """tau=0.5 defers sparse block columns: deferred fluid is kept."""
    m_ref, m, f, w, t = _round_inputs(300, c, 7, 0.5, 64)
    fo, so = _compare(m_ref, m, f, w, t, backend, tau=0.5)
    fo_all, so_all = _compare(m_ref, m, f, w, t, backend, tau=0.0)
    assert int((so != 0).sum()) < int((so_all != 0).sum())


def _interleaved(bs=8, seed=5):
    """Block rows 1 and 3 own no tiles (test_kernels.py's fixture)."""
    rng = np.random.default_rng(seed)
    p = np.zeros((4 * bs, 4 * bs), np.float32)
    p[:bs, :bs] = rng.random((bs, bs)) * 0.1  # block row 0
    p[2 * bs: 3 * bs, bs: 2 * bs] = rng.random((bs, bs)) * 0.1  # row 2
    blocks, br, bc = dense_to_bsr(p, bs)
    return (p, rd.BsrMatrix(blocks, br, bc, 4, bs),
            td.BsrMatrix(blocks, br, bc, 4, bs, device="cpu"), rng)


@pytest.mark.parametrize("backend", ["kernel", "block"])
def test_frontier_round_interleaved_empty_rows(backend):
    bs = 8
    _, m_ref, m, rng = _interleaved(bs)
    assert m.row_occupied.tolist() == [True, False, True, False]
    f = rng.standard_normal(4 * bs).astype(np.float32)
    w = np.ones(4 * bs, np.float32)
    fo, _ = _compare(m_ref, m, f, w, np.float32(0.5), backend)
    keep = np.where(np.abs(f) * w > 0.5, 0.0, f)
    np.testing.assert_array_equal(fo.numpy()[bs: 2 * bs], keep[bs: 2 * bs])
    np.testing.assert_array_equal(fo.numpy()[3 * bs:], keep[3 * bs:])


@pytest.mark.parametrize("n,seed,bs,cols",
                         [(300, 0, 128, 1), (500, 2, 64, 4), (200, 7, 8, 1)])
def test_bsr_spmm_matches_reference(n, seed, bs, cols):
    """K2's twin vs bsr_spmm_pallas (interpret) with its epilogue."""
    p, _ = pagerank_system(power_law_graph(n, seed=seed))
    m_ref, m = _matrices(p, bs)
    rng = np.random.default_rng(seed)
    shape = (m.n_row_blocks * bs, cols) if cols > 1 else (
        m.n_row_blocks * bs,)
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(rd.bsr_spmm(m_ref, jnp.asarray(x), interpret=True))
    got = td.bsr_spmm(m, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bsr_spmm_interleaved_empty_rows():
    bs = 8
    p, m_ref, m, rng = _interleaved(bs, seed=9)
    x = rng.standard_normal(4 * bs).astype(np.float32)
    ref = np.asarray(rd.bsr_spmm(m_ref, jnp.asarray(x), interpret=True))
    got = td.bsr_spmm(m, torch.from_numpy(x)).numpy()
    assert np.all(got[bs: 2 * bs] == 0) and np.all(got[3 * bs:] == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, p @ x, rtol=2e-4, atol=2e-4)


def test_bsr_spmm_plain_visit_table_shuffled_pool():
    """K2's contract reads tiles through a visit table: an arbitrarily
    ordered pool gives the same product as the reference gather kernel."""
    bs, n_tiles, nrb = 16, 24, 6
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((n_tiles, bs, bs)).astype(np.float32) * 0.1
    dst = rng.integers(0, nrb, n_tiles).astype(np.int32)
    col = rng.integers(0, nrb, n_tiles).astype(np.int32)
    x = rng.standard_normal((nrb, bs, 2)).astype(np.float32)
    order = np.argsort(dst, kind="stable").astype(np.int32)
    ref = np.asarray(rd.bsr_gather_spmm_pallas(
        jnp.asarray(pool), jnp.asarray(order), jnp.asarray(dst[order]),
        jnp.asarray(col[order]), jnp.asarray(x), nrb, bs=bs,
        interpret=True))
    row_ptr = np.zeros(nrb + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=nrb), out=row_ptr[1:])
    got = td.bsr_spmm_kernel(
        torch.from_numpy(pool), torch.from_numpy(order),
        torch.from_numpy(col[order]), torch.from_numpy(row_ptr),
        torch.from_numpy(x)).numpy()
    occ = np.bincount(dst, minlength=nrb) > 0
    np.testing.assert_allclose(got[occ], ref[occ], rtol=2e-4, atol=2e-4)
    assert np.all(got[~occ] == 0)


def test_wrappers_validate_and_count_nothing_on_cpu():
    m_ref, m, f, w, t = _round_inputs(150, 1, 1, 0.5, 8)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="buffer_depth"):
        td.frontier_round_bsr(m, torch.from_numpy(f), torch.from_numpy(w),
                              torch.tensor(t), backend="kernel",
                              buffer_depth=0)
    with pytest.raises(ValueError, match="unknown frontier backend"):
        td.frontier_round_bsr(m, torch.from_numpy(f), torch.from_numpy(w),
                              torch.tensor(t), backend="pallas")
    td.frontier_round_bsr(m, torch.from_numpy(f), torch.from_numpy(w),
                          torch.tensor(t), backend="kernel", buffer_depth=4)
    td.bsr_spmm(m, torch.from_numpy(f))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="sorted"):
        td.BsrMatrix(np.zeros((2, 8, 8), np.float32), [1, 0], [0, 0], 2, 8,
                     device="cpu")
    with pytest.raises(ValueError, match="square"):
        td.BsrMatrix(np.zeros((1, 8, 8), np.float32), [0], [3], 2, 8,
                     device="cpu")
