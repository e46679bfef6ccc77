"""Port parity for K3 (the per-destination edge reduction) and the
per-edge frontier round built on it.

K3's plain twin is held against ``jax.ops.segment_sum`` of the same
messages; the port's ``frontier_step`` against the reference's on the
selection and the op count exactly, and on f/h within 1e-6.  The CUDA
kernel is held against the twin in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier_step as ref_frontier_step
from repro.core import pagerank_system, webgraph_like
from repro.core.diteration import default_weights
import repro_torch.core as tc
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.edge_sum import csc_edges, edge_sum, edge_sum_plain

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


def _random_edges(seed, n=300, n_edges=2000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n // 2, n_edges)  # upper half: no in-edges
    wgt = rng.random(n_edges)
    x = rng.standard_normal(n).astype(np.float32)
    return src, dst, wgt, x, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_sum_plain_matches_segment_sum(seed):
    src, dst, wgt, x, n = _random_edges(seed)
    ref = np.asarray(jax.ops.segment_sum(
        jnp.asarray(x)[src] * jnp.asarray(wgt, jnp.float32),
        jnp.asarray(dst), num_segments=n))
    edges = csc_edges(src, dst, wgt, n, "cpu")
    got = edge_sum(torch.from_numpy(x), edges)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert np.all(got.numpy()[n // 2:] == 0)
    assert torch.equal(got, edge_sum_plain(torch.from_numpy(x), edges.indptr,
                                           edges.src, edges.wgt))


def test_csc_edges_layout():
    src, dst, wgt, _, n = _random_edges(4, n=40, n_edges=200)
    e = csc_edges(src, dst, wgt, n, "cpu")
    assert e.n_edges == 200 and e.n == n
    assert e.indptr.dtype == torch.int64 and e.src.dtype == torch.int32
    assert e.wgt.dtype == torch.float32
    counts = np.bincount(dst, minlength=n)
    assert np.array_equal(np.diff(e.indptr.numpy()), counts)
    # stable: within one destination the edges keep their input order
    order = np.argsort(dst, kind="stable")
    assert np.array_equal(e.src.numpy(), src[order])


def _step_inputs(seed, t_quantile):
    g = webgraph_like(600, seed=seed)
    p, b = pagerank_system(g)
    rng = np.random.default_rng(seed)
    f = (b * (1.0 + rng.random(p.n))).astype(np.float32)
    w = default_weights(p).astype(np.float32)
    fw = np.abs(f) * w
    t = np.float32(np.quantile(fw, t_quantile) if t_quantile < 1.0
                   else fw.max() * 2.0)
    return p, f, w, t


@pytest.mark.parametrize("seed,t_quantile", [(1, 0.0), (2, 0.5), (3, 0.95),
                                             (1, 1.0)])
def test_frontier_step_matches_reference(seed, t_quantile):
    p, f, w, t = _step_inputs(seed, t_quantile)
    src, dst, wgt = p.edge_list()
    dang = p.dangling_mask()
    f_r, h_r, t_r, ops_r = ref_frontier_step(
        jnp.asarray(f), jnp.zeros(p.n, jnp.float32), jnp.float32(t),
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(wgt, jnp.float32),
        jnp.asarray(w), jnp.asarray(dang), p.n)
    f_p, h_p, t_p, ops_p = tc.frontier_step(
        torch.from_numpy(f), torch.zeros(p.n), torch.tensor(t),
        csc_edges(src, dst, wgt, p.n, "cpu"), torch.from_numpy(w),
        torch.as_tensor(p.out_degree()), torch.as_tensor(dang))
    # selection: h starts at 0, so h == sent marks exactly the fired nodes
    assert np.array_equal(h_p.numpy() != 0, np.asarray(h_r) != 0)
    assert int(ops_p) == int(ops_r)
    assert ops_p.dtype == torch.int64
    assert float(t_p) == float(t_r)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_r), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_r), atol=1e-6,
                               rtol=0)


def test_edge_sum_counts_nothing_on_cpu():
    src, dst, wgt, x, n = _random_edges(5)
    before = dict(LAUNCHES)
    edge_sum(torch.from_numpy(x), csc_edges(src, dst, wgt, n, "cpu"))
    assert LAUNCHES == before
