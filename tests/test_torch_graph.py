"""Port parity: graph generators, PageRank systems, BSR tiling and the
GraphStore views give the reference's arrays byte for byte."""
import numpy as np
import pytest

import repro.core as rc
import repro.core.diteration as rdit
import repro.graph as rg
import repro.graph.delta as rdelta
import repro.kernels.diffusion.ref as rref
import repro_torch.core as tc
import repro_torch.graph as tg
import repro_torch.graph.delta as tdelta
import repro_torch.kernels.diffusion.ref as tref


def _same_csr(a, b):
    assert a.n == b.n
    for name in ("indptr", "indices", "weights"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y), name


GENERATORS = [
    ("power_law_graph", dict(n=500, seed=3)),
    ("power_law_graph", dict(n=300, d_min=2, seed=9, dedupe=False)),
    ("webgraph_like", dict(n=1000, seed=1)),
    ("host_block_graph", dict(n=2048, seed=0)),
    ("host_block_graph", dict(n=1000, host_size=64, dangling_frac=0.0,
                              seed=4)),
]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_byte_identical(name, kw):
    _same_csr(getattr(rc, name)(**kw), getattr(tc, name)(**kw))


@pytest.mark.parametrize("damping", [0.85, 0.5])
def test_pagerank_system_byte_identical(damping):
    g = rc.webgraph_like(800, seed=2)
    p_ref, b_ref = rc.pagerank_system(g, damping=damping)
    p, b = tc.pagerank_system(tc.webgraph_like(800, seed=2), damping=damping)
    _same_csr(p_ref, p)
    assert np.array_equal(b_ref, b)


@pytest.mark.parametrize("signed", [True, False])
def test_random_dd_system_byte_identical(signed):
    g_ref, b_ref = rc.random_dd_system(60, seed=2, signed=signed)
    g, b = tc.random_dd_system(60, seed=2, signed=signed)
    _same_csr(g_ref, g)
    assert np.array_equal(b_ref, b)


def test_csr_helpers_identical():
    g_ref = rc.power_law_graph(200, seed=5)
    g = tc.power_law_graph(200, seed=5)
    assert np.array_equal(g_ref.to_dense(), g.to_dense())
    assert np.array_equal(g_ref.in_degree(), g.in_degree())
    for a, b in zip(g_ref.edge_list(), g.edge_list()):
        assert np.array_equal(a, b)
    perm = np.argsort(-g.out_degree(), kind="stable")
    _same_csr(g_ref.reorder(perm), g.reorder(perm))


@pytest.mark.parametrize("mode", ["greedy", "inv_out", "inv_out_in"])
def test_default_weights_identical(mode):
    g = tc.power_law_graph(300, seed=1)
    assert np.array_equal(rdit.default_weights(g, mode),
                          tc.default_weights(g, mode))


def test_sequential_and_jacobi_identical():
    g = rc.power_law_graph(300, seed=3)
    p, b = rc.pagerank_system(g)
    ref = rdit.run_sequential(p, b, target_error=1e-7, eps=0.15)
    got = tc.run_sequential(p, b, target_error=1e-7, eps=0.15)
    assert np.array_equal(ref.x, got.x)
    assert (ref.n_ops, ref.n_sweeps, ref.n_diffusions) == (
        got.n_ops, got.n_sweeps, got.n_diffusions)
    x_ref, it_ref = rdit.jacobi_solve(p, b, 1e-6, 0.15)
    x, it = tc.jacobi_solve(p, b, 1e-6, 0.15)
    assert it == it_ref and np.array_equal(x, x_ref)


@pytest.mark.parametrize("bs", [8, 64, 128])
def test_csr_to_bsr_byte_identical(bs):
    g = rc.power_law_graph(500, seed=2)
    p, _ = rc.pagerank_system(g)
    ref = rref.csr_to_bsr(p.indptr, p.indices, p.weights, p.n, bs)
    got = tref.csr_to_bsr(p.indptr, p.indices, p.weights, p.n, bs)
    for a, b in zip(ref, got):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_dense_to_bsr_byte_identical():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((40, 40)) * (rng.random((40, 40)) < 0.05)
    for bs in (8, 16):
        for a, b in zip(rref.dense_to_bsr(d, bs), tref.dense_to_bsr(d, bs)):
            assert a.tobytes() == b.tobytes()
    zero = np.zeros((16, 16))
    for a, b in zip(rref.dense_to_bsr(zero, 8), tref.dense_to_bsr(zero, 8)):
        assert a.tobytes() == b.tobytes()


def test_edge_keys_identical():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 2**31 - 1, 100)
    dst = rng.integers(0, 2**31 - 1, 100)
    assert np.array_equal(rdelta.edge_keys(src, dst),
                          tdelta.edge_keys(src, dst))


@pytest.mark.parametrize("bs", [16, 128])
def test_graph_store_views_byte_identical(bs):
    g = rc.host_block_graph(1500, seed=1)
    p, _ = rc.pagerank_system(g)
    ref, got = rg.GraphStore.from_csr(p), tg.GraphStore.from_csr(p)
    _same_csr(ref.csr(), got.csr())
    assert ref.n_edges == got.n_edges and got.version == 0
    assert np.array_equal(ref.out_degree(), got.out_degree())
    assert np.array_equal(ref.dangling_mask(), got.dangling_mask())
    assert got.materialized_views() == ()
    v_ref, v = ref.bsr(bs), got.bsr(bs)
    assert got.bsr(bs) is v  # cached
    assert got.materialized_views() == (("bsr", bs),)
    for name in ("blocks", "block_row", "block_col"):
        assert getattr(v_ref, name).tobytes() == getattr(v, name).tobytes()
    assert (v_ref.n_row_blocks, v_ref.bs) == (v.n_row_blocks, v.bs)
    assert np.array_equal(v_ref.row_occupied, v.row_occupied)
    assert np.array_equal(v_ref.keys(), v.keys())


def test_graph_store_multigraph_and_edge_file(tmp_path):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    w = rng.random(400)
    _same_csr(rg.GraphStore.from_edges(src, dst, w, 50).csr(),
              tg.GraphStore.from_edges(src, dst, w, 50).csr())
    path = tmp_path / "edges.txt"
    lines = ["# comment"] + [f"{s} {d} {x:.6f}" for s, d, x in
                             zip(src, dst, w)]
    path.write_text("\n".join(lines) + "\n")
    for weighted in (False, True):
        _same_csr(
            rg.GraphStore.from_edge_file(str(path), weighted=weighted).csr(),
            tg.GraphStore.from_edge_file(str(path), weighted=weighted).csr())
    with pytest.raises(ValueError, match="ids >= n"):
        tg.GraphStore.from_edge_file(str(path), n=10)
