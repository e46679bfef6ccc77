"""Port parity for graph deltas: GraphDelta and its churn helpers, the
view patchers behind ``GraphStore.apply_delta``, ``Problem.with_graph``
and the delta re-solve ``SolverSession.update_graph``.

* the churn helpers (``rotation_churn``, ``pagerank_edge_churn``,
  ``invert_delta``) give the reference's arrays on the same store;
* every patched view (CSR splice, BSR tile pool, bucketed layout, tiled
  engine layout) equals the port's own rebuild bit for bit, and its
  arrays equal the reference's patched view (the contracts of
  tests/test_graph_store.py and test_graph_delta_props.py, the random
  delta sequences drawn by hypothesis as there);
* ``update_graph`` gives the reference's rounds and edge pushes on
  ``frontier:segment_sum``, ``frontier:pallas`` and the engine (the
  frontier ``cost_iterations`` within PR 11's 1 %), |Δx|₁ <= 1e-6, and
  rolls back on a malformed delta or a failure after the store mutated.

Everything runs on the CPU at n <= 1,024.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro
import repro.graph as rg
import repro_torch
import repro_torch.graph as tg
from repro.core import pagerank_system, power_law_graph, webgraph_like

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

BS = 8
N_BUCKETS = 3
ENGINE_KEY = (2, 4, 2, True, np.float32)  # k, b/dev, headroom, tiled, dtype
BSR_FIELDS = ("block_row", "block_col", "blocks", "row_occupied")
BUCKET_FIELDS = ("node_of_slot", "slot_of_node", "src_slot", "dst", "wgt",
                 "out_deg")
ENGINE_FIELDS = ("w", "src_slot", "dst_bucket", "dst_slot", "wgt",
                 "pos_of_bucket", "node_of_slot", "tiles", "tile_dst",
                 "slot_out_deg", "t_counts")


def _stores(g):
    """The same canonical graph as a reference and a port store."""
    return rg.GraphStore.from_csr(g), tg.GraphStore.from_csr(g)


def _same_delta(a, b):
    for name in ("added", "added_w", "removed", "reweighted",
                 "reweighted_w"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def _assert_views_equal(a, b, bs, n_buckets, engine_key, ctx="",
                        order=None):
    """Every view of store ``a`` equals ``b``'s bit for bit (either side
    may be the reference's).  ``t_counts`` is compared where both have
    it (the reference's untiled layouts carry none)."""
    ca, cb = a.csr(), b.csr()
    for name in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(ca, name), getattr(cb, name),
                                      err_msg=f"{ctx}: csr.{name}")
    ta, tb = a.bsr(bs), b.bsr(bs)
    for name in BSR_FIELDS:
        np.testing.assert_array_equal(getattr(ta, name), getattr(tb, name),
                                      err_msg=f"{ctx}: bsr.{name}")
    ga, gb = (a.bucketed(n_buckets, order=order),
              b.bucketed(n_buckets, order=order))
    for name in BUCKET_FIELDS:
        np.testing.assert_array_equal(getattr(ga, name), getattr(gb, name),
                                      err_msg=f"{ctx}: bucketed.{name}")
    assert ga.n_edges == gb.n_edges, ctx
    la = a.engine_layout(*engine_key, order=order)
    lb = b.engine_layout(*engine_key, order=order)
    for name in ENGINE_FIELDS:
        np.testing.assert_array_equal(getattr(la, name), getattr(lb, name),
                                      err_msg=f"{ctx}: engine.{name}")
    assert la.n_edges == lb.n_edges, ctx


def _materialize(store, bs, n_buckets, engine_key, order=None):
    store.bsr(bs)
    store.bucketed(n_buckets, order=order)
    store.engine_layout(*engine_key, order=order)


def _mixed_delta(mod, store, seed=0, n_rm=7, n_add=7, n_rew=5):
    """test_graph_store.py's hand-rolled add/remove/reweight batch, built
    with ``mod``'s GraphDelta."""
    rng = np.random.default_rng(seed)
    csr = store.csr()
    src_e, dst_e, w_e = csr.edge_list()
    keys = set((int(s) << 32) | int(d) for s, d in zip(src_e, dst_e))
    pick = rng.choice(src_e.shape[0], size=n_rm + n_rew, replace=False)
    removed = np.stack([src_e[pick[:n_rm]], dst_e[pick[:n_rm]]],
                       axis=1).astype(np.int64)
    rew_idx = pick[n_rm:]
    rew = (src_e[rew_idx].astype(np.int64), dst_e[rew_idx].astype(np.int64),
           w_e[rew_idx] * 1.5)
    added = []
    while len(added) < n_add:
        s, d = int(rng.integers(0, csr.n)), int(rng.integers(0, csr.n))
        k = (s << 32) | d
        if s != d and k not in keys:
            added.append((s, d, 0.01 * (len(added) + 1)))
            keys.add(k)
    return mod.GraphDelta.make(added_edges=np.array(added),
                               removed_edges=removed, reweighted=rew)


def _pagerank_links(store, seed=0, count=12):
    rng = np.random.default_rng(seed)
    csr = store.csr()
    src_e, dst_e, _ = csr.edge_list()
    deg = csr.out_degree()
    cand = np.nonzero(deg[src_e] > 1)[0]
    rm = rng.choice(cand, size=count, replace=False)
    removed = np.stack([src_e[rm], dst_e[rm]], axis=1).astype(np.int64)
    keys = set((int(s) << 32) | int(d) for s, d in zip(src_e, dst_e))
    added = []
    while len(added) < count:
        s, d = int(rng.integers(0, csr.n)), int(rng.integers(0, csr.n))
        if s != d and ((s << 32) | d) not in keys and deg[s] > 0:
            added.append((s, d))
            keys.add((s << 32) | d)
    return np.array(added, dtype=np.int64), removed


# --------------------------------------------------------------------------- #
# the churn helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_rot,seed,exclude_top", [(25, 5, 0.0),
                                                     (60, 1, 0.2),
                                                     (3, 9, 0.0)])
def test_rotation_churn_equals_reference(n_rot, seed, exclude_top):
    p, _ = pagerank_system(webgraph_like(1024, seed=1))
    rs, ts = _stores(p)
    rank = np.random.default_rng(3).random(1024) if exclude_top else None
    dr = rg.rotation_churn(rs, n_rot, seed=seed, rank=rank,
                           exclude_top=exclude_top)
    dt = tg.rotation_churn(ts, n_rot, seed=seed, rank=rank,
                           exclude_top=exclude_top)
    _same_delta(dr, dt)
    assert dt.n_changes == 2 * n_rot
    np.testing.assert_array_equal(dt.churn_per_node(1024),
                                  dr.churn_per_node(1024))
    _same_delta(rg.invert_delta(rs, dr), tg.invert_delta(ts, dt))


def test_pagerank_edge_churn_equals_reference():
    p, _ = pagerank_system(webgraph_like(1024, seed=1))
    rs, ts = _stores(p)
    added, removed = _pagerank_links(ts)
    dr = rg.pagerank_edge_churn(rs, added_links=added, removed_links=removed)
    dt = tg.pagerank_edge_churn(ts, added_links=added, removed_links=removed)
    _same_delta(dr, dt)
    assert dt.reweighted.shape[0] > 0
    _same_delta(rg.invert_delta(rs, dr), tg.invert_delta(ts, dt))


def test_delta_validation():
    g = power_law_graph(100, seed=0)
    store = tg.GraphStore.from_csr(g)
    csr = store.csr()
    s0 = int(np.nonzero(csr.out_degree() > 0)[0][0])
    d0 = int(csr.out_neighbors(s0)[0][0])
    with pytest.raises(ValueError, match="already exists"):
        store.apply_delta(tg.GraphDelta.make(
            added_edges=np.array([[s0, d0, 1.0]])))
    nbrs = set(csr.out_neighbors(s0)[0].tolist())
    d_missing = next(d for d in range(100) if d not in nbrs and d != s0)
    with pytest.raises(ValueError, match="does not exist"):
        store.apply_delta(tg.GraphDelta.make(
            removed_edges=np.array([[s0, d_missing]])))
    with pytest.raises(ValueError, match="duplicate"):
        tg.GraphDelta.make(added_edges=np.array([[1, 2, 0.5]]),
                           removed_edges=np.array([[1, 2]]))
    with pytest.raises(TypeError):
        store.apply_delta("not a delta")
    v = store.version
    store.apply_delta(tg.GraphDelta.make())  # empty = no-op
    assert store.version == v
    with pytest.raises(ValueError, match="cannot invert"):
        tg.invert_delta(store, tg.GraphDelta.make(
            removed_edges=np.array([[s0, d_missing]])))


# --------------------------------------------------------------------------- #
# patched views: bit-identical to a rebuild and to the reference's patch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("churn", ["pagerank", "mixed", "rotation"])
def test_apply_delta_views_equal_rebuild_and_reference(churn):
    p, _ = pagerank_system(webgraph_like(1024, seed=1))
    rs, ts = _stores(p)
    bs, n_buckets, key = 64, 6, (2, 5, 2, True, np.float32)
    for store in (rs, ts):
        _materialize(store, bs, n_buckets, key)
    if churn == "pagerank":
        added, removed = _pagerank_links(ts)
        dr = rg.pagerank_edge_churn(rs, added, removed)
        dt = tg.pagerank_edge_churn(ts, added, removed)
    elif churn == "mixed":
        dr, dt = _mixed_delta(rg, rs, seed=3), _mixed_delta(tg, ts, seed=3)
    else:
        dr, dt = rg.rotation_churn(rs, 25, seed=5), tg.rotation_churn(
            ts, 25, seed=5)
    rs.apply_delta(dr)
    ts.apply_delta(dt)
    assert ts.version == rs.version == 1
    fresh = tg.GraphStore.from_csr(ts.csr())
    _assert_views_equal(ts, fresh, bs, n_buckets, key, ctx="rebuild")
    _assert_views_equal(ts, rs, bs, n_buckets, key, ctx="reference")


def test_apply_delta_ordered_engine_layout_parity():
    """A layout built with a custom node order patches against its OWN
    ordered bucketed view."""
    g = webgraph_like(512, seed=4)
    rs, ts = _stores(g)
    order = np.random.default_rng(9).permutation(512).astype(np.int64)
    key = (2, 4, 1, True, np.float32)
    for store in (rs, ts):
        store.engine_layout(*key, order=order)
    rs.apply_delta(rg.rotation_churn(rs, 20, seed=6))
    ts.apply_delta(tg.rotation_churn(ts, 20, seed=6))
    fresh = tg.GraphStore.from_csr(ts.csr())
    _assert_views_equal(ts, fresh, 16, 8, key, ctx="rebuild", order=order)
    _assert_views_equal(ts, rs, 16, 8, key, ctx="reference", order=order)


def test_apply_delta_capacity_growth_parity():
    """A delta that outgrows the bucket edge capacity (one node gains
    many edges) re-pads, and the tile capacity T grows."""
    g = power_law_graph(256, seed=2)
    rs, ts = _stores(g)
    key = (1, 6, 2, True, np.float32)
    for store in (rs, ts):
        _materialize(store, 32, 4, key)
    src_e, dst_e, _ = ts.csr().edge_list()
    keys = set((int(s) << 32) | int(d) for s, d in zip(src_e, dst_e))
    added = np.array([(5, d, 1.0) for d in range(256)
                      if d != 5 and ((5 << 32) | d) not in keys])
    cap0 = ts.bucketed(4).edge_cap
    rs.apply_delta(rg.GraphDelta.make(added_edges=added))
    ts.apply_delta(tg.GraphDelta.make(added_edges=added))
    assert ts.bucketed(4).edge_cap > cap0
    fresh = tg.GraphStore.from_csr(ts.csr())
    _assert_views_equal(ts, fresh, 32, 4, key, ctx="rebuild")
    _assert_views_equal(ts, rs, 32, 4, key, ctx="reference")


def test_apply_delta_on_empty_store():
    """Adding the first edges to an edgeless store works; removing from
    one raises; the BSR placeholder tile never survives a merge."""
    store = tg.GraphStore.from_edges(np.zeros(0, np.int64),
                                     np.zeros(0, np.int64),
                                     np.zeros(0, np.float64), 64)
    t0 = store.bsr(bs=16)
    assert t0.n_blocks == 1 and not np.any(t0.blocks)
    with pytest.raises(ValueError, match="does not exist"):
        store.apply_delta(tg.GraphDelta.make(
            removed_edges=np.array([[0, 1]])))
    store.apply_delta(tg.GraphDelta.make(
        added_edges=np.array([[40, 33, .5], [3, 2, .25]])))
    assert store.n_edges == 2
    fresh = tg.GraphStore.from_csr(store.csr()).bsr(bs=16)
    for name in BSR_FIELDS:
        np.testing.assert_array_equal(getattr(store.bsr(16), name),
                                      getattr(fresh, name), err_msg=name)
    assert store.bsr(16).n_blocks == 2


def test_apply_delta_tile_drop_and_insert():
    """Removing a block's only edge drops its tile; removing every edge
    leaves csr_to_bsr's one placeholder."""
    store = tg.GraphStore.from_edges(np.array([0, 40]), np.array([33, 2]),
                                     np.array([0.5, 0.25]), 64)
    assert store.bsr(bs=16).n_blocks == 2
    store.apply_delta(tg.GraphDelta.make(
        added_edges=np.array([[50, 60, 0.3]]),
        removed_edges=np.array([[0, 33]])))
    t2 = store.bsr(bs=16)
    fresh = tg.GraphStore.from_csr(store.csr()).bsr(bs=16)
    for name in BSR_FIELDS:
        np.testing.assert_array_equal(getattr(t2, name),
                                      getattr(fresh, name), err_msg=name)
    assert t2.n_blocks == 2
    assert t2.row_occupied[60 // 16] and not t2.row_occupied[33 // 16]
    store.apply_delta(tg.GraphDelta.make(
        removed_edges=np.array([[40, 2], [50, 60]])))
    t3 = store.bsr(bs=16)
    assert t3.n_blocks == 1 and not np.any(t3.blocks)


def test_failed_patch_rolls_the_store_back(monkeypatch):
    """A view patch that raises leaves the CSR and the version as they
    were and drops the view cache."""
    g = webgraph_like(300, seed=1)
    store = tg.GraphStore.from_csr(g)
    _materialize(store, 16, 4, ENGINE_KEY)
    before = [a.copy() for a in (store.csr().indptr, store.csr().indices,
                                 store.csr().weights)]

    def boom(*a, **k):
        raise RuntimeError("patch failed")

    monkeypatch.setattr(tg.views, "patch_engine_layout", boom)
    with pytest.raises(RuntimeError, match="patch failed"):
        store.apply_delta(tg.rotation_churn(store, 5, seed=1))
    assert store.version == 0 and store.materialized_views() == ()
    for a, b in zip(before, (store.csr().indptr, store.csr().indices,
                             store.csr().weights)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# random delta sequences (test_graph_delta_props.py's property)
# --------------------------------------------------------------------------- #
def _random_graph(seed: int):
    """A random multigraph: duplicate (src, dst) pairs and self-loops
    included — from_edges canonicalizes by weight summation."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 48))
    m = int(rng.integers(0, 4 * n))
    return (rng.integers(0, n, size=m), rng.integers(0, n, size=m),
            rng.uniform(0.1, 2.0, size=m), n)


def _random_delta(store, rng):
    """Disjoint random add/remove/reweight picks over the current edges,
    as port GraphDelta (built from plain arrays both sides can take)."""
    src_e, dst_e, w_e = store.csr().edge_list()
    n, n_e = store.n, src_e.shape[0]
    k_total = int(rng.integers(0, n_e + 1)) if n_e else 0
    pick = (rng.choice(n_e, size=k_total, replace=False)
            if k_total else np.zeros(0, np.int64))
    n_rm = int(rng.integers(0, k_total + 1))
    rm, rw = pick[:n_rm], pick[n_rm:]
    existing = set((int(s) << 32) | int(d) for s, d in zip(src_e, dst_e))
    added = []
    for _ in range(100):
        if len(added) >= int(rng.integers(0, 8)):
            break
        s, d = int(rng.integers(0, n)), int(rng.integers(0, n))
        if ((s << 32) | d) in existing:
            continue
        existing.add((s << 32) | d)
        added.append((s, d, float(rng.uniform(0.1, 2.0))))
    return dict(
        added_edges=np.array(added) if added else None,
        removed_edges=(np.stack([src_e[rm], dst_e[rm]], axis=1)
                       .astype(np.int64) if rm.size else None),
        reweighted=((src_e[rw].astype(np.int64), dst_e[rw].astype(np.int64),
                     w_e[rw] * rng.uniform(0.5, 1.5, size=rw.size))
                    if rw.size else None))


def check_delta_sequence(graph_seed, delta_seed, n_deltas, reference):
    """After every delta of a random sequence, every patched view equals
    a rebuild bit for bit (and, with ``reference``, the reference
    store's patched views)."""
    edges = _random_graph(graph_seed)
    ts = tg.GraphStore.from_edges(*edges)
    rs = rg.GraphStore.from_edges(*edges) if reference else None
    for store in (ts, rs):
        if store is not None:
            _materialize(store, BS, N_BUCKETS, ENGINE_KEY)
    rng = np.random.default_rng(delta_seed)
    for i in range(n_deltas):
        kw = _random_delta(ts, rng)
        delta = tg.GraphDelta.make(**kw)
        version = ts.version
        ts.apply_delta(delta)
        ctx = (f"graph_seed={graph_seed} delta_seed={delta_seed} step={i} "
               f"({delta.n_changes} changes)")
        if delta.is_empty:
            assert ts.version == version, ctx
            continue
        assert ts.version == version + 1, ctx
        _assert_views_equal(ts, tg.GraphStore.from_csr(ts.csr()), BS,
                            N_BUCKETS, ENGINE_KEY, ctx=ctx)
        if reference:
            rs.apply_delta(rg.GraphDelta.make(**kw))
            _assert_views_equal(ts, rs, BS, N_BUCKETS, ENGINE_KEY,
                                ctx="reference " + ctx)


@settings(max_examples=25, deadline=None)
@given(graph_seed=st.integers(0, 2**31 - 1),
       delta_seed=st.integers(0, 2**31 - 1),
       n_deltas=st.integers(1, 4))
def test_delta_sequences_bit_identical_prop(graph_seed, delta_seed,
                                            n_deltas):
    check_delta_sequence(graph_seed, delta_seed, n_deltas, reference=False)


@pytest.mark.parametrize("case", range(8))
def test_delta_sequences_match_reference(case, repro_seed):
    check_delta_sequence(graph_seed=repro_seed + 101 * case,
                         delta_seed=repro_seed + 7919 * case + 1,
                         n_deltas=3, reference=True)


# --------------------------------------------------------------------------- #
# Problem.with_graph
# --------------------------------------------------------------------------- #
def test_problem_with_graph_shares_store():
    g = webgraph_like(512, seed=1)
    problem = repro_torch.Problem.pagerank(g)
    store = problem.graph
    assert problem.graph is store
    store.apply_delta(tg.rotation_churn(store, 5, seed=0))
    p2 = problem.with_graph(store)
    assert p2.graph is store and p2.store_version == 1
    assert p2.b is problem.b and p2.target_error == problem.target_error
    assert p2.p.n_edges == store.n_edges
    with pytest.raises(ValueError, match="cannot change N"):
        problem.with_graph(tg.GraphStore.from_csr(webgraph_like(256, seed=2)))
    with pytest.raises(ValueError, match="stale Problem snapshot"):
        problem.graph


# --------------------------------------------------------------------------- #
# update_graph: the delta re-solve against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method,opts,n", [
    ("frontier:segment_sum", {}, 600),
    ("frontier:pallas", {}, 600),
    # K1's plain twin against the Pallas kernel in interpret mode, over
    # the patched tile pool (a smaller graph: interpret mode is slow)
    ("frontier:pallas", {"interpret": True, "bs": 64}, 256),
    ("engine:chunk", {}, 600),
    ("engine:bsr", {}, 600),
])
def test_update_graph_matches_reference(method, opts, n):
    """A cold solve, a rotation delta through update_graph, the warm
    re-solve: |F'|_1, rounds and edge pushes as the reference's (k=1 for
    the engine, one device on either side), |Δx|_1 <= 1e-6."""
    g = webgraph_like(n, seed=1)
    ref = repro.SolverSession(repro.Problem.pagerank(g), method=method,
                              **opts)
    port = repro_torch.SolverSession(repro_torch.Problem.pagerank(g),
                                     method=method, device="cpu", **opts)
    a, b = ref.solve(), port.solve()
    assert (a.n_rounds, a.n_ops) == (b.n_rounds, b.n_ops)
    dr = rg.rotation_churn(ref.problem.graph, n // 50, seed=3)
    dt = tg.rotation_churn(port.problem.graph, n // 50, seed=3)
    _same_delta(dr, dt)
    r0, t0 = ref.update_graph(dr), port.update_graph(dt)
    assert t0 == pytest.approx(r0, rel=1e-5)
    assert port.problem.store_version == 1
    assert port.lifetime_ops == b.n_ops
    wa, wb = ref.solve(), port.solve()
    assert wb.converged and wb.n_rounds == wa.n_rounds
    if method.startswith("engine"):
        assert wb.n_ops == wa.n_ops
    else:
        assert wb.cost_iterations == pytest.approx(wa.cost_iterations,
                                                   rel=0.01)
    assert np.abs(wa.x - wb.x).sum() <= 1e-6
    cold = repro_torch.SolverSession(port.problem, method=method,
                                     device="cpu", **opts).solve()
    assert cold.n_ops > wb.n_ops
    assert np.abs(cold.x - wb.x).sum() <= 2 * port.problem.target_error


@pytest.mark.parametrize("method", ["frontier:segment_sum", "engine:chunk"])
def test_update_graph_rolls_back_a_malformed_delta(method):
    g = webgraph_like(400, seed=2)
    session = repro_torch.SolverSession(repro_torch.Problem.pagerank(g),
                                        method=method, device="cpu")
    first = session.solve()
    store = session.problem.graph
    src_e, dst_e, _ = store.csr().edge_list()
    present = set((int(s) << 32) | int(d) for s, d in zip(src_e, dst_e))
    missing = next((0, d) for d in range(1, 400) if d not in present)
    bad = tg.GraphDelta.make(removed_edges=np.array([missing]))
    with pytest.raises(ValueError, match="does not exist"):
        session.update_graph(bad)
    assert store.version == 0 and session.problem.store_version == 0
    with pytest.raises(TypeError):
        session.update_graph("not a delta")
    assert session.update_graph(tg.GraphDelta.make()) == session.residual
    again = session.solve()  # nothing moved: no round more in this phase
    assert (again.n_rounds, again.n_ops) == (first.n_rounds, first.n_ops)
    assert np.array_equal(again.x, first.x)


def test_update_graph_rolls_back_after_the_store_mutated(monkeypatch):
    """A driver rebuild that fails after apply_delta: the store is
    spliced back to the old graph, the session re-seeds over it and
    keeps serving the pre-delta problem."""
    from repro_torch.api import session as sess

    g = webgraph_like(400, seed=2)
    session = repro_torch.SolverSession(repro_torch.Problem.pagerank(g),
                                        device="cpu")
    first = session.solve()
    store = session.problem.graph
    csr0 = [a.copy() for a in (store.csr().indptr, store.csr().indices,
                               store.csr().weights)]
    real = sess._DRIVERS["frontier:segment_sum"]
    calls = []

    def flaky(problem, options):
        calls.append(problem.store_version)
        if len(calls) == 1:
            raise RuntimeError("driver rebuild failed")
        return real(problem, options)

    monkeypatch.setitem(sess._DRIVERS, "frontier:segment_sum", flaky)
    with pytest.raises(RuntimeError, match="driver rebuild failed"):
        session.update_graph(tg.rotation_churn(store, 6, seed=1))
    assert calls == [1, 2]  # applied, then rolled back by the inverse
    for a, b in zip(csr0, (store.csr().indptr, store.csr().indices,
                           store.csr().weights)):
        np.testing.assert_array_equal(a, b)
    again = session.solve()
    assert again.converged
    assert np.abs(again.x - first.x).sum() <= 2 * first.residual + 1e-6


def test_stale_session_refuses_to_run():
    problem = repro_torch.Problem.pagerank(webgraph_like(512, seed=1))
    _ = problem.graph  # materialize the shared store
    a = repro_torch.SolverSession(problem, device="cpu")
    b = repro_torch.SolverSession(problem, device="cpu")
    a.solve()
    b.solve()
    a.update_graph(tg.rotation_churn(a.problem.graph, 5, seed=0))
    with pytest.raises(ValueError, match="stale Problem snapshot"):
        b.warm_start(problem.b)
    with pytest.raises(ValueError, match="stale Problem snapshot"):
        b.solve()
    a.solve()


def test_engine_churn_signal_feeds_rebalancer():
    """Graph churn maps onto owning PIDs (as the reference's loop over
    buckets does), reaches the rebalancer as one graph-churn LoadSignal,
    and its MovePlans execute and are logged."""
    from repro_torch.api.session import _DRIVERS
    from repro_torch.balance import MovePlan

    problem = repro_torch.Problem.pagerank(webgraph_like(1024, seed=1))
    options = repro_torch.SolverOptions(k=4, device="cpu").validated()
    driver = _DRIVERS["engine:chunk"](problem, options)
    driver.seed(problem.b)

    class Recorder:
        def __init__(self):
            self.signals = []

        def propose(self, sig):
            self.signals.append(sig)
            return [MovePlan(src=0, dst=1, units=1, kind="bucket")]

        def reset_worker(self, k):
            pass

    rec = Recorder()
    driver.engine.rebalancer = rec
    delta = tg.rotation_churn(problem.graph, 50, seed=2)
    churn = delta.churn_per_node(problem.n)
    a = driver.engine.a
    want = np.zeros(4)
    for bid in range(a.n_rows):  # the reference's loop
        home = int(a.pos_of_bucket[bid])
        nodes = a.node_of_slot[home]
        cur = int(driver.ex.row_of_bucket[bid])
        want[cur // driver.cfg.buckets_per_dev] += churn[
            nodes[nodes >= 0]].sum()
    driver.note_graph_churn(churn)
    assert len(rec.signals) == 1
    sig = rec.signals[0]
    assert sig.kind == "graph-churn" and sig.values.shape == (4,)
    np.testing.assert_allclose(sig.values, want / want.sum())
    assert driver.move_log(), "churn-driven MovePlan was not executed"
