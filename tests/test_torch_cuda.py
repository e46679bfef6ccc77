"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA card and nvcc, and skips itself (inside a
fixture) without one.  The file imports neither JAX nor the reference, so
it also runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -o markers=cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports the JAX reference.)
Tolerances: float32 sums taken in another order than the twin's, on
values of order 1: rtol 1e-5 with atol 1e-6 (1e-5 for the products, whose
sums run over more terms); relaunches must be bit-identical (no atomics).
K1's and K2's bulk routes are held bit-equal to their simt bodies.
K4 (fm_interaction) is held to 1e-5 of the magnitude of its cancelling
terms, K5 (segment_sum, contiguous and gather forms) to rtol/atol 1e-5,
and exactly on integer-valued inputs, whose sums do not depend on the
order.  K7 (sim_messages and sim_push, float64) is held bit-equal to
its plain versions, the sum adding in message order as the reference's
np.add.at does; the simulator on the card to its CPU run within
|Δh|_1 <= 1e-10.
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


def _k1_operands(monkeypatch, m, f, w, t, tau):
    """The operands ops.frontier_round_bsr hands K1 for this round."""
    from repro_torch.kernels.diffusion import ops

    got = []
    real = ops.frontier_round_bsr_kernel

    def capture(*args, **kw):
        got.append(args)
        return real(*args, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(ops, "frontier_round_bsr_kernel", capture)
        td.frontier_round_bsr(m, f, w, t, backend="kernel",
                              occupancy_threshold=tau)
    return got[0]


def _launch_k1_both(ins):
    """K1's bulk body twice and its simt body, counted nowhere."""
    before = (dict(LAUNCHES), dict(td.FRONTIER_ROUTES))
    bulk = td.launch_frontier_round_bsr(*ins, route="bulk")
    again = td.launch_frontier_round_bsr(*ins, route="bulk")
    simt = td.launch_frontier_round_bsr(*ins, route="simt")
    torch.cuda.synchronize()
    assert (bulk[2], simt[2]) == ("bulk", "simt")
    assert (dict(LAUNCHES), dict(td.FRONTIER_ROUTES)) == before
    for a, b in ((bulk, simt), (bulk, again)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    return bulk[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 0.5])
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("bs", [8, 16, 64, 128])
def test_frontier_round_bulk_route_gives_the_simt_bits(cuda_device,
                                                      monkeypatch, bs, c,
                                                      tau):
    """K1's two bodies take every sum in the same order: on the operands
    ops.frontier_round_bsr builds, the bulk body's f_new and row_l1 are
    bit-equal to the simt body's, relaunch after relaunch, and within
    rtol 1e-5 / atol 1e-6 of the plain version."""
    _, m, f, w, t = _round_inputs(700, c, 4, bs, cuda_device)
    ins = _k1_operands(monkeypatch, m, torch.from_numpy(f).to(cuda_device),
                       torch.from_numpy(w).to(cuda_device),
                       torch.tensor(t, device=cuda_device), tau)
    f_new, row_l1 = _launch_k1_both(ins)
    plain = td.frontier_round_bsr_plain(*[a.cpu() for a in ins])
    np.testing.assert_allclose(f_new.cpu().numpy(), plain[0].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(row_l1.cpu().numpy(), plain[1].numpy(),
                               rtol=1e-5, atol=1e-6)


def _frontier_case(bs, c, seed, arming, device):
    """K1's operands over 44 block rows, of which rows 0, 2, 4, 5 and 43
    own 3, 40 (the bulk ring wraps many times), 2, 1 (its own column, 5)
    and 4 tiles, the rest none; positive tiles, so the sums do not cancel.
    ``arming``: ``mixed`` (about half the columns armed, every column of
    row 4 unarmed), ``none`` (every column unarmed) or ``own`` (only
    column 5: row 5's own)."""
    rng = np.random.default_rng(seed)
    nrb = 44
    counts = np.zeros(nrb, np.int64)
    counts[[0, 2, 4, 5, 43]] = [3, 40, 2, 1, 4]
    cols = [np.sort(rng.choice(nrb, n, replace=False)) for n in counts]
    cols[5] = np.array([5])
    row_ptr = np.zeros(nrb + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    block_col = np.concatenate(cols).astype(np.int32)
    blocks = (rng.random((block_col.size, bs, bs)) / bs).astype(np.float32)
    f = rng.standard_normal((nrb, bs, c)).astype(np.float32)
    wt = (2.0 * rng.random((nrb, bs))).astype(np.float32)
    if arming == "mixed":
        col_active = (rng.random(nrb) < 0.5).astype(np.int32)
        col_active[cols[4]] = 0
    else:
        col_active = np.zeros(nrb, np.int32)
        if arming == "own":
            col_active[5] = 1
    return [torch.from_numpy(a).to(device)
            for a in (blocks, block_col, row_ptr, col_active, f, wt)]


@pytest.mark.cuda
@pytest.mark.parametrize("arming", ["mixed", "none", "own"])
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("bs", [8, 128])
def test_frontier_round_bulk_route_edge_rows(cuda_device, bs, c, arming):
    """The bulk body on a 40-tile row, interleaved empty rows, a row whose
    tiles are all unarmed, every column unarmed and only a row's own
    column armed: the simt body's bits, and every row without an armed
    tile exactly its kept fluid."""
    ins = _frontier_case(bs, c, seed=bs + c, arming=arming,
                         device=cuda_device)
    f_new, _ = _launch_k1_both(ins)
    blocks, block_col, row_ptr, col_active, f, wt = [a.cpu() for a in ins]
    fire = (f.abs() * wt[..., None] > 1.0) & (col_active != 0)[:, None, None]
    kept = torch.where(fire, torch.zeros_like(f), f)
    armed = (col_active != 0)[block_col.long()].long()
    n_armed = torch.zeros(len(f), dtype=torch.long).index_add_(
        0, td.kernel._rows_of(row_ptr), armed)
    idle = n_armed == 0
    assert int(idle.sum()) >= 39  # the rows without tiles, and more
    assert (not bool(idle[5])) if arming == "own" else bool(idle[4])
    assert torch.equal(f_new.cpu()[idle], kept[idle])
    plain = td.frontier_round_bsr_plain(blocks, block_col, row_ptr,
                                        col_active, f, wt)
    np.testing.assert_allclose(f_new.cpu().numpy(), plain[0].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_frontier_round_unaligned_or_odd_bs_runs_simt(cuda_device):
    """An f that does not start on 16 bytes, or an odd bs, takes the simt
    body (the bulk copies need both), which the bulk route refuses."""
    ins = _frontier_case(128, 1, seed=2, arming="mixed", device=cuda_device)
    f = ins[4]
    f_off = torch.empty(f.numel() + 1, device=cuda_device)[1:].view(f.shape)
    f_off.copy_(f)
    aligned = td.launch_frontier_round_bsr(*ins)
    off = td.launch_frontier_round_bsr(*ins[:4], f_off, ins[5])
    assert (aligned[2], off[2]) == ("bulk", "simt")
    assert torch.equal(aligned[0], off[0]) and torch.equal(aligned[1], off[1])
    with pytest.raises(RuntimeError, match="route bulk"):
        td.launch_frontier_round_bsr(*ins[:4], f_off, ins[5], route="bulk")
    odd = _frontier_case(7, 2, seed=3, arming="mixed", device=cuda_device)
    got = td.launch_frontier_round_bsr(*odd)
    assert got[2] == "simt"
    with pytest.raises(RuntimeError, match="route bulk"):
        td.launch_frontier_round_bsr(*odd, route="bulk")
    plain = td.frontier_round_bsr_plain(*[a.cpu() for a in odd])
    np.testing.assert_allclose(got[0].cpu().numpy(), plain[0].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [7, 128])
def test_frontier_round_counts_each_launch_under_its_route(cuda_device, bs):
    """The wrapper runs the route the source picks (simt for an odd bs) and
    counts each launch once in FRONTIER_ROUTES beside LAUNCHES."""
    ins = _frontier_case(bs, 1, seed=5, arming="mixed", device=cuda_device)
    route = td.frontier_round_bsr_route(bs, 1)
    assert route == ("simt" if bs % 4 else "bulk")
    before, routes = LAUNCHES["frontier_round_bsr"], dict(td.FRONTIER_ROUTES)
    td.frontier_round_bsr_kernel(*ins)
    torch.cuda.synchronize()
    assert LAUNCHES["frontier_round_bsr"] == before + 1
    assert td.FRONTIER_ROUTES == {k: v + (k == route)
                                  for k, v in routes.items()}


@pytest.mark.cuda
def test_frontier_round_route_mirror_matches_the_source(cuda_device):
    """kernel.frontier_round_bsr_route is csrc/diffusion.cu's rule, shape
    for shape."""
    import ctypes

    lib = td.kernel._lib()
    names = {0: "simt", 1: "bulk", -1: None}
    for bs in list(range(1, 17)) + [96, 100, 128, 256, 500, 512, 1000, 1024]:
        for c in (1, 2, 3, 4, 5, 8, 9, 16, 20, 21, 28, 29, 56, 57, 64):
            for aligned in (True, False):
                out = ctypes.c_int()
                lib.frontier_round_bsr_route(bs, c, int(aligned),
                                             ctypes.byref(out))
                assert names[out.value] == td.frontier_round_bsr_route(
                    bs, c, aligned), (bs, c, aligned)


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


def _visit_case(bs, c, seed, device):
    """A shuffled pool of 60 tiles and 6 output rows of 3, 0, 40, 0, 2 and
    1 visits (the 40-visit row wraps the bulk ring many times), visits in
    no tile order; positive values, so the sums do not cancel."""
    rng = np.random.default_rng(seed)
    counts = np.array([3, 0, 40, 0, 2, 1])
    n_visits = int(counts.sum())
    row_ptr = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    pool = (rng.random((60, bs, bs)) / bs).astype(np.float32)
    visit_block = rng.integers(0, 60, n_visits).astype(np.int32)
    visit_col = rng.integers(0, 5, n_visits).astype(np.int32)
    x = rng.random((5, bs, c)).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (pool, visit_block, visit_col, row_ptr, x)]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("bs", [4, 8, 64, 128, 512])
def test_bsr_spmm_bulk_route_gives_the_simt_bits(cuda_device, bs, c):
    """K2's two bodies take every sum in the same order: the bulk route is
    bit-equal to the simt body, relaunch after relaunch, and within the
    products' rtol / atol 1e-5 of the plain version; empty rows are 0."""
    from repro_torch.kernels.diffusion.kernel import launch_bsr_spmm

    ins = _visit_case(bs, c, seed=bs * 10 + c, device=cuda_device)
    before = (dict(LAUNCHES), dict(td.ROUTES))
    bulk, route = launch_bsr_spmm(*ins, route="bulk")
    again, _ = launch_bsr_spmm(*ins, route="bulk")
    simt, simt_route = launch_bsr_spmm(*ins, route="simt")
    torch.cuda.synchronize()
    assert (route, simt_route) == ("bulk", "simt")
    assert (dict(LAUNCHES), dict(td.ROUTES)) == before
    assert torch.equal(bulk, simt) and torch.equal(bulk, again)
    assert bool((bulk[1] == 0).all()) and bool((bulk[3] == 0).all())
    plain = td.bsr_spmm_plain(*[t.cpu() for t in ins])
    np.testing.assert_allclose(bulk.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [7, 128])
def test_bsr_spmm_counts_each_launch_under_its_route(cuda_device, bs):
    """The wrapper runs the route the source picks (simt for an odd bs) and
    counts it in ROUTES beside LAUNCHES."""
    ins = _visit_case(bs, 1, seed=3, device=cuda_device)
    route = td.bsr_spmm_route(bs, 1)
    assert route == ("simt" if bs % 4 else "bulk")
    before, routes = LAUNCHES["bsr_spmm"], dict(td.ROUTES)
    got = td.bsr_spmm_kernel(*ins)
    torch.cuda.synchronize()
    assert LAUNCHES["bsr_spmm"] == before + 1
    assert td.ROUTES == {k: v + (k == route) for k, v in routes.items()}
    plain = td.bsr_spmm_plain(*[t.cpu() for t in ins])
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_bsr_spmm_route_mirror_matches_the_source(cuda_device):
    """kernel.bsr_spmm_route is csrc/diffusion.cu's rule, shape for shape,
    and a misaligned x takes the simt body."""
    import ctypes

    from repro_torch.kernels.diffusion import kernel as k2

    lib = k2._lib()
    names = {0: "simt", 1: "bulk", -1: None}
    for bs in list(range(1, 17)) + [96, 100, 128, 256, 500, 512, 1000, 1024]:
        for c in (1, 2, 3, 8, 9, 10, 16, 39, 40, 64):
            for aligned in (True, False):
                out = ctypes.c_int()
                lib.bsr_spmm_route(bs, c, int(aligned), ctypes.byref(out))
                assert names[out.value] == td.bsr_spmm_route(bs, c, aligned), (
                    bs, c, aligned)
    pool, vb, vc, ptr, x = _visit_case(128, 1, seed=1, device=cuda_device)
    x_off = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    x_off.copy_(x)
    got, route = k2.launch_bsr_spmm(pool, vb, vc, ptr, x_off)
    assert route == "simt"
    assert torch.equal(got, k2.launch_bsr_spmm(pool, vb, vc, ptr, x)[0])


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


def _engine_pair(backend, device, n=4000, k=4):
    from repro_torch.balance import BucketMoveExecutor
    from repro_torch.core.distributed import (
        DistributedEngine, EngineConfig, build_engine_arrays)

    g = power_law_graph(n, seed=7)
    g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    p, b = pagerank_system(g)
    cfg = EngineConfig(k=k, target_error=1e-6, eps=0.15,
                       buckets_per_dev=12, headroom=4,
                       diffusion_backend=backend, device=str(device))
    eng = DistributedEngine(build_engine_arrays(p, b, cfg), cfg)
    return eng, BucketMoveExecutor(eng, eng.init_state())


@pytest.mark.cuda
@pytest.mark.parametrize("moved", [False, True])
def test_k2_over_engine_visit_table_matches_plain(cuda_device, moved):
    """K2 fed the engine's visit table (bsr_gather_spmm's port) against
    its plain twin on the same card inputs, before and after a move."""
    from repro_torch.balance import MovePlan

    eng, ex = _engine_pair("bsr", cuda_device)
    if moved:
        assert ex.apply(MovePlan(src=0, dst=3, units=2, kind="bucket")) == 2
    a = eng.a
    rng = np.random.default_rng(5)
    sent = torch.from_numpy(rng.standard_normal(
        (a.n_rows, a.bucket_size)).astype(np.float32)).to(cuda_device)
    t = ex.table
    before = LAUNCHES["bsr_spmm"]
    got = td.engine_tile_push(eng.pool, t, sent)
    again = td.engine_tile_push(eng.pool, t, sent)
    torch.cuda.synchronize()
    assert LAUNCHES["bsr_spmm"] == before + 2
    assert torch.equal(got, again)
    plain = td.bsr_spmm_plain(eng.pool, t.visit_block, t.visit_col,
                              t.row_ptr, sent[:, :, None])[..., 0]
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kernel", [("bsr", "bsr_spmm"),
                                            ("segment_sum", "edge_sum")])
def test_engine_solve_on_the_card_matches_the_cpu(cuda_device, backend,
                                                   kernel):
    from repro_torch.balance import MovePlan

    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng, ex = _engine_pair(backend, dev)
        before = LAUNCHES[kernel]
        tol = eng.cfg.target_error * eng.cfg.eps
        for i in range(eng.cfg.max_chunks):
            ex.state, stats = eng.run_chunk(ex.state, *ex.chunk_operands())
            if i == 0:
                assert ex.apply(MovePlan(src=0, dst=3, units=2,
                                         kind="bucket")) == 2
            if float(stats["residual"]) <= tol:
                break
        runs[dev.type] = (eng.extract_solution(ex.state, ex.row_of_bucket),
                          ex.state.rounds, LAUNCHES[kernel] - before)
    (x_card, rounds, launches), (x_cpu, _, cpu_launches) = (
        runs["cuda"], runs["cpu"])
    assert launches == rounds and cpu_launches == 0
    assert np.abs(x_card - x_cpu).sum() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d", [(1, 2, 1), (7, 5, 4), (300, 39, 10),
                                   (257, 13, 64), (33, 26, 128)])
def test_fm_kernel_matches_plain(cuda_device, b, f, d):
    from repro_torch.kernels.fm import fm_interaction, fm_interaction_ref

    v = np.random.default_rng(b + f + d).standard_normal(
        (b, f, d)).astype(np.float32)
    v_d = torch.from_numpy(v).to(cuda_device)
    before = LAUNCHES["fm_interaction"]
    got = fm_interaction(v_d)
    again = fm_interaction(v_d)
    torch.cuda.synchronize()
    assert LAUNCHES["fm_interaction"] == before + 2
    assert got.shape == (b,) and torch.equal(got, again)
    # the sum-square trick cancels: hold each sample to 1e-5 of the
    # magnitude of its terms (see test_torch_fm.py)
    v64 = v.astype(np.float64)
    scale = 0.5 * (v64.sum(1) ** 2 + (v64 * v64).sum(1)).sum(-1)
    plain = fm_interaction_ref(torch.from_numpy(v)).numpy()
    err = np.abs(got.cpu().numpy().astype(np.float64) - plain)
    assert np.all(err <= 1e-5 * (1.0 + scale))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 10, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("gather", [False, True])
def test_segment_sum_kernel_matches_plain(cuda_device, d, weighted, gather):
    from repro_torch.kernels.segment import (
        pad_sorted_edges, segment_sum_ref, segment_sum_sorted)

    rng = np.random.default_rng(d)
    e, n = 3001, 400
    seg = np.sort(rng.integers(0, n // 2, e)).astype(np.int32)
    seg[seg % 5 == 3] -= 1  # every fifth segment of the lower half is empty
    seg = np.sort(seg)
    data = rng.standard_normal((e, d)).astype(np.float32)
    data_t, seg_t = pad_sorted_edges(torch.from_numpy(data),
                                     torch.from_numpy(seg), 512)
    w = (torch.from_numpy(rng.choice([0.0, 0.5, 2.0], data_t.shape[0])
                          .astype(np.float32)) if weighted else None)
    rows = None
    if gather:  # the rows read through an index into a node table
        rows = torch.from_numpy(rng.integers(0, 700, data_t.shape[0]))
        data_t = torch.from_numpy(rng.standard_normal((700, d))
                                  .astype(np.float32))
    dev = lambda t: None if t is None else t.to(cuda_device)
    before = LAUNCHES["segment_sum"]
    got = segment_sum_sorted(dev(data_t), dev(seg_t), n, weights=dev(w),
                             rows=dev(rows))
    again = segment_sum_sorted(dev(data_t), dev(seg_t), n, weights=dev(w),
                               rows=dev(rows))
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum"] == before + 2
    assert got.shape == (n, d) and torch.equal(got, again)
    assert bool((got[n // 2:] == 0).all())
    assert bool((got[3: n // 2: 5] == 0).all())
    plain = segment_sum_ref(data_t, seg_t, n, w, rows)
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def _long_segment_case(rng, chunk):
    """One segment of about 150,000 rows (many chunks), then a run of 20
    empty segments with a chunk boundary inside it, then segments of every
    length up to 3,000 and sentinel padding."""
    lengths = np.concatenate([[3, 150_000], np.zeros(20, np.int64),
                              rng.integers(0, 3000, 60), [0, 0]])
    seg = np.repeat(np.arange(lengths.size), lengths).astype(np.int32)
    # the boundary in the empty run: move rows from segment 1 so that the
    # first row after the run starts a chunk
    end = 150_003 + (-150_003) % chunk
    seg[150_003:end] = 1
    seg = np.concatenate([seg, np.full(777, 2**30, np.int32)])
    return seg, lengths.size


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("weighted", [True, False])
def test_segment_sum_kernel_long_segment_across_chunks(cuda_device, gather,
                                                      weighted):
    from repro_torch.kernels.segment import (
        CHUNK_ROWS, chunk_plan, row_ranges, segment_sum_kernel,
        segment_sum_ref)

    rng = np.random.default_rng(11)
    seg, n = _long_segment_case(rng, CHUNK_ROWS)
    e = seg.size
    seg_t = torch.from_numpy(seg).to(cuda_device)
    ptr = row_ranges(seg_t, n)
    plan = chunk_plan(ptr, e)
    assert (plan == 1).sum() >= 100  # segment 1 spans many chunks
    # segments 2..21 are empty, and a chunk begins where they sit
    assert int(ptr[2]) == int(ptr[22]) and int(ptr[2]) % CHUNK_ROWS == 0
    n_data = 5000 if gather else e
    rows = (torch.from_numpy(rng.integers(0, n_data, e)).to(cuda_device)
            if gather else None)
    w = (torch.from_numpy(rng.choice([0.0, 0.5, 1.0], e).astype(np.float32)
                          ).to(cuda_device) if weighted else None)
    # random rows: a sum of 150,000 float32 terms in another order than the
    # plain version's differs by ~1e-5 of its value, so the whole output is
    # held to relative L1 1e-5; integer-valued rows sum exactly
    random = torch.randn((n_data, 64), device=cuda_device)
    integer = torch.from_numpy(rng.integers(-8, 8, (n_data, 64))
                               .astype(np.float32)).to(cuda_device)
    for data in (random, integer):
        before = dict(LAUNCHES)
        got, again = (segment_sum_kernel(data, seg_t, n, w, ptr, rows, plan)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert LAUNCHES["segment_sum"] == before["segment_sum"] + 2
        assert LAUNCHES["segment_sum_carry"] == before["segment_sum_carry"] + 2
        assert torch.equal(got, again)
        # the plan the wrapper builds itself is the same
        assert torch.equal(got, segment_sum_kernel(data, seg_t, n, w, ptr,
                                                   rows))
        cpu = lambda t: None if t is None else t.cpu()
        plain = segment_sum_ref(data.cpu(), seg_t.cpu(), n, cpu(w), cpu(rows))
        if data is integer:
            assert torch.equal(got.cpu(), plain)
        rel = float((got.cpu().double() - plain.double()).abs().sum()
                    / plain.double().abs().sum())
        assert rel <= 1e-5
        assert bool((got[2:22] == 0).all()) and bool((got[-2:] == 0).all())


@pytest.mark.cuda
def test_segment_sum_kernel_is_exact_on_integers(cuda_device):
    """Integer-valued rows and weights sum exactly in any order: K5 must
    equal its plain version bit for bit, sentinel and mask-0 rows
    included."""
    from repro_torch.kernels.segment import (
        embedding_bag, embedding_bag_ref, segment_sum_ref, segment_sum_sorted)

    rng = np.random.default_rng(1)
    seg = np.sort(rng.integers(0, 300, 10_000)).astype(np.int32)
    seg[-100:] = 2**30
    data = rng.integers(-8, 8, (10_000, 64)).astype(np.float32)
    w = rng.integers(0, 3, 10_000).astype(np.float32)
    args = [torch.from_numpy(a) for a in (data, seg, w)]
    got = segment_sum_sorted(args[0].to(cuda_device), args[1].to(cuda_device),
                             300, weights=args[2].to(cuda_device))
    assert torch.equal(got.cpu(), segment_sum_ref(args[0], args[1], 300,
                                                  args[2]))
    # the gather form, through int32 rows of a 2,000-row table
    table = args[0][:2000]
    rows = torch.from_numpy(rng.integers(0, 2000, 10_000).astype(np.int32))
    got = segment_sum_sorted(table.to(cuda_device), args[1].to(cuda_device),
                             300, weights=args[2].to(cuda_device),
                             rows=rows.to(cuda_device))
    assert torch.equal(got.cpu(), segment_sum_ref(table, args[1], 300,
                                                  args[2], rows))
    table = torch.from_numpy(rng.integers(-4, 4, (50, 10)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (17, 9)).astype(np.int32))
    bw = torch.from_numpy(rng.integers(0, 3, (17, 9)).astype(np.float32))
    before = LAUNCHES["segment_sum"]
    got = embedding_bag(table.to(cuda_device), ids.to(cuda_device),
                        bw.to(cuda_device))
    assert LAUNCHES["segment_sum"] == before + 1
    assert torch.equal(got.cpu(), embedding_bag_ref(table, ids, bw))


@pytest.mark.cuda
def test_segment_sum_kernel_refuses_bad_rows(cuda_device):
    from repro_torch.kernels.segment import segment_sum_kernel

    data = torch.randn((50, 8), device=cuda_device)
    seg = torch.arange(20, dtype=torch.int32, device=cuda_device) // 2
    good = torch.arange(20, device=cuda_device)
    assert segment_sum_kernel(data, seg, 10, rows=good).shape == (10, 8)
    before = LAUNCHES["segment_sum"]
    for bad in (good.to(torch.float32), good.to(torch.int16), good[:19],
                good.reshape(4, 5), good.cpu(), good.repeat(2)[::2]):
        with pytest.raises(ValueError, match="rows"):
            segment_sum_kernel(data, seg, 10, rows=bad)
    with pytest.raises(ValueError, match="seg_ids"):  # no rows: data is [E, D]
        segment_sum_kernel(data, seg, 10)
    assert LAUNCHES["segment_sum"] == before


@pytest.mark.cuda
def test_fm_and_gin_forward_on_the_card_match_the_cpu(cuda_device):
    from repro_torch.data import criteo_like_batch, make_gnn_batch
    from repro_torch.models import gnn, recsys

    cfg = recsys.FMConfig(name="fm", n_fields=8, vocab_per_field=50,
                          embed_dim=6)
    card = recsys.FM(cfg, device=cuda_device)
    cpu = recsys.FM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = criteo_like_batch(0, 300, 8, 50)["ids"]
    before = LAUNCHES["fm_interaction"]
    got = recsys.forward_logits(card, ids)
    assert LAUNCHES["fm_interaction"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               recsys.forward_logits(cpu, ids).numpy(),
                               rtol=1e-5, atol=1e-5)
    gcfg = gnn.GNNConfig(name="g", arch="gin", n_layers=3, d_hidden=16,
                         d_feat=6, n_classes=4)
    g_card = gnn.init_params(gcfg, device=cuda_device)
    g_cpu = gnn.init_params(gcfg, device="cpu")
    g_cpu.load_state_dict({k: v.cpu() for k, v in g_card.state_dict().items()})
    batch = make_gnn_batch(power_law_graph(300, seed=0), 6, n_classes=4)
    before = LAUNCHES["segment_sum"]
    out = gnn.forward(g_card, batch)
    assert LAUNCHES["segment_sum"] == before + 3
    np.testing.assert_allclose(out.cpu().numpy(),
                               gnn.forward(g_cpu, batch).numpy(),
                               rtol=1e-4, atol=1e-5)


# K6: the reference's attention shapes (tests/test_kernels.py), inputs as
# the reference makes them; float32 sums in another order than the plain
# version's full softmax (rtol 1e-5 / atol 1e-6 on outputs of order 1),
# bf16 at the reference's own bf16 bound
ATTN_SHAPES = [(2, 4, 2, 256, 64, True), (1, 8, 1, 128, 32, True),
               (2, 4, 4, 384, 64, False), (1, 2, 1, 100, 64, True),
               (1, 16, 2, 128, 128, True)]


def _qkv(b, hq, hkv, sq, sk, dh, seed, dtype, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, dh)) * 0.2
    k = rng.standard_normal((b, hkv, sk, dh)) * 0.2
    v = rng.standard_normal((b, hkv, sk, dh))
    return [torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=dtype)
            for a in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,dh,causal", ATTN_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hkv, s, dh,
                                              causal, dtype):
    from repro_torch.kernels.attention import attention_plain, flash_attention

    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, hq, hkv, s, s, dh, s + dh, dt, cuda_device)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 2
    assert got.shape == q.shape and got.dtype == dt
    assert torch.equal(got, again)
    plain = attention_plain(q, k, v, causal=causal)
    tol = dict(rtol=1e-5, atol=1e-6) if dt == torch.float32 else dict(
        rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               plain.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_takes_strided_views_and_kv_len(cuda_device,
                                                               dtype):
    """The model's views: q and the cache as ``[B, S, H, Dh]`` transposed,
    the cache longer than the keys in use (decode); K6 must equal the
    same call on contiguous copies, and the plain version."""
    from repro_torch.kernels.attention import (
        attention_plain, flash_attention, flash_attention_kernel)

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    b, hq, hkv, smax, dh = 3, 8, 2, 300, 64
    cache = torch.from_numpy(rng.standard_normal(
        (2, b, smax, hkv, dh)).astype(np.float32)).to(cuda_device, dt)
    q_bshd = torch.from_numpy(rng.standard_normal(
        (b, 1, hq, dh)).astype(np.float32) * 0.2).to(cuda_device, dt)
    q = q_bshd.transpose(1, 2)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    assert not k.is_contiguous()
    tol = dict(rtol=1e-5, atol=1e-6) if dt == torch.float32 else dict(
        rtol=3e-2, atol=3e-2)
    for kv_len in (1, 63, 64, 65, 217, smax):
        got = flash_attention(q, k, v, causal=False, kv_len=kv_len)
        flat = flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=False,
                                      kv_len=kv_len)
        assert torch.equal(got, flat)
        # the keys past kv_len are never read: poisoning them changes nothing
        poisoned = cache.clone()
        poisoned[:, :, kv_len:] = float("nan")
        again = flash_attention(q, poisoned[0].transpose(1, 2),
                                poisoned[1].transpose(1, 2), causal=False,
                                kv_len=kv_len)
        assert torch.equal(got, again)
        plain = attention_plain(q, k[:, :, :kv_len], v[:, :, :kv_len],
                                causal=False)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   plain.float().cpu().numpy(), **tol)
    # causal prefill over [B, S, H, Dh] views with a ragged S
    x = torch.from_numpy(rng.standard_normal(
        (3, b, 129, hq, dh)).astype(np.float32) * 0.3).to(cuda_device, dt)
    qs, ks, vs = (x[i].transpose(1, 2) for i in range(3))
    got = flash_attention(qs, ks, vs, causal=True)
    assert torch.equal(got, flash_attention(
        qs.contiguous(), ks.contiguous(), vs.contiguous(), causal=True))
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        attention_plain(qs, ks, vs, causal=True).float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_prefill_every_head_dim(cuda_device, dh, causal):
    """bf16 with more than one query block runs K6's tensor-core path: every
    head dim, a ragged last block, GQA; Dh 64 and 128 on the wgmma kernel,
    16 and 32 on mma.sync (``ROUTES``)."""
    from repro_torch.kernels.attention import attention_plain, flash_attention

    from repro_torch.kernels.attention.kernel import ROUTES

    route = "wgmma" if dh in (64, 128) else "mma_sync"
    q, k, v = _qkv(2, 4, 2, 200, 200, dh, dh, torch.bfloat16, cuda_device)
    before = dict(ROUTES)
    got = flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))
    assert ROUTES == {r: n + 2 * (r == route) for r, n in before.items()}
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        attention_plain(q, k, v, causal=causal).float().cpu().numpy(),
        rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [65, 127, 128, 129, 300, 1000])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_wgmma_prefill_matches_plain(cuda_device, dh, causal,
                                                     group, sq):
    """K6's bf16 prefill kernel on wgmma and TMA
    (``flash_prefill_wgmma_kernel``) at ragged query blocks and key tiles (Sq around the 64-row warpgroup,
    the 128-key tile and the 128- or 192-row block), GQA, B = 2 over the
    model's transposed ``[B, S, H, Dh]`` views (equal to the same call on
    contiguous copies), and over a longer cache cut at kv_len 65, 200 and
    511, as a layer with a cache calls it, whose tail past kv_len is NaN
    and changes nothing: within the bf16 bound of the plain version,
    bit-identical on relaunch, every call counted under ``wgmma``."""
    from repro_torch.kernels.attention import (
        attention_plain, flash_attention, flash_attention_kernel)
    from repro_torch.kernels.attention.kernel import ROUTES

    b, hkv, smax = 2, 2, 512
    hq = hkv * group
    rng = np.random.default_rng(10_000 * dh + 1000 * group + 2 * sq + causal)

    def bshd(h, s, scale):
        x = rng.standard_normal((b, s, h, dh)).astype(np.float32) * scale
        return torch.from_numpy(x).to(cuda_device,
                                      torch.bfloat16).transpose(1, 2)

    def check(got, want):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), rtol=3e-2,
                                   atol=3e-2)

    q, k, v = bshd(hq, sq, 0.5), bshd(hkv, sq, 0.5), bshd(hkv, sq, 1.0)
    assert not q.is_contiguous()
    before = ROUTES["wgmma"]
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    flat = flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal)
    torch.cuda.synchronize()
    assert ROUTES["wgmma"] == before + 3
    assert torch.equal(got, again) and torch.equal(got, flat)
    check(got, attention_plain(q, k, v, causal=causal))
    cache = torch.from_numpy(rng.standard_normal(
        (2, b, smax, hkv, dh)).astype(np.float32)).to(cuda_device,
                                                      torch.bfloat16)
    ck, cv = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    for kv_len in (65, 200, 511):
        poisoned = cache.clone()
        poisoned[:, :, kv_len:] = float("nan")
        before = ROUTES["wgmma"]
        got = flash_attention(q, ck, cv, causal=causal, kv_len=kv_len)
        again = flash_attention(q, ck, cv, causal=causal, kv_len=kv_len)
        tail = flash_attention(q, poisoned[0].transpose(1, 2),
                               poisoned[1].transpose(1, 2), causal=causal,
                               kv_len=kv_len)
        torch.cuda.synchronize()
        assert ROUTES["wgmma"] == before + 3
        assert torch.equal(got, again) and torch.equal(got, tail)
        check(got, attention_plain(q, ck, cv, causal=causal, kv_len=kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 5, 64])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_attention_split_kv_matches_plain(cuda_device, sq, group, dh,
                                                dtype):
    """K6's decode kernel (Sq <= 64) over a ``[B, Smax, Hkv, Dh]`` cache
    through the model's transposed views, at kv_len values that leave the
    last tile ragged and splits ragged or empty (4224: 33 tiles over 8
    splits; causal: every split past the first tile): equal to the plain
    version, causal or not, bit-identical on relaunch and with the tail
    past kv_len poisoned with NaN; one K6 launch a call, run with the split
    count the policy gives (more than 1 at kv_len 4224 wherever a kv head
    serves at most 64 rows; the splits are combined in the same launch)."""
    from repro_torch.kernels.attention import attention_plain, flash_attention
    from repro_torch.kernels.attention.kernel import (
        SPLITS, decode_geometry, split_count)

    dt = getattr(torch, dtype)
    b, hkv, smax = 2, 2, 4224
    hq = hkv * group
    rng = np.random.default_rng(1000 * sq + 10 * group + dh)
    cache = torch.from_numpy(rng.standard_normal(
        (2, b, smax, hkv, dh)).astype(np.float32)).to(cuda_device, dt)
    q = torch.from_numpy(rng.standard_normal(
        (b, sq, hq, dh)).astype(np.float32) * 0.2).to(cuda_device,
                                                      dt).transpose(1, 2)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    tol = dict(rtol=1e-5, atol=1e-6) if dt == torch.float32 else dict(
        rtol=3e-2, atol=3e-2)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for kv_len in (1, 63, 64, 65, 4095, 4096, 4224):
        n_split = split_count(b, hq, hkv, sq, kv_len, n_sm,
                              decode_geometry(dt, dh))
        assert kv_len < 4224 or sq * group > 64 or n_split > 1
        poisoned = cache.clone()
        poisoned[:, :, kv_len:] = float("nan")
        before = dict(LAUNCHES)
        splits_before = SPLITS["flash_attention"]
        got = flash_attention(q, k, v, causal=False, kv_len=kv_len)
        again = flash_attention(q, k, v, causal=False, kv_len=kv_len)
        tail = flash_attention(q, poisoned[0].transpose(1, 2),
                               poisoned[1].transpose(1, 2), causal=False,
                               kv_len=kv_len)
        causal = flash_attention(q, k, v, causal=True, kv_len=kv_len)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] - before["flash_attention"] == 4
        assert SPLITS["flash_attention"] - splits_before == 4 * n_split
        assert torch.equal(got, again) and torch.equal(got, tail)
        for out, c in ((got, False), (causal, True)):
            np.testing.assert_allclose(
                out.float().cpu().numpy(),
                attention_plain(q, k, v, causal=c, kv_len=kv_len).float()
                .cpu().numpy(), **tol)


@pytest.mark.cuda
def test_decode_geometry_is_what_the_policy_tests_assume(cuda_device):
    """The decode kernel reports the geometry that
    tests/test_torch_attention.py holds ``split_count`` to: Sq <= 64, 4
    query rows a CTA, 128-key tiles in bf16 at Dh 64 and 64-key tiles in
    float32 at Dh 128."""
    from repro_torch.kernels.attention.kernel import decode_geometry

    assert decode_geometry(torch.bfloat16, 64) == (64, 4, 128)
    assert decode_geometry(torch.float32, 128) == (64, 4, 64)


@pytest.mark.cuda
def test_flash_attention_decode_graphs_replay_on_two_streams(cuda_device):
    """Two CUDA graphs of split decode calls, both captured on torch's one
    default capture stream, replayed the second before the first ever has
    and then both at once on two streams: each equals the plain version of
    its inputs, so no two launches share their arrival counters."""
    from repro_torch.kernels.attention import attention_plain, flash_attention
    from repro_torch.kernels.attention.kernel import (
        decode_geometry, split_count)

    b, hq, hkv, sk, dh = 1, 8, 8, 4096, 64
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert split_count(b, hq, hkv, 1, sk, n_sm,
                       decode_geometry(torch.float32, dh)) > 1
    rng = np.random.default_rng(11)

    def inputs():
        return [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device) for shape in
            ((b, hq, 1, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]

    sets = [inputs(), inputs()]
    outs, graphs = [], []
    for qkv in sets:
        flash_attention(*qkv, causal=False)  # builds and loads K6
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(flash_attention(*qkv, causal=False))
        graphs.append(graph)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for round_ in range(3):
        for qkv in sets:
            for t, new in zip(qkv, inputs()):
                t.copy_(new)
        torch.cuda.synchronize()
        order = (1,) if round_ == 0 else (1, 0)
        for i in order:
            streams[i].wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(streams[i]):
                graphs[i].replay()
        torch.cuda.synchronize()
        for i in order:
            np.testing.assert_allclose(
                outs[i].cpu().numpy(),
                attention_plain(*sets[i], causal=False).cpu().numpy(),
                rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.attention import flash_attention

    q, k, v = _qkv(1, 4, 2, 64, 64, 64, 0, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    q, k, v = _qkv(1, 4, 2, 64, 64, 48, 0, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, k, v)
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, 0, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, kv_len=65)
    # rows 66 floats apart: not 16-byte aligned
    padded = torch.zeros((2, 1, 2, 64, 66), device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, padded[0], padded[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n_kv_heads", [2, 1])
def test_lm_serving_on_the_card_matches_the_cpu(cuda_device, n_kv_heads):
    """The reduced qwen1.5-0.5b (float32) through prefill and 4 decode
    steps: K6 launched once per layer and step, logits and cache equal to
    the CPU's (plain attention) within rtol 1e-4 / atol 1e-5."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.smoke import lm_shrink
    from repro_torch.data import lm_token_batch
    from repro_torch.models import transformer as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(lm_shrink(get_arch("qwen1.5-0.5b").model_cfg),
                              n_kv_heads=n_kv_heads)
    card = lm.init_params(cfg, device=cuda_device)
    cpu = lm.init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = lm_token_batch(0, 3, 40, cfg.vocab)["tokens"]
    before = LAUNCHES["flash_attention"]
    c_card, l_card = lm.prefill_step(card, toks[:, :36], max_seq=40)
    c_cpu, l_cpu = lm.prefill_step(cpu, toks[:, :36], max_seq=40)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(l_card.cpu().numpy(), l_cpu.numpy(), **tol)
    for t in range(36, 40):
        l_card, c_card = lm.decode_step(card, c_card, toks[:, t])
        l_cpu, c_cpu = lm.decode_step(cpu, c_cpu, toks[:, t])
        np.testing.assert_allclose(l_card.cpu().numpy(), l_cpu.numpy(),
                                   **tol)
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers * 5
    np.testing.assert_allclose(c_card["k"].cpu().numpy(),
                               c_cpu["k"].numpy(), **tol)


def _push_inputs(n, e, n_dst, case, seed, device):
    """A K7 push into a state buffer of 4·n entries (the fluid of n nodes
    and three PIDs' outboxes): ``e`` messages over ``n_dst`` keys (none in
    the fluid for ``all_remote``), float64 values spread over eleven
    decades."""
    rng = np.random.default_rng(seed)
    lo = n if case == "all_remote" else 0
    key = rng.choice(np.arange(lo, 4 * n), n_dst, replace=False)[
        rng.integers(0, n_dst, e)].astype(np.int32)
    msg = rng.standard_normal(e) * 10.0 ** rng.uniform(-9, 2, e)
    state = rng.standard_normal(4 * n)
    return [torch.as_tensor(a, device=device) for a in (state, key, msg)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,n_dst,case", [
    (1, 1, 1, "mixed"), (64, 31, 7, "mixed"), (4096, 1000, 1000, "mixed"),
    (4096, 300_000, 300, "mixed"), (100_000, 262_144, 50_000, "mixed"),
    (4096, 20_000, 100, "all_remote"), (4096, 0, 1, "empty"),
])
def test_sim_push_kernel_matches_plain(cuda_device, n, e, n_dst, case):
    """K7 gives its plain version's bits (index_add_ on the CPU, which adds
    in message order, as np.add.at does), relaunched bit-identically; an
    empty push launches nothing."""
    from repro_torch.kernels.sim_push import sim_push, sim_push_plain

    state, key, msg = _push_inputs(n, e, n_dst, case, n + e, cuda_device)
    outs = []
    for _ in range(2):
        got = state.clone()
        before = LAUNCHES["sim_push"]
        sim_push(got, key, msg)
        assert LAUNCHES["sim_push"] == before + (e > 0)
        outs.append(got)
    torch.cuda.synchronize()
    want = state.cpu()
    sim_push_plain(want, key.cpu(), msg.cpu())
    for got in outs:
        assert torch.equal(got.cpu(), want)
    if case == "all_remote":  # the fluid (the first n entries) untouched
        assert torch.equal(outs[0][:n], state[:n])
    if case == "empty":
        assert torch.equal(want, state.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n_sel,k", [(1, 1), (0, 4), (37, 2), (600, 4),
                                     (1000, 8)])
def test_sim_messages_kernel_matches_plain(cuda_device, n_sel, k):
    """K7's messages (keys, values, |remote values|) are their plain
    version's, bit for bit, with nodes that have no out-edge among the
    selected; an empty selection launches nothing."""
    from repro_torch.kernels.sim_push import sim_messages, sim_messages_plain

    rng = np.random.default_rng(n_sel + k)
    p, _ = pagerank_system(power_law_graph(1000, seed=5))
    args = [torch.as_tensor(rng.choice(p.n, n_sel, replace=False)),
            torch.as_tensor(rng.integers(0, k, n_sel)),
            torch.as_tensor(rng.standard_normal(n_sel)),
            torch.as_tensor(np.diff(p.indptr)), torch.as_tensor(p.indptr),
            torch.as_tensor(p.indices.astype(np.int64)),
            torch.as_tensor(p.weights),
            torch.as_tensor(rng.integers(0, k, p.n).astype(np.int32))]
    n_e = int(args[3][args[0]].sum())
    want = sim_messages_plain(*args, n_e)
    before = LAUNCHES["sim_messages"]
    card = [a.to(cuda_device) for a in args]
    got = [sim_messages(*card, n_e) for _ in range(2)]
    torch.cuda.synchronize()
    assert LAUNCHES["sim_messages"] == before + 2 * (n_e > 0)
    for a, b, w in zip(got[0], got[1], want):
        assert torch.equal(a.cpu(), w) and torch.equal(a, b)


def _bucket_case(case, rng):
    """A push for K7's bucket design: ``(state, key, msg)`` as numpy
    arrays."""
    msg = None
    if case == "distinct":  # every key once: all settled in phase B
        state = rng.standard_normal(300_000)
        key = rng.permutation(300_000)[:200_000]
    elif case == "hub":  # one key given 10,000 messages: a long bucket
        state = rng.standard_normal(5000)
        key = rng.integers(0, 5000, 15_000)
        key[rng.permutation(15_000)[:10_000]] = 1234
    elif case == "above_2_24":  # keys past float32's exact integers
        state = rng.standard_normal(2**25 + 1000)
        key = 2**24 + rng.integers(0, 2**24 + 1000, 100_000)
        key[::7] = 2**25 + 999
    elif case == "random_1_4m":  # the largest push's size, keys repeated
        state = rng.standard_normal(2**21)
        key = rng.integers(0, 2**21, 1_406_169)
    elif case == "order":  # runs whose sum depends on the add order
        # each key's messages in order: 1e16, 1, -1e16, u, ...; added in
        # that order a key ends at its last u, added backwards at 0
        state = rng.standard_normal(4096)
        small = np.repeat(rng.permutation(4096)[:1000], 4)  # 4-message keys
        key = np.concatenate([small, np.full(300, 77)])  # and a long one
        key = key[rng.permutation(key.size)]  # the keys interleaved
        msg = np.empty(key.size)
        for d in np.unique(key):
            at = np.flatnonzero(key == d)
            run = np.tile([1e16, 1.0, -1e16, 0.0], at.size // 4)
            run[3::4] = rng.standard_normal(at.size // 4)
            msg[at] = run
    elif case == "long_buckets":  # merges of runs of every shape
        state = rng.standard_normal(100_000)
        lengths = [*range(6, 41), 63, 64, 65, 96, 127, 128, 129, 1000, 4097]
        hubs = rng.permutation(100_000)[:len(lengths)]
        key = np.concatenate([np.repeat(hubs, lengths),
                              rng.integers(0, 100_000, 50_000)])
        key = key[rng.permutation(key.size)]
    elif case == "one":
        state = rng.standard_normal(64)
        key = np.array([17])
    else:  # empty
        state = rng.standard_normal(64)
        key = np.zeros(0, np.int64)
    if msg is None:
        msg = rng.standard_normal(key.size) * 10.0 ** rng.uniform(
            -9, 2, key.size)
    return state, key.astype(np.int32), msg


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["distinct", "hub", "above_2_24",
                                  "random_1_4m", "order", "one", "empty",
                                  "long_buckets"])
def test_sim_push_buckets_match_plain(cuda_device, case):
    """K7's ordered buckets give the plain version's bits (np.add.at's) on
    every shape of push: distinct keys, a 10,000-message hub, keys above
    2**24, 1.4M random keys with repeats, sums that change with the add
    order, one message, none (no launch), and buckets of 6 to 4,097
    messages (merges of runs cut at every length).  Relaunched on a fresh copy the
    bits are the same, and every push leaves the counters all zero."""
    from repro_torch.kernels.sim_push import kernel as k7

    state, key, msg = _bucket_case(case, np.random.default_rng(11))
    want = torch.from_numpy(state.copy())
    k7.sim_push_plain(want, torch.from_numpy(key), torch.from_numpy(msg))
    if case == "order":  # the case can tell one add order from another
        other = state.copy()
        np.add.at(other, key[::-1], msg[::-1])
        assert not np.array_equal(other, want.numpy())
    card = [torch.as_tensor(a, device=cuda_device) for a in (state, key,
                                                              msg)]
    outs = []
    for _ in range(2):
        got = card[0].clone()
        before = LAUNCHES["sim_push"]
        k7.sim_push(got, card[1], card[2])
        assert LAUNCHES["sim_push"] == before + (key.size > 0)
        outs.append(got)
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got.cpu(), want)
    count = k7._workspace(card[0].device).get("count")
    assert key.size == 0 or not bool(count.any())


@pytest.mark.cuda
def test_sim_push_hub_of_a_million(cuda_device):
    """One key given 10**6 of 2·10**6 messages (a power-law hub): the
    plain version's bits, in m log m ordering work (merges of sorted
    runs), printed beside ``index_add_``'s time on the same push."""
    from repro_torch.kernels.sim_push import kernel as k7

    rng = np.random.default_rng(6)
    e, n = 2 * 10**6, 2 * 10**6
    key = rng.integers(0, n, e).astype(np.int32)
    key[rng.permutation(e)[:10**6]] = 4321
    msg = rng.standard_normal(e) * 10.0 ** rng.uniform(-9, 2, e)
    state = rng.standard_normal(n)
    want = torch.from_numpy(state.copy())
    k7.sim_push_plain(want, torch.from_numpy(key), torch.from_numpy(msg))
    card = [torch.as_tensor(a, device=cuda_device) for a in (state, key,
                                                              msg)]
    got = card[0].clone()
    k7.sim_push(got, card[1], card[2])
    assert torch.equal(got.cpu(), want)
    assert not bool(k7._workspace(got.device)["count"].any())
    times = {}
    for name, fn in (("sim_push", k7.sim_push), ("index_add_", lambda
                     st, k, m: st.index_add_(0, k, m))):
        fn(got, card[1], card[2])  # loads the kernel's module
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(3):
            fn(got, card[1], card[2])
        stop.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(stop) / 3
    print(f"hub of 10**6 messages: sim_push {times['sim_push']:.4f} ms, "
          f"index_add_ {times['index_add_']:.4f} ms")


@pytest.mark.cuda
def test_sim_push_on_two_streams_in_turn(cuda_device):
    """Pushes on two streams in turn share the device's one workspace: each
    stream waits for the other's pushes, so each state gets the plain
    version's bits and the counts stay zero."""
    from repro_torch.kernels.sim_push import kernel as k7

    rng = np.random.default_rng(8)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    wants, gots, pushes = [], [], []
    for i in range(4):
        state = rng.standard_normal(300_000)
        key = rng.integers(0, 300_000, 700_000).astype(np.int32)
        key[:3000] = 99  # and a long bucket
        msg = rng.standard_normal(key.size)
        want = torch.from_numpy(state.copy())
        k7.sim_push_plain(want, torch.from_numpy(key), torch.from_numpy(msg))
        wants.append(want)
        pushes.append([torch.as_tensor(a, device=cuda_device)
                       for a in (state, key, msg)])
    torch.cuda.synchronize()
    for i, (state, key, msg) in enumerate(pushes):
        with torch.cuda.stream(streams[i % 2]):
            k7.sim_push(state, key, msg)
    torch.cuda.synchronize()
    for (state, _, _), want in zip(pushes, wants):
        assert torch.equal(state.cpu(), want)
    assert not bool(k7._workspace(pushes[0][0].device)["count"].any())


@pytest.mark.cuda
def test_sim_push_twice_on_one_state(cuda_device):
    """Two pushes in a row into one state, the second with a bucket longer
    than a key's row: each leaves the counts all zero, and the state is the
    plain version's after both."""
    from repro_torch.kernels.sim_push import kernel as k7

    rng = np.random.default_rng(5)
    state = rng.standard_normal(50_000)
    pushes = [(rng.integers(0, 50_000, e).astype(np.int32),
               rng.standard_normal(e)) for e in (120_000, 80_000)]
    pushes[1][0][:500] = 42  # a long bucket in the second
    want = torch.from_numpy(state.copy())
    got = torch.as_tensor(state, device=cuda_device)
    for key, msg in pushes:
        k7.sim_push_plain(want, torch.from_numpy(key), torch.from_numpy(msg))
        k7.sim_push(got, torch.as_tensor(key, device=cuda_device),
                    torch.as_tensor(msg, device=cuda_device))
        torch.cuda.synchronize()
        assert not bool(k7._workspace(got.device)["count"].any())
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sim_push_on_states_of_other_sizes_in_turn(cuda_device):
    """Pushes into states of 3M, then 5,000, then 2M entries (the
    workspace's counts and rows reused at other sizes): each gives the
    plain version's bits and leaves the counts all zero."""
    from repro_torch.kernels.sim_push import kernel as k7

    rng = np.random.default_rng(17)
    for n in (3_000_000, 5000, 2_000_000):
        state = rng.standard_normal(n)
        key = rng.integers(0, n, 400_000).astype(np.int32)
        key[:50] = n - 1  # and a long bucket
        msg = rng.standard_normal(key.size)
        want = torch.from_numpy(state.copy())
        k7.sim_push_plain(want, torch.from_numpy(key), torch.from_numpy(msg))
        got = torch.as_tensor(state, device=cuda_device)
        k7.sim_push(got, torch.as_tensor(key, device=cuda_device),
                    torch.as_tensor(msg, device=cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert not bool(k7._workspace(got.device)["count"].any())


@pytest.mark.cuda
def test_sim_push_relaunch_is_bit_identical(cuda_device):
    """Ten launches of one push on fresh copies of one state give one set
    of bits: the integer atomics' order moves only where an index is
    stored."""
    from repro_torch.kernels.sim_push import sim_push

    rng = np.random.default_rng(9)
    state = torch.as_tensor(rng.standard_normal(200_000), device=cuda_device)
    key = torch.as_tensor(rng.integers(0, 20_000, 600_000).astype(np.int32),
                          device=cuda_device)
    key[:2000] = 7  # and one long bucket
    msg = torch.as_tensor(rng.standard_normal(600_000) * 10.0 ** rng.uniform(
        -9, 2, 600_000), device=cuda_device)
    first = None
    for _ in range(10):
        got = state.clone()
        sim_push(got, key, msg)
        if first is None:
            first = got
        assert torch.equal(got, first)


def _csr_args(deg, rng, k=4):
    """A CSR over ``deg.size`` nodes with out-degrees ``deg``, random
    destinations and weights, and a random owner map over ``k`` PIDs."""
    n = deg.size
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return [torch.as_tensor(deg.astype(np.int64)), torch.as_tensor(indptr),
            torch.as_tensor(rng.integers(0, n, indptr[-1])),
            torch.as_tensor(rng.random(indptr[-1])),
            torch.as_tensor(rng.integers(0, k, n).astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_degree", "max_degree", "nodes_1_5m"])
def test_sim_messages_expansion_matches_plain(cuda_device, case):
    """K7's load-balanced expansion gives the plain version's bits: a tile
    crowded with zero-degree nodes (more than it stages), one node at the
    graph's maximum out-degree (many tiles of one node), and 1.5M
    selected nodes."""
    from repro_torch.kernels.sim_push import sim_messages, sim_messages_plain

    rng = np.random.default_rng(3)
    if case == "zero_degree":
        deg = rng.integers(1, 4, 20_000)
        deg[5000:15_000] = 0
        sel = np.arange(20_000)
    elif case == "max_degree":
        deg = rng.integers(0, 6, 50_000)
        deg[123] = 300_000
        sel = np.sort(rng.choice(50_000, 2000, replace=False))
        sel[0] = 123
    else:
        deg = rng.integers(0, 3, 2_000_000)
        sel = np.sort(rng.choice(2_000_000, 1_500_000, replace=False))
    csr = _csr_args(deg, rng)
    args = [torch.as_tensor(sel), torch.as_tensor(rng.integers(0, 4,
                                                               sel.size)),
            torch.as_tensor(rng.standard_normal(sel.size)), *csr]
    n_e = int(deg[sel].sum())
    want = sim_messages_plain(*args, n_e)
    card = [a.to(cuda_device) for a in args]
    before = LAUNCHES["sim_messages"]
    got = [sim_messages(*card, n_e) for _ in range(2)]
    torch.cuda.synchronize()
    assert LAUNCHES["sim_messages"] == before + 2
    for a, b, w in zip(got[0], got[1], want):
        assert torch.equal(a.cpu(), w) and torch.equal(a, b)


def _sim_problem(mode):
    from repro_torch import Problem
    from repro_torch.core import host_block_graph

    g = (host_block_graph(4096, seed=0) if mode == "batch"
         else power_law_graph(300, seed=3))
    return Problem.pagerank(g)


def _sim_run(problem, mode, device):
    from repro_torch.core import DistributedSimulator, SimulatorConfig

    cfg = SimulatorConfig(k=8, target_error=problem.target_error,
                          eps=problem.eps, mode=mode, dynamic=True,
                          record_every=10, device=str(device))
    before = (LAUNCHES["sim_messages"], LAUNCHES["sim_push"])
    res = DistributedSimulator(problem.p, problem.b, cfg).run()
    return res, (LAUNCHES["sim_messages"] - before[0],
                 LAUNCHES["sim_push"] - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["batch", "sequential"])
def test_simulator_on_the_card_matches_the_cpu(cuda_device, mode):
    """The simulator on the card (each push on K7's two kernels, once
    each) against its run on the CPU (the plain versions): converged,
    |Δh|_1 <= 1e-10."""
    problem = _sim_problem(mode)
    card, launches = _sim_run(problem, mode, cuda_device)
    cpu, cpu_launches = _sim_run(problem, mode, "cpu")
    assert card.converged and cpu.converged
    assert launches == (card.n_pushes, card.n_pushes)
    assert card.n_pushes > 0 and cpu_launches == (0, 0)
    assert float((card.h.cpu() - cpu.h).abs().sum()) <= 1e-10


@pytest.mark.cuda
def test_simulator_replays_on_the_card(cuda_device):
    """Two card runs of the batch simulator: the same bits and counters."""
    problem = _sim_problem("batch")
    a, _ = _sim_run(problem, "batch", cuda_device)
    b, _ = _sim_run(problem, "batch", cuda_device)
    assert torch.equal(a.h, b.h)
    assert (a.n_steps, a.n_edge_ops, a.n_exchanges, a.move_log) == (
        b.n_steps, b.n_edge_ops, b.n_exchanges, b.move_log)
    assert np.array_equal(a.count_active, b.count_active)
