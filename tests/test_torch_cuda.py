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
K4 (fm_interaction) and its backward are held to 1e-5 of the magnitude
of their cancelling terms, K5 (segment_sum, contiguous and gather forms,
and the bf16-row form of the MoE combine) to rtol/atol 1e-5, and exactly
on integer-valued inputs, whose sums do not depend on the order (so is
the FM lookup's gradient, embedding_bwd); K5 as GIN's aggregation
backward, the FM lookup's gradient on normal inputs, and the combine's
backward's gate-weight gradient, against float64 sums
within 2⁻²⁴ times their terms' count and magnitudes (a power-law hub sums
thousands of terms).  K6's int8 decode form is
held to its plain version (dequantise, then attend) at K6's decode
tolerances, in bf16 to the bits of K6 over a dequantised copy, and its
dequantisation element for element.  K7 (sim_messages and sim_push, float64) is held bit-equal to
its plain versions, the sum adding in message order as the reference's
np.add.at does; the simulator on the card to its CPU run within
|Δh|_1 <= 1e-10.  K3's lane form (edge_sum_lanes) is held bit-equal to K3
launched on each lane's row, zero lanes to zero rows, and to its plain
version within rtol/atol 1e-5; batched solves on the card to their CPU
runs (|Δx|_1 <= 1e-6), the serving scheduler to its CPU run (equal edge
pushes, |Δx|_1 <= 2·target_error).  The threshold decay divides on the
card as numpy's float32 division does, so card and CPU solves push the
same edges.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro_torch.kernels.diffusion as td
from repro_torch.core import pagerank_system, power_law_graph
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.edge_sum import (csc_edges, edge_sum,
                                         edge_sum_lanes, edge_sum_lanes_plain)

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
    """The route rule (kernels/tune/model.py, the one source of it) is what
    the source runs: at the edges of the budget the bulk body launches
    with the bytes model.smem_bytes gives and gives the simt bits, a depth
    whose ring does not fit raises, and the CTAs an SM the launch gets
    (bulk_ctas_per_sm) are model.ctas_per_sm's, shape for shape."""
    from repro_torch.kernels.tune import model

    for bs in (4, 8, 64, 128, 256, 512, 1024):
        for c in (1, 2, 4, 5, 8, 20, 21):
            for depth in (1, 2, 3, 4, 6, 8):
                if model.route("frontier_round_bsr", bs, c, depth) != "bulk":
                    continue
                assert td.kernel.bulk_ctas_per_sm(
                    "frontier_round_bsr", bs, c, depth) == model.ctas_per_sm(
                        "frontier_round_bsr", bs, c, depth), (bs, c, depth)
    for bs, c, depth in ((128, 20, 1), (512, 4, 1), (1024, 1, 1),
                         (256, 1, 6), (64, 8, 8), (32, 1, 8)):
        assert td.frontier_round_bsr_route(bs, c, buffer_depth=depth) == "bulk"
        ins = _frontier_case(bs, c, seed=1, arming="mixed",
                             device=cuda_device)
        got = td.launch_frontier_round_bsr(*ins, buffer_depth=depth)
        simt = td.launch_frontier_round_bsr(*ins, route="simt")
        assert got[2] == "bulk"
        assert torch.equal(got[0], simt[0]) and torch.equal(got[1], simt[1])
    ins = _frontier_case(256, 1, seed=1, arming="mixed", device=cuda_device)
    assert td.frontier_round_bsr_route(256, 1, buffer_depth=8) is None
    with pytest.raises(ValueError, match="buffer_depth=8"):
        td.launch_frontier_round_bsr(*ins, buffer_depth=8)
    with pytest.raises(ValueError, match="buffer_depth=9"):
        td.frontier_round_bsr_kernel(*_frontier_case(
            8, 1, seed=1, arming="mixed", device=cuda_device),
            buffer_depth=9)


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
    """K2's route rule (kernels/tune/model.py) is what the source runs: at
    the edges of the budget the bulk body launches with model.smem_bytes
    and gives the simt bits, a ring that does not fit raises, the CTAs an
    SM are model.ctas_per_sm's, and a misaligned x takes the simt body."""
    from repro_torch.kernels.diffusion import kernel as k2
    from repro_torch.kernels.tune import model

    for bs in (4, 8, 64, 128, 256, 512, 1024):
        for c in (1, 3, 8, 16, 17, 40):
            for depth in (1, 2, 3, 4, 6, 8):
                if model.route("bsr_gather_spmm", bs, c, depth) != "bulk":
                    continue
                assert k2.bulk_ctas_per_sm(
                    "bsr_gather_spmm", bs, c, depth) == model.ctas_per_sm(
                        "bsr_gather_spmm", bs, c, depth), (bs, c, depth)
    for bs, c, depth in ((512, 16, 1), (512, 1, 6), (64, 8, 8),
                         (1024, 1, 1)):
        assert k2.bsr_spmm_route(bs, c, buffer_depth=depth) == "bulk"
        ins = _visit_case(bs, c, seed=2, device=cuda_device)
        got, route = k2.launch_bsr_spmm(*ins, buffer_depth=depth)
        assert route == "bulk"
        assert torch.equal(got, k2.launch_bsr_spmm(*ins, route="simt")[0])
    ins = _visit_case(512, 1, seed=2, device=cuda_device)
    assert k2.bsr_spmm_route(512, 1, buffer_depth=8) is None
    with pytest.raises(ValueError, match="buffer_depth=8"):
        k2.launch_bsr_spmm(*ins, buffer_depth=8)
    pool, vb, vc, ptr, x = _visit_case(128, 1, seed=1, device=cuda_device)
    x_off = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    x_off.copy_(x)
    got, route = k2.launch_bsr_spmm(pool, vb, vc, ptr, x_off)
    assert route == "simt"
    assert torch.equal(got, k2.launch_bsr_spmm(pool, vb, vc, ptr, x)[0])
    with pytest.raises(ValueError, match="buffer_depth=2"):
        k2.launch_bsr_spmm(pool, vb, vc, ptr, x_off, buffer_depth=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["frontier_round_bsr", "bsr_gather_spmm"])
def test_sweep_on_the_card_times_every_feasible_depth(cuda_device, kernel,
                                                      tmp_path, monkeypatch):
    """run_sweep on the card: every feasible (bs, depth) timed by CUDA
    events on the kernel itself, no infeasible one, each row's shared
    memory and CTAs an SM the model's; the record reads back, and its
    launches are counted nowhere."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.tune import model

    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path))
    tune.clear_cache()
    before = (dict(LAUNCHES), dict(td.ROUTES), dict(td.FRONTIER_ROUTES))
    rec = tune.run_sweep(kernel, n=8192, bs_list=(32, 64, 256),
                         depths=(1, 2, 8), iters=2, verbose=False,
                         device="cuda")
    assert (dict(LAUNCHES), dict(td.ROUTES), dict(td.FRONTIER_ROUTES)) == \
        before
    assert rec["timing_path"] == "cuda" and rec["platform"] == "cuda"
    assert rec["device_kind"] == torch.cuda.get_device_name()
    for r in rec["sweep"]:
        fits = model.route(kernel, r["bs"], 1, r["buffer_depth"])
        assert r["feasible"] == (fits is not None) and r["route"] == fits
        assert (r["measured_us"] is not None) == r["feasible"]
        assert r["smem_bytes"] == model.smem_bytes(kernel, r["bs"], 1,
                                                   r["buffer_depth"])
        if fits:
            assert r["measured_us"] > 0
            assert r["ctas_per_sm"] == td.bulk_ctas_per_sm(
                kernel, r["bs"], 1, r["buffer_depth"])
    assert not rec["sweep"][-1]["feasible"]  # bs=256 at depth 8
    best = tune.best_config(kernel, "cuda")
    assert (best.bs, best.buffer_depth) == (rec["best"]["bs"],
                                            rec["best"]["buffer_depth"])
    tune.clear_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("bs", [4, 8, 64, 128, 256])
def test_frontier_round_depths_give_the_depth1_bits(cuda_device, bs, c,
                                                    depth):
    """K1's ring depth changes how far the producer runs ahead, never the
    order of a sum: every depth whose ring fits gives the bits of depth 1
    and of the simt body, on the 40-tile row case, counted by depth; a
    depth whose ring does not fit raises."""
    ins = _frontier_case(bs, c, seed=7 * bs + c, arming="mixed",
                         device=cuda_device)
    if td.frontier_round_bsr_route(bs, c, buffer_depth=depth) is None:
        with pytest.raises(ValueError, match=f"buffer_depth={depth}"):
            td.frontier_round_bsr_kernel(*ins, buffer_depth=depth)
        return
    base = td.launch_frontier_round_bsr(*ins)
    simt = td.launch_frontier_round_bsr(*ins, route="simt")
    before = (LAUNCHES["frontier_round_bsr"],
              dict(td.FRONTIER_DEPTHS))
    got = td.frontier_round_bsr_kernel(*ins, buffer_depth=depth)
    torch.cuda.synchronize()
    for a in (base, simt):
        assert torch.equal(got[0], a[0]) and torch.equal(got[1], a[1])
    assert LAUNCHES["frontier_round_bsr"] == before[0] + 1
    assert td.FRONTIER_DEPTHS[depth] == before[1].get(depth, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("bs", [4, 8, 64, 128, 512])
def test_bsr_spmm_depths_give_the_depth1_bits(cuda_device, bs, c, depth):
    """K2 likewise: every depth whose ring fits gives the bits of depth 1
    and of the simt body on the 40-visit row case, counted by depth; a
    depth whose ring does not fit raises."""
    ins = _visit_case(bs, c, seed=5 * bs + c, device=cuda_device)
    if td.bsr_spmm_route(bs, c, buffer_depth=depth) is None:
        with pytest.raises(ValueError, match=f"buffer_depth={depth}"):
            td.bsr_spmm_kernel(*ins, buffer_depth=depth)
        return
    base = td.launch_bsr_spmm(*ins)[0]
    simt = td.launch_bsr_spmm(*ins, route="simt")[0]
    before = (LAUNCHES["bsr_spmm"], dict(td.DEPTHS))
    got = td.bsr_spmm_kernel(*ins, buffer_depth=depth)
    torch.cuda.synchronize()
    assert torch.equal(got, base) and torch.equal(got, simt)
    assert LAUNCHES["bsr_spmm"] == before[0] + 1
    assert td.DEPTHS[depth] == before[1].get(depth, 0) + 1


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


def _lane_inputs(c, seed, n=5000, n_edges=60000):
    """Random edges with an empty upper half of destinations and one hub
    destination (node 7, a fifth of the edges), and ``[C, n]`` fluid
    whose every third lane is zero."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n // 2, n_edges)
    dst[: n_edges // 5] = 7
    wgt = rng.random(n_edges)
    x = rng.standard_normal((c, n)).astype(np.float32)
    x[2::3] = 0.0
    return src, dst, wgt, x, n


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3, 8, 16, 64])
def test_edge_sum_lanes_kernel_matches_plain(cuda_device, c):
    src, dst, wgt, x, n = _lane_inputs(c, seed=c)
    e_d = csc_edges(src, dst, wgt, n, cuda_device)
    x_d = torch.from_numpy(x).to(cuda_device)
    before = dict(LAUNCHES)
    got = edge_sum_lanes(x_d, e_d)
    again = edge_sum_lanes(x_d, e_d)
    torch.cuda.synchronize()
    assert LAUNCHES["edge_sum_lanes"] == before["edge_sum_lanes"] + 2
    assert LAUNCHES["edge_sum"] == before["edge_sum"]
    assert got.shape == (c, n) and torch.equal(got, again)
    assert bool((got[:, n // 2:] == 0).all())  # empty destinations
    assert bool((got[2::3] == 0).all())  # zero lanes give zero rows
    for lane in range(c):  # each lane is K3 launched on its row
        assert torch.equal(got[lane], edge_sum(x_d[lane].contiguous(), e_d))
    plain = edge_sum_lanes_plain(x_d, e_d.indptr, e_d.src, e_d.wgt)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    cpu = edge_sum_lanes(torch.from_numpy(x),
                         csc_edges(src, dst, wgt, n, "cpu"))
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_edge_sum_lanes_on_two_streams_in_turn(cuda_device):
    """Launches alternating between two streams give the default
    stream's bits: the wrapper launches on the current stream."""
    src, dst, wgt, x, n = _lane_inputs(5, seed=11)
    e_d = csc_edges(src, dst, wgt, n, cuda_device)
    x_d = torch.from_numpy(x).to(cuda_device)
    want = edge_sum_lanes(x_d, e_d)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for i in range(6):
        st = streams[i % 2]
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(edge_sum_lanes(x_d, e_d))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_edge_sum_lanes_refuses_bad_operands(cuda_device):
    src, dst, wgt, x, n = _lane_inputs(2, seed=3)
    e_d = csc_edges(src, dst, wgt, n, cuda_device)
    x_d = torch.from_numpy(x).to(cuda_device)
    with pytest.raises(ValueError, match="expected"):
        edge_sum_lanes(x_d[:, :-1].contiguous(), e_d)
    with pytest.raises(ValueError, match="contiguous"):
        edge_sum_lanes(x_d.T.contiguous().T, e_d)
    with pytest.raises(ValueError, match="expected"):
        edge_sum_lanes(x_d.double(), e_d)


def _check_lanes(x_d, e_d):
    """K3's lane form on ``x_d``: every lane the bits of K3 launched on its
    row, a relaunch the same bits, a zero lane a zero row, and the plain
    version within rtol/atol 1e-5.  Returns the result."""
    before = LAUNCHES["edge_sum_lanes"]
    got = edge_sum_lanes(x_d, e_d)
    again = edge_sum_lanes(x_d, e_d)
    torch.cuda.synchronize()
    assert LAUNCHES["edge_sum_lanes"] == before + 2
    assert got.shape == (x_d.shape[0], e_d.n) and torch.equal(got, again)
    for lane in range(x_d.shape[0]):
        row = x_d[lane].contiguous()
        assert torch.equal(got[lane], edge_sum(row, e_d))
        if not bool(row.any()):
            assert bool((got[lane] == 0).all())
    plain = edge_sum_lanes_plain(x_d, e_d.indptr, e_d.src, e_d.wgt)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    return got


def _lane_fluid(rng, c, n):
    """``[C, n]`` float32 fluid on the card, every third lane zero."""
    x = rng.standard_normal((c, n)).astype(np.float32)
    x[2::3] = 0.0
    return torch.from_numpy(x).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 5, 17, 32, 70])
def test_edge_sum_lanes_ragged_and_wide_lane_groups(cuda_device, c):
    """Lane counts that fill four-lane groups, leave one ragged, take
    several groups a destination, or more lanes than a block holds."""
    src, dst, wgt, x, n = _lane_inputs(c, seed=100 + c)
    _check_lanes(torch.from_numpy(x).to(cuda_device),
                 csc_edges(src, dst, wgt, n, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 16])
def test_edge_sum_lanes_hub_spans_many_chunks(cuda_device, c):
    """One destination with 10**5 in-edges, far more than a block stages
    at once, beside ordinary ones."""
    rng = np.random.default_rng(21)
    n, hub = 3000, 1234
    src = rng.integers(0, n, 120_000)
    dst = rng.integers(0, n, 120_000)
    dst[:100_000] = hub
    wgt = rng.random(120_000)
    e_d = csc_edges(src, dst, wgt, n, cuda_device)
    assert int(e_d.indptr[hub + 1] - e_d.indptr[hub]) >= 100_000
    _check_lanes(_lane_fluid(rng, c, n), e_d)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 16])
def test_edge_sum_lanes_empty_tiles(cuda_device, c):
    """Whole tiles of destinations with no in-edge, between and after
    tiles that have some, and a graph with no edge at all."""
    rng = np.random.default_rng(22)
    n = 4096
    dst = np.concatenate([rng.integers(0, 200, 3000),
                          rng.integers(2500, 2600, 3000)])
    src = rng.integers(0, n, dst.size)
    wgt = rng.random(dst.size)
    got = _check_lanes(_lane_fluid(rng, c, n),
                       csc_edges(src, dst, wgt, n, cuda_device))
    assert bool((got[:, 200:2500] == 0).all())
    assert bool((got[:, 2600:] == 0).all())
    none = csc_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0), n, cuda_device)
    assert bool((_check_lanes(_lane_fluid(rng, c, n), none) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 5, 16, 17, 64])
@pytest.mark.parametrize("n", [1, 37, 1013])
def test_edge_sum_lanes_ragged_last_tile(cuda_device, c, n):
    """Destination counts that are no multiple of any tile width."""
    rng = np.random.default_rng(n * 100 + c)
    m = 12 * n
    _check_lanes(_lane_fluid(rng, c, n), csc_edges(
        rng.integers(0, n, m), rng.integers(0, n, m), rng.random(m), n,
        cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n_src,n", [(700, 1300), (2000, 500)])
@pytest.mark.parametrize("c", [3, 16])
def test_edge_sum_lanes_x_len_differs_from_n(cuda_device, n_src, n, c):
    """Sources and destinations in two spaces (the engine's table):
    ``x [C, n_src]`` -> ``[C, n]``."""
    import dataclasses

    rng = np.random.default_rng(n_src + n + c)
    m = 10 * n
    e_d = dataclasses.replace(csc_edges(
        rng.integers(0, n_src, m), rng.integers(0, n, m), rng.random(m), n,
        cuda_device), n_src=n_src)
    assert e_d.x_len == n_src
    _check_lanes(_lane_fluid(rng, c, n_src), e_d)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 16])
def test_edge_sum_lanes_permuted_node_order(cuda_device, c):
    """A host-ordered graph under a random node permutation: every
    gather lands far from its destination."""
    from repro_torch.core import host_block_graph

    g = host_block_graph(8192, seed=3)
    perm = np.random.default_rng(23).permutation(g.n)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    rng = np.random.default_rng(24)
    _check_lanes(_lane_fluid(rng, c, g.n), csc_edges(
        perm[src], perm[g.indices], g.weights, g.n, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["threshold_decay", "frontier_step"])
@pytest.mark.parametrize("gamma", [1.2, 1.5, 2.0, 10 / 9])
def test_threshold_decay_on_the_card_divides_as_the_reference(cuda_device,
                                                              gamma, path):
    """``t / γ`` on the card, by the helper and by a frontier round that
    selects nothing (zero fluid, so every threshold decays), equals
    numpy's float32 division, as the reference's ``t / gamma`` divides."""
    from repro_torch.core.diteration import frontier_step

    rng = np.random.default_rng(int(gamma * 1000))
    n = 100_000
    t = (rng.random(n) * 10.0 ** rng.uniform(-12, 2, n)).astype(np.float32)
    want = t / np.float32(gamma)
    t_d = torch.from_numpy(t).to(cuda_device)
    if path == "threshold_decay":
        from repro_torch.core.diteration import threshold_decay

        got = threshold_decay(t_d, torch.tensor(gamma, dtype=torch.float32,
                                                device=cuda_device))
    else:
        none = csc_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros(0), n, cuda_device)
        zeros = torch.zeros(n, device=cuda_device)
        _f, _h, got, _ops = frontier_step(
            zeros, zeros, t_d, none, torch.ones(n, device=cuda_device),
            torch.zeros(n, dtype=torch.int64, device=cuda_device),
            torch.zeros(n, dtype=torch.bool, device=cuda_device),
            torch.tensor(gamma, dtype=torch.float32, device=cuda_device))
    got = got.cpu().numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
def test_solve_batch_on_the_card_matches_the_cpu(cuda_device):
    """Batched solves on the card: the CPU run's op counts per column and
    rounds, x within 1e-6, pad / no-pad bit parity, and one lane-form
    launch a batched round."""
    import repro_torch

    problem = repro_torch.Problem.pagerank(
        repro_torch.core.host_block_graph(8192, seed=2))
    rng = np.random.default_rng(4)
    bs = np.abs(problem.b[:, None]
                * (1.0 + 0.05 * rng.standard_normal((problem.n, 3))))
    before = LAUNCHES["edge_sum_lanes"]
    card = repro_torch.SolverSession(problem).solve_batch(bs)
    lanes = LAUNCHES["edge_sum_lanes"] - before
    raw = repro_torch.SolverSession(problem).solve_batch(bs, pad=False)
    cpu = repro_torch.SolverSession(problem, device="cpu").solve_batch(bs)
    assert card.converged and cpu.converged
    assert lanes == card.n_rounds
    assert np.array_equal(card.x, raw.x)
    assert card.extras["ops_per_column"] == raw.extras["ops_per_column"]
    assert card.extras["ops_per_column"] == cpu.extras["ops_per_column"]
    assert card.n_rounds == cpu.n_rounds
    assert np.abs(card.x - cpu.x).sum() <= 1e-6


@pytest.mark.cuda
def test_scheduler_on_the_card_matches_the_cpu(cuda_device):
    """The continuous-batching scheduler, one graph update midway, on the
    card and on the CPU: the same requests served in the same order with
    the same pool hits, each one's edge pushes equal (the threshold decay
    divides on both devices alike) and |Δx|_1 <= 2·target_error."""
    import repro_torch
    from repro_torch.graph import rotation_churn
    from repro_torch.serving import Scheduler

    runs = []
    for dev in ("cuda", "cpu"):
        problem = repro_torch.Problem.pagerank(
            repro_torch.core.webgraph_like(3000, seed=1))
        sch = Scheduler(problem, max_lanes=4, rounds_per_tick=16,
                        deadline_s=1e9, device=dev)
        rng = np.random.default_rng(0)
        b = problem.b
        for i in range(8):
            if i == 4:
                sch.run_until_idle()
                sch.submit_update(rotation_churn(sch.problem.graph, 10,
                                                 seed=3))
            b = np.abs(b * (1.0 + 0.02 * rng.standard_normal(problem.n)))
            sch.submit(b, cluster=i % 3, request_id=i)
        sch.run_until_idle()
        assert sch.applied_updates == 1 and sch.dropped == 0
        runs.append(sch.results)
        te = problem.target_error
    card, cpu = runs
    assert [r.request_id for r in card] == [r.request_id for r in cpu]
    for a, b in zip(card, cpu):
        assert a.converged and a.pool_hit == b.pool_hit
        assert a.ops == b.ops
        # two converged schedules: within 2·target_error, the bound of
        # the reference's scheduler parity test
        assert np.abs(a.x - b.x).sum() <= 2.0 * te


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
    assert card.cost_iterations == cpu.cost_iterations
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


@contextlib.contextmanager
def _empty_is_nan():
    """torch.empty fills what it hands out with NaN (PyTorch's deterministic
    mode), so that a kernel that reads scratch or output it never wrote
    reads NaN, which no comparison lets pass."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


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
        CHUNK_ROWS, segment_sum_kernel, segment_sum_ref)

    rng = np.random.default_rng(11)
    seg, n = _long_segment_case(rng, CHUNK_ROWS)
    e = seg.size
    seg_t = torch.from_numpy(seg).to(cuda_device)
    firsts = seg[::CHUNK_ROWS]  # each chunk's first id
    assert (firsts == 1).sum() >= 100  # segment 1 spans many chunks
    # segments 2..21 are empty, and a chunk begins where they sit
    ptr = np.searchsorted(seg, np.arange(n + 1))
    assert ptr[2] == ptr[22] and ptr[2] % CHUNK_ROWS == 0
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
        with _empty_is_nan():
            got, again = (segment_sum_kernel(data, seg_t, n, w, rows)
                          for _ in range(2))
        torch.cuda.synchronize()
        assert LAUNCHES["segment_sum"] == before["segment_sum"] + 2
        assert LAUNCHES["segment_sum_carry"] == before["segment_sum_carry"] + 2
        assert torch.equal(got, again)
        # int64 ids take the same plan
        assert torch.equal(got, segment_sum_kernel(data, seg_t.long(), n, w,
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


def _combine_case(rng, t, k, e_pad, cap, d):
    """The MoE combine's operands: ``k`` slots a token over expert outputs
    ``[e_pad·cap, d]`` in bf16, rows ``e·cap + pos``, gate weights with
    the dropped slots at 0 and every slot of token 3 dropped."""
    eo = torch.from_numpy(rng.standard_normal((e_pad * cap, d)).astype(
        np.float32)).to(torch.bfloat16)
    rows = torch.from_numpy(rng.integers(0, e_pad * cap, t * k))
    w = torch.from_numpy(rng.random(t * k).astype(np.float32))
    w[rng.random(t * k) < 0.2] = 0.0
    w[3 * k:4 * k] = 0.0
    seg = torch.arange(t, dtype=torch.int32).repeat_interleave(k)
    return eo, seg, w, rows


@pytest.mark.cuda
@pytest.mark.parametrize("t,k,d", [(8, 4, 2048), (3000, 4, 64),
                                   (700, 8, 130), (50, 2, 2), (9, 1, 12)])
def test_segment_sum_bf16_rows_match_plain(cuda_device, t, k, d):
    """K5's bf16-row form (the MoE combine) against its plain version, which
    sums the rows in float32 too: within rtol / atol 1e-5 (float32 sums in
    another order), float32 out, a token whose weights are all zero a zero
    row, a relaunch bit-identical, and a launch counted under
    ``segment_sum_bf16``; D = 2,048 reads 16 bytes a lane, 130 and 2 four,
    12 eight, and 3,000 x 4 rows cross chunks."""
    from repro_torch.kernels.segment import segment_sum_ref, segment_sum_sorted

    rng = np.random.default_rng(t + d)
    eo, seg, w, rows = _combine_case(rng, t, k, 64, 5, d)
    dev = [x.to(cuda_device) for x in (eo, seg, w, rows)]
    before = dict(LAUNCHES)
    got = segment_sum_sorted(dev[0], dev[1], t, weights=dev[2], rows=dev[3])
    again = segment_sum_sorted(dev[0], dev[1], t, weights=dev[2],
                               rows=dev[3])
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum_bf16"] - before["segment_sum_bf16"] == 2
    assert LAUNCHES["segment_sum"] == before["segment_sum"]
    assert got.dtype == torch.float32 and got.shape == (t, d)
    assert torch.equal(got, again)
    assert bool((got[3] == 0).all())
    plain = segment_sum_ref(eo, seg, t, w, rows)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def _plan_case(kind, rng, chunk):
    """Sorted ids (numpy int32, or int64 for "int64_ids") and n for one of
    the layouts that decide K5's plan on the card."""
    if kind == "decode":  # A's decode combine: 8 tokens x 4 slots
        return np.repeat(np.arange(8), 4).astype(np.int32), 8
    if kind == "one_short_chunk":  # fewer rows than a chunk, uneven runs
        lengths = rng.integers(0, 9, 150)
        return np.repeat(np.arange(150), lengths).astype(np.int32), 150
    if kind == "many_chunks":  # a segment over 9.5 chunks, others around it
        lengths = np.concatenate([rng.integers(0, 30, 40), [9 * chunk +
                                  chunk // 2], rng.integers(0, 30, 40)])
        return np.repeat(np.arange(81), lengths).astype(np.int32), 81
    if kind in ("boundary_next", "boundary_far"):
        # whole chunks of short segments, then one of more than a chunk
        # from a chunk's first row: it ends in the chunk after the one it
        # starts (next), or five chunks on (far)
        k0, length = ((1, chunk + 500) if kind == "boundary_next"
                      else (3, 5 * chunk + 9))
        tail = np.repeat(np.arange(11, 30), rng.integers(0, 40, 19))
        return np.concatenate([np.sort(rng.integers(0, 10, k0 * chunk)),
                               np.full(length, 10), tail]).astype(
            np.int32), 30
    if kind == "int64_ids":  # chunk-crossing runs, ids as int64
        lengths = rng.integers(0, 1500, 12)
        return np.repeat(np.arange(12), lengths).astype(np.int64), 12
    if kind == "out_of_range":  # a chunk and more of -1 first, 2**30 last
        mid = np.sort(rng.integers(0, 60, 2 * chunk + 5))
        return np.concatenate([np.full(chunk + 9, -1), mid, np.full(
            chunk + 40, 2**30)]).astype(np.int32), 60
    # empty_ends: empty segments before the first row and after the last
    lengths = rng.integers(0, 400, 30)
    lengths[:5] = 0
    lengths[-6:] = 0
    return np.repeat(np.arange(30), lengths).astype(np.int32), 30


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["contiguous", "gather", "bf16_rows"])
@pytest.mark.parametrize("kind", ["decode", "one_short_chunk", "many_chunks",
                                  "boundary_next", "boundary_far",
                                  "int64_ids", "out_of_range",
                                  "empty_ends"])
def test_segment_sum_kernel_plans_its_own_work(cuda_device, kind, form):
    """K5 finds each chunk's first segment and a carried segment's first
    chunk from the ids alone: at A's decode combine (8 tokens x 4 slots,
    D 2,048, dropped slots weighted 0), in one short chunk, across a
    segment of many chunks, across segments of more than a chunk that
    start on a chunk's first row (their carries begin in that chunk), from
    int64 ids, past leading -1 and trailing 2**30 ids, and with empty
    leading and trailing segments; in the contiguous, gather and bf16-row
    forms, a relaunch bit-identical, the carry pass launched exactly when
    there is more than one chunk.  ``torch.empty`` hands out NaN, so a
    carry or an output row the kernel reads without writing it fails the
    comparisons.  Random
    rows are held to the plain version within relative L1 1e-5 (sums of
    thousands of float32 terms, taken in another order); integer-valued
    rows and weights, whose sums are exact in any order, bit for bit."""
    from repro_torch.kernels.segment import (
        CHUNK_ROWS, segment_sum_ref, segment_sum_sorted)

    rng = np.random.default_rng(len(kind) * 7 + len(form))
    seg, n = _plan_case(kind, rng, CHUNK_ROWS)
    e = seg.size
    d = 2048 if kind == "decode" else 64
    n_data = e if form == "contiguous" else 320
    drop = rng.random(e) < 0.3
    rows = None
    if form != "contiguous":  # rows e·cap + pos, a dropped slot's row 0
        rows = torch.from_numpy(np.where(drop, 0, rng.integers(0, 320, e)))
    dt = torch.bfloat16 if form == "bf16_rows" else torch.float32
    name = "segment_sum_bf16" if form == "bf16_rows" else "segment_sum"
    seg_t = torch.from_numpy(seg)
    chunks = -(-e // CHUNK_ROWS)
    for exact in (False, True):
        if exact:  # integers, exact in bf16 and in any sum order
            data = rng.integers(-8, 8, (n_data, d)).astype(np.float32)
            w = np.where(drop, 0, rng.integers(1, 3, e)).astype(np.float32)
        else:
            data = rng.standard_normal((n_data, d)).astype(np.float32)
            w = np.where(drop, 0, rng.random(e)).astype(np.float32)
        data = torch.from_numpy(data).to(dt)
        args = [seg_t, torch.from_numpy(w), rows]
        dev = [None if t is None else t.to(cuda_device) for t in args]
        before = dict(LAUNCHES)
        with _empty_is_nan():
            got, again = (segment_sum_sorted(data.to(cuda_device), dev[0], n,
                                             weights=dev[1], rows=dev[2])
                          for _ in range(2))
        torch.cuda.synchronize()
        assert LAUNCHES[name] - before[name] == 2
        assert (LAUNCHES["segment_sum_carry"] - before["segment_sum_carry"]
                == (2 if chunks > 1 else 0))
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert torch.equal(got, again)
        plain = segment_sum_ref(data, seg_t, n, args[1], rows)
        if exact:
            assert torch.equal(got.cpu(), plain)
        else:
            rel = float((got.cpu().double() - plain.double()).abs().sum()
                        / plain.double().abs().sum())
            assert rel <= 1e-5
        empty = np.setdiff1d(np.arange(n), seg)
        assert bool((got[torch.from_numpy(empty).to(cuda_device)] == 0)
                    .all())


@pytest.mark.cuda
@pytest.mark.parametrize("bag", [2048, 1536])
def test_embedding_bag_of_long_bags_on_the_card(cuda_device, bag):
    """Bags of 2,048 rows start on every other chunk's first row, and each
    bag after the first is a carried segment that began in the chunk
    before its last: K5 must sum each bag whole, exactly on integers, with
    ``torch.empty`` handing out NaN; bags of 1,536 rows start mid-chunk
    too."""
    from repro_torch.kernels.segment import embedding_bag, embedding_bag_ref

    rng = np.random.default_rng(bag)
    b = 6
    table = torch.from_numpy(rng.integers(-8, 8, (5000, 64)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 5000, (b, bag)))
    w = torch.from_numpy(rng.integers(0, 3, (b, bag)).astype(np.float32))
    args = [t.to(cuda_device) for t in (table, ids, w)]
    before = dict(LAUNCHES)
    with _empty_is_nan():
        got = [embedding_bag(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum"] - before["segment_sum"] == 2
    assert LAUNCHES["segment_sum_carry"] - before["segment_sum_carry"] == 2
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0].cpu(), embedding_bag_ref(table, ids, w))


@pytest.mark.cuda
def test_segment_sum_bf16_rows_refuse_an_odd_width(cuda_device):
    from repro_torch.kernels.segment import segment_sum_kernel

    data = torch.zeros((10, 7), dtype=torch.bfloat16, device=cuda_device)
    seg = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="even D"):
        segment_sum_kernel(data, seg, 2, rows=seg.long())


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_attention_int8_decode_matches_plain(cuda_device, sq, group, dh,
                                                   dtype):
    """K6's int8 decode form over an int8 ``[B, Smax, Hkv, Dh]`` cache and
    its ``[B, Smax, Hkv]`` scales (quantised from a random float cache by
    the model's ``quantize_kv``), through the model's transposed views, at
    ragged kv_len: equal to the plain version (dequantise, then attend)
    within rtol 1e-5 / atol 1e-6 in float32 and 3e-2 in bf16, bit-identical
    on relaunch and with the cache and scales past kv_len poisoned (NaN
    scales); one launch a call under ``flash_attention_int8``, with the
    split count the policy gives for the form's geometry.  Where that
    geometry is the T form's, the bits are K6's decode over a dequantised
    copy."""
    from repro_torch.kernels.attention import (
        attention_plain, dequantize, flash_attention)
    from repro_torch.kernels.attention.kernel import (
        SPLITS, decode_geometry, split_count)
    from repro_torch.models.transformer import quantize_kv

    dt = getattr(torch, dtype)
    b, hkv, smax = 2, 2, 4224
    hq = hkv * group
    rng = np.random.default_rng(1000 * sq + 10 * group + dh + 7)
    cache = torch.from_numpy(rng.standard_normal(
        (2, b, smax, hkv, dh)).astype(np.float32)).to(cuda_device, dt)
    c8, scales = quantize_kv(cache)
    q = torch.from_numpy(rng.standard_normal(
        (b, sq, hq, dh)).astype(np.float32) * 0.2).to(cuda_device,
                                                      dt).transpose(1, 2)
    k, v = c8[0].transpose(1, 2), c8[1].transpose(1, 2)
    ks, vs = scales[0].transpose(1, 2), scales[1].transpose(1, 2)
    kd, vd = dequantize(k, ks, dt), dequantize(v, vs, dt)
    tol = dict(rtol=1e-5, atol=1e-6) if dt == torch.float32 else dict(
        rtol=3e-2, atol=3e-2)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    geometry = decode_geometry(dt, dh, True)
    same_geometry = geometry == decode_geometry(dt, dh)
    for kv_len in (1, 63, 129, 4095, 4224):
        n_split = split_count(b, hq, hkv, sq, kv_len, n_sm, geometry)
        pc8, psc = c8.clone(), scales.clone()
        pc8[:, :, kv_len:] = 127
        psc[:, :, kv_len:] = float("nan")
        before = dict(LAUNCHES)
        splits_before = SPLITS["flash_attention_int8"]
        kw = dict(causal=False, kv_len=kv_len)
        got = flash_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
        again = flash_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
        tail = flash_attention(q, pc8[0].transpose(1, 2),
                               pc8[1].transpose(1, 2),
                               k_scale=psc[0].transpose(1, 2),
                               v_scale=psc[1].transpose(1, 2), **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention_int8"] - before[
            "flash_attention_int8"] == 3
        assert LAUNCHES["flash_attention"] == before["flash_attention"]
        assert SPLITS["flash_attention_int8"] - splits_before == 3 * n_split
        assert torch.equal(got, again) and torch.equal(got, tail)
        np.testing.assert_allclose(
            got.float().cpu().numpy(),
            attention_plain(q, k, v, k_scale=ks, v_scale=vs, **kw)
            .float().cpu().numpy(), **tol)
        if same_geometry:
            assert torch.equal(got, flash_attention(q, kd, vd, **kw))


@pytest.mark.cuda
def test_flash_attention_int8_refuses_prefill_and_bad_scales(cuda_device):
    from repro_torch.kernels.attention import flash_attention

    q = torch.zeros((1, 2, 65, 64), device=cuda_device)
    k = torch.zeros((1, 2, 100, 64), dtype=torch.int8, device=cuda_device)
    sc = torch.ones((1, 2, 100), device=cuda_device)
    with pytest.raises(ValueError, match="decode form"):
        flash_attention(q, k, k, causal=True, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="k_scale"):
        flash_attention(q[:, :, :1], k, k, k_scale=sc[:, :, :99],
                        v_scale=sc)
    with pytest.raises(ValueError, match="int8"):
        flash_attention(q[:, :, :1], k.float(), k.float(), k_scale=sc,
                        v_scale=sc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 128])
def test_flash_attention_int8_dequantises_each_element_exactly(cuda_device,
                                                               dh, dtype):
    """One key in one tile (kv_len 1: its softmax weight is exactly 1), so
    the output is the kernel's dequantised v itself: every int8 value from
    -128 to 127 (±127 in every row), under scales from the smallest to the
    largest ``quantize_kv`` gives (a zero row's and a row at the dtype's
    largest finite value's), must come out as ``v.float() · scale``
    rounded to q's dtype, element for element."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.models.transformer import quantize_kv

    dt = getattr(torch, dtype)
    b, hkv, smax = 2, 8, 64
    rng = np.random.default_rng(dh)
    big = float(torch.finfo(dt).max)
    rows = torch.zeros((b * hkv, dh), dtype=dt)
    rows[1, 0] = big  # the largest scale; row 0 the smallest
    rows[2:] = torch.from_numpy(rng.standard_normal((b * hkv - 2, dh)) * 10.0
                                ** rng.uniform(-6, 4, (b * hkv - 2, 1))).to(dt)
    _, sc = quantize_kv(rows)
    assert float(sc[0]) < 1e-7 and float(sc[1]) > 1e36
    v = np.arange(b * hkv * dh) % 256 - 128  # every int8 value
    v = v.reshape(b * hkv, dh)
    v[:, :2] = (127, -127)
    v[1] = np.clip(v[1], -127, 127)  # 128 x the largest scale overflows
    cache = torch.zeros((b, smax, hkv, dh), dtype=torch.int8)
    cache[:, 0] = torch.from_numpy(v.reshape(b, hkv, dh).astype(np.int8))
    scales = torch.full((b, smax, hkv), float("nan"))
    scales[:, 0] = sc.reshape(b, hkv)
    k8 = torch.zeros_like(cache).to(cuda_device).transpose(1, 2)
    ks = torch.ones((b, smax, hkv), device=cuda_device).transpose(1, 2)
    v8 = cache.to(cuda_device).transpose(1, 2)
    vs = scales.to(cuda_device).transpose(1, 2)
    q = torch.from_numpy(rng.standard_normal((b, 1, hkv, dh)).astype(
        np.float32)).to(cuda_device, dt).transpose(1, 2)
    got = flash_attention(q, k8, v8, causal=False, kv_len=1, k_scale=ks,
                          v_scale=vs)
    torch.cuda.synchronize()
    want = (cache[:, 0].float() * scales[:, 0, :, None]).to(dt)
    assert torch.equal(got[:, :, 0].cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", ["small", "wide"])
def test_flash_attention_int8_served_geometry(cuda_device, spread):
    """The geometry the MoE model serves: q in bf16, Dh 128, group 1, 16 kv
    heads, one query, over 2,080 slots at ragged kv_len; the cache
    quantised by ``quantize_kv`` from rows whose magnitudes span 1e-7 to
    1e-3 ("small": scales down to their 1e-8 floor) or 1e-6 to 1e2 for k
    and to 1 for v ("wide": outputs of order 1, where the 3e-2 bound
    applies), the largest rows at ±127.  Bit-identical on relaunch and with
    NaN scales past kv_len, the bits of K6's bf16 form over a dequantised
    copy, and within 3e-2 of the plain version."""
    from repro_torch.kernels.attention import (
        attention_plain, dequantize, flash_attention)
    from repro_torch.models.transformer import quantize_kv

    b, hkv, smax, dh = 2, 16, 2080, 128
    rng = np.random.default_rng(len(spread))
    low, top = {"small": (-7, (-3, -3)), "wide": (-6, (2, 0))}[spread]
    cache = torch.from_numpy(np.stack([
        rng.standard_normal((b, smax, hkv, dh)) * 10.0 ** rng.uniform(
            low, t, (b, smax, hkv, 1)) for t in top]).astype(
                np.float32)).to(cuda_device, torch.bfloat16)
    c8, scales = quantize_kv(cache)
    assert int(c8.abs().max()) == 127
    assert spread == "wide" or float(scales.min()) < 2e-8
    q = torch.from_numpy(rng.standard_normal((b, 1, hkv, dh)).astype(
        np.float32) * 0.2).to(cuda_device, torch.bfloat16).transpose(1, 2)
    k, v = c8[0].transpose(1, 2), c8[1].transpose(1, 2)
    ks, vs = scales[0].transpose(1, 2), scales[1].transpose(1, 2)
    kd = dequantize(k, ks, torch.bfloat16)
    vd = dequantize(v, vs, torch.bfloat16)
    for kv_len in (1, 700, 2049, 2080):
        psc = scales.clone()
        psc[:, :, kv_len:] = float("nan")
        kw = dict(causal=False, kv_len=kv_len)
        got = flash_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
        again = flash_attention(q, k, v, k_scale=ks, v_scale=vs, **kw)
        tail = flash_attention(q, k, v, k_scale=psc[0].transpose(1, 2),
                               v_scale=psc[1].transpose(1, 2), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, tail)
        assert torch.equal(got, flash_attention(q, kd, vd, **kw))
        np.testing.assert_allclose(
            got.float().cpu().numpy(),
            attention_plain(q, k, v, k_scale=ks, v_scale=vs, **kw)
            .float().cpu().numpy(), rtol=3e-2, atol=3e-2)


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


# --------------------------------------------------------------------------- #
# checkpoint / restore, elastic K and the supervisor on the card
# --------------------------------------------------------------------------- #
def _web_problem(n=2048):
    import repro_torch
    from repro_torch.core import webgraph_like
    from repro_torch.graph import GraphStore

    return repro_torch.Problem.pagerank(
        GraphStore.from_csr(webgraph_like(n, seed=1)))


def _state(session):
    """The driver's device state: (F, H) in node order as float32 tensors
    on the card (no host round trip)."""
    d = session._driver
    if hasattr(d, "ex"):  # the engine: home-row order of the layout
        cur = d.engine.cur_of_home(d.ex.row_of_bucket)
        return d.ex.state.f[cur], d.ex.state.h[cur]
    st = d._state
    return st[0][: d.n], (st[2] if len(st) == 6 else st[1])[: d.n]


@pytest.mark.cuda
@pytest.mark.parametrize("method,k", [("frontier:pallas", None),
                                      ("engine:chunk", 4)])
def test_restore_on_the_card_replays_the_uninterrupted_solve(
        cuda_device, tmp_path, method, k):
    """Checkpointed mid-solve and restored on the card: the restored
    rounds and pushes plus the checkpoint's equal an uninterrupted run's,
    and the device state is torch.equal to it."""
    import repro_torch

    problem = _web_problem()
    opts = repro_torch.SolverOptions(device="cuda", k=k)
    full = repro_torch.SolverSession(problem, method=method, options=opts)
    rep_full = full.solve()
    session = repro_torch.SolverSession(problem, method=method, options=opts)
    for i, _ in enumerate(session.run()):
        if i >= 3:
            break
    session.checkpoint(str(tmp_path))
    restored = repro_torch.SolverSession.restore(str(tmp_path), problem,
                                                 options=opts)
    info = restored.restored_from
    rep = restored.solve()
    assert rep.converged and rep_full.converged
    assert info["rounds"] + rep.n_rounds == rep_full.n_rounds
    assert info["ops"] + rep.n_ops == rep_full.n_ops
    for a, b in zip(_state(restored), _state(full)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_rescale_on_the_card_matches_the_cpu(cuda_device):
    """engine:chunk at k=4, rescaled 4 -> 3 -> 4 mid-solve on the card:
    the CPU port's drain list, move log and pushes, |Δx|_1 <= 1e-6."""
    import repro_torch

    problem = _web_problem()
    runs = {}
    for dev in ("cpu", "cuda"):
        s = repro_torch.SolverSession(
            problem, method="engine:chunk", device=dev, k=4,
            buckets_per_dev=12, headroom=4)
        for i, _ in enumerate(s.run()):
            if i >= 1:
                break
        drains = s.rescale(3, strict=True)
        for i, _ in enumerate(s.run()):
            if i >= 1:
                break
        grow = s.rescale(4)
        rep = s.solve()
        runs[dev] = (drains, grow, rep)
    (d_cpu, g_cpu, cpu), (d_gpu, g_gpu, gpu) = runs["cpu"], runs["cuda"]
    assert len(d_gpu) == 8 and d_gpu == d_cpu and g_gpu == g_cpu == []
    assert gpu.converged and gpu.move_log == cpu.move_log
    assert (gpu.n_rounds, gpu.n_ops) == (cpu.n_rounds, cpu.n_ops)
    assert np.abs(gpu.x - cpu.x).sum() <= 1e-6


@pytest.mark.cuda
def test_supervised_kill_retry_on_the_card_is_exact(cuda_device, tmp_path):
    """A supervised stream on engine:chunk k=4 on the card, a kill in the
    third request: every served x is bit-equal to a plain card session's
    on the same requests."""
    import repro_torch
    from repro_torch.chaos import ChaosPlan, SessionInjector
    from repro_torch.resilience import RetryPolicy, SupervisedSession

    problem = _web_problem()
    opts = repro_torch.SolverOptions(device="cuda", k=4, chunk_rounds=1)
    sup = SupervisedSession(problem, method="engine:chunk", options=opts,
                            ckpt_dir=str(tmp_path), sleep=lambda s: None,
                            retry=RetryPolicy(base_delay_s=1e-4,
                                              max_delay_s=1e-3))
    plain = repro_torch.SolverSession(_web_problem(), method="engine:chunk",
                                      options=opts)
    rng = np.random.default_rng(0)
    b = np.asarray(problem.b)
    for i in range(4):
        b = np.abs(b * (1 + 0.01 * rng.standard_normal(b.shape[0])))
        chaos = (SessionInjector(ChaosPlan().kill(3, round=2)) if i == 2
                 else None)
        out = sup.serve_rank(b, request_id=i, chaos=chaos)
        plain.warm_start(b)
        rep = plain.solve()
        assert out.ok and out.converged
        assert out.attempts == (2 if i == 2 else 1)
        assert np.array_equal(out.x, rep.x), i
        for a, c in zip(_state(sup.session), _state(plain)):
            assert torch.equal(a, c)
    counts = sup.log.counts()
    assert counts["fault"] == counts["restore"] == 1
    assert sup.wasted_ops > 0


# --------------------------------------------------------------------------- #
# training: K6's backward, the MoE combine's backward and the dispatch's
# --------------------------------------------------------------------------- #
ATTN_BWD_SHAPES = [(2, 4, 2, 1, 16, True), (2, 4, 2, 17, 16, True),
                   (2, 4, 4, 64, 64, True), (2, 4, 2, 100, 32, True),
                   (1, 8, 2, 130, 128, True), (2, 4, 4, 64, 64, False),
                   (1, 4, 1, 200, 64, False), (1, 16, 16, 300, 64, True)]


def _bwd_case(b, hq, hkv, s, dh, seed, dtype, device):
    """q, k, v, do in the model's layout (``[B, S, H, Dh]`` transposed)."""
    rng = np.random.default_rng(seed)

    def t(h, scale):
        a = rng.standard_normal((b, s, h, dh)) * scale
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=dtype).transpose(1, 2)

    return t(hq, 0.5), t(hkv, 0.5), t(hkv, 1.0), t(hq, 1.0)


def _rel_l1(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,dh,causal", ATTN_BWD_SHAPES)
def test_flash_attention_bwd_matches_plain(cuda_device, b, hq, hkv, s, dh,
                                           causal, dtype):
    """K6's backward against its plain version (float32 from the same
    inputs): float32 within rtol 1e-5 / atol 1e-6, bf16 within relative
    L1 1e-2 (P and dS rounded to bf16 for the products) plus 1e-6 an
    element (at S = 1 dq is 0 in exact arithmetic, and the kernel's dP and
    D round apart); every S, ragged tails included; a relaunch
    bit-identical; one count a call."""
    from repro_torch.kernels.attention import (attention_bwd_plain,
                                               flash_attention,
                                               flash_attention_bwd)
    from repro_torch.kernels.attention.backward import bwd_route
    from repro_torch.kernels.attention.kernel import flash_attention_lse

    dt = getattr(torch, dtype)
    q, k, v, do = _bwd_case(b, hq, hkv, s, dh, s + dh, dt, cuda_device)
    if bwd_route(dt, dh, s) == "wgmma":  # it reads the forward's L
        o, lse = flash_attention_lse(q, k, v, causal=causal)
    else:
        o, lse = flash_attention(q, k, v, causal=causal), None
    before = LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 2
    plain = attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)),
                                causal=causal)
    for g, g2, p, t, name in zip(got, again, plain, (q, k, v), "qkv"):
        assert g.shape == t.shape and g.dtype == dt, name
        assert torch.equal(g, g2), name
        assert bool(torch.isfinite(g).all()), name
        if dt == torch.float32:
            np.testing.assert_allclose(g.cpu().numpy(), p.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        else:  # an absolute floor for S = 1, where dq is 0 exactly
            err = float((g.float() - p).abs().sum())
            assert err <= 1e-2 * float(p.abs().sum()) + 1e-6 * p.numel(), (
                name, err, float(p.abs().sum()))


@pytest.mark.cuda
def test_flash_attention_bwd_block_is_the_wrappers(cuda_device):
    from repro_torch.kernels.attention.backward import bwd_block, lse_rows

    assert bwd_block() == 128  # the wgmma pair's blocks: 128 rows
    assert [lse_rows(s) for s in (1, 128, 129, 4096)] == [128, 128, 256,
                                                          4096]


def _bwd_wgmma_case(b, hq, hkv, sq, sk, dh, seed, device):
    """bf16 q, do [B, Hq, Sq, Dh] and k, v [B, Hkv, Sk, Dh] views of the
    model's layout."""
    rng = np.random.default_rng(seed)

    def t(s, h, scale):
        a = rng.standard_normal((b, s, h, dh)) * scale
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16).transpose(1, 2)

    return t(sq, hq, 0.5), t(sk, hkv, 0.5), t(sk, hkv, 1.0), t(sq, hq, 1.0)


WGMMA_BWD_CASES = [(s, s, dh, group, causal) for s in (65, 200, 1000, 4096)
                   for dh in (64, 128) for group in (1, 2)
                   for causal in (True, False)] + [(300, 200, 64, 2, False),
                                                    (200, 455, 128, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,dh,group,causal", WGMMA_BWD_CASES)
def test_flash_attention_bwd_wgmma_matches_plain(cuda_device, sq, sk, dh,
                                                 group, causal):
    """K6's wgmma backward (bf16, Dh 64 and 128, Sq > 64) fed the training
    forward's logsumexp, against its plain version on the same bf16
    inputs in float32: relative L1 <= 1e-2 on dq, dk and dv (P and dS
    rounded to bf16 for the products); GQA group 1 and 2, causal and
    bidirectional, Sq = Sk around the 64-row tiles and 128-row blocks up
    to 4,096, and ragged bidirectional Sq != Sk; a relaunch
    bit-identical; each call counted under ``BWD_ROUTES["wgmma"]``."""
    from repro_torch.kernels.attention import (attention_bwd_plain,
                                               flash_attention_bwd)
    from repro_torch.kernels.attention.backward import BWD_ROUTES
    from repro_torch.kernels.attention.kernel import flash_attention_lse

    b = 1 if sq > 1000 else 2
    hkv = 2
    q, k, v, do = _bwd_wgmma_case(b, hkv * group, hkv, sq, sk, dh,
                                  sq * 7 + sk + dh + group, cuda_device)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    before = dict(BWD_ROUTES)
    got = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    again = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert BWD_ROUTES == {r: n + 2 * (r == "wgmma")
                          for r, n in before.items()}
    plain = attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)),
                                causal=causal)
    for g, g2, p, t, name in zip(got, again, plain, (q, k, v), "qkv"):
        assert g.shape == t.shape and g.dtype == torch.bfloat16, name
        assert torch.equal(g, g2), name
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l1(g.float(), p) <= 1e-2, (name, _rel_l1(g.float(), p))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,dh,causal", [(65, 64, True), (1000, 64, False),
                                          (200, 128, True),
                                          (4096, 128, False)])
def test_flash_attention_lse_forward_is_servings_with_its_l(cuda_device, sq,
                                                            dh, causal):
    """The training forward (``flash_attention_lse``, the wgmma prefill
    kernel's instance that writes L): o bit-equal to serving's forward on
    the same inputs, L within 1e-5 (absolute plus relative) of the plain
    log2-sum-exp; counted under ``flash_attention`` and ``ROUTES["wgmma"]``
    as serving's launches are."""
    from repro_torch.kernels.attention import attention_plain, flash_attention
    from repro_torch.kernels.attention.backward import lse_rows
    from repro_torch.kernels.attention.kernel import (ROUTES,
                                                      flash_attention_lse)

    q, k, v, _ = _bwd_wgmma_case(2, 4, 2, sq, sq, dh, sq + dh, cuda_device)
    before, wg = LAUNCHES["flash_attention"], ROUTES["wgmma"]
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    served = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] - before == 2
    assert ROUTES["wgmma"] - wg == 2
    assert torch.equal(o, served) and o.stride() == served.stride()
    assert lse.shape == (2, 4, lse_rows(sq)) and lse.dtype == torch.float32
    _, want = attention_plain(*(t.float() for t in (q, k, v)), causal=causal,
                              lse=True)
    torch.testing.assert_close(lse[..., :sq], want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_bwd_counts_each_call_under_its_route(cuda_device):
    """``BWD_ROUTES`` counts a call under the pair that ran it: wgmma for
    bf16 at Dh 64 / 128 past 64 query rows (given the forward's L, and
    refused without it), mma_sync for other bf16 (refusing an L), fma for
    float32; the training op takes the wgmma route through the training
    forward."""
    import repro_torch.kernels.attention as ka
    from repro_torch.kernels.attention.backward import BWD_ROUTES, bwd_route
    from repro_torch.kernels.attention.kernel import (ROUTES,
                                                      flash_attention_lse)

    cases = [(torch.bfloat16, 64, 200, "wgmma"),
             (torch.bfloat16, 128, 65, "wgmma"),
             (torch.bfloat16, 64, 64, "mma_sync"),
             (torch.bfloat16, 32, 200, "mma_sync"),
             (torch.float32, 64, 200, "fma")]
    for dt, dh, s, route in cases:
        assert bwd_route(dt, dh, s) == route
        q, k, v, do = _bwd_case(1, 4, 2, s, dh, s, dt, cuda_device)
        lse = None
        if route == "wgmma":
            o, lse = flash_attention_lse(q, k, v, causal=True)
            with pytest.raises(ValueError, match="logsumexp"):
                ka.flash_attention_bwd(q, k, v, o, do, causal=True)
        else:
            o = ka.flash_attention(q, k, v, causal=True)
            with pytest.raises(ValueError, match="lse must be None"):
                ka.flash_attention_bwd(q, k, v, o, do, causal=True,
                                       lse=torch.zeros(1, device=cuda_device))
        before = dict(BWD_ROUTES)
        ka.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
        assert BWD_ROUTES == {r: n + (r == route) for r, n in before.items()}
    q, k, v, do = _bwd_case(1, 4, 2, 200, 64, 5, torch.bfloat16, cuda_device)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before, fwd = dict(BWD_ROUTES), ROUTES["wgmma"]
    out = ka.flash_attention_train(*leaves, causal=True)
    torch.autograd.grad(out, leaves, do)
    assert ROUTES["wgmma"] - fwd == 1
    assert BWD_ROUTES == {r: n + (r == "wgmma") for r, n in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_attention_train_op_wgmma_relaunch_is_bit_identical(cuda_device, dh):
    """The training op on the wgmma route (the forward writing L, the
    backward reading it) twice on the same bf16 inputs: the same output
    and gradients to the bit, and gradients within relative L1 1e-2 of
    the plain op's."""
    import repro_torch.kernels.attention as ka

    q, k, v, do = _bwd_wgmma_case(2, 8, 4, 777, 777, dh, dh, cuda_device)
    runs = []
    for op in (ka.flash_attention_train, ka.flash_attention_train,
               ka.attention_train_plain):
        leaves = [t.detach().float().requires_grad_(True)
                  if op is ka.attention_train_plain
                  else t.detach().requires_grad_(True) for t in (q, k, v)]
        out = op(*leaves, causal=True)
        runs.append((out.detach(), torch.autograd.grad(
            out, leaves, do.to(out.dtype))))
    (o1, g1), (o2, g2), (_, want) = runs
    assert torch.equal(o1, o2)
    for a, b_, w in zip(g1, g2, want):
        assert torch.equal(a, b_)
        assert _rel_l1(a.float(), w) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash_attention_train",
                                "attention_train_plain"])
def test_attention_train_op_on_the_card(cuda_device, op):
    """The autograd op on the card: K6 forward and backward (or their
    plain versions), gradients within the float32 tolerances of the plain
    backward, launches counted only on the kernels' op."""
    import repro_torch.kernels.attention as ka

    q, k, v, do = _bwd_case(2, 4, 2, 96, 64, 3, torch.float32, cuda_device)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = dict(LAUNCHES)
    out = getattr(ka, op)(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    kernels = op == "flash_attention_train"
    assert LAUNCHES["flash_attention"] - before["flash_attention"] == kernels
    assert (LAUNCHES["flash_attention_bwd"]
            - before["flash_attention_bwd"]) == kernels
    want = ka.attention_bwd_plain(q, k, v, out.detach(), do, causal=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


def _combine_bwd_case(rng, t, k, e_pad, cap, d, dtype, device, case="sorted"):
    """The MoE combine's operands as ``_dispatch_slots`` makes them: each
    kept slot a buffer row of its own, every dropped slot row 0 with
    weight 0 (row -1, as the model now names it, in the cases ending in
    ``dropped``), and ``slot`` the inverse map (the slot count where none).
    ``case``: ``sorted`` (a token's k slots side by side, a fifth dropped,
    rows at random); ``routed`` (the dispatch's layout: k distinct
    experts a token by a skewed preference, each expert's rows filled in
    token order, the overflow past ``cap`` dropped); ``shuffled`` (the
    slots of ``sorted`` in a random order, so that ``seg`` is unsorted);
    ``uneven`` (tokens of 0 to 2k slots); ``zero_weight`` (a tenth of the
    kept slots of weight 0); ``off_contract`` (up to 50 rows that no slot
    names given a kept slot that names another row: ``rows[slot[r]] !=
    r``); ``dropped`` (``sorted`` with row -1 a dropped slot);
    ``routed_dropped`` (``routed`` with row -1 a dropped slot)."""
    n = e_pad * cap
    counts = rng.integers(0, 2 * k + 1, t) if case == "uneven" else (
        np.full(t, k))
    seg = np.repeat(np.arange(t, dtype=np.int32), counts)
    m = seg.size
    if case.startswith("routed"):
        pref = rng.random((t, e_pad)) * np.linspace(1.0, 3.0, e_pad)
        gate = np.argsort(-pref, axis=1)[:, :k].reshape(-1)
        order = np.argsort(gate, kind="stable")
        first = np.cumsum(np.bincount(gate, minlength=e_pad)) - np.bincount(
            gate, minlength=e_pad)
        pos = np.empty(m, np.int64)
        pos[order] = np.arange(m) - first[gate[order]]
        keep = pos < cap
        dest = gate * cap + pos
    else:
        keep = rng.random(m) < 0.8
        dest = rng.permutation(n)[:m]
    rows = np.where(keep, dest, -1 if case.endswith("dropped") else 0)
    w = np.where(keep, rng.random(m), 0.0).astype(np.float32)
    if case == "zero_weight":
        w[keep & (rng.random(m) < 0.1)] = 0.0
    slot = np.full(n + 1, m, np.int64)
    slot[np.where(keep, dest, n)] = np.arange(m)
    slot = slot[:n]
    if case == "shuffled":  # slot i is the sorted case's slot perm[i]
        perm = rng.permutation(m)
        seg, rows, w = seg[perm], rows[perm], w[perm]
        inv = np.empty(m, np.int64)
        inv[perm] = np.arange(m)
        slot = np.where(slot < m, inv[np.minimum(slot, m - 1)], m)
    if case == "off_contract":
        free = np.flatnonzero(slot == m)
        pick = rng.choice(free, size=min(free.size, 50), replace=False)
        slot[pick] = rng.choice(np.flatnonzero(keep), size=pick.size)
    eo = rng.standard_normal((n, d)).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)
    out = [torch.from_numpy(a).to(device) for a in (g, w, rows, seg, slot)]
    return [torch.from_numpy(eo).to(device=device, dtype=dtype), *out]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t,k,d,case", [
    pytest.param(8, 4, 2048, "sorted", id="8-4-2048"),
    pytest.param(3000, 4, 64, "sorted", id="3000-4-64"),
    pytest.param(700, 8, 130, "sorted", id="700-8-130"),
    pytest.param(50, 2, 2, "sorted", id="50-2-2"),
    pytest.param(9, 1, 12, "sorted", id="9-1-12"),
    # granite-moe-1b-a400m's layer 0: 32 experts of 5,120 rows
    pytest.param(16384, 8, 1024, "routed", id="granite-16384-8-1024"),
    pytest.param(3000, 4, 64, "shuffled", id="shuffled-3000-4-64"),
    pytest.param(700, 8, 1152, "shuffled", id="shuffled-700-8-1152"),
    pytest.param(700, 8, 128, "uneven", id="uneven-700-8-128"),
    pytest.param(700, 8, 128, "zero_weight", id="zero_weight-700-8-128"),
    pytest.param(700, 8, 128, "off_contract", id="off_contract-700-8-128"),
    pytest.param(700, 8, 130, "off_contract", id="off_contract-700-8-130"),
    # a dropped slot names row -1 (the model's rows since the dispatch's
    # own backward): it reads nothing and gets grad_w 0
    pytest.param(700, 8, 128, "dropped", id="dropped-700-8-128"),
    pytest.param(700, 8, 130, "dropped", id="dropped-700-8-130"),
    pytest.param(16384, 8, 1024, "routed_dropped",
                 id="granite-dropped-16384-8-1024"),
])
def test_moe_combine_bwd_matches_plain(cuda_device, t, k, d, case, dtype):
    """The combine's backward against its plain version (index_add_ and a
    row-wise dot in float32): grad_data bit-equal (one term a row),
    grad_w against the dots in float64, each within 4·2⁻²⁴·D·Σ_d
    |eo[rows[e], d]·g[seg[e], d]| (a float32 sum of D terms in any order
    errs by at most about D roundings of the terms' magnitude), a
    relaunch bit-identical, a launch counted under its dtype's name and
    under the body that ran (``stream`` where D is a multiple of 16 bytes,
    else ``warp_row``), both outputs bit-equal to the ``warp_row`` body's
    (the stream body keeps its dot's order), and every output written:
    ``torch.empty`` hands out NaN.  Off the dispatch's contract a row
    whose ``slot`` names a slot of another row gets ``w[slot[r]] ·
    g[seg[slot[r]]]``, as the ``warp_row`` body always gave it.  A slot
    naming row -1 reads no row and gets ``grad_w`` 0 in every body, as in
    the plain version."""
    from repro_torch.kernels.segment import segment_sum_bwd_ref
    from repro_torch.kernels.segment.backward import (
        COMBINE_BWD_ROUTES, _moe_combine_bwd_warp_row, moe_combine_bwd)

    dt = getattr(torch, dtype)
    e_pad, cap = (32, 5120) if case.startswith("routed") else (
        64, max(1, -(-t * k // 50)))
    eo, g, w, rows, seg, slot = _combine_bwd_case(
        np.random.default_rng(t + d), t, k, e_pad, cap, d, dt, cuda_device,
        case)
    name = "segment_sum_bf16_bwd" if dt == torch.bfloat16 else (
        "segment_sum_bwd")
    route = "stream" if d % (16 // eo.element_size()) == 0 else "warp_row"
    before, routes = LAUNCHES[name], dict(COMBINE_BWD_ROUTES)
    with _empty_is_nan():
        got = moe_combine_bwd(g, eo, seg, w, rows, slot)
        again = moe_combine_bwd(g, eo, seg, w, rows, slot)
        old = _moe_combine_bwd_warp_row(g, eo, seg, w, rows, slot)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2
    assert {r: c - routes[r] for r, c in COMBINE_BWD_ROUTES.items()} == {
        **dict.fromkeys(routes, 0), route: 2}
    want = segment_sum_bwd_ref(g, eo, seg, w, rows)
    want_eo = want[1]
    if case == "off_contract":
        off = (slot < seg.numel()).nonzero()[:, 0]
        off = off[rows[slot[off]] != off]
        assert off.numel() > 0
        s = slot[off]
        want_eo[off] = (w[s, None] * g[seg[s].long()]).to(dt)
    assert got[1].dtype == dt and got[0].dtype == torch.float32
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[1], want_eo)
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    named = rows >= 0
    terms = (eo.double().index_select(0, rows.clamp(min=0))
             * g.double().index_select(0, seg.long())) * named[:, None]
    assert bool((got[0][~named] == 0).all())
    err = (got[0].double() - terms.sum(-1)).abs()
    bound = 4 * 2.0**-24 * d * terms.abs().sum(-1)
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_dispatch_bwd_on_k5_counts_apart(cuda_device, dtype):
    """The dispatch gather's backward through :func:`moe_dispatch` (its
    own kernel, ``csrc/dispatch_bwd.cu``, since it left K5's gather form):
    the sum of each token's kept slots, within rtol / atol 1e-5 of the
    plain version, counted under ``moe_dispatch_bwd`` and not under K5's
    own names."""
    from repro_torch.kernels.segment import (moe_dispatch, segment_sum_ref,
                                             segment_sum_sorted)

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    t, k, n = 700, 4, 64 * 50
    eo, _, w, rows, seg, slot = _combine_bwd_case(rng, t, k, 64, 50, 128,
                                                  dt, cuda_device)
    keep = w > 0
    x = torch.from_numpy(rng.standard_normal((t, 128)).astype(
        np.float32)).to(device=cuda_device, dtype=dt).requires_grad_(True)
    grads = []
    for plain in (False, True):
        before = dict(LAUNCHES)
        buf = moe_dispatch(x, slot // k, seg_ids=seg, dest=rows, keep=keep,
                           combine=segment_sum_ref if plain
                           else segment_sum_sorted)
        assert buf.shape == (n, 128)
        (gx,) = torch.autograd.grad(buf, [x], eo)
        torch.cuda.synchronize()
        assert LAUNCHES["moe_dispatch_bwd"] - before["moe_dispatch_bwd"] == (
            0 if plain else 1)
        for key in ("segment_sum", "segment_sum_bf16"):
            assert LAUNCHES[key] == before[key]
        grads.append(gx.float())
    np.testing.assert_allclose(grads[0].cpu().numpy(),
                               grads[1].cpu().numpy(), rtol=1e-5, atol=1e-5)


def _dispatch_bwd_case(rng, t, k, d, dtype, device):
    """The dispatch's backward operands: ``t`` tokens of ``k`` slots, a
    fifth dropped and the first 3 tokens' every slot, each kept slot a
    buffer row of its own among ``R = 1.25·t·k``, a dropped slot's dest a
    kept slot's row, a free row or past the buffer; ``g [R, d]`` normal.
    Returns ``(g, dest, keep)``."""
    m = t * k
    n_rows = m + m // 4
    keep = rng.random(m) < 0.8
    keep[:3 * k] = False
    dest = rng.permutation(n_rows)[:m].astype(np.int64)
    drop = np.flatnonzero(~keep)
    dest[drop] = rng.integers(0, n_rows + 100, drop.size)
    g = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(np.float32))
    return (g.to(device=device, dtype=dtype), torch.from_numpy(dest).to(device),
            torch.from_numpy(keep).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 1024, 1030])
def test_moe_dispatch_bwd_matches_plain(cuda_device, d, k, dtype):
    """The dispatch's backward kernel (``csrc/dispatch_bwd.cu``; D 1,030
    in either dtype runs its elem body, the others its vec body) against
    its plain version, which sums the same terms in the same order: the
    same bits (so within relative L1 1e-5), in ``g``'s dtype, zeros for
    the tokens whose every slot is dropped, every element written
    (``torch.empty`` hands out NaN), a relaunch bit-identical, one launch
    counted under ``moe_dispatch_bwd`` a call and none under K5's
    names."""
    from repro_torch.kernels.segment import (dispatch_bwd_kernel,
                                             dispatch_bwd_ref)

    dt = getattr(torch, dtype)
    t = 700
    g, dest, keep = _dispatch_bwd_case(np.random.default_rng(d + k), t, k,
                                       d, dt, cuda_device)
    before = dict(LAUNCHES)
    with _empty_is_nan():
        got = dispatch_bwd_kernel(g, dest, keep, t)
        again = dispatch_bwd_kernel(g, dest, keep, t)
        torch.cuda.synchronize()
        want = dispatch_bwd_ref(g, dest, keep, t)
    assert {key: n - before[key] for key, n in LAUNCHES.items()
            if n != before[key]} == {"moe_dispatch_bwd": 2}
    assert got.dtype == dt and got.shape == (t, d)
    assert torch.equal(got, again) and torch.equal(got, want)
    assert _rel_l1(got.float(), want.float()) <= 1e-5
    assert bool((got[:3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("dtype,d", [("bfloat16", 1024), ("float32", 64),
                                     ("bfloat16", 128), ("float32", 128)])
def test_moe_dispatch_bwd_is_k5s_route_plus_the_cast(cuda_device, dtype, d,
                                                     k):
    """On finite g, bit for bit what the port ran before: K5's gather form
    over rows ``where(keep, dest, 0)`` with weight 1 a kept slot and 0 a
    dropped one, then ``.to(dtype)`` (1,024 tokens: every K5 walker holds
    whole tokens, so K5 too sums a token's slots in slot order)."""
    from repro_torch.kernels.segment import (dispatch_bwd_kernel,
                                             segment_sum_kernel)

    dt = getattr(torch, dtype)
    t = 1024
    g, dest, keep = _dispatch_bwd_case(np.random.default_rng(d * k), t, k,
                                       d, dt, cuda_device)
    seg = torch.arange(t, dtype=torch.int32,
                       device=cuda_device).repeat_interleave(k)
    old = segment_sum_kernel(g, seg, t, keep.float(),
                             torch.where(keep, dest, 0)).to(dt)
    assert torch.equal(dispatch_bwd_kernel(g, dest, keep, t), old)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [128, 1030])
def test_moe_dispatch_bwd_reads_no_dropped_row(cuda_device, d, dtype):
    """NaN and inf in every row of g that no kept slot names (the rows the
    dropped slots name among them): the kernel's output is finite and
    bit-equal to its output with those rows zeroed."""
    from repro_torch.kernels.segment import dispatch_bwd_kernel

    dt = getattr(torch, dtype)
    t, k = 700, 8
    g, dest, keep = _dispatch_bwd_case(np.random.default_rng(d), t, k, d, dt,
                                       cuda_device)
    free = torch.ones(g.shape[0], dtype=torch.bool, device=cuda_device)
    free[dest[keep]] = False
    clean = dispatch_bwd_kernel(g.masked_fill(free[:, None], 0), dest, keep,
                                t)
    g[free] = torch.where(torch.rand(g[free].shape, device=cuda_device) < 0.5,
                          torch.inf, torch.nan).to(dt)
    got = dispatch_bwd_kernel(g, dest, keep, t)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, clean)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_lm_training_on_the_card_matches_the_cpu(cuda_device, arch):
    """The reduced config (float32) through ``train_loss`` and its
    gradients on the card, with remat: every gradient leaf within
    relative L1 1e-4 of the CPU's (plain versions); K6 launched twice a
    layer (forward and recomputation), its backward once, and, for the
    MoE, the combine's backward and the dispatch's once a layer; remat
    off gives the card's gradients again."""
    import dataclasses

    from repro_torch.configs.smoke import smoke_setup
    from repro_torch.models import transformer as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch, _ = smoke_setup(arch)
    card = lm.init_params(cfg, device=cuda_device)
    cpu = lm.init_params(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})

    def grads(model, c=None):
        model.requires_grad_(True)
        loss = lm.train_loss(model, batch, c)
        leaves = [p for _, p in sorted(model.named_parameters())]
        return loss, torch.autograd.grad(loss, leaves)

    before = dict(LAUNCHES)
    loss, got = grads(card)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert LAUNCHES["flash_attention"] - before["flash_attention"] == 2 * n
    assert (LAUNCHES["flash_attention_bwd"]
            - before["flash_attention_bwd"]) == n
    if cfg.moe is not None:
        for key in ("segment_sum_bwd", "moe_dispatch_bwd"):
            assert LAUNCHES[key] - before[key] == n, key
    loss_cpu, want = grads(cpu)
    np.testing.assert_allclose(float(loss.detach()), float(loss_cpu.detach()),
                               rtol=1e-5)
    for g, w in zip(got, want):
        assert _rel_l1(g.cpu(), w) <= 1e-4
    _, again = grads(card, dataclasses.replace(cfg, remat=False))
    for g, w in zip(got, again):
        assert _rel_l1(g, w) <= 1e-6


# --------------------------------------------------------------------------- #
# FM and GIN training: K4's backward, K5 as the embedding and aggregation
# backwards
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 10, 40])
@pytest.mark.parametrize("f", [6, 39])
@pytest.mark.parametrize("b", [1, 7, 4096])
def test_fm_interaction_bwd_matches_plain(cuda_device, b, f, d):
    """K4's backward against its plain version: within 1e-5 of the
    magnitude of the terms it subtracts (``|dy|·(Σ_g |v| + |v|)``), every
    element written (``torch.empty`` hands out NaN), a relaunch
    bit-identical, one launch counted each."""
    from repro_torch.kernels.fm import (fm_interaction_bwd_kernel,
                                        fm_interaction_bwd_ref)

    rng = np.random.default_rng(b * 100 + f * 10 + d)
    v = torch.from_numpy(rng.standard_normal((b, f, d)).astype(
        np.float32)).to(cuda_device)
    dy = torch.from_numpy(rng.standard_normal(b).astype(np.float32)).to(
        cuda_device)
    before = LAUNCHES["fm_interaction_bwd"]
    with _empty_is_nan():
        got = fm_interaction_bwd_kernel(v, dy)
        again = fm_interaction_bwd_kernel(v, dy)
    torch.cuda.synchronize()
    assert LAUNCHES["fm_interaction_bwd"] == before + 2
    assert torch.equal(got, again)
    want = fm_interaction_bwd_ref(v.double(), dy.double())
    scale = dy.double().abs()[:, None, None] * (
        v.double().abs().sum(1, keepdim=True) + v.double().abs())
    assert bool(((got.double() - want).abs() <= 1e-5 * scale).all())


def _emb_bwd_rows(kind, r, bag, seed):
    """Row ids of a lookup (shuffled, a multiple of ``bag`` of them) into a
    table of n rows, for the kernel's tiles of ``r`` rows: a hot id in 12,000
    or 40,000 rows (``hot12k`` / ``hot40k``), tiles 1, 2, 4 and 5 of six
    empty (``empty_tiles``), tile 2's ids all one id (``one_id_tile``), an n
    that is no multiple of r with ids in its last tile (``ragged``), ids
    below 0 and at or past n (``outside``, int64).  Returns ``(rows, n)``."""
    rng = np.random.default_rng(seed)
    n = 6 * r
    if kind in ("hot12k", "hot40k"):
        parts = [np.full(12_000 if kind == "hot12k" else 40_000, 2 * r + 5),
                 rng.integers(0, n, 5_000)]
    elif kind == "empty_tiles":
        parts = [rng.integers(0, r, 3_000), rng.integers(3 * r, 4 * r, 3_000)]
    elif kind == "one_id_tile":
        parts = [np.full(3_000, 2 * r + 7), rng.integers(0, 2 * r, 2_000),
                 rng.integers(3 * r, n, 2_000)]
    elif kind == "ragged":
        n = 4 * r + 13
        parts = [rng.integers(0, n, 4_000), np.full(300, n - 1),
                 rng.integers(4 * r, n, 500)]
    else:
        parts = [rng.integers(-50, 0, 700), rng.integers(n, n + 50, 700),
                 rng.integers(0, n, 4_000)]
    rows = np.concatenate(parts)
    rows = np.concatenate([rows, rows[: (-rows.size) % bag]])
    dtype = np.int64 if kind == "outside" else np.int32
    return rng.permutation(rows).astype(dtype), n


_EMB_KINDS = ["hot12k", "hot40k", "empty_tiles", "one_id_tile", "ragged",
              "outside"]


@pytest.mark.cuda
@pytest.mark.parametrize("bag", [1, 39])
@pytest.mark.parametrize("d", [1, 2, 10, 16])
@pytest.mark.parametrize("kind", _EMB_KINDS)
def test_embedding_gather_bwd_kernel_is_exact(cuda_device, kind, d, bag):
    """The FM lookup's gradient on its own kernel (``embedding_bwd.cu``),
    on integer-valued gradients whose sums are exact in any order: bit-equal
    to the plain version, every row written (``torch.empty`` hands out NaN),
    a relaunch bit-identical, one launch a call counted under
    ``embedding_gather_bwd`` and nothing under K5's names, its carry or
    its forms; through ``embedding_gather`` (ids inside the table) the same
    bits.  Hot ids of 12,000 and 40,000 rows, empty tiles, a tile of one
    id, a ragged last tile, ids outside ``[0, n)``; int32 and int64 ids and
    orders."""
    from repro_torch.kernels.segment import (
        FORMS, embedding_bwd_kernel, embedding_bwd_ref, embedding_gather)
    from repro_torch.kernels.segment.embedding_bwd import tile_rows

    r = tile_rows(d)
    seed = _EMB_KINDS.index(kind) * 100 + d + bag
    rows, n = _emb_bwd_rows(kind, r, bag, seed)
    rows_t = torch.from_numpy(rows).to(cuda_device)
    seg, order = torch.sort(rows_t, stable=True)
    if kind in ("one_id_tile", "ragged"):
        order = order.int()
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.integers(-8, 8, (rows.size // bag, d)).astype(
        np.float32)).to(cuda_device)
    before, forms = dict(LAUNCHES), dict(FORMS)
    with _empty_is_nan():
        got = embedding_bwd_kernel(g, seg, order, n, bag)
        again = embedding_bwd_kernel(g, seg, order, n, bag)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_gather_bwd"] - before[
        "embedding_gather_bwd"] == 2
    for name in ("segment_sum", "segment_sum_carry", "segment_sum_bf16"):
        assert LAUNCHES[name] == before[name]
    assert FORMS == forms
    want = embedding_bwd_ref(g, seg, order, n, bag)
    assert got.shape == (n, d)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert float(got.abs().sum()) > 0
    if kind == "empty_tiles":
        assert not bool(got[r:3 * r].any()) and not bool(got[4 * r:].any())
    if kind == "ragged":
        assert n % r != 0 and bool(got[n - 1].any())
    if kind == "outside":
        return
    shape = (n,) if d == 1 else (n, d)
    table = torch.zeros(shape, device=cuda_device, requires_grad=True)
    before = dict(LAUNCHES)
    with _empty_is_nan():
        out = embedding_gather(table, rows_t, bag=bag)
        (grad,) = torch.autograd.grad(out, [table], g.reshape(out.shape))
    torch.cuda.synchronize()
    delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert delta["embedding_gather_bwd"] == 1
    assert delta["segment_sum"] == delta["segment_sum_carry"] == 0
    assert torch.equal(grad.reshape(n, d), got)


@pytest.mark.cuda
@pytest.mark.parametrize("bag", [1, 39])
@pytest.mark.parametrize("d", [1, 2, 10, 16])
def test_embedding_gather_bwd_kernel_matches_float64(cuda_device, d, bag):
    """On normal gradients, hot ids of 12,000 and 40,000 rows among others:
    each row within 2⁻²⁴·n·Σ|terms| of the float64 sum of its n terms (a
    float32 sum in any order errs by at most n - 1 roundings of the terms'
    magnitudes), a relaunch bit-identical."""
    from repro_torch.kernels.segment import (embedding_bwd_kernel,
                                             embedding_bwd_ref)
    from repro_torch.kernels.segment.embedding_bwd import tile_rows

    r = tile_rows(d)
    rng = np.random.default_rng(d * 1000 + bag)
    n = 6 * r
    rows = np.concatenate([np.full(40_000, r + 3), np.full(12_000, 4 * r),
                           rng.integers(0, n, 20_000)])
    rows = np.concatenate([rows, rng.integers(0, n, (-rows.size) % bag)])
    rows_t = torch.from_numpy(rng.permutation(rows).astype(np.int32)).to(
        cuda_device)
    seg, order = torch.sort(rows_t, stable=True)
    g = torch.from_numpy(rng.standard_normal((rows.size // bag, d)).astype(
        np.float32)).to(cuda_device)
    got = embedding_bwd_kernel(g, seg, order, n, bag)
    again = embedding_bwd_kernel(g, seg, order, n, bag)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = embedding_bwd_ref(g.double(), seg, order, n, bag)
    mag = embedding_bwd_ref(g.double().abs(), seg, order, n, bag)
    cnt = torch.bincount(seg.long(), minlength=n).double()
    assert bool(((got.double() - want).abs()
                 <= 2.0**-24 * cnt[:, None] * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_gin_aggregation_bwd_matches_plain(cuda_device, masked):
    """One GIN aggregation's gradient on K5's gather form over the
    transposed graph against the same sums in float64: each row within
    2⁻²⁴·n·Σ|terms| for its n terms (a float32 sum in any order errs by
    at most n - 1 roundings of the terms' magnitudes; a power-law hub
    sums thousands), the plain version (index_add_) likewise; a relaunch
    bit-identical, counted under ``gnn_agg_bwd``; the forward stays K5's
    own launch."""
    from repro_torch.data import make_gnn_batch
    from repro_torch.kernels.segment import (gather_aggregate,
                                             segment_sum_ref)
    from repro_torch.models import gnn

    b = make_gnn_batch(power_law_graph(20_000, seed=2), 4, n_classes=2)
    rng = np.random.default_rng(masked)
    if masked:
        b["edge_mask"] = (rng.random(b["src"].shape[0]) > 0.3).astype(
            np.float32)
    p = gnn.prepare_batch(b, cuda_device)
    h = torch.from_numpy(rng.standard_normal((20_000, 64)).astype(
        np.float32)).to(cuda_device).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((20_000, 64)).astype(
        np.float32)).to(cuda_device)
    view = dict(weights=p["agg_w"], rows=p["agg_src"], t_seg=p["aggT_seg"],
                t_rows=p["aggT_rows"], t_weights=p["aggT_w"])
    got = []
    for plain in (False, False, True):
        before = dict(LAUNCHES)
        kw = dict(segment_sum=segment_sum_ref) if plain else {}
        out = gather_aggregate(h, p["agg_dst"], 20_000, **view, **kw)
        (gh,) = torch.autograd.grad(out, [h], g)
        torch.cuda.synchronize()
        assert LAUNCHES["gnn_agg_bwd"] - before["gnn_agg_bwd"] == (
            0 if plain else 1)
        assert LAUNCHES["segment_sum"] - before["segment_sum"] == (
            0 if plain else 1)
        got.append(gh)
    assert torch.equal(got[0], got[1])
    t_w = p["aggT_w"]
    w64 = None if t_w is None else t_w.double()
    want = segment_sum_ref(g.double(), p["aggT_seg"], 20_000, w64,
                           p["aggT_rows"])
    mag = segment_sum_ref(g.double().abs(), p["aggT_seg"], 20_000,
                          None if w64 is None else w64.abs(),
                          p["aggT_rows"])
    n = torch.bincount(p["aggT_seg"].long(), minlength=20_000).double()
    bound = 2.0**-24 * n[:, None] * mag
    for gh in (got[0], got[2]):
        assert bool(((gh.double() - want).abs() <= bound).all())


class _FailingLib:
    """A kernel library whose every C entry returns a CUDA error code."""

    def __init__(self, real):
        self._real = real

    def cuda_error_string(self, err):
        return b"injected failure"

    def __getattr__(self, name):
        entry = getattr(self._real, name)

        class _Entry:
            argtypes = entry.argtypes
            restype = entry.restype

            def __call__(self, *args):
                return 999

        return _Entry()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fm_interaction_train", "embedding_gather",
                                "gather_aggregate"])
def test_training_ops_raise_when_the_kernel_fails(cuda_device, op,
                                                  monkeypatch):
    """No fallback: with the kernel's C entry returning an error, the
    training op's backward on a CUDA tensor raises, and hands back no
    plain result."""
    import repro_torch.kernels.fm.kernel as fm_kernel
    import repro_torch.kernels.segment.embedding_bwd as emb_kernel
    import repro_torch.kernels.segment.kernel as seg_kernel
    from repro_torch.kernels.fm import fm_interaction_train
    from repro_torch.kernels.segment import (embedding_gather,
                                             gather_aggregate)

    rng = np.random.default_rng(0)
    if op == "fm_interaction_train":
        real = fm_kernel._lib()
        x = torch.from_numpy(rng.standard_normal((5, 4, 3)).astype(
            np.float32)).to(cuda_device).requires_grad_(True)
        out = fm_interaction_train(x)
        monkeypatch.setattr(fm_kernel, "_lib", lambda: _FailingLib(real))
    else:
        module = emb_kernel if op == "embedding_gather" else seg_kernel
        real = module._lib()
        x = torch.from_numpy(rng.standard_normal((50, 8)).astype(
            np.float32)).to(cuda_device).requires_grad_(True)
        ids = torch.from_numpy(rng.integers(0, 50, 200).astype(
            np.int32)).to(cuda_device)
        if op == "embedding_gather":
            out = embedding_gather(x, ids)
        else:
            seg, order = torch.sort(ids, stable=True)
            src = torch.from_numpy(rng.integers(0, 50, 200).astype(
                np.int32)).to(cuda_device)[order]
            t_seg, t_order = torch.sort(src, stable=True)
            out = gather_aggregate(x, seg, 50, weights=None, rows=src,
                                   t_seg=t_seg, t_rows=seg[t_order],
                                   t_weights=None)
        monkeypatch.setattr(module, "_lib", lambda: _FailingLib(real))
    with pytest.raises(RuntimeError, match="injected failure"):
        torch.autograd.grad(out.sum(), [x])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["fm", "gin-tu"])
def test_fm_and_gin_training_on_the_card_matches_the_cpu(cuda_device, arch):
    """The reduced config's train step (``launch.steps``) on the card and
    on the CPU from the same state: every gradient leaf within relative
    L1 1e-4, the parameters after three steps too; K4 and its backward
    launched once a step each and the embedding backward twice (the table
    and the linear table; no K5 launch), or K5 forward and backward once a
    layer (GIN)."""
    from repro_torch.configs.smoke import smoke_setup
    from repro_torch.data import criteo_like_batch
    from repro_torch.launch.steps import fm_train_step, gnn_train_step
    from repro_torch.models import gnn, recsys
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch0, family = smoke_setup(arch)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    models, steps = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        if family == "recsys":
            m = recsys.FM(cfg, seed=0, device=dev)
            steps[dev.type] = fm_train_step(m, ocfg)
        else:
            m = gnn.init_params(cfg, seed=0, device=dev)
            steps[dev.type] = gnn_train_step(m, ocfg)
        models[dev.type] = m
    for dst, src in zip(tree_leaves(models["cpu"].param_tree()),
                        tree_leaves(models["cuda"].param_tree())):
        with torch.no_grad():
            dst.copy_(src.cpu())
    states = {k: adamw_init(m.param_tree()) for k, m in models.items()}
    for i in range(3):
        batch = (criteo_like_batch(i, 32, cfg.n_fields, cfg.vocab_per_field)
                 if family == "recsys" else batch0)
        before = dict(LAUNCHES)
        _, states["cuda"], got = steps["cuda"](
            models["cuda"].param_tree(), states["cuda"], batch)
        torch.cuda.synchronize()
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if family == "recsys":
            assert delta["fm_interaction"] == delta["fm_interaction_bwd"] == 1
            assert delta["embedding_gather_bwd"] == 2
            assert delta["segment_sum"] == delta["segment_sum_carry"] == 0
        else:
            assert delta["segment_sum"] == delta["gnn_agg_bwd"] == (
                cfg.n_layers)
        _, states["cpu"], want = steps["cpu"](
            models["cpu"].param_tree(), states["cpu"], batch)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4)
        for a, b in zip(tree_leaves(states["cuda"]["m"]),
                        tree_leaves(states["cpu"]["m"])):
            assert _rel_l1(a.cpu(), b) <= 1e-4
    for a, b in zip(tree_leaves(models["cuda"].param_tree()),
                    tree_leaves(models["cpu"].param_tree())):
        assert _rel_l1(a.detach().cpu(), b.detach()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_aggregate_of_edge_messages_matches_plain(cuda_device, d,
                                                          masked):
    """The aggregation of built edge messages (MeshGraphNet's at d 128,
    EGNN's position update at d 3): K5's gather form over the
    destination sort's permutation, exact on integer-valued messages and
    within rtol / atol 1e-5 on normal ones, a relaunch bit-identical,
    one K5 launch each; its backward the gather ``w·g[dst]`` with no
    launch."""
    from repro_torch.data import make_gnn_batch
    from repro_torch.kernels.segment import segment_aggregate, segment_sum_ref
    from repro_torch.models import gnn

    n = 6_000
    b = make_gnn_batch(power_law_graph(n, seed=5), 2, n_classes=2)
    rng = np.random.default_rng(d + masked)
    if masked:
        b["edge_mask"] = (rng.random(b["src"].shape[0]) > 0.3).astype(
            np.float32)
    p = gnn.prepare_batch(b, cuda_device, "egnn")
    e = b["src"].shape[0]
    em = p["edge_mask"] if masked else None
    kw = dict(weights=em, order=p["dst_order"], sorted_ids=p["agg_dst"],
              sorted_weights=p["agg_w"] if masked else None)
    for exact in (True, False):
        msgs = (rng.integers(-8, 8, (e, d)) if exact
                else rng.standard_normal((e, d))).astype(np.float32)
        x = torch.from_numpy(msgs).to(cuda_device).requires_grad_(True)
        before = dict(LAUNCHES)
        got, again = (segment_aggregate(x, p["dst"], n, **kw)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert LAUNCHES["segment_sum"] - before["segment_sum"] == 2
        assert torch.equal(got, again)
        plain = segment_sum_ref(
            x.detach().cpu(), p["agg_dst"].cpu(), n,
            None if em is None else p["agg_w"].cpu(), p["dst_order"].cpu())
        if exact:
            assert torch.equal(got.detach().cpu(), plain)
        else:
            np.testing.assert_allclose(got.detach().cpu().numpy(),
                                       plain.numpy(), rtol=1e-5, atol=1e-5)
    g = torch.randn((n, d), device=cuda_device)
    before = dict(LAUNCHES)
    (gx,) = torch.autograd.grad(got, [x], g)
    assert LAUNCHES == before
    w = 1.0 if em is None else em[:, None]
    assert torch.equal(gx, g.index_select(0, p["dst"]) * w)


@pytest.mark.cuda
def test_triplet_aggregation_matches_plain(cuda_device):
    """DimeNet's triplet aggregation: K5's contiguous form over the
    triplets sorted by target edge, ``trip_mask`` the weight, padded to
    8·E as the cells pad them; exact on integer-valued messages, within
    rtol / atol 1e-5 on normal ones, a relaunch bit-identical."""
    from repro_torch.data import make_gnn_batch, pad_gnn_batch
    from repro_torch.kernels.segment import segment_aggregate, segment_sum_ref
    from repro_torch.models import gnn

    b = make_gnn_batch(power_law_graph(3_000, alpha=1.8, seed=2), 2,
                       with_pos=True, with_triplets=True)
    e = b["src"].shape[0]
    rng = np.random.default_rng(8)
    b["trip_mask"] = (rng.random(b["trip_e"].shape[0]) > 0.2).astype(
        np.float32)
    b = pad_gnn_batch(b, 3_008, -(-e // 512) * 512,
                      -(-e // 512) * 512 * 8)
    p = gnn.prepare_batch(b, cuda_device, "dimenet")
    t = p["trip_e"].shape[0]
    for exact in (True, False):
        inter = (rng.integers(-8, 8, (t, 128)) if exact
                 else rng.standard_normal((t, 128))).astype(np.float32)
        x = torch.from_numpy(inter).to(cuda_device)
        before = dict(LAUNCHES)
        got, again = (segment_aggregate(x, p["trip_e"], e,
                                        weights=p["trip_mask"])
                      for _ in range(2))
        torch.cuda.synchronize()
        assert LAUNCHES["segment_sum"] - before["segment_sum"] == 2
        assert torch.equal(got, again)
        plain = segment_sum_ref(x.cpu(), p["trip_e"].cpu(), e,
                                p["trip_mask"].cpu())
        if exact:
            assert torch.equal(got.cpu(), plain)
        else:
            np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_gathers_gradient_at_d128_is_bit_equal_on_a_relaunch(cuda_device):
    """``m[trip_f]``'s gradient (``embedding_gather``'s backward on
    ``embedding_bwd.cu``) at d 128: a relaunch bit-identical, exact on
    integer-valued g against the plain version, one launch a backward."""
    from repro_torch.data import make_gnn_batch
    from repro_torch.kernels.segment import embedding_gather, segment_sum_ref
    from repro_torch.models import gnn

    b = make_gnn_batch(power_law_graph(4_000, alpha=1.8, seed=3), 2,
                       with_pos=True, with_triplets=True)
    p = gnn.prepare_batch(b, cuda_device, "dimenet")
    e, t = b["src"].shape[0], b["trip_e"].shape[0]
    rng = np.random.default_rng(9)
    m = torch.from_numpy(rng.standard_normal((e, 128)).astype(
        np.float32)).to(cuda_device).requires_grad_(True)
    g = torch.from_numpy(rng.integers(-8, 8, (t, 128)).astype(
        np.float32)).to(cuda_device)
    got = []
    for plain in (False, False, True):
        kw = dict(segment_sum=segment_sum_ref) if plain else {}
        out = embedding_gather(m, p["trip_f"], p["trip_f_order"], **kw)
        before = dict(LAUNCHES)
        (gm,) = torch.autograd.grad(out, [m], g)
        torch.cuda.synchronize()
        assert LAUNCHES["embedding_gather_bwd"] - before[
            "embedding_gather_bwd"] == (0 if plain else 1)
        got.append(gm)
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["meshgraphnet", "egnn", "dimenet"])
def test_gnn_archs_training_on_the_card_matches_the_cpu(cuda_device, arch):
    """The reduced config's train step (``launch.steps``) on the card and
    on the CPU from the same state: the losses within rtol 1e-4, the
    AdamW moments and the parameters after three steps within relative L1
    1e-4; per step K5 and its carry once an aggregation (and once for the
    pooling) and ``embedding_gather_bwd`` once a gathered tensor that
    wants a gradient, no other kernel; the card's gradients bit-equal on
    a rerun."""
    from repro_torch.configs.smoke import smoke_setup
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.models import gnn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch0, _ = smoke_setup(arch)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    models = {dev.type: gnn.init_params(cfg, seed=0, device=dev)
              for dev in (cuda_device, torch.device("cpu"))}
    for dst, src in zip(tree_leaves(models["cpu"].param_tree()),
                        tree_leaves(models["cuda"].param_tree())):
        with torch.no_grad():
            dst.copy_(src.cpu())
    steps = {k: gnn_train_step(m, ocfg) for k, m in models.items()}
    states = {k: adamw_init(m.param_tree()) for k, m in models.items()}
    batches = {k: gnn.prepare_batch(batch0, m.device, arch)
               for k, m in models.items()}
    layers = cfg.n_layers
    k5 = (layers if arch == "meshgraphnet" else 2 * layers) + (
        cfg.task == "graph")
    emb = {"meshgraphnet": 2 * layers, "egnn": 4 * layers - 2,
           "dimenet": layers + 3}[arch]
    want = {"segment_sum": k5, "embedding_gather_bwd": emb}
    for i in range(3):
        before = dict(LAUNCHES)
        _, states["cuda"], got = steps["cuda"](
            models["cuda"].param_tree(), states["cuda"], batches["cuda"])
        torch.cuda.synchronize()
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k] and k != "segment_sum_carry"}
        assert delta == want
        _, states["cpu"], ref = steps["cpu"](
            models["cpu"].param_tree(), states["cpu"], batches["cpu"])
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=1e-4)
        for a, b in zip(tree_leaves(states["cuda"]["m"]),
                        tree_leaves(states["cpu"]["m"])):
            assert _rel_l1(a.cpu(), b) <= 1e-4
    for a, b in zip(tree_leaves(models["cuda"].param_tree()),
                    tree_leaves(models["cpu"].param_tree())):
        assert _rel_l1(a.detach().cpu(), b.detach()) <= 1e-4
    leaves = tree_leaves(models["cuda"].param_tree())
    runs = [torch.autograd.grad(gnn.loss_fn(models["cuda"], batches["cuda"]),
                                leaves, allow_unused=True) for _ in range(2)]
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)
