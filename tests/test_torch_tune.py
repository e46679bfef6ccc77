"""Port parity for the tuner of K1 and K2 (``repro_torch.kernels.tune``).

Each comparison runs ``repro.kernels.tune`` in the same process: the cost
model's numbers exactly (the same float arithmetic), the sweep problem's
arrays exactly, the record round trip, the winner rule, and the engine's
``pallas_buffer_depth`` resolved from a ``bsr_gather_spmm`` record in
both packages.  K1's and K2's plain versions (the CPU path) have no ring:
they give the same result at every depth, and are held to the
reference's Pallas kernels run in interpret mode at depths 1 and 2 with
``tests/test_kernels.py``'s bounds (rtol = atol = 2e-4).  The depths'
bit-identity on the card is in test_torch_cuda.py.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.kernels.diffusion as rd
import repro.kernels.tune as rt
from repro.kernels.tune import model as rmodel
from repro.kernels.tune import sweep as rsweep
import repro_torch
import repro_torch.kernels.diffusion as td
import repro_torch.kernels.tune as tt
from repro_torch.kernels.tune import model, sweep

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


@pytest.fixture()
def tune_dirs(tmp_path, monkeypatch):
    """Both packages' tune directories under tmp_path, caches cleared."""
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path / "port"))
    rt.clear_cache()
    tt.clear_cache()
    yield tmp_path
    rt.clear_cache()
    tt.clear_cache()


# --------------------------------------------------------------------------- #
# the cost model
# --------------------------------------------------------------------------- #
def test_platform_specs_keep_the_reference_entries():
    for name, ref in rmodel.PLATFORM_SPECS.items():
        got = model.PLATFORM_SPECS[name]
        assert (got.name, got.peak_flops, got.mem_bw, got.smem_budget) == (
            ref.name, ref.peak_flops, ref.mem_bw, ref.vmem_budget)
    cuda = model.PLATFORM_SPECS["cuda"]
    assert (cuda.peak_flops, cuda.mem_bw, cuda.smem_budget) == (
        67e12, 3.35e12, 232_448)


GRID = [(nrb, bs, c, act) for nrb in (1, 16, 8192) for bs in (8, 32, 128, 256)
        for c in (1, 3, 16) for act in (0, 5, 40_000)]


@pytest.mark.parametrize("nrb,bs,c,act", GRID)
def test_cost_functions_match_the_reference(nrb, bs, c, act):
    for fn in ("frontier_round_cost", "gather_spmm_cost"):
        got = getattr(model, fn)(nrb, bs, c, act)
        ref = getattr(rmodel, fn)(nrb, bs, c, act)
        assert (got.bytes_tiles, got.bytes_fluid, got.flops) == (
            ref.bytes_tiles, ref.bytes_fluid, ref.flops)
        assert got.total_bytes == ref.total_bytes
        assert got.arithmetic_intensity == ref.arithmetic_intensity
        for plat in rmodel.PLATFORM_SPECS:
            spec, rspec = model.PLATFORM_SPECS[plat], rmodel.PLATFORM_SPECS[
                plat]
            assert model.ideal_time_s(got, spec) == rmodel.ideal_time_s(
                ref, rspec)
            assert model.dma_compute_ratio(got, spec) == \
                rmodel.dma_compute_ratio(ref, rspec)
    for measured in (0.0, 1e-6, 3.5e-3):
        assert model.roofline_fraction(measured, 1e-4) == \
            rmodel.roofline_fraction(measured, 1e-4)


@pytest.mark.parametrize("kernel", ["frontier_round_bsr", "bsr_gather_spmm"])
def test_smem_rule_is_the_depth1_route_rule(kernel):
    """At depth 1 the model's bytes are the route rule's (the 3-stage
    ring); each stage adds a slab, an x slot and its barriers; a depth past
    the deepest instance, or a ring over the budget, has no body."""
    for bs in (4, 8, 32, 64, 128, 256, 512):
        for c in (1, 8):
            one = model.smem_bytes(kernel, bs, c, 1)
            assert one == model.smem_bytes(kernel, bs, c, 3)
            slab = min(bs, max(1, model.SLAB_BYTES // (bs * 4))) * bs * 4
            slot = 4 * bs * (c + 1 if kernel == "frontier_round_bsr" else c)
            assert (model.smem_bytes(kernel, bs, c, 4) - one
                    == slab + slot + 32)
            for depth in range(1, 11):
                body = model.route(kernel, bs, c, depth)
                fits = (depth <= model.MAX_STAGES and model.smem_bytes(
                    kernel, bs, c, depth) <= 232_448)
                assert body == ("bulk" if fits else
                                "simt" if depth == 1 else None)
    assert model.route(kernel, 7, 1, 1) == "simt"
    assert model.route(kernel, 7, 1, 2) is None
    assert model.route(kernel, 128, 1, 2, aligned=False) is None
    assert not model.smem_ok(kernel, 256, 1, 8)
    with pytest.raises(ValueError, match="buffer_depth"):
        model.ring_stages(0)


def test_ctas_per_sm_counts_what_one_sm_holds():
    """Two CTAs an SM while two rings fit the SM's 228 KiB (each with the
    driver's 1 KiB), one past that: K1 at bs=128 holds two at depths 1 and
    2 and one at depth 4."""
    k1 = "frontier_round_bsr"
    assert [model.ctas_per_sm(k1, 128, 1, d) for d in (1, 2, 4)] == [2, 2, 1]
    assert model.ctas_per_sm(k1, 256, 1, 8) == 0
    for kernel in (k1, "bsr_gather_spmm"):
        for bs in (32, 64, 128, 256, 512):
            for d in (1, 2, 3, 4, 5, 6):
                n = model.ctas_per_sm(kernel, bs, 1, d)
                if not model.smem_ok(kernel, bs, 1, d):
                    assert n == 0
                    continue
                need = model.smem_bytes(kernel, bs, 1, d) + 1024
                assert n == (2 if 2 * need <= 233_472 else 1)


# --------------------------------------------------------------------------- #
# the sweep
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bs", [32, 64])
def test_sweep_problem_matches_the_reference(bs):
    """The same graph (a host a block row at every bs), tiles, fluid and
    weights as the reference's _problem, and the same armed tile counts."""
    m_ref, f_ref, w_ref, t_ref = rsweep._problem(1024, bs, 2, 0.25, 3)
    m, f, w, t = sweep._problem(1024, bs, 2, 0.25, 3)
    np.testing.assert_array_equal(m.blocks.numpy(), np.asarray(m_ref.blocks))
    np.testing.assert_array_equal(m.block_col.numpy(),
                                  np.asarray(m_ref.block_col))
    np.testing.assert_array_equal(m.block_row.numpy(),
                                  np.asarray(m_ref.block_row))
    assert (m.n_row_blocks, m.bs) == (m_ref.n_row_blocks, m_ref.bs)
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    assert float(t) == float(t_ref)
    for occ in (0.0, 0.3):
        assert sweep._n_active_blocks(m, f, w, t, occ) == \
            rsweep._n_active_blocks(m_ref, f_ref, w_ref, t_ref, occ)


def test_sweep_writes_a_record_the_drivers_read(tune_dirs):
    """``python -m repro_torch.kernels.tune --smoke --device cpu``'s sweep:
    the record validates, reads back and resolves under the options."""
    rec = tt.run_sweep("frontier_round_bsr", n=1024, bs_list=(32, 64),
                       depths=(1, 2), iters=1, verbose=False, device="cpu")
    tt.validate_record(rec)
    assert rec["platform"] == "cpu" and rec["timing_path"] == "plain"
    assert rec["torch_version"] == torch.__version__
    assert len(rec["sweep"]) == 4
    assert all(r["measured_us"] > 0 for r in rec["sweep"])
    on_disk = json.loads(tt.record_path("frontier_round_bsr", "cpu")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert tt.load_record("frontier_round_bsr", "cpu") == on_disk
    best = tt.best_config("frontier_round_bsr", "cpu")
    win = rec["best"]
    assert (best.bs, best.buffer_depth, best.measured_us) == (
        win["bs"], win["buffer_depth"], win["measured_us"])
    # the plain versions have no ring: a bs's depths share one time, and
    # the shallower depth wins the tie
    assert best.buffer_depth == 1
    assert win["smem_bytes"] == model.smem_bytes("frontier_round_bsr",
                                                 win["bs"], 1, 1)
    assert tt.resolved_config("frontier_round_bsr", platform="cpu") == (
        win["bs"], 1, 0.0)
    assert tt.resolved_config("frontier_round_bsr", platform="cpu",
                              bs=128, buffer_depth=4) == (128, 4, 0.0)
    assert tt.resolved_config("frontier_round_bsr", platform="cuda") == (
        128, 1, 0.0)


def test_tune_cli_smoke_saves_both_records(tune_dirs, capsys):
    from repro_torch.kernels.tune.__main__ import main

    assert main(["--smoke", "--device", "cpu"]) == 0
    for kernel in tt.KERNELS:
        assert tt.load_record(kernel, "cpu") is not None
    assert '"buffer_depth"' in capsys.readouterr().out


def test_sweep_never_times_an_infeasible_row(tune_dirs, monkeypatch):
    """Under a budget that holds only bs=32's 2-stage ring, the deeper
    rings are infeasible and untimed (depth 1 keeps the simt body, which
    has no ring), and the winner is a timed row; under a budget that holds
    no body, the sweep raises."""
    k2 = "bsr_gather_spmm"
    budget = model.smem_bytes(k2, 32, 1, 2)
    monkeypatch.setitem(model.PLATFORM_SPECS, "cpu",
                        model.HwSpec("tiny", 2e11, 4e10, budget))
    timed = []
    real = sweep._measure

    def spy(kernel, m, f, w, t, depth, *rest):
        timed.append((m.bs, depth))
        return real(kernel, m, f, w, t, depth, *rest)

    monkeypatch.setattr(sweep, "_measure", spy)
    rec = tt.run_sweep(k2, n=1024, bs_list=(32, 64), depths=(1, 2, 4),
                       iters=1, verbose=False, device="cpu", save=False)
    feasible = {(r["bs"], r["buffer_depth"]): r["feasible"]
                for r in rec["sweep"]}
    assert feasible == {(32, 1): True, (32, 2): True, (32, 4): False,
                        (64, 1): True, (64, 2): False, (64, 4): False}
    assert [r["route"] for r in rec["sweep"]] == [
        "simt", "bulk", None, "simt", None, None]
    assert timed == [(32, 1), (32, 2), (64, 1)]
    for r in rec["sweep"]:
        assert (r["measured_us"] is None) == (not r["feasible"])
    assert rec["best"]["buffer_depth"] == 1
    assert rec["best"]["smem_bytes"] == model.simt_smem_bytes(
        k2, rec["best"]["bs"], 1)
    monkeypatch.setitem(model.PLATFORM_SPECS, "cpu",
                        model.HwSpec("none", 2e11, 4e10, 16))
    with pytest.raises(RuntimeError, match="no feasible config"):
        tt.run_sweep(k2, n=1024, bs_list=(32,), depths=(1,), iters=1,
                     verbose=False, device="cpu", save=False)


def test_winner_rule_is_the_reference_rule():
    rows = [
        {"bs": 32, "buffer_depth": 1, "measured_us": 5.0},
        {"bs": 64, "buffer_depth": 4, "measured_us": 3.0},
        {"bs": 128, "buffer_depth": 2, "measured_us": 3.0},
        {"bs": 256, "buffer_depth": 2, "measured_us": 3.0},
        {"bs": 64, "buffer_depth": 2, "measured_us": 3.5},
    ]
    assert sweep._winner(rows) is rows[3]
    # what the reference's run_sweep picks among the same rows
    ref = min(rows, key=lambda r: (r["measured_us"], r["buffer_depth"],
                                   -r["bs"]))
    assert sweep._winner(rows) is ref
    assert sweep._winner(rows[:1] + rows[4:]) is rows[4]


# --------------------------------------------------------------------------- #
# the depth on the CPU path, against the reference's interpret kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bs", [32, 64])
def test_k1_plain_path_equal_across_depths_and_the_reference(bs):
    m_ref, f_ref, w_ref, t_ref = rsweep._problem(1024, bs, 1, 0.25, 1)
    m, f, w, t = sweep._problem(1024, bs, 1, 0.25, 1)
    outs = [td.frontier_round_bsr(m, f, w, t, backend="kernel",
                                  buffer_depth=d) for d in (1, 2, 4)]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    for depth in (1, 2):
        fr, sr, rr = rd.frontier_round_bsr(
            m_ref, f_ref, w_ref, t_ref, backend="pallas", interpret=True,
            buffer_depth=depth)
        fo, so, ro = outs[0]
        np.testing.assert_array_equal(so.numpy(), np.asarray(sr))
        np.testing.assert_allclose(fo.numpy(), np.asarray(fr), rtol=2e-4,
                                   atol=2e-4)
        assert abs(float(ro) - float(rr)) <= 1e-3 * max(float(rr), 1.0)
    with pytest.raises(ValueError, match="buffer_depth"):
        td.frontier_round_bsr(m, f, w, t, backend="kernel", buffer_depth=0)


@pytest.mark.parametrize("bs", [32, 64])
def test_k2_plain_path_equal_across_depths_and_the_reference(bs):
    m_ref, f_ref, _, _ = rsweep._problem(1024, bs, 2, 0.25, 2)
    m, f, _, _ = sweep._problem(1024, bs, 2, 0.25, 2)
    x = f.reshape(m.n_row_blocks, bs, 2).contiguous()
    outs = [td.bsr_spmm_kernel(m.blocks, m.visit_block, m.block_col,
                               m.row_ptr, x, buffer_depth=d)
            for d in (1, 2, 4)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    order = jnp.arange(m_ref.n_blocks, dtype=jnp.int32)
    occ = m.row_occupied.numpy()
    for depth in (1, 2):
        ref = np.asarray(rd.bsr_gather_spmm_pallas(
            m_ref.blocks, order, m_ref.block_row, m_ref.block_col,
            jnp.asarray(x.numpy()), m_ref.n_row_blocks, bs=bs,
            interpret=True, buffer_depth=depth))
        np.testing.assert_allclose(outs[0].numpy()[occ], ref[occ],
                                   rtol=2e-4, atol=2e-4)
    assert bool((outs[0][~m.row_occupied] == 0).all())
    with pytest.raises(ValueError, match="buffer_depth"):
        td.bsr_spmm_kernel(m.blocks, m.visit_block, m.block_col, m.row_ptr,
                           x, buffer_depth=0)


# --------------------------------------------------------------------------- #
# records reach the engine
# --------------------------------------------------------------------------- #
def _record(pkg, kernel, platform, depth):
    best = {"bs": 64, "buffer_depth": depth, "occupancy_threshold": 0.0,
            "measured_us": 10.0, "throughput_gflops": 1.0,
            "roofline_fraction": 0.5}
    rec = {"version": 1, "kernel": kernel, "platform": platform,
           "device_kind": "cpu", "created_utc": "2026-01-01T00:00:00",
           "timing_path": "plain", "problem": {"n": 1024}, "sweep": [],
           "best": best}
    if pkg is rt:
        rec["jax_version"] = "0"
        best["vmem_bytes"] = 0
    else:
        rec["torch_version"] = torch.__version__
        best["smem_bytes"] = 0
    return pkg.save_record(rec)


def test_engine_resolves_its_depth_from_the_record_in_both_packages(
        tune_dirs):
    """engine:bsr's pallas_buffer_depth: the explicit option, else the
    bsr_gather_spmm record, else 1, in both packages alike; the solve at a
    recorded depth 2 gives the bits of depth 1 (the plain K2 has no
    ring)."""
    from repro.core import host_block_graph

    g = host_block_graph(2048, seed=0)
    ref_p = repro.Problem.pagerank(g)
    port_p = repro_torch.Problem.pagerank(
        repro_torch.core.host_block_graph(2048, seed=0))

    def depths(**kw):
        ref = repro.SolverSession(ref_p, "engine:bsr", k=1, **kw)
        port = repro_torch.SolverSession(port_p, "engine:bsr", k=1,
                                         device="cpu", **kw)
        return (ref._driver.cfg.pallas_buffer_depth,
                port._driver.cfg.pallas_buffer_depth), port

    (got, port_plain) = depths()
    assert got == (1, 1)
    x1 = port_plain.solve().x
    _record(rt, "bsr_gather_spmm", "cpu", 2)
    _record(tt, "bsr_gather_spmm", "cpu", 2)
    got, port = depths()
    assert got == (2, 2)
    assert np.array_equal(port.solve().x, x1)
    assert depths(buffer_depth=4)[0] == (4, 4)
    # a frontier record does not steer the engine, nor a record for
    # another platform
    rt.clear_cache()
    tt.clear_cache()
    (tune_dirs / "ref" / "bsr_gather_spmm__cpu.json").unlink()
    (tune_dirs / "port" / "bsr_gather_spmm__cpu.json").unlink()
    _record(rt, "frontier_round_bsr", "cpu", 2)
    _record(tt, "frontier_round_bsr", "cpu", 2)
    _record(tt, "bsr_gather_spmm", "cuda", 4)
    assert depths()[0] == (1, 1)
