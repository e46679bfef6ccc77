"""Port parity for the K-PID engine (``engine:chunk`` / ``engine:bsr``)
against the JAX reference, on the CPU.

* The layout (``build_engine_arrays``) is array-equal to the reference's,
  tiled and untiled.
* The engine tile push (K2's plain twin over the engine visit table)
  matches the reference's ``_tile_push_stable`` through the Pallas gather
  kernel in interpret mode, before and after a bucket move, at the
  reference's own rtol/atol of 2e-4 (float32 sums in another order).
* The K2 visit table and the K3 edge table hold exactly the real tiles
  and edges, before and after a move.
* k=1 solves through the front door land within |Δx|_1 <= 1e-6 of the
  reference's with equal rounds and ``n_ops``.
* One subprocess runs the reference with 8 fake XLA devices on the
  replay configuration (k=8, dynamic, moves fire) and on a forced move
  (k=4), for both backends; the port, in process on the same layout
  (``repro_torch.interop.engine_from_arrays``), must make the identical
  move log and land within |Δx|_1 <= 1e-6 with equal rounds and
  ``n_ops`` — also when it takes over the reference's state right after
  the forced move.  Measured on this tree: rounds and ``n_ops`` agree
  exactly, so the test holds them equal.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import pagerank_system, power_law_graph
from repro.core.distributed import (
    EngineConfig as RefConfig,
    _tile_push_stable,
    build_engine_arrays as ref_build_engine_arrays,
)
from repro_torch.balance import BucketMoveExecutor, MovePlan
from repro_torch.core.distributed import (
    DistributedEngine,
    EngineConfig,
    build_engine_arrays,
)
from repro_torch.interop import engine_from_arrays

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

FIELDS = ("f0", "w", "src_slot", "dst_bucket", "dst_slot", "wgt",
          "pos_of_bucket", "node_of_slot")


def _skewed(n):
    g = power_law_graph(n, seed=7)
    g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    return pagerank_system(g)


@pytest.fixture(scope="module")
def skewed1200():
    return _skewed(1200)


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_engine_arrays_equal_reference(skewed1200, backend):
    p, b = skewed1200
    kw = dict(k=4, target_error=1e-6, eps=0.15, diffusion_backend=backend)
    ref = ref_build_engine_arrays(p, b, RefConfig(**kw))
    got = build_engine_arrays(p, b, EngineConfig(**kw, device="cpu"))
    names = FIELDS + (("tiles", "tile_dst", "slot_out_deg")
                      if backend == "bsr" else ())
    for name in names:
        want, have = getattr(ref, name), getattr(got, name)
        assert have.dtype == want.dtype, name
        assert np.array_equal(have, want), name
    assert (got.n, got.n_edges) == (ref.n, ref.n_edges)
    if backend == "segment_sum":
        assert ref.tiles is None and got.tiles is None


def _engine(p, b, backend, k=4, **kw):
    cfg = EngineConfig(k=k, target_error=1e-6, eps=0.15,
                       diffusion_backend=backend, device="cpu", **kw)
    eng = DistributedEngine(build_engine_arrays(p, b, cfg), cfg)
    return eng, BucketMoveExecutor(eng, eng.init_state())


def test_engine_tile_push_matches_pallas_gather(skewed1200):
    """K2's plain twin over the engine visit table against the reference's
    gather kernel (interpret mode), PID by PID, in the home layout and
    after a bucket move (the reference permutes its tiles with the move;
    the port keeps them home and rebuilds the visit table)."""
    import jax.numpy as jnp

    p, b = skewed1200
    eng, ex = _engine(p, b, "bsr")
    a, cfg = eng.a, eng.cfg
    tiles, b_loc = a.tiles, cfg.buckets_per_dev
    rng = np.random.default_rng(1)
    sent = rng.standard_normal((a.n_rows, a.bucket_size)).astype(np.float32)
    for moved in (False, True):
        if moved:
            assert ex.apply(MovePlan(src=0, dst=3, units=2,
                                     kind="bucket")) == 2
        rob = ex.row_of_bucket
        home_of_cur = np.empty(a.n_rows, dtype=np.int64)
        home_of_cur[rob] = a.pos_of_bucket
        bid_of_cur = np.empty(a.n_rows, dtype=np.int64)
        bid_of_cur[rob] = np.arange(a.n_rows)
        got = eng._push(ex.table, torch.from_numpy(sent)).numpy().reshape(
            cfg.k, a.n_rows, a.bucket_size)
        for pid in range(cfg.k):
            rows = home_of_cur[pid * b_loc:(pid + 1) * b_loc]
            want = _tile_push_stable(
                jnp.asarray(tiles[rows]), jnp.asarray(a.tile_dst[rows]),
                jnp.asarray(sent[pid * b_loc:(pid + 1) * b_loc]),
                a.n_rows, use_pallas=True, interpret=True)
            np.testing.assert_allclose(
                got[pid], np.asarray(want)[bid_of_cur], rtol=2e-4,
                atol=2e-4, err_msg=f"pid {pid}, moved {moved}")


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_push_tables_hold_only_real_work(skewed1200, backend):
    """The reference pads with zero-weight edges and all-zero tiles that
    all point at bucket 0; the port's tables list real work only."""
    p, b = skewed1200
    eng, ex = _engine(p, b, backend)
    a, cfg = eng.a, eng.cfg
    for step in range(2):
        if step:
            assert ex.apply(MovePlan(src=1, dst=2, units=2,
                                     kind="bucket")) == 2
        t = ex.table
        if backend == "bsr":
            real = int(a.t_counts.sum())
            nonzero = int((np.abs(a.tiles).sum(axis=(2, 3)) > 0).sum())
            assert t.n_visits == real == nonzero
            assert int(t.row_ptr[-1]) == real
            assert t.row_ptr.numel() == cfg.k * a.n_rows + 1
            assert len(set(t.visit_block.tolist())) == real
        else:
            assert t.n_edges == p.n_edges == int((a.wgt != 0).sum())
            assert int(t.indptr[-1]) == p.n_edges
            assert t.n == cfg.k * a.n_rows * a.bucket_size
            assert float(t.wgt.abs().min()) > 0


@pytest.mark.parametrize("method", ["engine:chunk", "engine:bsr"])
def test_k1_solve_matches_reference(skewed1200, method):
    p, b = skewed1200
    ref = repro.solve(repro.Problem.linear(p, b, eps=0.15), method=method,
                      k=1)
    got = repro_torch.solve(repro_torch.Problem.linear(p, b, eps=0.15),
                            method=method, k=1, device="cpu")
    assert got.converged and ref.converged
    assert np.abs(got.x - ref.x).sum() <= 1e-6
    assert got.n_rounds == ref.n_rounds
    assert got.n_ops == ref.n_ops
    assert got.move_log == ref.move_log == []


REF_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {src!r})
    import numpy as np
    from repro.core import pagerank_system, power_law_graph
    from repro.core.distributed import (
        DistributedEngine, EngineConfig, build_engine_arrays)
    from repro.balance import BucketMoveExecutor, MovePlan

    g = power_law_graph(1600, seed=7)
    g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    p, b = pagerank_system(g)
    out = {{}}

    def keep(prefix, arrs):
        for name in {fields!r}:
            out[prefix + name] = np.asarray(getattr(arrs, name))
        out[prefix + "n"] = arrs.n
        out[prefix + "n_edges"] = arrs.n_edges
        if arrs.tile_dst is not None:
            out[prefix + "tile_dst"] = arrs.tile_dst
            out[prefix + "slot_out_deg"] = arrs.slot_out_deg

    for be in ("segment_sum", "bsr"):
        cfg = EngineConfig(k=8, target_error=1e-8, eps=0.15,
                           buckets_per_dev=40, headroom=8, dynamic=True,
                           eta=0.9, diffusion_backend=be)
        arrs = build_engine_arrays(p, b, cfg)
        xs, info = DistributedEngine(arrs, cfg).solve()
        pre = "replay_" + be + "_"
        keep(pre, arrs)
        out[pre + "x"] = xs
        out[pre + "rounds"] = info["rounds"]
        out[pre + "ops"] = info["n_edge_ops"]
        out[pre + "converged"] = info["converged"]
        out[pre + "move_log"] = np.array(info["move_log"],
                                         dtype=np.int64).reshape(-1, 4)

        cfg = EngineConfig(k=4, target_error=1e-6, eps=0.15,
                           buckets_per_dev=12, headroom=4,
                           diffusion_backend=be)
        arrs = build_engine_arrays(p, b, cfg)
        eng = DistributedEngine(arrs, cfg)
        ex = BucketMoveExecutor(eng, eng.init_state())
        ex.state, _ = eng._chunk(ex.state, *ex.chunk_operands())
        assert ex.apply(MovePlan(src=0, dst=3, units=2, kind="bucket")) == 2
        pre = "forced_" + be + "_"
        keep(pre, arrs)
        out[pre + "f"] = np.asarray(ex.state.f)
        out[pre + "h"] = np.asarray(ex.state.h)
        out[pre + "t"] = np.asarray(ex.state.t)
        out[pre + "ops_at_move"] = np.asarray(ex.state.ops).astype(np.int64)
        out[pre + "rounds_at_move"] = int(np.asarray(ex.state.rounds))
        out[pre + "row_of_bucket"] = np.asarray(ex.row_of_bucket)
        tol = cfg.target_error * cfg.eps
        for _ in range(cfg.max_chunks):
            ex.state, stats = eng._chunk(ex.state, *ex.chunk_operands())
            resid = float(np.asarray(stats["residual"])) + float(
                np.asarray(stats["s"]).sum())
            if resid <= tol:
                break
        out[pre + "converged"] = resid <= tol
        out[pre + "x"] = eng.extract_solution(ex.state, ex.row_of_bucket)
        out[pre + "rounds"] = int(np.asarray(ex.state.rounds))
        out[pre + "ops"] = int(np.asarray(ex.state.ops).astype(np.int64).sum())
    np.savez({path!r}, **out)
    print("REF_OK")
    """
)


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    """The reference on 8 fake XLA devices, run once for the module."""
    path = str(tmp_path_factory.mktemp("engine") / "ref8.npz")
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run(
        [sys.executable, "-c",
         REF_SCRIPT.format(src=src, fields=FIELDS, path=path)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REF_OK" in r.stdout
    return dict(np.load(path))


def _fields(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _drain(eng, ex):
    tol = eng.cfg.target_error * eng.cfg.eps
    for _ in range(eng.cfg.max_chunks):
        ex.state, stats = eng.run_chunk(ex.state, *ex.chunk_operands())
        resid = float(stats["residual"]) + float(stats["s"].sum())
        if resid <= tol:
            return True
    return False


@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_replay_matches_reference_8_devices(ref8, backend):
    pre = f"replay_{backend}_"
    cfg = EngineConfig(k=8, target_error=1e-8, eps=0.15, buckets_per_dev=40,
                       headroom=8, dynamic=True, eta=0.9,
                       diffusion_backend=backend, device="cpu")
    eng, _ = engine_from_arrays(_fields(ref8, pre), cfg)
    x, info = eng.solve()
    assert info["converged"] and bool(ref8[pre + "converged"])
    want_log = [tuple(int(v) for v in row) for row in ref8[pre + "move_log"]]
    assert len(want_log) > 0, "the replay exercised no bucket moves"
    assert info["move_log"] == want_log
    assert np.abs(x - ref8[pre + "x"]).sum() <= 1e-6
    assert info["rounds"] == int(ref8[pre + "rounds"])
    assert info["n_edge_ops"] == int(ref8[pre + "ops"])


@pytest.mark.parametrize("carry", [False, True],
                         ids=["replayed", "carried"])
@pytest.mark.parametrize("backend", ["segment_sum", "bsr"])
def test_forced_move_matches_reference_8_devices(ref8, backend, carry):
    """A forced ``MovePlan(0 -> 3, 2 units)`` after the first chunk: the
    port either replays the chunk and the move itself, or takes over the
    reference's state right after the move; either way the solve runs on
    to the reference's answer, rounds and ``n_ops``."""
    pre = f"forced_{backend}_"
    cfg = EngineConfig(k=4, target_error=1e-6, eps=0.15, buckets_per_dev=12,
                       headroom=4, diffusion_backend=backend, device="cpu")
    fields = _fields(ref8, pre)
    if carry:
        state = {"f": fields["f"], "h": fields["h"], "t": fields["t"],
                 "row_of_bucket": fields["row_of_bucket"],
                 "ops": fields["ops_at_move"],
                 "rounds": fields["rounds_at_move"]}
        eng, ex = engine_from_arrays(fields, cfg, state=state)
    else:
        eng, ex = engine_from_arrays(fields, cfg)
        ex.state, _ = eng.run_chunk(ex.state, *ex.chunk_operands())
        assert ex.apply(MovePlan(src=0, dst=3, units=2, kind="bucket")) == 2
        assert np.array_equal(ex.row_of_bucket, fields["row_of_bucket"])
        assert ex.state.rounds == int(fields["rounds_at_move"])
        assert np.array_equal(ex.state.ops.numpy(), fields["ops_at_move"])
    assert _drain(eng, ex) and bool(fields["converged"])
    x = eng.extract_solution(ex.state, ex.row_of_bucket)
    assert np.abs(x - fields["x"]).sum() <= 1e-6
    assert ex.state.rounds == int(fields["rounds"])
    assert int(ex.state.ops.sum()) == int(fields["ops"])


def test_tile_engine_edges_equal_reference(skewed1200):
    """The host tile pool from the engine's edge buffers, as the
    reference's ``_tile_engine_edges``, in float32 and float64."""
    from repro.core.distributed import (
        _tile_engine_edges as ref_tile_engine_edges)
    from repro_torch.core.distributed import _tile_engine_edges

    p, b = skewed1200
    a = build_engine_arrays(p, b, EngineConfig(
        k=4, target_error=1e-6, eps=0.15, device="cpu"))
    for dtype in (np.float32, np.float64):
        args = (a.src_slot, a.dst_bucket, a.dst_slot, a.wgt, a.bucket_size,
                np.dtype(dtype))
        for want, have in zip(ref_tile_engine_edges(*args),
                              _tile_engine_edges(*args)):
            assert have.dtype == want.dtype and np.array_equal(have, want)
