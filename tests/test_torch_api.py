"""Port parity for the slice as a whole: the repro_torch front door
(Problem → solve / SolverSession) against the reference's, on the CPU.

The N=4096 fixture is tests/test_api.py's (webgraph_like(4096, seed=1),
target_error=2.5e-7).  Each of ``sequential``, ``frontier:segment_sum`` and
``frontier:pallas`` must land within |Δx|_1 <= 1e-6 of the reference's same
method.  ``n_ops`` is exact on ``sequential`` (both run the same numpy
schedule in float64).  On the frontier methods ``cost_iterations`` must
agree within 1%: XLA and torch add float32 in different orders, which can
flip a node sitting on the selection boundary and with it the schedule.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro_torch
import repro_torch.api
from repro.core import webgraph_like
from repro_torch.kernels import LAUNCHES
import torch

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

METHODS = ("sequential", "frontier:segment_sum", "frontier:pallas")
ENGINES = ("engine:bsr", "engine:chunk")

API_SURFACE = [
    "BackendCapabilities",
    "GraphStore",
    "Problem",
    "RoundReport",
    "SolveReport",
    "SolverOptions",
    "SolverSession",
    "get_backend",
    "list_backends",
    "register_backend",
    "solve",
]


@pytest.fixture(scope="module")
def web4096():
    g = webgraph_like(4096, seed=1)
    ref_problem = repro.Problem.pagerank(g, target_error=2.5e-7)
    problem = repro_torch.Problem.pagerank(g, target_error=2.5e-7)
    ref = {m: repro.solve(ref_problem, method=m) for m in METHODS}
    got = {m: repro_torch.solve(problem, method=m, device="cpu")
           for m in METHODS}
    return problem, ref, got


@pytest.mark.parametrize("method", METHODS)
def test_slice_parity_x(web4096, method):
    problem, ref, got = web4096
    rep = got[method]
    assert rep.converged and rep.method == method
    assert rep.x.shape == (problem.n,) and rep.x.dtype == np.float64
    l1 = np.abs(rep.x - ref[method].x).sum()
    assert l1 <= 1e-6, (method, l1)


@pytest.mark.parametrize("method", METHODS)
def test_slice_parity_ops(web4096, method):
    problem, ref, got = web4096
    rep, rr = got[method], ref[method]
    assert rep.cost_iterations == pytest.approx(rep.n_ops / problem.n_edges)
    if method == "sequential":
        assert rep.n_ops == rr.n_ops and rep.n_rounds == rr.n_rounds
    else:
        assert rep.cost_iterations == pytest.approx(rr.cost_iterations,
                                                    rel=0.01)


def test_slice_report_fields(web4096):
    _, _, got = web4096
    for method, rep in got.items():
        assert rep.trace and rep.trace[-1].n_ops == rep.n_ops
        assert rep.trace[-1].residual == pytest.approx(rep.residual)
        rounds = [t.round for t in rep.trace]
        assert rounds == sorted(rounds), method
        assert rep.wall_time_s > 0 and np.isfinite(rep.residual)
        assert rep.move_log == []


def test_api_surface_and_registry():
    assert sorted(repro_torch.api.__all__) == API_SURFACE
    assert sorted(repro_torch.__all__) == API_SURFACE
    for name in API_SURFACE:
        assert getattr(repro_torch, name) is getattr(repro_torch.api, name)
    caps = repro_torch.list_backends()
    assert tuple(caps) == tuple(sorted(METHODS + ENGINES + ("simulator",)))
    assert caps["frontier:pallas"].device_kinds == ("cuda",)
    assert caps["frontier:pallas"].tune_key == "frontier_round_bsr"
    assert caps["frontier:segment_sum"].supports_warm_start
    assert not caps["sequential"].supports_warm_start
    # multi-RHS batches run on frontier:segment_sum alone, as there
    assert [k for k, c in caps.items() if c.supports_batch] == [
        "frontier:segment_sum"]
    assert [k for k, c in caps.items() if c.configurable_k] == list(
        ENGINES) + ["simulator"]
    ref_caps = repro.list_backends()
    for key, c in caps.items():  # same keys, same roles as the reference
        assert (c.supports_warm_start
                == ref_caps[key].supports_warm_start)
        assert c.supports_batch == ref_caps[key].supports_batch
    assert repro_torch.get_backend("simulator").name == "simulator"
    with pytest.raises(KeyError):
        repro_torch.get_backend("engine:nope")


@pytest.mark.parametrize("method", ENGINES + ("simulator",))
def test_engine_backends_carry_the_reference_capabilities(method):
    """Everything but the device kinds (cpu/cuda here, cpu/gpu/tpu
    there) is the reference's: auto-dispatch ranks them the same way."""
    got = dataclasses.asdict(repro_torch.list_backends()[method])
    want = dataclasses.asdict(repro.list_backends()[method])
    assert got.pop("device_kinds") == ("cpu", "cuda")
    assert want.pop("device_kinds") == ("cpu", "gpu", "tpu")
    assert got == want


def test_auto_dispatch_reads_the_device():
    g = webgraph_like(300, seed=4)
    problem = repro_torch.Problem.pagerank(g)
    rep = repro_torch.solve(problem, device="cpu")
    assert rep.method == "frontier:segment_sum" and rep.converged
    cuda = dataclasses.replace(repro_torch.SolverOptions(device="cpu"))
    object.__setattr__(cuda, "device", "cuda")  # as on a machine with a card
    from repro_torch.api.registry import _auto_select

    assert _auto_select(problem, cuda) == "frontier:pallas"


def batched_problem(g):
    return repro_torch.Problem.pagerank(g, personalization=np.ones(
        (g.n, 2)) / g.n)


def test_validation_raises():
    g = webgraph_like(200, seed=5)
    problem = repro_torch.Problem.pagerank(g)
    with pytest.raises(ValueError, match="single-process"):
        repro_torch.solve(problem, method="sequential", k=4, device="cpu")
    with pytest.raises(ValueError, match="dynamic partition"):
        repro_torch.solve(problem, method="frontier:segment_sum",
                          dynamic=True, device="cpu")
    # a batch runs on frontier:segment_sum alone, which has no k
    with pytest.raises(ValueError, match="no registered backend"):
        repro_torch.solve(batched_problem(g), device="cpu", k=2)
    with pytest.raises(ValueError, match="one-shot"):
        repro_torch.SolverSession(problem, "sequential", device="cpu")
    with pytest.raises(ValueError, match="device must be"):
        repro_torch.SolverOptions(device="mps")
    pref = np.ones((g.n, 2)) / g.n
    batched = repro_torch.Problem.pagerank(g, personalization=pref)
    with pytest.raises(ValueError, match="multi-RHS"):
        repro_torch.solve(batched, method="frontier:pallas", device="cpu")
    session = repro_torch.SolverSession(problem, "frontier:segment_sum",
                                        device="cpu")
    with pytest.raises(ValueError, match="b_new has shape"):
        session.warm_start(problem.b[:-1])


def test_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch.solve import main

    rep = main(["--n", "600", "--device", "cpu", "--method",
                "frontier:pallas"])
    assert rep.converged
    assert "[frontier:pallas] converged=True" in capsys.readouterr().out
    rep = main(["--n", "600", "--device", "cpu", "--simulate"])
    assert rep.converged and rep.method == "simulator"
    assert "[simulator] converged=True" in capsys.readouterr().out


def test_cli_runs_the_engine_on_the_cpu(capsys):
    from repro_torch.launch.solve import main

    rep = main(["--n", "600", "--device", "cpu", "--k", "4", "--dynamic",
                "-m", "engine:chunk", "--signal", "edge-ops",
                "--buckets-per-dev", "6"])
    assert rep.converged and rep.method == "engine:chunk"
    assert "[engine:chunk] converged=True" in capsys.readouterr().out
    rep = main(["--n", "600", "--device", "cpu", "--k", "2", "--verbose"])
    assert rep.converged and rep.method == "engine:chunk"  # auto: k > 1
    assert "chunk 1: residual=" in capsys.readouterr().out
    rep = main(["--n", "600", "--device", "cpu", "-m", "simulator", "--k",
                "4", "--dynamic", "--partition", "cb", "--signal",
                "edge-ops"])
    assert rep.converged and rep.method == "simulator"
    assert "[simulator] converged=True" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--partition needs the simulator"):
        main(["--n", "600", "--device", "cpu", "--k", "4", "-m",
              "engine:bsr", "--partition", "cb"])


@pytest.mark.parametrize("flag", [
    ["--signal", "edge-ops"], ["--partition", "cb"],
    ["--buckets-per-dev", "4"], ["--verbose"],
])
def test_cli_rejects_engine_flags(flag):
    """The engine's and the simulator's flags stay on the CLI; a frontier
    run does not read them, so a non-default value is rejected before any
    solve, never ignored."""
    from repro_torch.launch.solve import main

    with pytest.raises(SystemExit, match=f"{flag[0]} needs the"):
        main(["--n", "600", "--device", "cpu", "-m", "frontier:pallas"]
             + flag)


def test_options_carry_only_fields_a_backend_reads(monkeypatch):
    fields = {f.name for f in dataclasses.fields(repro_torch.SolverOptions)}
    ref = {f.name for f in dataclasses.fields(repro.SolverOptions)}
    assert fields == ref | {"device"}
    for name in fields & ref:  # the reference's defaults
        assert (getattr(repro_torch.SolverOptions(device="cpu"), name)
                == getattr(repro.SolverOptions(), name)), name
    with pytest.raises(ValueError, match="unknown partition"):
        repro_torch.SolverOptions(device="cpu", partition="nope").validated()
    with pytest.raises(ValueError, match="unknown mode"):
        repro_torch.SolverOptions(device="cpu", mode="nope").validated()
    with pytest.raises(ValueError, match="unknown signal"):
        repro_torch.SolverOptions(device="cpu", signal="nope").validated()
    with pytest.raises(ValueError, match="unknown engine dtype"):
        repro_torch.SolverOptions(device="cpu", dtype="int8").validated()
    assert repro_torch.SolverOptions(device="cpu",
                                     dtype="float64").validated()
    # as on a machine with a card: the kernels there are float32 only
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="float32 only"):
        repro_torch.SolverOptions(dtype=torch.float64).validated()


def test_cpu_solves_launch_no_kernel():
    before = dict(LAUNCHES)
    g = webgraph_like(300, seed=6)
    problem = repro_torch.Problem.pagerank(g)
    for method in METHODS:
        repro_torch.solve(problem, method=method, device="cpu")
    for method in ENGINES + ("simulator",):
        repro_torch.solve(problem, method=method, device="cpu", k=2,
                          dynamic=True)
    session = repro_torch.SolverSession(problem, "frontier:pallas",
                                        device="cpu", interpret=True, bs=64)
    session.solve()
    session.warm_start(problem.b * 1.01)
    session.solve()
    assert LAUNCHES == before


def test_simulator_solve_matches_the_reference():
    """``solve(problem, "simulator", k=4, dynamic=True)`` on the CPU (K7's
    plain push) against the reference's: the same schedule, so equal
    counters and move log, and h within 1e-10."""
    g = webgraph_like(1024, seed=1)
    ref = repro.solve(repro.Problem.pagerank(g), "simulator", k=4,
                      dynamic=True)
    got = repro_torch.solve(repro_torch.Problem.pagerank(g), "simulator",
                            k=4, dynamic=True, device="cpu")
    assert got.converged and ref.converged
    assert (got.n_ops, got.n_rounds, got.move_log) == (
        ref.n_ops, ref.n_rounds, ref.move_log)
    assert got.cost_iterations == ref.cost_iterations
    assert float(np.abs(got.x - ref.x).sum()) <= 1e-10
    assert set(got.extras) == set(ref.extras)
    for key in ("cost_steps_iterations", "n_exchanges", "n_moves"):
        assert got.extras[key] == ref.extras[key], key
    for key in ("count_active", "count_idle", "hist_sizes"):
        np.testing.assert_array_equal(got.extras[key], ref.extras[key])
    np.testing.assert_allclose(got.extras["hist_rs"], ref.extras["hist_rs"],
                               rtol=1e-12, atol=1e-18)
    assert [(r.round, r.n_ops) for r in got.trace] == [
        (r.round, r.n_ops) for r in ref.trace]
