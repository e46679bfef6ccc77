"""The port stands alone: it imports neither JAX nor the reference
package, needs no nvcc or card to import, never falls back from the card
to the CPU, and launches no kernel for CPU tensors."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_import_and_solve_with_jax_and_reference_blocked():
    """Solves (the simulator's too), the paper-tables and policy-ablation
    modules, an FM forward, a GIN forward and an LM prefill + decode step
    on the CPU, with jax and the reference unimportable, load no kernel
    library."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch
from repro_torch.core import webgraph_like
from repro_torch.kernels import _build

p = repro_torch.Problem.pagerank(webgraph_like(300, seed=1))
for m in ("sequential", "frontier:segment_sum", "frontier:pallas"):
    rep = repro_torch.solve(p, method=m, device="cpu")
    assert rep.converged, m
for m in ("engine:chunk", "engine:bsr", "simulator"):
    rep = repro_torch.solve(p, method=m, device="cpu", k=2, dynamic=True)
    assert rep.converged, m
import tempfile
from repro_torch.launch import paper_tables, policy_ablation

table = paper_tables.run_table("out_degree", n=200, ks=(2,), device="cpu",
                               verbose=False)
with tempfile.TemporaryDirectory() as out:
    paper_tables.write_csv(table, out + "/table2.csv")
ablation = policy_ablation.run_ablation("random", n=200, ks=(2,),
                                        device="cpu", verbose=False)
assert len(table) == 4 and len(ablation) == 4
from repro_torch.core import power_law_graph
from repro_torch.data import criteo_like_batch, make_gnn_batch
from repro_torch.models import gnn, recsys

fm = recsys.FM(recsys.FMConfig(name="fm", n_fields=4, vocab_per_field=20,
                               embed_dim=3), device="cpu")
logits = recsys.forward_logits(fm, criteo_like_batch(0, 9, 4, 20)["ids"])
assert logits.shape == (9,) and bool(logits.isfinite().all())
cfg = gnn.GNNConfig(name="g", arch="gin", n_layers=2, d_hidden=8, d_feat=5,
                    n_classes=3)
out = gnn.forward(gnn.init_params(cfg, device="cpu"),
                  make_gnn_batch(power_law_graph(60, seed=1), 5, n_classes=3))
assert out.shape == (60, 3) and bool(out.isfinite().all())
from repro_torch.configs import get_arch
from repro_torch.configs.smoke import lm_shrink
from repro_torch.data import lm_token_batch
from repro_torch.models import transformer

lm = transformer.init_params(lm_shrink(get_arch("qwen1.5-0.5b").model_cfg),
                             device="cpu")
cache, logits = transformer.prefill_step(
    lm, lm_token_batch(0, 2, 9, 128)["tokens"], max_seq=10)
logits, cache = transformer.decode_step(lm, cache, logits.argmax(-1))
assert logits.shape == (2, 128) and bool(logits.isfinite().all())
assert not _build._LIBS, "a kernel library was loaded for a CPU run"
assert not any(k.split(".")[0] in ("jax", "repro", "triton")
               and sys.modules[k] is not None for k in sys.modules)
print("ok")
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_serving_runs_with_jax_and_reference_blocked():
    """Graph deltas, update_graph, solve_batch, the continuous-batching
    scheduler (an update at its drain barrier, a poison request) and
    ``serve rank`` on the CPU, with jax and the reference unimportable,
    load no kernel library."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch
from repro_torch.core import webgraph_like
from repro_torch.graph import rotation_churn
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.resilience import RequestRejected
from repro_torch.serving import Scheduler, solo_reference

p = repro_torch.Problem.pagerank(webgraph_like(300, seed=1))
s = repro_torch.SolverSession(p, device="cpu")
s.solve()
s.update_graph(rotation_churn(s.problem.graph, 4, seed=0))
assert s.solve().converged
batch = s.solve_batch(np.stack([p.b, 2 * p.b], axis=1))
assert batch.converged and batch.x.shape == (300, 2)
p = repro_torch.Problem.pagerank(webgraph_like(300, seed=1))
sch = Scheduler(p, max_lanes=2, device="cpu")
sch.submit(p.b, request_id=0)
sch.run_until_idle()
sch.submit_update(rotation_churn(sch.problem.graph, 3, seed=1))
try:
    sch.submit(np.full(300, np.nan), request_id=1)
except RequestRejected:
    pass
sch.submit(p.b, request_id=2)
sch.run_until_idle()
assert [r.request_id for r in sch.results] == [0, 2]
assert sch.applied_updates == 1 and sch.quarantine.total == 1
x, ops, _ = solo_reference(sch.problem, p.b[:, None], device="cpu")
assert ops[0] > 0
serve.main(["rank", "--device", "cpu", "--n", "200", "--requests", "3",
            "--churn", "0.01"])
assert not _build._LIBS, "a kernel library was loaded for a CPU run"
assert not any(k.split(".")[0] in ("jax", "repro", "triton")
               and sys.modules[k] is not None for k in sys.modules)
print("ok")
"""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_default_options_ask_for_the_card():
    import repro_torch

    if torch.cuda.is_available():
        assert repro_torch.SolverOptions().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.SolverOptions()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.solve(repro_torch.Problem.pagerank(
                repro_torch.core.webgraph_like(50, seed=0)))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
