"""Port parity for checkpoints: the store (atomic commit, retention, torn
and ``.tmp`` steps, the async writer), checkpoints crossing between the
port and the JAX reference in both directions, and restore's rejection
reasons against the reference's on the same directories.  Everything
runs on the CPU, on ``webgraph_like`` graphs of n <= 1024.
"""
import builtins
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.checkpoint import store as ref_store
from repro.core import webgraph_like
from repro.graph import GraphStore as RefStore
from repro.graph import rotation_churn as ref_churn
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    list_steps, load_checkpoint,
                                    save_checkpoint)
from repro_torch.chaos import tear_checkpoint
from repro_torch.graph import GraphStore, rotation_churn

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

N = 1024


def _tree(rng):
    return {"h": rng.standard_normal(5), "b": rng.standard_normal(5),
            "t": np.float64(0.5), "f": rng.standard_normal(5),
            "nested": [rng.standard_normal(2), (np.arange(3), None)]}


def _files(step_dir):
    return sorted(os.listdir(step_dir))


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #
def test_leaf_order_and_manifest_equal_reference(tmp_path):
    """Both packages flatten a tree into the same arr_* files (dict keys
    sorted, sequences in order, None holding no leaf) with the same
    manifest keys; each loads the other's step."""
    tree = _tree(np.random.default_rng(0))
    mine = save_checkpoint(str(tmp_path / "port"), 7, tree, {"a": 1})
    ref = ref_store.save_checkpoint(str(tmp_path / "ref"), 7, tree, {"a": 1})
    assert os.path.basename(mine) == os.path.basename(ref) == "step_000000007"
    assert _files(mine) == _files(ref)
    for name in _files(ref):
        if name.endswith(".npy"):
            a, b = np.load(os.path.join(mine, name)), np.load(
                os.path.join(ref, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    with open(os.path.join(mine, "manifest.json")) as f:
        m_port = json.load(f)
    with open(os.path.join(ref, "manifest.json")) as f:
        m_ref = json.load(f)
    assert set(m_port) == set(m_ref)
    assert {k: m_port[k] for k in m_port if k != "treedef"} == {
        k: m_ref[k] for k in m_ref if k != "treedef"}
    # arr_00002 is the h leaf: the one tear_checkpoint zeroes
    np.testing.assert_array_equal(
        np.load(os.path.join(mine, "arr_00002.npy")), tree["h"])
    for loader, root in ((load_checkpoint, str(tmp_path / "ref")),
                         (ref_store.load_checkpoint, str(tmp_path / "port"))):
        got, step, extra = loader(root, tree)
        assert step == 7 and extra == {"a": 1}
        assert got["nested"][1][1] is None
        for key in ("b", "f", "h"):
            np.testing.assert_array_equal(got[key], tree[key])


def test_load_into_tensor_leaves(tmp_path):
    """A tensor leaf of ``tree_like`` comes back as a tensor of its dtype
    on its device."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": np.int64(3)}
    save_checkpoint(str(tmp_path), 1, tree)
    like = {"w": torch.zeros(2, 3, dtype=torch.float64), "n": np.int64(0)}
    got, _, _ = load_checkpoint(str(tmp_path), like)
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], tree["w"].double())
    assert int(got["n"]) == 3


def _bf16_values():
    """bfloat16 values with every kind of bit pattern: signs, a zero of
    each sign, subnormals, the largest finite, inf and a NaN."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(40) * 10.0 ** rng.integers(
        -30, 30, 40), [0.0, -0.0, 1e-40, -3e38, np.inf, np.nan, 1.5, -2.0]])
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def test_reference_bf16_leaf_loads_bit_for_bit(tmp_path):
    """A bfloat16 leaf the reference writes (an ``.npy`` that numpy reads
    as ``|V2``, the raw bits) loads into a bfloat16 tensor with those bits
    (the reference's own load_checkpoint cannot read it back)."""
    import jax.numpy as jnp

    want = _bf16_values()
    bits = want.view(torch.int16).numpy().view(np.uint16)
    leaf = jnp.asarray(bits.view(jnp.bfloat16)).reshape(3, -1)
    step = ref_store.save_checkpoint(str(tmp_path), 4, {"w": leaf})
    raw = np.load(os.path.join(step, "arr_00000.npy"))
    assert raw.dtype == np.dtype("V2")
    like = {"w": torch.zeros(leaf.shape, dtype=torch.bfloat16)}
    got, s, _ = load_checkpoint(str(tmp_path), like)
    assert s == 4 and got["w"].dtype == torch.bfloat16
    assert got["w"].shape == leaf.shape
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy().view(np.uint16).ravel(), bits)


def test_port_bf16_leaf_is_the_reference_file(tmp_path):
    """The port writes a bfloat16 leaf as the reference does: the same
    bytes (descr ``<V2``, numpy reads ``|V2`` holding the uint16 bits),
    and loads it back bit for bit, also beside float leaves."""
    import jax.numpy as jnp

    t = _bf16_values().reshape(3, -1)
    bits = t.view(torch.int16).numpy().view(np.uint16)
    mine = save_checkpoint(str(tmp_path / "port"), 2,
                           {"w": t, "x": torch.ones(2)})
    ref = ref_store.save_checkpoint(
        str(tmp_path / "ref"), 2,
        {"w": jnp.asarray(bits.view(jnp.bfloat16)), "x": jnp.ones(2)})
    a, b = (os.path.join(d, "arr_00000.npy") for d in (mine, ref))
    raw = np.load(a)
    assert raw.dtype == np.dtype("V2") and raw.shape == t.shape
    np.testing.assert_array_equal(raw.view(np.uint16), bits)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    like = {"w": torch.zeros(t.shape, dtype=torch.bfloat16),
            "x": torch.zeros(2)}
    got, _, _ = load_checkpoint(str(tmp_path / "port"), like)
    assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(got["x"], torch.ones(2))


def test_atomic_commit_torn_and_tmp_steps_skipped(tmp_path):
    """Both list_steps skip a .tmp directory, a torn manifest, a missing
    manifest and an incomplete one; a save over an existing step and a
    stale .tmp of the step it writes leave one complete step."""
    root = str(tmp_path)
    tree = _tree(np.random.default_rng(1))
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(root, s, tree)
    os.makedirs(os.path.join(root, "step_000000009.tmp"))
    with open(os.path.join(root, "step_000000005", "manifest.json"),
              "w") as f:
        f.write('{"step": 5, "leav')
    os.remove(os.path.join(root, "step_000000004", "manifest.json"))
    with open(os.path.join(root, "step_000000003", "manifest.json"),
              "w") as f:
        json.dump({"step": 3, "leaves": [], "complete": False}, f)
    assert list_steps(root) == ref_store.list_steps(root) == [1, 2]
    assert latest_step(root) == ref_store.latest_step(root) == 2
    os.makedirs(os.path.join(root, "step_000000002.tmp"))
    save_checkpoint(root, 2, tree, {"again": True})
    assert not os.path.exists(os.path.join(root, "step_000000002.tmp"))
    _, step, extra = load_checkpoint(root, tree)
    assert (step, extra) == (2, {"again": True})
    assert list_steps(str(tmp_path / "missing")) == []
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing"), tree)


@pytest.mark.parametrize("async_write", [False, True],
                         ids=["sync", "async"])
def test_manager_retention_matches_reference(tmp_path, async_write):
    """CheckpointManager keeps the last ``keep`` steps, writes tensors
    through the host, drains on wait and resumes the newest — the same
    directory the reference's manager leaves."""
    rng = np.random.default_rng(2)
    trees = [{"x": rng.standard_normal(4), "y": np.float64(i)}
             for i in range(6)]
    mine = CheckpointManager(str(tmp_path / "port"), keep=3,
                             async_write=async_write)
    ref = ref_store.CheckpointManager(str(tmp_path / "ref"), keep=3,
                                      async_write=async_write)
    for i, tree in enumerate(trees):
        mine.save(i + 1, {"x": torch.as_tensor(tree["x"]), "y": tree["y"]},
                  {"i": i})
        ref.save(i + 1, tree, {"i": i})
    mine.wait()
    ref.wait()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")) == [
        "step_000000004", "step_000000005", "step_000000006"]
    got, step, extra = mine.restore_or_none(trees[0])
    assert (step, extra) == (6, {"i": 5})
    np.testing.assert_array_equal(got["x"], trees[5]["x"])
    mine.close()
    ref.close()
    assert CheckpointManager(str(tmp_path / "void"),
                             async_write=False).restore_or_none(
        trees[0]) is None


def test_manager_snapshot_is_a_copy(tmp_path, monkeypatch):
    """``save`` snapshots the leaves: CPU tensors (float32 and bf16) and
    numpy arrays changed in place after ``save``, while the asynchronous
    writer still waits, are read back as they were at ``save``."""
    from repro_torch.checkpoint import store

    release = threading.Event()
    write = store.save_checkpoint

    def held(*a, **kw):
        assert release.wait(30)
        return write(*a, **kw)

    monkeypatch.setattr(store, "save_checkpoint", held)
    rng = np.random.default_rng(4)
    tree = {"m": torch.from_numpy(rng.standard_normal(6).astype(np.float32)),
            "p": torch.from_numpy(rng.standard_normal(5).astype(
                np.float32)).to(torch.bfloat16),
            "a": rng.standard_normal(3)}
    before = {k: v.clone() if torch.is_tensor(v) else v.copy()
              for k, v in tree.items()}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    tree["m"].add_(1.0)
    tree["p"].mul_(3.0)
    tree["a"] += 1.0
    release.set()
    mgr.wait()
    mgr.close()
    got, step, _ = load_checkpoint(str(tmp_path), before)
    assert step == 1
    for k in ("m", "p"):
        assert got[k].dtype == before[k].dtype
        assert torch.equal(got[k], before[k]), k
    np.testing.assert_array_equal(got["a"], before["a"])


def test_manager_surfaces_writer_errors(tmp_path):
    """A failed background write raises on the next save / wait."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker), keep=2)
    mgr.save(1, {"x": np.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    with pytest.raises(OSError):
        mgr.save(2, {"x": np.zeros(2)})


# --------------------------------------------------------------------------- #
# checkpoints crossing between the packages
# --------------------------------------------------------------------------- #
def _problems(n=N, seed=1):
    g = webgraph_like(n, seed=seed)
    return (repro.Problem.pagerank(RefStore.from_csr(g)),
            repro_torch.Problem.pagerank(GraphStore.from_csr(g)))


def _opts(method, port):
    k = 1 if method.startswith("engine") else None
    if port:
        return repro_torch.SolverOptions(device="cpu", k=k)
    return repro.SolverOptions(k=k)


def _mid_solve(session, grains=3):
    for i, _ in enumerate(session.run()):
        if i >= grains:
            break


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("method", ["frontier:segment_sum", "engine:chunk"])
def test_checkpoint_restores_across_packages(tmp_path, writer, method):
    """A mid-solve checkpoint written by one package restores in both;
    the two restored sessions resume to equal rounds and n_ops and
    |Δx|_1 <= 1e-8, and the provenance (step, counters) is equal."""
    pr, pt = _problems(512)
    if writer == "reference":
        src = repro.SolverSession(pr, method=method,
                                  options=_opts(method, False))
    else:
        src = repro_torch.SolverSession(pt, method=method,
                                        options=_opts(method, True))
    _mid_solve(src)
    src.checkpoint(str(tmp_path))
    ref = repro.SolverSession.restore(str(tmp_path), pr,
                                      options=_opts(method, False))
    got = repro_torch.SolverSession.restore(str(tmp_path), pt,
                                            options=_opts(method, True))
    assert got.method == ref.method == method  # from the manifest
    for key in ("step", "ops", "rounds", "lifetime_ops", "rejected"):
        assert got.restored_from[key] == ref.restored_from[key], key
    assert got.restored_from["ops"] > 0
    rep, ref_rep = got.solve(), ref.solve()
    assert rep.converged and ref_rep.converged
    assert (rep.n_rounds, rep.n_ops) == (ref_rep.n_rounds, ref_rep.n_ops)
    assert np.abs(rep.x - ref_rep.x).sum() <= 1e-8


@pytest.mark.parametrize("method", ["frontier:segment_sum",
                                    "frontier:pallas", "engine:chunk"])
def test_restore_replays_the_uninterrupted_solve(tmp_path, method):
    """Checkpoint mid-solve, restore, finish: the restored rounds and
    pushes plus the checkpoint's equal one uninterrupted solve's, and x
    is bit-equal (the float32 state survives its float64 leaves)."""
    _, pt = _problems()
    opts = repro_torch.SolverOptions(
        device="cpu", k=4 if method.startswith("engine") else None)
    full = repro_torch.SolverSession(pt, method=method, options=opts).solve()
    session = repro_torch.SolverSession(pt, method=method, options=opts)
    _mid_solve(session)
    session.checkpoint(str(tmp_path))
    restored = repro_torch.SolverSession.restore(str(tmp_path), pt,
                                                 options=opts)
    info = restored.restored_from
    rep = restored.solve()
    assert info["rounds"] + rep.n_rounds == full.n_rounds
    assert info["ops"] + rep.n_ops == full.n_ops
    assert np.array_equal(rep.x, full.x)
    assert restored.lifetime_ops == rep.n_ops  # a restore starts afresh


# --------------------------------------------------------------------------- #
# restore's rejections, against the reference's reasons
# --------------------------------------------------------------------------- #
def _steps(td, steps=3, writer="reference"):
    """``steps`` checkpoints of one mid-solve engine:chunk k=1 session."""
    pr, pt = _problems(256)
    if writer == "reference":
        ses = repro.SolverSession(pr, method="engine:chunk",
                                  options=repro.SolverOptions(k=1))
    else:
        ses = repro_torch.SolverSession(
            pt, method="engine:chunk",
            options=repro_torch.SolverOptions(device="cpu", k=1))
    _mid_solve(ses, 1)
    for _ in range(steps):
        ses.checkpoint(td)
    return pr, pt


def _both_restore(td, pr, pt):
    """Restore ``td`` in both packages: ``(ref_info, port_info)`` or the
    raised exceptions' ``(type, message)``."""
    out = []
    for restore, problem, opts in (
            (repro.SolverSession.restore, pr, repro.SolverOptions(k=1)),
            (repro_torch.SolverSession.restore, pt,
             repro_torch.SolverOptions(device="cpu", k=1))):
        try:
            out.append(restore(td, problem, options=opts).restored_from)
        except (FileNotFoundError, ValueError) as e:
            out.append((type(e), str(e)))
    return out


def _tear(td, name):
    tear_checkpoint(os.path.join(td, name))


def _drop_leaf(td, name):
    os.remove(os.path.join(td, name, "arr_00001.npy"))


def _torn_manifest(td, name):
    with open(os.path.join(td, name, "manifest.json"), "w") as f:
        f.write('{"step": 3, "leav')


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("damage", [
    [("step_000000003", _tear)],
    [("step_000000003", _drop_leaf)],
    [("step_000000003", _torn_manifest), ("step_000000002", _drop_leaf)],
    [(f"step_00000000{s}", _tear) for s in (1, 2, 3)],
    [(f"step_00000000{s}", _drop_leaf) for s in (1, 2, 3)],
], ids=["torn-leaf", "missing-leaf", "torn-manifest", "all-torn",
        "all-missing"])
def test_rejection_reasons_equal_reference(tmp_path, writer, damage):
    """Torn leaf, missing leaf, torn manifest, and every step invalid:
    the restored step and the per-step reasons (or the error) equal the
    reference's on the same directory."""
    td = str(tmp_path)
    pr, pt = _steps(td, writer=writer)
    for name, fn in damage:
        fn(td, name)
    ref, got = _both_restore(td, pr, pt)
    assert got == ref
    if isinstance(ref, dict):
        assert ref["rejected"] and ref["step"] < 3
    else:
        assert ref[0] is ValueError and "no valid checkpoint" in ref[1]


def test_rejection_permission_denied_equals_reference(tmp_path,
                                                      monkeypatch):
    """A step whose files cannot be opened (permission denied) is
    rejected, in both packages with the same reason; the open is refused
    by a patched ``open`` so the test holds for a privileged user too."""
    td = str(tmp_path)
    pr, pt = _steps(td)
    locked = os.path.join(td, "step_000000003")
    real_open = builtins.open

    def guarded(file, *a, **kw):
        if str(file).startswith(locked):
            raise PermissionError(13, "Permission denied", str(file))
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", guarded)
    ref, got = _both_restore(td, pr, pt)
    assert got == ref
    assert ref["step"] == 2
    assert ref["rejected"] == [(3, "incomplete or unreadable manifest")]


def test_rejection_stale_store_version_equals_reference(tmp_path):
    """A checkpoint cut before a graph delta is stale against the patched
    matrix, with the reference's reason; a post-delta one restores."""
    pr, pt = _problems(512, seed=2)
    ref = repro.SolverSession(pr, method="engine:chunk", k=1)
    got = repro_torch.SolverSession(pt, method="engine:chunk", k=1,
                                    device="cpu")
    for ses, churn, td in ((ref, ref_churn, tmp_path / "ref"),
                           (got, rotation_churn, tmp_path / "port")):
        ses.solve()
        ses.checkpoint(str(td))
        ses.update_graph(churn(ses.problem.graph, 20, seed=3))
        ses.solve()
    errors = []
    for restore, ses, td in ((repro.SolverSession.restore, ref,
                              tmp_path / "ref"),
                             (repro_torch.SolverSession.restore, got,
                              tmp_path / "port")):
        with pytest.raises(ValueError, match="stale") as err:
            restore(str(td), ses.problem, options=ses.options)
        errors.append(str(err.value).replace(str(td), "D"))
    assert errors[0] == errors[1]
    got.checkpoint(str(tmp_path / "port"))
    restored = repro_torch.SolverSession.restore(
        str(tmp_path / "port"), got.problem, options=got.options)
    assert restored.restored_from["step"] == 2


def test_rejection_empty_and_missing_dirs_equal_reference(tmp_path):
    pr, pt = _problems(256)
    (tmp_path / "empty").mkdir()
    for td in (str(tmp_path / "empty"), str(tmp_path / "missing")):
        assert _both_restore(td, pr, pt)[0] == _both_restore(td, pr, pt)[1]
        assert _both_restore(td, pr, pt)[1][0] is FileNotFoundError
    td = str(tmp_path / "one")
    _steps(td, steps=1)
    with pytest.raises(FileNotFoundError, match="step 9"):
        repro_torch.SolverSession.restore(
            td, pt, step=9, options=repro_torch.SolverOptions(device="cpu"))
    shutil.rmtree(td)
