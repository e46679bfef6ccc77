"""Port parity for MeshGraphNet, EGNN and DimeNet: forwards, losses,
gradients, train steps, configs, data and the CLI.

The reference's parameters (``repro.models.gnn.init_params``, every leaf
shifted by 0.05 so that every bias counts) are carried across by
``repro_torch.interop.gnn_params_from_numpy``.  Batches are
``make_gnn_batch``'s power-law graphs with coordinates (and triplets)
for node tasks and ``molecule_batch``'s small graphs for graph tasks,
some mask entries 0 where "masked".  On the CPU every reduction runs
K5's plain version and every gather's gradient ``embedding_bwd``'s; the
sums run in another order than XLA's scatter, so the tolerances are
GIN's: rtol 1e-4 / atol 1e-5 on outputs, the loss within rtol 1e-5 and
every gradient leaf within relative L1 1e-4; three ``build_cell_step``
steps within rtol 1e-5 (the first step's loss, lr and gradient norm),
1e-4 (the later losses) and relative L1 1e-4 (parameters and AdamW
state).
"""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_arch as ref_arch
from repro.configs.smoke import smoke_setup as ref_smoke_setup
from repro.data import pipeline as ref_pipeline
from repro.core import power_law_graph as ref_power_law_graph
from repro.launch import steps as ref_steps
from repro.models import gnn as ref_gnn
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.runtime import TrainLoop as RefTrainLoop
from repro.runtime import TrainLoopConfig as RefTrainLoopConfig
from repro_torch.configs import dimenet, egnn, get_arch, meshgraphnet
from repro_torch.configs.smoke import smoke_setup
from repro_torch.core import power_law_graph
from repro_torch.data import make_gnn_batch, molecule_batch, pad_gnn_batch
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import segment_aggregate
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import build_cell_step, gnn_train_step
from repro_torch.models import gnn
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import TrainLoop, TrainLoopConfig

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

ARCHS = ["meshgraphnet", "egnn", "dimenet"]
CONFIGS = {"meshgraphnet": meshgraphnet, "egnn": egnn, "dimenet": dimenet}
TOL = dict(rtol=1e-4, atol=1e-5)
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{n}" if n else k, leaf) for k in sorted(tree)
                for n, leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{n}" if n else str(i), leaf)
                for i, node in enumerate(tree) for n, leaf in _leaves(node)]
    return [("", tree)]


def _cfgs(arch, **kw):
    base = dict(name=arch, arch=arch, n_layers=2, d_hidden=16, d_feat=6,
                n_bilinear=4, n_spherical=4, n_radial=4)
    if arch == "meshgraphnet":
        base |= dict(d_edge=4, d_out=2)
    base.update(kw)
    return ref_gnn.GNNConfig(**base), gnn.GNNConfig(**base)


def _ref_params(ref_cfg, seed=0):
    params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: a + 0.05, params)


def _model(params, cfg):
    return gnn_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")


def _batch(arch, task, masked, d_out=1, n_classes=0, seed=0, d_feat=6):
    rng = np.random.default_rng(seed + 20)
    trip = arch == "dimenet"
    if task == "graph":
        b = molecule_batch(5, nodes_per_graph=12, edges_per_graph=30,
                           d_feat=d_feat, with_triplets=trip, seed=seed)
    else:
        b = make_gnn_batch(power_law_graph(70, seed=seed), d_feat,
                           n_classes=n_classes, with_pos=True,
                           with_triplets=trip, d_out=d_out, seed=seed)
    if masked:
        for key, ref in (("node_mask", "x"), ("edge_mask", "src"),
                         ("trip_mask", "trip_e")):
            if ref in b:
                b[key] = (rng.random(b[ref].shape[0]) > 0.25).astype(
                    np.float32)
    else:
        for key in ("node_mask", "edge_mask", "trip_mask"):
            b.pop(key, None)
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(loss, leaves):
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    """(arch, reference cfg, port cfg, reference params, port model) at
    the node task."""
    arch = request.param
    ref_cfg, cfg = _cfgs(arch)
    params = _ref_params(ref_cfg)
    return arch, ref_cfg, cfg, params, _model(params, cfg)


# --------------------------------------------------------------------------- #
# forward, loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_reference(arch_pair, masked):
    arch, ref_cfg, cfg, params, model = arch_pair
    batch = _batch(arch, "node", masked, d_out=cfg.d_out)
    want = np.asarray(jax.jit(lambda p, b: ref_gnn.forward(p, b, ref_cfg))(
        params, _jnp(batch)))
    before = dict(LAUNCHES)
    got = gnn.forward(model, batch)
    assert LAUNCHES == before, "a CPU forward launched a kernel"
    assert got.shape == want.shape == (70, cfg.d_out)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a prepared batch (sorted once) gives the same numbers
    prepared = gnn.prepare_batch(batch, "cpu", arch)
    assert torch.equal(gnn.forward(model, prepared), got)


LOSS_CASES = [pytest.param("graph", True, id="graph-regression-masked"),
              pytest.param("node", False, id="node-regression")]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("task,masked", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, task, masked):
    ref_cfg, cfg = _cfgs(arch, task=task)
    params = _ref_params(ref_cfg)
    batch = _batch(arch, task, masked, d_out=cfg.d_out)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_gnn.loss_fn(p, _jnp(batch), ref_cfg)))(params)
    model = _model(params, cfg)
    model.requires_grad_(True)
    names, leaves = zip(*_leaves(model.param_tree()))
    before = dict(LAUNCHES)
    loss = gnn.loss_fn(model, batch)
    grads = _grads(loss, leaves)
    assert LAUNCHES == before, "a CPU gradient launched a kernel"
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    want = dict(_leaves(grads_ref))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert _rel_l1(g.numpy(), want[name]) <= 1e-4, name
    # the plain versions (DimeNet's einsum among them) within the same
    # bound; a prepared batch gives the kernels' path's bits
    prepared = gnn.prepare_batch(batch, "cpu", arch)
    plain = _grads(gnn.loss_fn(model, prepared, kernels=False), leaves)
    again = _grads(gnn.loss_fn(model, prepared), leaves)
    for name, g, p, a in zip(names, grads, plain, again):
        assert _rel_l1(p.numpy(), want[name]) <= 1e-4, name
        assert torch.equal(g, a), name


def test_param_tree_is_the_references_pytree(arch_pair):
    arch, _, cfg, params, model = arch_pair
    tree = model.param_tree()
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == (
        jax.tree.structure(jax.tree.map(lambda _: 0, tree)))
    ref_leaves = jax.tree.leaves(params)
    port_leaves = tree_leaves(tree)
    assert [tuple(a.shape) for a in port_leaves] == [
        tuple(np.shape(b)) for b in ref_leaves]
    for a, b in zip(port_leaves, ref_leaves):
        assert np.array_equal(a.detach().numpy(), np.asarray(b))
    # load_param_tree copies a tree of other tensors in
    other = gnn.init_params(cfg, seed=5, device="cpu")
    model = _model(params, cfg)
    model.load_param_tree(other.param_tree())
    for a, b in zip(tree_leaves(model.param_tree()),
                    tree_leaves(other.param_tree())):
        assert torch.equal(a, b)


def test_triplet_bilinear_matches_the_einsum():
    """The product a bilinear channel at a time, and its recomputing
    backward, against the einsum (the plain version) and ``jax.vjp``."""
    rng = np.random.default_rng(3)
    sp, msrc, w, g = (rng.standard_normal(s).astype(np.float32) for s in
                      ((50, 4), (50, 8), (4, 8, 8), (50, 8)))
    out_ref, vjp = jax.vjp(lambda *a: jnp.einsum("tb,td,bdh->th", *a),
                           jnp.asarray(sp), jnp.asarray(msrc), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    for plain in (False, True):
        args = [torch.from_numpy(a).requires_grad_(True)
                for a in (sp, msrc, w)]
        out = gnn.triplet_bilinear(*args, plain=plain)
        got = torch.autograd.grad(out, args, torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("form", ["gather", "contiguous"])
def test_segment_aggregate_gradient_matches_jax_vjp(form):
    """``segment_aggregate`` (K5's plain version on the CPU) and its
    gather backward against ``jax.vjp`` of the reference's masked
    ``segment_sum``; ids outside ``[0, n)`` drop out."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 12, 80).astype(np.int32)
    ids[:3] = 40
    if form == "contiguous":
        ids = np.sort(ids)
    w = (rng.random(80) > 0.3).astype(np.float32)
    data = rng.standard_normal((80, 5)).astype(np.float32)
    g = rng.standard_normal((12, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jax.ops.segment_sum(
        d * jnp.asarray(w)[:, None], jnp.asarray(ids), num_segments=12),
        jnp.asarray(data))
    (want_g,) = vjp(jnp.asarray(g))
    dt = torch.from_numpy(data).requires_grad_(True)
    kw = {}
    if form == "gather":
        kw["order"] = torch.sort(torch.from_numpy(ids), stable=True)[1]
    out = segment_aggregate(dt, torch.from_numpy(ids), 12,
                            weights=torch.from_numpy(w), **kw)
    (got,) = torch.autograd.grad(out, [dt], torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_classification_cell_loss_is_nan_in_both_packages(arch):
    """The archs' heads are ``d_out`` wide, so a class label reads past
    them: JAX's ``take_along_axis`` fills NaN, and so does the port
    (whose gather stays in range)."""
    ref_cfg, cfg = _cfgs(arch, n_classes=5, d_out=1)
    params = _ref_params(ref_cfg)
    batch = _batch(arch, "node", False, n_classes=5)
    assert batch["labels"].max() >= 1
    ref = float(ref_gnn.loss_fn(params, _jnp(batch), ref_cfg))
    got = float(gnn.loss_fn(_model(params, cfg), batch))
    assert np.isnan(ref) and np.isnan(got)


def test_gold_reads_as_take_along_axis():
    logits = np.arange(12, dtype=np.float32).reshape(4, 3)
    labels = np.array([0, -1, 3, 2], np.int32)
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(logits), jnp.asarray(labels)[:, None], axis=-1))[:, 0]
    got = gnn._gold(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# invariances (tests/test_models_gnn.py's, on the port)
# --------------------------------------------------------------------------- #
def _rotation(axis_pair, theta):
    rot = np.eye(3, dtype=np.float32)
    i, j = axis_pair
    rot[i, i] = rot[j, j] = np.cos(theta)
    rot[i, j], rot[j, i] = -np.sin(theta), np.sin(theta)
    return rot


def test_egnn_is_translation_and_rotation_invariant():
    _, cfg = _cfgs("egnn")
    model = gnn.init_params(cfg, device="cpu")
    b = _batch("egnn", "node", False)
    out = gnn.forward(model, b).numpy()
    moved = dict(b, pos=b["pos"] + np.float32([5.0, -3.0, 2.0]))
    np.testing.assert_allclose(gnn.forward(model, moved).numpy(), out,
                               rtol=1e-4, atol=1e-4)
    turned = dict(b, pos=b["pos"] @ _rotation((0, 1), 0.7).T)
    np.testing.assert_allclose(gnn.forward(model, turned).numpy(), out,
                               rtol=1e-3, atol=1e-3)


def test_dimenet_is_rotation_invariant():
    _, cfg = _cfgs("dimenet", task="graph")
    model = gnn.init_params(cfg, device="cpu")
    b = _batch("dimenet", "graph", False)
    out = gnn.forward(model, b).numpy()
    turned = dict(b, pos=b["pos"] @ _rotation((1, 2), -0.4).T)
    np.testing.assert_allclose(gnn.forward(model, turned).numpy(), out,
                               rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------- #
# data and the prepared batch
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_triplets", [False, True])
def test_make_gnn_batch_with_positions_is_byte_identical(with_triplets):
    kw = dict(n_classes=0, with_pos=True, with_triplets=with_triplets,
              max_trip_per_edge=3, d_out=2, seed=1)
    want = ref_pipeline.make_gnn_batch(ref_power_law_graph(200, seed=2), 5,
                                       **kw)
    got = make_gnn_batch(power_law_graph(200, seed=2), 5, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_prepared_batch_sorts_the_triplets_once(monkeypatch):
    b = _batch("dimenet", "node", True)
    t = b["trip_e"].shape[0]
    padded = pad_gnn_batch(b, 80, b["src"].shape[0] + 30, t + 50)
    p = gnn.prepare_batch(padded, "cpu", "dimenet")
    order = np.argsort(padded["trip_e"], kind="stable")
    for key in ("trip_e", "trip_f", "trip_mask"):
        assert np.array_equal(p[key].numpy(), padded[key][order]), key
    assert np.array_equal(p["trip_f_order"].numpy(),
                          np.argsort(padded["trip_f"][order], kind="stable"))
    assert np.array_equal(p["src_order"].numpy(),
                          np.argsort(padded["src"], kind="stable"))
    assert np.array_equal(p["dst_order"].numpy(),
                          np.argsort(padded["dst"], kind="stable"))
    assert np.array_equal(p["z_order"].numpy(),
                          np.argsort(padded["z"], kind="stable"))
    # a forward over it sorts nothing
    model = gnn.init_params(_cfgs("dimenet")[1], device="cpu")
    want = gnn.forward(model, padded)
    monkeypatch.setattr(torch, "sort", None)
    assert torch.equal(gnn.forward(model, p), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_batch_gives_the_same_real_rows(arch):
    _, cfg = _cfgs(arch)
    model = gnn.init_params(cfg, device="cpu")
    b = _batch(arch, "node", False, d_out=cfg.d_out)
    e = b["src"].shape[0]
    t = b["trip_e"].shape[0] if arch == "dimenet" else None
    padded = pad_gnn_batch(b, 96, e + 200, None if t is None else t + 300)
    assert padded["x"].shape[0] == 96 and padded["src"].shape[0] == e + 200
    assert padded["edge_mask"].sum() == e
    if t is not None:
        assert padded["trip_e"].shape[0] == t + 300
        assert padded["trip_mask"].sum() == t
        assert padded["trip_e"][t:].max() < e
    got = gnn.forward(model, padded)
    np.testing.assert_allclose(got[:70].numpy(),
                               gnn.forward(model, b).numpy(),
                               rtol=1e-6, atol=1e-6)
    if t is not None:
        with pytest.raises(ValueError, match="cannot pad"):
            pad_gnn_batch(b, 96, e, t - 1)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_cells_match_reference(arch):
    ref_spec, spec = ref_arch(arch), get_arch(arch)
    assert spec.family == ref_spec.family == "gnn"
    assert spec.source == ref_spec.source

    def fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k != "dtype"}

    assert fields(spec.model_cfg) == fields(ref_spec.model_cfg)
    assert spec.cells.keys() == ref_spec.cells.keys()
    for name, cell in spec.cells.items():
        want = ref_spec.cells[name]
        assert cell.kind == want.kind == "train"
        assert cell.meta == want.meta
        assert cell.overrides == dict(want.overrides)
        ref_inputs = want.inputs()
        assert cell.inputs.keys() == ref_inputs.keys()
        for key, (shape, dtype) in cell.inputs.items():
            assert shape == ref_inputs[key].shape, key
            assert str(dtype).split(".")[-1] == str(ref_inputs[key].dtype)
        assert fields(CONFIGS[arch].cfg_for(name)) == fields(
            ref_spec.cfg_for(want))
    m = gnn.init_params(CONFIGS[arch].cfg_for("molecule"), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jax.eval_shape(
            lambda k: ref_gnn.init_params(ref_spec.cfg_for(
                ref_spec.cells["molecule"]), k), jax.random.PRNGKey(0))))


# --------------------------------------------------------------------------- #
# the train step, the runtime and the CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three steps of the ``molecule`` cell (its overrides on the small
    config), the reference's ``build_cell_step`` and the port's, from the
    same state, on one fixed masked batch with padded triplets."""
    ref_spec, spec = ref_arch(arch), get_arch(arch)
    ov = spec.cells["molecule"].overrides
    ref_cfg, cfg = _cfgs(arch, **ov)
    ref_spec = dataclasses.replace(ref_spec, model_cfg=ref_cfg)
    ref_step, _, _ = ref_steps.build_cell_step(
        ref_spec, ref_spec.cells["molecule"], {}, RefAdamWConfig(**OCFG))
    ref_step = jax.jit(ref_step)
    params = _ref_params(ref_cfg, seed=1)
    batch = _batch(arch, "graph", True, seed=1, d_feat=ov["d_feat"])
    if arch == "dimenet":
        batch = pad_gnn_batch(batch, batch["x"].shape[0],
                              batch["src"].shape[0],
                              batch["trip_e"].shape[0] + 40)
    model = _model(params, cfg)
    step = build_cell_step(spec, spec.cells["molecule"], model,
                           AdamWConfig(**OCFG))
    ref_state = ref_adamw_init(params)
    tree = model.param_tree()
    state = adamw_init(tree)
    prepared = gnn.prepare_batch(batch, "cpu", arch)
    for i in range(3):
        params, ref_state, want = ref_step(params, ref_state, _jnp(batch))
        tree, state, got = step(tree, state, prepared)
        for key in ("loss", "lr", "grad_norm") if i == 0 else ("loss",):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=key)
        for part, port, ref in (("params", tree, params),
                                *((k, state[k], ref_state[k])
                                  for k in ("master", "m", "v"))):
            want_leaves = dict(_leaves(ref))
            for name, leaf in _leaves(port):
                assert _rel_l1(leaf.detach().numpy(),
                               want_leaves[name]) <= 1e-4, (i, part, name)


def test_gnn_train_step_moves_every_leaf_of_egnn():
    """EGNN's last coordinate MLP reaches no output: its gradient is 0
    (as ``jax.grad`` gives it), and AdamW's decay still moves it."""
    _, cfg = _cfgs("egnn", task="graph")
    model = gnn.init_params(cfg, device="cpu")
    step = gnn_train_step(model, AdamWConfig(**OCFG))
    before = [p.detach().clone() for p in tree_leaves(model.param_tree())]
    _, _, metrics = step(model.param_tree(), adamw_init(model.param_tree()),
                         _batch("egnn", "graph", True))
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(
        before, tree_leaves(model.param_tree())) if a.abs().sum() > 0)


def test_reference_checkpoint_of_dimenet_resumes_in_the_port(tmp_path):
    """The reference's ``TrainLoop`` cuts a checkpoint at step 2 of the
    reduced DimeNet; the port's loop resumes from it (the ``blocks`` list
    of dicts included) and continues the reference's losses."""
    ref_cfg, batch, _ = ref_smoke_setup("dimenet")
    cfg, raw, _ = smoke_setup("dimenet")
    params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    ocfg = RefAdamWConfig(**OCFG)

    @jax.jit
    def ref_step(p, opt, b):
        loss, grads = jax.value_and_grad(
            lambda q: ref_gnn.loss_fn(q, b, ref_cfg))(p)
        p, opt, m = ref_adamw_update(grads, opt, ocfg,
                                     param_dtype=jnp.float32)
        return p, opt, {"loss": loss, **m}

    def ref_loop(ckpt, steps):
        return RefTrainLoop(ref_step, lambda i: batch,
                            lambda: (params, ref_adamw_init(params)),
                            RefTrainLoopConfig(total_steps=steps,
                                               ckpt_dir=str(ckpt),
                                               ckpt_every=2))

    whole = ref_loop(tmp_path / "ref", 5).run()
    ref_loop(tmp_path / "cut", 2).run()
    model = gnn.init_params(cfg, seed=7, device="cpu")
    step = gnn_train_step(model, AdamWConfig(**OCFG))
    prepared = gnn.prepare_batch(raw, "cpu", "dimenet")
    port = TrainLoop(step, lambda i: prepared,
                     lambda: (model.param_tree(),
                              adamw_init(model.param_tree())),
                     TrainLoopConfig(total_steps=5,
                                     ckpt_dir=str(tmp_path / "cut"),
                                     ckpt_every=2)).run()
    assert [m["step"] for m in port["metrics"]] == [2, 3, 4]
    np.testing.assert_allclose([float(m["loss"]) for m in port["metrics"]],
                               [float(m["loss"])
                                for m in whole["metrics"][2:]], rtol=1e-4)


_LOSSES = re.compile(r"loss ([0-9.]+) -> ([0-9.]+) over (\d+) steps")


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_matches_reference_cli(arch, tmp_path, monkeypatch):
    """``train --arch <arch> --steps 3 --device cpu`` from the reference's
    initial state (a step-0 checkpoint of its pytree) prints the
    reference CLI's first and last loss, the last below the first."""
    from repro.launch import train as ref_train

    ref_cfg, _, _ = ref_smoke_setup(arch)
    p0 = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    mgr = RefCheckpointManager(str(tmp_path / "port"), async_write=False)
    mgr.save(0, (p0, ref_adamw_init(p0)))
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--steps", "3", "--ckpt",
        str(tmp_path / "ref")])
    want = _LOSSES.search(_printed(lambda _: ref_train.main(), None))
    text = _printed(port_train.main, [
        "--arch", arch, "--steps", "3", "--device", "cpu", "--ckpt",
        str(tmp_path / "port")])
    assert f"[{arch}] reduced config" in text
    assert "[resume] from step 0" in text
    got = _LOSSES.search(text)
    assert got.group(3) == want.group(3) == "3"
    np.testing.assert_allclose([float(got.group(1)), float(got.group(2))],
                               [float(want.group(1)), float(want.group(2))],
                               rtol=1e-4)
    assert float(got.group(2)) < float(got.group(1))
