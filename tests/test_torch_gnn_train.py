"""Port parity for GIN training: the aggregation's and the pooling's
gradients, ``loss_fn`` for every task, the GNN train step, the pytree and
its AdamW state, and ``launch/train.py --arch gin-tu``.

The reference's GIN parameters (``repro.models.gnn.init_params``, every
leaf shifted by 0.05 so that eps and the biases are non-zero) are carried
across by ``repro_torch.interop.gnn_params_from_numpy``; batches are
``molecule_batch``'s small graphs (graph tasks) and ``make_gnn_batch``'s
power-law graphs (node tasks), with some ``node_mask`` / ``edge_mask``
entries 0.  On the CPU the aggregation's backward runs K5's plain version
over the transposed graph.  Tolerances, float32 sums in another order
throughout:

* the aggregation's and the pooling's gradients within rtol 1e-5 / atol
  1e-6 of ``jax.vjp``'s;
* the loss within rtol 1e-5, every gradient leaf within relative L1 1e-4
  of ``jax.value_and_grad``'s (node / graph task, classes / regression,
  masked or not);
* three steps of ``build_cell_step`` on a node and a graph cell, as the
  LM's steps are held: the first step's loss, lr and gradient norm
  within rtol 1e-5, the later losses within rtol 1e-4, the parameters
  and the AdamW state (master, m, v) within relative L1 1e-4 of the
  reference's after each step;
* the CLI's first and last loss within rtol 1e-4 of the reference CLI's,
  from the same initial state (a reference checkpoint whose pytree holds
  lists).
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
from repro.configs import gin_tu as ref_gin_tu
from repro.configs.smoke import smoke_setup as ref_smoke_setup
from repro.launch import steps as ref_steps
from repro.models import gnn as ref_gnn
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import gin_tu
from repro_torch.configs.smoke import smoke_setup
from repro_torch.core import power_law_graph
from repro_torch.data import make_gnn_batch, molecule_batch
from repro_torch.interop import adamw_state_from_numpy, gnn_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import (gather_aggregate, segment_sum_ref,
                                         segment_sum_sorted)
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import build_cell_step, gnn_train_step
from repro_torch.models import gnn
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

# lr as the LM parity tests take it: at 3e-2 the wide full_graph_sm cell
# (d_feat 1,433) swings its loss 24 -> 57 -> 16, and such a step
# magnifies float32 rounding past any tolerance
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=10)
TOL = dict(rtol=1e-5, atol=1e-6)


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


def _cfgs(**kw):
    base = dict(name="g", arch="gin", n_layers=3, d_hidden=16, d_feat=8)
    base.update(kw)
    return ref_gnn.GNNConfig(**base), gnn.GNNConfig(**base)


def _ref_params(ref_cfg, seed=0):
    params = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: a + 0.05, params)


def _model(params, cfg):
    return gnn_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")


def _batch(task, n_classes, d_out, masked, d_feat=8, seed=0):
    rng = np.random.default_rng(seed + 10)
    if task == "graph":
        b = molecule_batch(6, nodes_per_graph=12, edges_per_graph=30,
                           d_feat=d_feat, seed=seed)
        if n_classes:
            b["labels"] = rng.integers(0, n_classes, 6).astype(np.int32)
    else:
        b = make_gnn_batch(power_law_graph(90, seed=seed), d_feat,
                           n_classes=n_classes, d_out=d_out, seed=seed)
    if masked:
        b["node_mask"] = (rng.random(b["x"].shape[0]) > 0.2).astype(
            np.float32)
        b["edge_mask"] = (rng.random(b["src"].shape[0]) > 0.3).astype(
            np.float32)
    else:
        del b["node_mask"], b["edge_mask"]
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# the aggregation's and the pooling's gradients against jax.vjp
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_aggregation_gradient_matches_jax_vjp(plain, masked):
    """``gather_aggregate``'s backward (K5's gather form over the edges
    sorted by source; on the CPU its plain version) against ``jax.vjp``
    of the reference's ``_agg(h[src], dst, n, edge_mask)``."""
    b = make_gnn_batch(power_law_graph(200, seed=3), 4, n_classes=2)
    rng = np.random.default_rng(4)
    if masked:
        b["edge_mask"] = (rng.random(b["src"].shape[0]) > 0.3).astype(
            np.float32)
    else:
        del b["edge_mask"]
    h = rng.standard_normal((200, 16)).astype(np.float32)
    g = rng.standard_normal((200, 16)).astype(np.float32)
    em = None if not masked else jnp.asarray(b["edge_mask"])
    src, dst = jnp.asarray(b["src"]), jnp.asarray(b["dst"])
    _, vjp = jax.vjp(lambda x: ref_gnn._agg(x[src], dst, 200, em),
                     jnp.asarray(h))
    (want,) = vjp(jnp.asarray(g))
    p = gnn.prepare_batch(b, "cpu")
    ht = torch.from_numpy(h).requires_grad_(True)
    before = dict(LAUNCHES)
    out = gather_aggregate(
        ht, p["agg_dst"], 200, weights=p["agg_w"], rows=p["agg_src"],
        t_seg=p["aggT_seg"], t_rows=p["aggT_rows"], t_weights=p["aggT_w"],
        segment_sum=segment_sum_ref if plain else segment_sum_sorted)
    (got,) = torch.autograd.grad(out, [ht], torch.from_numpy(g))
    assert LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(ref_gnn._agg(jnp.asarray(h)[src], dst, 200, em)), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_graph_pool_gradient_matches_jax_vjp(masked):
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    ids = rng.integers(0, 5, 40).astype(np.int32)  # unsorted
    mask = (rng.random(40) > 0.2).astype(np.float32) if masked else None
    g = rng.standard_normal((5, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: ref_gnn._graph_pool(
        v, jnp.asarray(ids), 5, None if mask is None else jnp.asarray(mask)),
        jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(g))
    vt = torch.from_numpy(vals).requires_grad_(True)
    out = gnn.graph_pool(vt, torch.from_numpy(ids), 5,
                         None if mask is None else torch.from_numpy(mask))
    (got,) = torch.autograd.grad(out, [vt], torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------- #
# loss_fn
# --------------------------------------------------------------------------- #
LOSS_CASES = [
    pytest.param("node", 4, 1, True, id="node-classes-masked"),
    pytest.param("node", 4, 1, False, id="node-classes"),
    pytest.param("node", 0, 2, True, id="node-regression-masked"),
    pytest.param("node", 0, 2, False, id="node-regression"),
    pytest.param("graph", 3, 1, True, id="graph-classes-masked"),
    pytest.param("graph", 0, 1, True, id="graph-regression-masked"),
    pytest.param("graph", 0, 1, False, id="graph-regression"),
]


@pytest.mark.parametrize("task,n_classes,d_out,masked", LOSS_CASES)
def test_gin_loss_and_grads_match_reference(task, n_classes, d_out, masked):
    ref_cfg, cfg = _cfgs(task=task, n_classes=n_classes, d_out=d_out)
    params = _ref_params(ref_cfg)
    batch = _batch(task, n_classes, d_out, masked)
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: ref_gnn.loss_fn(p, _jnp(batch), ref_cfg))(params)
    model = _model(params, cfg)
    model.requires_grad_(True)
    names, leaves = zip(*_leaves(model.param_tree()))
    before = dict(LAUNCHES)
    loss = gnn.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert LAUNCHES == before, "a CPU gradient launched a kernel"
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    want = dict(_leaves(grads_ref))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert _rel_l1(g.numpy(), want[name]) <= 1e-4, name
    # the plain versions and a prepared batch give the same bits here
    prepared = gnn.prepare_batch(batch, "cpu")
    again = torch.autograd.grad(gnn.loss_fn(model, prepared, kernels=False),
                                leaves)
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


def test_param_tree_is_the_references_pytree():
    ref_cfg, cfg = _cfgs(n_classes=4)
    params = _ref_params(ref_cfg)
    model = _model(params, cfg)
    tree = model.param_tree()
    assert jax.tree.structure(jax.tree.map(lambda _: 0, params)) == (
        jax.tree.structure(jax.tree.map(lambda _: 0, tree)))
    for (name, got), (_, want) in zip(_leaves(tree), _leaves(params)):
        assert np.array_equal(got.detach().numpy(), np.asarray(want)), name
    # load_param_tree copies a tree of other tensors in
    other = gnn.init_params(cfg, seed=5, device="cpu")
    model.load_param_tree(other.param_tree())
    for a, b in zip(tree_leaves(model.param_tree()),
                    tree_leaves(other.param_tree())):
        assert torch.equal(a, b)


def test_adamw_state_from_numpy_walks_lists():
    ref_cfg, _ = _cfgs(n_classes=4)
    state = ref_adamw_init(_ref_params(ref_cfg))
    got = adamw_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    assert isinstance(got["master"]["mlps"], list)
    for part in ("master", "m", "v"):
        for (name, a), (_, b) in zip(_leaves(got[part]),
                                     _leaves(state[part])):
            assert np.array_equal(a.numpy(), np.asarray(b)), (part, name)


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cell_name", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("prepared", [False, True])
def test_train_steps_match_reference(cell_name, prepared, monkeypatch):
    """Three steps of a gin-tu cell (its overrides on the small config),
    the reference's ``build_cell_step`` and the port's, from the same
    state, on one fixed batch; a prepared batch makes the port sort
    nothing."""
    ref_spec = ref_gin_tu.spec()
    spec = gin_tu.spec()
    cell = spec.cells[cell_name]
    assert cell.kind == "train" and cell.overrides == dict(
        ref_spec.cells[cell_name].overrides)
    ov = cell.overrides
    ref_cfg, cfg = _cfgs(**ov)
    ref_spec = dataclasses.replace(ref_spec, model_cfg=ref_cfg)
    ref_step, _, _ = ref_steps.build_cell_step(
        ref_spec, ref_spec.cells[cell_name], {}, RefAdamWConfig(**OCFG))
    ref_step = jax.jit(ref_step)
    params = _ref_params(ref_cfg, seed=1)
    batch = _batch(ov["task"], ov["n_classes"], ov.get("d_out", 1), True,
                   d_feat=ov["d_feat"], seed=1)
    model = _model(params, cfg)
    step = build_cell_step(spec, cell, model, AdamWConfig(**OCFG))
    ref_state = ref_adamw_init(params)
    tree = model.param_tree()
    state = adamw_init(tree)
    port_batch = batch
    if prepared:
        port_batch = gnn.prepare_batch(batch, "cpu")
        monkeypatch.setattr(gnn, "prepare_batch", None)
    for i in range(3):
        params, ref_state, want = ref_step(params, ref_state, _jnp(batch))
        tree, state, got = step(tree, state, port_batch)
        for key in ("loss", "lr", "grad_norm") if i == 0 else ("loss",):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=key)
        assert int(state["step"]) == i + 1
        for part, port, ref in (("params", tree, params),
                                *((k, state[k], ref_state[k])
                                  for k in ("master", "m", "v"))):
            want_leaves = dict(_leaves(ref))
            for name, leaf in _leaves(port):
                assert _rel_l1(leaf.detach().numpy(),
                               want_leaves[name]) <= 1e-4, (i, part, name)


def test_gnn_train_step_writes_the_model():
    _, cfg = _cfgs(n_classes=4)
    model = gnn.init_params(cfg, device="cpu")
    step = gnn_train_step(model, AdamWConfig(**OCFG))
    before = [p.detach().clone() for p in tree_leaves(model.param_tree())]
    tree, _, metrics = step(model.param_tree(),
                            adamw_init(model.param_tree()),
                            _batch("node", 4, 1, True))
    assert bool(torch.isfinite(metrics["loss"]))
    moved = [not torch.equal(a, b)
             for a, b in zip(before, tree_leaves(model.param_tree()))]
    assert all(moved)
    assert tree_leaves(tree)[0] is model.embed.b[0]


# --------------------------------------------------------------------------- #
# data, smoke_setup and the CLI
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_triplets,graph_labels", [(False, True),
                                                        (True, False)])
def test_molecule_batch_is_byte_identical(with_triplets, graph_labels):
    """``molecule_batch`` (and, with triplets, ``build_triplets``) give the
    reference's arrays byte for byte."""
    from repro.data import pipeline as ref_pipeline

    kw = dict(nodes_per_graph=9, edges_per_graph=25, d_feat=5,
              with_triplets=with_triplets, graph_labels=graph_labels, seed=3)
    want = ref_pipeline.molecule_batch(5, **kw)
    got = molecule_batch(5, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k


def test_smoke_setup_matches_reference():
    cfg, batch, family = smoke_setup("gin-tu")
    ref_cfg, ref_batch, ref_family = ref_smoke_setup("gin-tu")
    assert family == ref_family == "gnn"
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert batch.keys() == ref_batch.keys()
    for k in batch:
        assert np.array_equal(batch[k], np.asarray(ref_batch[k])), k


_LOSSES = re.compile(r"loss ([0-9.]+) -> ([0-9.]+) over (\d+) steps")


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_train_cli_matches_reference_cli(tmp_path, monkeypatch):
    """``train --arch gin-tu --steps 3 --device cpu`` from the reference's
    initial state (a step-0 checkpoint of its pytree, lists and all)
    prints the reference CLI's first and last loss."""
    from repro.launch import train as ref_train

    ref_cfg, _, _ = ref_smoke_setup("gin-tu")
    p0 = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0))
    mgr = RefCheckpointManager(str(tmp_path / "port"), async_write=False)
    mgr.save(0, (p0, ref_adamw_init(p0)))
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "gin-tu", "--steps", "3", "--ckpt",
        str(tmp_path / "ref")])
    want = _LOSSES.search(_printed(lambda _: ref_train.main(), None))
    text = _printed(port_train.main, [
        "--arch", "gin-tu", "--steps", "3", "--device", "cpu", "--ckpt",
        str(tmp_path / "port")])
    assert "[gin-tu] reduced config" in text
    assert "[resume] from step 0" in text
    got = _LOSSES.search(text)
    assert got.group(3) == want.group(3) == "3"
    np.testing.assert_allclose([float(got.group(1)), float(got.group(2))],
                               [float(want.group(1)), float(want.group(2))],
                               rtol=1e-4)
    assert float(got.group(2)) < float(got.group(1))
