"""Port parity for FM training: K4's backward, the embedding gather's
gradient on K5, ``loss_fn``, the recsys train step, ``TrainLoop`` and
``launch/train.py --arch fm``.

The reference's FM parameters (``repro.models.recsys.init_params``, the
linear table and bias made non-zero) are carried across by
``repro_torch.interop.fm_params_from_numpy``; batches are
``criteo_like_batch``'s zipf(1.2) ids, whose rows repeat heavily (a
field's id 0 takes about a sixth of a batch), so the gather's gradient
sums many rows into one.  On the CPU the wrappers run the kernels' plain
versions.  Tolerances, float32 sums in another order throughout:

* K4's backward within rtol 1e-5 / atol 1e-5 of ``jax.vjp``'s (each entry
  the difference of a sum of F terms of order 1 and one of them: at F=39
  the sum is of order 6, whose ulp is 5e-7), the gather's gradients
  within rtol 1e-5 / atol 1e-6 (rows repeated up to a few hundred times,
  values of order 1);
* the loss within rtol 1e-5, every gradient leaf within relative L1 1e-4
  of ``jax.value_and_grad``'s;
* three train steps of ``build_cell_step``, the parameters and the AdamW
  state (master, m, v) after each within relative L1 1e-4 of the
  reference's, the step counts equal;
* a checkpoint cut by the reference's ``TrainLoop`` resumes in the
  port's, continuing the reference's losses within rtol 1e-4;
* the CLI's first and last loss within rtol 1e-4 of the reference CLI's,
  from the same initial state.
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
from repro.configs import fm as ref_fm_cfg
from repro.configs.smoke import smoke_setup as ref_smoke_setup
from repro.kernels.fm.ref import fm_interaction_ref as jax_fm_interaction
from repro.launch import steps as ref_steps
from repro.models import recsys as ref_recsys
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.runtime import TrainLoop as RefTrainLoop
from repro.runtime import TrainLoopConfig as RefTrainLoopConfig
from repro_torch.configs import fm as fm_cfg
from repro_torch.configs.smoke import smoke_setup
from repro_torch.data import criteo_like_batch
from repro_torch.interop import fm_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fm import (fm_interaction_bwd_kernel,
                                    fm_interaction_bwd_ref,
                                    fm_interaction_train)
from repro_torch.kernels.segment import (embedding_gather, segment_sum_ref,
                                         segment_sum_sorted)
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import build_cell_step, fm_train_step
from repro_torch.models import recsys
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import TrainLoop, TrainLoopConfig

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

REF_CFG = ref_recsys.FMConfig(name="fm", n_fields=8, vocab_per_field=50,
                              embed_dim=6)
CFG = recsys.FMConfig(name="fm", n_fields=8, vocab_per_field=50, embed_dim=6)
OCFG = dict(lr=3e-2, warmup_steps=2, total_steps=10)
TOL = dict(rtol=1e-5, atol=1e-6)


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)


def _ref_params(cfg, seed=0):
    params = ref_recsys.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return dict(params,
                lin_table=jnp.asarray(rng.standard_normal(cfg.n_rows)
                                      .astype(np.float32) * 0.1),
                bias=jnp.float32(0.25))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    return _ref_params(REF_CFG)


def _model(params, cfg=CFG):
    return fm_params_from_numpy(_np(params), cfg, device="cpu")


# --------------------------------------------------------------------------- #
# K4's backward and the gather's gradient against jax.vjp
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,f,d", [(1, 2, 1), (7, 6, 8), (33, 39, 10)])
def test_fm_interaction_bwd_ref_matches_jax_grad(b, f, d):
    rng = np.random.default_rng(b + f + d)
    v = rng.standard_normal((b, f, d)).astype(np.float32)
    dy = rng.standard_normal(b).astype(np.float32)
    _, vjp = jax.vjp(jax_fm_interaction, jnp.asarray(v))
    (want,) = vjp(jnp.asarray(dy))
    got = fm_interaction_bwd_ref(torch.from_numpy(v), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the wrapper runs the plain version for CPU tensors, launching nothing
    before = dict(LAUNCHES)
    assert torch.equal(fm_interaction_bwd_kernel(torch.from_numpy(v),
                                                 torch.from_numpy(dy)), got)
    vt = torch.from_numpy(v).requires_grad_(True)
    (auto,) = torch.autograd.grad(fm_interaction_train(vt),
                                  [vt], torch.from_numpy(dy))
    assert LAUNCHES == before
    assert torch.equal(auto, got)


@pytest.mark.parametrize("bag", [1, 8])
@pytest.mark.parametrize("plain", [False, True])
def test_embedding_gather_gradient_matches_jax_vjp(bag, plain):
    """The gather's backward (K5's gather form over the rows sorted by row
    id; on the CPU its plain version) against ``jax.vjp`` of the
    reference's ``table[rows]`` (``bag`` 1, the ``[400, 6]`` table) and
    of ``lin_table[rows].reshape(b, f).sum(-1)`` (``bag`` 8, the linear
    table), on zipf ids with many repeats."""
    ids = criteo_like_batch(2, 1200, 8, 50)["ids"]
    rows = (ids + np.arange(8, dtype=np.int32) * 50).reshape(-1)
    rng = np.random.default_rng(3)
    shape = (400, 6) if bag == 1 else (400,)
    table = rng.standard_normal(shape).astype(np.float32)
    n_out = rows.size // bag
    g = rng.standard_normal((n_out,) + shape[1:]).astype(np.float32)
    assert np.bincount(rows).max() > 100

    def ref(t):
        out = t[jnp.asarray(rows)]
        return out if bag == 1 else out.reshape(-1, bag).sum(-1)

    _, vjp = jax.vjp(ref, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    rows_t = torch.from_numpy(rows)
    out = embedding_gather(t, rows_t, bag=bag, segment_sum=(
        segment_sum_ref if plain else segment_sum_sorted))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref(jnp.asarray(table))), **TOL)
    (got,) = torch.autograd.grad(out, [t], torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a sort handed in gives the same bits
    order = torch.sort(rows_t, stable=True).indices
    out = embedding_gather(t, rows_t, order, bag=bag)
    assert torch.equal(torch.autograd.grad(out, [t], torch.from_numpy(g))[0],
                       got)


# --------------------------------------------------------------------------- #
# loss_fn and the train step
# --------------------------------------------------------------------------- #
def _ref_grads(params, batch, cfg=REF_CFG):
    return jax.value_and_grad(lambda p: ref_recsys.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), cfg))(params)


@pytest.mark.parametrize("kernels", [True, False])
def test_fm_loss_and_grads_match_reference(params, kernels):
    batch = criteo_like_batch(1, 256, 8, 50)
    loss_ref, grads_ref = _ref_grads(params, batch)
    model = _model(params)
    model.requires_grad_(True)
    tree = model.param_tree()
    before = dict(LAUNCHES)
    loss = recsys.loss_fn(model, batch, kernels=kernels)
    grads = torch.autograd.grad(loss, list(tree.values()))
    assert LAUNCHES == before, "a CPU gradient launched a kernel"
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    for (name, _), g in zip(tree.items(), grads):
        assert g.shape == tree[name].shape
        assert _rel_l1(g.numpy(), grads_ref[name]) <= 1e-4, name
    # rows no id reads get exactly 0, as the reference's scatter gives them
    assert np.array_equal(grads[2].numpy() == 0,
                          np.asarray(grads_ref["table"]) == 0)


def test_forward_logits_with_a_gradient_is_servings():
    """The training forward (the autograd ops) gives the serving
    forward's logits."""
    model = _model(_ref_params(REF_CFG, seed=2))
    ids = criteo_like_batch(4, 64, 8, 50)["ids"]
    serve = recsys.forward_logits(model, ids)
    model.requires_grad_(True)
    train = recsys.forward_logits(model, ids)
    assert train.requires_grad
    np.testing.assert_allclose(train.detach().numpy(), serve.numpy(),
                               rtol=1e-6, atol=1e-6)


def _ref_step(cfg, ocfg):
    spec = dataclasses.replace(ref_fm_cfg.spec(), model_cfg=cfg)
    step, _, _ = ref_steps.build_cell_step(spec, spec.cells["train_batch"],
                                           {}, ocfg)
    return jax.jit(step)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{n}" if n else k, leaf) for k in sorted(tree)
                for n, leaf in _leaves(tree[k])]
    return [("", tree)]


def test_train_steps_match_reference(params):
    """Three steps of the ``train_batch`` cell, the reference's
    ``build_cell_step`` and the port's, from the same state, on the
    batches of steps 0-2: loss, lr and gradient norm, then the parameters
    and the AdamW state after each step."""
    ref_step = _ref_step(REF_CFG, RefAdamWConfig(**OCFG))
    spec = dataclasses.replace(fm_cfg.spec(), model_cfg=CFG)
    model = _model(params)
    step = build_cell_step(spec, spec.cells["train_batch"], model,
                           AdamWConfig(**OCFG))
    ref_state = ref_adamw_init(params)
    tree = model.param_tree()
    state = adamw_init(tree)
    for i in range(3):
        batch = criteo_like_batch(i, 128, 8, 50)
        params, ref_state, want = ref_step(
            params, ref_state, jax.tree.map(jnp.asarray, batch))
        tree, state, got = step(tree, state, batch)
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        for part, port, ref in (("params", tree, params),
                                *((k, state[k], ref_state[k])
                                  for k in ("master", "m", "v"))):
            want_leaves = dict(_leaves(ref))
            for name, leaf in _leaves(port):
                assert _rel_l1(leaf.detach().numpy(),
                               want_leaves[name]) <= 1e-4, (i, part, name)


def test_fm_train_step_holds_the_models_own_tensors():
    """The step writes the new parameters into the model and returns its
    own tensors; a restored tree is copied in first."""
    model = recsys.FM(CFG, seed=1, device="cpu")
    step = fm_train_step(model, AdamWConfig(**OCFG))
    restored = {k: v.detach().clone() + 1.0
                for k, v in model.param_tree().items()}
    tree, state, _ = step(restored, adamw_init(restored),
                          criteo_like_batch(0, 32, 8, 50))
    assert all(tree[k] is v for k, v in model.param_tree().items())
    assert model.table.requires_grad
    # AdamW moved the restored values, not the model's old ones
    assert float((model.bias - restored["bias"]).abs().detach()) < 0.1


# --------------------------------------------------------------------------- #
# TrainLoop and the CLI
# --------------------------------------------------------------------------- #
def _smoke():
    ref_cfg, _, _ = ref_smoke_setup("fm")
    cfg, batch, family = smoke_setup("fm")
    return ref_cfg, cfg, batch, family


def test_smoke_setup_matches_reference():
    ref_cfg, cfg, batch, family = _smoke()
    _, ref_batch, ref_family = ref_smoke_setup("fm")
    assert family == ref_family == "recsys"
    assert (cfg.n_fields, cfg.vocab_per_field, cfg.embed_dim) == (
        ref_cfg.n_fields, ref_cfg.vocab_per_field, ref_cfg.embed_dim)
    for k in ("ids", "labels"):
        assert np.array_equal(batch[k], np.asarray(ref_batch[k]))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's loop over the FM smoke config cuts a checkpoint at
    step 2; the port's loop resumes from it and continues the
    reference's losses."""
    ref_cfg, cfg, _, _ = _smoke()
    params = _ref_params(ref_cfg, seed=1)
    ocfg = RefAdamWConfig(**OCFG)

    @jax.jit
    def ref_step(p, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda q: ref_recsys.loss_fn(q, batch, ref_cfg))(p)
        p, opt, m = ref_adamw_update(grads, opt, ocfg,
                                     param_dtype=jnp.float32)
        return p, opt, {"loss": loss, **m}

    def batch(i):
        return criteo_like_batch(i, 32, cfg.n_fields, cfg.vocab_per_field)

    def ref_loop(ckpt, steps):
        return RefTrainLoop(
            ref_step, lambda i: jax.tree.map(jnp.asarray, batch(i)),
            lambda: (params, ref_adamw_init(params)),
            RefTrainLoopConfig(total_steps=steps, ckpt_dir=str(ckpt),
                               ckpt_every=2))

    whole = ref_loop(tmp_path / "ref", 5).run()
    ref_loop(tmp_path / "cut", 2).run()
    model = recsys.FM(cfg, seed=7, device="cpu")
    port = TrainLoop(fm_train_step(model, AdamWConfig(**OCFG)), batch,
                     lambda: (model.param_tree(),
                              adamw_init(model.param_tree())),
                     TrainLoopConfig(total_steps=5,
                                     ckpt_dir=str(tmp_path / "cut"),
                                     ckpt_every=2)).run()
    assert [m["step"] for m in port["metrics"]] == [2, 3, 4]
    np.testing.assert_allclose([m["loss"] for m in port["metrics"]],
                               [m["loss"] for m in whole["metrics"][2:]],
                               rtol=1e-4)


_LOSSES = re.compile(r"loss ([0-9.]+) -> ([0-9.]+) over (\d+) steps")


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_train_cli_matches_reference_cli(tmp_path, monkeypatch):
    """``train --arch fm --steps 3 --device cpu`` from the reference's
    initial state (saved as a step-0 checkpoint) prints the reference
    CLI's first and last loss."""
    from repro.launch import train as ref_train

    ref_cfg, _, _, _ = _smoke()
    p0 = ref_recsys.init_params(ref_cfg, jax.random.PRNGKey(0))
    mgr = RefCheckpointManager(str(tmp_path / "port"), async_write=False)
    mgr.save(0, (p0, ref_adamw_init(p0)))
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "fm", "--steps", "3", "--ckpt",
        str(tmp_path / "ref")])
    want = _LOSSES.search(_printed(lambda _: ref_train.main(), None))
    text = _printed(port_train.main, [
        "--arch", "fm", "--steps", "3", "--device", "cpu", "--ckpt",
        str(tmp_path / "port")])
    assert "[fm] reduced config" in text and "[resume] from step 0" in text
    got = _LOSSES.search(text)
    assert got.group(3) == want.group(3) == "3"
    np.testing.assert_allclose([float(got.group(1)), float(got.group(2))],
                               [float(want.group(1)), float(want.group(2))],
                               rtol=1e-4)
