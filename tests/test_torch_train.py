"""Port parity for LM training: ``train_loss`` and its gradients, the
train step of ``launch.steps``, ``runtime.TrainLoop`` with its monitors,
and ``launch/train.py``.

The reference's reduced configs (``configs.smoke.smoke_setup``: 2 layers,
d=64, Dh 16, float32, ``ce_chunk`` 16) of qwen1.5-0.5b (dense, QKV bias),
granite-moe-1b-a400m (8 experts top 2) and qwen2-moe-a2.7b (8 experts top
2 and 4 shared), parameters from the reference's ``init_params`` with the
QKV biases set to non-zero numpy values, carried across by
``repro_torch.interop.lm_params_from_numpy``; the batch
``lm_token_batch(0, 2, 32, vocab)``.  On the CPU the wrappers run the
kernels' plain versions (K6's backward, the combine's backward, K5 for
the dispatch's).  Tolerances, float32 sums in another order throughout:

* the loss within rtol 1e-5, every gradient leaf within relative L1 1e-4
  of ``jax.value_and_grad``'s;
* remat on and off, and the kernels' paths against the plain versions,
  give the same bits on the CPU;
* a step of the reference's ``build_cell_step`` train kind
  (``n_microbatches`` 2) and the port's: loss, lr and gradient norm
  within rtol 1e-5; three steps: losses within rtol 1e-4, the
  parameters within relative L1 1e-4 (AdamW's first steps move every
  entry by about lr, whatever its gradient, so an entry whose gradient
  is rounding noise in both may move either way: the key bias ``bk``,
  which shifts every score of a query alike, has such a gradient
  throughout);
* the MoE FFN's gradients through the dispatch and the combine, with
  dropped slots, within relative L1 1e-5 a leaf (gradients up to 20 in
  magnitude);
* ``TrainLoop``: a crash and resume give the run's metrics bit for bit;
  a checkpoint cut by the reference's loop resumes in the port's and
  continues the reference's losses within rtol 1e-4; the expert-load
  monitor's plans, fed through the tap under remat, equal the
  reference's; the monitors on the reference tests' inputs give its
  plans and logs;
* the CLI's losses within rtol 1e-4 of the reference CLI's, from the
  same initial state.
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

from repro.balance.signals import LoadSignal as RefSignal
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_arch as ref_arch
from repro.configs.smoke import smoke_setup as ref_smoke_setup
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_lm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.runtime import ExpertLoadMonitor as RefExpertLoadMonitor
from repro.runtime import StragglerMonitor as RefStragglerMonitor
from repro.runtime import TrainLoop as RefTrainLoop
from repro.runtime import TrainLoopConfig as RefTrainLoopConfig
from repro_torch.balance.signals import LoadSignal
from repro_torch.configs import get_arch
from repro_torch.configs.smoke import smoke_setup
from repro_torch.data import lm_token_batch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import (moe_combine, moe_dispatch,
                                         segment_sum_ref, segment_sum_sorted)
from repro_torch.kernels.segment.backward import moe_combine_bwd
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import build_cell_step, lm_train_step
from repro_torch.models import transformer as lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (ExpertLoadMonitor, StragglerMonitor,
                                 TrainLoop, TrainLoopConfig)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

ARCHS = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "qwen2-moe-a2.7b")
OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _port_cfg(ref_cfg, **over):
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(lm.TransformerConfig)}
    if ref_cfg.moe is not None:
        fields["moe"] = lm.MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    fields["dtype"] = torch.float32
    fields.update(over)
    return lm.TransformerConfig(**fields)


def _ref_params(ref_cfg, seed=1):
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed))
    if not ref_cfg.qkv_bias:
        return params
    rng = np.random.default_rng(seed + 1)
    layers = dict(params["layers"])
    for name in ("bq", "bk", "bv"):
        layers[name] = jnp.asarray(0.1 * rng.standard_normal(
            layers[name].shape).astype(np.float32))
    return dict(params, layers=layers)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{n}" if n else k, leaf) for k in sorted(tree)
                for n, leaf in _leaves(tree[k])]
    return [("", tree)]


def _rel_l1(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30)


def _port_grads(model, batch, cfg=None, kernels=True):
    model.requires_grad_(True)
    loss = lm.train_loss(model, batch, cfg, kernels=kernels)
    names, leaves = zip(*_leaves(model.param_tree()))
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, reference params, numpy batch)."""
    ref_cfg, _, _ = ref_smoke_setup(request.param)
    params = _ref_params(ref_cfg)
    batch = lm_token_batch(0, 2, 32, ref_cfg.vocab)
    return request.param, ref_cfg, params, batch


def _model(ref_cfg, params, **over):
    return lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                _port_cfg(ref_cfg, **over), device="cpu")


def test_smoke_setup_matches_reference():
    for arch in ARCHS:
        cfg, batch, family = smoke_setup(arch)
        ref_cfg, ref_batch, ref_family = ref_smoke_setup(arch)
        assert family == ref_family == "lm"
        assert cfg == _port_cfg(ref_cfg)
        for k in ("tokens", "labels"):
            assert np.array_equal(batch[k], np.asarray(ref_batch[k]))
    # the other GNN archs are ported (item 7 (c)): their reduced configs
    # and batches are the reference's
    for arch in ("meshgraphnet", "egnn", "dimenet"):
        cfg, batch, family = smoke_setup(arch)
        ref_cfg, ref_batch, ref_family = ref_smoke_setup(arch)
        assert family == ref_family == "gnn"
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), (
                    arch, f.name)
        assert batch.keys() == ref_batch.keys()
        for k in batch:
            assert np.array_equal(batch[k], np.asarray(ref_batch[k])), k


def test_train_cells_match_reference():
    for arch in ARCHS:
        want, got = ref_arch(arch).cells["train_4k"], get_arch(arch).cells[
            "train_4k"]
        assert got.kind == want.kind == "train"
        assert got.meta == want.meta and got.overrides == want.overrides
        ref_inputs = want.inputs()
        assert got.inputs.keys() == ref_inputs.keys()
        for key, (shape, _) in got.inputs.items():
            assert shape == ref_inputs[key].shape


def test_train_loss_and_grads_match_reference(pair):
    arch, ref_cfg, params, batch = pair
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.train_loss(p, jax.tree.map(jnp.asarray, batch),
                                    ref_cfg)))(params)
    model = _model(ref_cfg, params)
    before = dict(LAUNCHES)
    loss, grads = _port_grads(model, batch)
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    want = dict(_leaves(grads_ref))
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert _rel_l1(g.numpy(), want[name]) <= 1e-4, (arch, name)


def test_remat_and_plain_versions_give_the_same_bits(pair):
    arch, ref_cfg, params, batch = pair
    model = _model(ref_cfg, params)
    loss, grads = _port_grads(model, batch)
    no_remat = dataclasses.replace(model.cfg, remat=False)
    for cfg, kernels in ((no_remat, True), (None, False)):
        loss2, grads2 = _port_grads(model, batch, cfg, kernels=kernels)
        assert torch.equal(loss, loss2)
        for name, g in grads.items():
            assert torch.equal(g, grads2[name]), (arch, name, kernels)


def _ref_train_step(spec, cell, ocfg):
    step, _, _ = ref_steps.build_cell_step(spec, cell, {}, ocfg)
    return jax.jit(step)


def test_microbatched_steps_match_reference(pair):
    """Three steps of the train cell at ``n_microbatches`` 2, the
    reference's ``build_cell_step`` and the port's, each from the same
    state, on the batches of steps 0-2."""
    arch, ref_cfg, params, _ = pair
    spec = dataclasses.replace(ref_arch(arch), model_cfg=ref_cfg)
    ref_cell = dataclasses.replace(spec.cells["train_4k"],
                                   overrides={"n_microbatches": 2})
    ref_step = _ref_train_step(spec, ref_cell, RefAdamWConfig(**OCFG))
    port_spec = get_arch(arch)
    cell = dataclasses.replace(port_spec.cells["train_4k"],
                               overrides={"n_microbatches": 2})
    model = _model(ref_cfg, params)
    step = build_cell_step(port_spec, cell, model, AdamWConfig(**OCFG))
    ref_state = ref_adamw_init(params)
    tree, state = model.param_tree(), adamw_init(model.param_tree())
    for i in range(3):
        batch = lm_token_batch(i, 2, 32, ref_cfg.vocab)
        params, ref_state, want = ref_step(
            params, ref_state, jax.tree.map(jnp.asarray, batch))
        tree, state, got = step(tree, state, batch)
        tol = 1e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=tol)
        if i == 0:
            for key in ("lr", "grad_norm"):
                np.testing.assert_allclose(float(got[key]), float(want[key]),
                                           rtol=1e-5)
    want = dict(_leaves(params))
    for name, p in _leaves(tree):
        assert _rel_l1(p.detach().numpy(), want[name]) <= 1e-4, (arch, name)


def test_train_step_with_one_microbatch_is_train_loss_gradient():
    """At ``n_microbatches`` 1 the step's update is AdamW on
    ``train_loss``'s gradient (checked through the first moment, which
    is 0.1 of the gradient after one step)."""
    ref_cfg, _, _ = ref_smoke_setup("granite-moe-1b-a400m")
    params = _ref_params(ref_cfg)
    batch = lm_token_batch(0, 2, 32, ref_cfg.vocab)
    model = _model(ref_cfg, params)
    _, grads = _port_grads(_model(ref_cfg, params), batch)
    step = lm_train_step(model, AdamWConfig(grad_clip=0.0))
    _, state, metrics = step(model.param_tree(), adamw_init(
        model.param_tree()), batch)
    for name, m in _leaves(state["m"]):
        np.testing.assert_allclose(m.numpy(), 0.1 * grads[name].numpy(),
                                   rtol=1e-6, atol=0)
    assert float(metrics["grad_norm"]) == 0.0


# --------------------------------------------------------------------------- #
# the MoE FFN's gradient paths
# --------------------------------------------------------------------------- #
MOE_KEYS = ("router", "ew1", "ew3", "ew2", "sw1", "sw3", "sw2")


def test_moe_ffn_gradients_match_reference_with_dropped_slots():
    ref_cfg, _, _ = ref_smoke_setup("qwen2-moe-a2.7b")
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, capacity_factor=0.5))
    params = _ref_params(ref_cfg)
    lp_ref = {k: params["layers"][k][0] for k in MOE_KEYS}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    g_out = rng.standard_normal((2, 16, 64)).astype(np.float32)

    def f(lp, x):
        out, aux = ref_lm._moe_ffn(lp, x, ref_cfg)
        return jnp.sum(out * g_out) + 3.0 * aux

    want = jax.grad(f, argnums=(0, 1))(lp_ref, jnp.asarray(x))
    cfg = _port_cfg(ref_cfg)
    gi = lm._route(torch.tensor(np.asarray(lp_ref["router"])),
                   torch.from_numpy(x).reshape(32, 64), cfg.moe)[2]
    assert not bool(lm._dispatch(torch.from_numpy(x).reshape(32, 64), gi,
                                 cfg.moe)[2].all()), "no slot was dropped"
    results = []
    for plain in (False, True):
        lp = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in lp_ref.items()}
        xt = torch.tensor(x, requires_grad=True)
        out, aux = lm._moe_ffn(
            lp, xt, cfg, segment_sum_ref if plain else segment_sum_sorted)
        grads = torch.autograd.grad(
            (out * torch.from_numpy(g_out)).sum() + 3.0 * aux,
            [*lp.values(), xt])
        results.append(grads)
        for g, name in zip(grads, [*lp, "x"]):
            w = want[1] if name == "x" else want[0][name]
            assert _rel_l1(g.numpy(), w) <= 1e-5, name
    for a, b in zip(*results):
        assert torch.equal(a, b)


def _combine_case(seed, t=12, k=3, rows_n=40, d=8, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((rows_n, d)).astype(
        np.float32)).to(dtype)
    keep = torch.from_numpy(rng.random(t * k) < 0.7)
    dest = torch.from_numpy(rng.permutation(rows_n)[:t * k])
    rows = torch.where(keep, dest, 0)
    w = torch.where(keep, torch.from_numpy(rng.random(t * k).astype(
        np.float32)), 0.0)
    seg = torch.arange(t, dtype=torch.int32).repeat_interleave(k)
    slot = torch.full((rows_n + 1,), t * k, dtype=torch.int64)
    slot.scatter_(0, torch.where(keep, dest, rows_n), torch.arange(t * k))
    return data, seg, w, rows, slot[:rows_n], keep


def test_combine_backward_is_autograd_of_its_plain_version():
    """The combine's backward (plain on the CPU) against autograd through
    ``segment_sum_ref`` (index_select, weighted index_add_): equal
    gradients for the rows and the weights; a dropped slot's weight
    gradient is its row-0 dot, as the plain version's."""
    data, seg, w, rows, slot, keep = _combine_case(0)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (12, 8)).astype(np.float32))
    leaves = [data.clone().requires_grad_(True), w.clone().requires_grad_(
        True)]
    out = segment_sum_ref(leaves[0], seg, 12, leaves[1], rows)
    want = torch.autograd.grad((out * g).sum(), leaves)
    grad_w, grad_data = moe_combine_bwd(g, data, seg, w, rows, slot)
    np.testing.assert_allclose(grad_data.numpy(), want[0].numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(grad_w.numpy(), want[1].numpy(), rtol=1e-6,
                               atol=1e-7)
    out2 = moe_combine(*(t.clone().requires_grad_(True) for t in (data,)),
                       seg, 12, weights=w, rows=rows, slot=slot)
    assert torch.equal(out2.detach(), out.detach())


def test_dispatch_backward_sums_each_tokens_kept_slots():
    data, seg, w, rows, slot, keep = _combine_case(3, d=6)
    t, k = 12, 3
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (t, 6)).astype(np.float32)).requires_grad_(True)
    src = slot // k
    for plain in (False, True):
        buf = moe_dispatch(x, src, seg_ids=seg, dest=rows, keep=keep,
                           combine=segment_sum_ref if plain
                           else segment_sum_sorted)
        g = torch.from_numpy(np.random.default_rng(5).standard_normal(
            buf.shape).astype(np.float32))
        (got,) = torch.autograd.grad((buf * g).sum(), [x])
        want = torch.zeros(t, 6).index_add_(
            0, torch.arange(t).repeat_interleave(k)[keep], g[rows[keep]])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
        empty = src == t
        assert bool((buf[empty] == 0).all())


# --------------------------------------------------------------------------- #
# the runtime
# --------------------------------------------------------------------------- #
def _port_loop(ref_cfg, params, ckpt, steps, **loop_kw):
    model = _model(ref_cfg, params)
    step = lm_train_step(model, AdamWConfig(**OCFG))

    def init_state():
        return model.param_tree(), adamw_init(model.param_tree())

    return TrainLoop(step, lambda i: lm_token_batch(i, 2, 32, ref_cfg.vocab),
                     init_state, TrainLoopConfig(total_steps=steps,
                                                 ckpt_dir=str(ckpt),
                                                 ckpt_every=2, **loop_kw))


def _ref_loop(ref_cfg, params, ckpt, steps, **loop_kw):
    ocfg = RefAdamWConfig(**OCFG)

    @jax.jit
    def step_fn(p, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda q: ref_lm.train_loss(q, batch, ref_cfg))(p)
        p, opt, m = ref_adamw_update(grads, opt, ocfg, param_dtype=jnp.float32)
        return p, opt, {"loss": loss, **m}

    def batch(i):
        return jax.tree.map(jnp.asarray, lm_token_batch(i, 2, 32,
                                                        ref_cfg.vocab))

    return RefTrainLoop(step_fn, batch,
                        lambda: (params, ref_adamw_init(params)),
                        RefTrainLoopConfig(total_steps=steps,
                                           ckpt_dir=str(ckpt), ckpt_every=2,
                                           **loop_kw))


def test_train_loop_crash_and_resume_give_the_same_metrics(tmp_path):
    ref_cfg, _, _ = ref_smoke_setup("qwen1.5-0.5b")
    params = _ref_params(ref_cfg)
    full = _port_loop(ref_cfg, params, tmp_path / "full", 5).run()
    crashed = _port_loop(ref_cfg, params, tmp_path / "crash", 5,
                         crash_at_step=3)
    with pytest.raises(RuntimeError, match="injected fault at step 3"):
        crashed.run()
    resumed = _port_loop(ref_cfg, params, tmp_path / "crash", 5).run()
    assert [m["step"] for m in resumed["metrics"]] == [2, 3, 4]
    for got, want in zip(resumed["metrics"], full["metrics"][2:]):
        for key in ("loss", "lr", "grad_norm"):
            assert got[key] == want[key], key
    for (name, a), (_, b) in zip(_leaves(resumed["params"]),
                                 _leaves(full["params"])):
        assert torch.equal(a, b), name
    assert full["opt_state"]["step"].dtype == torch.int32
    assert int(full["opt_state"]["step"]) == 5


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's loop cuts a checkpoint at step 2; the port's loop
    resumes from it and continues the reference's loss trajectory."""
    ref_cfg, _, _ = ref_smoke_setup("qwen1.5-0.5b")
    params = _ref_params(ref_cfg)
    whole = _ref_loop(ref_cfg, params, tmp_path / "ref", 5).run()
    _ref_loop(ref_cfg, params, tmp_path / "cut", 2).run()
    port = _port_loop(ref_cfg, params, tmp_path / "cut", 5).run()
    assert [m["step"] for m in port["metrics"]] == [2, 3, 4]
    np.testing.assert_allclose([m["loss"] for m in port["metrics"]],
                               [m["loss"] for m in whole["metrics"][2:]],
                               rtol=1e-4)


def test_expert_load_monitor_through_the_tap_matches_reference(tmp_path):
    """Both loops on the reduced granite-moe-1b-a400m (8 experts) with
    ``moe_experts=8``: the tap fires in each layer's forward and again in
    its recomputation (remat, as ``jax.debug.callback`` under
    ``jax.checkpoint`` does in the reference), and the monitor's shard
    ledger and plan log come out the reference's."""
    ref_cfg, _, _ = ref_smoke_setup("granite-moe-1b-a400m")
    params = _ref_params(ref_cfg)
    ref = _ref_loop(ref_cfg, params, tmp_path / "ref", 3, moe_experts=8)
    ref.run()
    port = _port_loop(ref_cfg, params, tmp_path / "port", 3, moe_experts=8)
    port.run()
    assert lm._expert_load_sink is None
    n_calls = 3 * 2 * ref_cfg.n_layers  # steps x (forward + recompute)
    assert port.expert_monitor._step == ref.expert_monitor._step == n_calls
    assert np.array_equal(port.expert_monitor.shards,
                          ref.expert_monitor.shards)
    assert ([dataclasses.astuple(p) for p in port.expert_monitor.executor.log]
            == [dataclasses.astuple(p)
                for p in ref.expert_monitor.executor.log])


def _plans(monitor):
    return [dataclasses.astuple(p) for p in monitor.executor.log]


def test_straggler_monitor_matches_reference():
    """tests/test_substrates.py's and tests/test_balance.py's inputs."""
    for times, z in (([0.1, 0.1, 0.1, 0.8], 2), ([0.1, 0.1, 0.1, 0.9], 2),
                     ([0.3, 0.1, 0.2, 0.1], 10)):
        ours, ref = StragglerMonitor(4, z=z), RefStragglerMonitor(4, z=z)
        for _ in range(8):
            got, want = ours.advise(np.array(times)), ref.advise(
                np.array(times))
            assert (got is None) == (want is None)
            if got is not None:
                assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert _plans(ours) == _plans(ref)
        ours.reseed()
        ref.reseed()
        assert np.array_equal(ours.policy.ctl.slope, ref.policy.ctl.slope)
        assert np.array_equal(ours.policy.ctl.cooldown,
                              ref.policy.ctl.cooldown)


def test_expert_load_monitor_matches_reference():
    ours, ref = ExpertLoadMonitor(n_experts=4, z=2), RefExpertLoadMonitor(
        n_experts=4, z=2)
    for counts in ([900.0, 10.0, 10.0, 10.0],) * 8 + ([5.0, 5, 400, 5],) * 4:
        got, want = ours.observe(np.array(counts)), ref.observe(
            np.array(counts))
        assert ([dataclasses.astuple(p) for p in got]
                == [dataclasses.astuple(p) for p in want])
    assert _plans(ours) == _plans(ref) and _plans(ours)
    assert np.array_equal(ours.shards, ref.shards)
    assert ours.observe(np.array([1.0, 2.0])) == []


def test_on_world_change_reseeds_or_rebuilds(tmp_path):
    ref_cfg, _, _ = ref_smoke_setup("qwen1.5-0.5b")
    loop = _port_loop(ref_cfg, _ref_params(ref_cfg), tmp_path, 1,
                      n_hosts=4)
    for _ in range(6):
        loop.monitor.advise(np.array([0.1, 0.1, 0.1, 0.9]))
    loop.on_world_change(4)
    assert (loop.monitor.policy.ctl.slope == 0).all()
    loop.on_world_change(3)
    assert loop.monitor.n_hosts == 3


@pytest.mark.parametrize("units", [None, np.array([5, 6, 7])])
def test_from_step_times_matches_reference(units):
    secs = np.array([0.25, 0.0, 1.5])
    got = LoadSignal.from_step_times(secs, units, step=4)
    want = RefSignal.from_step_times(secs, units, step=4)
    assert got.kind == want.kind == "step-time" and got.step == want.step
    assert np.array_equal(got.values, want.values)
    assert np.array_equal(got.sizes, want.sizes)


# --------------------------------------------------------------------------- #
# launch/train.py
# --------------------------------------------------------------------------- #
_LOSSES = re.compile(r"loss ([0-9.]+) -> ([0-9.]+) over (\d+) steps")


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_train_cli_matches_reference_cli(tmp_path, monkeypatch):
    """The port's CLI resumes from the reference's initial state (its
    ``init_params(PRNGKey(0))`` and ``adamw_init``, saved as a step-0
    checkpoint) and prints the reference CLI's falling losses."""
    from repro.launch import train as ref_train

    ref_cfg, _, _ = ref_smoke_setup("qwen1.5-0.5b")
    p0 = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    mgr = RefCheckpointManager(str(tmp_path / "port"), async_write=False)
    mgr.save(0, (p0, ref_adamw_init(p0)))
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen1.5-0.5b", "--steps", "4", "--ckpt",
        str(tmp_path / "ref")])
    want = _LOSSES.search(_printed(lambda _: ref_train.main(), None))
    text = _printed(port_train.main, [
        "--arch", "qwen1.5-0.5b", "--steps", "4", "--device", "cpu",
        "--ckpt", str(tmp_path / "port")])
    assert "[resume] from step 0" in text
    got = _LOSSES.search(text)
    assert got.group(3) == want.group(3) == "4"
    np.testing.assert_allclose([float(got.group(1)), float(got.group(2))],
                               [float(want.group(1)), float(want.group(2))],
                               rtol=1e-4)
    assert float(got.group(2)) < float(got.group(1))


def test_train_cli_wants_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_train.main(["--arch", "qwen1.5-0.5b", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="7 \\(a\\)"):
        port_train.main(["--arch", "command-r-plus-104b", "--steps", "1",
                         "--device", "cpu"])
    from repro_torch.models import gnn

    with pytest.raises(NotImplementedError, match="7 \\(d\\)"):
        gnn.loss_fn(gnn.init_params(gnn.GNNConfig(
            name="g", arch="gin", n_layers=1, d_hidden=4, d_feat=3),
            device="cpu"), {"src_slot": np.zeros(3, np.int32)})
