"""Port parity for the optimizer (``repro_torch.optim``, AdamW with float32
master weights).

The port's ``adamw_update`` is held to the reference's on the same
gradients, carried across by ``repro_torch.interop.adamw_state_from_numpy``
(master, moments and step), within rtol 1e-6 on the new parameters, the
moments and the metrics: the same float32 arithmetic op for op, where
XLA may fuse a product and a sum into one rounding.  With clipping on,
the clip's scale comes from a float32 global norm summed in another
order and may differ by one rounding, which an entry where the moment's
two terms cancel carries over at the scale of the terms: there the
leaves are also allowed an atol of 1e-6 of the leaf's largest
magnitude.  The learning-rate
schedules at steps 0-200 and ``clip_by_global_norm`` are held to the
reference within one float32 rounding (rtol 3e-7: ``cos`` and ``pow``
are two libraries' float32 functions, the global norm a float32 sum in
another order).  The reference's own optimizer tests are ported as
they are.  Gradient compression (``optim.compression``) is held to the
reference exactly: int8 ``q`` and ``scale`` equal (one float32 division
each, rounding half to even), the error-feedback top-k's sent entries
and residual equal, and ``sent + residual == g + r`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro_torch.interop import adamw_state_from_numpy
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               linear_warmup)
from repro_torch.optim import (compress_int8, decompress_int8,
                               ef_topk_compress, ef_topk_init)
from repro_torch.optim.adamw import _lr_at

torch.set_num_threads(1)

ULP = dict(rtol=3e-7, atol=0)


def _ref_cfg(cfg):
    return ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))


def _tree(seed, scale=1.0):
    """A nested tree of float32 numpy leaves, some entries near zero."""
    rng = np.random.default_rng(seed)
    t = {"embed": rng.standard_normal((7, 5)),
         "layers": {"wq": rng.standard_normal((2, 5, 6)),
                    "ln1": rng.standard_normal((2, 5)) * 1e-6},
         "lm_head": rng.standard_normal((5, 7))}
    return jax.tree.map(lambda a: (a * scale).astype(np.float32), t)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(a, dtype=dtype), tree)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference_on_the_same_grads(schedule, clip):
    cfg = AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=20,
                      schedule=schedule, grad_clip=clip)
    params = _tree(0)
    ref_state = ref_adamw.adamw_init(jax.tree.map(jnp.asarray, params))
    state = adamw_init(_torch(params))
    for step in range(4):
        # the state as the reference holds it, carried across each step
        state = adamw_state_from_numpy(jax.tree.map(np.asarray, ref_state),
                                       device="cpu")
        grads = _tree(10 + step, scale=3.0)
        want_p, ref_state, want_m = ref_adamw.adamw_update(
            jax.tree.map(jnp.asarray, grads), ref_state, _ref_cfg(cfg),
            param_dtype=jnp.float32)
        got_p, state, got_m = adamw_update(_torch(grads), state, cfg,
                                           param_dtype=torch.float32)
        for got, want in ((got_p, want_p), (state["master"],
                                            ref_state["master"]),
                          (state["m"], ref_state["m"]),
                          (state["v"], ref_state["v"])):
            jax.tree.map(lambda g, w: np.testing.assert_allclose(
                g.numpy(), np.asarray(w), rtol=1e-6,
                atol=1e-6 * float(np.abs(w).max()) if clip else 0.0),
                got, want)
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        assert state["step"].dtype == torch.int32
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(got_m[key]),
                                       float(want_m[key]), rtol=1e-6)


def test_schedules_match_reference_at_every_step():
    steps = np.arange(0, 201, dtype=np.int32)
    for schedule in ("cosine", "linear", "constant"):
        cfg = AdamWConfig(lr=3e-4, warmup_steps=25, total_steps=150,
                          schedule=schedule)
        want = np.asarray(ref_adamw._lr_at(jnp.asarray(steps),
                                           _ref_cfg(cfg)))
        got = _lr_at(torch.from_numpy(steps), cfg).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, **ULP, err_msg=schedule)
    cfg = AdamWConfig(warmup_steps=25, total_steps=150)
    for ours, theirs in ((linear_warmup, ref_adamw.linear_warmup),
                         (cosine_schedule, ref_adamw.cosine_schedule)):
        np.testing.assert_allclose(
            ours(torch.from_numpy(steps), cfg).numpy(),
            np.asarray(theirs(jnp.asarray(steps), _ref_cfg(cfg))), **ULP)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(3, scale=5.0)
    want, want_n = ref_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    got, got_n = clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(got_n), float(want_n), **ULP)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), **ULP), got, want)


# the reference's optimizer tests (tests/test_substrates.py), ported
def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, grad_clip=0)
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(g, opt, cfg, param_dtype=torch.float32)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clip():
    g = {"a": torch.full((100,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 99
    total = float(torch.sqrt(sum((x ** 2).sum() for x in clipped.values())))
    assert abs(total - 1.0) < 1e-5


def test_bf16_master_weights():
    cfg = AdamWConfig(lr=1e-3)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt["master"]["w"].dtype == torch.float32
    new_p, opt, _ = adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)},
                                 opt, cfg)
    assert new_p["w"].dtype == torch.bfloat16
    assert opt["master"]["w"].dtype == torch.float32


def test_adamw_state_from_numpy_keeps_the_reference_layout():
    params = _tree(5)
    ref_state = jax.tree.map(np.asarray, ref_adamw.adamw_init(
        jax.tree.map(jnp.asarray, params)))
    state = adamw_state_from_numpy(ref_state, device="cpu")
    ours = adamw_init(_torch(params))
    assert state.keys() == ours.keys()
    assert state["step"].dtype == ours["step"].dtype == torch.int32
    for name in ("master", "m", "v"):
        jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail(name),
                     state[name], ours[name])


# --------------------------------------------------------------------------- #
# gradient compression
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scale", [1.0, 1e-4, 0.0])
def test_compress_int8_matches_reference(scale):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
    x[0, :3] = [0.5, -0.5, 1.5]  # ties of round-half-to-even
    q_ref, s_ref = ref_compression.compress_int8(jnp.asarray(x))
    q, s = compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(q_ref))
    assert s.numpy().tobytes() == np.asarray(s_ref).tobytes()
    deq = decompress_int8(q, s)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(ref_compression.decompress_int8(q_ref,
                                                                s_ref)))
    assert float((deq - torch.from_numpy(x)).abs().max()) <= float(s) + 1e-7


@pytest.mark.parametrize("k_frac", [0.1, 0.5, 1e-4])
def test_ef_topk_matches_reference_and_keeps_the_error(k_frac):
    """Two rounds of error-feedback top-k over a tree of dicts and lists
    (GIN's pytree shape), the second fed the first's residual: the sent
    entries and the residual equal to the reference's, ``sent +
    residual == g + r``, ties at the threshold all sent."""
    rng = np.random.default_rng(8)
    grads = [{"a": rng.standard_normal(256).astype(np.float32),
              "b": [rng.standard_normal((7, 9)).astype(np.float32)]}
             for _ in range(2)]
    grads[0]["a"][:40] = 3.0  # a tie at the threshold
    ref_state = ref_compression.ef_topk_init(jax.tree.map(jnp.asarray,
                                                          grads[0]))
    state = ef_topk_init(_torch(grads[0]))
    for g in grads:
        sent_ref, ref_state = ref_compression.ef_topk_compress(
            jax.tree.map(jnp.asarray, g), ref_state, k_frac=k_frac)
        r_before = state.residual
        sent, state = ef_topk_compress(_torch(g), state, k_frac=k_frac)
        for got, want in ((sent, sent_ref), (state.residual,
                                             ref_state.residual)):
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                a.numpy(), np.asarray(b)), got, want)
        jax.tree.map(lambda s_, r, g_, r0: np.testing.assert_array_equal(
            (s_ + r).numpy(), (torch.from_numpy(g_) + r0).numpy()),
            sent, state.residual, g, r_before)
    assert float((sent["a"] == 3.0).sum()) in (0.0, 40.0)
