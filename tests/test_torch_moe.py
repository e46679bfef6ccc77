"""Port parity for MoE serving and the int8 KV cache.

The reference's reduced qwen2-moe-a2.7b (``configs.smoke.smoke_setup``:
2 layers, d=64, 2 heads of 16, 8 experts top-2 with 4 shared, padded to
8, float32) and its GQA variant with one KV head: parameters from the
reference's ``init_params`` with the QKV biases set to non-zero numpy
values, carried across by ``repro_torch.interop.lm_params_from_numpy``.
On the CPU (K5's and K6's plain versions) the port's routing, keep mask,
positions and expert-load counts equal the reference's exactly; its MoE
FFN, prefill, teacher-forced decode and int8 decode are held to the
reference's within rtol 1e-4 / atol 1e-5 (float32 sums in another order
through two layers and the LM head), and the int8 cache and its scales
bit for bit.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.balance.signals import LoadSignal as RefSignal
from repro.configs import get_arch
from repro.configs.smoke import smoke_setup
from repro.models import transformer as ref_lm
from repro_torch.balance.signals import LoadSignal
from repro_torch.configs import get_arch as port_arch
from repro_torch.configs.smoke import lm_shrink
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import segment_sum_ref
from repro_torch.launch.steps import build_cell_step
from repro_torch.models import transformer as lm

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2-moe-a2.7b"
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
# the reference's serving steps, compiled once per (config, shape)
_ref_prefill = jax.jit(ref_lm.prefill_step, static_argnums=(2,),
                       static_argnames=("max_seq",))
_ref_decode = jax.jit(ref_lm.decode_step, static_argnums=(3,))


def _port_cfg(ref_cfg, **over):
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(lm.TransformerConfig)}
    fields["moe"] = lm.MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    fields["dtype"] = torch.float32
    fields.update(over)
    return lm.TransformerConfig(**fields)


@pytest.fixture(scope="module", params=["mha", "gqa"])
def pair(request):
    """(reference cfg, params, tokens; port model) for one variant."""
    ref_cfg, batch, _ = smoke_setup(ARCH)
    if request.param == "gqa":
        ref_cfg = dataclasses.replace(ref_cfg, n_kv_heads=1)
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    layers = dict(params["layers"])
    for name in ("bq", "bk", "bv"):
        layers[name] = jnp.asarray(0.1 * rng.standard_normal(
            layers[name].shape).astype(np.float32))
    params = dict(params, layers=layers)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                 _port_cfg(ref_cfg), device="cpu")
    return ref_cfg, params, np.asarray(batch["tokens"]), model


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


def _ref_routing(lp, x, cfg):
    """The reference's routing, in its own lines (``_moe_ffn``)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xf = x.reshape(t, -1)
    logits = (xf @ lp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_w, gate_i = jax.lax.top_k(probs, m.top_k)
    cap = int(np.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
    flat_e = gate_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, m.n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot - 1).max(axis=-1)
    counts = jnp.bincount(flat_e, length=m.n_experts)
    return [np.asarray(a) for a in (gate_i, pos, pos < cap, counts)]


def test_moe_configs_and_cells_match_reference():
    for arch in MOE_ARCHS:
        ref, ours = get_arch(arch), port_arch(arch)
        assert ours.family == ref.family == "lm" and ours.source == ref.source
        for f in dataclasses.fields(lm.TransformerConfig):
            if f.name not in ("dtype", "moe"):
                assert getattr(ours.model_cfg, f.name) == getattr(
                    ref.model_cfg, f.name), (arch, f.name)
        assert dataclasses.asdict(ours.model_cfg.moe) == dataclasses.asdict(
            ref.model_cfg.moe)
        assert ours.model_cfg.moe.e_pad == ref.model_cfg.moe.e_pad
        assert ours.model_cfg.dtype == torch.bfloat16
        assert ours.model_cfg.n_params == ref.model_cfg.n_params
        assert (ours.model_cfg.n_active_params
                == ref.model_cfg.n_active_params)
        for name in ("prefill_32k", "decode_32k"):
            want, got = ref.cells[name], ours.cells[name]
            ref_inputs = want.inputs()
            assert got.kind == want.kind and got.meta == want.meta
            for key, (shape, _) in got.inputs.items():
                assert shape == ref_inputs[key].shape, (arch, name, key)
    qwen = port_arch(ARCH).model_cfg
    assert (qwen.n_params, qwen.n_active_params) == (14_315_735_040,
                                                     2_689_124_352)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_config_matches_reference(arch):
    ref_cfg, _, _ = smoke_setup(arch)
    ours = lm_shrink(port_arch(arch).model_cfg)
    for f in dataclasses.fields(lm.TransformerConfig):
        if f.name not in ("dtype", "moe"):
            assert getattr(ours, f.name) == getattr(ref_cfg, f.name), f.name
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(ref_cfg.moe)
    assert ours.dtype == torch.float32


def test_moe_params_count_and_names_match_reference(pair):
    """The port draws the reference's leaves under its names and shapes,
    the padded experts included: ``n_params`` plus the dead experts."""
    ref_cfg, params, _, model = pair
    m = ref_cfg.moe
    dead = ref_cfg.n_layers * (m.e_pad - m.n_experts) * 3 * \
        ref_cfg.d_model * m.d_ff_expert
    drawn = lm.init_params(model.cfg, seed=0, device="cpu")
    for name, p in drawn.layers.items():
        assert tuple(p.shape) == params["layers"][name].shape, name
    n_ref = sum(x.size for x in jax.tree.leaves(params))
    assert n_ref == model.cfg.n_params + dead
    assert sum(p.numel() for p in drawn.parameters()) == n_ref


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(pair, capacity_factor):
    """Routing, keep mask, positions and counts exactly; the FFN's output
    and aux within the tolerance; at capacity factor 0.5 slots are
    dropped."""
    ref_cfg, params, _, model = pair
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, capacity_factor=capacity_factor))
    cfg = _port_cfg(ref_cfg)
    x = np.random.default_rng(5).standard_normal((3, 11, 64)).astype(
        np.float32)
    lp_ref = _layer0(params)
    gate_i, pos, keep, counts = _ref_routing(lp_ref, jnp.asarray(x), ref_cfg)
    lp = model.layer(0)
    xt = torch.from_numpy(x)
    _, _, gi = lm._route(lp["router"], xt.reshape(33, 64), cfg.moe)
    flat_e, p, c = lm._slots(gi, cfg.moe)
    _, _, kp, _, _ = lm._dispatch(xt.reshape(33, 64), gi, cfg.moe)
    np.testing.assert_array_equal(gi.numpy(), gate_i)
    np.testing.assert_array_equal(p.numpy(), pos)
    np.testing.assert_array_equal(kp.numpy(), keep)
    np.testing.assert_array_equal(c.numpy(), counts)
    assert capacity_factor > 1 or not keep.all()
    want, want_aux = ref_lm._moe_ffn(lp_ref, jnp.asarray(x), ref_cfg)
    got, aux = lm._moe_ffn(lp, xt, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # the plain combine is the same function on the CPU
    again, _ = lm._moe_ffn(lp, xt, cfg, combine=segment_sum_ref)
    assert torch.equal(got, again)


def test_moe_dispatch_does_not_depend_on_slot_order(pair):
    """A token's k slots in another order (as topk on the card may give
    ties): the same buffer, the same destination for each (token, expert)
    and the same output up to the order of a token's sum."""
    ref_cfg, _, _, model = pair
    cfg = _port_cfg(ref_cfg, moe=dataclasses.replace(
        _port_cfg(ref_cfg).moe, capacity_factor=0.5))
    lp = model.layer(1)
    xf = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (40, 64)).astype(np.float32))
    _, gw, gi = lm._route(lp["router"], xf, cfg.moe)
    perm = torch.from_numpy(np.random.default_rng(7).permuted(
        np.tile(np.arange(cfg.moe.top_k), (40, 1)), axis=1))
    gi2 = gi.gather(1, perm)
    assert not torch.equal(gi, gi2)
    buf, dest, keep, counts, _ = lm._dispatch(xf, gi, cfg.moe)
    buf2, dest2, keep2, counts2, _ = lm._dispatch(xf, gi2, cfg.moe)
    assert torch.equal(buf, buf2) and torch.equal(counts, counts2)
    assert not keep.all()

    def by_pair(g, d, k):
        return {(t // cfg.moe.top_k, int(e)): (int(dd), bool(kk))
                for t, (e, dd, kk) in enumerate(zip(g.reshape(-1), d, k))}

    assert by_pair(gi, dest, keep) == by_pair(gi2, dest2, keep2)


def _check_slot_inverse(gate_i, keep, pos, cap, m, dest, kp, slot):
    """``_dispatch``'s keep and destinations are the reference's keep and
    ``e·cap + pos``; its ``slot`` is the exact inverse of ``rows =
    where(keep, dest, 0)`` over the kept slots (``slot[rows[s]] == s``),
    ``T·k`` at every row no kept slot names; so a slot owns its row
    (``slot[rows[s]] == s``) exactly when it is kept -- the ownership rule
    of the combine backward's stream body."""
    tk = keep.size
    dest, slot = dest.numpy(), slot.numpy()
    np.testing.assert_array_equal(kp.numpy(), keep)
    np.testing.assert_array_equal(dest[keep],
                                  (gate_i.reshape(-1) * cap + pos)[keep])
    assert slot.shape == (m.e_pad * cap,) and slot.dtype == np.int64
    rows = np.where(keep, dest, 0)
    kept = np.flatnonzero(keep)
    np.testing.assert_array_equal(slot[rows[kept]], kept)
    named = np.zeros(slot.size, bool)
    named[rows[kept]] = True
    assert (slot[~named] == tk).all()
    np.testing.assert_array_equal(slot[rows] == np.arange(tk), keep)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_dispatch_slot_inverts_the_kept_rows(pair, capacity_factor):
    """At the model's routing, with and without capacity drops, against
    the reference's keep and positions on the same inputs."""
    ref_cfg, params, _, model = pair
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, capacity_factor=capacity_factor))
    cfg = _port_cfg(ref_cfg)
    x = np.random.default_rng(8).standard_normal((3, 11, 64)).astype(
        np.float32)
    gate_i, pos, keep, _ = _ref_routing(_layer0(params), jnp.asarray(x),
                                        ref_cfg)
    xf = torch.from_numpy(x).reshape(33, 64)
    _, _, gi = lm._route(model.layer(0)["router"], xf, cfg.moe)
    np.testing.assert_array_equal(gi.numpy(), gate_i)
    _, dest, kp, _, slot = lm._dispatch(xf, gi, cfg.moe)
    cap = int(np.ceil(33 * cfg.moe.top_k / cfg.moe.n_experts
                      * capacity_factor))
    _check_slot_inverse(gate_i, keep, pos, cap, cfg.moe, dest, kp, slot)
    assert keep.all() or capacity_factor < 1
    assert capacity_factor > 1 or not keep.all()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_dispatch_slot_inverts_the_kept_rows_at_granite_routing(
        capacity_factor):
    """granite-moe-1b-a400m's MoE (32 experts, top 8) at 512 tokens of a
    skewed routing (numpy), against the reference's keep and positions
    (its one-hot cumsum) on the same experts; capacity drops at both
    factors."""
    m = dataclasses.replace(port_arch("granite-moe-1b-a400m").model_cfg.moe,
                            capacity_factor=capacity_factor)
    t = 512
    rng = np.random.default_rng(9)
    pref = rng.random((t, m.n_experts)) * np.linspace(1.0, 3.0, m.n_experts)
    gate_i = np.argsort(-pref, axis=1)[:, :m.top_k].astype(np.int32)
    flat_e = jnp.asarray(gate_i.reshape(-1))
    onehot = jax.nn.one_hot(flat_e, m.n_experts, dtype=jnp.int32)
    pos = np.asarray((jnp.cumsum(onehot, axis=0) * onehot - 1).max(axis=-1))
    cap = int(np.ceil(t * m.top_k / m.n_experts * capacity_factor))
    keep = pos < cap
    xf = torch.zeros((t, 16))
    _, dest, kp, _, slot = lm._dispatch(xf, torch.from_numpy(gate_i), m)
    _check_slot_inverse(gate_i, keep, pos, cap, m, dest, kp, slot)
    assert 0 < keep.sum() < keep.size


def test_moe_mesh_is_refused(pair):
    _, _, _, model = pair
    x = torch.zeros((1, 2, 64))
    with pytest.raises(NotImplementedError, match="item 7 \\(a\\)"):
        lm._moe(model.layer(0), x, model.cfg, mesh=object())


def test_moe_prefill_and_teacher_forced_decode_match_reference(pair):
    ref_cfg, params, tokens, model = pair
    prompt, max_seq = tokens[:, :24], 32
    ref_cache, ref_logits = _ref_prefill(
        params, jnp.asarray(prompt), ref_cfg, max_seq=max_seq)
    before = dict(LAUNCHES)
    cache, logits = lm.prefill_step(model, prompt, max_seq=max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), **TOL)
    for t in range(24, 32):
        ref_logits, ref_cache = _ref_decode(
            params, ref_cache, jnp.asarray(tokens[:, t]), ref_cfg)
        logits, cache = lm.decode_step(model, cache, tokens[:, t])
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == 32
    assert LAUNCHES == before, "a CPU run launched a kernel"


@jax.jit
def _ref_quantized(cache):
    """The reference's int8 cache of a float cache
    (tests/test_models_lm.py::test_int8_kv_cache_decode), compiled as the
    reference's decode step compiles the same lines (XLA takes the
    division by 127.0 as a product with its float32 reciprocal)."""
    ks = jnp.max(jnp.abs(cache["k"]), axis=-1) / 127.0 + 1e-8
    vs = jnp.max(jnp.abs(cache["v"]), axis=-1) / 127.0 + 1e-8
    return {"k": jnp.clip(jnp.round(cache["k"] / ks[..., None]),
                          -127, 127).astype(jnp.int8),
            "v": jnp.clip(jnp.round(cache["v"] / vs[..., None]),
                          -127, 127).astype(jnp.int8),
            "k_scale": ks.astype(jnp.float32),
            "v_scale": vs.astype(jnp.float32), "pos": cache["pos"]}


INT8_KEYS = ("k", "v", "k_scale", "v_scale")


def test_int8_decode_matches_reference(pair):
    """The int8 cache quantised from the same float cache is the
    reference's bit for bit; four decode steps on it give the reference's
    int8 logits within the tolerance, leave the prompt's entries as they
    were and write entries within one step of the reference's (scales
    within the tolerance); the int8 logits stay within the reference
    test's relative 0.05 of the float cache's."""
    ref_cfg, params, tokens, model = pair
    prompt = tokens[:, :20]
    ref_cache, _ = _ref_prefill(params, jnp.asarray(prompt), ref_cfg,
                                       max_seq=24)
    cache = {"k": torch.from_numpy(np.array(ref_cache["k"])),
             "v": torch.from_numpy(np.array(ref_cache["v"])), "pos": 20}
    ref_q = _ref_quantized(ref_cache)
    q = lm.quantize_cache(cache)
    for key in INT8_KEYS:
        assert q[key].dtype == {"k": torch.int8, "v": torch.int8}.get(
            key, torch.float32)
        np.testing.assert_array_equal(q[key].numpy(), np.asarray(ref_q[key]))
    dense = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in cache.items()}
    for t in range(20, 24):
        ref_logits, ref_q = _ref_decode(
            params, ref_q, jnp.asarray(tokens[:, t]), ref_cfg)
        logits, q = lm.decode_step(model, q, tokens[:, t])
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        float_logits, dense = lm.decode_step(model, dense, tokens[:, t])
        rel = float((logits - float_logits).abs().max()
                    / float_logits.abs().max())
        assert rel < 0.05, rel
    assert q["pos"] == int(ref_q["pos"]) == 24
    for key in INT8_KEYS:
        got, want = q[key].numpy(), np.asarray(ref_q[key])
        np.testing.assert_array_equal(got[:, :, :20], want[:, :, :20])
        # the steps' own entries quantise k / v that equal the reference's
        # within the tolerance, not bit for bit
        if key in ("k", "v"):
            assert np.abs(got.astype(np.int32) - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **TOL)


def test_int8_cache_through_steps_and_init(pair):
    """``launch.steps``' decode passes the int8 cell keys
    (``cache_k_scale`` / ``cache_v_scale``) and equals a direct call;
    ``init_cache(dtype=int8)`` has the reference's int8 cell shapes."""
    _, _, tokens, model = pair
    spec = port_arch(ARCH)
    cache, _ = lm.prefill_step(model, tokens[:, :10], max_seq=12)
    q = lm.quantize_cache(cache)
    q2 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in q.items()}
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)
    got, out = decode({"tokens": tokens[:, 10], "cache_k": q["k"],
                       "cache_v": q["v"], "cache_k_scale": q["k_scale"],
                       "cache_v_scale": q["v_scale"], "pos": q["pos"]})
    want, out2 = lm.decode_step(model, q2, tokens[:, 10])
    assert torch.equal(got, want) and out["pos"] == 11
    for key in INT8_KEYS:
        assert torch.equal(out[key], out2[key])
    c = lm.init_cache(model.cfg, 3, 16, dtype=torch.int8, device="cpu")
    shape = (model.cfg.n_layers, 3, 16, model.cfg.n_kv_heads, 16)
    assert c["k"].shape == c["v"].shape == shape and c["k"].dtype == torch.int8
    assert c["k_scale"].shape == c["v_scale"].shape == shape[:-1]
    assert c["k_scale"].dtype == torch.float32


def test_expert_load_sink_counts_every_slot(pair):
    """The tap hands the sink each dispatch's per-expert counts: ``top_k·T``
    routed slots (dropped ones too), the reference's counts on the same
    input, and nothing once unhooked."""
    ref_cfg, params, _, model = pair
    x = np.random.default_rng(8).standard_normal((2, 8, 64)).astype(
        np.float32)
    seen, ref_seen = [], []
    lm.set_expert_load_sink(seen.append)
    ref_lm.set_expert_load_sink(ref_seen.append)
    try:
        lm._moe_ffn(model.layer(0), torch.from_numpy(x), model.cfg)
        out, _ = jax.jit(lambda lp, x: ref_lm._moe_ffn(lp, x, ref_cfg))(
            _layer0(params), jnp.asarray(x))
        jax.block_until_ready(out)
    finally:
        lm.set_expert_load_sink(None)
        ref_lm.set_expert_load_sink(None)
    assert len(seen) == len(ref_seen) == 1
    assert seen[0].shape == (ref_cfg.moe.n_experts,)
    assert seen[0].sum() == ref_cfg.moe.top_k * 16
    np.testing.assert_array_equal(seen[0], ref_seen[0])
    lm._moe_ffn(model.layer(0), torch.from_numpy(x), model.cfg)
    assert len(seen) == 1
    got = LoadSignal.from_expert_counts(seen[0], step=3)
    want = RefSignal.from_expert_counts(ref_seen[0], step=3)
    assert got.kind == want.kind == "expert-tokens" and got.step == 3
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    shards = np.arange(1, ref_cfg.moe.n_experts + 1)
    np.testing.assert_array_equal(
        LoadSignal.from_expert_counts(np.zeros(8), shards).values,
        RefSignal.from_expert_counts(np.zeros(8), shards).values)


def _rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).sum() / np.abs(b).sum()


def test_bf16_moe_prefill_and_decode_stay_near_reference(pair):
    """The production dtype, as the dense model's bf16 test: the same
    weights rounded to bf16 through both packages' prefill and 8
    teacher-forced decode steps, the port within 2x the reference's own
    distance from a float32 run of the same bf16 weights.  The port's
    combine sums in float32 (K5's bf16-row form), the reference's in
    bf16."""
    ref_cfg, params, tokens, _ = pair
    cfg16 = dataclasses.replace(ref_cfg, dtype=jnp.bfloat16)
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), p16)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, p32),
                                 _port_cfg(ref_cfg, dtype=torch.bfloat16),
                                 device="cpu")
    prompt, max_seq = tokens[:, :24], 32

    def reference(ps, cfg):
        cache, logits = _ref_prefill(ps, jnp.asarray(prompt), cfg,
                                            max_seq=max_seq)
        out = [logits]
        for t in range(24, 32):
            logits, cache = _ref_decode(
                ps, cache, jnp.asarray(tokens[:, t]), cfg)
            out.append(logits)
        return [np.asarray(x, np.float32) for x in out]

    want, exact = reference(p16, cfg16), reference(p32, ref_cfg)
    cache, logits = lm.prefill_step(model, prompt, max_seq=max_seq)
    got = [logits]
    for t in range(24, 32):
        logits, cache = lm.decode_step(model, cache, tokens[:, t])
        got.append(logits)
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        assert _rel_l1(g, w) <= 2 * _rel_l1(w, e), i


def test_serve_cli_moe_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
         ARCH, "--device", "cpu", "--batch", "2", "--prompt", "12", "--gen",
         "5"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x12" in out.stdout and "decode 4 steps" in out.stdout
    assert len(eval(out.stdout.split("generated ids:")[1].strip())) == 5
