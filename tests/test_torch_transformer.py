"""Port parity for LM serving: config, data, model, steps and the CLI.

The reference's reduced qwen1.5-0.5b (``configs.smoke.smoke_setup``:
2 layers, d=64, 2 heads of 16, float32) and its GQA variant with one KV
head: parameters from the reference's ``init_params`` with the QKV biases
set to non-zero numpy values, carried across by
``repro_torch.interop.lm_params_from_numpy``.  The port's
``prefill_step`` / ``decode_step`` on the CPU (K6's plain version) are
held to the reference's within rtol 1e-4 / atol 1e-5: float32 sums in
another order through two layers and the LM head, on logits of order 1.
``lm_token_batch`` must be byte-identical.
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

from repro.configs import get_arch
from repro.configs.smoke import smoke_setup
from repro.data import pipeline as ref_pipeline
from repro.models import transformer as ref_lm
from repro_torch.configs import get_arch as port_arch
from repro_torch.configs.smoke import lm_shrink
from repro_torch.data import lm_token_batch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.steps import build_cell_step
from repro_torch.models import transformer as lm

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"


def _port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(lm.TransformerConfig)}
    fields["dtype"] = torch.float32
    return lm.TransformerConfig(**fields)


def _fields():
    """The config fields both packages hold, dtype aside (the training
    knobs included)."""
    return [f.name for f in dataclasses.fields(lm.TransformerConfig)
            if f.name != "dtype"]


@pytest.fixture(scope="module", params=["mha", "gqa"])
def pair(request):
    """(reference cfg, params, tokens; port model) for one variant."""
    ref_cfg, batch, _ = smoke_setup(ARCH)
    if request.param == "gqa":
        ref_cfg = dataclasses.replace(ref_cfg, n_kv_heads=1)
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    layers = dict(params["layers"])
    for name in ("bq", "bk", "bv"):
        layers[name] = jnp.asarray(0.1 * rng.standard_normal(
            layers[name].shape).astype(np.float32))
    params = dict(params, layers=layers)
    np_params = jax.tree.map(np.asarray, params)
    model = lm_params_from_numpy(np_params, _port_cfg(ref_cfg),
                                 device="cpu")
    return ref_cfg, params, np.asarray(batch["tokens"]), model


def test_reduced_config_matches_reference():
    ref_cfg, _, _ = smoke_setup(ARCH)
    ours = lm_shrink(port_arch(ARCH).model_cfg)
    for name in _fields():
        assert getattr(ours, name) == getattr(ref_cfg, name), name
    assert ours.dtype == torch.float32


def test_full_config_and_cells_match_reference():
    ref, ours = get_arch(ARCH), port_arch(ARCH)
    assert ours.family == ref.family == "lm" and ours.source == ref.source
    for name in _fields():
        assert getattr(ours.model_cfg, name) == getattr(ref.model_cfg,
                                                        name), name
    assert ours.model_cfg.dtype == torch.bfloat16
    assert ours.model_cfg.n_params == ref.model_cfg.n_params == 619_570_176
    for name in ("prefill_32k", "decode_32k"):
        want, got = ref.cells[name], ours.cells[name]
        assert got.kind == want.kind and got.meta == want.meta
        ref_inputs = want.inputs()
        assert got.inputs.keys() == ref_inputs.keys()
        for key, (shape, _) in got.inputs.items():
            assert shape == ref_inputs[key].shape, (name, key)


@pytest.mark.parametrize("step", [0, 5])
def test_lm_token_batch_is_byte_identical(step):
    want = ref_pipeline.lm_token_batch(step, 3, 40, 151936, seed=1)
    got = lm_token_batch(step, 3, 40, 151936, seed=1)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])


def test_prefill_and_teacher_forced_decode_match_reference(pair):
    ref_cfg, params, tokens, model = pair
    prompt, max_seq = tokens[:, :24], 32
    ref_cache, ref_logits = ref_lm.prefill_step(
        params, jnp.asarray(prompt), ref_cfg, max_seq=max_seq)
    before = dict(LAUNCHES)
    cache, logits = lm.prefill_step(model, prompt, max_seq=max_seq)
    assert logits.dtype == torch.float32 and logits.shape == (2, 128)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    for key in ("k", "v"):
        assert cache[key].shape == ref_cache[key].shape
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), **TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == 24
    for t in range(24, 32):
        ref_logits, ref_cache = ref_lm.decode_step(
            params, ref_cache, jnp.asarray(tokens[:, t]), ref_cfg)
        logits, cache = lm.decode_step(model, cache, tokens[:, t])
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == 32
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), **TOL)
    assert LAUNCHES == before, "a CPU run launched a kernel"


def _rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).sum() / np.abs(b).sum()


def test_bf16_prefill_and_decode_stay_near_reference(pair):
    """The production dtype: the same weights rounded to bf16 through both
    packages' prefill and 8 teacher-forced decode steps.  bf16 rounds at
    other places in the two (the reference's einsum rounds its scores to
    bf16, K6 keeps them in float32), so the port is held, per logits
    array, to within 2x the reference's own distance from a float32 run of
    the same bf16 weights, and to the reference's argmax."""
    ref_cfg, params, tokens, _ = pair
    cfg16 = dataclasses.replace(ref_cfg, dtype=jnp.bfloat16)
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    p32 = jax.tree.map(lambda x: x.astype(jnp.float32), p16)
    port_cfg = dataclasses.replace(_port_cfg(ref_cfg), dtype=torch.bfloat16)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, p32), port_cfg,
                                 device="cpu")
    prompt, max_seq = tokens[:, :24], 32

    def reference(ps, cfg):
        cache, logits = ref_lm.prefill_step(ps, jnp.asarray(prompt), cfg,
                                            max_seq=max_seq)
        out = [logits]
        for t in range(24, 32):
            logits, cache = ref_lm.decode_step(
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
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def test_decode_matches_prefill(pair):
    """Teacher-forced decode reproduces the prefill logits (the reference's
    test_models_lm.py::test_decode_matches_prefill, on the port alone)."""
    _, _, tokens, model = pair
    toks = tokens[:, :16]
    _, want = lm.prefill_step(model, toks)
    cache, _ = lm.prefill_step(model, toks[:, :8], max_seq=16)
    snapshot = cache["k"].clone()
    for t in range(8, 16):
        last, new = lm.decode_step(model, cache, toks[:, t])
        # the step writes the new k / v in place and moves pos on
        assert new["k"] is cache["k"] and new["pos"] == cache["pos"] + 1
        cache = new
    assert torch.equal(cache["k"][:, :, :8], snapshot[:, :, :8])
    np.testing.assert_allclose(last.numpy(), want.numpy(), **TOL)


def test_steps_match_direct_calls(pair):
    _, _, tokens, model = pair
    spec = port_arch(ARCH)
    prefill = build_cell_step(spec, spec.cells["prefill_32k"], model)
    decode = build_cell_step(spec, spec.cells["decode_32k"], model)
    cache, logits = prefill({"tokens": tokens[:, :20], "max_seq": 22})
    c2, l2 = lm.prefill_step(model, tokens[:, :20], max_seq=22)
    assert torch.equal(logits, l2) and torch.equal(cache["k"], c2["k"])
    got, cache = decode({"tokens": tokens[:, 20], "cache_k": cache["k"],
                         "cache_v": cache["v"], "pos": cache["pos"]})
    want, c2 = lm.decode_step(model, c2, tokens[:, 20])
    assert torch.equal(got, want) and cache["pos"] == c2["pos"] == 21
    assert torch.equal(cache["v"], c2["v"])


def test_n_params_matches_reference_formula_and_module(pair):
    ref_cfg, params, _, model = pair
    n_ref = sum(x.size for x in jax.tree.leaves(params))
    assert model.cfg.n_params == ref_cfg.n_params == n_ref
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_cache_shapes_and_moe_refused():
    """The cache's shapes; a MoE config (once refused) builds, counts its
    parameters as the reference's formula does, and its int8 cache has
    the shapes of the reference's int8 cell (``k`` / ``v`` int8, float32
    scales without the head dim)."""
    cfg = lm.TransformerConfig(name="tiny", n_layers=2, d_model=32,
                               n_heads=4, n_kv_heads=2, d_ff=64, vocab=61,
                               qkv_bias=True, dtype=torch.float32)
    c = lm.init_cache(cfg, batch=3, max_seq=64, device="cpu")
    assert c["k"].shape == c["v"].shape == (2, 3, 64, 2, 8)
    assert c["pos"] == 0
    moe = dict(n_experts=6, top_k=2, d_ff_expert=16, n_shared=1,
               pad_experts_to=8)
    ours = dataclasses.replace(cfg, moe=lm.MoEConfig(**moe))
    ref = ref_lm.TransformerConfig(
        name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=61, qkv_bias=True, dtype=jnp.float32,
        moe=ref_lm.MoEConfig(**moe))
    assert ours.n_params == ref.n_params
    assert ours.n_active_params == ref.n_active_params < ours.n_params
    c8 = lm.init_cache(ours, batch=3, max_seq=64, dtype=torch.int8,
                       device="cpu")
    assert c8["k"].shape == c8["v"].shape == (2, 3, 64, 2, 8)
    assert c8["k"].dtype == c8["v"].dtype == torch.int8
    assert c8["k_scale"].shape == c8["v_scale"].shape == (2, 3, 64, 2)
    assert c8["k_scale"].dtype == torch.float32


def test_rope_and_rmsnorm_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    np.testing.assert_allclose(
        lm.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                10_000.0).numpy(),
        np.asarray(ref_lm.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        **TOL)
    y = rng.standard_normal((4, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        lm.rmsnorm(torch.from_numpy(y), torch.from_numpy(s), 1e-5).numpy(),
        np.asarray(ref_lm.rmsnorm(jnp.asarray(y), jnp.asarray(s), 1e-5)),
        **TOL)


def test_serve_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
         ARCH, "--device", "cpu", "--batch", "2", "--prompt", "12", "--gen",
         "5"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill 2x12" in out.stdout and "decode 4 steps" in out.stdout
    ids = out.stdout.split("generated ids:")[1]
    assert len(eval(ids.strip())) == 5
