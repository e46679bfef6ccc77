"""Port parity for K6's backward (the gradient of attention in training).

The reference's model differentiates its einsum attention
(``repro.models.transformer._attention``) with XLA; the port's gradient is
K6's backward (``csrc/attention_bwd.cu``), whose plain version
``attention_bwd_plain`` runs for CPU tensors.  Here that plain version,
and the autograd op ``flash_attention_train`` around it, are held to
``jax.grad`` of the reference's attention on the same numpy inputs, in
float32, within rtol 1e-5 / atol 1e-6 (float32 sums in another order; the
gradients are of order 1).  The plain forward's logsumexp (the L that
K6's training forward writes for the wgmma backward) is held to
``jax.nn.logsumexp`` of the reference's scores, in base 2, within 1e-5
absolute plus relative.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, ``-m cuda -k attention_bwd``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_lm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.attention import (attention_bwd_plain,
                                           attention_plain,
                                           attention_train_plain,
                                           flash_attention_bwd,
                                           flash_attention_train)
from repro_torch.kernels.attention.kernel import flash_attention_lse

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(b, hq, hkv, s, dh, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, hq, dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, dh)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    return q, k, v, do


def _ref_grads(q, k, v, do, causal):
    """jax.grad of <_attention(q, k, v), do> in the reference's [B, S, H,
    Dh] layout."""
    def f(q, k, v):
        out = ref_lm._attention(q, k, v, causal=causal)
        return jnp.sum(out * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port(a):
    """[B, S, H, Dh] numpy -> the port's [B, H, S, Dh] view."""
    return torch.from_numpy(a).transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [1, 17, 64])
def test_attention_bwd_plain_matches_jax_grad(s, dh, hq, hkv, causal):
    q, k, v, do = _inputs(2, hq, hkv, s, dh, seed=s * dh + hq + hkv)
    want = _ref_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = (_port(a) for a in (q, k, v, do))
    o = attention_plain(tq, tk, tv, causal=causal)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(tq, tk, tv, o, tdo, causal=causal)
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    plain = attention_bwd_plain(tq, tk, tv, o, tdo, causal=causal)
    for g, p, w, name in zip(got, plain, want, "qkv"):
        assert torch.equal(g, p), name
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("op", [flash_attention_train, attention_train_plain])
def test_attention_train_ops_give_the_reference_gradients(op):
    """The autograd ops: forward equal to ``attention_plain``, gradients
    through ``torch.autograd`` equal to jax.grad's (GQA 4/2, S 33)."""
    q, k, v, do = _inputs(2, 4, 2, 33, 16, seed=7)
    want = _ref_grads(q, k, v, do, True)
    leaves = [_port(a).clone().requires_grad_(True) for a in (q, k, v)]
    out = op(*leaves, causal=True)
    assert torch.equal(out.detach(), attention_plain(
        *(t.detach() for t in leaves), causal=True))
    got = torch.autograd.grad((out * _port(do)).sum(), leaves)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, **TOL,
                                   err_msg=f"d{name}")


def test_attention_bwd_refuses_what_it_does_not_take():
    q, k, v, do = (_port(a) for a in _inputs(1, 4, 2, 8, 16, seed=0))
    o = attention_plain(q, k, v, causal=True)
    with pytest.raises(ValueError, match="does not match"):
        flash_attention_bwd(q, k, v, o[:, :2], do, causal=True)
    with pytest.raises(ValueError, match="does not match"):
        flash_attention_bwd(q, k, v, o, do.double(), causal=True)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_train(q, k, v, causal=True, kv_len=4)


def _ref_log2_sum_exp(q, k, causal):
    """log2 of the row sums of exp over the reference's scaled scores (its
    [B, S, H, Dh] layout, GQA by repeating k), by ``jax.nn.logsumexp``."""
    group = q.shape[2] // k.shape[2]
    kk = jnp.repeat(k, group, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((n, n), bool)), s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1) / np.log(2.0))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 2)])
@pytest.mark.parametrize("s,dh", [(17, 16), (65, 64), (130, 128)])
def test_attention_plain_lse_matches_jax_logsumexp(s, dh, hq, hkv, causal):
    """``attention_plain(..., lse=True)`` and the training forward's CPU
    path (``flash_attention_lse``): o as the plain forward's, and L, base 2,
    within 1e-5 (absolute plus relative) of jax's logsumexp."""
    q, k, v, _ = _inputs(2, hq, hkv, s, dh, seed=3 * s + hq + hkv + causal)
    want = _ref_log2_sum_exp(q, k, causal)
    tq, tk, tv = (_port(a) for a in (q, k, v))
    o, lse = attention_plain(tq, tk, tv, causal=causal, lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, hq, s)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, attention_plain(tq, tk, tv, causal=causal))
    before = dict(LAUNCHES)
    o2, lse2 = flash_attention_lse(tq, tk, tv, causal=causal)
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert o2.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,s", [(4, 2, 33), (2, 2, 70)])
def test_attention_train_op_matches_jax_value_and_grad(hq, hkv, s, causal):
    """The autograd op ``flash_attention_train`` (its plain versions on
    the CPU): ``<out, do>`` and its gradients against
    ``jax.value_and_grad`` of the reference's attention."""
    q, k, v, do = _inputs(2, hq, hkv, s, 16, seed=11 * s + hq)

    def f(q, k, v):
        return jnp.sum(ref_lm._attention(q, k, v, causal=causal) * do)

    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [_port(a).clone().requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_train(*leaves, causal=causal)
    loss = (out * _port(do)).sum()
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-5,
                               atol=1e-5)
    for g, w, name in zip(got, grads, "qkv"):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   **TOL, err_msg=f"d{name}")


def _k6_bwd_probe():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1]
            / "tools/k6_bwd_probe.py")
    spec = importlib.util.spec_from_file_location("k6_bwd_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", list(_k6_bwd_probe().VARIANTS))
def test_k6_bwd_probe_edits_find_their_text(variant):
    """Every source edit of tools/k6_bwd_probe.py finds its text, once, in
    csrc/attention_bwd.cu, so the probe cannot rot."""
    probe = _k6_bwd_probe()
    edits = probe.VARIANTS[variant]
    src = probe.edited_source(variant, [])
    got = probe.edited_source(variant, edits)
    assert edits
    for old, new in edits:
        assert src.count(old) == 1
        assert new in got
    assert got != src
