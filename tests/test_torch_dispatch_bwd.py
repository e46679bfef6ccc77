"""A dropped MoE slot reads no row, and the dispatch's backward.

The reference masks a dropped slot with ``jnp.where(keep, ..., 0.0)`` in
the dispatch and the combine (``repro.models.transformer._moe_ffn``), so a
dropped slot adds exact zeros whatever the experts' outputs hold, in the
forward and in the gradient.  The port names row -1 for a dropped slot in
the combine and hands the dispatch's backward its ``keep`` mask, so that
no dropped slot reads a row.  Here, on the CPU (the plain versions):

* the reduced MoE configs with one expert's outputs planted at inf: the
  port's ``_moe_ffn`` is finite on exactly the tokens where the
  reference's is, and equal there within rtol 1e-4 / atol 1e-5;
* a non-finite ``g`` in buffer rows that only dropped slots name never
  reaches the dispatch's gradient, plain or through autograd, and a
  non-finite expert output that only dropped slots name never reaches the
  combine's output or its gradients;
* the plain dispatch backward (:func:`dispatch_bwd_ref`) against a float64
  sum of each token's kept slots at top 1 to 8, with tokens whose every
  slot is dropped, and bit for bit against a float32 sum in slot order;
* every source edit of ``tools/dispatch_bwd_probe.py`` finds its text in
  ``csrc/dispatch_bwd.cu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_setup
from repro.models import transformer as ref_lm
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels.segment import (dispatch_bwd_kernel,
                                         dispatch_bwd_ref, moe_combine,
                                         moe_dispatch, segment_sum_bwd_ref,
                                         segment_sum_ref, segment_sum_sorted)
from repro_torch.models import transformer as lm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")


def _port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(lm.TransformerConfig)}
    fields["moe"] = lm.MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    fields["dtype"] = torch.float32
    return lm.TransformerConfig(**fields)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_with_an_expert_at_inf_is_finite_where_the_reference_is(
        arch):
    """Expert 0's ``ew2`` at inf, capacity factor 0.5: the port's FFN
    output is non-finite on exactly the reference's tokens (those that
    keep a slot at expert 0) and within the tolerance elsewhere, with the
    kernels' path and with the plain combine; no token goes non-finite
    through a dropped slot."""
    ref_cfg, _, _ = smoke_setup(arch)
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, capacity_factor=0.5))
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(3))
    layers = dict(params["layers"])
    layers["ew2"] = layers["ew2"].at[0, 0].set(jnp.inf)
    params = dict(params, layers=layers)
    cfg = _port_cfg(ref_cfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    x = np.random.default_rng(5).standard_normal((3, 11, 64)).astype(
        np.float32)
    lp_ref = {k: v[0] for k, v in params["layers"].items()}
    want, _ = ref_lm._moe_ffn(lp_ref, jnp.asarray(x), ref_cfg)
    want = np.asarray(want).reshape(33, 64)
    finite = np.isfinite(want)
    # the plant bites: some tokens are lost in the reference, some kept
    assert 0 < finite.all(-1).sum() < 33
    xt = torch.from_numpy(x)
    _, _, gi = lm._route(model.layer(0)["router"], xt.reshape(33, 64),
                         cfg.moe)
    _, _, keep, _, _ = lm._dispatch(xt.reshape(33, 64), gi, cfg.moe)
    assert not bool(keep.all())
    for combine in (segment_sum_sorted, segment_sum_ref):
        got, _ = lm._moe_ffn(model.layer(0), xt, cfg, combine)
        got = got.reshape(33, 64).numpy()
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], want[finite], **TOL)


def _slots(rng, n, k, n_rows, all_dropped=3):
    """``(dest, keep)`` of ``n`` tokens of ``k`` slots: distinct buffer
    rows for the kept slots, a dropped slot's dest anywhere (a row of a
    kept slot, a row no slot keeps, or past the buffer), and the first
    ``all_dropped`` tokens with every slot dropped."""
    m = n * k
    keep = rng.random(m) < 0.6
    keep[:all_dropped * k] = False
    dest = rng.permutation(n_rows)[:m].astype(np.int64)
    drop = np.flatnonzero(~keep)
    dest[drop] = rng.integers(0, n_rows + 5, drop.size)
    return torch.from_numpy(dest), torch.from_numpy(keep)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_plain_dispatch_backward_sums_each_tokens_kept_slots(k, dtype):
    """Each token's kept slots' rows summed: against a float64 sum within
    k float32 roundings (and one rounding into bf16), bit for bit against
    a float32 sum from +0 in slot order rounded once, zeros for a token
    whose every slot is dropped; the wrapper on the CPU is the plain
    version."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(k)
    n, d, n_rows = 40, 24, 400
    dest, keep = _slots(rng, n, k, n_rows)
    g = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(
        np.float32)).to(dt)
    got = dispatch_bwd_ref(g, dest, keep, n)
    assert got.dtype == dt and got.shape == (n, d)
    assert torch.equal(dispatch_bwd_kernel(g, dest, keep, n), got)
    rows, kept = dest.reshape(n, k), keep.reshape(n, k)
    want64 = torch.zeros(n, d, dtype=torch.float64)
    seq = torch.zeros(n, d)
    for t in range(n):
        for j in range(k):
            if kept[t, j]:
                want64[t] += g[rows[t, j]].double()
                seq[t] = seq[t] + g[rows[t, j]].float()
    assert torch.equal(got, seq.to(dt))
    assert bool((got[:3] == 0).all()) and not bool((got[3:] == 0).all())
    mag = torch.zeros(n, d, dtype=torch.float64)
    for t in range(n):
        for j in range(k):
            if kept[t, j]:
                mag[t] += g[rows[t, j]].double().abs()
    bound = k * 2.0**-24 * mag + (2.0**-8 * want64.abs()
                                  if dt == torch.bfloat16 else 0)
    assert bool(((got.double() - want64).abs() <= bound).all())


@pytest.mark.parametrize("plain", [False, True])
def test_dropped_slots_keep_a_non_finite_g_out_of_the_dispatch_gradient(
        plain):
    """NaN and inf in every buffer row that no kept slot names (the rows
    the dropped slots name among them): the gradient of ``x`` through
    :func:`moe_dispatch` is finite and is the sum of the kept slots' rows,
    plain and on the kernels' path (the plain version on the CPU)."""
    rng = np.random.default_rng(11)
    n, k, d, n_rows = 30, 4, 16, 200
    dest, keep = _slots(rng, n, k, n_rows)
    free = torch.ones(n_rows, dtype=torch.bool)
    free[dest[keep]] = False
    dest[~keep] = torch.from_numpy(rng.choice(
        free.nonzero()[:, 0].numpy(), int((~keep).sum())))
    g = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(
        np.float32))
    g[free] = torch.where(torch.from_numpy(rng.random((int(free.sum()), d))
                                           < 0.5), torch.inf, torch.nan)
    assert bool(free[dest[~keep]].all())
    src = torch.full((n_rows,), n)
    src[dest[keep]] = torch.arange(n * k)[keep] // k
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).requires_grad_(True)
    buf = moe_dispatch(x, src, dest=dest, keep=keep,
                       combine=segment_sum_ref if plain
                       else segment_sum_sorted)
    (gx,) = torch.autograd.grad(buf, [x], g)
    assert bool(torch.isfinite(gx).all())
    want = torch.zeros(n, d).index_add_(
        0, (torch.arange(n * k) // k)[keep], g[dest[keep]])
    np.testing.assert_allclose(gx.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(gx, dispatch_bwd_ref(g, dest, keep, n))


def test_combine_reads_no_row_for_a_dropped_slot():
    """A slot naming row -1 (a dropped one, weight 0) with inf and NaN in
    every row that no kept slot names: the combine's output, ``grad_w``
    (0 for the dropped slots) and ``grad_eo`` are finite and equal the
    kept slots' alone, plain and through :func:`moe_combine`'s
    backward; a row -1 reads as a zero row under any weight in the plain
    forward, as K5 reads it."""
    rng = np.random.default_rng(12)
    t, k, d, n_rows = 20, 3, 8, 90
    dest, keep = _slots(rng, t, k, n_rows, all_dropped=2)
    rows = torch.where(keep, dest, -1)
    w = torch.where(keep, torch.from_numpy(rng.random(t * k).astype(
        np.float32)), 0.0)
    seg = torch.arange(t, dtype=torch.int32).repeat_interleave(k)
    slot = torch.full((n_rows + 1,), t * k, dtype=torch.int64)
    slot.scatter_(0, torch.where(keep, dest, n_rows), torch.arange(t * k))
    slot = slot[:n_rows]
    eo = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(
        np.float32))
    free = torch.ones(n_rows, dtype=torch.bool)
    free[dest[keep]] = False
    eo[free] = torch.inf
    eo[0] = torch.nan if bool(free[0]) else eo[0]
    g = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    kept = keep.nonzero()[:, 0]
    out = segment_sum_ref(eo, seg, t, w, rows)
    want = segment_sum_ref(eo, seg[kept], t, w[kept], dest[kept])
    assert bool(torch.isfinite(out).all()) and torch.equal(out, want)
    grad_w, grad_eo = segment_sum_bwd_ref(g, eo, seg, w, rows)
    assert bool((grad_w[~keep] == 0).all())
    w_kept, eo_kept = segment_sum_bwd_ref(g, eo, seg[kept], w[kept],
                                          dest[kept])
    assert torch.equal(grad_w[kept], w_kept) and torch.equal(grad_eo,
                                                             eo_kept)
    assert bool(torch.isfinite(grad_eo).all())
    leaves = [eo.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    for combine in (segment_sum_sorted, segment_sum_ref):
        got = moe_combine(leaves[0], seg, t, weights=leaves[1], rows=rows,
                          slot=slot, combine=combine)
        assert torch.equal(got.detach(), out)
        ge, gw = torch.autograd.grad((got * g).sum(), leaves)
        assert torch.equal(ge, grad_eo) and torch.equal(gw, grad_w)
    # the plain forward reads row -1 as zeros under any weight
    ones = torch.ones(t * k)
    np.testing.assert_array_equal(
        segment_sum_ref(eo, seg, t, ones, rows).numpy(),
        segment_sum_ref(eo, seg[kept], t, ones[kept], dest[kept]).numpy())


def _probe():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / (
        "tools/dispatch_bwd_probe.py")
    spec = importlib.util.spec_from_file_location("dispatch_bwd_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", list(_probe().VARIANTS))
def test_dispatch_bwd_probe_edits_find_their_text(variant):
    """Every source edit of tools/dispatch_bwd_probe.py finds its text,
    once, in csrc/dispatch_bwd.cu, so the probe cannot rot; its ablations
    are variants of its own."""
    probe = _probe()
    edits = probe.VARIANTS[variant]
    src = probe.edited_source(variant, [])
    got = probe.edited_source(variant, edits)
    assert edits
    for old, new in edits:
        assert src.count(old) == 1
        assert new in got
    assert got != src
    assert probe.ABLATIONS <= set(probe.VARIANTS)
