"""Port parity for the FM tables' gradient (``embedding_bwd_kernel``).

The wrapper's CPU path (its plain version: K5's plain version over the
rows ``order // bag`` of g) against ``jax.vjp`` of the reference's lookups
``table[rows]`` (D 10, bag 1) and ``lin_table[rows].reshape(b, f).sum(-1)``
(D 1, bag F), on zipf ids with hot rows and on tables most of whose rows
receive nothing; ``embedding_gather`` with a sort handed in and made
inside; ids outside ``[0, n)``; int32 and int64 ids and orders; the
refusals; and ``tools/emb_bwd_probe.py``'s source edits.  Tolerance rtol
1e-5 / atol 1e-6: float32 sums in another order, rows repeated up to a few
thousand times, values of order 1.  The CUDA kernel is held to its plain
version in test_torch_cuda.py.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.data import criteo_like_batch
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import (embedding_bwd_kernel,
                                         embedding_bwd_ref, embedding_gather,
                                         segment_sum_ref)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = pathlib.Path(__file__).resolve().parents[1]
F, VOCAB = 8, 50


def _rows(kind, seed=0):
    """A batch's fused row ids ``[B * F]`` (int32) and the table's rows:
    criteo-like zipf ids (``zipf``), with one id in 3,000 more rows
    (``hot``), or into a table 20 times larger than the ids reach
    (``sparse``: most rows receive nothing)."""
    ids = criteo_like_batch(seed, 600, F, VOCAB)["ids"]
    rows = (ids + np.arange(F, dtype=np.int32) * VOCAB).reshape(-1)
    n = F * VOCAB
    if kind == "hot":
        rng = np.random.default_rng(seed)
        rows = rows.copy()
        rows[rng.choice(rows.size, 3000, replace=False)] = 7
    elif kind == "sparse":
        n *= 20
    return rows, n


@pytest.mark.parametrize("kind", ["zipf", "hot", "sparse"])
@pytest.mark.parametrize("d", [10, 1])
def test_embedding_bwd_matches_jax_vjp(d, kind):
    """The table's gradient (D 10, bag 1) and the linear table's (D 1, bag
    F) against ``jax.vjp`` of the reference's lookups; the rows no id
    names are 0."""
    rows, n = _rows(kind)
    bag = 1 if d > 1 else F
    rng = np.random.default_rng(d)
    shape = (n, d) if d > 1 else (n,)
    table = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((rows.size // bag,) + shape[1:]).astype(
        np.float32)

    def ref(t):
        out = t[jnp.asarray(rows)]
        return out if bag == 1 else out.reshape(-1, bag).sum(-1)

    _, vjp = jax.vjp(ref, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    rows_t = torch.from_numpy(rows)
    seg, order = torch.sort(rows_t, stable=True)
    got = embedding_bwd_kernel(torch.from_numpy(g).reshape(g.shape[0], -1),
                               seg, order, n, bag)
    assert got.shape == (n, 1 if d == 1 else d)
    np.testing.assert_allclose(got.reshape(shape).numpy(), np.asarray(want),
                               **TOL)
    empty = np.bincount(rows, minlength=n) == 0
    assert not got[torch.from_numpy(empty)].any()
    if kind == "sparse":
        assert empty.sum() > 0.9 * n
    if kind == "hot":
        assert int((rows == 7).sum()) >= 3000


@pytest.mark.parametrize("bag", [1, F])
def test_embedding_gather_sort_given_or_made_inside(bag):
    """``embedding_gather``'s gradient with the stable sort handed in and
    made inside: the same bits, the wrapper's."""
    rows, n = _rows("hot", seed=3)
    rng = np.random.default_rng(bag)
    shape = (n, 10) if bag == 1 else (n,)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    t.requires_grad_(True)
    rows_t = torch.from_numpy(rows)
    order = torch.sort(rows_t, stable=True).indices
    g = torch.from_numpy(rng.standard_normal(
        (rows.size // bag,) + shape[1:]).astype(np.float32))
    grads = [torch.autograd.grad(embedding_gather(t, rows_t, o, bag=bag),
                                 [t], g)[0] for o in (None, order)]
    assert torch.equal(grads[0], grads[1])
    want = embedding_bwd_kernel(g.reshape(g.shape[0], -1), rows_t[order],
                                order, n, bag)
    assert torch.equal(grads[0].reshape(n, -1), want)


@pytest.mark.parametrize("bag", [1, 5])
def test_embedding_bwd_on_the_cpu_is_its_plain_version(bag):
    """For CPU tensors the wrapper runs the plain version, K5's plain
    version over the rows ``order // bag``, and launches nothing."""
    rows, n = _rows("zipf", seed=bag)
    rows = rows[: rows.size // bag * bag]
    rows_t = torch.from_numpy(rows)
    seg, order = torch.sort(rows_t, stable=True)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (rows.size // bag, 3)).astype(np.float32))
    before = dict(LAUNCHES)
    got = embedding_bwd_kernel(g, seg, order, n, bag)
    assert LAUNCHES == before
    want = segment_sum_ref(g, seg, n, None,
                           torch.div(order, bag, rounding_mode="floor"))
    assert torch.equal(got, want)
    assert torch.equal(embedding_bwd_ref(g, seg, order, n, bag), want)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_embedding_bwd_drops_ids_outside_the_table(ids_dtype):
    """Ids below 0 and at or past n contribute nothing, as in K5's
    contract (``jax.ops.segment_sum`` drops them)."""
    rng = np.random.default_rng(5)
    n = 40
    rows = np.concatenate([rng.integers(-9, 0, 30), rng.integers(0, n, 200),
                           rng.integers(n, n + 9, 30)])
    rows_t = torch.from_numpy(rng.permutation(rows)).to(ids_dtype)
    seg, order = torch.sort(rows_t, stable=True)
    g = rng.standard_normal((rows.size, 4)).astype(np.float32)
    got = embedding_bwd_kernel(torch.from_numpy(g), seg, order, n)
    want = jax.ops.segment_sum(jnp.asarray(g[order.numpy()]),
                               jnp.asarray(seg.numpy()), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seg_dtype,order_dtype", [
    (torch.int32, torch.int32), (torch.int32, torch.int64),
    (torch.int64, torch.int32), (torch.int64, torch.int64)])
def test_embedding_bwd_takes_int32_and_int64_ids(seg_dtype, order_dtype):
    """The ids and the order as they come, int32 or int64: the same bits."""
    rows, n = _rows("hot", seed=1)
    rows_t = torch.from_numpy(rows)
    seg, order = torch.sort(rows_t, stable=True)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (rows.size // F, 1)).astype(np.float32))
    want = embedding_bwd_kernel(g, seg, order, n, F)
    got = embedding_bwd_kernel(g, seg.to(seg_dtype), order.to(order_dtype),
                               n, F)
    assert torch.equal(got, want)


def _refusal_case(case):
    g = torch.zeros(6, 2)
    seg = torch.arange(6, dtype=torch.int32)
    order = torch.arange(6)
    args = dict(g=g, seg=seg, order=order, n=6, bag=1)
    if case == "g_float64":
        args["g"] = g.double()
    elif case == "g_1d":
        args["g"] = g.reshape(-1)
    elif case == "seg_float":
        args["seg"] = seg.float()
    elif case == "seg_2d":
        args["seg"] = seg.reshape(2, 3)
    elif case == "order_short":
        args["order"] = order[:5]
    elif case == "bag_0":
        args["bag"] = 0
    else:
        args["n"] = -1
    return args


@pytest.mark.parametrize("case", ["g_float64", "g_1d", "seg_float", "seg_2d",
                                  "order_short", "bag_0", "n_negative"])
def test_embedding_bwd_refuses_what_the_kernel_does_not_take(case):
    """The wrapper checks dtype, shape and arguments before it picks the
    device, so the CPU path refuses what the kernel would."""
    a = _refusal_case(case)
    with pytest.raises(ValueError):
        embedding_bwd_kernel(a["g"], a["seg"], a["order"], a["n"], a["bag"])


def _probe():
    path = ROOT / "tools" / "emb_bwd_probe.py"
    spec = importlib.util.spec_from_file_location("emb_bwd_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", list(_probe().VARIANTS))
def test_emb_bwd_probe_edits_find_their_text(variant):
    """Every source edit of tools/emb_bwd_probe.py finds its text, once,
    in csrc/embedding_bwd.cu, so the probe cannot rot."""
    probe = _probe()
    edits = probe.VARIANTS[variant]
    src = probe.edited_source(variant, [])
    got = probe.edited_source(variant, edits)
    assert edits
    for old, new in edits:
        assert src.count(old) == 1
        assert new in got
    assert got != src


def test_emb_bwd_probe_wants_a_card():
    """Without a card the probe prints no number and exits non-zero."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "emb_bwd_probe.py")],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no card" in out.stderr and "ms" not in out.stdout
