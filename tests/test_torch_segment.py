"""Port parity for K5's contract: the sorted segment sum and embedding-bag.

The port's ``segment_sum_sorted`` / ``embedding_bag`` on CPU tensors
(K5's plain version), contiguous and in the gather form, against the
reference's, whose Pallas stage 1 runs in interpret mode on the CPU, and
against ``jax.ops.segment_sum`` on the layouts K5's chunks meet
(empty ends, a segment longer than a chunk, ids outside ``[0, n)``, the
MoE combine's fixed fan-in).  Tolerance rtol 1e-5 / atol 1e-5: float32
sums taken in another order.  The CUDA kernel is held against the plain
version in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment as ref_seg
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import (
    CHUNK_ROWS, embedding_bag, pad_sorted_edges, segment_sum_ref,
    segment_sum_sorted)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(e, d, s, seed):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, s, e)).astype(np.int32)
    data = rng.standard_normal((e, d)).astype(np.float32)
    return data, seg


@pytest.mark.parametrize("tile", [512, 128])
@pytest.mark.parametrize(
    "e,d,s", [(100, 4, 7), (513, 8, 64), (2048, 32, 500), (4096, 128, 11)])
def test_segment_sum_sorted_matches_reference(e, d, s, tile):
    data, seg = _case(e, d, s, e + d)
    want = np.asarray(ref_seg.segment_sum_sorted(
        jnp.asarray(data), jnp.asarray(seg), s, tile=tile))
    before = dict(LAUNCHES)
    got = segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(seg), s)
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    assert got.shape == (s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sentinel_padded_ids_contribute_nothing():
    data, seg = _case(300, 6, 40, 5)
    d_ref, s_ref = ref_seg.pad_sorted_edges(jnp.asarray(data),
                                            jnp.asarray(seg), 128)
    d_pad, s_pad = pad_sorted_edges(torch.from_numpy(data),
                                    torch.from_numpy(seg), 128)
    assert s_pad.dtype == torch.int32 and s_pad.shape == (384,)
    assert np.array_equal(s_pad.numpy(), np.asarray(s_ref))
    assert np.array_equal(d_pad.numpy(), np.asarray(d_ref))
    got = segment_sum_sorted(d_pad, s_pad, 40)
    want = np.asarray(ref_seg.segment_sum_ref(d_ref, s_ref, 40))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the real rows hold every id in [0, 40), the 84 sentinel rows follow
    assert np.array_equal(np.searchsorted(s_pad.numpy(), [0, 40]), [0, 300])


def test_weights_and_empty_segments():
    rng = np.random.default_rng(9)
    data, seg = _case(500, 5, 30, 9)
    seg[seg % 3 == 1] = 0  # segments 1, 4, 7, ... receive nothing
    seg = np.sort(seg)
    w = rng.choice([0.0, 0.5, 1.0, 2.0], 500).astype(np.float32)
    want = np.asarray(ref_seg.segment_sum_ref(
        jnp.asarray(data) * jnp.asarray(w)[:, None], jnp.asarray(seg), 30))
    got = segment_sum_sorted(torch.from_numpy(data), torch.from_numpy(seg),
                             30, weights=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[1::3] == 0)
    # the same sums row by row, in float64
    add = np.zeros((30, 5))
    np.add.at(add, seg, data.astype(np.float64) * w[:, None])
    np.testing.assert_allclose(got.numpy(), add, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((500, 16)).astype(np.float32)
    ids = rng.integers(0, 500, (32, 8)).astype(np.int32)
    w = rng.random((32, 8)).astype(np.float32) if weighted else None
    want = np.asarray(ref_seg.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), mode=mode))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        None if w is None else torch.from_numpy(w), mode=mode)
    assert got.shape == (32, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_version_drops_out_of_range_ids():
    data = torch.ones((5, 2))
    seg = torch.tensor([-1, 0, 2, 3, 2**30], dtype=torch.int32)
    got = segment_sum_ref(data, seg, 3)
    assert torch.equal(got, torch.tensor([[1.0, 1.0], [0.0, 0.0],
                                          [1.0, 1.0]]))


def _gather_case(seed, e, n_data, d, s):
    """Sorted ids with empty segments (every third, and the last quarter)
    and sentinel padding, a random source row per edge and mask weights."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, (3 * s) // 4, e)).astype(np.int32)
    seg[seg % 3 == 1] -= 1
    seg = np.sort(seg)
    seg[-(e // 10):] = 2**30
    h = rng.standard_normal((n_data, d)).astype(np.float32)
    src = rng.integers(0, n_data, e)
    w = rng.choice([0.0, 0.5, 1.0, 2.0], e).astype(np.float32)
    return h, seg, src, w


@pytest.mark.parametrize("rows_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("e,n_data,d,s", [(700, 90, 8, 60), (2048, 300, 64, 250),
                                          (333, 40, 10, 31)])
def test_gather_form_matches_reference(e, n_data, d, s, rows_dtype):
    """``rows`` gathers ``h[src]`` inside the segment sum: the port's plain
    version against the reference's two-stage ``segment_sum_sorted`` (Pallas
    stage 1 in interpret mode) and ``jax.ops.segment_sum`` on the masked
    messages ``h[src]·w``."""
    h, seg, src, w = _gather_case(e + d, e, n_data, d, s)
    msgs = jnp.asarray(h)[jnp.asarray(src)] * jnp.asarray(w)[:, None]
    want_pallas = np.asarray(ref_seg.segment_sum_sorted(msgs, jnp.asarray(seg),
                                                        s, tile=128))
    want_xla = np.asarray(jax.ops.segment_sum(msgs, jnp.asarray(seg),
                                              num_segments=s))
    before = dict(LAUNCHES)
    got = segment_sum_sorted(torch.from_numpy(h), torch.from_numpy(seg), s,
                             weights=torch.from_numpy(w),
                             rows=torch.from_numpy(src.astype(rows_dtype)))
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    assert got.shape == (s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)
    assert np.all(got.numpy()[(3 * s) // 4:] == 0)
    # the contiguous form over the gathered rows is the same function
    np.testing.assert_allclose(
        got.numpy(), segment_sum_ref(torch.from_numpy(h[src]),
                                     torch.from_numpy(seg), s,
                                     torch.from_numpy(w)).numpy(), **TOL)


def test_embedding_bag_and_graph_pool_take_the_gather_form(monkeypatch):
    """Mode "sum" hands K5 the table itself with the ids as ``rows`` (no
    gathered ``[B·L, D]`` copy), and ``graph_pool`` its node values with
    the sort order; both still match the reference."""
    from repro.models import gnn as ref_gnn
    from repro_torch.kernels.segment import ops
    from repro_torch.models import gnn

    seen = []

    def spy(data, seg_ids, n, weights=None, rows=None):
        seen.append((tuple(data.shape), None if rows is None else rows.dtype))
        return segment_sum_ref(data, seg_ids, n, weights, rows)

    monkeypatch.setattr(ops, "segment_sum_kernel", spy)
    rng = np.random.default_rng(6)
    table = rng.standard_normal((500, 16)).astype(np.float32)
    ids = rng.integers(0, 500, (32, 8))
    w = rng.random((32, 8)).astype(np.float32)
    want = np.asarray(ref_seg.embedding_bag(jnp.asarray(table),
                                            jnp.asarray(ids.astype(np.int32)),
                                            jnp.asarray(w)))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    vals = rng.standard_normal((60, 5)).astype(np.float32)
    gid = rng.integers(0, 7, 60)
    mask = (rng.random(60) > 0.25).astype(np.float32)
    want = np.asarray(ref_gnn._graph_pool(jnp.asarray(vals), jnp.asarray(gid),
                                          7, jnp.asarray(mask)))
    got = gnn.graph_pool(torch.from_numpy(vals), torch.from_numpy(gid), 7,
                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert seen == [((500, 16), torch.int64), ((60, 5), torch.int64)]


def _layout(kind, rng):
    """Sorted ids (and rows, weights, n, data) of one layout K5's chunks of
    ``CHUNK_ROWS`` rows meet on the card."""
    n, d = 90, 6
    rows = w = None
    if kind in ("empty_ends", "long_segment"):
        lengths = rng.integers(0, 40, n)
        lengths[:4] = 0  # empty segments at the start ...
        lengths[-5:] = 0  # ... and at the end
        lengths[20:27] = 0
        if kind == "long_segment":  # one segment over three chunks
            lengths[10] = 3 * CHUNK_ROWS + 17
        seg = np.repeat(np.arange(n), lengths)
    elif kind in ("boundary_next", "boundary_far"):
        # whole chunks of short segments, then one of more than a chunk from
        # a chunk's first row, ending in the chunk after (next) or five on
        k0, length = ((1, CHUNK_ROWS + 500) if kind == "boundary_next"
                      else (3, 5 * CHUNK_ROWS + 9))
        seg = np.concatenate([np.sort(rng.integers(0, 10, k0 * CHUNK_ROWS)),
                              np.full(length, 10), np.repeat(np.arange(
                                  11, n), rng.integers(0, 40, n - 11))])
    elif kind == "out_of_range_ids":  # -1 before, the 2**30 sentinel after
        seg = np.concatenate([np.full(7, -1), np.sort(rng.integers(
            0, n, 2 * CHUNK_ROWS)), np.full(CHUNK_ROWS + 30, 2**30)])
    else:  # the MoE combine: 4 slots a token, dropped slots of weight 0
        n, d, k = 300, 16, 4
        seg = np.repeat(np.arange(n), k)
        rows = rng.integers(0, 64 * 5, n * k)
        w = rng.random(n * k).astype(np.float32)
        w[rng.random(n * k) < 0.3] = 0.0
        rows[w == 0] = 0  # a dropped slot reads row 0 at weight 0
    seg = seg.astype(np.int64 if kind == "long_segment" else np.int32)
    n_data = seg.size if rows is None else 64 * 5
    data = rng.standard_normal((n_data, d)).astype(np.float32)
    return seg, rows, w, n, data


@pytest.mark.parametrize("kind", ["empty_ends", "long_segment",
                                  "boundary_next", "boundary_far",
                                  "out_of_range_ids", "moe_fan_in"])
@pytest.mark.parametrize("weighted", [False, True])
def test_chunk_layouts_match_jax_segment_sum(kind, weighted):
    """``segment_sum_sorted`` (K5's plain version on the CPU) against the
    reference's ``jax.ops.segment_sum`` on the layouts that decide K5's
    work on the card: empty segments at both ends and between, one segment
    longer than three chunks (int64 ids), segments of more than a chunk
    that start on a chunk's first row, -1 and ``2**30`` ids around the
    real ones, and the MoE combine (bf16 expert rows gathered by ``rows``,
    4 slots a token, dropped slots weighted 0; unweighted, the keep mask
    alone)."""
    rng = np.random.default_rng(len(kind) + weighted)
    seg, rows, w, n, data = _layout(kind, rng)
    if w is None and weighted:
        w = rng.choice([0.0, 0.5, 1.0, 2.0], seg.size).astype(np.float32)
    elif w is not None and not weighted:  # the keep mask alone
        w = (w != 0).astype(np.float32)
    bf16 = kind == "moe_fan_in"
    data_t = torch.from_numpy(data)
    if bf16:  # the reference sums the same bf16 values in float32
        data_t = data_t.to(torch.bfloat16)
        data = data_t.float().numpy()
    msgs = data if rows is None else data[rows]
    if w is not None:
        msgs = msgs * w[:, None]
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(msgs),
                                          jnp.asarray(seg), num_segments=n))
    before = dict(LAUNCHES)
    got = segment_sum_sorted(
        data_t, torch.from_numpy(seg), n,
        weights=None if w is None else torch.from_numpy(w),
        rows=None if rows is None else torch.from_numpy(rows))
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    assert got.shape == (n, data.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    empty = np.setdiff1d(np.arange(n), seg)
    assert np.all(got.numpy()[empty] == 0)


def _k5_probe():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools/k5_probe.py"
    spec = importlib.util.spec_from_file_location("k5_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", list(_k5_probe().VARIANTS))
def test_k5_probe_edits_find_their_text(variant):
    """Every source edit of tools/k5_probe.py finds its text, once, in
    csrc/segment_sum.cu, so the probe cannot rot."""
    probe = _k5_probe()
    edits, chunk = probe.VARIANTS[variant]
    src = probe.edited_source(variant, [])
    got = probe.edited_source(variant, edits)
    assert edits
    for old, new in edits:
        assert src.count(old) == 1
        assert new in got
    assert got != src
    assert chunk % 256 == 0  # a multiple of the CTA's threads


def _combine_bwd_probe():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / (
        "tools/combine_bwd_probe.py")
    spec = importlib.util.spec_from_file_location("combine_bwd_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", list(_combine_bwd_probe().VARIANTS))
def test_combine_bwd_probe_edits_find_their_text(variant):
    """Every source edit of tools/combine_bwd_probe.py finds its text,
    once, in csrc/segment_bwd.cu, so the probe cannot rot; its ablations
    are variants of its own."""
    probe = _combine_bwd_probe()
    edits = probe.VARIANTS[variant]
    src = probe.edited_source(variant, [])
    got = probe.edited_source(variant, edits)
    assert edits
    for old, new in edits:
        assert src.count(old) == 1
        assert new in got
    assert got != src
    assert probe.ABLATIONS <= set(probe.VARIANTS)
