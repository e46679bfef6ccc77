"""Port parity for K5's contract: the sorted segment sum and embedding-bag.

The port's ``segment_sum_sorted`` / ``embedding_bag`` on CPU tensors
(K5's plain version), contiguous and in the gather form, against the
reference's, whose Pallas stage 1 runs in interpret mode on the CPU; and
K5's chunk plan.  Tolerance rtol 1e-5 / atol 1e-5: float32
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
    chunk_plan, embedding_bag, pad_sorted_edges, row_ranges, segment_sum_ref,
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
    # ids past n_segments (the sentinel included) fall outside the ranges
    ptr = row_ranges(s_pad, 40)
    assert int(ptr[0]) == 0 and int(ptr[-1]) == 300


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
    ptr = row_ranges(torch.from_numpy(seg), 30)
    assert torch.equal(ptr, torch.from_numpy(
        np.searchsorted(seg, np.arange(31)).astype(np.int64)))


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

    def spy(data, seg_ids, n, weights=None, ptr=None, rows=None, plan=None):
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


def _owned(plan):
    """The segments each chunk writes: chunk 0 from 0, chunk c from
    ``plan[c]`` (it is where the segment ends), up to ``plan[c + 1]``."""
    return [range(0 if c == 0 else max(int(plan[c]), 0), int(plan[c + 1]))
            for c in range(len(plan) - 1)]


@pytest.mark.parametrize("chunk", [256, 512, 2048])
def test_chunk_plan(chunk):
    """Each row lies in one chunk, each chunk's first segment is that of its
    first row (-1 / n for rows outside [0, n)), and the chunks' segments
    partition [0, n): for chunks shorter than, as long as and longer than
    the longest segment (512 rows), with empty segments at both ends."""
    rng = np.random.default_rng(chunk)
    n = 90
    lengths = rng.integers(0, 40, n)
    lengths[:4] = 0  # empty segments at the start ...
    lengths[-5:] = 0  # ... and at the end
    lengths[10] = 512  # the longest segment
    lengths[20:27] = 0
    seg = np.repeat(np.arange(n), lengths).astype(np.int32)
    seg = np.concatenate([np.full(7, -1, np.int32), seg,
                          np.full(30, 2**30, np.int32)])
    e = seg.shape[0]
    ptr = row_ranges(torch.from_numpy(seg), n)
    plan = chunk_plan(ptr, e, chunk)
    n_chunks = -(-e // chunk)
    assert plan.dtype == torch.int32 and plan.shape == (n_chunks + 1,)
    starts = np.arange(n_chunks) * chunk
    ends = np.minimum(starts + chunk, e)
    covered = np.zeros(e, np.int64)
    for a, b in zip(starts, ends):
        covered[a:b] += 1
    assert np.all(covered == 1)
    assert np.array_equal(plan[:-1].numpy(), np.clip(seg[starts], -1, n))
    assert int(plan[-1]) == n
    owned = np.zeros(n, np.int64)
    for r in _owned(plan.numpy()):
        owned[list(r)] += 1
    assert np.all(owned == 1)
    # a segment that spans chunks is owned by the chunk of its last row
    for s in range(n):
        if lengths[s]:
            last_row = int(ptr[s + 1]) - 1
            assert s in _owned(plan.numpy())[last_row // chunk]
