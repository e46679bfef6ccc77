"""Port parity for K5's contract: the sorted segment sum and embedding-bag.

The port's ``segment_sum_sorted`` / ``embedding_bag`` on CPU tensors
(K5's plain version) against the reference's, whose Pallas stage 1 runs
in interpret mode on the CPU.  Tolerance rtol 1e-5 / atol 1e-5: float32
sums taken in another order.  The CUDA kernel is held against the plain
version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment as ref_seg
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import (
    embedding_bag, pad_sorted_edges, row_ranges, segment_sum_ref,
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
