"""Port parity for K4's contract: the FM pairwise interaction.

The port's ``fm_interaction`` on CPU tensors (K4's plain version) against
the reference's ``repro.kernels.fm.fm_interaction``, which runs its Pallas
kernel in interpret mode on the CPU.  Both sum float32 in their own order,
and ``(Σ_f v)² − Σ_f v²`` cancels: at (300, 39, 10) standard-normal inputs
the two differ by up to 2.9e-5 on outputs near 1 whose terms are near 70.
So each sample is held to 1e-5 of the magnitude it was computed from,
``|Δy| <= 1e-5·(1 + 0.5·Σ_d[(Σ_f v)² + Σ_f v²])``: rtol 1e-5 / atol 1e-5
on the terms, not on their difference.  The CUDA kernel is held against
the plain version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fm as ref_fm
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fm import (
    fm_interaction, fm_interaction_kernel, fm_interaction_naive,
    fm_interaction_ref)

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


@pytest.mark.parametrize("b,f,d", [(7, 5, 4), (300, 39, 10), (256, 26, 32)])
def test_fm_interaction_matches_reference(b, f, d):
    v = np.random.default_rng(b * 1000 + f).standard_normal(
        (b, f, d)).astype(np.float32)
    want = np.asarray(ref_fm.fm_interaction(jnp.asarray(v)))
    before = dict(LAUNCHES)
    got = fm_interaction(torch.from_numpy(v))
    assert LAUNCHES == before, "a CPU tensor launched a kernel"
    assert got.dtype == torch.float32 and got.shape == (b,)
    v64 = v.astype(np.float64)
    scale = 0.5 * (v64.sum(1) ** 2 + (v64 * v64).sum(1)).sum(-1)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= 1e-5 * (1.0 + scale)), float((err / (1 + scale))
                                                      .max())


@pytest.mark.parametrize("b,f,d", [(1, 2, 1), (17, 13, 7)])
def test_fm_ref_matches_naive_definition(b, f, d):
    v = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (b, f, d)).astype(np.float32))
    np.testing.assert_allclose(fm_interaction_ref(v).numpy(),
                               fm_interaction_naive(v).numpy(),
                               rtol=1e-4, atol=1e-4)
    want = np.asarray(ref_fm.fm_interaction_naive(jnp.asarray(v.numpy())))
    np.testing.assert_allclose(fm_interaction_naive(v).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_fm_interaction_takes_a_strided_view():
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 4, 5)).astype(np.float32))
    view = v.transpose(0, 1).contiguous().transpose(0, 1)
    assert not view.is_contiguous()
    assert torch.equal(fm_interaction(view), fm_interaction_ref(v))
    assert torch.equal(fm_interaction_kernel(v), fm_interaction_ref(v))
