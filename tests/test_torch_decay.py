"""The threshold decay ``t / γ`` on the CPU: the port's
``threshold_decay`` against numpy's float32 division and the reference's
``t / gamma`` (``repro/api/session.py``'s batched round, its frontier step
and engine), bit for bit.  The same division on the card is held to numpy
in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.diteration import GAMMA, threshold_decay

torch.set_num_threads(1)

GAMMAS = [1.2, 1.5, 2.0, 10 / 9]


def _thresholds(seed, n=100_000):
    """Seeded float32 thresholds over many binades, as a solve's decays
    reach them."""
    rng = np.random.default_rng(seed)
    return (rng.random(n) * 10.0 ** rng.uniform(-12, 2, n)).astype(
        np.float32)


@pytest.mark.parametrize("gamma", GAMMAS)
def test_threshold_decay_divides_as_numpy_and_the_reference(gamma):
    t = _thresholds(seed=int(gamma * 1000))
    want = t / np.float32(gamma)
    got = threshold_decay(torch.from_numpy(t),
                          torch.tensor(gamma, dtype=torch.float32)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    ref = np.asarray(jnp.asarray(t) / gamma)
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decay_divisor_takes_the_thresholds_dtype(dtype):
    """A divisor of the thresholds' dtype keeps that dtype and divides in
    it, float64 as the engine's float64 runs hold their thresholds."""
    d = torch.tensor(GAMMA, dtype=dtype)
    t = torch.tensor([3.0, 1e-30], dtype=dtype)
    got = threshold_decay(t, d)
    assert got.dtype == dtype
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    want = t.numpy() / np_dtype(GAMMA)
    assert np.array_equal(got.numpy(), want)
