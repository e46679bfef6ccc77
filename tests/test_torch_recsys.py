"""Port parity for FM recsys serving: data, configs, model and steps.

The reference's FM parameters (``repro.models.recsys.init_params``) are
carried across as numpy arrays by ``repro_torch.interop``; the port's
``forward_logits`` / ``retrieval_score`` on the CPU (K4's plain version)
are held to the reference's within rtol 1e-5 / atol 1e-5 (float32 sums in
another order, on logits of order 1).  ``criteo_like_batch`` must be
byte-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fm as ref_fm_cfg
from repro.data import pipeline as ref_pipeline
from repro.models import recsys as ref_recsys
from repro_torch.configs import fm as fm_cfg
from repro_torch.data import criteo_like_batch
from repro_torch.interop import fm_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.steps import build_cell_step
from repro_torch.models import recsys

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
REF_CFG = ref_recsys.FMConfig(name="fm", n_fields=8, vocab_per_field=50,
                              embed_dim=6)
CFG = recsys.FMConfig(name="fm", n_fields=8, vocab_per_field=50, embed_dim=6)


@pytest.fixture(scope="module")
def pair():
    params = ref_recsys.init_params(REF_CFG, jax.random.PRNGKey(0))
    # nonzero linear terms and bias, so that every term is compared
    rng = np.random.default_rng(0)
    params = dict(params,
                  lin_table=jnp.asarray(rng.standard_normal(REF_CFG.n_rows)
                                        .astype(np.float32) * 0.1),
                  bias=jnp.float32(0.25))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return params, fm_params_from_numpy(np_params, CFG, device="cpu")


@pytest.mark.parametrize("step", [0, 3])
def test_criteo_like_batch_is_byte_identical(step):
    want = ref_pipeline.criteo_like_batch(step, 64, 8, 50, seed=2)
    got = criteo_like_batch(step, 64, 8, 50, seed=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])


def test_forward_logits_matches_reference(pair):
    params, model = pair
    ids = criteo_like_batch(1, 37, 8, 50)["ids"]
    want = np.asarray(ref_recsys.forward_logits(params, jnp.asarray(ids),
                                                REF_CFG))
    before = dict(LAUNCHES)
    got = recsys.forward_logits(model, ids)
    assert LAUNCHES == before, "a CPU forward launched a kernel"
    assert got.dtype == torch.float32 and got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(model(torch.from_numpy(ids)), got)


def test_retrieval_score_matches_reference_and_forward(pair):
    params, model = pair
    rng = np.random.default_rng(1)
    user = rng.integers(0, 50, 7).astype(np.int32)
    cands = np.arange(50, dtype=np.int32)
    want = np.asarray(ref_recsys.retrieval_score(
        params, jnp.asarray(user), jnp.asarray(cands), REF_CFG))
    got = recsys.retrieval_score(model, user, cands)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = np.concatenate([np.broadcast_to(user, (50, 7)), cands[:, None]],
                          axis=1)
    np.testing.assert_allclose(got.numpy(),
                               recsys.forward_logits(model, full).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_fm_config_and_cells_match_reference():
    ref_spec, spec = ref_fm_cfg.spec(), fm_cfg.spec()
    ref = dataclasses.asdict(ref_spec.model_cfg)
    got = dataclasses.asdict(spec.model_cfg)
    assert {k: v for k, v in got.items() if k != "dtype"} == {
        k: v for k, v in ref.items() if k != "dtype"}
    assert spec.model_cfg.n_rows == 39_000_000
    assert (spec.arch_id, spec.family) == (ref_spec.arch_id, ref_spec.family)
    assert spec.cells.keys() == ref_spec.cells.keys()
    for name, cell in spec.cells.items():
        ref_cell = ref_spec.cells[name]
        assert cell.kind == ref_cell.kind and cell.meta == ref_cell.meta
        ref_inputs = ref_cell.inputs()
        assert cell.inputs.keys() == ref_inputs.keys()
        for key, (shape, dtype) in cell.inputs.items():
            assert shape == ref_inputs[key].shape
            assert str(dtype).split(".")[-1] == str(ref_inputs[key].dtype)


def test_serve_and_retrieval_steps(pair):
    _, model = pair
    spec = dataclasses.replace(fm_cfg.spec(), model_cfg=CFG)
    serve = build_cell_step(spec, spec.cells["serve_p99"], model)
    batch = criteo_like_batch(0, 16, 8, 50)
    assert torch.equal(serve(batch), recsys.forward_logits(model,
                                                           batch["ids"]))
    retrieval = build_cell_step(spec, spec.cells["retrieval_cand"], model)
    q = {"user_ids": batch["ids"][0, :7], "cand_ids": np.arange(50)}
    assert torch.equal(retrieval(q), recsys.retrieval_score(
        model, q["user_ids"], q["cand_ids"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_cell_step(spec, spec.cells["train_batch"], model)


def test_fm_init_is_seeded():
    a = recsys.FM(CFG, seed=3, device="cpu")
    b = recsys.FM(CFG, seed=3, device="cpu")
    assert torch.equal(a.table, b.table)
    assert a.table.shape == (400, 6)
    assert abs(float(a.table.std()) - 6 ** -0.5) < 0.05
    assert not a.table.requires_grad
    assert float(a.lin_table.abs().sum()) == 0 and float(a.bias) == 0
