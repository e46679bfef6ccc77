"""Port parity for the GIN forward: data, configs and the model.

The reference's GIN parameters (``repro.models.gnn.init_params``) are
carried across as numpy arrays by ``repro_torch.interop``; the port's
``forward`` on the CPU (K5's plain version over a destination-sorted edge
order) is held to the reference's ``forward`` (XLA's ``segment_sum``
scatter) within rtol 1e-4 / atol 1e-5: the per-node sums run in another
order, and three layers of sum aggregation compound that on outputs of
order 10-100.  ``make_gnn_batch`` must be byte-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as ref_gin_tu
from repro.configs import gnn_common as ref_gnn_common
from repro.core import power_law_graph as ref_power_law_graph
from repro.data import pipeline as ref_pipeline
from repro.models import gnn as ref_gnn
from repro_torch.configs import gin_tu, gnn_common
from repro_torch.core import power_law_graph
from repro_torch.data import make_gnn_batch, pad_gnn_batch
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.segment import segment_sum_sorted
from repro_torch.models import gnn

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
REF_CFG = ref_gnn.GNNConfig(name="g", arch="gin", n_layers=3, d_hidden=16,
                            d_feat=6, n_classes=4)
CFG = gnn.GNNConfig(name="g", arch="gin", n_layers=3, d_hidden=16, d_feat=6,
                    n_classes=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    params = ref_gnn.init_params(REF_CFG, jax.random.PRNGKey(0))
    # nonzero eps and biases, so that every parameter is compared
    params = jax.tree.map(lambda a: a + 0.05, params)
    return params, gnn_params_from_numpy(_np_tree(params), CFG, device="cpu")


@pytest.fixture(scope="module")
def batch():
    return make_gnn_batch(power_law_graph(300, seed=0), d_feat=6,
                          n_classes=4)


@pytest.mark.parametrize("n_classes,d_out", [(4, 1), (0, 2)])
def test_make_gnn_batch_is_byte_identical(n_classes, d_out):
    want = ref_pipeline.make_gnn_batch(ref_power_law_graph(300, seed=0), 6,
                                       n_classes=n_classes, d_out=d_out,
                                       seed=1)
    got = make_gnn_batch(power_law_graph(300, seed=0), 6,
                         n_classes=n_classes, d_out=d_out, seed=1)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])


@pytest.mark.parametrize("masked", [False, True])
def test_gin_forward_matches_reference(pair, batch, masked):
    params, model = pair
    if masked:
        batch = dict(batch)
        rng = np.random.default_rng(3)
        batch["edge_mask"] = (rng.random(batch["src"].shape[0]) > 0.3
                              ).astype(np.float32)
    want = np.asarray(ref_gnn.forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, REF_CFG))
    before = dict(LAUNCHES)
    got = gnn.forward(model, batch)
    assert LAUNCHES == before, "a CPU forward launched a kernel"
    assert got.shape == (300, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a prepared batch (sorted once) gives the same numbers
    prepared = gnn.prepare_batch(batch, "cpu")
    assert torch.equal(gnn.forward(model, prepared), got)


def test_prepared_order_is_stable_by_destination(batch):
    p = gnn.prepare_batch(batch, "cpu")
    order = np.argsort(batch["dst"], kind="stable")
    assert p["agg_dst"].dtype == torch.int32
    assert np.array_equal(p["agg_dst"].numpy(), batch["dst"][order])
    assert np.array_equal(p["agg_src"].numpy(), batch["src"][order])
    # the transposed view for the backward: the edges by source
    order = np.argsort(batch["src"], kind="stable")
    assert p["aggT_seg"].dtype == p["aggT_rows"].dtype == torch.int32
    assert np.array_equal(p["aggT_seg"].numpy(), batch["src"][order])
    assert np.array_equal(p["aggT_rows"].numpy(), batch["dst"][order])
    assert np.array_equal(p["aggT_w"].numpy(), batch["edge_mask"][order])
    # the two sorts are all it adds: K5 plans its work from the ids on the
    # card
    assert set(p) == set(batch) | {"agg_src", "agg_dst", "agg_w",
                                   "aggT_seg", "aggT_rows", "aggT_w"}


def test_padded_batch_gives_the_same_real_rows(pair, batch):
    _, model = pair
    padded = pad_gnn_batch(batch, 320, batch["src"].shape[0] + 700)
    assert padded["x"].shape == (320, 6)
    assert padded["edge_mask"].sum() == batch["src"].shape[0]
    assert np.all(padded["node_mask"][300:] == 0)
    got = gnn.forward(model, padded)
    np.testing.assert_allclose(got[:300].numpy(),
                               gnn.forward(model, batch).numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="cannot pad"):
        pad_gnn_batch(batch, 299, batch["src"].shape[0])


def test_graph_pool_matches_reference():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    ids = rng.integers(0, 5, 40).astype(np.int32)  # unsorted
    mask = (rng.random(40) > 0.2).astype(np.float32)
    want = np.asarray(ref_gnn._graph_pool(jnp.asarray(vals), jnp.asarray(ids),
                                          5, jnp.asarray(mask)))
    got = gnn.graph_pool(torch.from_numpy(vals), torch.from_numpy(ids), 5,
                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gin_config_and_shapes_match_reference():
    assert gnn_common.SHAPE_DIMS == ref_gnn_common.SHAPE_DIMS
    ref_spec = ref_gin_tu.spec()
    for shape in gnn_common.SHAPE_DIMS:
        want = dataclasses.asdict(ref_spec.cfg_for(ref_spec.cells[shape]))
        got = dataclasses.asdict(gin_tu.cfg_for(shape))
        assert {k: v for k, v in got.items() if k != "dtype"} == {
            k: want[k] for k in got if k != "dtype"}
    m = gnn.init_params(gin_tu.cfg_for("ogb_products"), device="cpu")
    assert [tuple(w.shape) for w in m.embed.w] == [(100, 64)]
    assert [tuple(w.shape) for w in m.readout.w] == [(64, 64), (64, 47)]
    assert len(m.mlps) == 5


@pytest.mark.parametrize("arch", ["meshgraphnet", "egnn", "dimenet"])
def test_other_archs_and_halo_are_not_ported(arch):
    """The other archs build now (item 7 (c), their parity in
    ``test_torch_gnn_archs.py``); the halo batch still waits (7 (d)),
    for them as for GIN."""
    cfg = dataclasses.replace(CFG, arch=arch, d_edge=4)
    model = gnn.init_params(cfg, device="cpu")
    assert model.cfg.arch == arch and model.param_tree()
    halo = {"src_slot": np.zeros(3, np.int32)}
    with pytest.raises(NotImplementedError, match="7 \\(d\\)"):
        gnn.prepare_batch(halo, "cpu", arch)
    with pytest.raises(NotImplementedError, match="7 \\(d\\)"):
        gnn.forward(model, halo)


def test_prepared_forward_builds_no_message_buffer(pair, batch):
    """On a prepared batch the forward hands each layer's aggregation the
    node states and ``rows = agg_src`` (K5's gather form) by the prepared
    ids and weights, launches no kernel on the CPU, and creates no ``[E,
    d]`` tensor outside the reduction (whose plain version gathers)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, model = pair
    p = gnn.prepare_batch(batch, "cpu")
    e = p["agg_src"].shape[0]
    made, calls = [], []

    class Shapes(TorchDispatchMode):
        active = True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.active:
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if isinstance(t, torch.Tensor):
                        made.append(tuple(t.shape))
            return out

    mode = Shapes()

    def reduction(data, seg, n, *, weights, rows):
        calls.append((tuple(data.shape), rows is p["agg_src"],
                      seg is p["agg_dst"], weights is p["agg_w"]))
        mode.active = False
        try:
            return segment_sum_sorted(data, seg, n, weights=weights,
                                      rows=rows)
        finally:
            mode.active = True

    before = dict(LAUNCHES)
    with mode:
        got = gnn.forward(model, p, segment_sum=reduction)
    assert LAUNCHES == before, "a CPU forward launched a kernel"
    assert calls == [((300, 16), True, True, True)] * 3
    assert made and not [s for s in made if s and s[0] == e]
    assert torch.equal(got, gnn.forward(model, p))
