"""The examples on the port (``repro_torch.examples``) against the
reference's, at small sizes.

``quickstart`` and ``solve_web``: every counter (costs, moves, exchanges,
rounds, Jacobi's matvecs) equals ``repro.solve`` with the same arguments,
and the solutions agree within 1e-9 (max |Δx|) where the reference's
backend is the same float64 host code; ``gnn_partition``: the slope
controller's moves and the imbalances equal the reference's exactly (both
run numpy on the host); ``serve_lm``: the greedy tokens equal the
reference's under carried weights; ``train_lm``: 3 steps' losses within
rtol 1e-5 of the reference's under carried weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import jacobi_solve as ref_jacobi
from repro.core import power_law_graph as ref_power_law
from repro.core import webgraph_like as ref_webgraph
from repro.core.partition import DynamicController as RefController
from repro.core.partition import DynamicControllerConfig as RefControllerCfg
from repro.core.partition import apply_move as ref_apply_move
from repro.core.partition import uniform_partition as ref_uniform
from repro.data import lm_token_batch as ref_lm_batch
from repro.models import transformer as ref_lm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.runtime import TrainLoop as RefTrainLoop
from repro.runtime import TrainLoopConfig as RefTrainLoopConfig
from repro_torch.examples import (gnn_partition, quickstart, serve_lm,
                                  solve_web, train_lm)
from repro_torch.interop import lm_params_from_numpy

# small tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores with spinning OpenMP threads
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [300, 700])
def test_quickstart_counts_equal_the_reference(n, capsys):
    got = quickstart.main(["--n", str(n), "--device", "cpu"])
    assert "top-5 PageRank nodes" in capsys.readouterr().out
    g = ref_power_law(n, alpha=1.5, seed=0)
    problem = repro.Problem.pagerank(g, damping=0.85, target_error=1.0 / n)
    ref = repro.solve(problem, method="sequential")
    _, iters = ref_jacobi(problem.p, problem.b, target_error=1.0 / n,
                          eps=0.15)
    sim = repro.solve(problem, method="simulator", k=8, dynamic=True,
                      mode="sequential", record_every=50)
    eng = repro.solve(problem, method="engine:chunk", k=1, dynamic=False)
    assert (got["links"], got["dangling"]) == (
        g.n_edges, int(g.dangling_mask().sum()))
    assert got["sequential"]["cost"] == ref.cost_iterations
    assert got["jacobi_iters"] == iters
    assert got["simulator"]["cost"] == sim.cost_iterations
    assert got["simulator"]["moves"] == len(sim.move_log)
    assert got["simulator"]["exchanges"] == sim.extras["n_exchanges"]
    assert got["engine"]["k"] == 1
    assert got["engine"]["rounds"] == eng.n_rounds
    assert got["engine"]["converged"] and eng.converged
    assert got["top5"] == np.argsort(-ref.x)[:5].tolist()


def test_solve_web_counts_equal_the_reference():
    n, k = 2000, 4
    got = solve_web.main(["--n", str(n), "--k", str(k), "--device", "cpu"])
    g = ref_webgraph(n, seed=1)
    problem = repro.Problem.pagerank(g, target_error=1.0 / g.n)
    opts = dict(mode="batch", record_every=100)
    base = repro.solve(problem, method="simulator", k=1, **opts)
    assert got["base"]["cost"] == base.extras["cost_steps_iterations"]
    for dyn in (False, True):
        res = repro.solve(problem, method="simulator", k=k, dynamic=dyn,
                          **opts)
        row = got["dynamic" if dyn else "static"]
        assert row["cost"] == res.extras["cost_steps_iterations"]
        assert row["moves"] == len(res.move_log)
        assert row["converged"] and res.converged
        if dyn:
            sizes = res.extras["hist_sizes"]
            assert row["sizes"] == (sizes[0].tolist(), sizes[-1].tolist())


def test_gnn_partition_moves_equal_the_reference():
    moves, shown, final = gnn_partition.balance(gnn_partition.skewed_graph(),
                                                verbose=False)
    g = ref_power_law(4000, seed=3)
    g = g.reorder(np.argsort(-g.out_degree(), kind="stable"))
    deg = np.maximum(g.out_degree(), 1)
    sets = ref_uniform(g.n, 8)
    ctl = RefController(RefControllerCfg(k=8, target_error=1e-6, z=3))
    want, want_shown = [], []
    for step in range(60):
        costs = np.array([deg[s].sum() for s in sets], dtype=np.float64)
        if step % 10 == 0:
            want_shown.append(float(costs.max() / costs.mean()))
        move = ctl.update(costs, np.array([s.size for s in sets]))
        if move is not None:
            want.append((move.src, move.dst, move.n_move))
            sets, _ = ref_apply_move(sets, move)
    costs = np.array([deg[s].sum() for s in sets], dtype=np.float64)
    assert moves == want and len(moves) > 0
    assert shown == want_shown
    assert final == float(costs.max() / costs.mean())
    assert final < shown[0]


def _port_cfg(ref_cfg, **over):
    from repro_torch.models import transformer as lm

    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(lm.TransformerConfig)}
    fields.update(dtype=torch.float32, **over)
    return lm.TransformerConfig(**fields)


def test_serve_lm_greedy_tokens_equal_the_reference():
    ref_cfg = ref_lm.TransformerConfig(
        name="serve-demo", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=768, vocab=4096, dtype=jnp.float32, ce_chunk=64)
    assert _port_cfg(ref_cfg) == serve_lm.CFG
    batch, prompt, gen = 2, 8, 6
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    prompts = ref_lm_batch(0, batch, prompt, ref_cfg.vocab)["tokens"]
    cache, logits = ref_lm.prefill_step(params, jnp.asarray(prompts),
                                        ref_cfg, max_seq=prompt + gen)
    tokens = jnp.argmax(logits, -1)
    want = [tokens]
    for _ in range(gen - 1):
        logits, cache = ref_lm.decode_step(params, cache, tokens, ref_cfg)
        tokens = jnp.argmax(logits, -1)
        want.append(tokens)
    want = np.stack([np.asarray(t) for t in want], 1)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                 serve_lm.CFG, device="cpu")
    got, _, _ = serve_lm.generate(model, prompts, gen)
    np.testing.assert_array_equal(got, want)


def test_train_lm_losses_equal_the_reference(tmp_path):
    argv = ["--steps", "3", "--width", "64", "--layers", "2", "--seq", "32",
            "--batch", "2", "--vocab", "256", "--device", "cpu"]
    args = train_lm.parse(argv + ["--ckpt", str(tmp_path / "port")])
    cfg = train_lm.config(args)
    ref_cfg = ref_lm.TransformerConfig(
        name="example-lm", n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
        d_ff=192, vocab=256, dtype=jnp.float32, ce_chunk=32)
    assert _port_cfg(ref_cfg) == cfg
    ocfg = RefAdamWConfig(lr=3e-4, warmup_steps=20, total_steps=3)
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))

    @jax.jit
    def step_fn(p, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda q: ref_lm.train_loss(q, batch, ref_cfg))(p)
        p, opt, m = ref_adamw_update(grads, opt, ocfg,
                                     param_dtype=jnp.float32)
        return p, opt, {"loss": loss, **m}

    def make_batch(step):
        return jax.tree.map(jnp.asarray, ref_lm_batch(step, 2, 32, 256))

    ref = RefTrainLoop(step_fn, make_batch,
                       lambda: (params, ref_adamw_init(params)),
                       RefTrainLoopConfig(total_steps=3,
                                          ckpt_dir=str(tmp_path / "ref"),
                                          ckpt_every=50, log_every=10)).run()
    want = [m["loss"] for m in ref["metrics"]]
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    got = train_lm.run(args, model=model)
    assert got["steps"] == [0, 1, 2]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    # a second run resumes from the last checkpoint: no step left
    assert train_lm.run(args, model=model)["losses"] == []
