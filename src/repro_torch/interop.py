"""Carry state across from the JAX reference, as numpy arrays.

Nothing here imports the reference: callers hand over the arrays its
objects expose, so the tests can make both packages compute the same
thing from the same state.

* :func:`problem_from_arrays` builds the port's :class:`Problem` from a
  reference ``Problem``'s ``p.indptr`` / ``p.indices`` / ``p.weights`` /
  ``n`` / ``b`` / ``eps`` / ``target_error`` / ``weight_mode`` /
  ``weights``.
* :func:`seed_session` seeds a port :class:`SolverSession` with the
  ``(F, H)`` of a reference session driver's ``fluid()`` and the
  threshold of its ``threshold()``, through the driver protocol
  (``seed``, ``set_threshold``) both packages share.  The session's
  phase counters restart at zero.
* :func:`engine_from_arrays` builds the port's K-PID engine over a
  reference ``EngineArrays``' fields, optionally carrying a reference
  ``EngineState`` across (``f``, ``h``, ``t`` and the bucket → row map),
  so both packages run one layout from one state.
* :func:`fm_params_from_numpy`, :func:`gnn_params_from_numpy` and
  :func:`lm_params_from_numpy` build the port's FM, GNN (all four archs)
  and transformer modules holding a reference parameter pytree
  (``recsys.init_params`` / ``gnn.init_params`` /
  ``transformer.init_params``) given as numpy arrays.
* :func:`adamw_state_from_numpy` turns a reference ``adamw_init`` /
  ``adamw_update`` state (``master``, ``m``, ``v`` pytrees and ``step``)
  given as numpy arrays into the port's optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .api import Problem, SolverSession
from .balance.executors import BucketMoveExecutor
from .core.distributed import DistributedEngine, EngineArrays, EngineConfig
from .core.graph import CSRGraph
from .graph.views import tile_groups
from .models.gnn import GNNConfig, init_params
from .models.recsys import FM, FMConfig
from .models.transformer import Transformer, TransformerConfig
from .models.transformer import init_params as init_lm

__all__ = ["problem_from_arrays", "seed_session", "engine_from_arrays",
           "fm_params_from_numpy", "gnn_params_from_numpy",
           "lm_params_from_numpy", "adamw_state_from_numpy"]


def problem_from_arrays(indptr, indices, edge_weights, n: int, b, eps: float,
                        target_error: float, weight_mode: str = "inv_out",
                        weights: Optional[np.ndarray] = None) -> Problem:
    """The port's Problem over the same P (out-adjacency CSR), B and
    stopping rule.  ``edge_weights`` are P's entries; ``weights`` are the
    optional node-selection weights (§2.2.1)."""
    p = CSRGraph(indptr=np.asarray(indptr, dtype=np.int64),
                 indices=np.asarray(indices, dtype=np.int32),
                 weights=np.asarray(edge_weights, dtype=np.float64),
                 n=int(n))
    return Problem.linear(
        p, np.asarray(b, dtype=np.float64), eps=eps,
        target_error=target_error, weight_mode=weight_mode,
        weights=None if weights is None else np.asarray(weights,
                                                        dtype=np.float64))


def seed_session(session: SolverSession, f: np.ndarray, h: np.ndarray,
                 t) -> None:
    """Re-seed ``session`` with node-space ``(F, H)`` and threshold ``t``."""
    session._driver.seed(np.asarray(f, dtype=np.float64),
                         np.asarray(h, dtype=np.float64))
    session._driver.set_threshold(np.asarray(t, dtype=np.float64))


_ARRAY_FIELDS = ("f0", "w", "src_slot", "dst_bucket", "dst_slot", "wgt",
                 "pos_of_bucket", "node_of_slot")


def engine_from_arrays(
    fields: Mapping[str, np.ndarray],
    cfg: EngineConfig,
    state: Optional[Mapping[str, np.ndarray]] = None,
) -> Tuple[DistributedEngine, BucketMoveExecutor]:
    """The port's engine over a reference ``EngineArrays``' numpy fields
    (``f0``, ``w``, ``src_slot``, ``dst_bucket``, ``dst_slot``, ``wgt``,
    ``pos_of_bucket``, ``node_of_slot``, ``n``, ``n_edges`` and, for
    ``diffusion_backend="bsr"``, ``tile_dst`` and ``slot_out_deg``; the
    dense ``tiles`` are re-derived from the edges, never read).

    Returns ``(engine, executor)``, the executor cold-started — or, with
    ``state``, holding a reference ``EngineState``: ``f`` and ``h`` as
    ``[R, S]`` in current row order, the per-PID ``t`` and the
    ``row_of_bucket`` map (a reference ``BucketMoveExecutor``'s), plus
    optional ``ops`` and ``rounds`` counters.
    """
    arrays = EngineArrays(
        **{name: np.asarray(fields[name]) for name in _ARRAY_FIELDS},
        n=int(fields["n"]), n_edges=int(fields["n_edges"]))
    if cfg.diffusion_backend == "bsr":
        tile_dst, t_counts, _ = tile_groups(arrays.dst_bucket, arrays.wgt)
        if not np.array_equal(tile_dst, np.asarray(fields["tile_dst"])):
            raise ValueError("tile_dst disagrees with the edges' grouping")
        arrays.tile_dst = tile_dst
        arrays.t_counts = t_counts
        arrays.slot_out_deg = np.asarray(fields["slot_out_deg"])
        arrays.tile_dtype = torch.empty((), dtype=cfg.dtype).numpy().dtype
    engine = DistributedEngine(arrays, cfg)
    ex = BucketMoveExecutor(engine, engine.init_state())
    if state is None:
        return engine, ex
    rob = np.asarray(state["row_of_bucket"], dtype=np.int64)
    # the executor's moving operands follow the map: row c holds what
    # home row perm[c] held
    perm = np.empty_like(rob)
    perm[rob] = np.asarray(arrays.pos_of_bucket, dtype=np.int64)
    ex.state, (ex.w, ex.slot_deg), ex.table = engine.repartition(
        ex.state, perm, rob, (ex.w, ex.slot_deg))
    ex.row_of_bucket = rob
    put = lambda v: torch.as_tensor(np.asarray(v), device=engine.device)
    ex.state.f = put(state["f"]).to(cfg.dtype).reshape(ex.state.f.shape)
    ex.state.h = put(state["h"]).to(cfg.dtype).reshape(ex.state.h.shape)
    ex.state.t = put(state["t"]).to(cfg.dtype).reshape(cfg.k)
    if "ops" in state:
        ex.state.ops = put(state["ops"]).to(torch.int64).reshape(cfg.k)
    ex.state.rounds = int(state.get("rounds", 0))
    return engine, ex


def _fill(param: torch.nn.Parameter, value) -> None:
    value = torch.tensor(np.asarray(value))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(value.shape)} where the port holds "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


def fm_params_from_numpy(params: Mapping, cfg: FMConfig,
                         device="cuda") -> FM:
    """The port's FM holding the reference's ``table``, ``lin_table`` and
    ``bias``."""
    model = FM(cfg, device=device)
    for name in ("table", "lin_table", "bias"):
        _fill(getattr(model, name), params[name])
    return model


def _fill_tree(port: Any, ref: Any, where: str = "") -> None:
    """Fill the port's pytree ``port`` (dicts, lists, parameters) from the
    reference's ``ref`` of the same structure."""
    if isinstance(port, dict):
        if set(port) != set(ref):
            raise ValueError(f"{where or 'tree'}: keys {sorted(ref)} where "
                             f"the port holds {sorted(port)}")
        for k in port:
            _fill_tree(port[k], ref[k], f"{where}/{k}")
    elif isinstance(port, (list, tuple)):
        if len(port) != len(ref):
            raise ValueError(f"{where}: {len(ref)} entries where the port "
                             f"holds {len(port)}")
        for i, (a, b) in enumerate(zip(port, ref)):
            _fill_tree(a, b, f"{where}/{i}")
    else:
        _fill(port, ref)


def gnn_params_from_numpy(params: Mapping, cfg: GNNConfig,
                          device="cuda") -> torch.nn.Module:
    """The port's GNN of ``cfg.arch`` holding the reference's parameter
    pytree: GIN's ``embed``, ``eps``, ``mlps``, ``readout``;
    MeshGraphNet's ``node_enc``, ``edge_enc``, ``edge_mlps``,
    ``node_mlps``, ``decoder``; EGNN's ``embed``, ``edge_mlps``,
    ``coord_mlps``, ``node_mlps``, ``readout``; DimeNet's ``atom_embed``,
    ``rbf_proj``, ``edge_embed``, ``blocks`` (a list of ``sbf_proj``,
    ``w_bil [nb, d, d]``, ``msg_mlp``, ``out_mlp``) and ``readout``; each
    MLP a ``{"w": [...], "b": [...]}``."""
    model = init_params(cfg, device=device)
    _fill_tree(model.param_tree(), params)
    return model


def lm_params_from_numpy(params: Mapping, cfg: TransformerConfig,
                         device="cuda") -> Transformer:
    """The port's transformer holding the reference's ``embed``,
    ``final_norm``, ``lm_head`` and stacked ``layers`` (``ln1``, ``ln2``,
    ``wq``, ``wk``, ``wv``, ``wo``, the QKV biases, ``w1``, ``w3``,
    ``w2``; a MoE config's ``router``, ``ew1``, ``ew3``, ``ew2``, the
    padded experts included, and the shared experts' ``sw1``, ``sw3``,
    ``sw2``), cast to ``cfg.dtype``."""
    model = init_lm(cfg, device=device)
    for name in ("embed", "final_norm", "lm_head"):
        _fill(getattr(model, name), params[name])
    layers = params["layers"]
    if set(layers) != set(model.layers):
        raise ValueError(f"layers {sorted(layers)} where the port holds "
                         f"{sorted(model.layers)}")
    for name, p in model.layers.items():
        _fill(p, layers[name])
    return model


def adamw_state_from_numpy(state: Mapping, device="cuda") -> Dict[str, Any]:
    """The port's AdamW state (:func:`repro_torch.optim.adamw_init`'s
    layout) holding a reference state's ``master``, ``m`` and ``v`` (float32
    pytrees of dicts and lists) and ``step``, given as numpy arrays."""
    dev = torch.device(device)

    def tree(node):
        if isinstance(node, Mapping):
            return {k: tree(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [tree(x) for x in node]
        return torch.tensor(np.asarray(node, dtype=np.float32), device=dev)

    out = {name: tree(state[name]) for name in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=dev)
    return out
