"""Decoder-only transformer LM (dense and MoE): training, prefill and
decode.

The port of ``repro.models.transformer``: GQA attention
(with optional QKV bias, Qwen-style), RMSNorm, RoPE, SwiGLU FFN or a MoE
FFN (shared + routed experts, top-k routing with capacity-based
dispatch), untied LM head, parameters stacked ``[L, ...]`` under the
reference's names.  Attention runs on K6
(:func:`repro_torch.kernels.attention.flash_attention`) for tensors on
the card, its plain version on the CPU: the Pallas kernel that the
reference calls "the TPU drop-in" is the port's attention proper.  The
MoE combine (the reference's ``jax.ops.segment_sum``) runs on K5's gather
form (:func:`repro_torch.kernels.segment.segment_sum_sorted`, bf16 rows
read as they are).

Serving only, on one device, eagerly (a Python loop over the layers):

* :func:`prefill_step` runs a prompt causally and writes each layer's
  k / v into a ``[L, B, max_seq, Hkv, Dh]`` cache allocated once (the
  reference pads its cache after the scan);
* :func:`decode_step` writes the new k / v at ``pos`` **in place** (the
  reference returns a new cache) and attends over the first ``pos + 1``
  cache slots (K6's ``kv_len``; the reference masks ``kpos <= pos``).
  A cache that holds ``k_scale`` / ``v_scale`` is the int8 KV cache: the
  step quantises the new k / v per (token, head) (:func:`quantize_kv`),
  writes them and their scales at ``pos`` in place, and attends over the
  int8 cache on K6's int8 decode form, which dequantises each tile as it
  loads it (the reference dequantises the whole cache, then attends).
  :func:`quantize_cache` makes such a cache from a prefill's.

The MoE FFN (:func:`_moe_ffn`) keeps the reference's semantics, those
that look odd included: the capacity ``ceil(T·k / E · capacity_factor)``
counts the routed experts, so at a decode step of 8 tokens on
qwen2-moe-a2.7b it is 1 and a second token routed to an expert is
dropped; the padded experts receive no token but run through the expert
``bmm`` all the same.  :func:`set_expert_load_sink` taps each dispatch's
per-expert routed counts (a host read, only while a sink is registered).

Training, on one device, eagerly (:func:`train_loss`, the reference's
mean token cross-entropy plus the MoE auxiliary loss summed over the
layers): the layers run in a Python loop over the stacked parameters
(``unbind``, so that a parameter's gradient is stacked once), each under
``torch.utils.checkpoint`` (non-reentrant) with ``remat``; the cross
entropy runs ``ce_chunk`` tokens of a row at a time and recomputes each
chunk's logits in its backward (:class:`_ChunkedCE`), so that no
``[B, S, V]`` logits are kept; ``n_microbatches`` splits the batch, each
microbatch its own forward.  Attention's gradient is K6's backward
(:func:`repro_torch.kernels.attention.flash_attention_train`), the MoE
combine's the combine backward of K5's gather form and the dispatch
gather's K5's gather form itself (:func:`repro_torch.kernels.segment.
moe_combine` / ``moe_dispatch``); ``kernels=False`` runs the plain
versions of all of them.  The recomputation under ``remat`` routes as the
first forward did (the same ops on the same inputs) and, as the
reference's ``jax.debug.callback`` under ``jax.checkpoint`` does, hands
the expert-load sink its counts again.  Serving runs under
``torch.inference_mode``; training outside it, with the parameters'
``requires_grad`` set (``launch.steps``).

``attn_q_chunk`` stays in :class:`TransformerConfig` so that configs match
the reference's, but it is ignored: K6 never materialises ``[Sq, Sk]``.
The expert-parallel MoE (``_moe_ffn_ep``) and the distributed decode
attention wait for more than one card (ROADMAP §1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as fn
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import (attention_train_plain, flash_attention,
                                 flash_attention_train)
from ..kernels.segment import (moe_combine, moe_dispatch, segment_sum_ref,
                               segment_sum_sorted)

__all__ = ["MoEConfig", "TransformerConfig", "Transformer", "init_params",
           "init_cache", "quantize_kv", "quantize_cache", "prefill_step",
           "decode_step", "train_loss", "set_expert_load_sink", "rmsnorm",
           "rope"]

Attention = Callable[..., torch.Tensor]
# the MoE combine: ``combine(data, seg_ids, n, weights=, rows=)`` with K5's
# contract (segment_sum_sorted, or its plain version segment_sum_ref, which
# under autograd also brings the plain backwards of the combine and the
# dispatch gather)
Combine = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared experts, fused into one dense SwiGLU
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss
    pad_experts_to: int = 0  # pad expert tensors for even EP sharding

    @property
    def e_pad(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = torch.bfloat16
    # per-shape training knobs (overridden by launch configs): tokens of a
    # cross-entropy chunk, microbatches of a step, checkpointed layers
    ce_chunk: int = 1024
    n_microbatches: int = 1
    remat: bool = True
    # the reference's q-chunked XLA attention; kept so that the configs
    # match, read by nothing here (K6 never materialises [Sq, Sk])
    attn_q_chunk: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting)."""
        d, v, l = self.d_model, self.vocab, self.n_layers
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv_heads)
        if self.moe is None:
            ffn = 3 * d * self.d_ff
        else:
            m = self.moe
            ffn = m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
            if m.n_shared:
                ffn += 3 * d * (m.d_ff_expert * m.n_shared)
        norms = 2 * d
        return l * (attn + ffn + norms) + 2 * v * d + d

    @property
    def n_active_params(self) -> int:
        """Active per-token params (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.n_params
        d, l, m = self.d_model, self.n_layers, self.moe
        routed_all = m.n_experts * 3 * d * m.d_ff_expert
        routed_act = m.top_k * 3 * d * m.d_ff_expert
        return self.n_params - l * (routed_all - routed_act)


class Transformer(nn.Module):
    """The parameters on one device, under the reference's names:
    ``embed [V, D]``, ``final_norm [D]``, ``lm_head [D, V]`` and
    ``layers.{ln1, ln2, wq, wk, wv, wo, [bq, bk, bv], w1, w3, w2}``
    stacked ``[L, ...]``, weights in ``x @ w`` layout; a MoE config holds
    ``router [L, D, E]``, ``ew1`` / ``ew3 [L, E_pad, D, F]``, ``ew2 [L,
    E_pad, F, D]`` (the padded experts included) and, with shared experts,
    ``sw1`` / ``sw3 [L, D, F·n_shared]``, ``sw2 [L, F·n_shared, D]`` in
    place of ``w1``, ``w3``, ``w2``.  Weights are drawn N(0, 1/fan_in) in
    float32 from ``gen`` (the experts' one layer at a time) and cast to
    ``cfg.dtype``; norms start at 1, biases at 0, as in the reference."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        hq, hkv, l = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
        dev, dt = gen.device, cfg.dtype

        def dense(shape, fan_in):
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev)
            return nn.Parameter(w.mul_(1.0 / math.sqrt(fan_in)).to(dt),
                                requires_grad=False)

        def experts(shape, fan_in):
            # a layer at a time: no float32 copy of all the experts
            w = torch.empty(shape, dtype=dt, device=dev)
            for i in range(shape[0]):
                w[i] = torch.randn(shape[1:], generator=gen,
                                   dtype=torch.float32, device=dev).mul_(
                                       1.0 / math.sqrt(fan_in))
            return nn.Parameter(w, requires_grad=False)

        def const(shape, value):
            return nn.Parameter(torch.full(shape, value, dtype=dt,
                                           device=dev), requires_grad=False)

        layers = {
            "ln1": const((l, d), 1.0),
            "ln2": const((l, d), 1.0),
            "wq": dense((l, d, hq * hd), d),
            "wk": dense((l, d, hkv * hd), d),
            "wv": dense((l, d, hkv * hd), d),
            "wo": dense((l, hq * hd, d), hq * hd),
        }
        if cfg.qkv_bias:
            layers["bq"] = const((l, hq * hd), 0.0)
            layers["bk"] = const((l, hkv * hd), 0.0)
            layers["bv"] = const((l, hkv * hd), 0.0)
        if cfg.moe is None:
            layers["w1"] = dense((l, d, cfg.d_ff), d)
            layers["w3"] = dense((l, d, cfg.d_ff), d)
            layers["w2"] = dense((l, cfg.d_ff, d), cfg.d_ff)
        else:
            m = cfg.moe
            f = m.d_ff_expert
            layers["router"] = dense((l, d, m.n_experts), d)
            layers["ew1"] = experts((l, m.e_pad, d, f), d)
            layers["ew3"] = experts((l, m.e_pad, d, f), d)
            layers["ew2"] = experts((l, m.e_pad, f, d), f)
            if m.n_shared:
                fs = f * m.n_shared
                layers["sw1"] = dense((l, d, fs), d)
                layers["sw3"] = dense((l, d, fs), d)
                layers["sw2"] = dense((l, fs, d), fs)
        self.layers = nn.ParameterDict(layers)
        self.embed = dense((cfg.vocab, d), d)
        self.final_norm = const((d,), 1.0)
        self.lm_head = dense((d, cfg.vocab), d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s parameters (views of the stacked tensors)."""
        return {name: p[i] for name, p in self.layers.items()}

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the reference's pytree, ``{"embed",
        "final_norm", "layers": {...}, "lm_head"}``: the module's own
        tensors (the training state, and what a checkpoint holds)."""
        return {"embed": self.embed, "final_norm": self.final_norm,
                "layers": dict(self.layers), "lm_head": self.lm_head}

    @torch.no_grad()
    def load_param_tree(self, tree: Dict[str, Any]) -> None:
        """Copy a :meth:`param_tree`-shaped tree of tensors (a restored
        checkpoint's) into the parameters; the module's own tensors are
        left as they are."""
        own = self.param_tree()
        pairs = [(own[k], tree[k]) for k in ("embed", "final_norm",
                                             "lm_head")]
        pairs += [(own["layers"][k], tree["layers"][k])
                  for k in own["layers"]]
        for dst, src in pairs:
            if src is not dst:
                dst.copy_(src)


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device="cuda") -> Transformer:
    """The model's parameters on ``device``, drawn from a seeded
    ``torch.Generator`` there."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return Transformer(cfg, gen)


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def _rope_tables(positions: torch.Tensor, theta: float, dh: int,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin ``[..., S, 1, Dh/2]`` for positions ``[..., S]``, computed
    in float32 and cast to ``dtype``, as the reference does per layer."""
    half = dh // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return (torch.cos(ang)[..., None, :].to(dtype),
            torch.sin(ang)[..., None, :].to(dtype))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: ``[B, S, H, Dh]``; positions: ``[B, S]`` (or ``[S]``)."""
    cos, sin = _rope_tables(positions, theta, x.shape[-1], x.dtype)
    return _apply_rope(x, cos, sin)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, kv_len: Optional[int] = None,
               attention: Attention = flash_attention,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, Sq, Hq, Dh]``, k / v ``[B, Sk, Hkv, Dh]`` (views allowed) ->
    ``[B, Sq, Hq, Dh]``, through ``attention`` in its ``[B, H, S, Dh]``
    layout (K6 takes the transposed views as they are).  With scales
    (``[B, Sk, Hkv]`` float32) k / v are the int8 cache."""
    kw = {}
    if k_scale is not None:
        kw = {"k_scale": k_scale.transpose(1, 2),
              "v_scale": v_scale.transpose(1, 2)}
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, kv_len=kv_len, **kw)
    return out.transpose(1, 2)


def _dense_ffn(lp: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = fn.silu(x @ lp["w1"]) * (x @ lp["w3"])
    return h @ lp["w2"]


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
_expert_load_sink: Optional[Callable[[np.ndarray], Any]] = None


def set_expert_load_sink(sink: Optional[Callable[[np.ndarray], Any]]
                         ) -> None:
    """Register ``sink(counts: np.ndarray[n_experts])`` as the expert-load
    sink: every MoE dispatch then hands it its per-expert routed counts
    (each (token, slot) counted, dropped ones too; int32) — the
    ``expert-tokens`` signal of :mod:`repro_torch.balance`
    (``LoadSignal.from_expert_counts``).  The counts are read to the host
    at each dispatch, so only while a sink is registered.  ``None``
    unhooks."""
    global _expert_load_sink
    _expert_load_sink = sink


def _route(router: torch.Tensor, xf: torch.Tensor, m: MoEConfig):
    """The router over tokens ``xf [T, D]``: logits in the model's dtype
    cast to float32, softmax, top-k and the gate weights renormalised;
    returns ``(probs [T, E], gate_w [T, k], gate_i [T, k])``."""
    probs = torch.softmax((xf @ router).float(), dim=-1)
    gate_w, gate_i = torch.topk(probs, m.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_i


def _capacity(t: int, m: MoEConfig) -> int:
    """Slots an expert takes: ``ceil(T·k / E · capacity_factor)`` over the
    routed experts, as in the reference's single-device dispatch."""
    return int(math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))


def _slots(gate_i: torch.Tensor, m: MoEConfig):
    """Each (token, slot)'s expert and its position among the expert's
    slots in token order (a token picks an expert once, so the order of a
    token's k slots does not matter): ``(flat_e [T·k], pos [T·k],
    counts [E])``, ``pos`` and ``counts`` int32."""
    flat_e = gate_i.reshape(-1)
    experts = torch.arange(m.n_experts, device=flat_e.device)
    # one row an expert, so that the scan runs along the contiguous dim (a
    # scan down the T·k rows of [T·k, E] took 45 ms a layer at 32k tokens)
    onehot = (experts[:, None] == flat_e).to(torch.int32)
    csum = onehot.cumsum(1, dtype=torch.int32)
    pos = csum.gather(0, flat_e[None, :])[0] - 1
    return flat_e, pos, csum[:, -1]


def _dispatch(xf: torch.Tensor, gate_i: torch.Tensor, m: MoEConfig,
              combine: Combine = segment_sum_sorted):
    """The dispatch of tokens ``xf [T, D]`` routed to ``gate_i [T, k]``:
    ``(buf [E_pad, cap, D], dest [T·k], keep [T·k], counts [E], slot
    [E_pad·cap])``, where slot ``(t, j)`` (index ``t·k + j``) goes to row
    ``dest = e·cap + pos`` of the buffer when ``keep`` (``pos < cap``) and
    ``slot`` maps each buffer row back to its slot index (``T·k`` where
    none).  The buffer is filled by a gather: a kept slot's destination is
    unique, an empty slot reads a zero row.  With a gradient wanted the
    gather is :func:`moe_dispatch`'s, whose backward sums each token's
    kept slots' rows and reads no row for a dropped slot (``combine``
    gives its kind)."""
    t, d = xf.shape
    k = m.top_k
    cap = _capacity(t, m)
    flat_e, pos, counts = _slots(gate_i, m)
    keep = pos < cap
    n_slots = m.e_pad * cap
    dest = flat_e * cap + pos
    # the dropped slots all land in a spare last entry
    slot = torch.full((n_slots + 1,), t * k, dtype=torch.int64,
                      device=xf.device)
    slot.scatter_(0, torch.where(keep, dest, n_slots),
                  torch.arange(t * k, device=xf.device))
    slot = slot[:n_slots]
    # each buffer row's token: t (the zero row) where none
    buf = moe_dispatch(xf, slot // k, dest=dest, keep=keep, combine=combine)
    return buf.view(m.e_pad, cap, d), dest, keep, counts, slot


def _moe_ffn(lp: Dict[str, torch.Tensor], x: torch.Tensor,
             cfg: TransformerConfig, combine: Combine = segment_sum_sorted):
    """Capacity-based top-k MoE over ``x [B, S, D]``; returns ``(out [B,
    S, D], aux)``.  The dispatch buffer (:func:`_dispatch`) runs through
    the experts' SwiGLU, three ``bmm`` over every expert, padded ones
    included, and the combine ``out[t] = Σ_slots w·eo[e, pos]`` is
    ``combine`` over the expert outputs' rows in float32 (K5's bf16-row
    form on the card for a bf16 model).  A dropped slot names row -1 and
    weight 0: it reads no row and adds exact zeros, forward and backward,
    whatever the experts' outputs hold, as the reference's ``where(keep,
    ...)`` does.
    Under autograd the dispatch's and the combine's gradients are the
    kernels' (with the plain ``combine``, ``segment_sum_ref``, their plain
    versions)."""
    m = cfg.moe
    b, s, d = x.shape
    t, k = b * s, m.top_k
    xf = x.reshape(t, d)
    probs, gate_w, gate_i = _route(lp["router"], xf, m)
    tok_idx = torch.arange(t, dtype=torch.int32,
                           device=x.device).repeat_interleave(k)
    buf, dest, keep, counts, slot = _dispatch(xf, gate_i, m, combine)
    n_slots = buf.shape[0] * buf.shape[1]
    h = fn.silu(torch.bmm(buf, lp["ew1"])) * torch.bmm(buf, lp["ew3"])
    eo = torch.bmm(h, lp["ew2"])
    # the gate weights rounded to the model's dtype, as the reference's
    # (the gradient passes the rounding, as through JAX's astype)
    w = torch.where(keep, gate_w.reshape(-1).to(x.dtype).float(), 0.0)
    out = moe_combine(eo.view(n_slots, d), tok_idx, t, weights=w,
                      rows=torch.where(keep, dest, -1), slot=slot,
                      combine=combine).to(x.dtype)
    if _expert_load_sink is not None:
        _expert_load_sink(counts.cpu().numpy())
    # auxiliary load-balance loss (Switch-style)
    ce = counts.float() / max(t * k, 1)
    aux = m.n_experts * (probs.mean(0) * ce).sum() * m.router_aux_weight
    if m.n_shared:
        sh = fn.silu(xf @ lp["sw1"]) * (xf @ lp["sw3"])
        out = out + sh @ lp["sw2"]
    return out.reshape(b, s, d), aux


def _moe(lp: Dict[str, torch.Tensor], x: torch.Tensor,
         cfg: TransformerConfig, combine: Combine = segment_sum_sorted,
         mesh: Any = None):
    """:func:`_moe_ffn` on one device; a ``mesh`` (the reference's
    expert-parallel ``_moe_ffn_ep``) raises."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel MoE (_moe_ffn_ep) waits for more than one "
            "card (ROADMAP §1, item 7 (a))")
    return _moe_ffn(lp, x, cfg, combine)


def _layer(lp: Dict[str, torch.Tensor], x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, cfg: TransformerConfig,
           cache: Optional[Tuple[torch.Tensor, ...]] = None,
           pos: int = 0, attention: Attention = flash_attention,
           combine: Combine = segment_sum_sorted):
    """One decoder layer over ``x [B, S, D]``; returns ``(x, k, v, aux)``
    with this layer's new ``k`` / ``v`` ``[B, S, Hkv, Dh]`` and its MoE
    auxiliary loss (0 for a dense layer).  Without ``cache``
    the layer attends causally over its own k / v (prefill); with
    ``cache=(ck, cv)`` (``[B, Smax, Hkv, Dh]``) it writes k / v at ``pos``
    in place and attends over slots ``[0, pos + S)``; with ``cache=(ck,
    cv, ks, vs)`` (int8, scales ``[B, Smax, Hkv]`` float32) it writes the
    quantised k / v and their scales."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    y = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, kk, vv = y @ lp["wq"], y @ lp["wk"], y @ lp["wv"]
    if cfg.qkv_bias:
        q, kk, vv = q + lp["bq"], kk + lp["bk"], vv + lp["bv"]
    q = _apply_rope(q.reshape(b, s, hq, hd), cos, sin)
    kk = _apply_rope(kk.reshape(b, s, hkv, hd), cos, sin)
    vv = vv.reshape(b, s, hkv, hd)
    if cache is None:
        attn = _attention(q, kk, vv, causal=True, attention=attention)
    else:
        ck, cv = cache[:2]
        scales = {}
        if len(cache) == 4:  # int8 KV cache
            ks, vs = cache[2:]
            (ck[:, pos:pos + s], ks[:, pos:pos + s]) = quantize_kv(kk)
            (cv[:, pos:pos + s], vs[:, pos:pos + s]) = quantize_kv(vv)
            scales = {"k_scale": ks, "v_scale": vs}
        else:
            ck[:, pos:pos + s] = kk
            cv[:, pos:pos + s] = vv
        attn = _attention(q, ck, cv, causal=False, kv_len=pos + s,
                          attention=attention, **scales)
    x = x + attn.reshape(b, s, hq * hd) @ lp["wo"]
    y = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        x = x + _dense_ffn(lp, y)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        ffn, aux = _moe(lp, y, cfg, combine)
        x = x + ffn
    return x, kk, vv, aux


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None,
               device="cuda") -> Dict[str, Any]:
    """``{"k", "v"}`` zeros ``[L, B, max_seq, Hkv, Dh]`` and ``"pos"``, the
    next slot to write, as a Python int (no device read per step).  With
    ``dtype=torch.int8`` the int8 KV cache: also ``"k_scale"`` /
    ``"v_scale"`` zeros ``[L, B, max_seq, Hkv]`` float32."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = torch.device(device)
    kw = dict(dtype=dtype or cfg.dtype, device=dev)
    cache = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
             "pos": 0}
    if kw["dtype"] == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
    return cache


# float32 1 / 127 and 1e-8: XLA compiles the reference's ``max|x| / 127.0 +
# 1e-8`` into a product with this reciprocal, and its CPU code fuses the
# product and the add into one FMA
_R127 = float(np.float32(1) / np.float32(127))
_EPS = float(np.float32(1e-8))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (token, head) int8 quantisation of k or v ``[..., Dh]``, the
    reference's int8 decode step's: ``scale = max|x| / 127 + 1e-8`` in
    x's dtype, ``q = clip(round(x / scale), -127, 127)`` (round half to
    even) as int8; returns ``(q, scale as float32 [...])``.  The scale is
    taken as the compiled reference takes it, ``max|x|`` times the float32
    reciprocal of 127 plus 1e-8: in float32 with one rounding (an FMA,
    exact in float64), in bf16 rounded after the product and after the
    add; so the scales are the reference decode step's bit for bit.
    ``x / scale`` divides by a tensor, an IEEE quotient on either
    device."""
    amax = x.abs().amax(dim=-1)
    if x.dtype == torch.float32:
        scale = (amax.double() * _R127 + _EPS).float()
    else:
        scale = (amax.float() * _R127).to(x.dtype) + 1e-8
    q = torch.round(x / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale.float()


def quantize_cache(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The int8 KV cache of a float cache (a prefill's): every slot
    quantised by :func:`quantize_kv` (the empty ones get scale ``1e-8``),
    a layer at a time; ``pos`` carried over."""
    out: Dict[str, Any] = {"pos": cache["pos"]}
    for name in ("k", "v"):
        src = cache[name]
        q = torch.empty(src.shape, dtype=torch.int8, device=src.device)
        sc = torch.empty(src.shape[:-1], dtype=torch.float32,
                         device=src.device)
        for i in range(src.shape[0]):
            q[i], sc[i] = quantize_kv(src[i])
        out[name], out[name + "_scale"] = q, sc
    return out


def _tokens(model: Transformer, tokens) -> torch.Tensor:
    if not torch.is_tensor(tokens):  # a copy: the array may be read-only
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
    return tokens.to(model.device).long()


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, model.cfg.norm_eps)
    return (x @ model.lm_head).float()


def prefill_step(model: Transformer, tokens, max_seq: Optional[int] = None,
                 *, attention: Attention = flash_attention,
                 combine: Combine = segment_sum_sorted):
    """Process a prompt ``tokens [B, S]``; return ``(cache, logits)``, the
    last token's logits ``[B, V]`` in float32.

    ``max_seq`` sizes the cache so that decode can continue past the
    prompt (default ``S``).  ``attention`` replaces K6's op and
    ``combine`` K5's (their plain versions, for a comparison).
    """
    cfg = model.cfg
    tokens = _tokens(model, tokens)
    b, s = tokens.shape
    max_seq = s if max_seq is None else max_seq
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} below the prompt's {s} tokens")
    x = model.embed[tokens]
    positions = torch.arange(s, device=model.device)
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim, x.dtype)
    cache = init_cache(cfg, b, max_seq, x.dtype, model.device)
    for i in range(cfg.n_layers):
        x, kk, vv, _ = _layer(model.layer(i), x, cos, sin, cfg,
                              attention=attention, combine=combine)
        cache["k"][i, :, :s] = kk
        cache["v"][i, :, :s] = vv
    cache["pos"] = s
    # RMSNorm is per token: normalising the last one alone is the same
    return cache, _logits(model, x[:, -1])


def decode_step(model: Transformer, cache: Dict[str, Any], tokens, *,
                attention: Attention = flash_attention,
                combine: Combine = segment_sum_sorted):
    """One decode step: ``tokens [B]`` -> ``(logits [B, V] float32,
    cache)``.  Writes the new k / v into ``cache["k"]`` / ``cache["v"]`` at
    ``cache["pos"]`` in place (quantised, with their scales, when the cache
    holds ``k_scale`` / ``v_scale``) and returns a new dict holding the
    same tensors and ``pos + 1``."""
    cfg = model.cfg
    tokens = _tokens(model, tokens)
    pos = int(cache["pos"])
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache else (
        "k", "v")
    tensors = [cache[n] for n in names]
    if pos >= tensors[0].shape[2]:
        raise ValueError(f"the cache's {tensors[0].shape[2]} slots are full")
    x = model.embed[tokens][:, None, :]
    positions = torch.full((1,), pos, device=model.device)
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim, x.dtype)
    for i in range(cfg.n_layers):
        x = _layer(model.layer(i), x, cos, sin, cfg,
                   cache=tuple(t[i] for t in tensors), pos=pos,
                   attention=attention, combine=combine)[0]
    return _logits(model, x[:, 0]), {**dict(zip(names, tensors)),
                                     "pos": pos + 1}


# --------------------------------------------------------------------------- #
# training loss (chunked CE + microbatching)
# --------------------------------------------------------------------------- #
def _stack_scan(model: Transformer, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cfg: TransformerConfig, kernels: bool):
    """The layers over ``x`` (each checkpointed with ``cfg.remat``);
    returns ``(x, aux summed over the layers)``."""
    attention = flash_attention_train if kernels else attention_train_plain
    combine = segment_sum_sorted if kernels else segment_sum_ref
    names = list(model.layers)
    stacked = [p.unbind(0) for p in model.layers.values()]

    def body(x, *lp):
        y, _, _, aux = _layer(dict(zip(names, lp)), x, cos, sin, cfg,
                              attention=attention, combine=combine)
        return y, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = [t[i] for t in stacked]
        if cfg.remat:
            x, a = checkpoint(body, x, *lp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(x, *lp)
        aux = aux + a
    return x, aux


class _ChunkedCE(torch.autograd.Function):
    """The summed token cross-entropy of ``x [B, S, D] @ w [D, V]`` over
    ``labels [B, S]``, ``chunk`` tokens of each row at a time; the backward
    recomputes each chunk's logits, so that none are kept."""

    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, x.shape[1], chunk):
            logits = (x[:, c:c + chunk] @ w).float()
            gold = logits.gather(-1, labels[:, c:c + chunk, None])[..., 0]
            tot = tot + (torch.logsumexp(logits, dim=-1) - gold).sum()
        ctx.save_for_backward(x, w, labels)
        ctx.chunk = chunk
        return tot

    @staticmethod
    def backward(ctx, g):
        x, w, labels = ctx.saved_tensors
        gx = torch.empty_like(x)
        gw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for c in range(0, x.shape[1], ctx.chunk):
            xc = x[:, c:c + ctx.chunk]
            # d(logsumexp - gold)/dlogits = softmax - onehot
            dl = torch.softmax((xc @ w).float(), dim=-1)
            dl.scatter_add_(-1, labels[:, c:c + ctx.chunk, None],
                            torch.full(dl.shape[:-1] + (1,), -1.0,
                                       device=dl.device))
            dl = dl.mul_(g).to(x.dtype)
            gx[:, c:c + ctx.chunk] = dl @ w.t()
            gw += (xc.reshape(-1, xc.shape[-1]).t()
                   @ dl.reshape(-1, dl.shape[-1])).float()
        return gx, gw.to(w.dtype), None, None


def _chunked_ce(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """Mean token CE without materialising ``[B, S, V]``."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of ce_chunk "
                         f"{chunk}")
    return _ChunkedCE.apply(x, lm_head, labels, chunk) / (b * s)


def _forward_loss(model: Transformer, tokens: torch.Tensor,
                  labels: torch.Tensor, cfg: TransformerConfig,
                  kernels: bool) -> torch.Tensor:
    x = fn.embedding(tokens, model.embed)
    positions = torch.arange(tokens.shape[1], device=model.device)
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim, x.dtype)
    x, aux = _stack_scan(model, x, cos, sin, cfg, kernels)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return _chunked_ce(x, model.lm_head, labels, cfg.ce_chunk) + aux


def train_loss(model: Transformer, batch, cfg: Optional[TransformerConfig]
               = None, *, kernels: bool = True) -> torch.Tensor:
    """Mean CE (plus the MoE auxiliary loss) over the batch ``{"tokens",
    "labels"}`` (``[B, S]``), split into ``cfg.n_microbatches`` (``cfg``:
    the model's, or one with other training knobs), as the reference's
    ``train_loss``; a float32 scalar with its autograd graph.
    ``kernels=False`` runs the plain versions of K6, K5 and their
    backwards."""
    cfg = cfg or model.cfg
    tokens = _tokens(model, batch["tokens"])
    labels = _tokens(model, batch["labels"])
    nm = cfg.n_microbatches
    if nm <= 1:
        return _forward_loss(model, tokens, labels, cfg, kernels)
    b = tokens.shape[0]
    if b % nm:
        raise ValueError(f"batch {b} is not a multiple of n_microbatches "
                         f"{nm}")
    mb = b // nm
    tot = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(nm):
        sl = slice(i * mb, (i + 1) * mb)
        tot = tot + _forward_loss(model, tokens[sl], labels[sl], cfg,
                                  kernels)
    return tot / nm
