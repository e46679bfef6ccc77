"""Decoder-only transformer LM, dense, for serving: prefill and decode.

The port of ``repro.models.transformer``'s dense path: GQA attention (with
optional QKV bias, Qwen-style), RMSNorm, RoPE, SwiGLU FFN, untied LM head,
parameters stacked ``[L, ...]`` under the reference's names.  Attention
runs on K6 (:func:`repro_torch.kernels.attention.flash_attention`) for
tensors on the card, its plain version on the CPU: the Pallas kernel that
the reference calls "the TPU drop-in" is the port's attention proper.

Serving only, on one device, eagerly (a Python loop over the layers):

* :func:`prefill_step` runs a prompt causally and writes each layer's
  k / v into a ``[L, B, max_seq, Hkv, Dh]`` cache allocated once (the
  reference pads its cache after the scan);
* :func:`decode_step` writes the new k / v at ``pos`` **in place** (the
  reference returns a new cache) and attends over the first ``pos + 1``
  cache slots (K6's ``kv_len``; the reference masks ``kpos <= pos``).

``attn_q_chunk`` stays in :class:`TransformerConfig` so that configs match
the reference's, but it is ignored: K6 never materialises ``[Sq, Sk]``.
MoE (``_moe``, the expert-parallel path), the int8 KV cache, the
distributed decode attention and training (``train_loss``, with its
``ce_chunk`` / ``n_microbatches`` / ``remat`` knobs) wait (ROADMAP); a
config with ``moe`` set raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as fn
from torch import nn

from ..kernels.attention import flash_attention

__all__ = ["TransformerConfig", "Transformer", "init_params", "init_cache",
           "prefill_step", "decode_step", "rmsnorm", "rope"]

Attention = Callable[..., torch.Tensor]


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
    moe: Any = None
    dtype: torch.dtype = torch.bfloat16
    # the reference's q-chunked XLA attention; kept so that the configs
    # match, read by nothing here (K6 never materialises [Sq, Sk])
    attn_q_chunk: Optional[int] = None

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                "MoE is not ported yet (ROADMAP §1, item 7 (a): MoE with "
                "its expert-parallel path)")

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
        ffn = 3 * d * self.d_ff
        norms = 2 * d
        return l * (attn + ffn + norms) + 2 * v * d + d


class Transformer(nn.Module):
    """The parameters on one device, under the reference's names:
    ``embed [V, D]``, ``final_norm [D]``, ``lm_head [D, V]`` and
    ``layers.{ln1, ln2, wq, wk, wv, wo, [bq, bk, bv], w1, w3, w2}``
    stacked ``[L, ...]``, weights in ``x @ w`` layout.  Weights are drawn
    N(0, 1/fan_in) in float32 from ``gen`` and cast to ``cfg.dtype``; norms
    start at 1, biases at 0, as in the reference."""

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
        layers["w1"] = dense((l, d, cfg.d_ff), d)
        layers["w3"] = dense((l, d, cfg.d_ff), d)
        layers["w2"] = dense((l, cfg.d_ff, d), cfg.d_ff)
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
               attention: Attention = flash_attention) -> torch.Tensor:
    """q ``[B, Sq, Hq, Dh]``, k / v ``[B, Sk, Hkv, Dh]`` (views allowed) ->
    ``[B, Sq, Hq, Dh]``, through ``attention`` in its ``[B, H, S, Dh]``
    layout (K6 takes the transposed views as they are)."""
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, kv_len=kv_len)
    return out.transpose(1, 2)


def _dense_ffn(lp: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = fn.silu(x @ lp["w1"]) * (x @ lp["w3"])
    return h @ lp["w2"]


def _layer(lp: Dict[str, torch.Tensor], x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, cfg: TransformerConfig,
           cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           pos: int = 0, attention: Attention = flash_attention):
    """One decoder layer over ``x [B, S, D]``; returns ``(x, k, v)`` with
    this layer's new ``k`` / ``v`` ``[B, S, Hkv, Dh]``.  Without ``cache``
    the layer attends causally over its own k / v (prefill); with
    ``cache=(ck, cv)`` (``[B, Smax, Hkv, Dh]``) it writes k / v at ``pos``
    in place and attends over slots ``[0, pos + S)``."""
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
        ck, cv = cache
        ck[:, pos:pos + s] = kk
        cv[:, pos:pos + s] = vv
        attn = _attention(q, ck, cv, causal=False, kv_len=pos + s,
                          attention=attention)
    x = x + attn.reshape(b, s, hq * hd) @ lp["wo"]
    x = x + _dense_ffn(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return x, kk, vv


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None,
               device="cuda") -> Dict[str, Any]:
    """``{"k", "v"}`` zeros ``[L, B, max_seq, Hkv, Dh]`` and ``"pos"``, the
    next slot to write, as a Python int (no device read per step)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(dtype=dtype or cfg.dtype, device=torch.device(device))
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "pos": 0}


def _tokens(model: Transformer, tokens) -> torch.Tensor:
    if not torch.is_tensor(tokens):  # a copy: the array may be read-only
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int64))
    return tokens.to(model.device).long()


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, model.final_norm, model.cfg.norm_eps)
    return (x @ model.lm_head).float()


def prefill_step(model: Transformer, tokens, max_seq: Optional[int] = None,
                 *, attention: Attention = flash_attention):
    """Process a prompt ``tokens [B, S]``; return ``(cache, logits)``, the
    last token's logits ``[B, V]`` in float32.

    ``max_seq`` sizes the cache so that decode can continue past the
    prompt (default ``S``).  ``attention`` replaces K6's op (the plain
    version, for a comparison).
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
        x, kk, vv = _layer(model.layer(i), x, cos, sin, cfg,
                           attention=attention)
        cache["k"][i, :, :s] = kk
        cache["v"][i, :, :s] = vv
    cache["pos"] = s
    # RMSNorm is per token: normalising the last one alone is the same
    return cache, _logits(model, x[:, -1])


def decode_step(model: Transformer, cache: Dict[str, Any], tokens, *,
                attention: Attention = flash_attention):
    """One decode step: ``tokens [B]`` -> ``(logits [B, V] float32,
    cache)``.  Writes the new k / v into ``cache["k"]`` / ``cache["v"]`` at
    ``cache["pos"]`` in place and returns a new dict holding the same
    tensors and ``pos + 1``."""
    cfg = model.cfg
    tokens = _tokens(model, tokens)
    pos = int(cache["pos"])
    ck_all, cv_all = cache["k"], cache["v"]
    if pos >= ck_all.shape[2]:
        raise ValueError(f"the cache's {ck_all.shape[2]} slots are full")
    x = model.embed[tokens][:, None, :]
    positions = torch.full((1,), pos, device=model.device)
    cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim, x.dtype)
    for i in range(cfg.n_layers):
        x, _, _ = _layer(model.layer(i), x, cos, sin, cfg,
                         cache=(ck_all[i], cv_all[i]), pos=pos,
                         attention=attention)
    return _logits(model, x[:, 0]), {"k": ck_all, "v": cv_all,
                                     "pos": pos + 1}
