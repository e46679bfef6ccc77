"""Wrapper of K6's backward (``csrc/attention_bwd.cu``).

``flash_attention_bwd(q, k, v, o, do, causal=..., lse=...)`` returns
``(dq, dk, dv)``, the gradients of K6's ``o = flash_attention(q, k, v,
causal=causal)`` for ``do = dL/do``: q, o, do ``[B, Hq, Sq, Dh]`` and k, v
``[B, Hkv, Sk, Dh]``, any strided views whose last dimension is
contiguous, float32 or bfloat16, ``Dh`` in {16, 32, 64, 128}, ``Hq`` a
multiple of ``Hkv``, causal top-left as K6's forward (no ``kv_len``).  dq
is laid out ``[B, Sq, Hq, Dh]`` and dk / dv ``[B, Sk, Hkv, Dh]`` in
memory, so that the model's ``transpose(1, 2)`` back to its own layout is
contiguous.  A dQ kernel, then a dK / dV kernel: two launches a call,
counted once, under ``LAUNCHES["flash_attention_bwd"]`` and under the
route that ran them in ``BWD_ROUTES``, as ``csrc/attention_bwd.cu`` picks
it (:func:`bwd_route`):

* ``wgmma`` (bf16 at Dh 64 and 128 with Sq > 64, wherever K6's forward
  ran ``flash_prefill_wgmma_kernel``): the pair on wgmma and TMA, which
  reads each row's logsumexp from ``lse``, the float32 ``[B, Hq, ld]``
  scratch that the training forward
  (:func:`~repro_torch.kernels.attention.kernel.flash_attention_lse`)
  wrote; it is required here;
* ``mma_sync`` (bf16 otherwise) and ``fma`` (float32): the dQ kernel
  rebuilds the logsumexp in a first walk over its key tiles; ``lse`` must
  be None.

Either way the dQ kernel writes ``rowsum(do · o)`` to a scratch the dK /
dV kernel reads.  For CPU tensors the wrapper runs the plain version
:func:`~repro_torch.kernels.attention.ref.attention_bwd_plain` (``lse`` is
not read); for CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .kernel import DTYPES, _check, _strides
from .ref import attention_bwd_plain

__all__ = ["flash_attention_bwd", "bwd_block", "bwd_route", "lse_rows",
           "BWD_ROUTES"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# backward launches by the pair that ran them; csrc/attention_bwd.cu's
# route codes index _ROUTE_NAMES
BWD_ROUTES = {"wgmma": 0, "mma_sync": 0, "fma": 0}
_ROUTE_NAMES = ("fma", "mma_sync", "wgmma")
_ENTRY_ARGS = [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P, _P]


def _lib() -> ctypes.CDLL:
    lib = library("attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        for entry in (lib.flash_attention_bwd,
                      lib.flash_attention_bwd_mma_sync):
            entry.argtypes = _ENTRY_ARGS
            entry.restype = ctypes.c_int
        lib.flash_attention_bwd_block.argtypes = []
        lib.flash_attention_bwd_block.restype = ctypes.c_int
        lib.flash_attention_bwd_route.argtypes = [_I, _I, _I, _P]
        lib.flash_attention_bwd_route.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_block() -> int:
    """Rows that ``csrc/attention_bwd.cu``'s scratch rounds Sq up to: it
    holds that multiple of Sq a (batch row, q head) (builds the kernel
    library)."""
    return _lib().flash_attention_bwd_block()


def lse_rows(sq: int) -> int:
    """``ld``, the rows a (batch row, q head) of the ``[B, Hq, ld]``
    logsumexp scratch: Sq rounded up to :func:`bwd_block`."""
    return -(-sq // bwd_block()) * bwd_block()


@functools.lru_cache(maxsize=None)
def bwd_route(dtype: torch.dtype, dh: int, sq: int) -> str:
    """The ``BWD_ROUTES`` key of the pair that runs a backward of
    ``dtype`` at head dim ``dh`` over ``sq`` query rows, as
    ``csrc/attention_bwd.cu`` reports it (builds the kernel library)."""
    lib = _lib()
    out = ctypes.c_int()
    check(lib, lib.flash_attention_bwd_route(DTYPES[dtype], dh, sq,
                                             ctypes.byref(out)),
          "flash_attention_bwd_route")
    return _ROUTE_NAMES[out.value]


def _aligned(t: torch.Tensor) -> bool:
    per16 = 16 // t.element_size()
    st = t.stride()
    return (st[3] == 1 and t.data_ptr() % 16 == 0
            and all(st[i] % per16 == 0 for i in range(3) if t.shape[i] > 1))


def _like(shape, dtype, device) -> torch.Tensor:
    """``[B, H, S, Dh]`` laid out ``[B, S, H, Dh]``."""
    b, h, s, dh = shape
    return torch.empty((b, s, h, dh), dtype=dtype,
                       device=device).transpose(1, 2)


def _check_bwd(q, k, v, o, do):
    _check(q, k, v, None)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} does not "
                             f"match q {q.dtype} {tuple(q.shape)}")
    if q.device.type != "cpu" and (q.device.type != "cuda"
                                   or k.device != q.device
                                   or v.device != q.device):
        raise ValueError(f"no kernel for devices {q.device}, {k.device}, "
                         f"{v.device}")


def _launch(entry: str, q, k, v, o, do, causal: bool, lse):
    """The library's ``entry`` on CUDA operands; ``lse`` the forward's
    logsumexp scratch, or None for one that the kernels fill."""
    if not _aligned(do):  # the gradient as autograd hands it over
        do = do.contiguous()
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = _like(q.shape, q.dtype, q.device)
    dk = _like(k.shape, k.dtype, k.device)
    dv = _like(v.shape, v.dtype, v.device)
    if lse is None:
        lse = torch.empty((b, hq, lse_rows(sq)), dtype=torch.float32,
                          device=q.device)
    delta = torch.empty_like(lse)
    st = []
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("dq", dq), ("dk", dk), ("dv", dv)):
        st += _strides(t, name)
    strides = (ctypes.c_int64 * len(st))(*st)
    lib = _lib()
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), DTYPES[q.dtype], dh, b, hq, hkv, sq, sk,
        int(causal), 1.0 / math.sqrt(dh), strides, stream_handle(q.device))
    check(lib, err, entry)
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                        lse: Optional[torch.Tensor] = None):
    """K6's backward; returns ``(dq, dk, dv)`` in the inputs' dtype.
    ``lse``: the training forward's logsumexp scratch, which the
    ``wgmma`` route reads (required there, refused on the others)."""
    _check_bwd(q, k, v, o, do)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, do, causal=causal)
    b, hq, sq, dh = q.shape
    route = bwd_route(q.dtype, dh, sq)
    if route == "wgmma":
        want = (b, hq, lse_rows(sq))
        if (lse is None or tuple(lse.shape) != want
                or lse.dtype != torch.float32 or lse.device != q.device
                or not lse.is_contiguous()):
            got = None if lse is None else (lse.dtype, tuple(lse.shape))
            raise ValueError(
                "the wgmma backward reads the forward's logsumexp: pass "
                f"lse, contiguous float32 {want} on {q.device}, from "
                f"flash_attention_lse (got {got})")
    elif lse is not None:
        raise ValueError(f"the {route} backward rebuilds the logsumexp: lse "
                         "must be None")
    grads = _launch("flash_attention_bwd", q, k, v, o, do, causal, lse)
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_ROUTES[route] += 1
    return grads


def _flash_attention_bwd_mma_sync(q, k, v, o, do, *, causal: bool):
    """The ``mma_sync`` pair on bf16 CUDA operands whatever the route (it
    rebuilds the logsumexp), counted nowhere: for timing the pair that the
    ``wgmma`` route replaced beside it."""
    _check_bwd(q, k, v, o, do)
    if q.dtype != torch.bfloat16 or q.device.type != "cuda":
        raise ValueError("the mma.sync pair takes bf16 operands on the card")
    return _launch("flash_attention_bwd_mma_sync", q, k, v, o, do, causal,
                   None)
