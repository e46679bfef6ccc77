"""Wrapper of K6's backward (``csrc/attention_bwd.cu``).

``flash_attention_bwd(q, k, v, o, do, causal=...)`` returns ``(dq, dk,
dv)``, the gradients of K6's ``o = flash_attention(q, k, v,
causal=causal)`` for ``do = dL/do``: q, o, do ``[B, Hq, Sq, Dh]`` and k, v
``[B, Hkv, Sk, Dh]``, any strided views whose last dimension is
contiguous, float32 or bfloat16, ``Dh`` in {16, 32, 64, 128}, ``Hq`` a
multiple of ``Hkv``, causal top-left as K6's forward (no ``kv_len``).  dq
is laid out ``[B, Sq, Hq, Dh]`` and dk / dv ``[B, Sk, Hkv, Dh]`` in
memory, so that the model's ``transpose(1, 2)`` back to its own layout is
contiguous.  The kernel writes each row's logsumexp and ``rowsum(do · o)``
to a float32 scratch the wrapper allocates, then reads them back in a
second kernel: two launches a call, counted once, under
``LAUNCHES["flash_attention_bwd"]``.  For CPU tensors the wrapper runs the
plain version :func:`~repro_torch.kernels.attention.ref.attention_bwd_plain`;
for CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .kernel import DTYPES, _check, _strides
from .ref import attention_bwd_plain

__all__ = ["flash_attention_bwd", "bwd_block"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = library("attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        lib.flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 8 + [
            ctypes.c_float, _P, _P]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_block.argtypes = []
        lib.flash_attention_bwd_block.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_block() -> int:
    """Rows of a CTA's block in ``csrc/attention_bwd.cu``: the scratch
    holds that multiple of Sq a (batch row, q head) (builds the kernel
    library)."""
    return _lib().flash_attention_bwd_block()


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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool):
    """K6's backward; returns ``(dq, dk, dv)`` in the inputs' dtype."""
    _check(q, k, v, None)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} does not "
                             f"match q {q.dtype} {tuple(q.shape)}")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, do, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or (
            v.device != q.device):
        raise ValueError(f"no kernel for devices {q.device}, {k.device}, "
                         f"{v.device}")
    if not _aligned(do):  # the gradient as autograd hands it over
        do = do.contiguous()
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dq = _like(q.shape, q.dtype, q.device)
    dk = _like(k.shape, k.dtype, k.device)
    dv = _like(v.shape, v.dtype, v.device)
    ld = -(-sq // bwd_block()) * bwd_block()
    lse = torch.empty((b, hq, ld), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    st = []
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("dq", dq), ("dk", dk), ("dv", dv)):
        st += _strides(t, name)
    strides = (ctypes.c_int64 * len(st))(*st)
    lib = _lib()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), DTYPES[q.dtype], dh, b, hq, hkv, sq, sk,
        int(causal), 1.0 / math.sqrt(dh), strides, stream_handle(q.device))
    check(lib, err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
