"""Wrapper of the flash-attention kernel K6 (``csrc/attention.cu``).

``flash_attention_kernel(q, k, v, causal=..., kv_len=..., out=...)``
takes q ``[B, Hq, Sq, Dh]`` and k / v ``[B, Hkv, Sk, Dh]`` as any strided
views whose last dimension is contiguous (the model hands it
``transpose(1, 2)`` views of its ``[B, S, H, Dh]`` activations and cache
without a copy), in float32 or bfloat16, with ``Dh`` in {16, 32, 64, 128}
and ``Hq`` a multiple of ``Hkv``.  Replaces
``repro.kernels.attention.kernel.flash_attention_pallas``; unlike it, any
``Sq`` and ``Sk`` are taken (K6 masks its ragged tiles) and ``kv_len``
masks the keys at index ``>= kv_len`` (decode over a partly filled cache)
without reading them.  When one query block's (batch, head) pairs would
leave the card's SMs idle (decode), the wrapper splits the key tiles over
:func:`split_count` CTAs per row and K6 combines the splits in a second
launch, in a fixed order.  For CPU tensors the wrapper runs the plain version
:func:`~repro_torch.kernels.attention.ref.attention_plain`; for CUDA
tensors it launches K6 or raises, and adds one to
``LAUNCHES["flash_attention"]`` per launch of the attention kernel and one
to ``LAUNCHES["flash_attention_combine"]`` per launch of the combine kernel
(a split call launches both).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import attention_plain

__all__ = ["flash_attention_kernel", "split_count", "HEAD_DIMS", "DTYPES"]

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 64  # K6's query rows per CTA and keys per tile
CTAS_PER_SM = 4  # the split-KV target: enough CTAs to cover the load latency


def _lib() -> ctypes.CDLL:
    lib = library("attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, ctypes.c_float, _P,
                                        _I, _P, _P]
        lib.flash_attention.restype = ctypes.c_int
    return lib


def _check(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B, Hq, Sq, Dh] and k, v [B, Hkv, Sk, "
                         f"Dh], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1]:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, Dh, Hq % Hkv == 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: K6 takes "
                         "float32 or bfloat16, the same for q, k and v")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: K6 takes {HEAD_DIMS}")
    if kv_len is not None and not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[2]}]")


def split_count(b: int, hq: int, sq: int, kv_len: int, n_sm: int) -> int:
    """CTAs that share one query block's key tiles: 1 unless ``sq`` fits
    one block and the ``b * hq`` blocks would leave SMs idle; then enough
    for about ``CTAS_PER_SM`` CTAs per SM, each walking 4 tiles or more."""
    if sq > BLOCK:
        return 1
    tiles = -(-kv_len // BLOCK)
    want = -(-CTAS_PER_SM * n_sm // (b * hq))
    return max(1, min(want, -(-tiles // 4)))


def _strides(t: torch.Tensor, name: str):
    """(b, h, s) element strides of a 4-D view; raises unless Dh is
    contiguous and every used stride and the base are 16-byte aligned."""
    per16 = 16 // t.element_size()
    st = t.stride()
    if t.shape[3] > 1 and st[3] != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if t.data_ptr() % 16 or any(st[i] % per16 for i in range(3)
                                if t.shape[i] > 1):
        raise ValueError(f"{name}: base and strides {st} must be 16-byte "
                         "aligned")
    return st[:3]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, kv_len: Optional[int] = None,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K6; returns ``out`` (allocated ``[B, Hq, Sq, Dh]`` when None)."""
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        res = attention_plain(q, k, v, causal=causal, kv_len=kv_len)
        return res if out is None else out.copy_(res)
    if q.device.type != "cuda" or k.device != q.device or (
            v.device != q.device):
        raise ValueError(f"no kernel for devices {q.device}, {k.device}, "
                         f"{v.device}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif (out.shape != q.shape or out.dtype != q.dtype
          or out.device != q.device):
        raise ValueError(f"out {out.dtype} {tuple(out.shape)} does not match "
                         f"q {q.dtype} {tuple(q.shape)}")
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 12)(
        *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
        *_strides(out, "out"))
    kv_len = sk if kv_len is None else kv_len
    n_split = split_count(b, hq, sq, kv_len, _sm_count(q.device))
    part = None
    if n_split > 1:  # each split's acc, m and l, combined by K6 itself
        part = torch.empty(n_split * b * hq * sq * (dh + 2),
                           dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], dh, b, hq, hkv, sq, sk, kv_len, int(causal),
        1.0 / math.sqrt(dh), strides, n_split,
        None if part is None else part.data_ptr(), stream_handle(q.device))
    check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if n_split > 1:
        LAUNCHES["flash_attention_combine"] += 1
    return out
