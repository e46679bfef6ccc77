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
without reading them.  ``Sq <= 64`` (decode) runs K6's decode kernel,
one CTA per (split, kv head, batch row, chunk of query rows): the wrapper
splits the key tiles over :func:`split_count` CTAs per chunk, and the last
split to arrive combines them all inside the same launch, in split order
(there is no combine kernel).  For CPU tensors the wrapper runs the plain
version :func:`~repro_torch.kernels.attention.ref.attention_plain`; for
CUDA tensors it launches K6 or raises, adds one to
``LAUNCHES["flash_attention"]`` per launch, prefill or decode, adds the
split count each decode launch ran with to ``SPLITS["flash_attention"]``
and counts each prefill launch (``Sq > 64``) in ``ROUTES`` under the
kernel that ran it, as ``csrc/attention.cu`` picks it
(:func:`prefill_route`): ``wgmma`` (``flash_prefill_wgmma_kernel``, bf16
at Dh 64 and 128), ``mma_sync`` (bf16 at Dh 16 and 32) or ``fma``
(float32).  Every route takes strides below 2**40 bytes and extents below
2**31 (the wgmma route's TMA maps and 32-bit coordinates): the wrapper
refuses the rest on any device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import attention_plain

__all__ = ["flash_attention_kernel", "split_count", "decode_geometry",
           "prefill_route", "SPLITS", "ROUTES", "HEAD_DIMS", "DTYPES"]

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CTAS_PER_SM = 1  # one decode CTA per SM (128 KB of cp.async ring at Dh 64)
MIN_TILES = 4  # tiles a split walks at least: enough to fill its ring
# split CTAs per (batch row, kv head, row chunk), summed over decode launches
SPLITS = {"flash_attention": 0}
# prefill launches by the kernel that ran them; csrc/attention.cu's route
# codes index _ROUTE_NAMES
ROUTES = {"wgmma": 0, "mma_sync": 0, "fma": 0}
_ROUTE_NAMES = ("fma", "mma_sync", "wgmma")


def _lib() -> ctypes.CDLL:
    lib = library("attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, ctypes.c_float, _P,
                                        _I, _P, _P]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_decode_geometry.argtypes = [_I, _I, _P]
        lib.flash_decode_geometry.restype = ctypes.c_int
        lib.flash_prefill_route.argtypes = [_I, _I, _P]
        lib.flash_prefill_route.restype = ctypes.c_int
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if max(t.shape) >= 2**31:
            raise ValueError(f"{name} {tuple(t.shape)}: K6 takes extents "
                             "below 2**31")
        if any(t.stride(i) * t.element_size() >= 2**40 for i in range(3)
               if t.shape[i] > 1):
            raise ValueError(f"{name}: strides {t.stride()} reach 2**40 "
                             "bytes, past what a TMA map takes")


def split_count(b: int, hq: int, hkv: int, sq: int, kv_len: int, n_sm: int,
                geometry: tuple) -> int:
    """Decode CTAs that share one (batch row, kv head, row chunk)'s key
    tiles, for the decode kernel's ``geometry`` (its largest Sq, query rows
    a CTA and keys a tile: :func:`decode_geometry`): 1 in prefill; else as
    many as keep all of the ``b * hkv * chunks`` CTAs of the launch
    resident at once (``CTAS_PER_SM`` per SM, one wave), with ``MIN_TILES``
    tiles or more per split, and at least 1."""
    max_sq, rows, tile = geometry
    if sq > max_sq:
        return 1
    ctas = b * hkv * -(-sq * (hq // hkv) // rows)
    return max(1, min(CTAS_PER_SM * n_sm // ctas,
                      -(-kv_len // tile) // MIN_TILES))


@functools.lru_cache(maxsize=None)
def decode_geometry(dtype: torch.dtype, dh: int) -> tuple:
    """(largest Sq, query rows a CTA, keys a tile) of K6's decode kernel for
    ``dtype`` and head dim ``dh``, as ``csrc/attention.cu`` reports them
    (builds the kernel library)."""
    lib = _lib()
    out = (ctypes.c_int * 3)()
    check(lib, lib.flash_decode_geometry(DTYPES[dtype], dh, out),
          "flash_decode_geometry")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def prefill_route(dtype: torch.dtype, dh: int) -> str:
    """The ``ROUTES`` key of the kernel that runs a prefill (``Sq > 64``)
    of ``dtype`` at head dim ``dh``, as ``csrc/attention.cu`` reports it
    (builds the kernel library)."""
    lib = _lib()
    out = ctypes.c_int()
    check(lib, lib.flash_prefill_route(DTYPES[dtype], dh, ctypes.byref(out)),
          "flash_prefill_route")
    return _ROUTE_NAMES[out.value]


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
    geometry = decode_geometry(q.dtype, dh)
    n_split = split_count(b, hq, hkv, sq, kv_len, _sm_count(q.device),
                          geometry)
    part = None
    if n_split > 1:  # each split's acc, m and l, then the arrival counters
        chunks = -(-sq * (hq // hkv) // geometry[1])
        part = torch.empty(n_split * b * hq * sq * (dh + 2) + b * hkv * chunks,
                           dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], dh, b, hq, hkv, sq, sk, kv_len, int(causal),
        1.0 / math.sqrt(dh), strides, n_split,
        None if part is None else part.data_ptr(), stream_handle(q.device))
    check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if sq <= geometry[0]:
        SPLITS["flash_attention"] += n_split
    else:
        ROUTES[prefill_route(q.dtype, dh)] += 1
    return out
