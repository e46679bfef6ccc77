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

``flash_attention_lse(q, k, v, causal=...)`` is the training forward:
the same prefill on ``flash_prefill_wgmma_kernel``, in an instance that
also writes each query row's logsumexp, the ``L`` that K6's ``wgmma``
backward reads instead of rebuilding it (bf16 at Dh 64 and 128, Sq > 64:
the ``wgmma`` route of :func:`prefill_route` and of the backward's
``bwd_route``; it refuses anything else on the card).  Its launches count
under ``LAUNCHES["flash_attention"]`` and ``ROUTES["wgmma"]``; serving's
instance of the kernel does not write ``L``.

With ``k_scale`` / ``v_scale`` (float32 ``[B, Hkv, Sk]``, any strides) k
and v are an int8 cache with one scale a (row, head, token), the
reference's int8 KV cache: K6's int8 decode form (``Sq <= 64`` only)
streams the int8 tiles, half the bytes, and dequantises each element as
it loads it, as the reference does before it attends (``k · k_scale`` in
float32, rounded to q's dtype), so its result is the bits of K6's decode
over a dequantised copy, which is never made.  With the bytes halved the
instructions bound it next, so it makes each int8 a float with integer
and FP32 work (a byte under the exponent of ``2**23``, then ``2**23 +
128`` taken off: exact), rounds the products to bf16 two at a time,
never through the slow single conversions, and copies each warp's tiles
in 16-byte pieces shared by its lanes.  Its launches count under
``LAUNCHES["flash_attention_int8"]`` and its splits under
``SPLITS["flash_attention_int8"]``, not K6's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import attention_plain

__all__ = ["flash_attention_kernel", "flash_attention_lse", "split_count",
           "decode_geometry", "prefill_route", "SPLITS", "ROUTES",
           "HEAD_DIMS", "DTYPES"]

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT8_KV = 2  # added to q's dtype code for an int8 K/V cache
CTAS_PER_SM = 1  # one decode CTA per SM (128 KB of cp.async ring at Dh 64)
MIN_TILES = 4  # tiles a split walks at least: enough to fill its ring
# split CTAs per (batch row, kv head, row chunk), summed over decode launches
SPLITS = {"flash_attention": 0, "flash_attention_int8": 0}
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
        lib.flash_attention_int8.argtypes = [_P] * 6 + [_I] * 9 + [
            ctypes.c_float, _P, _I, _P, _P]
        lib.flash_attention_int8.restype = ctypes.c_int
        lib.flash_decode_geometry.argtypes = [_I, _I, _P]
        lib.flash_decode_geometry.restype = ctypes.c_int
        lib.flash_prefill_route.argtypes = [_I, _I, _P]
        lib.flash_prefill_route.restype = ctypes.c_int
        lib.flash_attention_lse.argtypes = [_P] * 5 + [_I] * 8 + [
            ctypes.c_float, _P, _I, _P]
        lib.flash_attention_lse.restype = ctypes.c_int
    return lib


def _check(q, k, v, kv_len, k_scale=None, v_scale=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B, Hq, Sq, Dh] and k, v [B, Hkv, Sk, "
                         f"Dh], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1]:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, Dh, Hq % Hkv == 0)")
    kv_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: K6 takes "
                         "float32 or bfloat16, the same for q, k and v, or "
                         "int8 k and v with their scales")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is not None:
        want = tuple(k.shape[:3])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name}: expected float32 {want}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
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
def decode_geometry(dtype: torch.dtype, dh: int, int8: bool = False) -> tuple:
    """(largest Sq, query rows a CTA, keys a tile) of K6's decode kernel for
    q's ``dtype`` and head dim ``dh`` (over an int8 K/V cache with
    ``int8``), as ``csrc/attention.cu`` reports them (builds the kernel
    library)."""
    lib = _lib()
    out = (ctypes.c_int * 3)()
    code = DTYPES[dtype] + (INT8_KV if int8 else 0)
    check(lib, lib.flash_decode_geometry(code, dh, out),
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


def _scale_strides(t: torch.Tensor, name: str):
    """(b, h, s) element strides of a float32 ``[B, Hkv, Sk]`` scale view
    on the card."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, not the card")
    return t.stride()


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, kv_len: Optional[int] = None,
                           out: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K6; returns ``out`` (allocated ``[B, Hq, Sq, Dh]`` when None).  With
    ``k_scale`` / ``v_scale`` its int8 decode form."""
    _check(q, k, v, kv_len, k_scale, v_scale)
    int8 = k_scale is not None
    if q.device.type == "cpu":
        res = attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                              k_scale=k_scale, v_scale=v_scale)
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
    st = [*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
          *_strides(out, "out")]
    kv_len = sk if kv_len is None else kv_len
    geometry = decode_geometry(q.dtype, dh, int8)
    if int8:
        if sq > geometry[0]:
            raise ValueError(f"Sq {sq}: K6's int8 form is a decode form "
                             f"(Sq <= {geometry[0]})")
        st += [*_scale_strides(k_scale, "k_scale"),
               *_scale_strides(v_scale, "v_scale")]
    strides = (ctypes.c_int64 * len(st))(*st)
    n_split = split_count(b, hq, hkv, sq, kv_len, _sm_count(q.device),
                          geometry)
    part = None
    if n_split > 1:  # each split's acc, m and l, then the arrival counters
        chunks = -(-sq * (hq // hkv) // geometry[1])
        part = torch.empty(n_split * b * hq * sq * (dh + 2) + b * hkv * chunks,
                           dtype=torch.float32, device=q.device)
    lib = _lib()
    part_ptr = None if part is None else part.data_ptr()
    if int8:
        err = lib.flash_attention_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(), DTYPES[q.dtype], dh, b, hq,
            hkv, sq, sk, kv_len, int(causal), 1.0 / math.sqrt(dh), strides,
            n_split, part_ptr, stream_handle(q.device))
        check(lib, err, "flash_attention_int8")
        LAUNCHES["flash_attention_int8"] += 1
        SPLITS["flash_attention_int8"] += n_split
        return out
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], dh, b, hq, hkv, sq, sk, kv_len, int(causal),
        1.0 / math.sqrt(dh), strides, n_split, part_ptr,
        stream_handle(q.device))
    check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if sq <= geometry[0]:
        SPLITS["flash_attention"] += n_split
    else:
        ROUTES[prefill_route(q.dtype, dh)] += 1
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool):
    """The training forward: ``(o, lse)``, o as :func:`flash_attention`
    lays it out (``[B, Hq, Sq, Dh]`` over ``[B, Sq, Hq, Dh]`` memory) and
    each query row's logsumexp in base 2 of the scores times
    ``scale · log2(e)``: on the card a float32 ``[B, Hq, ld]`` scratch
    (``ld`` = Sq rounded up to the backward's block) whose first Sq
    columns are written, on the CPU the plain version's ``[B, Hq, Sq]``."""
    _check(q, k, v, None)
    b, hq, sq, dh = q.shape
    if q.device.type == "cpu":
        o, lse = attention_plain(q, k, v, causal=causal, lse=True)
        out = torch.empty((b, sq, hq, dh), dtype=q.dtype).transpose(1, 2)
        return out.copy_(o), lse
    if q.device.type != "cuda" or k.device != q.device or (
            v.device != q.device):
        raise ValueError(f"no kernel for devices {q.device}, {k.device}, "
                         f"{v.device}")
    if (prefill_route(q.dtype, dh) != "wgmma"
            or sq <= decode_geometry(q.dtype, dh)[0]):
        raise ValueError(f"{q.dtype} at Dh {dh}, Sq {sq}: the forward that "
                         "writes the logsumexp is the wgmma prefill (bf16, "
                         "Dh 64 or 128, Sq > 64)")
    from .backward import lse_rows  # the backward imports this module

    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    ld = lse_rows(sq)
    lse = torch.empty((b, hq, ld), dtype=torch.float32, device=q.device)
    st = [*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
          *_strides(out, "out")]
    strides = (ctypes.c_int64 * len(st))(*st)
    lib = _lib()
    err = lib.flash_attention_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), DTYPES[q.dtype], dh, b, hq, hkv, sq, sk, int(causal),
        1.0 / math.sqrt(dh), strides, ld, stream_handle(q.device))
    check(lib, err, "flash_attention_lse")
    LAUNCHES["flash_attention"] += 1
    ROUTES["wgmma"] += 1
    return out, lse
