"""Wrapper of the MoE combine's backward (``csrc/segment_bwd.cu``).

``moe_combine_bwd(g, data, seg_ids, weights, rows, slot)`` returns
``(grad_w, grad_data)``, the gradients of the MoE combine, K5's gather
form ``out = segment_sum_sorted(data, seg_ids, n, weights=weights,
rows=rows)``, for ``g = dL/dout`` (``[n, D]`` float32): ``grad_w[e] =
<data[rows[e]], g[seg[e]]>`` in float32, and ``grad_data[r] =
w[slot[r]]·g[seg[slot[r]]]`` in data's dtype (0 where ``slot[r]`` is
outside ``[0, E)``).  It holds only under the MoE dispatch's contract:
each row of ``data`` is named by at most one slot that carries weight,
and ``slot`` (int64) is that inverse of ``rows`` (int64), the dispatch's
map of buffer rows to (token, slot) pairs; ``seg_ids`` are int32.  Every
other slot (a dropped one) names row -1: it reads no row, adds to none
and gets ``grad_w`` 0, as in the plain version.  That is the plain
version's ``index_add_`` over the slots, which no sort or atomic needs; a
segment sum whose rows repeat (an ``embedding_bag``) needs another
backward.  Only :func:`~repro_torch.kernels.segment.ops.
moe_combine` calls it.  For CPU tensors the wrapper runs the plain version
:func:`~repro_torch.kernels.segment.ref.segment_sum_bwd_ref`; for CUDA
tensors it launches the kernel or raises, and adds one to
``LAUNCHES["segment_sum_bf16_bwd"]`` (bfloat16 data) or
``LAUNCHES["segment_sum_bwd"]`` (float32) per launch, and one to
``COMBINE_BWD_ROUTES`` under the body that ran, as ``csrc/segment_bwd.cu``
picks it: ``stream`` (one token-major pass over the slots that reads each
token's gradient once, and the rows no slot owns zeroed in the same
launch) where ``D`` is a multiple of ``16 / itemsize`` and data, g and
the output are 16-byte aligned, ``warp_row`` (a warp an output row) for
every other shape.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import segment_sum_bwd_ref

__all__ = ["moe_combine_bwd", "COMBINE_BWD_ROUTES"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches by the body that ran them
COMBINE_BWD_ROUTES = {"stream": 0, "warp_row": 0}


def _lib() -> ctypes.CDLL:
    lib = library("segment_bwd")
    if lib.moe_combine_bwd.argtypes is None:
        for entry in (lib.moe_combine_bwd, lib.moe_combine_bwd_warp_row):
            entry.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                              _I, _I, _P]
            entry.restype = _I
    return lib


def moe_combine_bwd(g: torch.Tensor, data: torch.Tensor,
                    seg_ids: torch.Tensor, weights: torch.Tensor,
                    rows: torch.Tensor, slot: torch.Tensor):
    """The combine's backward; ``data [R, D]``, ``seg_ids`` (int32) /
    ``weights`` / ``rows`` (int64) ``[E]``, ``slot [R]`` (int64), ``g [n,
    D]`` float32."""
    if data.device.type == "cpu":
        return segment_sum_bwd_ref(g, data, seg_ids, weights, rows)
    grads, vec = _launch("moe_combine_bwd", g, data, seg_ids, weights, rows,
                         slot)
    LAUNCHES["segment_sum_bf16_bwd" if data.dtype == torch.bfloat16
             else "segment_sum_bwd"] += 1
    COMBINE_BWD_ROUTES["stream" if vec > 1 else "warp_row"] += 1
    return grads


def _moe_combine_bwd_warp_row(g, data, seg_ids, weights, rows, slot):
    """The same function on the ``warp_row`` body whatever the shape,
    counted nowhere: for timing the body that ``stream`` replaced beside
    it, and holding the two to each other's bits."""
    if data.device.type != "cuda":
        raise ValueError("the warp_row body runs on the card")
    return _launch("moe_combine_bwd_warp_row", g, data, seg_ids, weights,
                   rows, slot)[0]


def _launch(entry: str, g, data, seg_ids, weights, rows, slot):
    """The library's ``entry`` on CUDA operands; returns ``((grad_w,
    grad_data), vec)``."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if data.dtype not in _DTYPES or data.dim() != 2:
        raise ValueError(f"data: expected float32 or bfloat16 [R, D], got "
                         f"{data.dtype} {tuple(data.shape)}")
    n_rows, d = data.shape
    e = seg_ids.shape[0]
    for name, t, n, dt in (("seg_ids", seg_ids, e, torch.int32),
                           ("rows", rows, e, torch.int64),
                           ("slot", slot, n_rows, torch.int64)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: expected {dt} [{n}] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (weights.device != dev or weights.dtype != torch.float32
            or tuple(weights.shape) != (e,)):
        raise ValueError(f"weights: expected float32 [{e}] on {dev}")
    if g.device != dev or g.dtype != torch.float32 or g.dim() != 2 or (
            g.shape[1] != d):
        raise ValueError(f"g: expected float32 [n, {d}] on {dev}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    data, g, weights = data.contiguous(), g.contiguous(), weights.contiguous()
    seg_ids, rows, slot = (t.contiguous() for t in (seg_ids, rows, slot))
    grad_w = torch.empty((e,), dtype=torch.float32, device=dev)
    grad_data = torch.empty_like(data)
    vec = 16 // data.element_size()
    if d % vec or any(t.data_ptr() % 16 for t in (data, g, grad_data)):
        vec = 1
    lib = _lib()
    err = getattr(lib, entry)(
        data.data_ptr(), _DTYPES[data.dtype], g.data_ptr(), weights.data_ptr(),
        rows.data_ptr(), seg_ids.data_ptr(), slot.data_ptr(),
        grad_w.data_ptr(), grad_data.data_ptr(), e, n_rows, d, vec,
        stream_handle(dev))
    check(lib, err, entry)
    return (grad_w, grad_data), vec
