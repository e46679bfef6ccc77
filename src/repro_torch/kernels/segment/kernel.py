"""Wrapper of the sorted segment-sum kernel K5 (``csrc/segment_sum.cu``).

``segment_sum_kernel(data, seg_ids, n)[s] = Σ_{e: seg[e] = s} w[e]·data[e]``
for ids sorted ascending, ``data [E, D]`` float32 and optional per-row
weights ``w [E]``.  Segments that receive nothing are 0; ids outside
``[0, n)`` (the ``2**30`` sentinel of :func:`pad_sorted_edges`) contribute
nothing.  Replaces ``repro.kernels.segment.kernel.segment_sum_tiles`` and
the stage-2 epilogue of ``segment_sum_sorted``.

K5 reads each segment's rows from a range ``ptr[s] .. ptr[s+1]`` of the
sorted rows.  :func:`row_ranges` builds it from the ids with a binary
search on the ids' device; a caller that reduces the same ids many times
(GIN's layers) builds it once and passes it.  For CPU tensors the
wrapper runs the plain version :func:`segment_sum_ref` on the ids; for
CUDA tensors it launches K5 or raises, and adds one to
``LAUNCHES["segment_sum"]`` per launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import segment_sum_ref

__all__ = ["row_ranges", "segment_sum_kernel"]

_P = ctypes.c_void_p


def row_ranges(seg_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``ptr [n+1]`` int64: the rows of segment ``s`` of the sorted ids are
    ``ptr[s] .. ptr[s+1]``; ids below 0 or from ``n`` on fall outside
    ``ptr[0] .. ptr[n]``."""
    bounds = torch.arange(n_segments + 1, dtype=seg_ids.dtype,
                          device=seg_ids.device)
    return torch.searchsorted(seg_ids, bounds)


def _lib() -> ctypes.CDLL:
    lib = library("segment_sum")
    if lib.segment_sum.argtypes is None:
        lib.segment_sum.argtypes = [_P] * 4 + [ctypes.c_int64, ctypes.c_int,
                                               _P]
        lib.segment_sum.restype = ctypes.c_int
    return lib


def segment_sum_kernel(data: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int,
                       weights: Optional[torch.Tensor] = None,
                       ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 over ``data [E, D]`` by sorted ``seg_ids [E]``; returns
    ``[n_segments, D]``.  ``ptr`` is ``row_ranges(seg_ids, n_segments)``
    when the caller has it already."""
    if data.device.type == "cpu":
        return segment_sum_ref(data, seg_ids, n_segments, weights)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    if data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError(f"data: expected float32 [E, D], got {data.dtype} "
                         f"{tuple(data.shape)}")
    e, d = data.shape
    if ptr is None:
        ptr = row_ranges(seg_ids, n_segments)
    checks = [("seg_ids", seg_ids, (torch.int32, torch.int64), (e,)),
              ("ptr", ptr, (torch.int64,), (n_segments + 1,))]
    if weights is not None:
        checks.append(("weights", weights, (torch.float32,), (e,)))
    for name, t, dtypes, shape in checks:
        if t.device != data.device or t.dtype not in dtypes or (
                tuple(t.shape) != shape):
            raise ValueError(
                f"{name}: expected {dtypes} {shape} on {data.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("data", data), ("ptr", ptr), ("weights", weights)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((n_segments, d), dtype=torch.float32,
                      device=data.device)
    lib = _lib()
    err = lib.segment_sum(ptr.data_ptr(), data.data_ptr(),
                          None if weights is None else weights.data_ptr(),
                          out.data_ptr(), n_segments, d,
                          stream_handle(data.device))
    check(lib, err, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out
