"""Wrapper of the sorted segment-sum kernel K5 (``csrc/segment_sum.cu``).

``segment_sum_kernel(data, seg_ids, n)[s] = Σ_{e: seg[e] = s} w[e]·data[r(e)]``
for ids sorted ascending, ``data [*, D]`` float32 and optional per-row
weights ``w [E]``; ``r(e) = e`` (the contiguous form) or ``rows[e]`` (the
gather form: ``rows = src`` and ``data = h`` is one GIN aggregation with
no ``[E, D]`` message buffer).  Segments that receive nothing are 0; ids
outside ``[0, n)`` (the ``2**30`` sentinel of :func:`pad_sorted_edges`)
contribute nothing.  Replaces
``repro.kernels.segment.kernel.segment_sum_tiles`` and the stage-2
epilogue of ``segment_sum_sorted``.

K5 splits the sorted rows into chunks of ``chunk`` rows, one CTA each,
whatever the segments' lengths.  :func:`chunk_plan` gives each chunk its
first segment from the row ranges ``ptr`` (:func:`row_ranges`), both by
binary search on the ids' device; a caller that reduces the same ids
many times (GIN's layers) builds both once and passes them.  The partial
sums of segments that cross a chunk boundary are added in chunk order
by a second kernel, counted under ``LAUNCHES["segment_sum_carry"]``.
For CPU tensors the wrapper runs the plain version
:func:`segment_sum_ref`; for CUDA tensors it launches K5 or raises, and
adds one to ``LAUNCHES["segment_sum"]`` per launch and to
``FORMS["gather"]`` or ``FORMS["contiguous"]`` by the form it ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import segment_sum_ref

__all__ = ["CHUNK_ROWS", "FORMS", "row_ranges", "chunk_plan",
           "segment_sum_kernel"]

# sorted rows a CTA: kChunk of csrc/segment_sum.cu, which refuses a plan
# made for another size
CHUNK_ROWS = 1024
FORMS = {"contiguous": 0, "gather": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


def row_ranges(seg_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``ptr [n+1]`` int64: the rows of segment ``s`` of the sorted ids are
    ``ptr[s] .. ptr[s+1]``; ids below 0 or from ``n`` on fall outside
    ``ptr[0] .. ptr[n]``."""
    bounds = torch.arange(n_segments + 1, dtype=seg_ids.dtype,
                          device=seg_ids.device)
    return torch.searchsorted(seg_ids, bounds)


def chunk_plan(ptr: torch.Tensor, n_rows: int,
               chunk: int = CHUNK_ROWS) -> torch.Tensor:
    """K5's work plan: ``plan [ceil(n_rows / chunk) + 1]`` int32, where
    chunk ``c`` holds rows ``c·chunk .. min((c+1)·chunk, n_rows)`` and
    ``plan[c]`` is the segment of its first row (-1 before ``ptr[0]``,
    ``n`` from ``ptr[n]`` on); ``plan[-1] = n``."""
    n = ptr.numel() - 1
    starts = torch.arange(0, n_rows, chunk, dtype=ptr.dtype,
                          device=ptr.device)
    first = torch.searchsorted(ptr, starts, right=True) - 1
    return torch.cat([first, first.new_full((1,), n)]).to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = library("segment_sum")
    if lib.segment_sum.argtypes is None:
        lib.segment_sum.argtypes = ([_P] * 4 + [_I] + [_P] * 4
                                    + [_I64] * 3 + [_I] * 4 + [_P])
        lib.segment_sum.restype = _I
        lib.segment_sum_carry.argtypes = ([_P] * 4 + [_I64] * 2 + [_I] * 4
                                          + [_P])
        lib.segment_sum_carry.restype = _I
    return lib


def _check(name, t, dtypes, shape, device):
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtypes} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def segment_sum_kernel(data: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int,
                       weights: Optional[torch.Tensor] = None,
                       ptr: Optional[torch.Tensor] = None,
                       rows: Optional[torch.Tensor] = None,
                       plan: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K5 over ``data`` by sorted ``seg_ids [E]`` (rows ``rows [E]`` of
    ``data`` if given, else ``data [E, D]`` itself); returns
    ``[n_segments, D]``.  ``ptr`` is ``row_ranges(seg_ids, n_segments)``
    and ``plan`` is ``chunk_plan(ptr, E)`` when the caller has them
    already."""
    if data.device.type == "cpu":
        return segment_sum_ref(data, seg_ids, n_segments, weights, rows)
    if data.device.type != "cuda":
        raise ValueError(f"no kernel for device {data.device}")
    if data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError(f"data: expected float32 [*, D], got {data.dtype} "
                         f"{tuple(data.shape)}")
    dev = data.device
    n_data, d = data.shape
    e = seg_ids.shape[0] if seg_ids.dim() == 1 else -1
    if rows is not None:
        _check("rows", rows, (torch.int32, torch.int64), (e,), dev)
    elif n_data != e:
        raise ValueError(f"seg_ids: expected [{n_data}] for data "
                         f"{tuple(data.shape)}, got {tuple(seg_ids.shape)}")
    _check("seg_ids", seg_ids, (torch.int32, torch.int64), (e,), dev)
    _check("data", data, (torch.float32,), (n_data, d), dev)
    if weights is not None:
        _check("weights", weights, (torch.float32,), (e,), dev)
    if ptr is None:
        ptr = row_ranges(seg_ids, n_segments)
    _check("ptr", ptr, (torch.int64,), (n_segments + 1,), dev)
    chunk = CHUNK_ROWS
    n_chunks = -(-e // chunk)
    if plan is None:
        plan = chunk_plan(ptr, e, chunk)
    _check("plan", plan, (torch.int32,), (n_chunks + 1,), dev)
    if n_segments == 0 or d == 0 or e == 0:
        return torch.zeros((n_segments, d), dtype=torch.float32, device=dev)
    if seg_ids.dtype == torch.int64:  # the kernel reads int32 ids
        seg_ids = seg_ids.clamp(-1, n_segments).to(torch.int32)
    vec = next(v for v in (4, 2, 1)
               if d % v == 0 and data.data_ptr() % (4 * v) == 0)
    units = d // vec
    lanes = min(32, 1 << (units - 1).bit_length())
    out = torch.empty((n_segments, d), dtype=torch.float32, device=dev)
    carry = torch.empty((n_chunks, d), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = stream_handle(dev)
    err = lib.segment_sum(
        ptr.data_ptr(), plan.data_ptr(), seg_ids.data_ptr(),
        None if rows is None else rows.data_ptr(),
        0 if rows is None else rows.element_size(), data.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        carry.data_ptr(), n_segments, e, n_data, d, vec, chunk, lanes, stream)
    check(lib, err, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    FORMS["contiguous" if rows is None else "gather"] += 1
    if n_chunks > 1:
        err = lib.segment_sum_carry(ptr.data_ptr(), plan.data_ptr(),
                                    out.data_ptr(), carry.data_ptr(),
                                    n_segments, e, d, vec, chunk, lanes,
                                    stream)
        check(lib, err, "segment_sum_carry")
        LAUNCHES["segment_sum_carry"] += 1
    return out
