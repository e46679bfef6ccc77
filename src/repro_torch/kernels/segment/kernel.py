"""Wrapper of the sorted segment-sum kernel K5 (``csrc/segment_sum.cu``).

``segment_sum_kernel(data, seg_ids, n)[s] = Σ_{e: seg[e] = s} w[e]·data[r(e)]``
for ids sorted ascending, ``data [*, D]`` float32 or bfloat16 and
optional per-row float32 weights ``w [E]``; ``r(e) = e`` (the contiguous
form) or ``rows[e]`` (the gather form: ``rows = src`` and ``data = h`` is
one GIN aggregation with no ``[E, D]`` message buffer; ``rows = e·cap +
pos`` into the expert outputs ``[E_pad·cap, D]`` is the MoE combine).
bfloat16 rows (an even D) run K5's bf16-row form, which reads them as
they are, 16 bytes a lane, multiplies by the weight and sums in float32:
the output is float32 either way.  Segments that receive nothing are 0; ids
outside ``[0, n)`` (the ``2**30`` sentinel of :func:`pad_sorted_edges`)
contribute nothing.  Replaces
``repro.kernels.segment.kernel.segment_sum_tiles`` and the stage-2
epilogue of ``segment_sum_sorted``.

K5 splits the sorted rows into chunks of ``CHUNK_ROWS`` rows, one CTA
each, whatever the segments' lengths, and plans that work itself on the
card from the ids as they come (int32 or int64): a chunk's first segment
is its first row's id, and the chunk where a carried segment began is
the chunk before, or else found by a binary search over the ids.  So a
call makes no torch op but its output (and, past one chunk, the
carries' scratch): at the MoE decode combine, 32 rows into 8 tokens,
the host's work around the one launch is what a call costs.  The partial sums of segments that
cross a chunk boundary are added in chunk order by a second kernel,
counted under ``LAUNCHES["segment_sum_carry"]``.
For CPU tensors the wrapper runs the plain version
:func:`segment_sum_ref`; for CUDA tensors it launches K5 or raises, and
adds one to ``LAUNCHES["segment_sum"]`` per launch
(``LAUNCHES["segment_sum_bf16"]`` for bfloat16 rows) and to
``FORMS["gather"]`` or ``FORMS["contiguous"]`` by the form it ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import segment_sum_ref

__all__ = ["CHUNK_ROWS", "FORMS", "segment_sum_kernel"]

# sorted rows a CTA: kChunk of csrc/segment_sum.cu, which refuses another
# size
CHUNK_ROWS = 1024
FORMS = {"contiguous": 0, "gather": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = library("segment_sum")
    if lib.segment_sum.argtypes is None:
        for name in ("segment_sum", "segment_sum_bf16"):
            getattr(lib, name).argtypes = ([_P, _I, _P, _I] + [_P] * 4
                                           + [_I64] * 3 + [_I] * 4 + [_P])
            getattr(lib, name).restype = _I
        lib.segment_sum_carry.argtypes = ([_P, _I, _P, _P] + [_I64] * 2
                                          + [_I] * 4 + [_P])
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
                       rows: Optional[torch.Tensor] = None,
                       count: Optional[str] = None) -> torch.Tensor:
    """K5 over ``data`` by sorted ``seg_ids [E]`` (rows ``rows [E]`` of
    ``data`` if given, else ``data [E, D]`` itself); returns
    ``[n_segments, D]``.  ``count`` names the ``LAUNCHES`` entry the
    launch adds to in place of its form's (the MoE dispatch's backward
    counts its launches apart)."""
    dev = data.device
    if dev.type == "cpu":
        return segment_sum_ref(data, seg_ids, n_segments, weights, rows)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if data.dtype not in (torch.float32, torch.bfloat16) or data.dim() != 2:
        raise ValueError(f"data: expected float32 or bfloat16 [*, D], got "
                         f"{data.dtype} {tuple(data.shape)}")
    n_data, d = data.shape
    e = seg_ids.shape[0] if seg_ids.dim() == 1 else -1
    if rows is not None:
        _check("rows", rows, (torch.int32, torch.int64), (e,), dev)
    elif n_data != e:
        raise ValueError(f"seg_ids: expected [{n_data}] for data "
                         f"{tuple(data.shape)}, got {tuple(seg_ids.shape)}")
    _check("seg_ids", seg_ids, (torch.int32, torch.int64), (e,), dev)
    _check("data", data, (torch.float32, torch.bfloat16), (n_data, d), dev)
    if weights is not None:
        _check("weights", weights, (torch.float32,), (e,), dev)
    if n_segments == 0 or d == 0 or e == 0:
        return torch.zeros((n_segments, d), dtype=torch.float32, device=dev)
    bf16 = data.dtype == torch.bfloat16
    # elements a lane reads at once: the widest whose bytes (16, 8 or 4 in
    # bf16, where cp.async copies no 2 bytes) D and the base divide
    size = data.element_size()
    vec = next((v for v in ((8, 4, 2) if bf16 else (4, 2, 1))
                if d % v == 0 and data.data_ptr() % (size * v) == 0), None)
    if vec is None:
        raise ValueError(f"data: bfloat16 rows need an even D ({d}) and a "
                         "4-byte aligned base")
    units = d // vec
    lanes = min(32, 1 << (units - 1).bit_length())
    chunk = CHUNK_ROWS
    n_chunks = -(-e // chunk)
    out = torch.empty((n_segments, d), dtype=torch.float32, device=dev)
    carry = (torch.empty((n_chunks, d), dtype=torch.float32, device=dev)
             if n_chunks > 1 else None)
    lib = _lib()
    stream = stream_handle(dev)
    name = "segment_sum_bf16" if bf16 else "segment_sum"
    seg_p, seg_b = seg_ids.data_ptr(), seg_ids.element_size()
    err = getattr(lib, name)(
        seg_p, seg_b, None if rows is None else rows.data_ptr(),
        0 if rows is None else rows.element_size(), data.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        None if carry is None else carry.data_ptr(), n_segments, e, n_data,
        d, vec, chunk, lanes, stream)
    check(lib, err, name)
    LAUNCHES[count or name] += 1
    FORMS["contiguous" if rows is None else "gather"] += 1
    if carry is not None:
        err = lib.segment_sum_carry(seg_p, seg_b, out.data_ptr(),
                                    carry.data_ptr(), n_segments, e, d, vec,
                                    chunk, lanes, stream)
        check(lib, err, "segment_sum_carry")
        LAUNCHES["segment_sum_carry"] += 1
    return out
