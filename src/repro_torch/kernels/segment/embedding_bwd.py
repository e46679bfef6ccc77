"""Wrapper of the FM tables' gradient (``csrc/embedding_bwd.cu``).

``embedding_bwd_kernel(g, seg, order, n, bag)[r] = Σ_{e: seg[e] = r}
g[order[e] // bag]`` for ``r`` in ``[0, n)``, 0 where no ``e`` names ``r``:
``seg`` the ids sorted ascending (int32 or int64), ``order`` the stable
sort's permutation (int32 or int64), ``g`` float32 ``[E / bag, D]``; the
output is dense float32 ``[n, D]``.  Ids outside ``[0, n)`` contribute
nothing, as in K5's contract.  With ``seg = rows[order]`` it is the
gradient of the lookup ``table[rows]`` (``bag`` 1) or of its sums over
bags of ``bag`` consecutive rows (FM's linear term), which
:func:`~repro_torch.kernels.segment.ops.embedding_gather` hands it.

The kernel is one cooperative launch: every warp of the grid sums an equal
piece of the sorted ids into the runs of equal ids that begin in it (a hot
id's rows spread over many warps), then each CTA assembles tiles of output
rows in shared memory from those sums and writes each row once, coalesced;
no atomics, so a relaunch gives the same bits.  Its scratch (the runs' ids
and sums) is a byte tensor the wrapper allocates.  For CPU tensors the wrapper runs the plain version
:func:`embedding_bwd_ref`; for CUDA tensors it launches the kernel or
raises, and adds one to ``LAUNCHES["embedding_gather_bwd"]`` per launch.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import segment_sum_ref

__all__ = ["embedding_bwd_kernel", "embedding_bwd_ref", "tile_rows"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_IDS = (torch.int32, torch.int64)


def _lib() -> ctypes.CDLL:
    lib = library("embedding_bwd")
    if lib.embedding_bwd.argtypes is None:
        lib.embedding_bwd.argtypes = [_P, _I64, _P, _I, _P, _I, _I64, _P,
                                      _I64, _I, _I, _P, _I64, _I, _I, _P]
        lib.embedding_bwd.restype = _I
        lib.embedding_bwd_scratch.argtypes = [_I64, _I64, _I64, _I, _I, _I,
                                              ctypes.POINTER(_I64)]
        lib.embedding_bwd_scratch.restype = _I
        lib.embedding_bwd_tile_rows.argtypes = [_I]
        lib.embedding_bwd_tile_rows.restype = _I
    return lib


def embedding_bwd_ref(g: torch.Tensor, seg: torch.Tensor,
                      order: torch.Tensor, n: int,
                      bag: int = 1) -> torch.Tensor:
    """The plain version: K5's plain version over the rows ``order //
    bag`` of ``g``."""
    src = order if bag == 1 else torch.div(order, bag, rounding_mode="floor")
    return segment_sum_ref(g, seg, n, None, src)


def tile_rows(d: int) -> int:
    """Output rows a CTA owns at width ``d``, as ``csrc/embedding_bwd.cu``
    picks them (builds the library: the card's machine only)."""
    return int(_lib().embedding_bwd_tile_rows(d))


def _check(g, seg, order, n, bag):
    if g.dtype != torch.float32 or g.dim() != 2:
        raise ValueError(f"g: expected float32 [E / bag, D], got {g.dtype} "
                         f"{tuple(g.shape)}")
    for name, t in (("seg", seg), ("order", order)):
        if t.dtype not in _IDS or t.dim() != 1 or t.device != g.device:
            raise ValueError(f"{name}: expected int32 or int64 [E] on "
                             f"{g.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if order.shape != seg.shape:
        raise ValueError(f"order {tuple(order.shape)} and seg "
                         f"{tuple(seg.shape)} differ")
    if n < 0 or bag < 1:
        raise ValueError(f"n must be >= 0 and bag >= 1, got {n}, {bag}")


def embedding_bwd_kernel(g: torch.Tensor, seg: torch.Tensor,
                         order: torch.Tensor, n: int,
                         bag: int = 1) -> torch.Tensor:
    """The dense gradient ``[n, D]`` of a lookup over the sorted ids
    ``seg`` with stable sort ``order``, for ``g [E / bag, D]``."""
    _check(g, seg, order, n, bag)
    dev = g.device
    if dev.type == "cpu":
        return embedding_bwd_ref(g, seg, order, n, bag)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = _launch(g, seg, order, n, bag)
    LAUNCHES["embedding_gather_bwd"] += 1
    return out


def _launch(g, seg, order, n, bag, rows_a_tile=0, ctas_per_sm=0):
    """The kernel on CUDA operands, counted nowhere (tools/emb_bwd_probe.py
    passes other tile sizes and CTAs an SM; 0 takes the source's)."""
    for name, t in (("g", g), ("seg", seg), ("order", order)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    e, d = seg.shape[0], g.shape[1]
    if e >= 2**31 - 1 or g.shape[0] >= 2**31 - 1:
        raise ValueError(f"{e} ids or {g.shape[0]} rows of g: the kernel "
                         "takes fewer than 2**31")
    if n == 0 or d == 0:
        return torch.zeros((n, d), dtype=torch.float32, device=g.device)
    if n >= 2**31 - 1:
        raise ValueError(f"{n} rows: the kernel takes fewer than 2**31")
    out = torch.empty((n, d), dtype=torch.float32, device=g.device)
    lib = _lib()
    size = _I64(0)
    err = lib.embedding_bwd_scratch(g.shape[0], e, n, d, rows_a_tile,
                                    ctas_per_sm, ctypes.byref(size))
    check(lib, err, "embedding_bwd_scratch")
    scratch = torch.empty(size.value, dtype=torch.uint8, device=g.device)
    err = lib.embedding_bwd(
        g.data_ptr(), g.shape[0], seg.data_ptr(), seg.element_size(),
        order.data_ptr(), order.element_size(), e, out.data_ptr(), n, d, bag,
        scratch.data_ptr(), size.value, rows_a_tile, ctas_per_sm,
        stream_handle(g.device))
    check(lib, err, "embedding_bwd")
    return out
