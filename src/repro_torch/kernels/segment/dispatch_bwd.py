"""Wrapper of the MoE dispatch's backward (``csrc/dispatch_bwd.cu``).

``dispatch_bwd_kernel(g, dest, keep, n)[t] = Σ_{j < k, keep[t·k + j]}
g[dest[t·k + j]]`` for ``g [R, D]`` (float32 or bfloat16), ``dest``
(int64) and ``keep`` (bool) ``[n·k]``: each token's kept slots, summed in
float32 in ascending ``j`` from +0 and rounded once into ``g``'s dtype,
which the output ``[n, D]`` has.  A token with no kept slot gets zeros; a
dropped slot reads no row (and a kept slot whose ``dest`` lies outside
``[0, R)`` counts as dropped), so a non-finite ``g`` in a row that only
dropped slots name never reaches the output, as the reference's
``where(keep, ...)`` keeps it out.  It is the gradient of the MoE
dispatch gather, which
:func:`~repro_torch.kernels.segment.ops.moe_dispatch` hands it.

The kernel takes a warp a (token, 32 16-byte columns) where ``D`` is a
multiple of ``16 / itemsize`` and ``g`` and the output are 16-byte
aligned (the ``vec`` body), else a warp a token, an element a lane (the
``elem`` body); both sum in the same order.  For CPU tensors the wrapper
runs the plain version :func:`dispatch_bwd_ref`; for CUDA tensors it
launches the kernel or raises, and adds one to
``LAUNCHES["moe_dispatch_bwd"]`` per launch.  The plain version sums the
same terms in the same order (an ``index_add_`` a slot position over the
tokens that keep it), so on finite data the two give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, library, stream_handle

__all__ = ["dispatch_bwd_kernel", "dispatch_bwd_ref"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = library("dispatch_bwd")
    if lib.moe_dispatch_bwd.argtypes is None:
        lib.moe_dispatch_bwd.argtypes = [_P, _I, _P, _P, _P, _I64, _I, _I64,
                                         _I, _I, _P]
        lib.moe_dispatch_bwd.restype = _I
    return lib


def _check(g, dest, keep, n):
    if g.dtype not in _DTYPES or g.dim() != 2:
        raise ValueError(f"g: expected float32 or bfloat16 [R, D], got "
                         f"{g.dtype} {tuple(g.shape)}")
    m = dest.shape[0] if dest.dim() == 1 else -1
    if n < 0 or (n == 0 and m > 0) or (n > 0 and m % n):
        raise ValueError(f"{m} slots do not split into {n} tokens")
    for name, t, dt in (("dest", dest, torch.int64),
                        ("keep", keep, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (m,) or t.device != g.device:
            raise ValueError(f"{name}: expected {dt} [{m}] on {g.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def dispatch_bwd_ref(g: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The plain version: for each slot position ``j`` in turn, an
    ``index_add_`` of the kept slots' rows into their tokens' float32 sums
    (no token twice in one, so in any order the same bits), then one
    cast."""
    _check(g, dest, keep, n)
    out = torch.zeros((n, g.shape[1]), dtype=torch.float32, device=g.device)
    if dest.numel():
        k = dest.numel() // n
        rows = dest.reshape(n, k)
        kept = keep.reshape(n, k) & (rows >= 0) & (rows < g.shape[0])
        for j in range(k):
            tok = kept[:, j].nonzero()[:, 0]
            out.index_add_(0, tok, g.index_select(0, rows[tok, j]).float())
    return out.to(g.dtype)


def dispatch_bwd_kernel(g: torch.Tensor, dest: torch.Tensor,
                        keep: torch.Tensor, n: int) -> torch.Tensor:
    """The dispatch's backward ``[n, D]`` in ``g``'s dtype."""
    _check(g, dest, keep, n)
    dev = g.device
    if dev.type == "cpu":
        return dispatch_bwd_ref(g, dest, keep, n)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    d = g.shape[1]
    if n == 0 or d == 0:  # nothing to launch
        return torch.empty((n, d), dtype=g.dtype, device=dev)
    for name, t in (("g", g), ("dest", dest), ("keep", keep)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    k = dest.shape[0] // n
    if k >= 2**31 or d >= 2**31:
        raise ValueError(f"top {k} of width {d}: the kernel takes fewer "
                         "than 2**31")
    out = torch.empty((n, d), dtype=g.dtype, device=dev)
    vec = 16 // g.element_size()
    if d % vec or g.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    lib = _lib()
    err = lib.moe_dispatch_bwd(g.data_ptr(), _DTYPES[g.dtype],
                               dest.data_ptr(), keep.data_ptr(),
                               out.data_ptr(), n, k, g.shape[0], d, vec,
                               stream_handle(dev))
    check(lib, err, "moe_dispatch_bwd")
    LAUNCHES["moe_dispatch_bwd"] += 1
    return out
