"""Wrapper of the per-destination edge reduction K3 (``csrc/edge_sum.cu``).

``edge_sum(x, edges)[j] = Σ_{e ∈ in(j)} x[src[e]]·wgt[e]`` — the
``segment_sum(x[src]·wgt, dst)`` of the per-edge frontier round and of
the warm-start product ``P·H``.  It has no Pallas source in the JAX
package (XLA's ``segment_sum`` does the work there); on the card it gets
a kernel of its own because ``index_add_`` scatters with atomics whose
float sum order changes from run to run, and replay must be bit-exact.

The edges are held in destination-sorted (CSC) order, built once on the
host per driver (:func:`csc_edges`).  :func:`edge_sum` launches K3 for
tensors on the card (one thread per destination, fixed sum order) and
runs :func:`edge_sum_plain` for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._build import LAUNCHES, check, library, stream_handle

__all__ = ["CscEdges", "csc_edges", "edge_sum", "edge_sum_plain"]


@dataclasses.dataclass(frozen=True)
class CscEdges:
    """Destination-sorted edge list on one device."""

    indptr: torch.Tensor  # [n+1] int64, edges of destination j at [indptr[j], indptr[j+1])
    src: torch.Tensor  # [L] int32 source of each edge
    wgt: torch.Tensor  # [L] float32 weight of each edge
    n: int

    @property
    def n_edges(self) -> int:
        return int(self.src.numel())


def csc_edges(src: np.ndarray, dst: np.ndarray, wgt: np.ndarray, n: int,
              device) -> CscEdges:
    """Sort an edge list by destination (stable: within a destination the
    edges keep their order, source-ascending for a canonical CSR) and
    upload it; weights are pinned to float32."""
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    dev = torch.device(device)
    return CscEdges(
        indptr=torch.as_tensor(indptr).to(dev),
        src=torch.as_tensor(np.asarray(src)[order].astype(np.int32)).to(dev),
        wgt=torch.as_tensor(np.asarray(wgt)[order].astype(np.float32)).to(dev),
        n=int(n),
    )


def edge_sum_plain(x: torch.Tensor, indptr: torch.Tensor, src: torch.Tensor,
                   wgt: torch.Tensor) -> torch.Tensor:
    """K3's contract in torch: ``out[j] = Σ_{e in in(j)} x[src[e]]·wgt[e]``."""
    n = indptr.numel() - 1
    dst = torch.repeat_interleave(torch.arange(n, device=x.device),
                                  torch.diff(indptr))
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
        0, dst, x[src.long()] * wgt)


_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("edge_sum")
    if lib.edge_sum.argtypes is None:
        lib.edge_sum.argtypes = [_P] * 5 + [ctypes.c_int64, _P]
        lib.edge_sum.restype = ctypes.c_int
    return lib


def edge_sum(x: torch.Tensor, edges: CscEdges) -> torch.Tensor:
    """K3 over ``edges`` for the node vector ``x [n]``; returns ``[n]``."""
    if x.device.type == "cpu":
        return edge_sum_plain(x, edges.indptr, edges.src, edges.wgt)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n = edges.n
    for name, t, dtype, shape in (
            ("x", x, torch.float32, (n,)),
            ("indptr", edges.indptr, torch.int64, (n + 1,)),
            ("src", edges.src, torch.int32, (edges.n_edges,)),
            ("wgt", edges.wgt, torch.float32, (edges.n_edges,))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.edge_sum(edges.indptr.data_ptr(), edges.src.data_ptr(),
                       edges.wgt.data_ptr(), x.data_ptr(), out.data_ptr(), n,
                       stream_handle(x.device))
    check(lib, err, "edge_sum")
    LAUNCHES["edge_sum"] += 1
    return out
