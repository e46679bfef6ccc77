"""Wrapper of the per-destination edge reduction K3 (``csrc/edge_sum.cu``).

``edge_sum(x, edges)[j] = Σ_{e ∈ in(j)} x[src[e]]·wgt[e]`` — the
``segment_sum(x[src]·wgt, dst)`` of the per-edge frontier round and of
the warm-start product ``P·H``.  It has no Pallas source in the JAX
package (XLA's ``segment_sum`` does the work there); on the card it gets
a kernel of its own because ``index_add_`` scatters with atomics whose
float sum order changes from run to run, and replay must be bit-exact.

The edges are held in destination-sorted (CSC) order: built once on the
host per driver for the node-space product (:func:`csc_edges`), and on
the tensors' own device for the engine's per-edge push
(:func:`engine_edge_table`), whose sources and destinations are two
different spaces (``x`` has ``n_src`` entries, the output ``n``).
:func:`edge_sum` launches K3 for tensors on the card (one thread per
destination, fixed sum order) and runs :func:`edge_sum_plain` for
tensors on the CPU.

K3's lane form :func:`edge_sum_lanes` takes ``C`` lanes at once
(``x [C, x_len] -> [C, n]``): the batched frontier round of multi-RHS
solves and continuous-batching serving, the reference's vmapped
``segment_sum`` (``repro/api/session.py:114-116``).  Persistent blocks
take tiles of consecutive destinations, stage each tile's edges in shared
memory (read once a launch, the next tile's copies in flight while a tile
sums), and a thread sums four lanes of one destination, walking its edges
in K3's order with K3's arithmetic: each lane is bit-equal to K3 on that
row and a zero lane stays zero, so zero padding lanes never touch the
real ones.  ``csrc/edge_sum.cu`` says what bounds it.  Its plain version
:func:`edge_sum_lanes_plain` sums each destination's messages in the
same order on the CPU (``torch.segment_reduce``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .._build import LAUNCHES, check, library, stream_handle

__all__ = ["CscEdges", "csc_edges", "edge_sum", "edge_sum_lanes",
           "edge_sum_lanes_plain", "edge_sum_plain", "engine_edge_table"]


@dataclasses.dataclass(frozen=True)
class CscEdges:
    """Destination-sorted edge list on one device."""

    indptr: torch.Tensor  # [n+1] int64, edges of destination j at [indptr[j], indptr[j+1])
    src: torch.Tensor  # [L] int32 source of each edge
    wgt: torch.Tensor  # [L] float32 weight of each edge
    n: int
    n_src: Optional[int] = None  # length of x (default: n)

    @property
    def n_edges(self) -> int:
        return int(self.src.numel())

    @property
    def x_len(self) -> int:
        return self.n if self.n_src is None else self.n_src


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


def edge_sum_lanes_plain(x: torch.Tensor, indptr: torch.Tensor,
                         src: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """The lane form's contract in torch: ``out[c, j] = Σ_{e in in(j)}
    x[c, src[e]]·wgt[e]`` for ``x [C, x_len]``, returned ``[C, n]``.

    Each destination's messages are summed in CSC order, one after the
    other, on the CPU (``segment_reduce``'s CPU loop), which is K3's
    order: every lane is bit-equal to :func:`edge_sum_plain` on that row
    there.  On the card ``segment_reduce`` sums in its own order; the
    smoke and the card tests hold the kernel to it within a tolerance.
    """
    msg = (x[:, src.long()] * wgt).T.contiguous()  # [L, C]
    out = torch.segment_reduce(msg, "sum", lengths=torch.diff(indptr),
                               axis=0)  # [n, C]
    return out.T.contiguous()


_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("edge_sum")
    if lib.edge_sum.argtypes is None:
        lib.edge_sum.argtypes = [_P] * 5 + [ctypes.c_int64, _P]
        lib.edge_sum.restype = ctypes.c_int
        lib.edge_sum_lanes.argtypes = [_P] * 5 + [ctypes.c_int64] * 3 + [_P]
        lib.edge_sum_lanes.restype = ctypes.c_int
    return lib


def _check_edges(x: torch.Tensor, edges: CscEdges) -> None:
    n = edges.n
    for name, t, dtype, shape in (
            ("indptr", edges.indptr, torch.int64, (n + 1,)),
            ("src", edges.src, torch.int32, (edges.n_edges,)),
            ("wgt", edges.wgt, torch.float32, (edges.n_edges,))):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def edge_sum(x: torch.Tensor, edges: CscEdges) -> torch.Tensor:
    """K3 over ``edges`` for ``x [edges.x_len]``; returns ``[edges.n]``."""
    if x.device.type == "cpu":
        return edge_sum_plain(x, edges.indptr, edges.src, edges.wgt)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n = edges.n
    if x.dtype != torch.float32 or tuple(x.shape) != (edges.x_len,):
        raise ValueError(f"x: expected torch.float32 ({edges.x_len},), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_edges(x, edges)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.edge_sum(edges.indptr.data_ptr(), edges.src.data_ptr(),
                       edges.wgt.data_ptr(), x.data_ptr(), out.data_ptr(), n,
                       stream_handle(x.device))
    check(lib, err, "edge_sum")
    LAUNCHES["edge_sum"] += 1
    return out


def edge_sum_lanes(x: torch.Tensor, edges: CscEdges) -> torch.Tensor:
    """K3's lane form over ``edges`` for ``x [C, edges.x_len]``; returns
    ``[C, edges.n]``.  Launches the kernel for a tensor on the card and
    runs :func:`edge_sum_lanes_plain` for one on the CPU."""
    if x.device.type == "cpu":
        return edge_sum_lanes_plain(x, edges.indptr, edges.src, edges.wgt)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 2
            or x.shape[1] != edges.x_len):
        raise ValueError(f"x: expected torch.float32 (C, {edges.x_len}), "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_edges(x, edges)
    lanes, n = x.shape[0], edges.n
    out = torch.empty((lanes, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.edge_sum_lanes(edges.indptr.data_ptr(), edges.src.data_ptr(),
                             edges.wgt.data_ptr(), x.data_ptr(),
                             out.data_ptr(), n, edges.x_len, lanes,
                             stream_handle(x.device))
    check(lib, err, "edge_sum_lanes")
    LAUNCHES["edge_sum_lanes"] += 1
    return out


def engine_edge_table(
    home_row: torch.Tensor,  # [L] int64 home row of each real edge
    edge_pos: torch.Tensor,  # [L] int64 its position in that row's buffer
    src_slot: torch.Tensor,  # [L] int64 in-bucket source slot
    dst_bucket: torch.Tensor,  # [L] int64 stable destination bucket id
    dst_slot: torch.Tensor,  # [L] int64 in-bucket destination slot
    wgt: torch.Tensor,  # [L] edge weights (the compute dtype)
    cur_of_home: torch.Tensor,  # [R] int64 current row of each home row
    row_of_bucket: torch.Tensor,  # [R] int64 current row of each bucket
    k: int,
    b_loc: int,
    s: int,
    edge_cap: int,
) -> CscEdges:
    """The engine's per-edge push as a K3 edge list, on the tensors' device.

    Every PID gets a full-length contribution vector: destination
    ``p·R·S + row·S + slot`` collects what PID ``p`` (the owner of the
    edge's current source row) pushes into the bucket currently at
    ``row``.  Sources index the current-row fluid ``sent [R·S]``.  Within
    one destination the edges run in (current source row, buffer
    position) order — a stable sort by destination of the edges listed in
    that order — which is the order of the reference's ``segment_sum``
    over each device's ``[B_loc, E]`` buffers.  Only real edges are
    listed: the reference's zero-weight padding edges all point at slot 0
    of bucket 0 and would pile onto one thread here.
    """
    r = int(row_of_bucket.numel())
    cur = cur_of_home[home_row]
    first = torch.sort(cur * edge_cap + edge_pos, stable=True).indices
    dst = ((cur[first] // b_loc) * (r * s)
           + row_of_bucket[dst_bucket[first]] * s + dst_slot[first])
    dst, second = torch.sort(dst, stable=True)
    order = first[second]
    n_out = k * r * s
    indptr = torch.searchsorted(
        dst, torch.arange(n_out + 1, device=dst.device))
    return CscEdges(
        indptr=indptr,
        src=(cur[order] * s + src_slot[order]).to(torch.int32),
        wgt=wgt[order].contiguous(),
        n=n_out,
        n_src=r * s,
    )
