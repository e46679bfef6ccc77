"""Wrappers of the BSR diffusion kernels K1 and K2 (``csrc/diffusion.cu``).

Each kernel comes as a pair with one contract:

* ``frontier_round_bsr_kernel`` / ``frontier_round_bsr_plain`` (K1) — one
  fused frontier round ``F' = F − sent + P·sent`` over row-sorted tiles,
  with ``sent = where(|f|·wt > 1, f, 0)`` built inside the kernel, tiles of
  unarmed block columns (``col_active == 0``) skipped, rows seeded with the
  kept fluid, and the per-row ``|F'|_1`` emitted.  Replaces
  ``repro.kernels.diffusion.kernel.frontier_round_bsr_pallas``.
* ``bsr_spmm_kernel`` / ``bsr_spmm_plain`` (K2) — ``out[r] = Σ_k
  blocks[visit_block[k]] @ x[visit_col[k]]`` over the visits
  ``row_ptr[r] .. row_ptr[r+1]``; rows without visits come out exactly 0.
  Replaces ``bsr_spmm_pallas`` and, fed the engine's visit table,
  ``bsr_gather_spmm_pallas``.

The ``*_kernel`` wrapper takes the plain version only for CPU tensors.
For CUDA tensors it launches the kernel or raises, and adds one to
``LAUNCHES[name]`` per launch.  The source's header says what bounds the
kernels on an H100 (tile bytes) and how the design answers it.

K1 and K2 each have two bodies, and the wrapper picks one per launch by
:func:`frontier_round_bsr_route` / :func:`bsr_spmm_route` (the rule of
``kernels/tune/model.py``, the one source of it): ``bulk``
(``frontier_round_bulk_kernel``, ``bsr_spmm_bulk_kernel``: persistent
CTAs streaming the tiles through a TMA bulk-copy ring; K1's producer warp
tests 32 tiles at once and copies only the armed ones) for every
``bs % 4 == 0`` with 16-byte aligned operands whose ring fits in shared
memory, ``simt`` (``frontier_round_kernel``, ``bsr_spmm_kernel``: a CTA
per output row) for the rest.  ``buffer_depth`` is the ring's depth, a
launch parameter: depth 1 runs the ring of 3 stages, depth ``d >= 2`` a
ring of ``d`` stages (up to ``model.MAX_STAGES``), and a depth ``>= 2``
whose ring does not fit raises ``ValueError``: it names a ring, and no
other body runs in its place.  The launch takes the dynamic shared memory
``model.smem_bytes`` gives.  Both bodies of a kernel, at every depth,
take every sum in the same order, so they give the same bits.  The
wrappers count their launches by route in ``FRONTIER_ROUTES`` (K1) and
``ROUTES`` (K2) and by depth in ``FRONTIER_DEPTHS`` and ``DEPTHS``;
:func:`launch_frontier_round_bsr` and :func:`launch_bsr_spmm` run either
body on request, counted nowhere, to hold the two against each other.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .._build import LAUNCHES, check, library, stream_handle
from ..tune import model

__all__ = [
    "frontier_round_bsr_kernel",
    "frontier_round_bsr_plain",
    "frontier_round_bsr_route",
    "launch_frontier_round_bsr",
    "FRONTIER_ROUTES",
    "FRONTIER_DEPTHS",
    "bsr_spmm_kernel",
    "bsr_spmm_plain",
    "bsr_spmm_route",
    "launch_bsr_spmm",
    "ROUTES",
    "DEPTHS",
    "bulk_ctas_per_sm",
]

# K1 and K2 launches by the body that ran them; csrc/diffusion.cu's route
# codes index _ROUTE_NAMES
FRONTIER_ROUTES = {"bulk": 0, "simt": 0}
ROUTES = {"bulk": 0, "simt": 0}
# and by buffer_depth
FRONTIER_DEPTHS: Dict[int, int] = {}
DEPTHS: Dict[int, int] = {}
_ROUTE_NAMES = ("simt", "bulk")
_K1, _K2 = "frontier_round_bsr", "bsr_gather_spmm"


# --------------------------------------------------------------------------- #
# plain torch versions (the contract; the CPU path; the card's yardstick)
# --------------------------------------------------------------------------- #
def _rows_of(row_ptr: torch.Tensor) -> torch.Tensor:
    """Destination block row of every tile/visit, from the row pointer."""
    nrb = row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(nrb, device=row_ptr.device), torch.diff(row_ptr))


def frontier_round_bsr_plain(
    blocks: torch.Tensor,  # [n_blocks, bs, bs] f32, sorted by block row
    block_col: torch.Tensor,  # [n_blocks] int32
    row_ptr: torch.Tensor,  # [nrb + 1] int64 over the row-sorted tiles
    col_active: torch.Tensor,  # [nrb] int32 armed block columns
    f: torch.Tensor,  # [nrb, bs, C] f32 residual fluid
    wt: torch.Tensor,  # [nrb, bs] f32 selection weights / threshold
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's contract in torch: returns ``(f_new [nrb, bs, C], row_l1 [nrb])``."""
    armed = (col_active != 0)[:, None, None]
    fire = (f.abs() * wt[..., None] > 1.0) & armed
    sent = torch.where(fire, f, torch.zeros_like(f))
    kept = torch.where(fire, torch.zeros_like(f), f)
    partial = torch.bmm(blocks, sent[block_col.long()])
    f_new = kept.index_add(0, _rows_of(row_ptr), partial)
    return f_new, f_new.abs().sum(dim=(1, 2))


def bsr_spmm_plain(
    blocks: torch.Tensor,  # [n_tiles, bs, bs] f32 tile pool
    visit_block: torch.Tensor,  # [V] int32 tile of each visit
    visit_col: torch.Tensor,  # [V] int32 source block column of each visit
    row_ptr: torch.Tensor,  # [nrb + 1] int64 over the row-sorted visits
    x: torch.Tensor,  # [ncb, bs, C] f32
) -> torch.Tensor:
    """K2's contract in torch: returns ``out [nrb, bs, C]``."""
    nrb = row_ptr.numel() - 1
    partial = torch.bmm(blocks[visit_block.long()], x[visit_col.long()])
    out = torch.zeros((nrb,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, _rows_of(row_ptr), partial)


# --------------------------------------------------------------------------- #
# the CUDA launches
# --------------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = library("diffusion")
    if lib.frontier_round_bsr.argtypes is None:
        lib.frontier_round_bsr.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib.frontier_round_bsr.restype = ctypes.c_int
        lib.bsr_spmm.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        lib.bsr_spmm.restype = ctypes.c_int
        lib.bulk_ctas_per_sm.argtypes = [_I, _I, _I, _P]
        lib.bulk_ctas_per_sm.restype = ctypes.c_int
    return lib


def frontier_round_bsr_route(bs: int, c: int, aligned: bool = True,
                             buffer_depth: int = 1) -> Optional[str]:
    """The body K1 runs a ``bs x C`` round on at ``buffer_depth``, ``None``
    where none fits (``model.route``).  ``aligned``: the tile pool, ``f``
    and ``wt`` start on 16 bytes, as the bulk copies need."""
    return model.route(_K1, bs, c, buffer_depth, aligned)


def bsr_spmm_route(bs: int, c: int, aligned: bool = True,
                   buffer_depth: int = 1) -> Optional[str]:
    """The body K2 runs a ``bs x C`` product on at ``buffer_depth``,
    ``None`` where none fits (``model.route``).  ``aligned``: the tile
    pool and ``x`` start on 16 bytes, as the bulk copies need."""
    return model.route(_K2, bs, c, buffer_depth, aligned)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _plan(kernel: str, bs: int, c: int, buffer_depth: int, aligned: bool,
          route: Optional[str]) -> Tuple[str, int, int]:
    """``(route, ring stages, dynamic shared memory)`` of one launch.
    ``route`` ``None`` takes the rule's body; a named one runs as asked
    (the source refuses a bulk launch it cannot run)."""
    stages = model.ring_stages(buffer_depth)
    fits = model.route(kernel, bs, c, buffer_depth, aligned)
    if route is None:
        route = fits
    if route is None or (route == "bulk"
                         and not model.smem_ok(kernel, bs, c, buffer_depth)):
        need = model.smem_bytes(kernel, bs, c, buffer_depth)
        raise ValueError(
            f"{kernel}: no body fits bs={bs} x C={c} at buffer_depth="
            f"{buffer_depth} (a {stages}-stage ring needs {need} bytes of "
            f"shared memory, {'aligned' if aligned else 'unaligned'} "
            f"operands; the budget is {model.PLATFORM_SPECS['cuda'].smem_budget}"
            f" bytes and {model.MAX_STAGES} stages)")
    if route not in _ROUTE_NAMES:
        raise ValueError(f"unknown route {route!r}")
    if route == "simt" and buffer_depth != 1:
        raise ValueError(f"{kernel}: the simt body has no ring; "
                         f"buffer_depth={buffer_depth} names one")
    smem = (model.smem_bytes(kernel, bs, c, buffer_depth) if route == "bulk"
            else model.simt_smem_bytes(kernel, bs, c))
    return route, stages, smem


def bulk_ctas_per_sm(kernel: str, bs: int, c: int, buffer_depth: int) -> int:
    """The persistent CTAs an SM the source gives a bulk launch of
    ``kernel`` at this ring (the card's occupancy answer, to hold
    ``model.ctas_per_sm`` to)."""
    stages = model.ring_stages(buffer_depth)
    smem = model.smem_bytes(kernel, bs, c, buffer_depth)
    got = ctypes.c_int(0)
    lib = _lib()
    err = lib.bulk_ctas_per_sm(0 if kernel == _K1 else 1, stages, smem,
                               ctypes.byref(got))
    check(lib, err, f"bulk_ctas_per_sm ({kernel}, {stages} stages)")
    return got.value


def _count(routes: Dict[str, int], depths: Dict[int, int], route: str,
           buffer_depth: int) -> None:
    routes[route] += 1
    depths[buffer_depth] = depths.get(buffer_depth, 0) + 1


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def frontier_round_bsr_kernel(
    blocks: torch.Tensor,
    block_col: torch.Tensor,
    row_ptr: torch.Tensor,
    col_active: torch.Tensor,
    f: torch.Tensor,
    wt: torch.Tensor,
    *,
    buffer_depth: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: one fused frontier round (see :func:`frontier_round_bsr_plain`),
    on the body :func:`frontier_round_bsr_route` picks, with a ring of
    ``buffer_depth`` (see the module's docstring).  Every depth gives the
    same bits.  The plain version (CPU tensors) has no ring: there the
    depth is only validated (>= 1)."""
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    if not _on_card(f):
        return frontier_round_bsr_plain(blocks, block_col, row_ptr,
                                        col_active, f, wt)
    f_new, row_l1, route = launch_frontier_round_bsr(
        blocks, block_col, row_ptr, col_active, f, wt,
        buffer_depth=buffer_depth)
    LAUNCHES["frontier_round_bsr"] += 1
    _count(FRONTIER_ROUTES, FRONTIER_DEPTHS, route, buffer_depth)
    return f_new, row_l1


def launch_frontier_round_bsr(
    blocks: torch.Tensor,
    block_col: torch.Tensor,
    row_ptr: torch.Tensor,
    col_active: torch.Tensor,
    f: torch.Tensor,
    wt: torch.Tensor,
    route: Optional[str] = None,
    *,
    buffer_depth: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, str]:
    """One K1 launch on the card, counted nowhere; returns ``(f_new,
    row_l1, the route that ran)``.  ``route`` ``None`` takes the rule's
    choice; ``"bulk"`` or ``"simt"`` runs that body (raising where it does
    not fit), so that tests and the probe can hold the two against each
    other."""
    if not _on_card(f):
        raise ValueError("launch_frontier_round_bsr launches the kernel: f "
                         f"must be on a card, not {f.device}")
    nrb, bs, c = f.shape
    n_blocks = blocks.shape[0]
    dev = f.device
    _require(blocks, "blocks", torch.float32, (n_blocks, bs, bs), dev)
    _require(block_col, "block_col", torch.int32, (n_blocks,), dev)
    _require(row_ptr, "row_ptr", torch.int64, (nrb + 1,), dev)
    _require(col_active, "col_active", torch.int32, (nrb,), dev)
    _require(f, "f", torch.float32, (nrb, bs, c), dev)
    _require(wt, "wt", torch.float32, (nrb, bs), dev)
    route, stages, smem = _plan(_K1, bs, c, buffer_depth,
                                _aligned(blocks, f, wt), route)
    f_new = torch.empty_like(f)
    row_l1 = torch.empty(nrb, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.frontier_round_bsr(
        blocks.data_ptr(), block_col.data_ptr(), row_ptr.data_ptr(),
        col_active.data_ptr(), f.data_ptr(), wt.data_ptr(),
        f_new.data_ptr(), row_l1.data_ptr(), nrb, bs, c,
        _ROUTE_NAMES.index(route), stages, smem, stream_handle(dev))
    check(lib, err, f"frontier_round_bsr (route {route}, {stages} stages)")
    return f_new, row_l1, route


def bsr_spmm_kernel(
    blocks: torch.Tensor,
    visit_block: torch.Tensor,
    visit_col: torch.Tensor,
    row_ptr: torch.Tensor,
    x: torch.Tensor,
    *,
    buffer_depth: int = 1,
) -> torch.Tensor:
    """K2: block-sparse product over a visit table (see
    :func:`bsr_spmm_plain`), on the body :func:`bsr_spmm_route` picks, with
    a ring of ``buffer_depth``.  Every depth gives the same bits; on CPU
    tensors the depth is only validated (>= 1)."""
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    if not _on_card(x):
        return bsr_spmm_plain(blocks, visit_block, visit_col, row_ptr, x)
    out, route = launch_bsr_spmm(blocks, visit_block, visit_col, row_ptr, x,
                                 buffer_depth=buffer_depth)
    LAUNCHES["bsr_spmm"] += 1
    _count(ROUTES, DEPTHS, route, buffer_depth)
    return out


def launch_bsr_spmm(
    blocks: torch.Tensor,
    visit_block: torch.Tensor,
    visit_col: torch.Tensor,
    row_ptr: torch.Tensor,
    x: torch.Tensor,
    route: Optional[str] = None,
    *,
    buffer_depth: int = 1,
) -> Tuple[torch.Tensor, str]:
    """One K2 launch on the card, counted nowhere; returns ``(out, the
    route that ran)``.  ``route`` ``None`` takes the rule's choice;
    ``"bulk"`` or ``"simt"`` runs that body (raising where it does not
    fit), so that tests and the probe can hold the two against each
    other."""
    if not _on_card(x):
        raise ValueError("launch_bsr_spmm launches the kernel: x must be "
                         f"on a card, not {x.device}")
    ncb, bs, c = x.shape
    nrb = row_ptr.numel() - 1
    n_visits = visit_block.numel()
    dev = x.device
    _require(blocks, "blocks", torch.float32, (blocks.shape[0], bs, bs), dev)
    _require(visit_block, "visit_block", torch.int32, (n_visits,), dev)
    _require(visit_col, "visit_col", torch.int32, (n_visits,), dev)
    _require(row_ptr, "row_ptr", torch.int64, (nrb + 1,), dev)
    _require(x, "x", torch.float32, (ncb, bs, c), dev)
    route, stages, smem = _plan(_K2, bs, c, buffer_depth,
                                _aligned(blocks, x), route)
    out = torch.empty((nrb, bs, c), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.bsr_spmm(
        blocks.data_ptr(), visit_block.data_ptr(), visit_col.data_ptr(),
        row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(), nrb, bs, c,
        _ROUTE_NAMES.index(route), stages, smem, stream_handle(dev))
    check(lib, err, f"bsr_spmm (route {route}, {stages} stages)")
    return out, route
