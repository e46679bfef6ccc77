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
  Replaces ``bsr_spmm_pallas``; the visit table lets the engine's gather
  SpMM run on it later.

The ``*_kernel`` wrapper takes the plain version only for CPU tensors.
For CUDA tensors it launches the kernel or raises, and adds one to
``LAUNCHES[name]`` per launch.  The source's header says what bounds the
kernels on an H100 (tile bytes) and how the design answers it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import LAUNCHES, check, library, stream_handle

__all__ = [
    "frontier_round_bsr_kernel",
    "frontier_round_bsr_plain",
    "bsr_spmm_kernel",
    "bsr_spmm_plain",
]

_MAX_BS = 1024
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
_WARPS = 8  # kThreads / 32 in diffusion.cu


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
        lib.frontier_round_bsr.argtypes = [_P] * 8 + [_I, _I, _I, _P]
        lib.frontier_round_bsr.restype = ctypes.c_int
        lib.bsr_spmm.argtypes = [_P] * 6 + [_I, _I, _I, _P]
        lib.bsr_spmm.restype = ctypes.c_int
    return lib


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


def _check_tiling(bs: int, c: int, smem_floats: int) -> None:
    if not 1 <= bs <= _MAX_BS:
        raise ValueError(f"bs must be in [1, {_MAX_BS}], got {bs}")
    if smem_floats * 4 > _MAX_SMEM:
        raise ValueError(
            f"bs={bs} x C={c} needs {smem_floats * 4} bytes of shared "
            f"memory, more than the {_MAX_SMEM} a Hopper block may use")


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
    """K1: one fused frontier round (see :func:`frontier_round_bsr_plain`).

    ``buffer_depth`` is the TPU kernel's tile-prefetch depth.  It is
    validated (>= 1) and has no effect on this kernel yet: the CUDA
    kernel keeps several tile rows in flight per warp instead.
    """
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    if not _on_card(f):
        return frontier_round_bsr_plain(blocks, block_col, row_ptr,
                                        col_active, f, wt)
    nrb, bs, c = f.shape
    n_blocks = blocks.shape[0]
    dev = f.device
    _check_tiling(bs, c, 2 * bs * c + _WARPS)
    _require(blocks, "blocks", torch.float32, (n_blocks, bs, bs), dev)
    _require(block_col, "block_col", torch.int32, (n_blocks,), dev)
    _require(row_ptr, "row_ptr", torch.int64, (nrb + 1,), dev)
    _require(col_active, "col_active", torch.int32, (nrb,), dev)
    _require(f, "f", torch.float32, (nrb, bs, c), dev)
    _require(wt, "wt", torch.float32, (nrb, bs), dev)
    f_new = torch.empty_like(f)
    row_l1 = torch.empty(nrb, dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.frontier_round_bsr(
        blocks.data_ptr(), block_col.data_ptr(), row_ptr.data_ptr(),
        col_active.data_ptr(), f.data_ptr(), wt.data_ptr(),
        f_new.data_ptr(), row_l1.data_ptr(), nrb, bs, c,
        stream_handle(dev))
    check(lib, err, "frontier_round_bsr")
    LAUNCHES["frontier_round_bsr"] += 1
    return f_new, row_l1


def bsr_spmm_kernel(
    blocks: torch.Tensor,
    visit_block: torch.Tensor,
    visit_col: torch.Tensor,
    row_ptr: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """K2: block-sparse product over a visit table (see
    :func:`bsr_spmm_plain`)."""
    if not _on_card(x):
        return bsr_spmm_plain(blocks, visit_block, visit_col, row_ptr, x)
    ncb, bs, c = x.shape
    nrb = row_ptr.numel() - 1
    n_visits = visit_block.numel()
    dev = x.device
    _check_tiling(bs, c, 2 * bs * c)
    _require(blocks, "blocks", torch.float32, (blocks.shape[0], bs, bs), dev)
    _require(visit_block, "visit_block", torch.int32, (n_visits,), dev)
    _require(visit_col, "visit_col", torch.int32, (n_visits,), dev)
    _require(row_ptr, "row_ptr", torch.int64, (nrb + 1,), dev)
    _require(x, "x", torch.float32, (ncb, bs, c), dev)
    out = torch.empty((nrb, bs, c), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.bsr_spmm(
        blocks.data_ptr(), visit_block.data_ptr(), visit_col.data_ptr(),
        row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(), nrb, bs, c,
        stream_handle(dev))
    check(lib, err, "bsr_spmm")
    LAUNCHES["bsr_spmm"] += 1
    return out
