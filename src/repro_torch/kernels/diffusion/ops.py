"""Public ops of the BSR diffusion push over the K1/K2 kernels.

:class:`BsrMatrix` holds the tile pool on one device; :func:`bsr_spmm`
and :func:`frontier_round_bsr` run the CUDA kernels for tensors on the
card and their plain torch versions for tensors on the CPU (the kernel
wrappers decide by the tensor's device, never by catching a failure).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .kernel import bsr_spmm_kernel, frontier_round_bsr_kernel
from .ref import bsr_spmm_ref, csr_to_bsr

__all__ = ["bsr_spmm", "frontier_round_bsr", "prepare_bsr", "BsrMatrix"]


class BsrMatrix:
    """Host-prepared BSR operand: static structure + device tensors.

    The tile pool is uploaded once and stays on ``device``.  The row
    pointer ``row_ptr [n_row_blocks+1]`` over the row-sorted tiles is
    built on the host; ``visit_block`` is the identity visit table K2
    reads the pool through.
    """

    def __init__(self, blocks, block_row, block_col, n_row_blocks, bs,
                 device="cuda"):
        self.device = torch.device(device)
        block_row = np.asarray(block_row, dtype=np.int64)
        block_col = np.asarray(block_col)
        self.n_row_blocks = int(n_row_blocks)
        self.bs = int(bs)
        if block_row.size and (np.any(np.diff(block_row) < 0)
                               or block_row[-1] >= self.n_row_blocks
                               or block_row[0] < 0):
            raise ValueError("block_row must be sorted and in "
                             f"[0, {self.n_row_blocks})")
        if block_col.size and (block_col.min() < 0
                               or block_col.max() >= self.n_row_blocks):
            raise ValueError("block_col must lie in "
                             f"[0, {self.n_row_blocks}): the frontier "
                             "tiling is square")
        counts = np.bincount(block_row, minlength=self.n_row_blocks)
        row_ptr = np.zeros(self.n_row_blocks + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        dev = self.device
        self.blocks = torch.as_tensor(
            np.asarray(blocks, dtype=np.float32)).to(dev)
        self.block_row = torch.as_tensor(block_row.astype(np.int32)).to(dev)
        self.block_col = torch.as_tensor(block_col.astype(np.int32)).to(dev)
        self.row_ptr = torch.as_tensor(row_ptr).to(dev)
        self.row_occupied = torch.as_tensor(counts > 0).to(dev)
        self.visit_block = torch.arange(block_row.size, dtype=torch.int32,
                                        device=dev)

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def density(self) -> float:
        return self.n_blocks / max(self.n_row_blocks**2, 1)


def prepare_bsr(indptr, indices, weights, n, bs=128,
                device="cuda") -> BsrMatrix:
    blocks, br, bc, nrb = csr_to_bsr(
        np.asarray(indptr), np.asarray(indices), np.asarray(weights), n, bs
    )
    return BsrMatrix(blocks, br, bc, nrb, bs, device=device)


def bsr_spmm(m: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """delta = P @ x with P in BSR form (K2).  ``x`` is ``[n]`` or
    ``[n, C]`` with ``n = n_row_blocks * bs``; returns the same shape.
    Block rows without tiles come out exactly 0."""
    squeeze = x.dim() == 1
    x2 = x[:, None] if squeeze else x
    c = x2.shape[1]
    out = bsr_spmm_kernel(m.blocks, m.visit_block, m.block_col, m.row_ptr,
                          x2.reshape(-1, m.bs, c).contiguous())
    out = out.reshape(-1, c)
    return out[:, 0] if squeeze else out


def frontier_round_bsr(
    m: BsrMatrix,
    f: torch.Tensor,  # [n] or [n, C] residual fluid, n = n_row_blocks * bs
    w: torch.Tensor,  # [n] selection weights (0 = padding / inert slot)
    t: torch.Tensor,  # 0-d threshold
    *,
    backend: Optional[str] = None,  # None/"auto" | "kernel" | "block"
    buffer_depth: int = 1,
    occupancy_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused frontier round ``F' = F - sent + P @ sent`` over BSR ``m``.

    Every node above the threshold diffuses simultaneously (the
    frontier-batched D-iteration schedule).  Returns ``(f_new, sent,
    res)`` with ``res = |f_new|_1`` (0-d tensor).

    ``occupancy_threshold`` defers sparse block columns: a column block
    whose fraction of above-threshold entries is <= the threshold keeps
    its fluid this round and diffuses later (exact — deferred fluid is
    kept, never dropped).  0.0 arms every column with at least one
    above-threshold node.  ``buffer_depth`` is validated and passed to
    K1, which does not use it yet.

    Backends, each with its own selection predicate:

    * ``kernel`` — K1.  It folds the threshold into the weights
      (``wt = w/t`` in f32, select when ``|f|·wt > 1``); ``sent`` and
      ``col_active`` are computed here with that exact predicate, or a
      boundary node could be sent by one side and kept by the other.
      On CPU tensors it runs K1's plain twin.
    * ``block`` — the reference's CPU oracle: ``|f|·w > t``, tiles
      multiplied in torch.  CPU tensors only.
    * ``auto``/None — ``kernel`` on the card, ``block`` on the CPU, as
      the reference picks its Pallas kernel on the TPU only.
    """
    squeeze = f.dim() == 1
    f2 = f[:, None] if squeeze else f
    c = f2.shape[1]
    if backend in (None, "auto"):
        backend = "kernel" if f2.is_cuda else "block"
    if backend == "kernel":
        wt_flat = (w / t).to(f2.dtype)
        sel = f2.abs() * wt_flat[:, None] > 1.0
    elif backend == "block":
        if f2.device.type != "cpu":
            raise ValueError("the block backend is the CPU oracle; on "
                             f"{f2.device} use backend='kernel'")
        sel = f2.abs() * w[:, None] > t
    else:
        raise ValueError(f"unknown frontier backend {backend!r}")
    blk = sel.reshape(-1, m.bs * c)
    if occupancy_threshold > 0.0:
        frac = blk.to(f2.dtype).mean(dim=1)
        col_active = (frac > occupancy_threshold).to(torch.int32)
        # only nodes in armed columns fire; the rest keep their fluid.
        sel = sel & (col_active != 0).repeat_interleave(m.bs)[:, None]
    else:
        col_active = blk.any(dim=1).to(torch.int32)
    sent = torch.where(sel, f2, torch.zeros_like(f2))
    if backend == "block":
        xt = sent.reshape(-1, m.bs, c)
        delta = bsr_spmm_ref(m.blocks, m.block_row, m.block_col, xt,
                             m.n_row_blocks)
        f_new = (f2 - sent) + delta.reshape(f2.shape)
        res = f_new.abs().sum()
    else:
        out, row_l1 = frontier_round_bsr_kernel(
            m.blocks, m.block_col, m.row_ptr, col_active,
            f2.reshape(-1, m.bs, c).contiguous(),
            wt_flat.reshape(-1, m.bs).contiguous(),
            buffer_depth=buffer_depth)
        f_new = out.reshape(f2.shape)
        res = row_l1.sum()
    if squeeze:
        return f_new[:, 0], sent[:, 0], res
    return f_new, sent, res
