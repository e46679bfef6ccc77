"""Plain oracles and host-side BSR preparation for the diffusion kernels.

``csr_to_bsr``, ``dense_to_bsr`` and ``frontier_round_ref`` are numpy
copies of ``repro.kernels.diffusion.ref`` (same arrays, byte for byte);
``bsr_spmm_ref`` is the torch block oracle the ``block`` backend of
:func:`repro_torch.kernels.diffusion.frontier_round_bsr` runs on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bsr_spmm_ref",
    "frontier_round_ref",
    "csr_to_bsr",
    "dense_to_bsr",
]


def bsr_spmm_ref(
    blocks: torch.Tensor,  # [n_blocks, bs, bs]
    block_row: torch.Tensor,  # [n_blocks]
    block_col: torch.Tensor,  # [n_blocks]
    x: torch.Tensor,  # [n_col_blocks, bs, C]
    n_row_blocks: int,
) -> torch.Tensor:
    """delta[r] = sum_{i: block_row[i]==r} blocks[i] @ x[block_col[i]]."""
    partial = torch.bmm(blocks, x[block_col.long()])  # [n_blocks, bs, C]
    out = torch.zeros((n_row_blocks,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, block_row.long(), partial)


def frontier_round_ref(
    blocks: np.ndarray,  # [n_blocks, bs, bs]
    block_row: np.ndarray,  # [n_blocks]
    block_col: np.ndarray,  # [n_blocks]
    f: np.ndarray,  # [n] or [n, C] residual fluid (n = n_row_blocks * bs)
    w: np.ndarray,  # [n] selection weights
    t: float,  # threshold
):
    """Pure-numpy twin of the fused frontier round (oracle for the kernel).

    Returns ``(f_new, sent, res)`` where ``f_new = F - sent + P @ sent``,
    ``sent = where(|F| * w > t, F, 0)`` and ``res = |f_new|_1``.
    """
    squeeze = f.ndim == 1
    f2 = f[:, None] if squeeze else f
    bs = blocks.shape[1]
    sel = np.abs(f2) * w[:, None] > t
    sent = np.where(sel, f2, 0.0)
    xt = sent.reshape(-1, bs, f2.shape[1])
    partial = np.einsum("bij,bjc->bic", blocks, xt[block_col])
    delta = np.zeros_like(xt)
    np.add.at(delta, block_row, partial)
    f_new = (f2 - sent) + delta.reshape(f2.shape)
    res = float(np.abs(f_new).sum())
    if squeeze:
        return f_new[:, 0], sent[:, 0], res
    return f_new, sent, res


def dense_to_bsr(p: np.ndarray, bs: int):
    """Dense [N, M] -> (blocks, block_row, block_col) keeping nonzero tiles.

    Rows/cols are zero-padded to multiples of ``bs``; block_row is sorted.
    """
    n, m = p.shape
    nr = -(-n // bs)
    nc = -(-m // bs)
    pad = np.zeros((nr * bs, nc * bs), dtype=p.dtype)
    pad[:n, :m] = p
    tiles = pad.reshape(nr, bs, nc, bs).transpose(0, 2, 1, 3)
    occ = np.abs(tiles).sum(axis=(2, 3)) > 0
    rows, cols = np.nonzero(occ)  # row-major order => sorted by row
    blocks = tiles[rows, cols]
    if blocks.shape[0] == 0:  # degenerate all-zero matrix
        blocks = np.zeros((1, bs, bs), dtype=p.dtype)
        rows = np.zeros(1, dtype=np.int64)
        cols = np.zeros(1, dtype=np.int64)
    return (
        blocks.astype(np.float32),
        rows.astype(np.int32),
        cols.astype(np.int32),
    )


def csr_to_bsr(indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray,
               n: int, bs: int):
    """Out-adjacency CSR of P (edges i->j, weight P[j,i]) -> BSR of P.

    P[j, i] lives in block (j // bs, i // bs).  Returns
    (blocks [n_blocks, bs, bs], block_row, block_col, n_row_blocks).
    """
    nb = -(-n // bs)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    br = dst // bs
    bc = src // bs
    key = br * nb + bc
    order = np.argsort(key, kind="stable")
    src, dst, w, key = src[order], dst[order], weights[order], key[order]
    uniq, first = np.unique(key, return_index=True)
    n_blocks = uniq.shape[0] if uniq.shape[0] else 1
    blocks = np.zeros((n_blocks, bs, bs), dtype=np.float32)
    block_of_edge = np.searchsorted(uniq, key)
    blocks[block_of_edge, dst % bs, src % bs] += w
    block_row = (uniq // nb).astype(np.int32)
    block_col = (uniq % nb).astype(np.int32)
    if uniq.shape[0] == 0:
        block_row = np.zeros(1, dtype=np.int32)
        block_col = np.zeros(1, dtype=np.int32)
    return blocks, block_row, block_col, nb
