"""View builders over the canonical CSR.

Every backend representation the solvers consume is derived here from
one canonical out-adjacency CSR (edges sorted by ``(src, dst)``,
deduplicated):

* :func:`build_canonical_csr` — the canonical arrays themselves;
* :func:`build_bsr` / :class:`BsrTiles` — the frontier kernel's BSR tile
  pool plus its block-row occupancy map.

The incremental patchers of ``repro.graph.views`` arrive with the
graph-delta slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .delta import edge_keys as _edge_keys

__all__ = ["BsrTiles", "build_canonical_csr", "build_bsr"]


def build_canonical_csr(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, weights) sorted by (src, dst).

    Parallel (src, dst) entries are merged by summing their weights —
    the same multigraph semantics as ``CSRGraph.to_dense`` — so any
    multigraph CSR canonicalizes to an equivalent simple graph.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    keys = _edge_keys(src, dst)
    if keys.size:
        first = np.ones(keys.size, dtype=bool)
        first[1:] = keys[1:] != keys[:-1]
        if not first.all():
            w = np.add.reduceat(w, np.nonzero(first)[0])
            src, dst = src[first], dst[first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int32), w


@dataclasses.dataclass
class BsrTiles:
    """Host-side BSR of P: sorted block keys + the occupancy map.

    ``blocks[t]`` is the dense ``[bs, bs]`` tile of block row
    ``block_row[t]`` / block column ``block_col[t]`` with tiles sorted
    by ``block_row * nb + block_col`` (the :func:`repro_torch.kernels.
    diffusion.ref.csr_to_bsr` layout).
    """

    blocks: np.ndarray  # [n_blocks, bs, bs] float32
    block_row: np.ndarray  # [n_blocks] int32
    block_col: np.ndarray  # [n_blocks] int32
    n_row_blocks: int
    bs: int

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def row_occupied(self) -> np.ndarray:
        occ = np.zeros(self.n_row_blocks, dtype=bool)
        occ[self.block_row] = True
        return occ

    def keys(self) -> np.ndarray:
        return (self.block_row.astype(np.int64) * self.n_row_blocks
                + self.block_col.astype(np.int64))

    def to_device(self, device):
        """Upload as the kernel-facing :class:`BsrMatrix` on ``device``."""
        from ..kernels.diffusion import BsrMatrix

        return BsrMatrix(self.blocks, self.block_row, self.block_col,
                         self.n_row_blocks, self.bs, device=device)


def build_bsr(indptr, indices, weights, n: int, bs: int) -> BsrTiles:
    from ..kernels.diffusion.ref import csr_to_bsr

    blocks, br, bc, nrb = csr_to_bsr(
        np.asarray(indptr), np.asarray(indices), np.asarray(weights), n, bs)
    return BsrTiles(blocks=blocks, block_row=br, block_col=bc,
                    n_row_blocks=nrb, bs=bs)
