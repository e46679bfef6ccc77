"""Byte/flop cost model and shared-memory rule of the BSR diffusion kernels.

The D-iteration hot loop is fluid movement: per tile the kernels read one
``[bs, bs]`` weight tile plus ``O(bs*C)`` fluid and do ``2*bs*bs*C``
flops, so arithmetic intensity is ~``C/2`` flops per byte — firmly
memory-bound for the paper's ``C = 1``.  The cost functions give the
numbers of ``repro.kernels.tune.model`` for the same arguments.

On the card this module is also the one source of K1's and K2's
shared-memory rule (``csrc/diffusion.cu``): :func:`smem_bytes` is the
dynamic shared memory the wrapper passes to a bulk launch at a ring depth,
:func:`route` the body a launch runs (or ``None`` where none fits), and
:func:`ctas_per_sm` the persistent CTAs an SM the launch gets.  The
source keeps only the ring's compile-time constants, which the names
below mirror (``kMaxStages``, ``kSlabBytes``, ``kRowSlots``,
``kCtasPerSm``, ``kWarps``); the stages a depth runs
(:func:`ring_stages`) are decided here and passed to the launch.

Platform peaks are *nominal* datasheet values; they anchor the roofline
fraction, they are not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "HwSpec",
    "PLATFORM_SPECS",
    "KernelCost",
    "frontier_round_cost",
    "gather_spmm_cost",
    "ideal_time_s",
    "dma_compute_ratio",
    "ring_stages",
    "smem_bytes",
    "simt_smem_bytes",
    "smem_ok",
    "route",
    "ctas_per_sm",
    "roofline_fraction",
]


@dataclasses.dataclass(frozen=True)
class HwSpec:
    """Nominal hardware envelope used to anchor the roofline."""

    name: str
    peak_flops: float  # f32 (cpu/gpu/cuda) / bf16-MXU (tpu) peak, flop/s
    mem_bw: float  # main-memory bandwidth, bytes/s (HBM on tpu/gpu/cuda)
    # fast-memory budget for kernel operands, bytes: VMEM on the TPU, the
    # shared memory one CTA may take on the card
    smem_budget: int


PLATFORM_SPECS: Dict[str, HwSpec] = {
    # the reference's entries, number for number
    "tpu": HwSpec("tpu-v5e", 197e12, 819e9, 64 * 2**20),
    "gpu": HwSpec("gpu-a100", 19.5e12, 1.555e12, 48 * 2**20),
    "cpu": HwSpec("cpu-host", 2e11, 4e10, 32 * 2**20),
    # H100 SXM datasheet values (not measurements): 67 TFLOP/s float32
    # outside the tensor cores, 3.35 TB/s HBM3; 227 KiB of shared memory a
    # CTA (the launch's own budget)
    "cuda": HwSpec("h100-sxm", 67e12, 3.35e12, 232_448),
}

# the ring's stages at buffer_depth 1 (the ring the bulk bodies were
# designed and measured with), then csrc/diffusion.cu's constants: the
# deepest ring it has an instance of (kMaxStages), the slab of tile rows
# one bulk copy moves (kSlabBytes), K1's row slots (kRowSlots), the
# persistent CTAs an SM (kCtasPerSm), the simt body's warps (kWarps)
DEPTH1_STAGES = 3
MAX_STAGES = 8
SLAB_BYTES = 32 * 1024
ROW_SLOTS = 8
CTAS_PER_SM = 2
WARPS = 8
MAX_BS = 1024
# Hopper: the shared memory of one SM, and what the driver keeps of it
# for each resident CTA
SM_SMEM_BYTES = 233_472
CTA_RESERVED_SMEM = 1024

_K1, _K2 = "frontier_round_bsr", "bsr_gather_spmm"


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Bytes moved / flops issued by one kernel sweep."""

    bytes_tiles: float  # the tile-pool stream (what buffer_depth pipelines)
    bytes_fluid: float  # f / wt / output traffic
    flops: float

    @property
    def total_bytes(self) -> float:
        return self.bytes_tiles + self.bytes_fluid

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.total_bytes, 1.0)


def frontier_round_cost(
    n_row_blocks: int,
    bs: int,
    c: int,
    n_blocks_active: int,
    dtype_bytes: int = 4,
) -> KernelCost:
    """One fused frontier round at a given frontier occupancy.

    ``n_blocks_active`` is the number of tiles whose block column is armed
    — unarmed tiles cost nothing (no copy, no product), which is why the
    model is parametric in the swept density.
    """
    bytes_tiles = float(n_blocks_active) * bs * bs * dtype_bytes
    # per active visit: f_col [bs, C] + wt_col [bs]; per block row: the
    # kept-fluid seed read (f_row + wt_row), the output write and the
    # per-row |.|_1 cell.
    bytes_fluid = (
        float(n_blocks_active) * (bs * c + bs)
        + float(n_row_blocks) * (2 * (bs * c + bs) + bs * c + 1)
    ) * dtype_bytes
    flops = 2.0 * n_blocks_active * bs * bs * c
    return KernelCost(bytes_tiles, bytes_fluid, flops)


def gather_spmm_cost(
    n_row_blocks: int,
    bs: int,
    c: int,
    n_visits: int,
    dtype_bytes: int = 4,
) -> KernelCost:
    """One gather-indirection SpMM sweep over ``n_visits`` tile visits."""
    bytes_tiles = float(n_visits) * bs * bs * dtype_bytes
    bytes_fluid = (
        float(n_visits) * bs * c + float(n_row_blocks) * bs * c
    ) * dtype_bytes
    flops = 2.0 * n_visits * bs * bs * c
    return KernelCost(bytes_tiles, bytes_fluid, flops)


def ideal_time_s(cost: KernelCost, spec: HwSpec) -> Tuple[float, str]:
    """Roofline-ideal runtime and which wall binds it."""
    t_mem = cost.total_bytes / spec.mem_bw
    t_comp = cost.flops / spec.peak_flops
    if t_mem >= t_comp:
        return t_mem, "memory"
    return t_comp, "compute"


def dma_compute_ratio(cost: KernelCost, spec: HwSpec) -> float:
    """Tile-copy time over arithmetic time — >1 means the tile stream is
    the bottleneck and a deeper ring can only hide (never remove) it."""
    t_comp = cost.flops / spec.peak_flops
    t_dma = cost.bytes_tiles / spec.mem_bw
    return t_dma / max(t_comp, 1e-30)


def ring_stages(buffer_depth: int) -> int:
    """The stages of the bulk bodies' tile ring at ``buffer_depth``: depth
    1 keeps the source's ring (``DEPTH1_STAGES``), depth ``d >= 2`` runs
    ``d`` stages."""
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1, got {buffer_depth}")
    return DEPTH1_STAGES if buffer_depth == 1 else buffer_depth


def _slab_rows(bs: int) -> int:
    return min(bs, max(1, SLAB_BYTES // (bs * 4)))


def _is_k1(kernel: str) -> bool:
    if kernel not in (_K1, _K2):
        raise ValueError(f"no shared-memory rule for kernel {kernel!r}")
    return kernel == _K1


def smem_bytes(kernel: str, bs: int, c: int, buffer_depth: int) -> int:
    """Dynamic shared memory of one CTA of ``kernel``'s bulk body at
    ``buffer_depth``: the bytes the wrapper passes to the launch.

    K2 (``bsr_gather_spmm``, also ``bsr_spmm``'s body): the tile ring, an x slot a
    stage and the accumulator, then four barriers a stage.  K1
    (``frontier_round_bsr``): the ring, an (f, wt) slot a stage and a row
    slot, the accumulator, the epilogue's warp sums and a record a row
    slot, then four barriers a stage and two a row slot.
    """
    s = ring_stages(buffer_depth)
    ring = s * _slab_rows(bs) * bs
    if _is_k1(kernel):
        return (4 * (ring + (s + ROW_SLOTS) * bs * (c + 1) + bs * c + WARPS
                     + 2 * ROW_SLOTS)
                + 8 * (4 * s + 2 * ROW_SLOTS))
    return 4 * ring + 4 * (s + 1) * bs * c + 8 * 4 * s


def simt_smem_bytes(kernel: str, bs: int, c: int) -> int:
    """Dynamic shared memory of the simt body's CTA: the accumulator and
    an x slot (K1: and the epilogue's warp sums)."""
    if _is_k1(kernel):
        return 4 * (2 * bs * c + WARPS)
    return 4 * 2 * bs * c


def smem_ok(kernel: str, bs: int, c: int, buffer_depth: int,
            spec: HwSpec = PLATFORM_SPECS["cuda"]) -> bool:
    """The bulk body's ring at ``buffer_depth`` fits ``spec``'s budget and
    the source has an instance of it."""
    return (ring_stages(buffer_depth) <= MAX_STAGES
            and smem_bytes(kernel, bs, c, buffer_depth) <= spec.smem_budget)


def route(kernel: str, bs: int, c: int, buffer_depth: int = 1,
          aligned: bool = True,
          spec: HwSpec = PLATFORM_SPECS["cuda"]) -> Optional[str]:
    """The body a launch of ``kernel`` runs, ``None`` where none fits.

    ``bulk`` needs ``bs % 4 == 0``, 16-byte aligned operands (``aligned``)
    and its ring in the budget.  At depth 1 everything else runs ``simt``
    (no ring); a depth ``>= 2`` names a ring, so where the bulk body does
    not fit there is no body for it.
    """
    if (not 1 <= bs <= MAX_BS or c < 1
            or simt_smem_bytes(kernel, bs, c) > spec.smem_budget):
        return None
    if bs % 4 == 0 and aligned and smem_ok(kernel, bs, c, buffer_depth,
                                            spec):
        return "bulk"
    return "simt" if buffer_depth == 1 else None


def ctas_per_sm(kernel: str, bs: int, c: int, buffer_depth: int) -> int:
    """Persistent CTAs an SM a bulk launch runs: ``CTAS_PER_SM``, or as
    many as the SM's shared memory holds at this ring (0 where none)."""
    if not smem_ok(kernel, bs, c, buffer_depth):
        return 0
    per_cta = smem_bytes(kernel, bs, c, buffer_depth) + CTA_RESERVED_SMEM
    return min(CTAS_PER_SM, SM_SMEM_BYTES // per_cta)


def roofline_fraction(measured_s: float, ideal_s: float) -> float:
    """Fraction of the roofline the measurement achieves (1.0 = at the
    roof)."""
    if measured_s <= 0.0:
        return 0.0
    return ideal_s / measured_s
