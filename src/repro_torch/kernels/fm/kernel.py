"""Wrapper of the FM pairwise-interaction kernel K4 (``csrc/fm.cu``).

``fm_interaction_kernel(v)[b] = 0.5·Σ_d[(Σ_f v[b,f,d])² − Σ_f v[b,f,d]²]``
for ``v [B, F, D]`` float32.  Replaces
``repro.kernels.fm.kernel.fm_interaction_pallas``; unlike it, any ``B``
is taken (no tile padding).  For a CPU tensor the wrapper runs the plain
version :func:`~repro_torch.kernels.fm.ref.fm_interaction_ref`; for a
CUDA tensor it launches K4 or raises, and adds one to
``LAUNCHES["fm_interaction"]`` per launch.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import fm_interaction_ref

__all__ = ["fm_interaction_kernel"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("fm")
    if lib.fm_interaction.argtypes is None:
        lib.fm_interaction.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, _P]
        lib.fm_interaction.restype = ctypes.c_int
    return lib


def fm_interaction_kernel(v: torch.Tensor) -> torch.Tensor:
    """K4 on ``v [B, F, D]`` float32 (contiguous); returns ``[B]``."""
    if v.device.type == "cpu":
        return fm_interaction_ref(v)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    if v.dtype != torch.float32 or v.dim() != 3:
        raise ValueError(f"v: expected float32 [B, F, D], got {v.dtype} "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    b, f, d = v.shape
    out = torch.empty(b, dtype=torch.float32, device=v.device)
    lib = _lib()
    err = lib.fm_interaction(v.data_ptr(), out.data_ptr(), b, f, d,
                             stream_handle(v.device))
    check(lib, err, "fm_interaction")
    LAUNCHES["fm_interaction"] += 1
    return out
