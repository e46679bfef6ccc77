"""Wrapper of the FM pairwise-interaction kernel K4 (``csrc/fm.cu``).

``fm_interaction_kernel(v)[b] = 0.5·Σ_d[(Σ_f v[b,f,d])² − Σ_f v[b,f,d]²]``
for ``v [B, F, D]`` float32.  Replaces
``repro.kernels.fm.kernel.fm_interaction_pallas``; unlike it, any ``B``
is taken (no tile padding).  For a CPU tensor the wrapper runs the plain
version :func:`~repro_torch.kernels.fm.ref.fm_interaction_ref`; for a
CUDA tensor it launches K4 or raises, and adds one to
``LAUNCHES["fm_interaction"]`` per launch.

``fm_interaction_bwd_kernel(v, dy)[b, f, d] = dy[b]·(Σ_g v[b,g,d] −
v[b,f,d])`` is K4's backward (``fm_interaction_bwd`` in the same source),
under the same rules: its plain version
:func:`~repro_torch.kernels.fm.ref.fm_interaction_bwd_ref` for CPU
tensors, the kernel or an error for CUDA ones, one added to
``LAUNCHES["fm_interaction_bwd"]`` per launch.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import LAUNCHES, check, library, stream_handle
from .ref import fm_interaction_bwd_ref, fm_interaction_ref

__all__ = ["fm_interaction_kernel", "fm_interaction_bwd_kernel"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("fm")
    if lib.fm_interaction.argtypes is None:
        lib.fm_interaction.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, _P]
        lib.fm_interaction.restype = ctypes.c_int
        lib.fm_interaction_bwd.argtypes = [_P, _P, _P, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int, _P]
        lib.fm_interaction_bwd.restype = ctypes.c_int
    return lib


def _check_v(v: torch.Tensor) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    if v.dtype != torch.float32 or v.dim() != 3:
        raise ValueError(f"v: expected float32 [B, F, D], got {v.dtype} "
                         f"{tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")


def fm_interaction_kernel(v: torch.Tensor) -> torch.Tensor:
    """K4 on ``v [B, F, D]`` float32 (contiguous); returns ``[B]``."""
    if v.device.type == "cpu":
        return fm_interaction_ref(v)
    _check_v(v)
    b, f, d = v.shape
    out = torch.empty(b, dtype=torch.float32, device=v.device)
    lib = _lib()
    err = lib.fm_interaction(v.data_ptr(), out.data_ptr(), b, f, d,
                             stream_handle(v.device))
    check(lib, err, "fm_interaction")
    LAUNCHES["fm_interaction"] += 1
    return out


def fm_interaction_bwd_kernel(v: torch.Tensor,
                              dy: torch.Tensor) -> torch.Tensor:
    """K4's backward on ``v [B, F, D]`` float32 (contiguous) and ``dy
    [B]`` float32; returns ``grad_v [B, F, D]``."""
    if v.device.type == "cpu":
        return fm_interaction_bwd_ref(v, dy)
    _check_v(v)
    b, f, d = v.shape
    if (dy.device != v.device or dy.dtype != torch.float32
            or tuple(dy.shape) != (b,) or not dy.is_contiguous()):
        raise ValueError(f"dy: expected contiguous float32 [{b}] on "
                         f"{v.device}, got {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device}")
    grad_v = torch.empty_like(v)
    lib = _lib()
    err = lib.fm_interaction_bwd(v.data_ptr(), dy.data_ptr(),
                                 grad_v.data_ptr(), b, f, d,
                                 stream_handle(v.device))
    check(lib, err, "fm_interaction_bwd")
    LAUNCHES["fm_interaction_bwd"] += 1
    return grad_v
