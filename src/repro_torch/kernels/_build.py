"""Build and load the port's CUDA kernels; count their launches.

Every ``*.cu`` under ``src/repro_torch/csrc/`` is compiled by ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes``.  Builds happen at first use, never at import: the package
imports on machines without ``nvcc`` or a card.  All sources compile in
parallel (one ``nvcc`` per file, started together), into
``build/kernels/`` at the repository root, cached by the hash of the
source: an unchanged source is loaded, not rebuilt.  The first build
prints the ``-Xptxas -v`` register / shared-memory summary.

Launch counters: each kernel wrapper adds one to ``LAUNCHES[name]``
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launches`` zeroes them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import threading
from typing import Dict

__all__ = ["LAUNCHES", "reset_launches", "library", "build_all",
           "check", "stream_handle"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {
    "frontier_round_bsr": 0,
    "bsr_spmm": 0,
    "edge_sum": 0,
    "fm_interaction": 0,
    "segment_sum": 0,
    "segment_sum_carry": 0,
    "flash_attention": 0,
    "sim_messages": 0,
    "sim_push": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use and cannot run without it")


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every stale source in parallel; return name -> library path.

    Raises with the compiler's output when any build fails.
    """
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    stale = [s for s in sources if not targets[s.stem].exists()]
    if not stale:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in stale:
        tmp = targets[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {s.name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, targets[s.stem])
        summary = [ln.strip() for ln in out.splitlines()
                   if "ptxas info" in ln and ("Used" in ln
                                              or "Compiling" in ln)]
        print(f"[build] {s.name}:\n  " + "\n  ".join(summary),
              file=sys.stderr)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            for stem, path in build_all().items():
                if stem not in _LIBS:
                    loaded = ctypes.CDLL(str(path))
                    loaded.cuda_error_string.argtypes = [ctypes.c_int]
                    loaded.cuda_error_string.restype = ctypes.c_char_p
                    _LIBS[stem] = loaded
            lib = _LIBS[name]
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    """The raw handle of ``device``'s current stream (torch's C accessor,
    a tenth of ``torch.cuda.current_stream``'s host time)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())
