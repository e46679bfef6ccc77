"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each kernel family is a subpackage whose wrapper launches the CUDA
kernel for tensors on the card and runs its plain torch version for
tensors on the CPU.  Sources live under ``repro_torch/csrc/`` and are
built at first use (:mod:`repro_torch.kernels._build`).

* ``diffusion`` — block-sparse (BSR) fluid push: K1 the fused frontier
  round, K2 the BSR product (``csrc/diffusion.cu``).
* ``edge_sum``  — K3, the deterministic per-destination edge reduction
  of the per-edge frontier round and of warm starts (``csrc/edge_sum.cu``).
* ``tune``      — the read side of the tuned-config records.

``LAUNCHES`` counts each kernel's launches; ``reset_launches`` zeroes it.
"""
from ._build import LAUNCHES, reset_launches  # noqa: F401
