"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each kernel family is a subpackage whose wrapper launches the CUDA
kernel for tensors on the card and runs its plain torch version for
tensors on the CPU.  Sources live under ``repro_torch/csrc/`` and are
built at first use (:mod:`repro_torch.kernels._build`).

* ``diffusion`` — block-sparse (BSR) fluid push: K1 the fused frontier
  round, K2 the BSR product (``csrc/diffusion.cu``).
* ``edge_sum``  — K3, the deterministic per-destination edge reduction
  of the per-edge frontier round and of warm starts (``csrc/edge_sum.cu``).
* ``fm``        — K4, the factorization-machine pairwise term of FM
  serving (``csrc/fm.cu``).
* ``segment``   — K5, the sorted (optionally weighted, optionally
  gathered) segment sum behind ``segment_sum_sorted`` / ``embedding_bag``
  and GIN's aggregation (``csrc/segment_sum.cu``).
* ``attention`` — K6, flash attention (causal or not, GQA, ``kv_len``
  masking) behind the transformer's prefill and decode
  (``csrc/attention.cu``).
* ``sim_push``  — K7, the K-PID simulator's float64 push: its messages
  (``sim_messages``) and their sum into the fluid and the outboxes, in
  message order per destination (``sim_push``; ``csrc/sim_push.cu``).
* ``tune``      — the read side of the tuned-config records.

``LAUNCHES`` counts each kernel's launches; ``reset_launches`` zeroes it.
"""
from ._build import LAUNCHES, reset_launches  # noqa: F401
