"""Fault-tolerant training loop (the port of ``repro.runtime.loop``).

* **checkpoint/restart** — :class:`~repro_torch.checkpoint.CheckpointManager`
  (atomic, async, retention; the reference's on-disk format) and
  auto-resume; batches are made from the step number, so a restart
  replays the exact batch stream.
* **straggler detection** — the *paper's own slope policy* on step
  times, through the shared :mod:`repro_torch.balance` control plane: a
  straggling host is a "slow PID" whose residual-decay slope lags, so
  per-host step times become the ``step-time`` LoadSignal and the policy
  proposes "move load away from host i" MovePlans.  On one card the
  monitor runs against an :class:`~repro_torch.balance.executors.
  AdvisoryExecutor` (it records the plans).
* **MoE expert rebalancing** — the same policy on per-expert routed-token
  counts (the ``expert-tokens`` LoadSignal: a hot expert is an
  overloaded Ω_k), fed by the transformer's expert-load tap
  (:func:`repro_torch.models.transformer.set_expert_load_sink`), which
  :meth:`TrainLoop.run` registers around the run.
* **elastic scaling** — :meth:`TrainLoop.on_world_change` re-seeds the
  policy through the shared interface (``Rebalancer.reset_worker``).
* **fault injection** — ``crash_at_step`` simulates a hard kill for the
  restart tests.

A step function takes and returns the state ``(params, opt_state)`` as
trees of tensors (the model's :meth:`~repro_torch.models.transformer.
Transformer.param_tree` and :func:`~repro_torch.optim.adamw_init`'s
state), as ``launch.steps``' train kind does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..balance.executors import AdvisoryExecutor
from ..balance.plan import MovePlan
from ..balance.policies import Rebalancer, SlopeEMAPolicy
from ..balance.signals import LoadSignal
from ..checkpoint import CheckpointManager

__all__ = ["TrainLoopConfig", "TrainLoop", "StragglerMonitor",
           "ExpertLoadMonitor"]


class StragglerMonitor:
    """Slope-EMA straggler detector: the paper's policy on step times.

    Per-host step durations become a ``step-time`` :class:`LoadSignal`,
    any :class:`Rebalancer` proposes, and an :class:`AdvisoryExecutor`
    records the accepted plans (``self.executor.log`` / ``drain()``).  A
    host whose EMA'd log-slowness exceeds the fastest by the paper's 50%
    rule is flagged and sheds load.
    """

    def __init__(self, n_hosts: int, eta: float = 0.5, z: int = 10,
                 policy: Optional[Rebalancer] = None):
        self.policy: Rebalancer = policy or SlopeEMAPolicy(
            k=n_hosts, target_error=1e-6, eta=eta, z=z, unit="device")
        self.executor = AdvisoryExecutor(kind="device")
        self.n_hosts = n_hosts
        self._step = 0

    def advise(self, step_times: np.ndarray,
               load_units: Optional[np.ndarray] = None
               ) -> Optional[MovePlan]:
        """step_times: ``[n_hosts]`` seconds.  Returns the first MovePlan
        (or None); the whole batch lands in ``self.executor.log``.  The
        host with the largest EMA'd log step-time becomes i_min and sheds
        load."""
        self._step += 1
        sig = LoadSignal.from_step_times(step_times, load_units,
                                         step=self._step)
        plans = self.policy.propose(sig)
        for p in plans:
            self.executor.apply(p)
        return plans[0] if plans else None

    def reseed(self) -> None:
        """Elastic event at unchanged width: re-seed every host's slope."""
        for k in range(self.n_hosts):
            self.policy.reset_worker(k)


class ExpertLoadMonitor:
    """MoE expert rebalancer: the same policy on routed-token counts.

    Register :meth:`observe` with
    :func:`repro_torch.models.transformer.set_expert_load_sink`; every MoE
    layer then hands it its per-expert token counts.  A hot expert (its
    slope lagging on the ``expert-tokens`` signal) sheds shards.
    """

    def __init__(self, n_experts: int, eta: float = 0.5, z: int = 10,
                 shards_per_expert: int = 16,
                 policy: Optional[Rebalancer] = None):
        self.policy: Rebalancer = policy or SlopeEMAPolicy(
            k=n_experts, target_error=1e-6, eta=eta, z=z,
            unit="expert-shard")
        self.executor = AdvisoryExecutor(kind="expert-shard")
        self.n_experts = n_experts
        # the movable-unit budget: each expert's capacity is split into
        # this many shards (the 10% move cap needs >= 10 units to act)
        self.shards = np.full(n_experts, shards_per_expert, dtype=np.int64)
        self._step = 0

    def observe(self, token_counts: np.ndarray) -> List[MovePlan]:
        counts = np.asarray(token_counts, np.float64)
        if counts.shape[0] != self.n_experts:
            return []
        self._step += 1
        sig = LoadSignal.from_expert_counts(
            np.maximum(counts, 1e-9), shards_per_expert=self.shards,
            step=self._step)
        accepted = []
        for p in self.policy.propose(sig):
            # keep the shard ledger truthful: a source never drops below
            # one shard, and proposals beyond that are clipped
            units = int(min(p.units, self.shards[p.src] - 1))
            if units < 1:
                continue
            if units != p.units:
                p = MovePlan(src=p.src, dst=p.dst, units=units, kind=p.kind)
            self.executor.apply(p)
            self.shards[p.src] -= units
            self.shards[p.dst] += units
            accepted.append(p)
        return accepted


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    crash_at_step: Optional[int] = None  # fault injection (tests)
    n_hosts: int = 1  # straggler monitor width
    moe_experts: int = 0  # >0 wires the MoE expert-load monitor


def _ready(t: Any) -> None:
    """Wait for ``t``'s device work (a step's wall is the device's)."""
    if torch.is_tensor(t) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class TrainLoop:
    """Generic step loop: state = (params, opt_state); restart-safe."""

    def __init__(self, step_fn: Callable[[Any, Any, Dict], tuple],
                 make_batch: Callable[[int], Dict],
                 init_state: Callable[[], tuple], cfg: TrainLoopConfig):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.init_state = init_state
        self.cfg = cfg
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.monitor = StragglerMonitor(cfg.n_hosts)
        self.expert_monitor = (ExpertLoadMonitor(cfg.moe_experts)
                               if cfg.moe_experts > 0 else None)
        self.metrics_log: list = []

    def run(self, verbose: bool = False) -> Dict[str, Any]:
        if self.expert_monitor is None:
            return self._run(verbose)
        from ..models.transformer import set_expert_load_sink

        set_expert_load_sink(self.expert_monitor.observe)
        try:
            return self._run(verbose)
        finally:  # injected faults must not leave a stale global sink
            set_expert_load_sink(None)

    def _run(self, verbose: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        params, opt_state = self.init_state()
        start = 0
        restored = self.mgr.restore_or_none((params, opt_state))
        if restored is not None:
            (params, opt_state), step, _extra = restored
            start = step
            if verbose:
                print(f"[resume] from step {start}")
        t_hist = []
        for step in range(start, cfg.total_steps):
            if cfg.crash_at_step is not None and step == cfg.crash_at_step:
                # simulate a hard kill AFTER some checkpoints were cut
                self.mgr.wait()
                raise RuntimeError(f"injected fault at step {step}")
            batch = self.make_batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            _ready(metrics["loss"])
            dt = time.perf_counter() - t0
            t_hist.append(dt)
            self.metrics_log.append(
                {k: float(v) for k, v in metrics.items()}
                | {"step": step, "sec": dt})
            if verbose and step % cfg.log_every == 0:
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"({dt*1e3:.0f} ms)")
            if (step + 1) % cfg.ckpt_every == 0:
                self.mgr.save(step + 1, (params, opt_state),
                              extra={"loss": float(metrics["loss"])})
            # advisory straggler scan (one host: a vector of one)
            self.monitor.advise(np.full(cfg.n_hosts, dt))
        self.mgr.save(cfg.total_steps, (params, opt_state))
        self.mgr.wait()
        return {
            "params": params,
            "opt_state": opt_state,
            "metrics": self.metrics_log,
            "mean_step_time": float(np.mean(t_hist)) if t_hist else 0.0,
        }

    def on_world_change(self, new_hosts: int):
        """Elastic event: an unchanged width (a host replaced in place)
        re-seeds every slope through ``Rebalancer.reset_worker``; a changed
        width rebuilds the monitor at the new K (the policy state is
        per-worker and cannot survive a dimension change)."""
        if new_hosts == self.monitor.n_hosts:
            self.monitor.reseed()
        else:
            self.monitor = StragglerMonitor(new_hosts)
