"""Deterministic chaos harness: seeded disruption plans + injectors (the
port of ``repro.chaos``).

A :class:`ChaosPlan` schedules straggler / kill / rescale / churn-burst /
checkpoint-crash events against a running solve, the injectors replay it
bit-identically, and the §2.2 invariant ``B = (I−P)H + F`` is the
recovery oracle throughout.

>>> from repro_torch.chaos import ChaosPlan, ChaosRunner
>>> plan = ChaosPlan(seed=0).kill(pid=1, round=3).rescale(2, round=5)
>>> runner = ChaosRunner(problem, "engine:chunk", plan, ckpt_dir=d,
...                      options=SolverOptions(k=4))
>>> runner.measure()  # recovery overhead vs an undisturbed twin
>>> DistributedSimulator(g, b, cfg).run(chaos=plan)  # virtual PIDs
"""
from .inject import ChaosKill, ChaosRunner, SessionInjector, tear_checkpoint
from .plan import EVENT_KINDS, SIM_KINDS, ChaosEvent, ChaosPlan

__all__ = [
    "EVENT_KINDS",
    "SIM_KINDS",
    "ChaosEvent",
    "ChaosKill",
    "ChaosPlan",
    "ChaosRunner",
    "SessionInjector",
    "tear_checkpoint",
]
