"""Deterministic chaos plans (DESIGN.md §8), the port's copy of the plan
half of ``repro.chaos``.

>>> from repro_torch.chaos import ChaosPlan
>>> plan = ChaosPlan(seed=0).straggler(1, 4.0, round=3).kill(2, round=10)
>>> DistributedSimulator(g, b, cfg).run(chaos=plan)
"""
from .plan import EVENT_KINDS, SIM_KINDS, ChaosEvent, ChaosPlan

__all__ = ["EVENT_KINDS", "SIM_KINDS", "ChaosEvent", "ChaosPlan"]
