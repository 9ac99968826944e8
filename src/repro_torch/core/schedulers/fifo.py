"""FIFO — the trivial scheduler (paper Table 1: 10 LoC).

Runs each trial to its stopping condition; launches trials in parallel when
resources allow (that part is the runner's job).  All logic is the base class.
"""
from __future__ import annotations

from .base import TrialScheduler

__all__ = ["FIFOScheduler"]


class FIFOScheduler(TrialScheduler):
    def decision_interval(self) -> int:
        # Never stops/pauses/perturbs: every decision is CONTINUE, so workers
        # may run unbounded result lookahead without changing semantics.
        return 0
