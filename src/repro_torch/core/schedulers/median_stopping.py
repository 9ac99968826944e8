"""Median Stopping Rule (Golovin et al. 2017, Google Vizier; paper Table 1).

Stop trial t at step s if t's best objective up to s is strictly worse than the
median of the *running averages* of all completed/ongoing trials' objectives
reported up to step s.  A grace period and a minimum number of reference trials
guard cold starts.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..trial import Result, Trial
from .base import SchedulerDecision, TrialScheduler

__all__ = ["MedianStoppingRule"]


class MedianStoppingRule(TrialScheduler):
    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        grace_period: int = 1,
        min_samples_required: int = 3,
        hard_stop: bool = True,
    ):
        super().__init__(metric=metric, mode=mode)
        self.grace_period = grace_period
        self.min_samples_required = min_samples_required
        self.hard_stop = hard_stop
        # trial_id -> list of scores in report order (higher = better)
        self._scores: Dict[str, List[float]] = {}
        self.n_stopped = 0

    def decision_interval(self) -> int:
        # May stop a trial on any post-grace result: exact mode needs
        # lookahead 1.
        return 1

    def _running_avg(self, trial_id: str, upto: int) -> float:
        scores = self._scores[trial_id][:upto]
        return float(np.mean(scores)) if scores else float("-inf")

    def on_result(self, runner, trial: Trial, result: Result) -> SchedulerDecision:
        score = self._score(result.value(self.metric))
        self._scores.setdefault(trial.trial_id, []).append(score)
        step = len(self._scores[trial.trial_id])
        if step <= self.grace_period:
            return SchedulerDecision.CONTINUE

        # Median of other trials' running averages up to the same step.
        others = [
            self._running_avg(tid, step)
            for tid, s in self._scores.items()
            if tid != trial.trial_id and len(s) >= step
        ]
        if len(others) < self.min_samples_required:
            return SchedulerDecision.CONTINUE
        median = float(np.median(others))
        best_so_far = max(self._scores[trial.trial_id])
        if best_so_far < median:
            self.n_stopped += 1
            verdict = SchedulerDecision.STOP if self.hard_stop else SchedulerDecision.PAUSE
        else:
            verdict = SchedulerDecision.CONTINUE
        self._record_decision(trial.trial_id, verdict,
                              iteration=result.training_iteration,
                              reason="median", step=step, score=score,
                              best_so_far=best_so_far, median=median,
                              n_others=len(others),
                              grace_period=self.grace_period,
                              min_samples=self.min_samples_required)
        return verdict

    def state_dict(self) -> Dict[str, Any]:
        return {"scores": {tid: list(s) for tid, s in self._scores.items()},
                "n_stopped": self.n_stopped}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._scores = {str(tid): [float(v) for v in s]
                        for tid, s in state["scores"].items()}
        self.n_stopped = int(state["n_stopped"])

    def debug_string(self) -> str:
        return f"MedianStoppingRule: {self.n_stopped} trials stopped"
