"""Asynchronous HyperBand / ASHA (Li et al. 2018; paper Table 1: 78 LoC).

Successive halving with asynchronous rung promotion: a trial reaching rung r is
promoted iff its result is in the top 1/reduction_factor of all results *seen so
far* at rung r; otherwise it is stopped (or paused).  No bracket barriers — this
is the variant the paper notes is "simpler to implement in the distributed
setting".  Multiple brackets (s values) are supported like the published ASHA.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..trial import Result, Trial
from .base import SchedulerDecision, TrialScheduler

__all__ = ["AsyncHyperBandScheduler", "ASHAScheduler"]


class _Bracket:
    def __init__(self, min_t: int, max_t: int, rf: int, s: int):
        # rung milestones: min_t * rf^k for k >= s, capped at max_t
        self.rf = rf
        self.milestones: List[int] = []
        t = min_t * (rf ** s)
        while t < max_t:
            self.milestones.append(int(t))
            t *= rf
        self.milestones.append(int(max_t))
        # rung -> list of recorded scores (higher better)
        self.rungs: Dict[int, List[float]] = {m: [] for m in self.milestones}

    def on_result(self, iteration: int, score: float
                  ) -> Tuple[SchedulerDecision, Optional[Dict[str, Any]]]:
        """Verdict plus the rung check that produced it (None = no new rung).

        The returned check carries the promotion inputs for the *deciding*
        rung: the last rung this result arrived at (a STOP at any rung wins).
        """
        decision = SchedulerDecision.CONTINUE
        check: Optional[Dict[str, Any]] = None
        for milestone in self.milestones:
            if iteration >= milestone and milestone != self.milestones[-1]:
                recorded = self.rungs[milestone]
                if not any(np.isclose(score, r) for r in recorded):
                    # promotion check against results seen so far at this rung
                    cutoff = (
                        float(np.percentile(recorded, (1 - 1 / self.rf) * 100))
                        if recorded
                        else float("-inf")
                    )
                    rung_decision = (SchedulerDecision.STOP if score < cutoff
                                     else SchedulerDecision.CONTINUE)
                    if check is None or rung_decision == SchedulerDecision.STOP:
                        check = {"milestone": milestone, "cutoff": cutoff,
                                 "score": score, "n_rung": len(recorded),
                                 "rf": self.rf}
                    recorded.append(score)
                    if score < cutoff:
                        decision = SchedulerDecision.STOP
        return decision, check

    def state_dict(self) -> Dict[str, Any]:
        # rungs keyed by int milestones -> list-of-pairs for JSON round-trips
        return {"rungs": [[m, list(v)] for m, v in self.rungs.items()]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for m, scores in state["rungs"]:
            self.rungs[int(m)] = [float(s) for s in scores]

    def debug_string(self) -> str:
        return " | ".join(f"r={m}:n={len(v)}" for m, v in self.rungs.items())


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
        brackets: int = 1,
    ):
        super().__init__(metric=metric, mode=mode)
        if grace_period < 1 or max_t < grace_period:
            raise ValueError("need 1 <= grace_period <= max_t")
        self.max_t = max_t
        self.grace_period = grace_period  # rung-survival signal (elastic GreedyFill)
        self._brackets = [
            _Bracket(grace_period, max_t, reduction_factor, s) for s in range(brackets)
        ]
        self._trial_bracket: Dict[str, int] = {}
        self._rng = np.random.default_rng(0)
        self.n_stopped = 0

    def decision_interval(self) -> int:
        # Any result can be a rung arrival (milestones are per-bracket), so a
        # stop may be issued on every report: exact mode needs lookahead 1.
        return 1

    def on_trial_add(self, runner, trial: Trial) -> None:
        # Softmax-free sizing: weight brackets by number of rungs (as in ASHA).
        sizes = np.array([len(b.milestones) for b in self._brackets], dtype=float)
        probs = sizes / sizes.sum()
        self._trial_bracket[trial.trial_id] = int(self._rng.choice(len(self._brackets), p=probs))

    def on_result(self, runner, trial: Trial, result: Result) -> SchedulerDecision:
        if result.training_iteration >= self.max_t:
            self._record_decision(trial.trial_id, SchedulerDecision.STOP,
                                  iteration=result.training_iteration,
                                  reason="max_t", max_t=self.max_t)
            return SchedulerDecision.STOP
        b_idx = self._trial_bracket.get(trial.trial_id, 0)
        bracket = self._brackets[b_idx]
        score = self._score(result.value(self.metric))
        decision, check = bracket.on_result(result.training_iteration, score)
        if check is not None:
            self._record_decision(trial.trial_id, decision,
                                  iteration=result.training_iteration,
                                  reason="rung", bracket=b_idx, **check)
        if decision == SchedulerDecision.STOP:
            self.n_stopped += 1
        return decision

    def state_dict(self) -> Dict[str, Any]:
        return {
            "brackets": [b.state_dict() for b in self._brackets],
            "trial_bracket": dict(self._trial_bracket),
            "rng": self._rng.bit_generator.state,
            "n_stopped": self.n_stopped,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for b, bs in zip(self._brackets, state["brackets"]):
            b.load_state_dict(bs)
        self._trial_bracket = {str(k): int(v)
                               for k, v in state["trial_bracket"].items()}
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self.n_stopped = int(state["n_stopped"])

    def debug_string(self) -> str:
        lines = [f"AsyncHyperBand: {self.n_stopped} stopped"]
        lines += [f"  bracket {i}: {b.debug_string()}" for i, b in enumerate(self._brackets)]
        return "\n".join(lines)


ASHAScheduler = AsyncHyperBandScheduler
