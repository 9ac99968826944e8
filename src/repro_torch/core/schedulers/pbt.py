"""Population-Based Training (Jaderberg et al. 2017; paper Table 1: 169 LoC).

Every ``perturbation_interval`` iterations a trial is *ready*; if it sits in the
bottom ``quantile_fraction`` of the population it EXPLOITS: clone the model
parameters of a top-quantile donor (via the donor's latest checkpoint) and
EXPLORE: perturb the donor's hyperparameters (x0.8 / x1.2, or resample from the
original distribution with prob ``resample_probability``).

This exercises the paper's requirement of "clone or mutate model parameters in
the middle of training" (§3) through the narrow interface alone: the scheduler
returns RESTART_WITH_CONFIG and the runner restores the staged donor checkpoint
with the mutated hyperparameter map — no scheduler-side distributed code.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..trial import Result, Trial
from .base import SchedulerDecision, TrialScheduler

__all__ = ["PopulationBasedTraining"]


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        perturbation_factors: tuple = (0.8, 1.2),
        seed: int = 0,
    ):
        super().__init__(metric=metric, mode=mode)
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.perturbation_interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        self.perturbation_factors = perturbation_factors
        self._rng = np.random.default_rng(seed)
        self._last_perturb: Dict[str, int] = {}
        self.n_exploits = 0

    def decision_interval(self) -> int:
        # Exploit/explore fires only once a trial has advanced
        # perturbation_interval iterations past its last perturbation — the
        # declared granularity.  The broker still clamps lookahead to 1 for
        # exactness (a nonzero interval means decisions exist); the value is
        # surfaced so observability (CREDITS events) records how much slack a
        # future bounded-staleness mode could exploit.
        return max(1, int(self.perturbation_interval))

    # -- explore ------------------------------------------------------------------
    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ..search.space import Domain, Categorical

        new = dict(config)
        for key, spec in self.mutations.items():
            if key not in new:
                continue
            if self._rng.random() < self.resample_probability:
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self._rng)
                elif isinstance(spec, (list, tuple)):
                    new[key] = spec[int(self._rng.integers(len(spec)))]
                elif callable(spec):
                    new[key] = spec()
            else:
                if isinstance(spec, (list, tuple)) or isinstance(spec, Categorical):
                    values = list(spec.values) if isinstance(spec, Categorical) else list(spec)
                    # shift to a neighbouring value
                    try:
                        i = values.index(new[key])
                        j = int(np.clip(i + self._rng.choice([-1, 1]), 0, len(values) - 1))
                        new[key] = values[j]
                    except ValueError:
                        new[key] = values[int(self._rng.integers(len(values)))]
                elif isinstance(new[key], (int, float)) and not isinstance(new[key], bool):
                    factor = float(self._rng.choice(self.perturbation_factors))
                    mutated = new[key] * factor
                    new[key] = int(round(mutated)) if isinstance(new[key], int) else mutated
        return new

    # -- quantiles ------------------------------------------------------------------
    def _population_scores(self, runner) -> List[tuple]:
        scored = []
        for t in runner.trials:
            if t.last_result is not None and self.metric in t.last_result.metrics:
                scored.append((self._score(t.last_result.value(self.metric)), t))
        return sorted(scored, key=lambda x: x[0])  # ascending: worst first

    def on_result(self, runner, trial: Trial, result: Result) -> SchedulerDecision:
        last = self._last_perturb.get(trial.trial_id, 0)
        if result.training_iteration - last < self.perturbation_interval:
            return SchedulerDecision.CONTINUE
        self._last_perturb[trial.trial_id] = result.training_iteration

        scored = self._population_scores(runner)
        if len(scored) < 2:
            return SchedulerDecision.CONTINUE
        n_q = max(1, int(len(scored) * self.quantile_fraction))
        bottom = {t.trial_id for _, t in scored[:n_q]}
        top = [t for _, t in scored[-n_q:]]
        if trial.trial_id not in bottom:
            return SchedulerDecision.CONTINUE

        donor = top[int(self._rng.integers(len(top)))]
        if donor.trial_id == trial.trial_id or donor.checkpoint is None:
            # Journaled so resume replay can reproduce this branch: whether
            # the drawn donor had a live checkpoint is executor state the
            # journal otherwise would not capture (DESIGN.md §12).
            self._record_decision(
                trial.trial_id, "EXPLOIT_SKIPPED",
                iteration=result.training_iteration, reason="exploit_skipped",
                donor=donor.trial_id,
                donor_is_self=donor.trial_id == trial.trial_id,
                donor_has_checkpoint=donor.checkpoint is not None)
            return SchedulerDecision.CONTINUE

        # Stage the exploit: the runner restores donor's checkpoint with the
        # explored config (paper: "restart a trial with an updated
        # hyperparameter configuration").
        donor.checkpoint.pinned = True  # survive keep_last rotation until applied
        new_config = self._explore(donor.config)
        trial.scheduler_state["restore_from"] = donor.checkpoint
        trial.scheduler_state["new_config"] = new_config
        trial.scheduler_state["cloned_from"] = donor.trial_id
        self.n_exploits += 1
        my_score = next((s for s, t in scored if t.trial_id == trial.trial_id),
                        None)
        donor_score = next((s for s, t in scored
                            if t.trial_id == donor.trial_id), None)
        self._record_decision(
            trial.trial_id, SchedulerDecision.RESTART_WITH_CONFIG,
            iteration=result.training_iteration, reason="exploit",
            donor=donor.trial_id,
            donor_iteration=donor.checkpoint.training_iteration,
            donor_score=donor_score, my_score=my_score,
            quantile_fraction=self.quantile_fraction, n_bottom=n_q,
            population=len(scored), new_config=new_config)
        return SchedulerDecision.RESTART_WITH_CONFIG

    def state_dict(self) -> Dict[str, Any]:
        return {"last_perturb": dict(self._last_perturb),
                "n_exploits": self.n_exploits,
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._last_perturb = {str(k): int(v)
                              for k, v in state["last_perturb"].items()}
        self.n_exploits = int(state["n_exploits"])
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]

    def debug_string(self) -> str:
        return f"PBT: {self.n_exploits} exploit/explore events"
