"""Searcher interface + random/grid searchers.

The paper folds search algorithms into schedulers ("they can add to the list of
trials to execute (e.g., based on suggestions from HyperOpt)" §4.2).  We keep a
small ``Searcher`` interface (suggest/observe) and an adapter scheduler
(``SearchAlgorithmScheduler``) that feeds suggestions into the runner as
capacity frees up — so any Searcher composes with any TrialScheduler's
early-stopping behaviour.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np

from .space import sample_space
from .variants import generate_variants

__all__ = ["Searcher", "RandomSearcher", "GridSearcher"]


class Searcher:
    def __init__(self, space: Dict[str, Any], metric: str = "loss", mode: str = "min"):
        self.space = space
        self.metric = metric
        self.mode = mode
        self._last_explain: Optional[Dict[str, Any]] = None

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Return the next config to try, or None when exhausted."""
        raise NotImplementedError

    def observe(self, trial_id: str, config: Dict[str, Any], value: float, final: bool) -> None:
        """Feed back an observed metric value for a suggested config."""

    def _score(self, value: float) -> float:
        return value if self.mode == "max" else -value

    # -- decision provenance (DESIGN.md §10) ------------------------------------
    def _record_suggest(self, trial_id: str, **inputs: Any) -> Dict[str, Any]:
        """Record the inputs behind the last suggest() for explain_last()."""
        rec = {"trial_id": trial_id, "verdict": "SUGGEST", "iteration": None,
               "inputs": inputs}
        self._last_explain = rec
        return rec

    def explain_last(self) -> Optional[Dict[str, Any]]:
        """The most recent suggestion record (inputs behind it), or None."""
        return self._last_explain

    # -- durable state (DESIGN.md §10) ------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of the searcher's mutable state."""
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore from a ``state_dict()`` snapshot.  Base: nothing to do."""


class RandomSearcher(Searcher):
    def __init__(self, space, metric="loss", mode="min", max_trials: int = 0, seed: int = 0):
        super().__init__(space, metric, mode)
        self.max_trials = max_trials
        self._rng = np.random.default_rng(seed)
        self._count = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self.max_trials and self._count >= self.max_trials:
            return None
        self._count += 1
        self._record_suggest(trial_id, strategy="random",
                             n_suggested=self._count,
                             max_trials=self.max_trials)
        return sample_space(self.space, self._rng)

    def state_dict(self) -> Dict[str, Any]:
        return {"rng": self._rng.bit_generator.state, "count": self._count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._count = int(state["count"])


class GridSearcher(Searcher):
    """Exhausts the grid cross-product (stochastic domains sampled once each)."""

    def __init__(self, space, metric="loss", mode="min", num_samples: int = 1, seed: int = 0):
        super().__init__(space, metric, mode)
        self.num_samples = num_samples
        self.seed = seed
        self._it = generate_variants(space, num_samples=num_samples, seed=seed)
        self._n_emitted = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        try:
            cfg = next(self._it)
        except StopIteration:
            return None
        self._n_emitted += 1
        self._record_suggest(trial_id, strategy="grid",
                             index=self._n_emitted - 1)
        return cfg

    def state_dict(self) -> Dict[str, Any]:
        # The live generator can't serialize; snapshot how far it advanced
        # and fast-forward a rebuilt one on load (deterministic: same seed).
        return {"n_emitted": self._n_emitted}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._it = generate_variants(self.space, num_samples=self.num_samples,
                                     seed=self.seed)
        self._n_emitted = 0
        for _ in range(int(state["n_emitted"])):
            try:
                next(self._it)
            except StopIteration:
                break
            self._n_emitted += 1
