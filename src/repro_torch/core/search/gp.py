"""Gaussian-process Bayesian optimization searcher (expected improvement).

Beyond the paper's integrations (it lists HyperOpt/TPE): a numpy-only GP with
an RBF kernel over normalized continuous dims, EI maximized over random
candidates.  Complements TPE: better sample-efficiency on smooth, low-dim
spaces; same ``Searcher`` interface, so it composes with every scheduler.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .basic import Searcher
from .space import Categorical, Domain, LogUniform, RandInt, Uniform, sample_space

__all__ = ["GPSearcher"]


class _GP:
    """RBF-kernel GP regression with Cholesky solves (no scipy)."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 length_scale: float = 0.2, noise: float = 1e-4):
        self.X = X
        self.mu = y.mean()
        self.sigma_y = max(y.std(), 1e-8)
        self.y = (y - self.mu) / self.sigma_y
        self.ls = length_scale
        K = self._kernel(X, X) + noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(
            self.L.T, np.linalg.solve(self.L, self.y))

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls**2)

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._kernel(Xs, self.X)
        mean = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
        return mean * self.sigma_y + self.mu, np.sqrt(var) * self.sigma_y


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


class GPSearcher(Searcher):
    def __init__(self, space: Dict[str, Any], metric: str = "loss",
                 mode: str = "min", n_startup_trials: int = 8,
                 n_candidates: int = 256, length_scale: float = 0.2,
                 xi: float = 0.01, max_trials: int = 0, seed: int = 0):
        super().__init__(space, metric, mode)
        self.n_startup = n_startup_trials
        self.n_candidates = n_candidates
        self.ls = length_scale
        self.xi = xi
        self.max_trials = max_trials
        self._rng = np.random.default_rng(seed)
        self._history: List[Tuple[Dict[str, Any], float]] = []  # (cfg, score↑)
        self._count = 0
        self._cont_dims = [(k, v) for k, v in space.items()
                           if isinstance(v, (Uniform, LogUniform, RandInt))]
        if not self._cont_dims:
            raise ValueError("GPSearcher needs >=1 continuous/int dimension")

    # -- unit-cube encoding ------------------------------------------------------
    def _encode(self, cfg: Dict[str, Any]) -> np.ndarray:
        out = []
        for k, d in self._cont_dims:
            v = float(cfg[k])
            if isinstance(d, LogUniform):
                out.append((math.log(v) - math.log(d.low))
                           / (math.log(d.high) - math.log(d.low)))
            else:
                out.append((v - d.low) / (d.high - d.low))
        return np.asarray(out)

    def _decode_into(self, u: np.ndarray, cfg: Dict[str, Any]) -> Dict[str, Any]:
        for (k, d), ui in zip(self._cont_dims, u):
            ui = float(np.clip(ui, 0.0, 1.0))
            if isinstance(d, LogUniform):
                cfg[k] = math.exp(math.log(d.low)
                                  + ui * (math.log(d.high) - math.log(d.low)))
            elif isinstance(d, RandInt):
                cfg[k] = int(round(d.low + ui * (d.high - 1 - d.low)))
            else:
                cfg[k] = d.low + ui * (d.high - d.low)
        return cfg

    # -- Searcher interface ---------------------------------------------------------
    def observe(self, trial_id, config, value, final) -> None:
        if final:
            self._history.append((config, self._score(value)))

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self.max_trials and self._count >= self.max_trials:
            return None
        self._count += 1
        base = sample_space(self.space, self._rng)
        if len(self._history) < self.n_startup:
            self._record_suggest(trial_id, strategy="random_startup",
                                 n_obs=len(self._history),
                                 n_startup=self.n_startup)
            return base
        X = np.stack([self._encode(c) for c, _ in self._history])
        y = np.asarray([s for _, s in self._history])  # higher better
        try:
            gp = _GP(X, y, length_scale=self.ls)
        except np.linalg.LinAlgError:
            self._record_suggest(trial_id, strategy="random_fallback",
                                 n_obs=len(self._history),
                                 reason="gp_cholesky_failed")
            return base
        cands = self._rng.uniform(0, 1, size=(self.n_candidates, X.shape[1]))
        mean, std = gp.predict(cands)
        best = y.max()
        z = (mean - best - self.xi) / std
        ei = (mean - best - self.xi) * _norm_cdf(z) + std * _norm_pdf(z)
        i = int(np.argmax(ei))
        self._record_suggest(trial_id, strategy="gp_ei",
                             n_obs=len(self._history), best_score=float(best),
                             ei=float(ei[i]), posterior_mean=float(mean[i]),
                             posterior_std=float(std[i]))
        return self._decode_into(cands[i], base)

    def state_dict(self) -> Dict[str, Any]:
        return {"rng": self._rng.bit_generator.state,
                "history": [[dict(c), float(s)] for c, s in self._history],
                "count": self._count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._history = [(dict(c), float(s)) for c, s in state["history"]]
        self._count = int(state["count"])
