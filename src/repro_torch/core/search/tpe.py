"""Tree-structured Parzen Estimator — HyperOpt's algorithm (Bergstra et al. 2013).

The paper integrates HyperOpt as a suggestion source (Table 1: 137 LoC).  We
implement TPE from scratch (numpy only — no scipy/hyperopt available offline):

  - observations are split at quantile gamma into "good" (l) and "bad" (g);
  - continuous dims: Parzen KDE (Gaussian mixture centred on observations,
    bandwidth per Scott's rule, truncated to the domain);
  - categorical/int dims: smoothed categorical counts;
  - EI is maximized by sampling n_ei_candidates from l(x) and picking
    argmax l(x)/g(x).

Supports Uniform, LogUniform, RandInt, Categorical domains; other domain types
fall back to prior sampling.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .basic import Searcher
from .space import Categorical, Domain, LogUniform, RandInt, Uniform, sample_space

__all__ = ["TPESearcher"]


def _norm_pdf(x: np.ndarray, mu: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    z = (x[:, None] - mu[None, :]) / sigma[None, :]
    return np.exp(-0.5 * z * z) / (sigma[None, :] * math.sqrt(2 * math.pi))


class _ParzenEstimator:
    """1-D Parzen estimator over a (possibly log-) bounded continuous domain."""

    def __init__(self, obs: np.ndarray, low: float, high: float, log: bool):
        self.log = log
        self.low, self.high = (math.log(low), math.log(high)) if log else (low, high)
        pts = np.log(obs) if log else np.asarray(obs, dtype=float)
        # prior component: uniform-ish wide Gaussian at the domain centre
        centre = 0.5 * (self.low + self.high)
        width = self.high - self.low
        self.mu = np.concatenate([[centre], pts])
        n = len(self.mu)
        # HyperOpt-style adaptive bandwidths: each point's sigma is its max
        # gap to the neighbouring points (sorted), clipped to sane bounds —
        # dense clusters get narrow kernels so the estimator concentrates.
        order = np.argsort(self.mu)
        sorted_mu = self.mu[order]
        gaps = np.empty(n)
        if n > 1:
            left = np.diff(sorted_mu, prepend=sorted_mu[0] - width)
            right = np.diff(sorted_mu, append=sorted_mu[-1] + width)
            gaps[order] = np.maximum(left, right)
        else:
            gaps[:] = width
        lo_bw = width / max(100.0, 10.0 * n)
        self.sigma = np.clip(gaps, lo_bw, width)
        self.sigma[0] = width  # broad prior

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(0, len(self.mu), size=n)
        raw = rng.normal(self.mu[idx], self.sigma[idx])
        raw = np.clip(raw, self.low, self.high)
        return np.exp(raw) if self.log else raw

    def log_pdf(self, x: np.ndarray) -> np.ndarray:
        pts = np.log(x) if self.log else np.asarray(x, dtype=float)
        dens = _norm_pdf(pts, self.mu, self.sigma).mean(axis=1)
        return np.log(np.maximum(dens, 1e-300))


class _CategoricalEstimator:
    def __init__(self, obs_idx: List[int], n_choices: int, prior_weight: float = 1.0):
        counts = np.full(n_choices, prior_weight)
        for i in obs_idx:
            counts[i] += 1.0
        self.probs = counts / counts.sum()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(len(self.probs), size=n, p=self.probs)

    def log_pdf(self, idx: np.ndarray) -> np.ndarray:
        return np.log(self.probs[idx.astype(int)])


class TPESearcher(Searcher):
    def __init__(
        self,
        space: Dict[str, Any],
        metric: str = "loss",
        mode: str = "min",
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        n_ei_candidates: int = 24,
        max_trials: int = 0,
        seed: int = 0,
    ):
        super().__init__(space, metric, mode)
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_ei = n_ei_candidates
        self.max_trials = max_trials
        self._rng = np.random.default_rng(seed)
        self._history: List[Tuple[Dict[str, Any], float]] = []  # (config, score↑)
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._count = 0

    # -- observation ---------------------------------------------------------------
    def observe(self, trial_id, config, value, final) -> None:
        if final:
            self._history.append((config, self._score(value)))
            self._pending.pop(trial_id, None)

    # -- suggestion ----------------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self.max_trials and self._count >= self.max_trials:
            return None
        self._count += 1
        if len(self._history) < self.n_startup:
            cfg = sample_space(self.space, self._rng)
            self._record_suggest(trial_id, strategy="random_startup",
                                 n_obs=len(self._history),
                                 n_startup=self.n_startup)
        else:
            cfg = self._suggest_tpe()
            n_good = max(1, int(np.ceil(self.gamma * len(self._history))))
            self._record_suggest(trial_id, strategy="tpe",
                                 n_obs=len(self._history), n_good=n_good,
                                 n_bad=len(self._history) - n_good,
                                 gamma=self.gamma)
        self._pending[trial_id] = cfg
        return cfg

    def state_dict(self) -> Dict[str, Any]:
        return {"rng": self._rng.bit_generator.state,
                "history": [[dict(c), float(s)] for c, s in self._history],
                "pending": {tid: dict(c) for tid, c in self._pending.items()},
                "count": self._count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._history = [(dict(c), float(s)) for c, s in state["history"]]
        self._pending = {str(tid): dict(c)
                         for tid, c in state["pending"].items()}
        self._count = int(state["count"])

    def _split(self) -> Tuple[List[Dict], List[Dict]]:
        ranked = sorted(self._history, key=lambda cv: cv[1], reverse=True)
        n_good = max(1, int(np.ceil(self.gamma * len(ranked))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or [c for c, _ in ranked[n_good - 1:]]
        return good, bad

    def _suggest_tpe(self) -> Dict[str, Any]:
        good, bad = self._split()
        out: Dict[str, Any] = {}
        for key, spec in self.space.items():
            if isinstance(spec, dict):
                raise ValueError("TPESearcher supports flat spaces; nest-free keys only")
            if not isinstance(spec, Domain):
                out[key] = spec
                continue
            g_obs = [c[key] for c in good if key in c]
            b_obs = [c[key] for c in bad if key in c]
            out[key] = self._suggest_dim(spec, g_obs, b_obs)
        return out

    def _suggest_dim(self, spec: Domain, g_obs: List, b_obs: List):
        rng = self._rng
        if isinstance(spec, (Uniform, LogUniform)) and g_obs and b_obs:
            log = isinstance(spec, LogUniform)
            l_est = _ParzenEstimator(np.asarray(g_obs, float), spec.low, spec.high, log)
            g_est = _ParzenEstimator(np.asarray(b_obs, float), spec.low, spec.high, log)
            cands = l_est.sample(rng, self.n_ei)
            score = l_est.log_pdf(cands) - g_est.log_pdf(cands)
            return float(cands[int(np.argmax(score))])
        if isinstance(spec, RandInt) and g_obs and b_obs:
            lo, hi = spec.low, spec.high
            l_est = _ParzenEstimator(np.asarray(g_obs, float) + 0.5, lo, hi, False)
            g_est = _ParzenEstimator(np.asarray(b_obs, float) + 0.5, lo, hi, False)
            cands = l_est.sample(rng, self.n_ei)
            score = l_est.log_pdf(cands) - g_est.log_pdf(cands)
            return int(np.clip(round(cands[int(np.argmax(score))] - 0.5), lo, hi - 1))
        if isinstance(spec, Categorical) and g_obs:
            values = list(spec.values)
            gi = [values.index(v) for v in g_obs if v in values]
            bi = [values.index(v) for v in b_obs if v in values]
            l_est = _CategoricalEstimator(gi, len(values))
            g_est = _CategoricalEstimator(bi, len(values))
            cands = l_est.sample(rng, self.n_ei)
            score = l_est.log_pdf(cands) - g_est.log_pdf(cands)
            return values[int(cands[int(np.argmax(score))])]
        return spec.sample(rng)
