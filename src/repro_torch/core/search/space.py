"""Search-space DSL.

The paper (§4.3) provides "a small DSL to specify hyperparameter variations",
offering "features similar to those provided by HyperOpt".  We implement the
same surface: ``grid_search`` for exhaustive axes and a family of stochastic
domains (``choice``, ``uniform``, ``loguniform``, ``randint``, ``qrandint``,
``normal``, ``sample_from``) for random/suggested sampling.

A *space* is a (possibly nested) dict mapping hyperparameter names to either
constants, ``Domain`` instances, or ``grid_search([...])`` markers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

__all__ = [
    "Domain",
    "Categorical",
    "Uniform",
    "LogUniform",
    "RandInt",
    "QRandInt",
    "Normal",
    "Function",
    "GridSearch",
    "grid_search",
    "choice",
    "uniform",
    "loguniform",
    "randint",
    "qrandint",
    "normal",
    "sample_from",
    "sample_space",
    "space_signature",
]


class Domain:
    """Base class for stochastic hyperparameter domains."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    # -- Introspection used by searchers (TPE) -------------------------------
    def is_continuous(self) -> bool:
        return False


@dataclass(frozen=True)
class Categorical(Domain):
    values: tuple

    def sample(self, rng: np.random.Generator) -> Any:
        return self.values[int(rng.integers(0, len(self.values)))]


@dataclass(frozen=True)
class Uniform(Domain):
    low: float
    high: float

    def __post_init__(self):
        if not self.low < self.high:
            raise ValueError(f"uniform requires low < high, got [{self.low}, {self.high})")

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.low, self.high))

    def is_continuous(self) -> bool:
        return True


@dataclass(frozen=True)
class LogUniform(Domain):
    low: float
    high: float

    def __post_init__(self):
        if self.low <= 0:
            raise ValueError("loguniform requires low > 0")
        if not self.low < self.high:
            raise ValueError(f"loguniform requires low < high, got [{self.low}, {self.high})")

    def sample(self, rng: np.random.Generator) -> float:
        return float(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))

    def is_continuous(self) -> bool:
        return True


@dataclass(frozen=True)
class RandInt(Domain):
    low: int
    high: int  # exclusive

    def __post_init__(self):
        if not self.low < self.high:
            raise ValueError(f"randint requires low < high, got [{self.low}, {self.high})")

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.low, self.high))


@dataclass(frozen=True)
class QRandInt(Domain):
    low: int
    high: int
    q: int = 1

    def sample(self, rng: np.random.Generator) -> int:
        v = int(rng.integers(self.low, self.high))
        return int(round(v / self.q) * self.q)


@dataclass(frozen=True)
class Normal(Domain):
    mean: float
    std: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.normal(self.mean, self.std))

    def is_continuous(self) -> bool:
        return True


@dataclass(frozen=True)
class Function(Domain):
    """``sample_from`` — arbitrary user callable (optionally config-dependent)."""

    fn: Callable

    def sample(self, rng: np.random.Generator, config: Dict[str, Any] | None = None) -> Any:
        try:
            return self.fn(config or {})
        except TypeError:
            return self.fn()


@dataclass(frozen=True)
class GridSearch:
    """Exhaustive axis marker; the cross product of all grid axes is taken."""

    values: tuple


# -- public constructors ------------------------------------------------------

def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(tuple(values))


def choice(values: Sequence[Any]) -> Categorical:
    return Categorical(tuple(values))


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def qrandint(low: int, high: int, q: int = 1) -> QRandInt:
    return QRandInt(low, high, q)


def normal(mean: float, std: float) -> Normal:
    return Normal(mean, std)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


# -- sampling -----------------------------------------------------------------

def sample_space(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """Resolve one concrete config from ``space``.

    ``grid_search`` markers are NOT resolved here (use variants.generate_variants
    for the grid cross-product); passing one raises.
    ``sample_from`` functions are resolved last so they may read sampled values.
    """
    out: Dict[str, Any] = {}
    deferred: List[tuple] = []
    for key, spec in space.items():
        if isinstance(spec, GridSearch):
            raise ValueError(
                f"grid_search axis {key!r} must be resolved via generate_variants()"
            )
        if isinstance(spec, Function):
            deferred.append((key, spec))
        elif isinstance(spec, Domain):
            out[key] = spec.sample(rng)
        elif isinstance(spec, dict):
            out[key] = sample_space(spec, rng)
        else:
            out[key] = spec
    for key, spec in deferred:
        out[key] = spec.sample(rng, out)
    return out


def space_signature(space: Dict[str, Any]) -> List[str]:
    """Flat, sorted list of parameter paths — used by searchers to key models."""
    sig: List[str] = []

    def walk(prefix: str, node: Dict[str, Any]):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(path, v)
            else:
                sig.append(path)

    walk("", space)
    return sorted(sig)
