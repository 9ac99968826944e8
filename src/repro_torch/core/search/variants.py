"""Grid-search resolution: expand ``grid_search`` axes into concrete variants.

Mirrors the paper's §4.3 example: a space with two 3- and 2-valued grid axes
produces the 3x2 cross product as the initial set of trials; all stochastic
domains within each variant are sampled ``num_samples`` times.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from .space import Domain, Function, GridSearch, sample_space

__all__ = ["generate_variants", "count_grid_variants", "format_variant_tag"]


def _find_grid_axes(space: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], GridSearch]]:
    axes = []
    for k, v in space.items():
        path = prefix + (k,)
        if isinstance(v, GridSearch):
            axes.append((path, v))
        elif isinstance(v, dict):
            axes.extend(_find_grid_axes(v, path))
    return axes


def _set_path(d: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    node = d
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _copy_space(space: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        out[k] = _copy_space(v) if isinstance(v, dict) else v
    return out


def count_grid_variants(space: Dict[str, Any]) -> int:
    n = 1
    for _, axis in _find_grid_axes(space):
        n *= len(axis.values)
    return n


def generate_variants(
    space: Dict[str, Any],
    num_samples: int = 1,
    seed: int | None = None,
) -> Iterator[Dict[str, Any]]:
    """Yield ``num_samples x prod(grid axes)`` concrete configs.

    Grid axes are expanded exhaustively; stochastic domains are re-sampled per
    variant so that ``num_samples > 1`` gives distinct random draws.
    """
    rng = np.random.default_rng(seed)
    axes = _find_grid_axes(space)
    axis_paths = [p for p, _ in axes]
    axis_values = [a.values for _, a in axes]
    for _ in range(num_samples):
        for combo in itertools.product(*axis_values) if axes else [()]:
            variant = _copy_space(space)
            for path, value in zip(axis_paths, combo):
                _set_path(variant, path, value)
            yield sample_space(variant, rng)


def format_variant_tag(config: Dict[str, Any], max_items: int = 4) -> str:
    """Short human-readable tag for a trial, e.g. ``lr=0.01,momentum=0.9``."""
    items = []
    for k, v in config.items():
        if isinstance(v, dict):
            continue
        if isinstance(v, float):
            items.append(f"{k}={v:.4g}")
        else:
            items.append(f"{k}={v}")
        if len(items) >= max_items:
            break
    return ",".join(items)
