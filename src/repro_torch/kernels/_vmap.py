"""Folding helpers for the kernels' ``vmap`` rules.

A rule receives each input with its lane axis at ``dim`` (None: the input
is not batched, so every lane reads the same one), folds the lanes into an
axis the kernel already iterates over, launches once, and hands the outputs
back with the lanes split out of that axis again.  Which axis takes the
lanes is the kernel's choice: the batch axis (K1, K3), the head axis (K2,
whose ``u`` is one per head) or the row axes (K4).  Each helper passes an
absent optional input or output (None) through.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["lanes_first", "fold", "unfold", "fold_at", "unfold_at"]


def lanes_first(x: Optional[torch.Tensor], dim: Optional[int], n: int):
    """``x`` with its lane axis first: (n, ...).  Unbatched, it is expanded
    to every lane (a view)."""
    if x is None:
        return None
    return x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)


def fold(x: Optional[torch.Tensor], dim: Optional[int], n: int):
    """The lanes folded into the batch axis: (n, B, ...) -> (n*B, ...),
    lane-major.  A reshape that cannot view copies."""
    x = lanes_first(x, dim, n)
    return None if x is None else x.reshape(n * x.shape[1], *x.shape[2:])


def unfold(x: Optional[torch.Tensor], n: int):
    """``fold``'s inverse on an output: (n*B, ...) -> (n, B, ...), a view."""
    return None if x is None else x.reshape(n, x.shape[0] // n, *x.shape[1:])


def fold_at(x: Optional[torch.Tensor], dim: Optional[int], n: int, axis: int):
    """The lanes folded into axis ``axis`` of each lane's tensor: (..., H,
    ...) of n lanes -> (..., n*H, ...), lane-major.  A copy unless the lanes
    already sit just before that axis."""
    if x is None:
        return None
    if dim is None:
        x = x.unsqueeze(axis).expand(*x.shape[:axis], n, *x.shape[axis:])
    else:
        x = x.movedim(dim, axis)
    return x.reshape(*x.shape[:axis], n * x.shape[axis + 1], *x.shape[axis + 2:])


def unfold_at(x: Optional[torch.Tensor], n: int, axis: int):
    """``fold_at``'s inverse on an output: (..., n*H, ...) -> (..., n, H,
    ...), a view whose lane axis is ``axis``."""
    if x is None:
        return None
    return x.reshape(*x.shape[:axis], n, x.shape[axis] // n, *x.shape[axis + 1:])
