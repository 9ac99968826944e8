"""Optimizers and LR schedules, written out as ``repro.train.optimizer``
writes them (not through ``torch.optim``), so that the port's numbers follow
the reference's.

Counterpart of ``repro.train.optimizer``.  An ``Optimizer`` is an (init,
update) pair like optax.  Parameters, gradients and moments are dicts of
tensors keyed by parameter name (``dict(model.named_parameters())``).  Where
JAX returns new arrays, ``update`` writes the new parameters into the given
tensors in place (under ``torch.no_grad``), which saves a copy of the model,
and returns them with the new state.  AdamW keeps fp32 master moments
whatever the parameter dtype.  Schedules and bias corrections are computed in
fp32 on the host, as JAX computes them in fp32, and enter the update as
numbers, so a step never waits on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "Optimizer", "adamw", "sgd", "global_norm", "clip_by_global_norm",
    "cosine_schedule", "linear_warmup_cosine", "constant_schedule",
]

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        t = torch.clamp(step.float() / max(total_steps, 1), max=1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)
    def fn(step):
        s = step.float()
        warm = lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(torch.clamp(s - warmup, min=0)))
    return fn


def _lr(sched: Schedule, step: int) -> float:
    """The schedule at ``step`` (an int), as the fp32 number JAX computes."""
    return float(sched(torch.tensor(step, dtype=torch.int32)))


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def clip_by_global_norm(tree: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]  # (grads, state, params)


def _bias_correction(b: float, step: int) -> float:
    """1 - b ** step in fp32, as JAX computes it."""
    return float(1.0 - torch.tensor(b, dtype=torch.float32) ** torch.tensor(float(step)))


def adamw(
    schedule: Schedule | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: Optional[float] = 1.0,
    moment_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """``moment_dtype=torch.bfloat16`` halves optimizer-state memory
    (8-bit-Adam-style trade, coarser: moments round-trip through bf16
    between steps)."""
    sched = constant_schedule(schedule) if isinstance(schedule, (int, float)) else schedule

    def init(params: Tensors):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return {"step": 0, "m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state["step"] + 1
        lr = _lr(sched, step)
        c1, c2 = _bias_correction(b1, step), _bias_correction(b2, step)
        new_m, new_v = {}, {}
        for k, p in params.items():
            g32 = grads[k].float()
            m32 = b1 * state["m"][k].float() + (1 - b1) * g32
            v32 = b2 * state["v"][k].float() + (1 - b2) * g32 * g32
            mhat = m32 / c1
            vhat = v32 / c2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            new_m[k], new_v[k] = m32.to(moment_dtype), v32.to(moment_dtype)
        return params, {"step": step, "m": new_m, "v": new_v}

    return Optimizer(init=init, update=update)


def sgd(
    schedule: Schedule | float,
    momentum: float = 0.9,
    nesterov: bool = False,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    sched = constant_schedule(schedule) if isinstance(schedule, (int, float)) else schedule

    def init(params: Tensors):
        return {"step": 0, "mom": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                   for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: Tensors, state, params: Tensors):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state["step"] + 1
        lr = _lr(sched, step)
        mom = {}
        for k, p in params.items():
            g32 = grads[k].float() + weight_decay * p.float()
            m = momentum * state["mom"][k] + g32
            d = g32 + momentum * m if nesterov else m
            p.copy_((p.float() - lr * d).to(p.dtype))
            mom[k] = m
        return params, {"step": step, "mom": mom}

    return Optimizer(init=init, update=update)
