"""Train / eval steps: loss + grad + optimizer apply, with optional
gradient-accumulation microbatching.

Counterpart of ``repro.train.train_step``.  A ``TrainState`` holds the model
(an ``LM`` module), the optimizer state and the step count; ``train_step``
takes gradients with ``torch.autograd.grad`` (the module's ``.grad`` fields
are never used), applies the optimizer, which updates the parameters in
place, and returns the new state.  JAX jit-compiles the step; PyTorch runs it
eagerly.  A state placed by ``dist.sharding.shard_train_state`` steps the
same way, every rank running the step on DTensors: each gradient is
redistributed to its parameter's placements before the update (JAX's
``out_shardings``), and the metrics come back as plain tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..dist import sharding
from ..dist.sharding import full_value, placed_like
from ..models import LM, ModelConfig, forward_train, init_params
from .optimizer import Optimizer, global_norm

__all__ = ["TrainState", "make_train_state", "make_train_step", "make_eval_step"]

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: LM
    opt_state: Any
    step: int


def make_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     opt: Optimizer, device="cuda") -> TrainState:
    params = init_params(generator, cfg, resolve_device(device))
    return TrainState(params=params, opt_state=opt.init(dict(params.named_parameters())),
                      step=0)


def make_train_step(cfg: ModelConfig, opt: Optimizer, microbatch: int = 0):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatch`` > 1 splits the per-call batch into that many accumulation
    slices along axis 0, run one after another (live activation memory at
    1/microbatch of the batch's); gradients, loss and metrics are their
    mean."""

    def single(params: LM, batch: Batch):
        loss, metrics = forward_train(params, batch, cfg)
        names, tensors = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else placed_like(g, p)
                 for n, p, g in zip(names, tensors, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def accumulated(params: LM, batch: Batch):
        def slice_batch(i):
            return {k: sharding.microbatch(x, microbatch, i) for k, x in batch.items()}

        loss, metrics, grads = single(params, slice_batch(0))
        for i in range(1, microbatch):
            loss_i, metrics_i, grads_i = single(params, slice_batch(i))
            grads = {k: grads[k] + grads_i[k] for k in grads}
            loss = loss + loss_i
            metrics = {k: metrics[k] + metrics_i[k] for k in metrics}
        inv = 1.0 / microbatch
        return (loss * inv, {k: v * inv for k, v in metrics.items()},
                {k: g * inv for k, g in grads.items()})

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        if microbatch and microbatch > 1:
            loss, metrics, grads = accumulated(state.params, batch)
        else:
            loss, metrics, grads = single(state.params, batch)
        _, new_opt = opt.update(grads, state.opt_state, dict(state.params.named_parameters()))
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        metrics["total_loss"] = loss
        metrics = {k: full_value(v) for k, v in metrics.items()}
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params: LM, batch: Batch):
        _, metrics = forward_train(params, batch, cfg)
        return metrics
    return eval_step
