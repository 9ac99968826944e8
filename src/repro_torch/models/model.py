"""Model entry points: init / train forward / prefill / decode for the
dense, MoE, SSM (rwkv6) and hybrid (RG-LRU + local attention) families.

Counterpart of ``repro.models.model``.  ``init_params`` returns an ``LM``
module whose children carry the JAX tree's top-level names (``embed``,
``stack``, ``final_norm``, ``lm_head``); ``forward_train``, ``prefill`` and
``decode_step`` are functions over it, as in JAX.  ``prefill`` and
``decode_step`` run without autograd and drop the stack's MoE aux loss as
JAX's do; ``forward_train`` keeps the graph for the backward.  The modality frontends raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig

def _check_ported(cfg: ModelConfig) -> None:
    # The audio and vision frontends would otherwise be dropped silently.
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.arch_id}: the {cfg.frontend} frontend is not "
                                  "ported yet (ROADMAP Queue 1, 'Frontends and arch smoke')")


class LM(nn.Module):
    """The parameter tree of ``repro.models.init_params`` as modules."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator], device):
        super().__init__()
        self.embed = L.Embedding(cfg, generator, device)
        self.stack = T.init_stack(generator, cfg, device)
        self.final_norm = L.Norm(cfg.d_model, cfg, device)
        self.lm_head = L.init_lm_head(cfg, generator, device)


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights from ``generator``, drawn on its device and placed on
    ``device``.  ``generator=None`` leaves them uninitialised (``convert.py``
    loads them)."""
    _check_ported(cfg)
    return LM(cfg, generator, resolve_device(device))


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def _logits(params: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.lm_logits(params.embed, params.lm_head, params.final_norm(x), cfg)


# -- losses -------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE in fp32. Returns (loss, accuracy)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - gold
    correct = (logits.argmax(dim=-1) == labels).float()   # the first maximum, as jnp.argmax
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom, (correct * mask).sum() / denom


# -- forward passes -----------------------------------------------------------------

def forward_train(params: LM, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, metrics).  batch needs "tokens" and "labels"
    (and optional "loss_mask"); the graph is kept for the backward."""
    _check_ported(cfg)
    x = params.embed.embed_tokens(batch["tokens"], cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, _, aux = T.apply_stack(params.stack, cfg, x, positions, None, mode="train")
    logits = _logits(params, x, cfg)
    ce, acc = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    loss = ce + aux_coef * aux
    return loss, {"loss": ce, "aux_loss": aux, "accuracy": acc}


@torch.no_grad()
def prefill(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, List[Any]]:
    """Process a prompt, fill caches sized ``max_len``; return (last-token
    logits (B, V), caches)."""
    tokens = batch["tokens"]
    x = params.embed.embed_tokens(tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    caches = T.init_caches(cfg, B, max_len, x.device)
    x, caches, _ = T.apply_stack(params.stack, cfg, x, positions, caches, mode="prefill")
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


@torch.no_grad()
def decode_step(params: LM, caches: List[Any], tokens: torch.Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, List[Any]]:
    """One synchronized decode step.  tokens (B,) int, pos the step's position.
    Returns (logits (B, V), caches updated in place)."""
    x = params.embed.embed_tokens(tokens[:, None], cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    x, caches, _ = T.apply_stack(params.stack, cfg, x, positions, caches, mode="decode")
    return _logits(params, x, cfg)[:, 0], caches
