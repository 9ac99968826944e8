"""Model entry points: init / prefill / decode for the dense, MoE, SSM
(rwkv6) and hybrid (RG-LRU + local attention) families.

Counterpart of ``repro.models.model``.  ``init_params`` returns an ``LM``
module whose children carry the JAX tree's top-level names (``embed``,
``stack``, ``final_norm``, ``lm_head``); ``prefill`` and ``decode_step`` are
functions over it, as in JAX, and drop the stack's MoE aux loss as JAX's
do.  The modality frontends raise ``NotImplementedError`` naming the
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
                                  "ported yet (ROADMAP Queue 1 item 10)")


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
