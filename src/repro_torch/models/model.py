"""Model entry points: init / train forward / encode / prefill / decode for
every family.

Counterpart of ``repro.models.model``.  ``init_params`` returns an ``LM``
module whose children carry the JAX tree's top-level names (``embed``,
``stack``, ``final_norm``, ``lm_head``, ``frontend``); ``forward_train``,
``forward_encode``, ``prefill`` and ``decode_step`` are functions over it,
as in JAX.  ``prefill`` and ``decode_step`` run without autograd and drop
the stack's MoE aux loss as JAX's do; ``forward_train`` and
``forward_encode`` keep the graph for a backward.

Modality frontends are stubs, as in JAX: ``audio_stub`` consumes
precomputed conv-feature frames (B, S, frontend_dim) through a linear
projection; ``vision_stub`` consumes precomputed patch embeddings
(B, P, frontend_dim) through a projector, prepended to the text token
embeddings (PaliGemma's prefix-LM layout).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..dist.sharding import constrain, gathered, policy_caches, replicated_like, whole_on
from . import layers as L
from . import transformer as T
from .config import ModelConfig

class Frontend(nn.Module):
    """JAX's ``params["frontend"]``: the stub frontend's projection
    ``proj``, frontend_dim -> d_model, drawn as ``_dense_init`` draws it
    (std 1/sqrt(frontend_dim))."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator], device):
        super().__init__()
        self.proj = L._linear(cfg.frontend_dim, cfg.d_model, cfg, generator, device)


class LM(nn.Module):
    """The parameter tree of ``repro.models.init_params`` as modules."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator], device):
        super().__init__()
        self.embed = L.Embedding(cfg, generator, device)
        self.stack = T.init_stack(generator, cfg, device)
        self.final_norm = L.Norm(cfg.d_model, cfg, device)
        self.lm_head = L.init_lm_head(cfg, generator, device)
        # drawn last, so that the other weights of a config draw as without it
        self.frontend = Frontend(cfg, generator, device) if cfg.frontend else None


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights from ``generator``, drawn on its device and placed on
    ``device``.  ``generator=None`` leaves them uninitialised (``convert.py``
    loads them)."""
    return LM(cfg, generator, resolve_device(device))


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# -- input embedding ---------------------------------------------------------------

def _embed_inputs(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d_model) in the activation dtype: the projected frames
    (``audio_stub``), the projected patches followed by the token embeddings
    (``vision_stub``), or the token embeddings."""
    with gathered(params.frontend):   # a sharded projection, FSDP-gathered for its use
        adt = L._dtype(cfg.activation_dtype)
        if cfg.frontend == "audio_stub":
            return F.linear(batch["features"].to(adt), params.frontend.proj.weight.to(adt))
        x = params.embed.embed_tokens(batch["tokens"], cfg)
        if cfg.frontend == "vision_stub":
            img = F.linear(batch["patch_embeds"].to(adt), params.frontend.proj.weight.to(adt))
            x = torch.cat([img, x], dim=1)
        return constrain(x)


def _positions(x: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions; replicated when ``x`` is a DTensor."""
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return replicated_like(pos, x)


def _logits(params: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    with gathered(params.embed, params.lm_head, params.final_norm):
        return L.lm_logits(params.embed, params.lm_head, params.final_norm(x), cfg)


# -- losses -------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE in fp32. Returns (loss, accuracy).  A DTensor's vocab
    dim is gathered first."""
    logits = whole_on(logits, -1)
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
    """Returns (total_loss, metrics).  batch needs family-appropriate inputs
    plus "labels" (and optional "loss_mask"); the graph is kept for the
    backward.  For ``vision_stub`` the loss covers the text after the image
    prefix: its P positions are dropped before the final norm and the head,
    which act on each position alone, so the logits are JAX's
    ``logits[:, P:]`` without computing the rest."""
    x = _embed_inputs(params, batch, cfg)
    x, _, aux = T.apply_stack(params.stack, cfg, x, _positions(x), None, mode="train")
    ce, acc = _head_loss(params, x, batch, cfg)
    return train_loss(ce, acc, aux, cfg)


def _head_loss(params: LM, x: torch.Tensor, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy, accuracy) of the stack's output ``x``."""
    if cfg.frontend == "vision_stub":
        x = x[:, batch["patch_embeds"].shape[1]:]
    return cross_entropy(_logits(params, x, cfg), batch["labels"], batch.get("loss_mask"))


def aux_loss_coef(cfg: ModelConfig) -> float:
    return cfg.moe.aux_loss_coef if cfg.moe else 0.0


def train_loss(ce: torch.Tensor, acc: torch.Tensor, aux: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``forward_train``'s (total_loss, metrics) from its cross-entropy,
    accuracy and the stack's aux loss."""
    return ce + aux_loss_coef(cfg) * aux, {"loss": ce, "aux_loss": aux, "accuracy": acc}


class TrainStage(NamedTuple):
    """A stage of ``forward_train``: ``fn(params, *xs)`` reads only the
    parameters whose names start with one of ``prefixes``."""
    prefixes: Tuple[str, ...]
    fn: Callable


def train_stages(cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[TrainStage, List[TrainStage], TrainStage]:
    """``forward_train`` cut where remat cuts it (JAX's ``jax.checkpoint``
    on each repeat of a segment): (the embedding, ``fn(params) -> x``; each
    repeat of each segment in order, ``fn(params, x) -> (x, aux or None)``;
    the head and the loss, ``fn(params, x) -> (ce, accuracy)``).  Chained,
    and with ``train_loss`` over the repeats' aux losses summed from 0 in
    order, they compute ``forward_train``'s values; a caller that
    differentiates each stage on its own keeps only each stage's input
    between the forward and the backward."""
    embed = TrainStage(("embed.", "frontend."), lambda params: _embed_inputs(params, batch, cfg))
    repeats = [TrainStage(tuple(f"stack.{p}" for p in rep.prefixes),
                          lambda params, x, rep=rep: rep.apply(params.stack, cfg, x,
                                                               _positions(x)))
               for rep in T.stack_repeats(cfg)]
    tied = ("embed.",) if cfg.tie_embeddings else ()
    head = TrainStage(("final_norm.", "lm_head.", *tied),
                      lambda params, x: _head_loss(params, x, batch, cfg))
    return embed, repeats, head


def forward_encode(params: LM, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> torch.Tensor:
    """Encoder-only / no-cache forward over the whole sequence (``mode=
    "train"``), returning the full logits (B, S, V); the graph is kept
    unless the caller turns autograd off."""
    x = _embed_inputs(params, batch, cfg)
    x, _, _ = T.apply_stack(params.stack, cfg, x, _positions(x), None, mode="train")
    return _logits(params, x, cfg)


@torch.no_grad()
def prefill(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: int) -> Tuple[torch.Tensor, List[Any]]:
    """Process a prompt, fill caches sized ``max_len``; return (last-token
    logits (B, V), caches).  A VLM prompt is its image prefix
    ("patch_embeds") followed by its "tokens"; ``max_len`` counts both."""
    x = _embed_inputs(params, batch, cfg)
    caches = policy_caches(T.init_caches(cfg, x.shape[0], max_len, x.device), x.shape[0])
    x, caches, _ = T.apply_stack(params.stack, cfg, x, _positions(x), caches, mode="prefill")
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


@torch.no_grad()
def decode_step(params: LM, caches: List[Any], tokens: torch.Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, List[Any]]:
    """One synchronized decode step.  tokens (B,) int, pos the step's position
    (after a VLM prompt it counts the image prefix).  Returns (logits (B, V), caches updated in place)."""
    x = params.embed.embed_tokens(tokens[:, None], cfg)
    B = x.shape[0]
    positions = replicated_like(
        torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device), x)
    x, caches, _ = T.apply_stack(params.stack, cfg, x, positions, caches, mode="decode")
    return _logits(params, x, cfg)[:, 0], caches
