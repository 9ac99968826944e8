"""Stack assembly: segments of repeated layer groups.

Counterpart of ``repro.models.transformer``.  A *segment* is
(block_types, n_repeats): dense models are one segment (("attention",), L).
The stack is ``stack[segment][block_type][repeat]``, a nest of
``nn.ModuleList``s; ``apply_stack`` loops over the repeat axis in Python
where JAX runs ``lax.scan`` over stacked parameters.  Caches keep JAX's
layout (stacked on the repeat axis) and are updated in place.

Block kinds: ``attention`` (GQA/MQA, optional SWA, dense MLP, or the MoE
layer for the moe family), ``local_attn`` (sliding-window attention + MLP,
hybrid), ``rglru`` (RG-LRU temporal block + MLP, hybrid) and ``rwkv6``
(time-mix + channel-mix).
Recurrent states are nested dicts (rwkv6: ``{"tm": {prev, wkv}, "cm":
{prev}}``; rglru: ``{h, conv}``), stacked on the repeat axis like the caches.
With ``cfg.remat`` a training pass rematerialises each repeat of a segment in
the backward (``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` on the
scan body does.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain, gathered, replicated_like
from . import kvcache as kv
from . import layers as L
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv6_mod
from .config import ModelConfig


# -- static structure -------------------------------------------------------------

def segment_specs(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    pattern = cfg.pattern_for_layers()
    period = len(cfg.block_pattern) if cfg.block_pattern else 1
    n_full = len(pattern) // period
    segs: List[Tuple[Tuple[str, ...], int]] = []
    if n_full:
        segs.append((tuple(pattern[:period]), n_full))
    rem = len(pattern) - n_full * period
    if rem:
        segs.append((tuple(pattern[n_full * period:]), 1))
    return segs


class Repeat(NamedTuple):
    """One repeat of a segment (JAX's scan body): repeat ``index`` of
    segment ``segment``, whose blocks are of ``types``."""
    segment: int
    index: int
    types: Tuple[str, ...]

    @property
    def prefixes(self) -> Tuple[str, ...]:
        """The names of its blocks' parameters in the stack start with these."""
        return tuple(f"{self.segment}.{bi}.{self.index}." for bi in range(len(self.types)))

    def apply(self, stack: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, states=None, mode: str = "train",
              remat: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``_apply_repeat`` on its blocks of ``stack`` (states None: no
        caches); with ``remat`` under ``torch.utils.checkpoint``."""
        blocks = [stack[self.segment][bi][self.index] for bi in range(len(self.types))]
        states = [None] * len(self.types) if states is None else states
        if remat:
            return checkpoint(_apply_repeat, blocks, cfg, self.types, x, positions, states,
                              mode, use_reentrant=False)
        return _apply_repeat(blocks, cfg, self.types, x, positions, states, mode)


def stack_repeats(cfg: ModelConfig) -> List[Repeat]:
    """Every repeat of every segment, in the order the stack runs them."""
    return [Repeat(si, r, types) for si, (types, n) in enumerate(segment_specs(cfg))
            for r in range(n)]


# -- init ----------------------------------------------------------------------------

class Block(nn.Module):
    """``_init_block``: norm1, then tm (rwkv6), rglru (rglru) or attn
    (attention / local_attn); norm2, then cm (rwkv6), moe (attention blocks
    of the moe family) or mlp."""

    def __init__(self, cfg: ModelConfig, block_type: str, generator, device):
        super().__init__()
        self.norm1 = L.Norm(cfg.d_model, cfg, device)
        if block_type == "rwkv6":
            self.tm = rwkv6_mod.TimeMix(cfg, generator, device)
        elif block_type == "rglru":
            self.rglru = rglru_mod.RGLRU(cfg, generator, device)
        else:
            self.attn = L.Attention(cfg, generator, device)
        self.norm2 = L.Norm(cfg.d_model, cfg, device)
        if block_type == "rwkv6":
            self.cm = rwkv6_mod.ChannelMix(cfg, generator, device)
        elif block_type in ("attention", "local_attn") and cfg.family == "moe":
            self.moe = moe_mod.MoELayer(cfg, generator, device)
        else:
            self.mlp = L.MLP(cfg, generator, device)


def init_stack(generator, cfg: ModelConfig, device) -> nn.ModuleList:
    """Per-segment params: ``stack[segment][block_type][repeat]``, aligned
    with segment_specs(cfg)."""
    return nn.ModuleList(
        nn.ModuleList(
            nn.ModuleList(Block(cfg, btype, generator, device) for _ in range(n))
            for btype in types)
        for types, n in segment_specs(cfg))


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> List[Any]:
    """Decode caches, segment-aligned, stacked along the repeat axis."""
    caches = []
    for types, n in segment_specs(cfg):
        seg = []
        for btype in types:
            one = kv.init_block_state(cfg, btype, batch, max_len, device)
            seg.append(_tree_map(lambda x: torch.stack([x] * n), one))
        caches.append(seg)
    return caches


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nest of dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix: Tuple[str, ...] = ()):
    """(path, tensor) of every tensor of a nest of dicts, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _write(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy a block's new state into its cache views, leaf by leaf."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


# -- forward ---------------------------------------------------------------------------

def _apply_block(bp: Block, cfg: ModelConfig, btype: str, x: torch.Tensor,
                 positions: torch.Tensor, state: Optional[Dict[str, torch.Tensor]],
                 mode: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x_out, aux_loss); the aux loss is None for a block without
    MoE (JAX's zero, without a launch on the card).  ``state`` (this layer's
    cache views) is updated in place."""
    if btype == "rwkv6":
        h, tm_state = rwkv6_mod.apply_time_mix(bp.tm, bp.norm1(x), cfg,
                                               state["tm"] if state else None)
        x = constrain(x + h)   # a DTensor's partial sums (a split fan-in) summed here
        h, cm_state = rwkv6_mod.apply_channel_mix(bp.cm, bp.norm2(x), cfg,
                                                  state["cm"] if state else None)
        if state is not None:
            _write(state, {"tm": tm_state, "cm": cm_state})
        return x + h, None
    if btype == "rglru":
        h, new_state = rglru_mod.apply_rglru_block(bp.rglru, bp.norm1(x), cfg, state)
        if state is not None:
            _write(state, new_state)
        x = constrain(x + h)
        return x + bp.mlp(bp.norm2(x)), None

    # attention / local_attn
    window = cfg.sliding_window if (btype == "local_attn" or cfg.sliding_window) else None
    causal = not cfg.encoder_only
    xn = bp.norm1(x)
    if state is None:  # train: plain self-attention
        h, _ = bp.attn(xn, cfg, positions, causal=causal, window=window)
    elif mode == "prefill":
        # self-attention over the prompt + write (the tail of) k/v to the cache
        h, (k_new, v_new) = bp.attn(xn, cfg, positions, causal=causal, window=window)
        kv.update_attn_cache(state, k_new, v_new, positions)
    else:  # decode: write this step's k/v, then attend against the cache
        q, k_new, v_new = bp.attn.project_qkv(xn, cfg, positions)
        kv.update_attn_cache(state, k_new, v_new, positions)
        (k_all, v_all), kpos = kv.attn_cache_views(state, x.shape[0])
        out = L.attend(q, k_all, v_all, positions, kpos, cfg, causal=causal, window=window)
        h = bp.attn.project_out(out)
    x = constrain(x + h)
    if cfg.family == "moe":
        h2, aux = moe_mod.apply_moe_layer(bp.moe, bp.norm2(x), cfg)
        return x + h2, aux
    return x + bp.mlp(bp.norm2(x)), None


def apply_stack(stack: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, caches: Optional[List[Any]] = None,
                mode: str = "train") -> Tuple[torch.Tensor, Optional[List[Any]], torch.Tensor]:
    """Run all segments. mode: train | prefill | decode.

    train:   caches must be None; returns (x, None, aux)
    prefill: caches are fresh; returns (x, caches filled in place, aux)
    decode:  x is (B, 1, D); caches updated in ring fashion, in place
    aux is the sum of the blocks' MoE aux losses (0 without MoE blocks).
    """
    aux_total = replicated_like(torch.zeros((), dtype=torch.float32, device=x.device), x)
    remat = cfg.remat and mode == "train"
    for rep in stack_repeats(cfg):
        states = None if caches is None else \
            [_tree_map(lambda t: t[rep.index], caches[rep.segment][bi])
             for bi in range(len(rep.types))]
        x, aux = rep.apply(stack, cfg, x, positions, states, mode, remat)
        if aux is not None:
            aux_total = aux_total + aux
    return x, caches, aux_total


def _apply_repeat(blocks, cfg: ModelConfig, types, x: torch.Tensor, positions: torch.Tensor,
                  states, mode: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One repeat of a segment (JAX's scan body): its blocks in order.
    Returns (x, the sum of their aux losses or None)."""
    aux_total = None
    for block, btype, st in zip(blocks, types, states):
        with gathered(block):   # a sharded block's weights, FSDP-gathered for its use
            x, aux = _apply_block(block, cfg, btype, x, positions, st, mode)
        x = constrain(x)   # pin batch sharding at every block boundary
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total
