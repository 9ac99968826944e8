"""Stack assembly: segments of repeated layer groups.

Counterpart of ``repro.models.transformer``.  A *segment* is
(block_types, n_repeats): dense models are one segment (("attention",), L).
The stack is ``stack[segment][block_type][repeat]``, a nest of
``nn.ModuleList``s; ``apply_stack`` loops over the repeat axis in Python
where JAX runs ``lax.scan`` over stacked parameters.  Caches keep JAX's
layout (stacked on the repeat axis) and are updated in place.

Block kinds ported so far: ``attention`` (GQA/MQA, optional SWA, dense MLP)
and ``local_attn``.  The MoE MLP, ``rglru`` and ``rwkv6`` raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import kvcache as kv
from . import layers as L
from .config import ModelConfig

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 7 (MoE family: models/moe.py)",
    "rwkv6": "ROADMAP Queue 1 item 8 (SSM family: models/rwkv6.py)",
    "rglru": "ROADMAP Queue 1 item 9 (hybrid family: models/rglru.py)",
}


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


# -- init ----------------------------------------------------------------------------

class Block(nn.Module):
    """``_init_block`` for attention / local_attn: norm1, attn, norm2, mlp."""

    def __init__(self, cfg: ModelConfig, block_type: str, generator, device):
        super().__init__()
        kind = "moe" if cfg.family == "moe" else block_type
        if kind in _NOT_PORTED:
            raise NotImplementedError(f"{kind} blocks are not ported yet: {_NOT_PORTED[kind]}")
        self.norm1 = L.Norm(cfg.d_model, cfg, device)
        self.attn = L.Attention(cfg, generator, device)
        self.norm2 = L.Norm(cfg.d_model, cfg, device)
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
            seg.append({k: torch.stack([x] * n) for k, x in one.items()})
        caches.append(seg)
    return caches


# -- forward ---------------------------------------------------------------------------

def _apply_block(bp: Block, cfg: ModelConfig, btype: str, x: torch.Tensor,
                 positions: torch.Tensor, state: Optional[Dict[str, torch.Tensor]],
                 mode: str) -> torch.Tensor:
    """Returns x_out; ``state`` (this layer's cache views) is updated in place."""
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
        B, S, H, hd = out.shape
        h = bp.attn.wo(out.reshape(B, S, H * hd))
    x = x + h
    return x + bp.mlp(bp.norm2(x))


def apply_stack(stack: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, caches: Optional[List[Any]] = None,
                mode: str = "train") -> Tuple[torch.Tensor, Optional[List[Any]]]:
    """Run all segments. mode: train | prefill | decode.

    train:   caches must be None; returns (x, None)
    prefill: caches are fresh; returns (x, caches filled in place)
    decode:  x is (B, 1, D); caches updated in ring fashion, in place
    (JAX also returns the MoE aux loss; no ported block has one.)
    """
    for si, (types, n) in enumerate(segment_specs(cfg)):
        for r in range(n):
            for bi, btype in enumerate(types):
                st = None
                if caches is not None:
                    st = {k: t[r] for k, t in caches[si][bi].items()}
                x = _apply_block(stack[si][bi][r], cfg, btype, x, positions, st, mode)
    return x, caches
