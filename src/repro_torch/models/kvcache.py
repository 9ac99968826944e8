"""Decode-time state: full KV caches, sliding-window (ring) caches, recurrent
states.

Counterpart of ``repro.models.kvcache``.  Decode is synchronized across the
batch (one global position).  Cache trees are built per *segment* (see
transformer.py): each leaf's leading axis is the segment's repeat count.

Where the JAX version is functional and returns new arrays, this one updates
the cache tensors in place (and returns the same dict): a layer's cache is a
view into its segment's stacked tensor, so a write lands in the stack.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..dist.sharding import placed_like
from . import rglru as rglru_mod
from . import rwkv6 as rwkv6_mod
from .config import ModelConfig


def init_block_state(cfg: ModelConfig, block_type: str, batch: int, max_len: int,
                     device) -> Dict[str, Any]:
    """Fresh decode state for one block.  max_len = cache capacity (full
    attention) or its bound (window); recurrent states ignore it."""
    if block_type == "rglru":
        return rglru_mod.init_state(cfg, batch, device)
    if block_type == "rwkv6":
        return rwkv6_mod.init_state(cfg, batch, device)
    if block_type == "attention":
        cap = max_len if cfg.sliding_window is None else min(cfg.sliding_window, max_len)
    elif block_type == "local_attn":
        cap = min(cfg.sliding_window or 2048, max_len)
    else:
        raise ValueError(f"unknown block type {block_type}")
    adt = getattr(torch, cfg.activation_dtype)
    K, hd = cfg.kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, cap, K, hd), dtype=adt, device=device),
        "v": torch.zeros((batch, cap, K, hd), dtype=adt, device=device),
        "kpos": torch.full((cap,), -1, dtype=torch.int32, device=device),
    }


def update_attn_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                      v_new: torch.Tensor, positions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write S_new freshly-computed (post-RoPE) k/v at their positions, in place.

    Ring-buffer semantics: slot = position % capacity.  For a full cache the
    capacity >= max sequence length so slots never collide; for a sliding
    window the oldest entries are overwritten — exactly the tokens that fell
    out of the window.  When writing more tokens than the capacity (window
    prefill) only the last ``cap`` are written, keeping the slots unique.
    """
    cap = cache["k"].shape[1]
    if k_new.shape[1] >= cap:
        k_new, v_new = k_new[:, -cap:], v_new[:, -cap:]
        pos_vec = positions[0, -cap:]
    else:
        pos_vec = positions[0]  # synchronized decode: same positions per batch row
    slots = (pos_vec % cap).long()
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    if isinstance(k, DTensor):
        # each rank writes its own shard: the new k/v placed as the cache is,
        # the slots whole (DTensor's own index_put_ differs between versions)
        k_new, v_new = (placed_like(t.to(k.dtype), k).to_local() for t in (k_new, v_new))
        k, v, kpos, slots, pos_vec = (t.to_local() for t in (k, v, kpos, slots, pos_vec))
    k[:, slots] = k_new.to(k.dtype)
    v[:, slots] = v_new.to(v.dtype)
    kpos[slots] = pos_vec.to(torch.int32)
    return cache


def attn_cache_views(cache: Dict[str, torch.Tensor],
                     batch: int) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Return ((k_all, v_all), k_positions (B, cap)) for attend()."""
    kpos = cache["kpos"][None, :].expand(batch, cache["kpos"].shape[0])
    return (cache["k"], cache["v"]), kpos
