"""Plain PyTorch versions of the kernels (the allclose ground truth).

Each mirrors its kernel's exact contract (shapes, dtypes, masking rules) with
straightforward tensor code: no blocking, no online softmax.  On a CPU tensor
the kernel wrappers in ``ops.py`` run these; on the card they are what each
kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Sk,K,hd); q_pos (B,Sq); k_pos (B,Sk) -> (B,Sq,H,hd).

    GQA via head grouping; invalid cache slots are k_pos < 0.  A row whose
    keys are all masked returns 0."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    d = q_pos[:, :, None] - k_pos[:, None, :]
    ok = k_pos[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    logits = logits.masked_fill(~ok[:, None, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m.clamp_min(-1e30))
    l = p.sum(dim=-1, keepdim=True)
    w = p / l.clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
