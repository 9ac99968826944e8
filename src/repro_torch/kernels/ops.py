"""Public wrappers for the kernels.

Dispatch is by the device of the tensors and nothing else: a CPU tensor runs
the plain PyTorch version (``ref.py``), a CUDA tensor launches the hand-written
kernel or the call raises.  There is no fallback from one to the other.
``flash_attention.launches`` counts kernel launches, so that a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import ref

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Sk,K,hd); q_pos (B,Sq); k_pos (B,Sk) -> (B,Sq,H,hd).

    GQA maps head h to kv head h // (H/K); the mask comes from positions
    (causal, optional window, k_pos < 0 for an empty slot); optional tanh
    softcap.  A row with every key masked returns 0.  Any length is taken:
    the kernel masks ragged edges itself, so nothing is padded."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, softcap=softcap)
    out = _fa.flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
