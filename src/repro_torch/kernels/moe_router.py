"""ctypes wrapper of the CUDA MoE router (``csrc/moe_router.cu``).

Checks what the kernel takes, allocates the weights and indices and
launches on PyTorch's current stream without synchronising.  Logits that are
already contiguous (the model's are) are not copied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

__all__ = ["moe_router_cuda", "DTYPES", "MAX_EXPERTS", "MAX_TOP_K"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS, MAX_TOP_K = 256, 8
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("moe_router").moe_router_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, P]      # logits w idx dtype T E k stream
    fn.restype = I
    return fn


def moe_router_cuda(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; same contract as ``ref.moe_router_ref``.

    Raises on anything the kernel does not take: a tensor off the card, a
    dtype other than float32/bfloat16, a shape other than (T, E) with T >= 1,
    more than ``MAX_EXPERTS`` experts, a ``top_k`` outside 1..min(8, E), or
    a launch that CUDA refuses."""
    if not logits.is_cuda:
        raise ValueError("moe_router_cuda takes CUDA tensors only")
    if logits.dtype not in DTYPES:
        raise ValueError(f"dtype {logits.dtype}: need one of {list(DTYPES)}")
    if logits.dim() != 2 or logits.shape[0] < 1:
        raise ValueError(f"logits {tuple(logits.shape)} must be (T, E) with T >= 1")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts: the kernel takes 1 to {MAX_EXPERTS}")
    if not 1 <= top_k <= min(MAX_TOP_K, E):
        raise ValueError(f"top_k {top_k}: the kernel takes 1 to min({MAX_TOP_K}, E={E})")
    if logits.numel() > _INT_MAX:
        raise ValueError("logits of more than 2**31 elements")
    logits = logits.contiguous()
    w = torch.empty((T, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _fn()(logits.data_ptr(), w.data_ptr(), idx.data_ptr(), DTYPES[logits.dtype],
                T, E, top_k, stream)
    if err != 0:
        raise RuntimeError(f"moe_router_fwd launch failed: cudaError_t {err}")
    return w, idx
