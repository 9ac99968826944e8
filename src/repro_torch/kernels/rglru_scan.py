"""ctypes wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

Checks what the kernel takes, allocates h and launches on PyTorch's current
stream without synchronising.  Inputs that are already contiguous (the
model's are) are not copied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["rglru_scan_cuda"]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("rglru_scan").rglru_scan_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, P]      # a b h0 h B S R stream
    fn.restype = I
    return fn


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel; same contract as ``ref.rglru_scan_ref``.

    Raises on anything the kernel does not take: a tensor off the card, a
    dtype other than float32, mismatched shapes, a batch above 65535, or a
    launch that CUDA refuses."""
    ts = (a, b) if h0 is None else (a, b, h0)
    if not all(t.is_cuda for t in ts):
        raise ValueError("rglru_scan_cuda takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("a, b and h0 must be on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"dtypes {[t.dtype for t in ts]}: the kernel takes float32")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be one (B,S,R)")
    B, S, R = a.shape
    if h0 is not None and h0.shape != (B, R):
        raise ValueError(f"h0 {tuple(h0.shape)} must be (B,R) = {(B, R)}")
    if B > 65535:
        raise ValueError(f"batch {B} above 65535")
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn()(a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None,
                h.data_ptr(), B, S, R, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd launch failed: cudaError_t {err}")
    return h
