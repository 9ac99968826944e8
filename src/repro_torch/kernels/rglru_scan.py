"""ctypes wrappers of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``) and its
backward (``csrc/rglru_scan_bwd.cu``), and ``RGLRUScanFn``, the two joined
for autograd.

Each checks what its kernel takes, allocates its outputs and launches on
PyTorch's current stream without synchronising.  Inputs that are already
contiguous (the model's are) are not copied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["rglru_scan_cuda", "rglru_scan_bwd_cuda", "RGLRUScanFn"]


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


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.load_library("rglru_scan_bwd").rglru_scan_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, I, I, I, P]   # a h0 h dh da db dh0 B S R stream
    fn.restype = I
    return fn


def rglru_scan_bwd_cuda(a: torch.Tensor, h0: Optional[torch.Tensor], h: torch.Tensor,
                        dh: torch.Tensor):
    """Launch the backward; same contract as ``ref.rglru_scan_bwd_ref``: a, h
    and dh (B,S,R), h0 (B,R) or None, all float32 on the card ->
    (da, db, dh0), dh0 None when h0 is None.  Raises as
    ``rglru_scan_cuda`` does."""
    ts = (a, h, dh) if h0 is None else (a, h, dh, h0)
    if not all(t.is_cuda for t in ts):
        raise ValueError("rglru_scan_bwd_cuda takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("a, h0, h and dh must be on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"dtypes {[t.dtype for t in ts]}: the kernel takes float32")
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)}, h {tuple(h.shape)} and dh {tuple(dh.shape)} "
                         "must be one (B,S,R)")
    B, S, R = a.shape
    if h0 is not None and h0.shape != (B, R):
        raise ValueError(f"h0 {tuple(h0.shape)} must be (B,R) = {(B, R)}")
    if B > 65535:
        raise ValueError(f"batch {B} above 65535")
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _bwd_fn()(a.data_ptr(), h0.data_ptr() if h0 is not None else None, h.data_ptr(),
                    dh.data_ptr(), da.data_ptr(), db.data_ptr(),
                    dh0.data_ptr() if dh0 is not None else None, B, S, R, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: cudaError_t {err}")
    return da, db, dh0


class RGLRUScanFn(torch.autograd.Function):
    """The CUDA forward with its CUDA backward, for CUDA tensors that need a
    gradient (``ops.rglru_scan`` routes them here).  The forward keeps a, h0
    and its output h; the backward runs ``ops.rglru_scan_bwd``, which counts
    its launches, and returns a gradient only where one is needed."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        from . import ops   # ops imports this module
        a, h0, h = ctx.saved_tensors
        da, db, dh0 = ops.rglru_scan_bwd(a, h0, h, dh)
        need = ctx.needs_input_grad
        return (da if need[0] else None, db if need[1] else None,
                dh0 if need[2] else None)
