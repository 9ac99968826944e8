"""ctypes wrappers of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``) and its
backward (``csrc/rglru_scan_bwd.cu``), and ``RGLRUScanFn``, the two joined
for autograd, with ``RGLRUScanBwdFn`` for its backward; both have ``vmap``
rules that launch once for all lanes.

Each checks what its kernel takes, allocates its outputs and launches on
PyTorch's current stream without synchronising.  Inputs that are already
contiguous (the model's are) are not copied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, _vmap

__all__ = ["rglru_scan_cuda", "rglru_scan_bwd_cuda", "RGLRUScanFn", "RGLRUScanBwdFn"]


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
    """The forward with its backward, for tensors that need a gradient or
    that a ``torch.func`` transform wraps (``ops.rglru_scan`` routes them
    here).  The forward keeps a, h0 and its output h; the backward runs
    ``RGLRUScanBwdFn`` and returns a gradient only where one is needed.
    Under ``torch.func.vmap`` the ``vmap`` rule folds the lanes into the
    batch axis (an unbatched input expanded, an ``h0`` of None kept None)
    and launches once for all of them: each thread owns one (batch row,
    channel), so each lane is its own call bit for bit.  Both passes go
    through ``ops`` (``ops._rglru_scan``, ``ops.rglru_scan_bwd``), which
    count the launches and run the plain version for a CPU tensor."""

    @staticmethod
    def forward(a, b, h0):
        from . import ops   # ops imports this module
        return ops._rglru_scan(a, b, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, _, h0 = inputs
        ctx.save_for_backward(a, h0, output)

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        da, db, dh0 = RGLRUScanBwdFn.apply(a, h0, h, dh)
        need = ctx.needs_input_grad
        return (da if need[0] else None, db if need[1] else None,
                dh0 if need[2] else None)

    @staticmethod
    def vmap(info, in_dims, a, b, h0):
        n = info.batch_size
        folded = (_vmap.fold(x, d, n) for x, d in zip((a, b, h0), in_dims))
        return _vmap.unfold(RGLRUScanFn.apply(*folded), n), 0


class RGLRUScanBwdFn(torch.autograd.Function):
    """K3's backward as a function of its own, so that ``torch.func`` can
    carry it: its ``vmap`` rule folds the lanes of a, h0, h and dh into the
    batch axis, as ``RGLRUScanFn``'s does, and launches once.  It has no
    backward."""

    @staticmethod
    def forward(a, h0, h, dh):
        from . import ops
        return ops.rglru_scan_bwd(a, h0, h, dh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the RG-LRU scan's backward has no backward of its own: a double "
                           "backward through ops.rglru_scan is not supported")

    @staticmethod
    def vmap(info, in_dims, a, h0, h, dh):
        n = info.batch_size
        folded = (_vmap.fold(x, d, n) for x, d in zip((a, h0, h, dh), in_dims))
        grads = tuple(_vmap.unfold(g, n) for g in RGLRUScanBwdFn.apply(*folded))
        return grads, (0, 0, None if grads[2] is None else 0)
