"""ctypes wrappers of the CUDA MoE router (``csrc/moe_router.cu``) and its
backward (``csrc/moe_router_bwd.cu``), and ``MoERouterFn``, the two joined
for autograd, with ``MoERouterBwdFn`` for its backward; both have ``vmap``
rules that launch once for all lanes.

The host's work a forward call is kept to what a call must do, because the kernel
takes a few microseconds and runs once per MoE layer of every decode step:
- the (shape, dtype, top_k) check runs once per distinct key and is
  remembered (``plan``); the device is checked on every call;
- logits of any leading shape (..., E) are taken as they are, so the
  caller makes no reshape on the way in or out;
- one allocation holds both outputs, the fp32 weights then the int32
  indices, returned as two contiguous views; it is fresh on every call;
- the stream is read as a raw pointer, without building a ``Stream``;
- the launch is one ctypes call on PyTorch's current stream, without
  synchronising.
Logits that are already contiguous (the model's are) are not copied.  A
forward for training (``MoERouterFn``) also asks for each row's max and sum
of exponentials, in the same allocation; the backward makes its
probabilities from them.  Serving does not ask, and pays nothing for them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build, _vmap

__all__ = ["moe_router_cuda", "moe_router_bwd_cuda", "MoERouterFn", "MoERouterBwdFn", "check",
           "plan", "DTYPES", "MAX_EXPERTS", "MAX_TOP_K"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS, MAX_TOP_K = 256, 8
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("moe_router").moe_router_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, I, P]      # logits out stats z dtype T E k stream
    fn.restype = I
    return fn


def check(shape: Tuple[int, ...], dtype: torch.dtype, top_k: int
          ) -> Tuple[int, int, int, Tuple[int, ...]]:
    """(T rows, E, the kernel's dtype code, the outputs' allocation shape
    (2, ..., top_k)) for logits of this shape (..., E) and dtype routed to
    ``top_k`` experts.  Raises on anything the kernel does not take: a dtype
    other than float32/bfloat16, fewer than two dims or no row, more than
    ``MAX_EXPERTS`` experts, a ``top_k`` outside 1..min(8, E), or more than
    2**31 elements."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype}: need one of {list(DTYPES)}")
    if len(shape) < 2 or math.prod(shape[:-1]) < 1:
        raise ValueError(f"logits {tuple(shape)} must be (..., E) with at least one row")
    T, E = math.prod(shape[:-1]), shape[-1]
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts: the kernel takes 1 to {MAX_EXPERTS}")
    if not 1 <= top_k <= min(MAX_TOP_K, E):
        raise ValueError(f"top_k {top_k}: the kernel takes 1 to min({MAX_TOP_K}, E={E})")
    if T * E > _INT_MAX:
        raise ValueError("logits of more than 2**31 elements")
    return T, E, DTYPES[dtype], (2, *shape[:-1], top_k)


# ``check`` remembered per key; a key that raises is not remembered
plan = functools.lru_cache(maxsize=None)(check)


def moe_router_cuda(logits: torch.Tensor, top_k: int, return_stats: bool = False,
                    z: Optional[torch.Tensor] = None):
    """Launch the kernel; same contract as ``ref.moe_router_ref``: logits
    (..., E) -> (weights (..., k) fp32, idx (..., k) int32), each row of E
    routed on its own, so that a caller need not reshape to (T, E) and back.
    With ``return_stats`` also each row's fp32 (max, sum of exponentials),
    (..., 2), which ``moe_router_bwd_cuda`` takes; the weights and indices
    are the same bits either way.  ``z``, a contiguous fp32 CUDA tensor of
    the T rows, receives each row's Z = max(sum of the k selected
    probabilities, 1e-9), for checks.

    Raises on a tensor off the card, on what ``check`` refuses, or on a
    launch that CUDA refuses."""
    if not logits.is_cuda:
        raise ValueError("moe_router_cuda takes CUDA tensors only")
    T, E, code, out_shape = plan(logits.shape, logits.dtype, top_k)
    if not logits.is_contiguous():
        logits = logits.contiguous()
    if return_stats:   # one allocation: weights, indices, then the (T, 2) statistics
        flat = logits.new_empty(2 * T * top_k + 2 * T, dtype=torch.int32)
        out = flat[:2 * T * top_k].view(out_shape)
        stats = flat[2 * T * top_k:].view(torch.float32).view(*logits.shape[:-1], 2)
    else:
        out, stats = logits.new_empty(out_shape, dtype=torch.int32), None
    w, idx = out.unbind(0)
    # the current stream's cudaStream_t, as an int
    stream = torch._C._cuda_getCurrentRawStream(logits.get_device())
    err = _fn()(logits.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
                _check_z(z, T, logits.device), code, T, E, top_k, stream)
    if err != 0:
        raise RuntimeError(f"moe_router_fwd launch failed: cudaError_t {err}")
    return (w.view(torch.float32), idx, stats) if return_stats else (w.view(torch.float32), idx)


def _check_z(z: Optional[torch.Tensor], T: int, device: torch.device) -> Optional[int]:
    """``z``'s pointer, None for no tensor; raises unless it is a
    contiguous fp32 tensor of ``T`` elements on ``device``."""
    if z is None:
        return None
    if z.dtype != torch.float32 or z.numel() != T or not z.is_contiguous() or z.device != device:
        raise ValueError(f"z must be a contiguous float32 tensor of {T} elements on {device}")
    return z.data_ptr()


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.load_library("moe_router_bwd").moe_router_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    # logits stats w idx dw dlogits z dtype T E k stream
    fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
    fn.restype = I
    return fn


def moe_router_bwd_cuda(logits: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                        dw: torch.Tensor, stats: Optional[torch.Tensor],
                        z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the backward; same contract as ``ref.moe_router_bwd_ref``:
    logits (..., E) fp32 or bf16, the forward's weights ``w`` (..., k) fp32
    and indices ``idx`` (..., k) int32, the gradient ``dw`` of w (..., k)
    -> dlogits (..., E) in the logits' dtype.  ``stats`` (..., 2) fp32 are
    the forward's row statistics (``moe_router_cuda(..., return_stats=True)``),
    from which the kernel makes the forward's probabilities bit for bit;
    they are required and never recomputed.  ``z`` as in ``moe_router_cuda``.

    Raises on missing statistics, a tensor off the card, tensors on two
    devices, what ``check`` refuses, shapes or dtypes that do not match, or
    a launch that CUDA refuses."""
    if stats is None:
        raise ValueError("moe_router_bwd_cuda needs the forward's row statistics "
                         "(moe_router_cuda(..., return_stats=True))")
    ts = (logits, w, idx, dw, stats)
    if not all(t.is_cuda for t in ts):
        raise ValueError("moe_router_bwd_cuda takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("logits, w, idx, dw and stats must be on one device")
    top_k = idx.shape[-1] if idx.dim() else 0
    T, E, code, _ = plan(logits.shape, logits.dtype, top_k)
    want = (*logits.shape[:-1], top_k)
    if any(tuple(t.shape) != want for t in (w, idx, dw)):
        raise ValueError(f"w {tuple(w.shape)}, idx {tuple(idx.shape)} and dw {tuple(dw.shape)} "
                         f"must be {want} for logits {tuple(logits.shape)}")
    if tuple(stats.shape) != (*logits.shape[:-1], 2):
        raise ValueError(f"stats {tuple(stats.shape)} must be {(*logits.shape[:-1], 2)} for "
                         f"logits {tuple(logits.shape)}")
    if (w.dtype, idx.dtype, stats.dtype) != (torch.float32, torch.int32, torch.float32):
        raise ValueError(f"w {w.dtype}, idx {idx.dtype} and stats {stats.dtype}: need float32, "
                         "int32 and float32")
    logits, w, idx = logits.contiguous(), w.contiguous(), idx.contiguous()
    stats = stats.contiguous()
    dw = dw.to(torch.float32).contiguous()
    dlogits = torch.empty_like(logits)
    stream = torch._C._cuda_getCurrentRawStream(logits.get_device())
    err = _bwd_fn()(logits.data_ptr(), stats.data_ptr(), w.data_ptr(), idx.data_ptr(),
                    dw.data_ptr(), dlogits.data_ptr(), _check_z(z, T, logits.device), code, T, E,
                    top_k, stream)
    if err != 0:
        raise RuntimeError(f"moe_router_bwd launch failed: cudaError_t {err}")
    return dlogits


class MoERouterFn(torch.autograd.Function):
    """The router with its backward, for logits that need a gradient or
    that a ``torch.func`` transform wraps (``ops.moe_router`` routes them
    here).  The forward returns (weights, indices, row statistics): the
    kernel's launch asks for the statistics (8 B a row), which the plain
    version on the CPU does not make (None).  It keeps the logits, its
    outputs and the statistics (a recompute under remat keeps its own); the
    indices and statistics take no gradient.  The backward runs
    ``MoERouterBwdFn``; an unused weights' gradient stays None.  Under
    ``torch.func.vmap`` the ``vmap`` rule puts the lanes first, as one more
    row axis: the kernel routes each row of E on its own and takes any
    leading shape, so one launch routes every lane's rows, each bit for bit
    its own call.  Both passes go through ``ops`` (``ops._moe_router``,
    ``ops.moe_router_bwd``), which count the launches and run the plain
    version for a CPU tensor."""

    @staticmethod
    def forward(logits, top_k):
        from . import ops   # ops imports this module
        return ops._moe_router(logits, top_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        w, idx, stats = output
        ctx.mark_non_differentiable(idx, *(() if stats is None else (stats,)))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(inputs[0], w, idx, stats)

    @staticmethod
    def backward(ctx, dw, _didx, _dstats):
        if dw is None:
            return None, None
        logits, w, idx, stats = ctx.saved_tensors
        return MoERouterBwdFn.apply(logits, w, idx, dw, stats), None

    @staticmethod
    def vmap(info, in_dims, logits, top_k):
        logits = _vmap.lanes_first(logits, in_dims[0], info.batch_size)
        w, idx, stats = MoERouterFn.apply(logits, top_k)
        return (w, idx, stats), (0, 0, None if stats is None else 0)


class MoERouterBwdFn(torch.autograd.Function):
    """K4's backward as a function of its own, so that ``torch.func`` can
    carry it: its ``vmap`` rule puts the lanes of the logits, weights,
    indices, their gradient and the row statistics first, as
    ``MoERouterFn``'s does, and launches once.  It has no backward."""

    @staticmethod
    def forward(logits, w, idx, dw, stats):
        from . import ops
        return ops.moe_router_bwd(logits, w, idx, dw, stats)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the MoE router's backward has no backward of its own: a double "
                           "backward through ops.moe_router is not supported")

    @staticmethod
    def vmap(info, in_dims, logits, w, idx, dw, stats):
        xs = (_vmap.lanes_first(x, d, info.batch_size)
              for x, d in zip((logits, w, idx, dw, stats), in_dims))
        return MoERouterBwdFn.apply(*xs), 0
