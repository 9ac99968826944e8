"""Public wrappers for the kernels.

Dispatch is by the device of the tensors and nothing else: a CPU tensor runs
the plain PyTorch version (``ref.py``), a CUDA tensor launches the hand-written
kernel or the call raises.  There is no fallback from one to the other.
Each wrapper's ``launches`` counts its kernel's launches, so that a run can
show that its main path went through the kernel.

Gradients: on the CPU autograd differentiates the plain versions.  On the
card every kernel has a backward kernel: a call whose inputs need a
gradient, or that a ``torch.func`` transform (``vmap``, ``grad``) wraps,
goes through ``FlashAttentionFn``, ``RWKV6ScanFn``, ``RGLRUScanFn`` or
``MoERouterFn``, whose backwards are ``FlashAttentionBwdFn``,
``RWKV6ScanBwdFn``, ``RGLRUScanBwdFn`` and ``MoERouterBwdFn``; each
Function's forward calls the private helper here that launches (and counts)
the kernel, and each backward's the public ``*_bwd`` wrapper.  Every one of
them has a ``vmap`` rule that folds the lanes into an axis the kernel
already iterates over and launches once for all lanes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from . import flash_attention as _fa
from . import moe_router as _router
from . import ref
from . import rglru_scan as _rglru
from . import rwkv6_scan as _rwkv

__all__ = ["flash_attention", "flash_attention_bwd", "rwkv6_scan", "rwkv6_scan_bwd",
           "rglru_scan", "rglru_scan_bwd", "moe_router", "moe_router_bwd"]


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would need a gradient through a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _wrapped(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a ``torch.func`` transform (``vmap``, ``grad``) wraps any of
    ``tensors``: such a tensor has no storage of its own, so it must reach a
    kernel through an ``autograd.Function`` with a ``vmap`` rule."""
    return any(t is not None and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def _no_dtensor(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Refuse a DTensor: a kernel reads one device's storage.  The model
    runs each kernel on each rank's shards through its helper in
    ``dist.sharding`` (``_LOCAL``), under ``local_map``."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise NotImplementedError(f"{name} takes no DTensor: call it on each rank's shards "
                                  f"(dist.sharding.{_LOCAL[name]})")


# The helper of ``dist.sharding`` that runs each wrapper on local shards.
_LOCAL = {"flash_attention": "local_shards", "rwkv6_scan": "local_rwkv6_scan",
          "rglru_scan": "local_rglru_scan", "moe_router": "local_moe_router"}


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
    the kernel masks ragged edges itself, so nothing is padded.  On the
    card, with grad enabled and q, k or v needing a gradient, or with a
    ``torch.func`` transform wrapping an input, the call goes through
    ``FlashAttentionFn`` (the same forward, which also keeps its
    log-sum-exp, and the backward kernel; under ``vmap`` one launch for all
    lanes).  A DTensor is refused (``_no_dtensor``)."""
    _no_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, softcap=softcap)
    if _needs_grad(q, k, v) or _wrapped(q, k, v, q_pos, k_pos):
        return _fa.FlashAttentionFn.apply(q, k, v, q_pos, k_pos, causal, window, softcap)[0]
    out = _fa.flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, softcap=softcap)
    flash_attention.launches += 1
    return out


def _flash_attention_lse(q, k, v, q_pos, k_pos, causal, window, softcap):
    """``FlashAttentionFn``'s forward: (out, lse (B,H,Sq) fp32), the plain
    version for a CPU tensor, else one launch, counted as
    ``flash_attention``'s."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal, window=window,
                                       softcap=softcap, return_lse=True)
    out = _fa.flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
    flash_attention.launches += 1
    return out


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention`` given its output
    ``out``, its log-sum-exp ``lse`` (B, H, Sq) fp32 and the gradient
    ``dout`` of ``out``.  ``FlashAttentionBwdFn`` calls it (under ``vmap``
    once for all lanes); one call launches the kernel's two passes and
    counts one."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, q_pos, k_pos, out, lse, dout,
                                           causal=causal, window=window, softcap=softcap)
    grads = _fa.flash_attention_bwd_cuda(q, k, v, q_pos, k_pos, out, lse, dout,
                                         causal=causal, window=window, softcap=softcap)
    flash_attention_bwd.launches += 1
    return grads


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV over a sequence.  r/k/v (B,S,H,N); logw (B,S,H,N) fp32;
    u (H,N); state (B,H,N,N) fp32 -> (y (B,S,H,N) in r's dtype, final state).

    The kernel works in chunks of ``min(chunk, S)`` steps and masks a ragged
    last chunk itself; the plain version steps one token at a time.  On the
    card, with grad enabled and an input needing a gradient, or with a
    ``torch.func`` transform wrapping an input, the call goes through
    ``RWKV6ScanFn`` (the same forward, which also keeps its chunk states,
    and the backward kernels; under ``vmap`` one launch for all lanes).  A
    DTensor is refused."""
    _no_dtensor("rwkv6_scan", r, k, v, logw, u, state)
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, logw, u, state)
    if _needs_grad(r, k, v, logw, u, state) or _wrapped(r, k, v, logw, u, state):
        return _rwkv.RWKV6ScanFn.apply(r, k, v, logw, u, state, chunk)[:2]
    out = _rwkv.rwkv6_scan_cuda(r, k, v, logw, u, state, chunk=chunk)
    rwkv6_scan.launches += 1
    return out


def _rwkv6_scan(r, k, v, logw, u, state, chunk):
    """``RWKV6ScanFn``'s forward: (y, final state, the workspace of chunk
    states), the plain version for a CPU tensor, which keeps no workspace
    (None), else one launch, counted as ``rwkv6_scan``'s."""
    if r.device.type == "cpu":
        return (*ref.rwkv6_scan_ref(r, k, v, logw, u, state), None)
    out = _rwkv.rwkv6_scan_cuda(r, k, v, logw, u, state, chunk=chunk, return_states=True)
    rwkv6_scan.launches += 1
    return out


def rwkv6_scan_bwd(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, states: Optional[torch.Tensor], dy: torch.Tensor,
    ds_out: Optional[torch.Tensor] = None, chunk: int = 32,
) -> Tuple[torch.Tensor, ...]:
    """Gradients (dr, dk, dv, dlogw, du, dstate) of ``rwkv6_scan`` given the
    forward's workspace of chunk states ``states`` (``RWKV6ScanFn`` keeps
    it), the gradient ``dy`` of y and ``ds_out`` of the final state (None
    when it is not used).  The plain version steps one token at a time and
    reads no workspace, so on the CPU ``states`` is None.
    ``RWKV6ScanBwdFn`` calls it (under ``vmap`` once for all lanes); one
    call launches the kernel's three passes and counts one."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_bwd_ref(r, k, v, logw, u, state, dy, ds_out)
    grads = _rwkv.rwkv6_scan_bwd_cuda(r, k, v, logw, u, state, states, dy, ds_out,
                                      chunk=chunk)
    rwkv6_scan_bwd.launches += 1
    return grads


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t.  a/b (B,S,R) fp32; h0 (B,R) or None
    (zeros) -> h (B,S,R).  On the card, with grad enabled and an input
    needing a gradient, or with a ``torch.func`` transform wrapping an
    input, the call goes through ``RGLRUScanFn`` (under ``vmap`` one launch
    for all lanes).  A DTensor is refused."""
    _no_dtensor("rglru_scan", a, b, h0)
    if a.device.type != "cpu" and (_needs_grad(a, b, h0) or _wrapped(a, b, h0)):
        return _rglru.RGLRUScanFn.apply(a, b, h0)
    return _rglru_scan(a, b, h0)


def _rglru_scan(a, b, h0):
    """h: the plain version for a CPU tensor, else one launch, counted as
    ``rglru_scan``'s."""
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    h = _rglru.rglru_scan_cuda(a, b, h0)
    rglru_scan.launches += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h0: Optional[torch.Tensor], h: torch.Tensor,
                   dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Gradients (da, db, dh0) of ``rglru_scan`` from its output ``h`` and
    the gradient ``dh`` of h; dh0 is None when h0 is.  ``RGLRUScanBwdFn``
    calls it (under ``vmap`` once for all lanes)."""
    if a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(a, h0, h, dh)
    grads = _rglru.rglru_scan_bwd_cuda(a, h0, h, dh)
    rglru_scan_bwd.launches += 1
    return grads


def moe_router(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over experts -> top-k -> renormalise.  logits (..., E) (fp32
    or bf16 on the card), computed in fp32 -> (weights (..., k) fp32, idx
    (..., k) int32); the lowest index wins among equal probabilities.  Any
    number of rows is taken: the kernel masks the rows past the last
    itself, so nothing is padded.  Called once per MoE layer of every
    decode step, so the dispatch reads the cheap ``is_cpu``, not a
    ``device`` object.  On the card, with grad enabled and the logits
    needing a gradient, or with a ``torch.func`` transform wrapping them,
    the call goes through ``MoERouterFn`` (the same forward with its row
    statistics, and the backward kernel; under ``vmap`` one launch for all
    lanes).  A DTensor is refused."""
    _no_dtensor("moe_router", logits)
    if logits.is_cpu:
        return ref.moe_router_ref(logits, top_k)
    if (logits.requires_grad and torch.is_grad_enabled()) or _wrapped(logits):
        return _router.MoERouterFn.apply(logits, top_k)[:2]
    out = _router.moe_router_cuda(logits, top_k)
    moe_router.launches += 1
    return out


def _moe_router(logits, top_k):
    """``MoERouterFn``'s forward: (weights, idx, row statistics (..., 2)
    fp32), the plain version for a CPU tensor, which makes no statistics
    (None), else one launch, counted as ``moe_router``'s."""
    if logits.is_cpu:
        return (*ref.moe_router_ref(logits, top_k), None)
    out = _router.moe_router_cuda(logits, top_k, return_stats=True)
    moe_router.launches += 1
    return out


def moe_router_bwd(logits: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   dw: torch.Tensor, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradient dlogits (..., E), in the logits' dtype, of ``moe_router``'s
    weights from its outputs ``w`` and ``idx`` (..., k) and the gradient
    ``dw`` of w.  On the card the kernel also takes the forward's row
    statistics ``stats`` (..., 2) and raises without them; the plain
    version needs none.  ``MoERouterBwdFn`` calls it (under ``vmap`` once
    for all lanes)."""
    if logits.is_cpu:
        return ref.moe_router_bwd_ref(logits, w, idx, dw)
    out = _router.moe_router_bwd_cuda(logits, w, idx, dw, stats)
    moe_router_bwd.launches += 1
    return out


flash_attention.launches = 0
flash_attention_bwd.launches = 0
rwkv6_scan.launches = 0
rwkv6_scan_bwd.launches = 0
rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
moe_router.launches = 0
moe_router_bwd.launches = 0
