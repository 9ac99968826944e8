"""ctypes wrappers of the CUDA flash attention: the forward
(``csrc/flash_attention.cu``), its backward (``csrc/flash_attention_bwd.cu``)
and ``FlashAttentionFn``, the ``torch.autograd.Function`` that joins them,
with ``FlashAttentionBwdFn`` for its backward; both have ``vmap`` rules, so
that ``torch.func`` transforms (``vmap`` of ``grad``) launch each kernel
once for all lanes.

Each wrapper checks what its kernel takes, allocates the outputs and launches
on PyTorch's current stream without synchronising.  The kernels read q/k/v
(and the backward dO) through their strides, so no transpose or padding copy
is made; only the position vectors are made contiguous int32, and a dO whose
last axis is not contiguous is copied.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, _vmap

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "FlashAttentionFn",
           "FlashAttentionBwdFn", "tile_config", "bwd_tile_config", "HEAD_DIMS", "DTYPES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128, 256)
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("flash_attention").flash_attention_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P,         # q k v q_pos k_pos out lse
                   I, I, I, I, I, I, I,         # dtype B Sq Sk H K hd
                   I, I, I, I, I, I, I, I, I,   # q/k/v strides (b, s, head)
                   I, I, I, ctypes.c_float,     # causal has_window window softcap
                   P]                           # stream
    fn.restype = I
    return fn


def _check(q, k, v, q_pos, k_pos) -> None:
    """Raise on what the kernels do not take."""
    if not all(t.is_cuda for t in (q, k, v, q_pos, k_pos)):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if len({t.device for t in (q, k, v, q_pos, k_pos)}) != 1:
        raise ValueError("q, k, v and positions must be on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of {list(DTYPES)}")
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sk):
        raise ValueError(f"positions {tuple(q_pos.shape)}/{tuple(k_pos.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the last axis of q, k and v must be contiguous")
    if max(t.numel() for t in (q, k, v)) > _INT_MAX:
        raise ValueError("tensors of more than 2**31 elements")


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, return_lse: bool = False,
):
    """Launch the kernel; same contract as ``ref.flash_attention_ref``.
    With ``return_lse`` also each row's log-sum-exp of its scaled (and
    capped) scores, fp32 (B, H, Sq), +inf for a row with every key masked;
    the output is the same with or without it.

    Raises on anything the kernel does not take: a tensor off the card, a
    dtype other than float32/bfloat16, a head_dim outside ``HEAD_DIMS``, a
    non-contiguous last axis, or a launch that CUDA refuses."""
    _check(q, k, v, q_pos, k_pos)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), lse.data_ptr() if return_lse else None,
        DTYPES[q.dtype], B, Sq, Sk, H, K, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window is not None), int(window or 0),
        float(softcap or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    return (out, lse) if return_lse else out


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.load_library("flash_attention_bwd").flash_attention_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P,      # q k v out dout lse q_pos k_pos
                   P, P, P, P,                  # delta dq dk dv
                   I, I, I, I, I, I, I,         # dtype B Sq Sk H K hd
                   I, I, I, I, I, I,            # q/k strides (b, s, head)
                   I, I, I, I, I, I,            # v/dout strides (b, s, head)
                   I, I, I, ctypes.c_float,     # causal has_window window softcap
                   P]                           # stream
    fn.restype = I
    return fn


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward (two kernels); same contract as
    ``ref.flash_attention_bwd_ref``: ``out`` and ``lse`` are the forward's
    (``flash_attention_cuda(..., return_lse=True)``), ``dout`` the gradient
    of ``out``.  Returns (dq, dk, dv), contiguous, in q's dtype."""
    _check(q, k, v, q_pos, k_pos)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if out.dtype != q.dtype or lse.dtype != torch.float32 or not out.is_cuda or not lse.is_cuda:
        raise ValueError("out must be the forward's output and lse its fp32 log-sum-exp")
    # the kernel honours dout's (b, s, head) strides; only a strided last axis is copied
    dout = dout.to(q.dtype)
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    out, lse = out.contiguous(), lse.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        DTYPES[q.dtype], B, Sq, Sk, H, K, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        dout.stride(0), dout.stride(1), dout.stride(2),
        int(causal), int(window is not None), int(window or 0),
        float(softcap or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError_t {err}")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The forward with its backward, for tensors that need a gradient or
    that a ``torch.func`` transform wraps (``ops.flash_attention`` routes
    them here).  The forward returns (out, lse), ``lse`` not
    differentiable, and keeps q, k, v, the positions, out and lse; the
    backward runs ``FlashAttentionBwdFn``.  Under ``torch.func.vmap`` the
    ``vmap`` rule folds the lanes into the batch axis and launches once for
    all of them.  Both passes go through ``ops`` (``ops._flash_attention_lse``,
    ``ops.flash_attention_bwd``), which count the launches and run the
    plain version for a CPU tensor."""

    @staticmethod
    def forward(q, k, v, q_pos, k_pos, causal, window, softcap):
        from . import ops   # ops imports this module
        return ops._flash_attention_lse(q, k, v, q_pos, k_pos, causal, window, softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, k_pos, causal, window, softcap = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.mask = (causal, window, softcap)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBwdFn.apply(q, k, v, q_pos, k_pos, out, lse, dout,
                                               *ctx.mask)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, k_pos, causal, window, softcap):
        n = info.batch_size
        folded = (_vmap.fold(x, d, n) for x, d in zip((q, k, v, q_pos, k_pos), in_dims))
        out, lse = FlashAttentionFn.apply(*folded, causal, window, softcap)
        return (_vmap.unfold(out, n), _vmap.unfold(lse, n)), (0, 0)


class FlashAttentionBwdFn(torch.autograd.Function):
    """K1's backward as a function of its own, so that ``torch.func`` can
    carry it: its ``vmap`` rule folds the lanes of q, k, v, the positions,
    out, lse (N, B, H, Sq) and dout into the batch axis, as
    ``FlashAttentionFn``'s does, and launches once.  It has no backward."""

    @staticmethod
    def forward(q, k, v, q_pos, k_pos, out, lse, dout, causal, window, softcap):
        from . import ops
        return ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, dout,
                                       causal=causal, window=window, softcap=softcap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention's backward has no backward of its own: "
                           "a double backward through ops.flash_attention is not supported")

    @staticmethod
    def vmap(info, in_dims, q, k, v, q_pos, k_pos, out, lse, dout, causal, window, softcap):
        n = info.batch_size
        folded = (_vmap.fold(x, d, n) for x, d in zip((q, k, v, q_pos, k_pos, out, lse, dout),
                                                  in_dims))
        grads = FlashAttentionBwdFn.apply(*folded, causal, window, softcap)
        return tuple(_vmap.unfold(g, n) for g in grads), (0, 0, 0)


@functools.lru_cache(maxsize=None)
def _tiles_fn():
    fn = _build.load_library("flash_attention").flash_attention_tiles
    I, P = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [I, I, P, P, P]   # dtype hd -> block_keys smem_bytes blocks_per_sm
    fn.restype = I
    return fn


def tile_config(dtype: torch.dtype, head_dim: int) -> dict:
    """The kernel's keys per tile, dynamic shared memory a block and blocks
    an SM can hold for one (dtype, head_dim), as the card reports them."""
    if dtype not in DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"no kernel for {dtype}, head_dim {head_dim}")
    out = [ctypes.c_int() for _ in range(3)]
    err = _tiles_fn()(DTYPES[dtype], head_dim, *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"flash_attention_tiles failed: cudaError_t {err}")
    return dict(zip(("block_keys", "smem_bytes", "blocks_per_sm"), (x.value for x in out)))


@functools.lru_cache(maxsize=None)
def _bwd_tiles_fn():
    fn = _build.load_library("flash_attention_bwd").flash_attention_bwd_tiles
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def bwd_tile_config(dtype: torch.dtype, head_dim: int) -> dict:
    """The backward's tiles: the rows a block owns (query rows in the dq
    kernel, keys in the dkdv kernel); and for each of its two kernels the
    rows of each tile it streams (keys, query rows), its threads, the
    dynamic shared memory a block and blocks an SM, as the card reports
    them."""
    if dtype not in DTYPES or head_dim not in HEAD_DIMS:
        raise ValueError(f"no kernel for {dtype}, head_dim {head_dim}")
    out = (ctypes.c_int * 9)()
    err = _bwd_tiles_fn()(DTYPES[dtype], head_dim, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_tiles failed: cudaError_t {err}")
    keys = ("tile_rows", "threads", "smem_bytes", "blocks_per_sm")
    return {"block_rows": out[0], "dq": dict(zip(keys, out[1:5])),
            "dkdv": dict(zip(keys, out[5:9]))}
