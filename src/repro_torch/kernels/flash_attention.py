"""ctypes wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Checks what the kernel takes, allocates the output and launches on PyTorch's
current stream without synchronising.  The kernel reads q/k/v through their
strides, so no transpose or padding copy is made; only the position vectors
are made contiguous int32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention_cuda", "tile_config", "HEAD_DIMS", "DTYPES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("flash_attention").flash_attention_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P,            # q k v q_pos k_pos out
                   I, I, I, I, I, I, I,         # dtype B Sq Sk H K hd
                   I, I, I, I, I, I, I, I, I,   # q/k/v strides (b, s, head)
                   I, I, I, ctypes.c_float,     # causal has_window window softcap
                   P]                           # stream
    fn.restype = I
    return fn


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel; same contract as ``ref.flash_attention_ref``.

    Raises on anything the kernel does not take: a tensor off the card, a
    dtype other than float32/bfloat16, a head_dim outside ``HEAD_DIMS``, a
    non-contiguous last axis, or a launch that CUDA refuses."""
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
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), DTYPES[q.dtype], B, Sq, Sk, H, K, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window is not None), int(window or 0),
        float(softcap or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    return out


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
