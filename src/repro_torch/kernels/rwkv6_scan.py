"""ctypes wrapper of the CUDA RWKV-6 WKV scan (``csrc/rwkv6_scan.cu``).

Checks what the kernels take, allocates y, the final state and the
workspace of chunk states, and launches the two kernels (the chunk states,
then the outputs) on PyTorch's current stream without synchronising.  The
kernels mask a ragged last chunk themselves, so nothing is padded; inputs
that are already contiguous (the model's are) are not copied, and ``u`` is
cast to fp32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

__all__ = ["rwkv6_scan_cuda", "occupancy", "HEAD_SIZE", "DTYPES", "MAX_CHUNK", "PASSES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZE = 64      # rwkv6-1.6b's; the kernel is built for this one
MAX_CHUNK = 32      # every config's rwkv_chunk
PASSES = ("states", "outputs")   # the two kernels, rwkv6_scan_<pass>_kernel, in launch order


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("rwkv6_scan").rwkv6_scan_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, P,   # r k v logw u state y s_out ws
                   I, I, I, I, I, I,            # dtype B S H N L
                   P]                           # stream
    fn.restype = I
    return fn


def rwkv6_scan_cuda(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the two kernels; same contract as ``ref.rwkv6_scan_ref``,
    computed in chunks of ``min(chunk, S)`` steps.

    Raises on anything the kernel does not take: a tensor off the card, r/k/v
    of a dtype other than float32/bfloat16 (or not one dtype), logw or state
    not float32, a head size other than ``HEAD_SIZE``, a chunk outside
    1..``MAX_CHUNK``, mismatched shapes, or a launch that CUDA refuses."""
    ts = (r, k, v, logw, u, state)
    if not all(t.is_cuda for t in ts):
        raise ValueError("rwkv6_scan_cuda takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("r, k, v, logw, u and state must be on one device")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}/{k.dtype}/{v.dtype}: need one of {list(DTYPES)}")
    if logw.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"logw and state must be float32, not {logw.dtype}/{state.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B,S,H,N), not {tuple(r.shape)}")
    B, S, H, N = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or u.shape != (H, N) or state.shape != (B, H, N, N)):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"logw {tuple(logw.shape)} u {tuple(u.shape)} state {tuple(state.shape)}")
    if N != HEAD_SIZE:
        raise ValueError(f"head size {N}: the kernel takes {HEAD_SIZE}")
    L = min(chunk, S)
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: need 1..{MAX_CHUNK}")
    r, k, v, logw, state = (t.contiguous() for t in (r, k, v, logw, state))
    u = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    # the state entering each chunk after the first, written by the first kernel
    ws = torch.empty((B, H, -(-S // L) - 1, N, N), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                state.data_ptr(), y.data_ptr(), s_out.data_ptr(), ws.data_ptr(),
                DTYPES[r.dtype], B, S, H, N, L, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_fwd launch failed: cudaError_t {err}")
    return y, s_out


@functools.lru_cache(maxsize=None)
def _occupancy_fn():
    fn = _build.load_library("rwkv6_scan").rwkv6_scan_occupancy
    I, P = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [I, I, P, P]      # dtype L -> smem_bytes[2] blocks_per_sm[2]
    fn.restype = I
    return fn


def occupancy(dtype: torch.dtype, chunk: int = MAX_CHUNK) -> dict:
    """For each kernel of ``PASSES``: its dynamic shared memory a block and
    the blocks an SM can hold at this chunk, as the card reports them."""
    if dtype not in DTYPES or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"no kernel for {dtype}, chunk {chunk}")
    smem, blocks = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    err = _occupancy_fn()(DTYPES[dtype], chunk, smem, blocks)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_occupancy failed: cudaError_t {err}")
    return {name: {"smem_bytes": smem[i], "blocks_per_sm": blocks[i]}
            for i, name in enumerate(PASSES)}
