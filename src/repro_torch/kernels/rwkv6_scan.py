"""ctypes wrappers of the CUDA RWKV-6 WKV scan (``csrc/rwkv6_scan.cu``) and
its backward (``csrc/rwkv6_scan_bwd.cu``), and ``RWKV6ScanFn``, the two
joined for autograd, with ``RWKV6ScanBwdFn`` for its backward; both have
``vmap`` rules, so that ``torch.func`` transforms (``vmap`` of ``grad``)
launch each kernel once for all lanes.

The forward checks what the kernels take, allocates y, the final state and
the workspace of chunk states, and launches the two kernels (the chunk
states, then the outputs) on PyTorch's current stream without
synchronising; the backward launches its three (the gradients of the chunk
states in reverse, then dr/dk/dv/dlogw and each chunk's part of du, then
du).  The kernels mask a ragged last chunk themselves, so nothing is padded;
inputs that are already contiguous (the model's are) are not copied, and
``u`` is cast to fp32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, _vmap

__all__ = ["rwkv6_scan_cuda", "rwkv6_scan_bwd_cuda", "RWKV6ScanFn", "RWKV6ScanBwdFn",
           "occupancy", "bwd_occupancy", "HEAD_SIZE", "DTYPES", "MAX_CHUNK", "PASSES",
           "BWD_PASSES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZE = 64      # rwkv6-1.6b's; the kernel is built for this one
MAX_CHUNK = 32      # every config's rwkv_chunk
PASSES = ("states", "outputs")   # the two kernels, rwkv6_scan_<pass>_kernel, in launch order
BWD_PASSES = ("states", "grads", "du")   # the backward's, rwkv6_scan_bwd_<pass>_kernel


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load_library("rwkv6_scan").rwkv6_scan_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, P,   # r k v logw u state y s_out ws
                   I, I, I, I, I, I,            # dtype B S H N L
                   P]                           # stream
    fn.restype = I
    return fn


def _check(r, k, v, logw, u, state, chunk) -> int:
    """Raise on what the kernels do not take; return the chunk length."""
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
    return L


def rwkv6_scan_cuda(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, chunk: int = 32, return_states: bool = False,
):
    """Launch the two kernels; same contract as ``ref.rwkv6_scan_ref``,
    computed in chunks of ``min(chunk, S)`` steps.  With ``return_states``
    also the workspace the first kernel wrote, the state entering each
    chunk after the first (B, H, ceil(S/L) - 1, N, N) fp32, which the
    backward reads.

    Raises on anything the kernel does not take: a tensor off the card, r/k/v
    of a dtype other than float32/bfloat16 (or not one dtype), logw or state
    not float32, a head size other than ``HEAD_SIZE``, a chunk outside
    1..``MAX_CHUNK``, mismatched shapes, or a launch that CUDA refuses."""
    L = _check(r, k, v, logw, u, state, chunk)
    B, S, H, N = r.shape
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
    return (y, s_out, ws) if return_states else (y, s_out)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in a fresh allocation when its data does not
    start on a 16-byte boundary (a contiguous view at an odd offset)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.load_library("rwkv6_scan_bwd").rwkv6_scan_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, P,   # r k v logw u state ws dy ds_out
                   P, P, P, P, P, P,            # dr dk dv dlogw du dstate
                   P, P,                        # dws du_part
                   I, I, I, I, I, I,            # dtype B S H N L
                   P]                           # stream
    fn.restype = I
    return fn


def rwkv6_scan_bwd_cuda(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
    ds_out: Optional[torch.Tensor] = None, chunk: int = 32,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward's three kernels; same contract as
    ``ref.rwkv6_scan_bwd_ref``: (dr, dk, dv) in r's dtype, dlogw, dstate fp32
    and du in u's dtype.  ``states`` is the forward's workspace at the same
    chunk (``rwkv6_scan_cuda(..., return_states=True)``), ``dy`` the
    gradient of y (cast to r's dtype), ``ds_out`` that of the final state or
    None for zeros.  Raises as ``rwkv6_scan_cuda`` does, and on a states,
    dy or ds_out of another shape or off the card."""
    L = _check(r, k, v, logw, u, state, chunk)
    B, S, H, N = r.shape
    nc = -(-S // L)
    if dy.shape != r.shape or not dy.is_cuda:
        raise ValueError(f"dy {tuple(dy.shape)} must be a CUDA tensor of r's shape")
    if ds_out is not None and (ds_out.shape != state.shape or not ds_out.is_cuda):
        raise ValueError(f"ds_out {tuple(ds_out.shape)} must be a CUDA tensor of state's shape")
    if (states.shape != (B, H, nc - 1, N, N) or states.dtype != torch.float32
            or states.device != r.device):
        raise ValueError(f"states {tuple(states.shape)} {states.dtype} on {states.device}: "
                         f"need the forward's workspace {(B, H, nc - 1, N, N)} float32 on "
                         f"{r.device}")
    # the grads kernel reads its tiles 16 bytes at a time
    r, k, v, logw, state, states, dy = (_aligned(t.contiguous())
                                        for t in (r, k, v, logw, state, states, dy.to(r.dtype)))
    if ds_out is not None:
        ds_out = ds_out.to(torch.float32).contiguous()
    u32 = u.to(torch.float32).contiguous()
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(logw)
    du = torch.empty_like(u32)
    dstate = torch.empty_like(state)
    dws = torch.empty((B, H, nc, N, N), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, nc, H, N), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _bwd_fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u32.data_ptr(),
                    state.data_ptr(), states.data_ptr(), dy.data_ptr(),
                    ds_out.data_ptr() if ds_out is not None else None,
                    dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
                    du.data_ptr(), dstate.data_ptr(), dws.data_ptr(), du_part.data_ptr(),
                    DTYPES[r.dtype], B, S, H, N, L, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd launch failed: cudaError_t {err}")
    return dr, dk, dv, dlogw, du.to(u.dtype), dstate


# the axis of each input and output that takes the lanes under ``vmap``: the heads
_FWD_AXES = (2, 2, 2, 2, 0, 1)             # r k v logw u state
_FWD_OUT_AXES = (2, 1, 1)                  # y s_out states
_BWD_AXES = (2, 2, 2, 2, 0, 1, 1, 2, 1)    # r k v logw u state states dy ds_out
_BWD_OUT_AXES = (2, 2, 2, 2, 0, 1)         # dr dk dv dlogw du dstate


def _fold_heads(xs, in_dims, axes, n):
    return (_vmap.fold_at(x, d, n, a) for x, d, a in zip(xs, in_dims, axes))


def _unfold_heads(outs, axes, n):
    """A rule's outputs and their lane axes (None for an absent output)."""
    outs = tuple(_vmap.unfold_at(x, n, a) for x, a in zip(outs, axes))
    return outs, tuple(None if x is None else a for x, a in zip(outs, axes))


class RWKV6ScanFn(torch.autograd.Function):
    """The forward with its backward, for tensors that need a gradient or
    that a ``torch.func`` transform wraps (``ops.rwkv6_scan`` routes them
    here).  The forward returns (y, the final state, the workspace of chunk
    states), the workspace not differentiable (None from the plain version
    on the CPU, which keeps none), and keeps its inputs and the workspace;
    the backward runs ``RWKV6ScanBwdFn`` and returns a gradient only where
    one is needed.  The final state's gradient may be None (training drops
    the state).  Under ``torch.func.vmap`` the ``vmap`` rule folds the lanes
    into the head axis, not the batch axis: ``u`` is one per head for every
    batch row, and the backward sums ``du`` over the batch, so each lane
    keeps its own ``u`` and ``du`` only as heads of its own.  Each (batch
    row, head) block then does what it does in the lane's own call, bit for
    bit, with one launch for all lanes.  Both passes go through ``ops``
    (``ops._rwkv6_scan``, ``ops.rwkv6_scan_bwd``), which count the launches
    and run the plain version for a CPU tensor."""

    @staticmethod
    def forward(r, k, v, logw, u, state, chunk):
        from . import ops   # ops imports this module
        return ops._rwkv6_scan(r, k, v, logw, u, state, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, logw, u, state, chunk = inputs
        states = output[2]
        if states is not None:
            ctx.mark_non_differentiable(states)
        ctx.save_for_backward(r, k, v, logw, u, state, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused output's gradient stays None

    @staticmethod
    def backward(ctx, dy, ds_out, _dstates):
        r, k, v, logw, u, state, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = RWKV6ScanBwdFn.apply(r, k, v, logw, u, state, states, dy, ds_out, ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)

    @staticmethod
    def vmap(info, in_dims, r, k, v, logw, u, state, chunk):
        n = info.batch_size
        folded = _fold_heads((r, k, v, logw, u, state), in_dims, _FWD_AXES, n)
        return _unfold_heads(RWKV6ScanFn.apply(*folded, chunk), _FWD_OUT_AXES, n)


class RWKV6ScanBwdFn(torch.autograd.Function):
    """K2's backward as a function of its own, so that ``torch.func`` can
    carry it: its ``vmap`` rule folds the lanes of every input (the
    workspace of chunk states stays in the forward's folded layout, so it
    folds back as a view) into the head axis, as ``RWKV6ScanFn``'s does,
    and launches once; ``du`` comes back one (H, N) a lane.  It has no
    backward."""

    @staticmethod
    def forward(r, k, v, logw, u, state, states, dy, ds_out, chunk):
        from . import ops
        return ops.rwkv6_scan_bwd(r, k, v, logw, u, state, states, dy, ds_out, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the RWKV-6 scan's backward has no backward of its own: a double "
                           "backward through ops.rwkv6_scan is not supported")

    @staticmethod
    def vmap(info, in_dims, r, k, v, logw, u, state, states, dy, ds_out, chunk):
        n = info.batch_size
        folded = _fold_heads((r, k, v, logw, u, state, states, dy, ds_out), in_dims,
                             _BWD_AXES, n)
        return _unfold_heads(RWKV6ScanBwdFn.apply(*folded, chunk), _BWD_OUT_AXES, n)


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


@functools.lru_cache(maxsize=None)
def _bwd_occupancy_fn():
    fn = _build.load_library("rwkv6_scan_bwd").rwkv6_scan_bwd_occupancy
    I, P = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [I, I, P, P]      # dtype L -> smem_bytes[3] blocks_per_sm[3]
    fn.restype = I
    return fn


def bwd_occupancy(dtype: torch.dtype, chunk: int = MAX_CHUNK) -> dict:
    """``occupancy`` for each kernel of the backward (``BWD_PASSES``)."""
    if dtype not in DTYPES or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"no kernel for {dtype}, chunk {chunk}")
    smem, blocks = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    err = _bwd_occupancy_fn()(DTYPES[dtype], chunk, smem, blocks)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd_occupancy failed: cudaError_t {err}")
    return {name: {"smem_bytes": smem[i], "blocks_per_sm": blocks[i]}
            for i, name in enumerate(BWD_PASSES)}
