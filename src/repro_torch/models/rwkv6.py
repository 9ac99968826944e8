"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay.

Counterpart of ``repro.models.rwkv6``.

Time-mixing:   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
               y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
with per-channel data-dependent decay w_t = exp(-exp(w0 + lora_w(x))) and
data-dependent token-shift interpolation (DDLerp) for r/k/v/w/g.

A prompt or a training sequence runs the exact chunked evaluation:
``kernel_impl="pallas"`` (the JAX name, kept so that configs compare equal)
launches the CUDA WKV kernel (``kernels/ops.rwkv6_scan``; in training its
gradients come from the backward kernels through ``RWKV6ScanFn``, u's in
u's dtype), ``"jnp"`` runs ``_wkv_chunked`` in PyTorch, differentiated by
autograd; either runs on each rank's shards of a DTensor
(``dist.sharding.local_rwkv6_scan``).  Decode (one token) is the plain
single-step recurrence in either case.
``TimeMix`` and ``ChannelMix`` are the JAX ``init_*``: parameters under the
JAX leaf names, dense weights in ``nn.Linear``'s (out, in) layout.

Channel-mixing: squared-ReLU MLP with static token-shift (Finch eq. 20-22).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import local_einsum, local_rwkv6_scan, replicated_like, whole_on
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import _dtype, _linear, _normal

__all__ = ["TimeMix", "ChannelMix", "apply_time_mix", "apply_channel_mix", "init_state"]

State = Dict[str, torch.Tensor]

_N_MIX = 5  # r, k, v, w, g
_LORA_MIX = 32
_LORA_DECAY = 64


class TimeMix(nn.Module):
    """``init_time_mix``."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        dtype = _dtype(cfg.param_dtype)
        D, N = cfg.d_model, cfg.rwkv_head_dim
        H = D // N
        const = lambda shape, value: nn.Parameter(
            torch.full(shape, value, device=device, dtype=dtype))
        self.mu_x = const((D,), 0.0)
        self.mu_rkvwg = const((_N_MIX, D), 0.0)
        self.maa_w1 = _linear(D, _N_MIX * _LORA_MIX, cfg, generator, device, scale=1e-2)
        self.maa_w2 = _normal((_N_MIX, _LORA_MIX, D), 1e-2, generator, device, dtype)
        self.w0 = const((D,), -6.0)  # slow initial decay
        self.w_lora_a = _linear(D, _LORA_DECAY, cfg, generator, device, scale=1e-2)
        self.w_lora_b = _linear(_LORA_DECAY, D, cfg, generator, device, scale=1e-2)
        self.u = _normal((H, N), 0.1, generator, device, dtype)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _linear(D, D, cfg, generator, device))
        self.ln_x_scale = const((D,), 1.0)
        self.ln_x_bias = const((D,), 0.0)


class ChannelMix(nn.Module):
    """``init_channel_mix``."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        dtype = _dtype(cfg.param_dtype)
        D, Fd = cfg.d_model, cfg.d_ff
        self.mu_k = nn.Parameter(torch.zeros(D, device=device, dtype=dtype))
        self.mu_r = nn.Parameter(torch.zeros(D, device=device, dtype=dtype))
        self.w_k = _linear(D, Fd, cfg, generator, device)
        self.w_v = _linear(Fd, D, cfg, generator, device)
        self.w_r = _linear(D, D, cfg, generator, device)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """s_t = x_{t-1}; position 0 uses ``prev`` (decode state) or zeros."""
    if x.shape[1] == 1:
        return prev[:, None, :] if prev is not None else torch.zeros_like(x)
    first = prev[:, None, :] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: TimeMix, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp -> (5, B, S, D) mixed inputs for r/k/v/w/g."""
    xm = x + (s - x) * p.mu_x.to(x.dtype)
    lora = torch.tanh(p.maa_w1(xm))                               # (B,S,5*r)
    # a DTensor's 5*r dim whole first: 5 mixes do not split over the model axis
    lora = whole_on(lora, -1).reshape(*lora.shape[:-1], _N_MIX, _LORA_MIX)
    # on each rank's shards: torch 2.11's DTensor refuses to flatten lora's
    # split inner dim in the backward, and runs the product whole where 2.13
    # splits it
    m = local_einsum("bsnr,nrd->nbsd", lora, p.maa_w2.to(x.dtype))
    m = m + p.mu_rkvwg.to(x.dtype)[:, None, None, :]
    # a DTensor's 5 mixes whole, so that they unbind (on a mesh dim of one
    # rank DTensor may leave them "split")
    return whole_on(x[None] + (s - x)[None] * m, 0)


def _decay(p: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    """log-decay (negative), fp32: logw = -exp(w0 + lora_w(xw))."""
    lora = p.w_lora_b(torch.tanh(p.w_lora_a(xw)))
    return -torch.exp(torch.clamp(p.w0.float() + lora.float(), -10.0, 8.0))


def _group_norm(p: TimeMix, y: torch.Tensor, n_heads: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm over the flattened (H*N) output (RWKV ln_x)."""
    B, S, D = y.shape
    yh = y.reshape(B, S, n_heads, D // n_heads).float()
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    out = yh.reshape(B, S, D) * p.ln_x_scale.float() + p.ln_x_bias.float()
    return out.to(y.dtype)


def _wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Exact chunked WKV in PyTorch.  r/k/v: (B,S,H,N); logw fp32 (B,S,H,N);
    u (H,N); state (B,H,N,N) fp32.  Returns (y (B,S,H,N), new_state).  A
    Python loop over the chunks where JAX scans.  Plain tensors: a DTensor's
    scan comes here through ``local_rwkv6_scan``."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    if pad:  # logw=0 -> w=1 (no decay) and k=0: padded steps leave the state alone
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    eye = torch.eye(L, device=r.device)
    uf = u.float()
    ys = []
    for c in range(n_chunks):
        rb, kb, vb, wb = (a[:, c * L:(c + 1) * L] for a in (r, k, v, logw))  # (B,L,H,N)
        rb32, kb32, vb32 = rb.float(), kb.float(), vb.float()
        cum = torch.cumsum(wb, dim=1)           # inclusive cumsum of log-decay
        cum_excl = cum - wb                     # exclusive
        # intra-chunk: A[t,s] = sum_n r[t,n] k[s,n] exp(cum_excl[t]-cum[s]), s < t
        ratio = cum_excl[:, :, None] - cum[:, None, :]                  # (B,t,s,H,N)
        ratio = ratio.masked_fill(~mask[None, :, :, None, None], float("-inf"))
        A = (rb32[:, :, None] * kb32[:, None, :] * torch.exp(ratio)).sum(-1)
        A = A.permute(0, 3, 1, 2)                                        # (B,H,t,s)
        diag = torch.einsum("bthn,hn,bthn->bht", rb32, uf, kb32)
        A = A + eye[None, None] * diag[..., None]
        y_intra = torch.einsum("bhts,bshn->bthn", A, vb32)
        # inter-chunk: y += (r * exp(cum_excl))^T S0
        y_inter = torch.einsum("bthn,bhnm->bthm", rb32 * torch.exp(cum_excl), state)
        # state update: S = diag(exp(cum_L)) S0 + sum_s (k * exp(cum_L - cum_s)) v^T
        decay_all = torch.exp(cum[:, -1])                                # (B,H,N)
        k_scaled = kb32 * torch.exp(cum[:, -1][:, None] - cum)
        state = decay_all[..., None] * state + torch.einsum("bthn,bthm->bhnm", k_scaled, vb32)
        ys.append((y_intra + y_inter).to(r.dtype))
    return torch.cat(ys, dim=1)[:, :S], state


def _wkv_step(r, k, v, logw, u, state):
    """Single decode step. r/k/v/logw: (B,H,N); state (B,H,N,N) fp32."""
    r32, k32, v32 = r.float(), k.float(), v.float()
    kv = k32[..., :, None] * v32[..., None, :]                           # (B,H,N,N)
    # on each rank's shards: torch 2.11's DTensor refuses the flatten of the
    # batch and the split heads
    y = local_einsum("bhn,bhnm->bhm", r32, state + u.float()[None, :, :, None] * kv)
    state = torch.exp(logw)[..., None] * state + kv
    return y.to(r.dtype), state


def apply_time_mix(p: TimeMix, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[State] = None,
                   chunk: Optional[int] = None) -> Tuple[torch.Tensor, State]:
    """x (B,S,D).  ``state`` = {"prev": (B,D), "wkv": (B,H,N,N) fp32} for
    decode.  Returns (out, new state); ``state`` is not written."""
    chunk = chunk or cfg.rwkv_chunk
    B, S, D = x.shape
    N = cfg.rwkv_head_dim
    H = D // N
    prev = state["prev"] if state else None
    s = _token_shift(x, prev)
    xr, xk, xv, xw, xg = _ddlerp(p, x, s)
    r = p.w_r(xr).reshape(B, S, H, N)
    k = p.w_k(xk).reshape(B, S, H, N)
    v = p.w_v(xv).reshape(B, S, H, N)
    g = F.silu(p.w_g(xg))
    logw = _decay(p, xw).reshape(B, S, H, N)

    wkv0 = state["wkv"] if state else replicated_like(
        torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device), x)
    if S == 1:
        y, wkv = _wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p.u, wkv0)
        y = y[:, None]
    else:
        # a DTensor's scan runs on each rank's batch and heads (local_map): the
        # kernel, or the chunked einsums, which torch 2.11's DTensor refuses
        scan = kops.rwkv6_scan if cfg.kernel_impl == "pallas" else _wkv_chunked
        y, wkv = local_rwkv6_scan(scan, r, k, v, logw, p.u, wkv0, chunk=chunk)

    y = _group_norm(p, y.reshape(B, S, D), H) * g
    return p.w_o(y), {"prev": x[:, -1], "wkv": wkv}


def apply_channel_mix(p: ChannelMix, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    prev = state["prev"] if state else None
    s = _token_shift(x, prev)
    xk = x + (s - x) * p.mu_k.to(x.dtype)
    xr = x + (s - x) * p.mu_r.to(x.dtype)
    k = torch.square(torch.relu(p.w_k(xk)))
    rgate = torch.sigmoid(p.w_r(xr))
    return rgate * p.w_v(k), {"prev": x[:, -1]}


def init_state(cfg: ModelConfig, batch: int, device) -> Dict[str, State]:
    """Per-layer decode state (O(1) in sequence length)."""
    D, N = cfg.d_model, cfg.rwkv_head_dim
    H = D // N
    adt = _dtype(cfg.activation_dtype)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return {
        "tm": {"prev": zeros((batch, D), adt), "wkv": zeros((batch, H, N, N), torch.float32)},
        "cm": {"prev": zeros((batch, D), adt)},
    }
