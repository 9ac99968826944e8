"""Core layers: norms, RoPE, GQA/MQA attention (naive, chunked online-softmax
and the CUDA flash kernel), gated MLPs, embeddings.

Counterpart of ``repro.models.layers``.  Each parameter-bearing layer is an
``nn.Module`` whose constructor is the JAX ``init_*`` (same scales) and whose
``forward`` is the JAX ``apply_*``; the attention helpers are plain functions
on tensors with the JAX layouts ((B, S, heads, hd)).  Linear weights live in
``nn.Linear``'s (out, in) layout; ``convert.py`` maps JAX's (in, out) weights
onto them.  Randomness comes from a ``torch.Generator`` and is drawn on its
device (a CUDA generator draws a large model's weights on the card); a
constructor given ``generator=None`` leaves its weights uninitialised (for
loading).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist import sharding
from ..kernels import ops as kops
from .config import ModelConfig

__all__ = ["Norm", "Attention", "MLP", "Embedding", "init_lm_head", "lm_logits",
           "rope_angles", "apply_rope", "attend"]


# -- init helpers ---------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _normal(shape, std: float, generator: Optional[torch.Generator], device,
            dtype: torch.dtype) -> nn.Parameter:
    """Normal(0, std) drawn on the generator's device, then placed on
    ``device``; ``generator=None`` leaves the weight uninitialised."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    x = torch.randn(shape, generator=generator, device=generator.device).mul_(std)
    return nn.Parameter(x.to(device=device, dtype=dtype))


def _linear(d_in: int, d_out: int, cfg: ModelConfig, generator, device,
            bias: bool = False, scale: Optional[float] = None) -> nn.Linear:
    """JAX ``_dense_init``: normal with std 1/sqrt(fan_in) (or ``scale``);
    biases start at zero."""
    dtype = _dtype(cfg.param_dtype)
    lin = nn.Linear(d_in, d_out, bias=bias, device="meta")
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    lin.weight = _normal((d_out, d_in), std, generator, device, dtype)
    if bias:
        lin.bias = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
    return lin


# -- norms ------------------------------------------------------------------------

class Norm(nn.Module):
    """``init_norm`` / ``apply_norm``: rmsnorm or layernorm.  Reductions in
    fp32, multiplies in the activation dtype."""

    def __init__(self, d: int, cfg: ModelConfig, device, eps: float = 1e-6):
        super().__init__()
        dtype = _dtype(cfg.param_dtype)
        self.kind, self.eps = cfg.norm, eps
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # on DTensors pinned to the batch's placements, its gradient too: XLA
        # sums the partial gradient of the split matmuls after the norm before
        # the norm's backward, and a DTensor norm may come out partial
        return sharding.constrain(self._norm(x))

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "layernorm":
            xf = x.float()
            mu = xf.mean(-1, keepdim=True)
            var = (xf - mu).square().mean(-1, keepdim=True)
            inv = torch.rsqrt(var + self.eps)
            y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
            return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        var = x.float().square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + self.eps)
        return x * inv.to(x.dtype) * self.scale.to(x.dtype)


# -- rotary position embeddings ----------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * sharding.replicated_like(freqs, positions)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, half) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -- attention ---------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(…, Sq, Sk) additive bias in fp32: 0 allowed / -inf masked."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = k_pos[..., None, :] >= 0  # ring-cache slots still empty carry kpos=-1
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))


def _sdpa(q, k, v, bias, softcap: Optional[float]) -> torch.Tensor:
    """q (B,Sq,H,hd) k/v (B,Sk,K,hd) bias (B,Sq,Sk) -> (B,Sq,H,hd). GQA via reshape."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + bias[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window, softcap,
                  chunk: int) -> torch.Tensor:
    """Online-softmax over q-chunks: memory O(chunk * Sk), never (Sq, Sk).

    A Python loop where JAX scans.  As JAX's ``jax.checkpoint`` on the scan
    body does, each chunk is rematerialised in the backward
    (``torch.utils.checkpoint``) when a gradient is needed, so autograd
    never keeps every chunk's (chunk, Sk) logits.  fp32 softmax."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]

    def body(qb, pb):
        n = qb.shape[1]
        qg = qb.reshape(B, n, K, H // K, hd)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        logits = logits + _mask_bias(pb, k_pos, causal, window)[:, None, None]
        m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # rows fully masked
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskd->bqkgd", (p / l.clamp_min(1e-30)).to(q.dtype), v)
        return o.reshape(B, n, H, hd)

    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for s0 in range(0, Sq, chunk):
        qb, pb = q[:, s0:s0 + chunk], q_pos[:, s0:s0 + chunk]
        outs.append(checkpoint(body, qb, pb, use_reentrant=False) if remat else body(qb, pb))
    return torch.cat(outs, dim=1)


def attend(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, cfg: ModelConfig,
           causal: bool = True, window: Optional[int] = None,
           impl: Optional[str] = None) -> torch.Tensor:
    """Scaled-dot-product attention core with mask from positions.

    ``impl="pallas"`` (the JAX name, kept so configs compare equal) selects
    the CUDA flash-attention kernel for S > 1.  On DTensors attention runs
    on each rank's batch and heads (``sharding.local_shards``), the kernel
    and the plain versions alike, as XLA partitions it."""
    impl = impl or cfg.attn_impl
    S = q.shape[1]
    if impl == "auto":
        impl = "chunked" if (k_all.shape[1] > 2048 and S > 1) else "naive"
    if impl == "pallas" and S > 1:   # on each rank's shards when q is a DTensor
        return sharding.local_shards(kops.flash_attention, q, k_all, v_all, q_pos, k_pos,
                                     causal=causal, window=window, softcap=cfg.logit_softcap)
    chunk = cfg.attn_chunk if impl == "chunked" and S > 1 else None
    return sharding.local_shards(_plain_attention, q, k_all, v_all, q_pos, k_pos, causal=causal,
                                 window=window, softcap=cfg.logit_softcap, chunk=chunk)


def _plain_attention(q, k, v, q_pos, k_pos, causal: bool, window: Optional[int],
                     softcap: Optional[float], chunk: Optional[int]) -> torch.Tensor:
    """Attention in PyTorch: online softmax over q-chunks of ``chunk``, or
    at once when ``chunk`` is None."""
    if chunk:
        return _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window, softcap, chunk)
    return _sdpa(q, k, v, _mask_bias(q_pos, k_pos, causal, window), softcap)


class Attention(nn.Module):
    """``init_attention`` / ``attention``: GQA/MQA self-attention with RoPE
    and optional q/k/v bias (JAX's ``bq``/``bk``/``bv``).  As in JAX, the
    config is an argument of every call: the weights fix the shapes, the
    call's config picks the attention implementation."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
        self.wq = _linear(D, H * hd, cfg, generator, device, bias=cfg.qkv_bias)
        self.wk = _linear(D, K * hd, cfg, generator, device, bias=cfg.qkv_bias)
        self.wv = _linear(D, K * hd, cfg, generator, device, bias=cfg.qkv_bias)
        self.wo = _linear(H * hd, D, cfg, generator, device)

    def _qkv(self, x: torch.Tensor, cfg: ModelConfig):
        B, S, _ = x.shape
        # DTensors: a projection off the model axis split over it, as XLA splits it
        proj = lambda lin: sharding.spread_linear(x, lin.weight, lin.bias)
        return (proj(self.wq).reshape(B, S, cfg.n_heads, cfg.hd),
                proj(self.wk).reshape(B, S, cfg.kv_heads, cfg.hd),
                proj(self.wv).reshape(B, S, cfg.kv_heads, cfg.hd))

    def project_qkv(self, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
        """QKV projection + RoPE.  Returns q (B,S,H,hd), k/v (B,S,K,hd)."""
        q, k, v = self._qkv(x, cfg)
        cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def forward(self, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                causal: bool = True, window: Optional[int] = None,
                impl: Optional[str] = None):
        """Self-attention (no cache).  Returns (out, (k, v)): this call's
        post-RoPE keys/values, so that prefill can fill decode caches."""
        q, k_new, v_new = self.project_qkv(x, cfg, positions)
        out = attend(q, k_new, v_new, positions, positions, cfg, causal, window, impl)
        return self.project_out(out), (k_new, v_new)

    def project_out(self, out: torch.Tensor) -> torch.Tensor:
        """The output projection of attention's (B, S, H, hd); off the model
        axis split over it, as ``_qkv``'s projections are."""
        B, S, H, hd = out.shape
        return sharding.spread_linear(out.reshape(B, S, H * hd), self.wo.weight, self.wo.bias)


# -- MLPs -------------------------------------------------------------------------

class MLP(nn.Module):
    """``init_mlp`` / ``apply_mlp``: swiglu, geglu, or tanh-gelu with biases."""

    def __init__(self, cfg: ModelConfig, generator, device, d_ff: Optional[int] = None):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        self.activation = cfg.activation
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = _linear(D, Fd, cfg, generator, device)
            self.w_up = _linear(D, Fd, cfg, generator, device)
            self.w_down = _linear(Fd, D, cfg, generator, device)
        else:
            self.w_in = _linear(D, Fd, cfg, generator, device, bias=True)
            self.w_out = _linear(Fd, D, cfg, generator, device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation == "swiglu":
            return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))
        if self.activation == "geglu":
            return self.w_down(F.gelu(self.w_gate(x), approximate="tanh") * self.w_up(x))
        return self.w_out(F.gelu(self.w_in(x), approximate="tanh"))


# -- embeddings ----------------------------------------------------------------------

class Embedding(nn.Module):
    """``init_embedding`` / ``embed_tokens``: table (V, D), std 0.02."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        V = cfg.padded_vocab or cfg.vocab_size
        self.tok = _normal((V, cfg.d_model), 0.02, generator, device,
                           _dtype(cfg.param_dtype))

    def embed_tokens(self, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """A DTensor table is gathered whole for the lookup, as XLA gathers
        a sharded table (``sharding.lookup``); the tied LM head reads it
        sharded."""
        x = sharding.lookup(self.tok, tokens).to(_dtype(cfg.activation_dtype))
        if cfg.embedding_scale:
            # the scale rounded to the activation dtype first, as JAX does
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
        return x


def init_lm_head(cfg: ModelConfig, generator, device) -> Optional[nn.Linear]:
    if cfg.tie_embeddings:
        return None
    V = cfg.padded_vocab or cfg.vocab_size
    return _linear(cfg.d_model, V, cfg, generator, device, scale=0.02)


def lm_logits(embed: Embedding, head: Optional[nn.Linear], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    # DTensors: a head off the model axis (a vocab that does not divide it) split
    # over it, as XLA splits it
    w = embed.tok if cfg.tie_embeddings or head is None else head.weight
    logits = sharding.spread_linear(x, w.to(x.dtype))
    if cfg.padded_vocab and cfg.padded_vocab > cfg.vocab_size:
        # mask the padding rows: -1e30 contributes nothing to logsumexp/argmax
        # (the positions replicated beside a DTensor's logits)
        iota = sharding.replicated_like(torch.arange(logits.shape[-1], device=logits.device),
                                        logits)
        logits = logits.masked_fill(iota >= cfg.vocab_size, -1e30)
    return logits
