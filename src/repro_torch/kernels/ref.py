"""Plain PyTorch versions of the kernels (the allclose ground truth).

Each mirrors its kernel's exact contract (shapes, dtypes, masking rules) with
straightforward tensor code: no blocking, no online softmax.  On a CPU tensor
the kernel wrappers in ``ops.py`` run these; on the card they are what each
kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention_ref", "rwkv6_scan_ref", "rglru_scan_ref", "moe_router_ref"]


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Sk,K,hd); q_pos (B,Sq); k_pos (B,Sk) -> (B,Sq,H,hd).

    GQA via head grouping; invalid cache slots are k_pos < 0.  A row whose
    keys are all masked returns 0."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(hd)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    d = q_pos[:, :, None] - k_pos[:, None, :]
    ok = k_pos[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    logits = logits.masked_fill(~ok[:, None, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m.clamp_min(-1e30))
    l = p.sum(dim=-1, keepdim=True)
    w = p / l.clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def rwkv6_scan_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential RWKV-6 WKV recurrence.

    r/k/v (B,S,H,N); logw (B,S,H,N) fp32 log-decay; u (H,N); state (B,H,N,N)
    fp32.  y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1}
    + k_t v_t^T.  Returns (y (B,S,H,N) in r's dtype, final state fp32)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S + uf * kv))
        S = torch.exp(wf[:, t])[..., None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def rglru_scan_ref(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Linear recurrence h_t = a_t * h_{t-1} + b_t, one step at a time, in
    fp32.  a/b (B,S,R); h0 (B,R) or None (zeros).  Returns h (B,S,R) in a's
    dtype."""
    af, bf = a.float(), b.float()
    h = h0.float() if h0 is not None else torch.zeros_like(bf[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def moe_router_ref(logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over experts -> top-k -> renormalise (DeepSeek convention).

    logits (..., E) of any float dtype, computed in fp32 -> (weights
    (..., k) fp32, idx (..., k) int32).  Equal probabilities go to the
    lowest index first, as ``lax.top_k`` and the kernel's argmax-and-mask
    rounds do: a stable descending sort keeps equal values in index order
    (``topk`` does not promise an order among them)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :top_k], idx[..., :top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return w, idx.to(torch.int32)
