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

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "rwkv6_scan_ref",
           "rwkv6_scan_bwd_ref", "rglru_scan_ref", "rglru_scan_bwd_ref", "moe_router_ref",
           "moe_router_bwd_ref"]


def _allowed(q_pos, k_pos, causal, window) -> torch.Tensor:
    """(B, Sq, Sk): the (query, key) pairs the mask allows."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    ok = k_pos[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return ok


def _scores(q, k, softcap):
    """Scaled (and capped) scores (B,K,G,Sq,Sk) in fp32, and tanh of the
    capped ones (None without a softcap)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(hd)
    if not softcap:
        return logits, None
    t = torch.tanh(logits / softcap)
    return t * softcap, t


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, return_lse: bool = False,
):
    """q (B,Sq,H,hd); k/v (B,Sk,K,hd); q_pos (B,Sq); k_pos (B,Sk) -> (B,Sq,H,hd).

    GQA via head grouping; invalid cache slots are k_pos < 0.  A row whose
    keys are all masked returns 0.  With ``return_lse`` also each row's
    log-sum-exp of its scaled (and capped) scores, fp32 (B, H, Sq), +inf
    for a fully masked row (the kernel's second output)."""
    B, Sq, H, hd = q.shape
    logits, _ = _scores(q, k, softcap)
    ok = _allowed(q_pos, k_pos, causal, window)
    logits = logits.masked_fill(~ok[:, None, None], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m.clamp_min(-1e30))
    l = p.sum(dim=-1, keepdim=True)
    w = p / l.clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float()).reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("inf")))
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` by the formula, in
    fp32, returned in q's dtype.  ``out`` and ``lse`` are the forward's,
    ``dout`` the gradient of ``out``.  With x the scaled (capped) scores:
    P = exp(x - lse) where the mask allows, else 0; D = rowsum(dout * out);
    dS = P (dout v^T - D) / sqrt(hd), times 1 - tanh^2 under a softcap;
    dq = dS k, dk = dS^T q and dv = P^T dout, summed over the query heads
    of each kv head."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    x, t = _scores(q, k, softcap)
    ok = _allowed(q_pos, k_pos, causal, window)[:, None, None]
    p = torch.where(ok, torch.exp(x - lse.reshape(B, K, G, Sq, 1)), torch.zeros_like(x))
    qg, dog, og = (a.float().reshape(B, Sq, K, G, hd) for a in (q, dout, out))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]        # (B,K,G,Sq,1)
    ds = p * (dp - dsum)
    if t is not None:
        ds = ds * (1 - t * t)
    ds = ds / math.sqrt(hd)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rwkv6_scan_bwd_ref(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
    ds_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Gradients (dr, dk, dv, dlogw, du, dstate) of ``rwkv6_scan_ref`` given
    ``dy``, the gradient of y, and ``ds_out``, that of the final state
    (None: the final state is not used, as in training).  Autograd of the
    sequential recurrence on fp32 copies of the inputs; each gradient is
    returned in its input's dtype."""
    xs = (r, k, v, logw, u, state)
    leaves = [x.detach().float().requires_grad_() for x in xs]
    with torch.enable_grad():
        y, s = rwkv6_scan_ref(*leaves)
        outs, grads = [y], [dy.float()]
        if ds_out is not None:
            outs.append(s)
            grads.append(ds_out.float())
        g = torch.autograd.grad(outs, leaves, grads)
    return tuple(gi.to(x.dtype) for gi, x in zip(g, xs))


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


def rglru_scan_bwd_ref(
    a: torch.Tensor, h0: Optional[torch.Tensor], h: torch.Tensor, dh: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Gradients (da, db, dh0) of ``rglru_scan_ref`` from its output ``h``
    and the gradient ``dh`` of h, in fp32, one step at a time in reverse:
    with h_{-1} = h0 (zeros when None) and g_S = 0,
    g_t = dh_t + a_{t+1} g_{t+1};  da_t = g_t h_{t-1};  db_t = g_t;
    dh0 = a_0 g_0 (None when h0 is None)."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    h_prev = torch.cat([(h0.float() if h0 is not None else torch.zeros_like(hf[:, 0]))[:, None],
                        hf[:, :-1]], dim=1)
    g = torch.zeros_like(dhf[:, 0])
    gs = []
    for t in range(a.shape[1] - 1, -1, -1):
        g = dhf[:, t] + (af[:, t + 1] * g if t + 1 < a.shape[1] else 0.0)
        gs.append(g)
    gs = torch.stack(gs[::-1], dim=1)
    dh0 = af[:, 0] * gs[:, 0] if h0 is not None else None
    return (gs * h_prev).to(a.dtype), gs.to(a.dtype), dh0


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


def moe_router_bwd_ref(logits: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                       dw: torch.Tensor) -> torch.Tensor:
    """Gradient dlogits (..., E), in the logits' dtype, of the weights of
    ``moe_router_ref`` given its outputs ``w`` and ``idx`` (..., k) and the
    gradient ``dw`` of ``w``; the indices take none.  Written out as the
    chain that autograd of JAX's ``_route`` takes, in fp32:
    p = softmax(logits); Z = max(sum_j p[idx_j], 1e-9);
    dp[idx_j] = (dw_j - sum_m dw_m w_m) / Z, 0 elsewhere;
    dlogits = p * (dp - sum_e p_e dp_e).
    The last sum is zero but for rounding, so an unselected logit gets the
    chain's rounding residue, as in JAX, not an exact zero."""
    p = torch.softmax(logits.float(), dim=-1)
    idx = idx.long()
    z = p.gather(-1, idx).sum(-1, keepdim=True).clamp_min(1e-9)
    dw = dw.float()
    dp_k = (dw - (dw * w).sum(-1, keepdim=True)) / z
    dp = torch.zeros_like(p).scatter_(-1, idx, dp_k)
    return (p * (dp - (p * dp).sum(-1, keepdim=True))).to(logits.dtype)
