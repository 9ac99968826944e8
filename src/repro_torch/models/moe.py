"""Fine-grained Mixture-of-Experts (DeepSeek-MoE / Granite-MoE style).

Counterpart of ``repro.models.moe``.  Tokens are split into groups of
``group_size``; within each group a capacity-bounded one-hot dispatch tensor
routes tokens to experts through einsums (``impl="einsum"``, GShard), or a
sort-based rank and a scatter build the expert buffers directly
(``impl="scatter"``).  Tokens past an expert's capacity are dropped.

Routing: softmax over all experts -> top-k -> renormalise over the selected
k (DeepSeek-MoE convention).  With ``kernel_impl="pallas"`` (the JAX name)
the router runs the CUDA kernel (``kernels/ops.moe_router``), with ``"jnp"``
its plain version; the softmax that the aux loss reads is computed apart in
both cases.  Shared experts (always on) are a plain dense MLP added to the
routed output.  The aux load-balance loss is Switch-style
``E * sum_e f_e * p_e``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import sharding
from ..kernels import ops as kops
from ..kernels import ref as kref
from . import layers as L
from .config import ModelConfig, MoEConfig

__all__ = ["MoELayer", "apply_moe_layer"]


class MoELayer(nn.Module):
    """``init_moe_layer``: ``router`` (D, E) and ``experts.w_gate`` /
    ``w_up`` (E, D, Fe), ``w_down`` (E, Fe, D), plain parameters in JAX's
    layout; ``shared``, an MLP of width ``n_shared * d_expert``, when there
    are shared experts.  As JAX's ``_dense_init`` does, the expert tensors
    take their std from the leading axis, 1/sqrt(E)."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        moe = cfg.moe
        dtype = L._dtype(cfg.param_dtype)
        D, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
        self.router = L._normal((D, E), 0.02, generator, device, dtype)
        std = 1.0 / math.sqrt(E)
        self.experts = nn.ParameterDict({
            "w_gate": L._normal((E, D, Fe), std, generator, device, dtype),
            "w_up": L._normal((E, D, Fe), std, generator, device, dtype),
            "w_down": L._normal((E, Fe, D), std, generator, device, dtype),
        })
        if moe.n_shared:
            self.shared = L.MLP(cfg, generator, device, d_ff=moe.n_shared * moe.d_expert)


def _capacity(S: int, moe: MoEConfig) -> int:
    return max(1, int(math.ceil(S * moe.top_k / moe.n_experts * moe.capacity_factor)))


def _route(logits: torch.Tensor, moe: MoEConfig, kernel_impl: str = "jnp"
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (G, S, E) -> (weights (G,S,k) fp32, expert_idx (G,S,k) int32,
    probs (G,S,E) fp32).  ``kernel_impl="pallas"`` routes through the kernel
    entry, anything else through its plain version; both take the (G, S, E)
    logits as they are (no reshape to rows and back: on the card each
    costs the host a few microseconds, once per MoE layer of every decode
    step)."""
    probs = torch.softmax(logits.float(), dim=-1)
    router = kops.moe_router if kernel_impl == "pallas" else kref.moe_router_ref
    # a DTensor's rows each on their rank (local_map): the plain version's
    # stable sort, too, is differentiated by a scatter that DTensor refuses
    top_w, top_idx = sharding.local_moe_router(router, logits, moe.top_k)
    return top_w, top_idx, probs


def _dispatch_tensors(top_w: torch.Tensor, top_idx: torch.Tensor, moe: MoEConfig,
                      S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch/combine tensors.

    top_w/top_idx: (G, S, k).  Returns
      dispatch (G, S, E, C) one-hot float: token s of group g goes to slot c of expert e
      combine  (G, S, E, C): dispatch * routing weight
    Tokens past expert capacity C are dropped (standard GShard): their slot
    row is all zero, as ``jax.nn.one_hot`` gives for an index >= C.  Both
    one-hots are comparisons with an ``arange``: ``F.one_hot`` raises for
    the slot index >= C, and reads its indices' maximum with ``.item()``,
    which ``torch.func.vmap`` refuses."""
    E = moe.n_experts
    C = _capacity(S, moe)
    experts = sharding.replicated_like(torch.arange(E, device=top_idx.device), top_idx)
    onehot = (top_idx[..., None] == experts).float()                # (G,S,k,E)
    # position of each (token, k) among that expert's tokens, in token order.
    # The scan runs along the last axis: down axis 1 PyTorch's CUDA scan walks
    # each of the G*E columns in order on one thread.  Sums of 0/1 below 2**24
    # are exact in fp32, so any order gives JAX's positions bit for bit.
    flat = onehot.reshape(onehot.shape[0], -1, E)                   # (G, S*k, E)
    pos = torch.cumsum(flat.transpose(1, 2), dim=-1).transpose(1, 2) - flat
    pos = pos.reshape(onehot.shape)                                 # (G,S,k,E)
    in_cap = (pos < C).float() * onehot
    slots = sharding.replicated_like(torch.arange(C, device=pos.device), pos)
    slot = (pos.long()[..., None] == slots).float()                 # (G,S,k,E,C)
    disp_k = in_cap[..., None] * slot
    dispatch = disp_k.sum(2)                                        # (G,S,E,C)
    combine = (disp_k * top_w[..., None, None]).sum(2)              # (G,S,E,C)
    return dispatch, combine


def _rank_within_expert(e_flat: torch.Tensor) -> torch.Tensor:
    """e_flat (G, N) expert ids -> rank of each token among same-expert
    tokens, in token order.  Sort-based, (G, N) intermediates only."""
    G, N = e_flat.shape
    order = torch.argsort(e_flat, dim=1, stable=True)
    es = torch.gather(e_flat, 1, order)
    idx = torch.arange(N, device=e_flat.device).expand(G, N)
    first = torch.cat([torch.ones((G, 1), dtype=torch.bool, device=e_flat.device),
                       es[:, 1:] != es[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=1).values
    rank_sorted = idx - seg_start
    inv = torch.argsort(order, dim=1)            # scatter ranks back to token order
    return torch.gather(rank_sorted, 1, inv)


def _experts_ffn(we, expert_in: torch.Tensor, cfg: ModelConfig,
                 spec: str) -> torch.Tensor:
    """Every expert's gated MLP on its buffer: ``we`` holds the experts'
    ``w_gate``, ``w_up`` and ``w_down``; ``spec`` names the buffer's axes
    around the expert axis ``e`` (``"egcd"`` or ``"gecd"``)."""
    dtype = expert_in.dtype
    hidden = spec.replace("d", "f")
    # DTensors: on each rank's shards, split as the buffer is; where its d_model
    # is split (a decode step's one group), the products' fan-in and w_down's
    # output are split with it, as XLA splits them, and the partial sums summed
    h_gate, h_up = (sharding.whole_on(sharding.local_einsum(
        f"{spec},edf->{hidden}", expert_in, we[w].to(dtype))) for w in ("w_gate", "w_up"))
    act = F.silu(h_gate) if cfg.activation == "swiglu" else F.gelu(h_gate, approximate="tanh")
    w_down = sharding.split_like(we["w_down"].to(dtype), expert_in, {spec.index("d"): 2})
    return sharding.local_einsum(f"{hidden},efd->{spec}", act * h_up, w_down)


def _router_logits(p: MoELayer, xg: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    router_dtype = L._dtype(moe.router_dtype)
    # DTensors: the product split over the axes that nothing else splits, as XLA's
    logits = sharding.spread_product(lambda x: x.to(router_dtype) @ p.router.to(router_dtype),
                                     xg, p.router, overs=("data", "model"))
    return sharding.constrain(logits)   # (G,S,E)


def _apply_moe_scatter(p: MoELayer, xg: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort/scatter dispatch: no (G,S,E,C) one-hot tensors.

    xg (G, S, D) -> (out (G, S, D), aux).  Slots come from ranking tokens
    within their expert; an indexed write builds the expert buffers, with
    dropped tokens sent to a trash slot, and an indexed read applies the
    combine weights (``_scatter_dispatch``).  A DTensor's groups and
    experts each on their rank (``sharding.local_moe_scatter``)."""
    moe = cfg.moe
    S = xg.shape[1]
    top_w, top_idx, probs = _route(_router_logits(p, xg, moe), moe, cfg.kernel_impl)
    we = p.experts
    y, counts = sharding.local_moe_scatter(
        lambda *a: _scatter_dispatch(*a, cfg=cfg), xg, top_w, top_idx,
        we["w_gate"], we["w_up"], we["w_down"])

    # aux load-balance: dispatched fraction per expert via scatter-add counts
    f = counts / (S * 1.0)
    pbar = probs.mean(1)
    aux = moe.n_experts * torch.mean(torch.sum(f * pbar, dim=-1))
    return y, aux.float()


def _scatter_dispatch(xg: torch.Tensor, top_w: torch.Tensor, top_idx: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                      first, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter dispatch through the experts ``first`` .. ``first + El
    - 1`` that ``w_gate`` (El, D, Fe) holds: (the routed output of those
    experts (G, S, D), the tokens kept in each of all E experts (G, E)).
    Tokens routed to other experts go to the trash slot El*C, whose output
    is zero."""
    moe = cfg.moe
    G, S, D = xg.shape
    E, k = moe.n_experts, moe.top_k
    El = w_gate.shape[0]
    C = _capacity(S, moe)
    dtype = xg.dtype

    e_flat = top_idx.reshape(G, S * k).long()
    rank = _rank_within_expert(e_flat)                          # (G, S*k)
    kept = rank < C
    local = e_flat - first
    keep = kept & (local >= 0) & (local < El)
    slot = torch.where(keep, local * C + rank, El * C)          # trash slot El*C

    rows = torch.arange(G, device=xg.device)[:, None]
    buf = xg.new_zeros((G, El * C + 1, D))
    buf[rows, slot] = xg.repeat_interleave(k, dim=1)            # (G, S*k, D) in
    expert_out = _experts_ffn({"w_gate": w_gate, "w_up": w_up, "w_down": w_down},
                              buf[:, :El * C].reshape(G, El, C, D), cfg, "gecd")

    out_flat = torch.cat([expert_out.reshape(G, El * C, D), xg.new_zeros((G, 1, D))], dim=1)
    y_k = out_flat[rows, slot]                                  # (G, S*k, D)
    y = (y_k.reshape(G, S, k, D) * top_w.reshape(G, S, k, 1).to(dtype)).sum(dim=2)

    counts = torch.zeros((G, E), dtype=torch.float32, device=xg.device)
    counts.scatter_add_(1, e_flat, kept.float())
    return y, counts


def apply_moe_layer(p: MoELayer, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar fp32)."""
    moe = cfg.moe
    B, S, D = x.shape
    g = moe.group_size
    n_tokens = B * S
    n_groups = max(1, n_tokens // g)
    xt = x.reshape(n_tokens, D)
    pad = 0
    if n_tokens % g:
        # pad the token count to a multiple of the group size
        pad = n_groups * g + (g if n_tokens > n_groups * g else 0) - n_tokens
        # (a zero block appended: torch 2.11's DTensor pad loses a 2-D mesh's placements)
        zeros = torch.zeros((pad, D), dtype=xt.dtype, device=xt.device)
        xt = torch.cat([xt, sharding.replicated_like(zeros, xt)])
        n_groups = xt.shape[0] // g
    # a DTensor's gradient comes back as the groups were placed: from the
    # dispatch it may come split over two mesh axes, which DTensor cannot
    # fold back into a batch dim of fewer rows than ranks
    xg = sharding.pin_grad(xt.reshape(n_groups, g, D))

    if moe.impl == "scatter":
        routed, aux = _apply_moe_scatter(p, xg, cfg)
    else:
        top_w, top_idx, probs = _route(_router_logits(p, xg, moe), moe, cfg.kernel_impl)
        dispatch, combine = _dispatch_tensors(top_w, top_idx, moe, g)

        # aux load-balance loss (Switch): E * mean_e[f_e * p_e]
        f = dispatch.sum((1, 3)) / g                       # (G, E) fraction dispatched
        pbar = probs.mean(1)                               # (G, E)
        aux = moe.n_experts * torch.mean(torch.sum(f * pbar, dim=-1))

        dtype = xg.dtype
        # on DTensors the experts split over the model axis, as their weights are,
        # and the slots over the data axes where these split no group (decode)
        dispatch, combine = (sharding.spread_over_idle(t, dim=2) for t in (dispatch, combine))
        combine = sharding.spread_over_idle(combine, dim=3, over="data")
        dispatch = sharding.spread_over_idle(dispatch, dim=1, over="data")
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(dtype),
                                 sharding.spread_over_idle(xg, dim=1, over="data"))
        # (E,G,C,D): the slots over the data axes where these split no group, else d_model
        expert_in = sharding.spread_over_idle(expert_in, dim=2, over="data")
        expert_in = sharding.spread_over_idle(expert_in, dim=3, over="data")
        # (placed as its input: DTensor may split the slots unevenly inside)
        expert_out = sharding.placed_like(_experts_ffn(p.experts, expert_in, cfg, "egcd"),
                                         expert_in)
        # (G,S,D) on each rank's shards: in decode it sums over the experts,
        # split over the model axis, and the slots, split over the data axes,
        # which DTensor's einsum flattens into one dim with its inner dim
        # split, as torch 2.11 refuses; the partial sums are summed below.
        # The experts' label sorts first: the plain einsum sums experts-major
        routed = sharding.local_einsum("gsac,agcd->gsd", combine.to(dtype), expert_out)

    # a DTensor's groups back on the batch's placements first: DTensor mis-splits
    # a token dim split over more ranks than the batch dim it unflattens into
    out = sharding.constrain(routed).reshape(-1, D)
    if pad:   # (a DTensor's full slice would gather the token dim)
        out = out[:n_tokens]
    out = out.reshape(B, S, D)
    if moe.n_shared:
        out = out + p.shared(x)
    return out, aux.float()
