"""RG-LRU recurrent block: RecurrentGemma / Griffin (arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.

Temporal block (recurrent variant):
    gate branch:      g = GeLU(x @ w_gate)
    recurrent branch: u = x @ w_x -> causal depthwise conv1d(width 4) -> RG-LRU
    output:           (g * h) @ w_out

RG-LRU:  r_t = sigmoid(x W_a + b_a), i_t = sigmoid(x W_i + b_i)
         log a_t = -c * softplus(lambda) * r_t            (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A prompt or a training sequence evaluates the linear recurrence with
``kernel_impl="pallas"`` (the JAX name) through the CUDA scan kernel
(``kernels/ops.rglru_scan``; in training its gradients come from the
backward kernel through ``RGLRUScanFn``), or with ``"jnp"`` through
``_rglru_scan``, a log-depth (Hillis-Steele) associative scan written out in
PyTorch and differentiated by autograd; decode is the single step in either
case.
Griffin's block-diagonal gate matrices are dense, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import local_rglru_scan, pin_grad, replicated_like
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import _dtype, _linear, _normal

__all__ = ["RGLRU", "apply_rglru_block", "init_state"]

State = Dict[str, torch.Tensor]

_C = 8.0  # Griffin's fixed gate sharpness
# lambda init so that a^c = exp(-c*softplus(l)) is spread in (0.9, 0.999)
_LAM_MIN, _LAM_MAX = math.log(math.exp(0.001) - 1), math.log(math.exp(0.1) - 1)


def _uniform(shape, lo: float, hi: float, generator, device) -> nn.Parameter:
    """fp32 uniform on [lo, hi), drawn on the generator's device."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, device=device, dtype=torch.float32))
    x = torch.rand(shape, generator=generator, device=generator.device) * (hi - lo) + lo
    return nn.Parameter(x.to(device))


class _Gates(nn.Module):
    def __init__(self, R: int, cfg: ModelConfig, generator, device):
        super().__init__()
        dtype = _dtype(cfg.param_dtype)
        self.w_a = _linear(R, R, cfg, generator, device, scale=1.0 / math.sqrt(R))
        self.b_a = nn.Parameter(torch.zeros(R, device=device, dtype=dtype))
        self.w_i = _linear(R, R, cfg, generator, device, scale=1.0 / math.sqrt(R))
        self.b_i = nn.Parameter(torch.zeros(R, device=device, dtype=dtype))


class RGLRU(nn.Module):
    """``init_rglru_block``."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        dtype = _dtype(cfg.param_dtype)
        D = cfg.d_model
        R = cfg.rglru_d_rnn or D
        W = cfg.conv1d_width
        self.w_gate = _linear(D, R, cfg, generator, device)
        self.w_x = _linear(D, R, cfg, generator, device)
        self.w_out = _linear(R, D, cfg, generator, device)
        self.conv_w = _normal((W, R), 1.0 / math.sqrt(W), generator, device, dtype)
        self.conv_b = nn.Parameter(torch.zeros(R, device=device, dtype=dtype))
        self.gates = _Gates(R, cfg, generator, device)
        self.lam = _uniform((R,), _LAM_MIN, _LAM_MAX, generator, device)


def _causal_conv1d(p: RGLRU, u: torch.Tensor,
                   conv_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u (B,S,R); conv_state (B,W-1,R) carries history."""
    W = p.conv_w.shape[0]
    if conv_state is None:
        conv_state = replicated_like(
            torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype, device=u.device), u)
    xext = torch.cat([conv_state.to(u.dtype), u], dim=1)      # (B, S+W-1, R)
    S = u.shape[1]
    out = sum(xext[:, i:i + S] * p.conv_w[i].to(u.dtype) for i in range(W)) \
        + p.conv_b.to(u.dtype)
    return out, xext[:, -(W - 1):]


def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, as an associative scan: log2(S)
    Hillis-Steele steps, each combining element t with element t - d
    ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2).  fp32."""
    if h0 is not None:  # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """x (B,S,D) -> (out (B,S,D), new_state {"h": (B,R) fp32, "conv": (B,W-1,R)});
    ``state`` is not written."""
    gate = F.gelu(p.w_gate(x), approximate="tanh")
    # a DTensor's gradient comes back split as u is, over the model axis, as XLA
    # reduce-scatters it: else DTensor may run w_x's weight gradient whole there
    u = pin_grad(p.w_x(x))
    u, conv_state = _causal_conv1d(p, u, state["conv"] if state else None)

    u32 = u.float()
    g = p.gates
    r = torch.sigmoid(F.linear(u32, g.w_a.weight.float()) + g.b_a.float())
    i = torch.sigmoid(F.linear(u32, g.w_i.weight.float()) + g.b_i.float())
    log_a = -_C * F.softplus(p.lam) * r                        # (B,S,R) fp32
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * u32)

    h0 = state["h"] if state else None
    if x.shape[1] == 1:
        h_prev = h0 if h0 is not None else torch.zeros_like(gated_in[:, 0])
        h_last = a[:, 0] * h_prev + gated_in[:, 0]
        h = h_last[:, None]
    elif cfg.kernel_impl == "pallas":
        # a DTensor's scan runs on each rank's batch and channels (local_map)
        h = local_rglru_scan(kops.rglru_scan, a, gated_in, h0)
        h_last = h[:, -1]
    else:
        h = _rglru_scan(a, gated_in, h0)
        h_last = h[:, -1]

    out = p.w_out(gate * h.to(x.dtype))
    return out, {"h": h_last, "conv": conv_state}


def init_state(cfg: ModelConfig, batch: int, device) -> State:
    R = cfg.rglru_d_rnn or cfg.d_model
    return {
        "h": torch.zeros((batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, R),
                            dtype=_dtype(cfg.activation_dtype), device=device),
    }
