"""The port's RWKV-6 and RG-LRU scans against the JAX package's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.rwkv6_scan`` / ``rglru_scan`` run
their plain versions; they are held against the JAX Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and against
``repro.kernels.ref``, on the cases of ``TestRWKV6Scan`` and
``TestRGLRUScan``.  Their backwards (``rwkv6_scan_bwd``, ``rglru_scan_bwd``;
JAX has no backward kernel and differentiates jnp) are held against
``jax.grad`` of JAX's ``rwkv6_scan_ref``, of ``models.rwkv6._wkv_chunked``
and of ``rglru_scan_ref``, and so are the backward kernels' chunked
algorithm and its grads kernel's sub-chunk decomposition, emulated in
plain PyTorch.  The CUDA kernels themselves are held
against the plain versions by the ``gpu`` tests, which skip without a card.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rwkv6 as jrwkv6

from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rglru_scan as prg
from repro_torch.kernels import rwkv6_scan as prw

# Tolerances of tests/test_kernels.py: 1e-4 for the fp32 WKV scan (chunked
# sums in another order than the sequential one), 5e-2 with bf16 r/k/v,
# 1e-5 for the RG-LRU recurrence (one multiply-add per step).
RWKV_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
RGLRU_ATOL = 1e-5
# Gradients against jax.grad, normwise (max |port - jax| over max(1, max
# |jax|)): the kernel tolerances of tests/test_kernels.py, 2e-5 in fp32 (the
# sums of a chunk, or of the sequential steps, in another order; readings at
# most 6.2e-7 on these cases) and 2e-2 with bf16 r/k/v (each side rounds
# its fp32 gradient to bf16 once).
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# K2's backward kernel against the plain backward on the card, normwise: the
# limits chip_smoke.py holds it to (readings on an H100 at most 1.0e-6 in
# fp32, 5.5e-6 with strong decay, and 3.6e-3, one bf16 ulp, with bf16
# r/k/v).
CARD_GRAD_TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}


# log(-logw) ~ N(shift, 0.5): TestRWKV6Scan's draw (-2.0, about 0.14 an
# e-fold a step), and a strong decay (about 3.1 a step: e^{ce_t - c_s}
# spans tens of e-folds within a chunk).
USUAL_DECAY, STRONG_DECAY = -2.0, 1.0


def _rwkv_inputs(seed, B, S, H, N, decay=USUAL_DECAY):
    """The draws of TestRWKV6Scan._inputs, made with numpy; ``decay`` shifts
    log(-logw)."""
    rng = np.random.default_rng(seed)
    n = lambda shape, scale: (rng.standard_normal(shape) * scale).astype(np.float32)
    r, k, v = n((B, S, H, N), 0.5), n((B, S, H, N), 0.5), n((B, S, H, N), 0.5)
    logw = -np.exp(n((B, S, H, N), 0.5) + decay)
    return r, k, v, logw, n((H, N), 0.3), n((B, H, N, N), 0.2)


def _rglru_inputs(seed, B, S, R):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, R))))
    b = rng.standard_normal((B, S, R)) * 0.3
    h0 = rng.standard_normal((B, R)) * 0.2
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


def _rwkv_all(arrays, chunk, dtype="float32"):
    """(port, JAX Pallas interpret, JAX ref) as float32 numpy pairs (y, state)."""
    r, k, v, logw, u, s0 = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jr, jk, jv = (jnp.asarray(a).astype(jd) for a in (r, k, v))
    jw, ju, js = (jnp.asarray(a) for a in (logw, u, s0))
    pr, pk, pv = (torch.from_numpy(a).to(td) for a in (r, k, v))
    py, ps = pops.rwkv6_scan(pr, pk, pv, torch.from_numpy(logw), torch.from_numpy(u),
                             torch.from_numpy(s0), chunk=chunk)
    assert py.dtype == td and ps.dtype == torch.float32
    outs = [(py.float().numpy(), ps.numpy())]
    for y, s in (jops.rwkv6_scan(jr, jk, jv, jw, ju, js, chunk=chunk),
                 jref.rwkv6_scan_ref(jr, jk, jv, jw, ju, js)):
        outs.append((np.asarray(y, np.float32), np.asarray(s)))
    return outs


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 32, 1, 8, 8), (2, 50, 3, 16, 16), (2, 64, 2, 32, 32),
    (1, 100, 2, 16, 64),
])
def test_rwkv6_shape_sweep(B, S, H, N, chunk):
    port, jax_k, jax_r = _rwkv_all(_rwkv_inputs(0, B, S, H, N), chunk)
    for other in (jax_k, jax_r):
        np.testing.assert_allclose(port[0], other[0], atol=RWKV_ATOL["float32"])
        np.testing.assert_allclose(port[1], other[1], atol=RWKV_ATOL["float32"])


def test_rwkv6_bfloat16_inputs():
    port, jax_k, jax_r = _rwkv_all(_rwkv_inputs(1, 2, 32, 2, 16), 16, "bfloat16")
    for other in (jax_k, jax_r):
        np.testing.assert_allclose(port[0], other[0], atol=RWKV_ATOL["bfloat16"])
        np.testing.assert_allclose(port[1], other[1], atol=RWKV_ATOL["bfloat16"])


def test_rwkv6_state_chaining():
    """Two halves with the carried state == one run (the plain version)."""
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _rwkv_inputs(2, 1, 64, 2, 8))
    y_full, s_full = pops.rwkv6_scan(r, k, v, logw, u, s0, chunk=16)
    y1, s_mid = pops.rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], logw[:, :32], u, s0, chunk=16)
    y2, s_end = pops.rwkv6_scan(r[:, 32:], k[:, 32:], v[:, 32:], logw[:, 32:], u, s_mid,
                                chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=1e-4)


# -- K2's two-kernel split, emulated on the CPU ---------------------------------------

def _two_pass_emulation(r, k, v, logw, u, s0, chunk):
    """K2's two CUDA kernels in plain PyTorch, fp32, in chunks of min(chunk, S)
    rows.  Pass 1 (the states kernel) carries the state through the chunks
    in order and keeps the state entering each; pass 2 (the outputs kernel)
    then computes every chunk's y at once from the state entering it.  The
    rows past S in the last chunk read r = k = v = 0 and logw = 0."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    nc = -(-S // L)
    rc, kc, vc, wc = (torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, nc * L - S))
                      .reshape(B, nc, L, H, N).permute(0, 3, 1, 2, 4)      # (B,H,nc,L,N)
                      for a in (r, k, v, logw))
    cum = wc.cumsum(3)
    cum_excl = cum - wc
    last = cum[:, :, :, -1]                                                  # (B,H,nc,N)
    k_dec = kc * torch.exp(last[:, :, :, None] - cum)
    entering, state = [], s0.float()
    for c in range(nc):                                                      # pass 1
        entering.append(state)
        state = (torch.exp(last[:, :, c])[..., None] * state
                 + k_dec[:, :, c].transpose(-1, -2) @ vc[:, :, c])
    entering = torch.stack(entering, 2)                                      # (B,H,nc,N,N)
    below = torch.tril(torch.ones((L, L), dtype=torch.bool), diagonal=-1)    # pass 2
    ratio = (cum_excl[..., :, None, :] - cum[..., None, :, :]).masked_fill(
        ~below[..., None], float("-inf"))
    A = (rc[..., :, None, :] * kc[..., None, :, :] * torch.exp(ratio)).sum(-1)
    A = A + torch.diag_embed((rc * u.float()[None, :, None, None, :] * kc).sum(-1))
    y = A @ vc + (rc * torch.exp(cum_excl)) @ entering
    return y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, N)[:, :S].to(r.dtype), state


@pytest.mark.parametrize("B,S,H,N,chunk,dtype,zero_state", [
    (2, 50, 3, 16, 16, "float32", False),     # ragged last chunk
    (1, 33, 2, 16, 16, "float32", False),     # one row in the last chunk
    (2, 20, 2, 16, 32, "float32", False),     # one chunk shorter than L
    (2, 64, 2, 32, 32, "float32", False),     # chunks of 32
    (1, 96, 2, 16, 32, "float32", True),      # zero initial state, 3 chunks
    (2, 50, 2, 16, 16, "bfloat16", False),    # bf16 r/k/v, ragged
])
def test_two_pass_split_matches_jax(B, S, H, N, chunk, dtype, zero_state):
    """The chunk-state pass and the output pass, computed apart, give the JAX
    Pallas kernel's (interpret mode) and the JAX sequential reference's y
    and final state."""
    r, k, v, logw, u, s0 = _rwkv_inputs(11, B, S, H, N)
    if zero_state:
        s0 = np.zeros_like(s0)
    td = getattr(torch, dtype)
    y, s = _two_pass_emulation(*(torch.from_numpy(a).to(td) for a in (r, k, v)),
                               *(torch.from_numpy(a) for a in (logw, u, s0)), chunk)
    assert y.dtype == td and s.dtype == torch.float32
    jr, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (r, k, v))
    jw, ju, js = (jnp.asarray(a) for a in (logw, u, s0))
    for y_j, s_j in (jops.rwkv6_scan(jr, jk, jv, jw, ju, js, chunk=chunk),
                     jref.rwkv6_scan_ref(jr, jk, jv, jw, ju, js)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                                   atol=RWKV_ATOL[dtype])
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=RWKV_ATOL[dtype])


# -- K2's backward ----------------------------------------------------------------

def _normwise(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(1.0, np.abs(ref).max()))


def _cotangents(seed, B, S, H, N):
    """dy and ds_out, the gradients of y and of the final state."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, N)).astype(np.float32),
            rng.standard_normal((B, H, N, N)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_wkv_vjp(name, which):
    """jax.vjp of JAX's sequential reference (``which="ref"``) or of its
    chunked model scan (``"chunked"``), jitted, at the inputs of
    ``BWD_CASES[name]``; one trace a case, shared by the tests."""
    arrays, _, _, chunk, dtype = _bwd_case(name, False)
    fn = jax.jit(jref.rwkv6_scan_ref if which == "ref"
                 else functools.partial(jrwkv6._wkv_chunked, chunk=chunk))
    jd = getattr(jnp, dtype)
    xs = (*(jnp.asarray(a).astype(jd) for a in arrays[:3]), *(jnp.asarray(a) for a in arrays[3:]))
    (y, s), vjp = jax.vjp(fn, *xs)
    return vjp, y.dtype, s


def _jax_wkv_grads(name, which, dy, ds_out):
    """JAX's gradients of r, k, v, logw, u and the initial state at case
    ``name``, for cotangents dy and ds_out (None: zeros)."""
    vjp, y_dtype, s = _jax_wkv_vjp(name, which)
    cot = (jnp.asarray(dy).astype(y_dtype),
           jnp.zeros_like(s) if ds_out is None else jnp.asarray(ds_out))
    return [np.asarray(g, np.float32) for g in vjp(cot)]


def _chunks(r, k, v, logw, dy, chunk):
    """(r, k, v, logw, dy) padded to whole chunks of L = min(chunk, S) rows
    (0, and logw 0, past S) as (B, H, nc, L, N) fp32, with the running sums
    c (inclusive) and ce (exclusive) of logw and cL, c at each chunk's last
    row (B, H, nc, N)."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    nc = -(-S // L)
    rc, kc, vc, wc, yc = (torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, nc * L - S))
                          .reshape(B, nc, L, H, N).permute(0, 3, 1, 2, 4)      # (B,H,nc,L,N)
                          for a in (r, k, v, logw, dy))
    cum = wc.cumsum(3)
    return rc, kc, vc, yc, cum, cum - wc, cum[:, :, :, -1]


def _state_walks(rc, kc, vc, yc, cum, ce, cl, s0, ds_out):
    """The forward's chunk states S entering each chunk, and the states
    kernel's reverse walk, dS = e^{cL} dS' + (r e^{ce})^T dy, keeping the
    dS' leaving each chunk: (S (B,H,nc,N,N), dS' (B,H,nc,N,N), dstate)."""
    nc = rc.shape[2]
    kd = torch.exp(cl[:, :, :, None] - cum)                                  # e^{cL - c}
    entering, state = [], s0.float()
    for c in range(nc):
        entering.append(state)
        state = (torch.exp(cl[:, :, c])[..., None] * state
                 + (kc[:, :, c] * kd[:, :, c]).transpose(-1, -2) @ vc[:, :, c])
    dS = torch.zeros_like(s0.float()) if ds_out is None else ds_out.float()
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = dS
        dS = (torch.exp(cl[:, :, c])[..., None] * dS
              + (rc[:, :, c] * torch.exp(ce[:, :, c])).transpose(-1, -2) @ yc[:, :, c])
    return torch.stack(entering, 2), torch.stack(leaving, 2), dS


def _unchunk(x, S):
    B, H, nc, L, N = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, N)[:, :S]


def _bwd_emulation(r, k, v, logw, u, s0, dy, ds_out, chunk):
    """K2's backward's chunked algorithm in plain PyTorch, fp32, in chunks of
    min(chunk, S) rows, with every pair's decay e^{ce_t - c_s} taken over
    the whole chunk: the chunk states entering each chunk (the forward's
    workspace); the states kernel's reverse walk, dS = e^{cL} dS' +
    (r e^{ce})^T dy, keeping the dS' leaving each chunk; then every chunk at
    once: dr, dk and dv from A, dA, S and dS', du summed over b and t, and
    dlogw_j = sum_{t>j} rho_t - sum_{s>=j} kappa_s + sigma.  Returns (dr,
    dk, dv, dlogw, du, dstate)."""
    S = r.shape[1]
    rc, kc, vc, yc, cum, ce, cl = _chunks(r, k, v, logw, dy, chunk)
    L = rc.shape[3]
    kd = torch.exp(cl[:, :, :, None] - cum)                                  # e^{cL - c}
    S_in, dSp, dS = _state_walks(rc, kc, vc, yc, cum, ce, cl, s0, ds_out)
    below = torch.tril(torch.ones((L, L), dtype=torch.bool), diagonal=-1)    # grads kernel
    E = torch.exp((ce[..., :, None, :] - cum[..., None, :, :]).masked_fill(
        ~below[..., None], float("-inf")))                                   # (...,t,s,n)
    uf = u.float()[None, :, None, None, :]
    A = (torch.einsum("...tn,...sn,...tsn->...ts", rc, kc, E)
         + torch.diag_embed((rc * uf * kc).sum(-1)))
    dA = yc @ vc.transpose(-1, -2)
    dA_below = dA * below
    dA_diag = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]
    intra_r = torch.einsum("...ts,...sn,...tsn->...tn", dA_below, kc, E)
    inter_r = torch.exp(ce) * (yc @ S_in.transpose(-1, -2))
    intra_k = torch.einsum("...ts,...tn,...tsn->...sn", dA_below, rc, E)
    inter_k = kd * (vc @ dSp.transpose(-1, -2))
    dr = intra_r + uf * kc * dA_diag + inter_r
    dk = intra_k + uf * rc * dA_diag + inter_k
    dv = (A * ~below.T).transpose(-1, -2) @ yc + (kc * kd) @ dSp
    du = (rc * kc * dA_diag).sum((0, 2, 3))
    rho, kappa = rc * (intra_r + inter_r), kc * (intra_k + inter_k)
    sigma = torch.exp(cl) * (S_in * dSp).sum(-1) + (kc * inter_k).sum(3)
    from_end = lambda x: x.flip(3).cumsum(3).flip(3)                         # sum over t >= j
    dlogw = from_end(rho) - rho - from_end(kappa) + sigma[:, :, :, None]
    return (_unchunk(dr, S).to(r.dtype), _unchunk(dk, S).to(r.dtype),
            _unchunk(dv, S).to(r.dtype), _unchunk(dlogw, S), du, dS)


SUBCHUNK = 16   # the grads kernel's sub-chunk rows (csrc/rwkv6_scan_bwd.cu, LS)


def _exp_le1(x, scale):
    """e^x for exponents that are never above 0, but for the rounding of the
    running sums (of magnitude ``scale``) that they are differences of: what
    keeps the factors of the sub-chunk decomposition from overflowing."""
    assert float(x.max()) <= 8 * 2.0**-24 * max(1.0, scale), float(x.max())
    return torch.exp(x)


def _subchunk_emulation(r, k, v, logw, u, s0, dy, ds_out, chunk, ls=SUBCHUNK):
    """K2's backward as ``csrc/rwkv6_scan_bwd.cu``'s grads kernel forms it
    since its redesign, in plain PyTorch, fp32, term by term.  Within a chunk
    the rows fall in sub-chunks of ``ls``.  A pair (t, s) in one sub-chunk
    (a diagonal block) has one exponential e^{ce_t - c_s} a channel, made
    once and used for A, dr and dk.  A pair in different sub-chunks factors
    its decay at a sub-chunk boundary b, both exponents <= 0: for A and dr
    at the start of t's sub-chunk, A = (r e^{ce - ce_b})(k e^{ce_b - c})^T and
    dr_t += e^{ce_t - ce_b} (dA (k e^{ce_b - c}))_t; for dk at the end e of
    s's sub-chunk, dk_s += e^{c_e - c_s} (dA^T (r e^{ce - c_e}))_s.  e^{cL - c}
    and e^{ce} are made once an entry.  dA's diagonal, du and the u terms as
    before; rho and kappa from their own terms; dlogw one running sum a
    channel from the last row: acc = sigma; acc -= kappa_j; dlogw_j = acc;
    acc += rho_j.  Returns (dr, dk, dv, dlogw, du, dstate)."""
    S = r.shape[1]
    rc, kc, vc, yc, cum, ce, cl = _chunks(r, k, v, logw, dy, chunk)
    L = rc.shape[3]
    ex = functools.partial(_exp_le1, scale=float(cum.abs().max()))
    fl = ex(cl[:, :, :, None] - cum)                                   # e^{cL - c}
    S_in, dSp, dS = _state_walks(rc, kc, vc, yc, cum, ce, cl, s0, ds_out)
    uf = u.float()[None, :, None, None, :]
    dA = yc @ vc.transpose(-1, -2)
    dAd = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]                    # dA[t, t]
    A = torch.zeros(dA.shape)
    intra_r, intra_k = torch.zeros_like(rc), torch.zeros_like(kc)
    starts = range(0, L, ls)
    for b in starts:
        t = slice(b, min(b + ls, L))
        n = t.stop - t.start
        # the diagonal block: one exponential a (t, s, n), for A, dr and dk
        below = torch.tril(torch.ones((n, n), dtype=torch.bool), diagonal=-1)
        diff = (ce[..., t, None, :] - cum[..., None, t, :]).masked_fill(~below[..., None], -1.0)
        E = ex(diff) * below[..., None]                                # (...,t,s,n)
        dAb = dA[..., t, t] * below
        A[..., t, t] = (torch.einsum("...tn,...sn,...tsn->...ts", rc[..., t, :], kc[..., t, :], E)
                        + torch.diag_embed((rc * uf * kc)[..., t, :].sum(-1)))
        intra_r[..., t, :] += torch.einsum("...ts,...sn,...tsn->...tn", dAb, kc[..., t, :], E)
        intra_k[..., t, :] += torch.einsum("...ts,...tn,...tsn->...sn", dAb, rc[..., t, :], E)
        if b:   # the rows before t's sub-chunk, factored at b
            ft = ex(ce[..., t, :] - ce[..., b:b + 1, :])
            ks_ = kc[..., :b, :] * ex(ce[..., b:b + 1, :] - cum[..., :b, :])
            A[..., t, :b] = (rc[..., t, :] * ft) @ ks_.transpose(-1, -2)
            intra_r[..., t, :] += ft * (dA[..., t, :b] @ ks_)
        e = t.stop
        if e < L:   # the rows after s's sub-chunk, factored at its end e
            fs = ex(cum[..., e - 1:e, :] - cum[..., t, :])
            rt = rc[..., e:, :] * ex(ce[..., e:, :] - cum[..., e - 1:e, :])
            intra_k[..., t, :] += fs * (dA[..., e:, t].transpose(-1, -2) @ rt)
    inter_r = ex(ce) * (yc @ S_in.transpose(-1, -2))                   # e^{ce} (S dy)
    inter_k = fl * (vc @ dSp.transpose(-1, -2))                              # e^{cL - c} (dS' v)
    dr = intra_r + uf * kc * dAd + inter_r
    dk = intra_k + uf * rc * dAd + inter_k
    dv = A.transpose(-1, -2) @ yc + (kc * fl) @ dSp
    du = (rc * kc * dAd).sum((0, 2, 3))
    rho, kappa = rc * (intra_r + inter_r), kc * (intra_k + inter_k)
    acc = ex(cl) * (S_in * dSp).sum(-1) + (kc * inter_k).sum(3)        # sigma
    dlogw = torch.zeros_like(rho)
    for j in reversed(range(L)):
        acc = acc - kappa[:, :, :, j]
        dlogw[:, :, :, j] = acc
        acc = acc + rho[:, :, :, j]
    return (_unchunk(dr, S).to(r.dtype), _unchunk(dk, S).to(r.dtype),
            _unchunk(dv, S).to(r.dtype), _unchunk(dlogw, S), du, dS)


BWD_CASES = {   # (B, S, H, N), chunk, dtype, zero initial state, decay
    "ragged last chunk": ((2, 50, 3, 16), 16, "float32", False, USUAL_DECAY),
    "one row in the last chunk": ((1, 33, 2, 16), 16, "float32", False, USUAL_DECAY),
    "one chunk shorter than L": ((2, 20, 2, 16), 32, "float32", False, USUAL_DECAY),
    "zero initial state, 3 chunks": ((1, 96, 2, 16), 32, "float32", True, USUAL_DECAY),
    "bf16 r/k/v, ragged": ((2, 50, 2, 16), 16, "bfloat16", False, USUAL_DECAY),
    # chunks of 24 rows and a last one of 3: sub-chunks of 16, 8 and 3
    "chunk not a multiple of the sub-chunk": ((1, 75, 2, 16), 24, "float32", False,
                                              USUAL_DECAY),
    "strong decay": ((2, 70, 2, 16), 32, "float32", False, STRONG_DECAY),
}


def _bwd_case(name, with_ds_out):
    shape, chunk, dtype, zero, decay = BWD_CASES[name]
    arrays = list(_rwkv_inputs(12, *shape, decay))
    if zero:
        arrays[5] = np.zeros_like(arrays[5])
    dy, ds_out = _cotangents(13, *shape)
    return arrays, dy, ds_out if with_ds_out else None, chunk, dtype


def _port(arrays, dy, ds_out, dtype):
    td = getattr(torch, dtype)
    return (*(torch.from_numpy(a).to(td) for a in arrays[:3]),
            *(torch.from_numpy(a) for a in arrays[3:]), torch.from_numpy(dy).to(td),
            None if ds_out is None else torch.from_numpy(ds_out))


def _assert_grads_close(port, expect, dtype, tol=GRAD_TOL):
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate")
    errs = {n: _normwise(p.float().numpy(), e) for n, p, e in zip(names, port, expect)}
    assert max(errs.values()) <= tol[dtype], errs


@pytest.mark.parametrize("name", list(BWD_CASES))
@pytest.mark.parametrize("with_ds_out", [False, True])
def test_rwkv6_bwd_ref_matches_jax_grad(name, with_ds_out):
    """The plain backward against jax.grad of JAX's sequential reference and
    of its chunked model scan; without ds_out the final state is unused, as
    in training."""
    arrays, dy, ds_out, chunk, dtype = _bwd_case(name, with_ds_out)
    xs = _port(arrays, dy, ds_out, dtype)
    port = pops.rwkv6_scan_bwd(*xs[:6], None, *xs[6:])   # the plain version reads no states
    td = getattr(torch, dtype)
    assert [g.dtype for g in port] == [td, td, td] + [torch.float32] * 3
    for which in ("ref", "chunked"):
        _assert_grads_close(port, _jax_wkv_grads(name, which, dy, ds_out), dtype)


@pytest.mark.parametrize("name", list(BWD_CASES))
@pytest.mark.parametrize("with_ds_out", [False, True])
def test_backward_split_matches_jax_grad(name, with_ds_out):
    """The backward kernels' chunked algorithm (``_bwd_emulation``) gives
    jax.grad of JAX's sequential reference."""
    arrays, dy, ds_out, chunk, dtype = _bwd_case(name, with_ds_out)
    port = _bwd_emulation(*_port(arrays, dy, ds_out, dtype), chunk)
    _assert_grads_close(port, _jax_wkv_grads(name, "ref", dy, ds_out), dtype)


@pytest.mark.parametrize("name", list(BWD_CASES))
@pytest.mark.parametrize("with_ds_out", [False, True])
def test_subchunk_backward_matches_jax_grad(name, with_ds_out):
    """The grads kernel's sub-chunk decomposition (``_subchunk_emulation``:
    the decay factored at a sub-chunk boundary off the diagonal blocks, one
    exponential a (t, s, n) on them, dlogw's running sum) gives jax.grad of
    JAX's sequential reference and of its chunked model scan; no factor's
    exponent is above 0, strong decay included."""
    arrays, dy, ds_out, chunk, dtype = _bwd_case(name, with_ds_out)
    port = _subchunk_emulation(*_port(arrays, dy, ds_out, dtype), chunk)
    td = getattr(torch, dtype)
    assert [g.dtype for g in port] == [td, td, td] + [torch.float32] * 3
    for which in ("ref", "chunked"):
        _assert_grads_close(port, _jax_wkv_grads(name, which, dy, ds_out), dtype)


# -- K3's backward ---------------------------------------------------------------

@pytest.mark.parametrize("B,S,R", [(1, 32, 16), (3, 77, 40), (2, 5, 300)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_bwd_ref_matches_jax_grad(B, S, R, with_h0):
    a, b, h0 = _rglru_inputs(14, B, S, R)
    dh = np.random.default_rng(15).standard_normal((B, S, R)).astype(np.float32)
    if with_h0:
        h_j, vjp = jax.vjp(jref.rglru_scan_ref, *(jnp.asarray(x) for x in (a, b, h0)))
        expect = vjp(jnp.asarray(dh))
    else:
        h_j, vjp = jax.vjp(lambda a_, b_: jref.rglru_scan_ref(a_, b_), jnp.asarray(a),
                           jnp.asarray(b))
        expect = (*vjp(jnp.asarray(dh)), None)
    at, h0t = torch.from_numpy(a), torch.from_numpy(h0) if with_h0 else None
    h = pops.rglru_scan(at, torch.from_numpy(b), h0t)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=RGLRU_ATOL)
    got = pops.rglru_scan_bwd(at, h0t, h, torch.from_numpy(dh))
    assert (got[2] is None) == (not with_h0)
    for g, e in zip(got, expect):
        if e is not None:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=RGLRU_ATOL)


def test_backwards_on_cpu_run_the_plain_versions_without_counting():
    """On CPU tensors ``rwkv6_scan_bwd`` and ``rglru_scan_bwd`` are the plain
    versions, and autograd of ``rwkv6_scan`` / ``rglru_scan`` (the plain
    forwards) gives the same gradients."""
    arrays, dy, ds_out, chunk, _ = _bwd_case("ragged last chunk", True)
    r, k, v, logw, u, s0, dyt, dst = _port(arrays, dy, ds_out, "float32")
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(16, 2, 20, 8))
    dh = torch.from_numpy(np.random.default_rng(17).standard_normal((2, 20, 8)).astype(np.float32))
    before = (pops.rwkv6_scan_bwd.launches, pops.rglru_scan_bwd.launches)
    got = pops.rwkv6_scan_bwd(r, k, v, logw, u, s0, None, dyt, dst, chunk=chunk)
    h = pops.rglru_scan(a, b, h0)
    got3 = pops.rglru_scan_bwd(a, h0, h, dh)
    assert (pops.rwkv6_scan_bwd.launches, pops.rglru_scan_bwd.launches) == before
    for x, e in zip(got, pref.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dyt, dst)):
        torch.testing.assert_close(x, e, rtol=0, atol=0)
    xs = [x.clone().requires_grad_() for x in (r, k, v, logw, u, s0)]
    torch.autograd.backward(pops.rwkv6_scan(*xs, chunk=chunk), [dyt, dst])
    for x, g in zip(xs, got):
        torch.testing.assert_close(x.grad, g, rtol=0, atol=1e-6)
    ys = [x.clone().requires_grad_() for x in (a, b, h0)]
    pops.rglru_scan(*ys).backward(dh)
    for x, g in zip(ys, got3):
        torch.testing.assert_close(x.grad, g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,S,R", [(1, 32, 16), (3, 77, 40), (2, 128, 64)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_shape_sweep(B, S, R, with_h0):
    a, b, h0 = _rglru_inputs(3, B, S, R)
    h0 = h0 if with_h0 else None
    port = pops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert port.dtype == torch.float32 and tuple(port.shape) == (B, S, R)
    jh0 = None if h0 is None else jnp.asarray(h0)
    for other in (jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, chunk_t=32, block_r=16),
                  jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)):
        np.testing.assert_allclose(port.numpy(), np.asarray(other), atol=RGLRU_ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_rglru_odd_sizes(seed):
    """The fuzz of tests/test_kernels.py, on fixed draws."""
    B, S, R = (int(x) for x in np.random.default_rng(seed).integers((1, 5, 4), (4, 61, 25)))
    a, b, _ = _rglru_inputs(seed, B, S, R)
    port = pops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(port.numpy(), np.asarray(jref.rglru_scan_ref(
        jnp.asarray(a), jnp.asarray(b))), atol=RGLRU_ATOL)


# -- dispatch ------------------------------------------------------------------------

def test_cpu_dispatches_to_plain_versions_without_counting():
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _rwkv_inputs(4, 1, 20, 2, 16))
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(4, 2, 20, 8))
    before = (pops.rwkv6_scan.launches, pops.rglru_scan.launches)
    y, s = pops.rwkv6_scan(r, k, v, logw, u, s0)
    h = pops.rglru_scan(a, b, h0)
    assert (pops.rwkv6_scan.launches, pops.rglru_scan.launches) == before
    y_ref, s_ref = pref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0)
    torch.testing.assert_close(h, pref.rglru_scan_ref(a, b, h0), rtol=0, atol=0)


def test_non_cpu_tensors_never_run_the_plain_versions():
    """A tensor off the CPU goes to the kernel, which refuses what is not on
    the card: here meta tensors, as no card is needed to show it."""
    m = lambda *shape: torch.empty(shape, device="meta")
    before = (pops.rwkv6_scan.launches, pops.rglru_scan.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.rwkv6_scan(m(1, 8, 2, 64), m(1, 8, 2, 64), m(1, 8, 2, 64), m(1, 8, 2, 64),
                        m(2, 64), m(1, 2, 64, 64))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.rglru_scan(m(1, 8, 16), m(1, 8, 16))
    assert (pops.rwkv6_scan.launches, pops.rglru_scan.launches) == before


def test_rwkv6_bwd_wrapper_copies_only_misaligned_inputs():
    """The backward's grads kernel reads its tiles 16 bytes at a time: a
    contiguous view that does not start on a 16-byte boundary is copied
    into a fresh allocation, anything else passes through untouched."""
    base = torch.arange(1 + 2 * 8 * 64, dtype=torch.float32)
    aligned = base[:-1].view(2, 8, 64)
    odd = base[1:].view(2, 8, 64)
    assert aligned.data_ptr() % 16 == 0 and odd.data_ptr() % 16 == 4 and odd.is_contiguous()
    assert prw._aligned(aligned) is aligned
    copy = prw._aligned(odd)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, odd)


def test_cuda_wrappers_refuse_cpu_tensors():
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _rwkv_inputs(5, 1, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        prw.rwkv6_scan_cuda(r, k, v, logw, u, s0)
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(5, 1, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        prg.rglru_scan_cuda(a, b, h0)


# -- the bounds chip_smoke.py reports ----------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("S,chunk", [(64, 32), (50, 32), (20, 32)])
def test_chip_smoke_rwkv6_bound(S, chunk):
    """Bytes: each input read once, y and the state written once.  Operations:
    the chunked algorithm's, counted chunk by chunk over the rows it holds."""
    smoke = _smoke()
    B, H, N = 2, 3, 16
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(6, B, S, H, N)]
    ms, by, flops, nbytes = smoke.rwkv6_bound(*ts, chunk=chunk)
    L = min(chunk, S)
    per_chunk = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n - 1) // 2
        per_chunk += (2 * n * N                       # running sums
                      + 5 * N * pairs + 3 * N * n     # A below and on the diagonal
                      + 5 * n * N                     # r and k rescaled
                      + 2 * N * (pairs + n)           # A @ V
                      + 2 * n * N * N + n * N         # + (r e^c) @ S
                      + 2 * n * N * N + 2 * N * N + N)  # state update
    assert flops == B * H * per_chunk
    r = ts[0]
    assert nbytes == 4 * (5 * r.numel() + H * N + 2 * B * H * N * N)
    assert ms == pytest.approx(1e3 * max(flops / smoke.PEAK_FP32_FLOPS,
                                         nbytes / smoke.PEAK_HBM_BYTES))
    assert by == ("operations" if flops / smoke.PEAK_FP32_FLOPS >= nbytes / smoke.PEAK_HBM_BYTES
                  else "bytes")


@pytest.mark.parametrize("S,chunk", [(512, 32), (50, 32), (20, 32)])
def test_chip_smoke_rwkv6_design_floor(S, chunk):
    """K2's design floor: the states kernel reads k, v, logw and the initial
    state and writes the workspace and the final state; the outputs kernel
    reads r, k, v, logw, u, the initial state and the workspace, writes y."""
    smoke = _smoke()
    B, H, N = 1, 2, 16
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(6, B, S, H, N)]
    ms, nbytes = smoke.rwkv6_design_floor(*ts, chunk=chunk)
    x, st, ws = 4 * B * S * H * N, 4 * B * H * N * N, 4 * B * H * N * N * (-(-S // chunk) - 1)
    assert nbytes == (3 * x + st + ws + st) + (4 * x + 4 * H * N + st + ws + x)
    assert ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


@pytest.mark.parametrize("S,chunk,with_ds_out", [(512, 32, False), (50, 32, True), (20, 32, False)])
def test_chip_smoke_rwkv6_bwd_design_floor(S, chunk, with_ds_out):
    """K2's backward design floor: the states kernel reads r, logw, dy (and
    ds_out) and writes dS' of every chunk and dstate; the grads kernel reads
    r, k, v, dy, logw, u, the initial state, the forward's workspace and the
    dS' of every chunk, and writes dr, dk, dv, dlogw and a du partial a
    (b, chunk); the du kernel reads the partials and writes du."""
    smoke = _smoke()
    B, H, N = 1, 2, 16
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(6, B, S, H, N)]
    dy, ds_out = (torch.from_numpy(a) for a in _cotangents(7, B, S, H, N))
    ms, nbytes = smoke.rwkv6_bwd_design_floor(*ts, dy, ds_out if with_ds_out else None,
                                              chunk=chunk)
    nc = -(-S // chunk)
    x, st, uu = 4 * B * S * H * N, 4 * B * H * N * N, 4 * H * N
    ws, dws, part = st * (nc - 1), st * nc, 4 * B * nc * H * N
    states = 3 * x + (st if with_ds_out else 0) + dws + st
    grads = 5 * x + uu + st + ws + dws + 4 * x + part
    assert nbytes == states + grads + part + uu
    assert ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


def test_chip_smoke_rwkv6_bwd_design_floor_at_the_training_shape():
    """610 MB at B=8 S=512 H=32 N=64 L=32, fp32 (0.182 ms): above the
    backward's bound by bytes (310 MB), which counts no workspace."""
    smoke = _smoke()
    B, S, H, N = 8, 512, 32, 64
    t = torch.empty((B, S, H, N), device="meta")
    u, st = torch.empty((H, N), device="meta"), torch.empty((B, H, N, N), device="meta")
    ms, nbytes = smoke.rwkv6_bwd_design_floor(t, t, t, t, u, st, t)
    assert nbytes == 610_287_616
    assert ms > smoke.rwkv6_bwd_bound(t, t, t, t, u, st, t)[4]


def test_chip_smoke_counts_the_backward_sass():
    """sass_counts: every instruction, the tensor core's HMMA, the
    exponentials (MUFU.EX2, not other MUFU), shared loads (LDSM among
    them) and ldmatrix."""
    smoke = _smoke()
    sass = """
        Function : _ZN12_GLOBAL__N_127rwkv6_scan_bwd_grads_kernelIfEEvNS_6ParamsE
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.1688.F32.TF32 R8, R4, R12, R8 ;
        /*0020*/                   HMMA.1688.F32.TF32 R8, R4, R14, R8 ;
        /*0030*/                   LDS R16, [R3] ;
        /*0040*/                   MUFU.EX2 R17, R16 ;
        /*0050*/                   MUFU.RCP R18, R16 ;
        /*0060*/                   LDS.64 R20, [R3+0x8] ;
        /*0070*/                   EXIT ;
"""
    ins = smoke.parse_sass(sass)["_ZN12_GLOBAL__N_127rwkv6_scan_bwd_grads_kernelIfEEvNS_6ParamsE"]
    assert smoke.sass_counts(ins) == {"instructions": 8, "HMMA": 2, "MUFU.EX2": 1, "LDS": 3,
                                      "LDSM": 1}


def test_k2_kernel_names_match_the_trace_filter():
    """chip_smoke finds K2's kernels by the prefix ``rwkv6_scan_`` and counts
    two launches a call: one kernel of each of ``PASSES`` in the source."""
    src = (Path(prw.__file__).parent / "csrc" / "rwkv6_scan.cu").read_text()
    for name in prw.PASSES:
        assert f"rwkv6_scan_{name}_kernel" in src
    assert _smoke().KERNELS_PER_CALL["rwkv6_scan"] == len(prw.PASSES) == 2


@pytest.mark.parametrize("S,chunk,with_ds_out", [(64, 32, False), (50, 32, True), (20, 32, False)])
def test_chip_smoke_rwkv6_bwd_bound(S, chunk, with_ds_out):
    """Bytes: r, k, v, logw, u, state, dy (and ds_out) read once, their six
    gradients written once.  Operations: the backward's, counted chunk by
    chunk over the rows each holds, with one exponential a pair and channel
    shared by A, dr and dk; on the tensor cores its four N^2 products as
    3xTF32 beside the rest on the CUDA cores."""
    smoke = _smoke()
    B, H, N = 2, 3, 64
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(6, B, S, H, N)]
    dy, ds_out = (torch.from_numpy(a) for a in _cotangents(7, B, S, H, N))
    ms, by, flops, nbytes, tc_ms, tc_by = smoke.rwkv6_bwd_bound(
        *ts, dy, ds_out if with_ds_out else None, chunk=chunk)
    L = min(chunk, S)
    ops = mm = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        P = n * (n - 1) // 2
        ops += 15 * N * P + 39 * n * N + 4 * N * N + 3 * N
        mm += 8 * n * N * N
    assert flops == B * H * (ops + mm)
    x, st = 4 * B * S * H * N, 4 * B * H * N * N
    assert nbytes == 2 * (4 * x + 4 * H * N + st) + x + (st if with_ds_out else 0)
    assert ms == pytest.approx(1e3 * max(flops / smoke.PEAK_FP32_FLOPS,
                                         nbytes / smoke.PEAK_HBM_BYTES))
    t_ops = max(B * H * ops / smoke.PEAK_FP32_FLOPS, 3 * B * H * mm / smoke.PEAK_TF32_FLOPS)
    assert tc_ms == pytest.approx(1e3 * max(t_ops, nbytes / smoke.PEAK_HBM_BYTES))
    assert tc_by == ("operations" if t_ops >= nbytes / smoke.PEAK_HBM_BYTES else "bytes")
    assert tc_ms <= ms


def test_chip_smoke_rwkv6_bwd_bound_at_the_training_shape():
    """At B=8 S=512 H=32 N=64 L=32 the CUDA-core bound is set by operations
    and the tensor-core bound by bytes (about 310 MB)."""
    smoke = _smoke()
    B, S, H, N = 8, 512, 32, 64
    t = torch.empty((B, S, H, N), device="meta")
    u, st = torch.empty((H, N), device="meta"), torch.empty((B, H, N, N), device="meta")
    ms, by, flops, nbytes, tc_ms, tc_by = smoke.rwkv6_bwd_bound(t, t, t, t, u, st, t)
    assert by == "operations" and tc_by == "bytes"
    assert nbytes == 9 * 4 * B * S * H * N + 2 * 4 * H * N + 2 * 4 * B * H * N * N
    assert tc_ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


@pytest.mark.parametrize("with_h0", [True, False])
def test_chip_smoke_rglru_bwd_bound(with_h0):
    smoke = _smoke()
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(7, 2, 30, 24))
    h0 = h0 if with_h0 else None
    ms, by, flops, nbytes = smoke.rglru_bwd_bound(a, h0, b, a)
    lanes = 0 if h0 is None else h0.numel()
    assert flops == 3 * a.numel() + 2 * lanes
    assert nbytes == 4 * (5 * a.numel() + 2 * lanes)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


def test_k2_bwd_kernel_names_match_the_trace_filter():
    """chip_smoke finds the backward's kernels by ``rwkv6_scan_bwd_`` and
    counts three launches a call, and no filter of a forward takes a
    backward kernel for its own."""
    smoke = _smoke()
    src = (Path(prw.__file__).parent / "csrc" / "rwkv6_scan_bwd.cu").read_text()
    names = [f"rwkv6_scan_bwd_{p}_kernel" for p in prw.BWD_PASSES]
    assert all(f"{n}(" in src or f"{n}<" in src for n in names)
    assert smoke.KERNELS_PER_CALL["rwkv6_scan_bwd"] == len(prw.BWD_PASSES) == 3
    assert "rglru_scan_bwd_kernel" in (Path(prg.__file__).parent / "csrc"
                                       / "rglru_scan_bwd.cu").read_text()
    keys = [f"void (anonymous namespace)::{n}<float>(Params)" for n in names] + \
        ["(anonymous namespace)::rglru_scan_bwd_kernel(float const*)"]
    for key in keys:
        owners = [n for n in smoke.KERNELS if smoke.ours(n, key)]
        assert owners == ["rglru_scan_bwd" if "rglru" in key else "rwkv6_scan_bwd"], key
    for n in ("rwkv6_scan_states_kernel", "rwkv6_scan_outputs_kernel", "rglru_scan_kernel"):
        key = f"void (anonymous namespace)::{n}<float>(Params)"
        assert [k for k in smoke.KERNELS if smoke.ours(k, key)] == [n[:10]], key


@pytest.mark.parametrize("arch,n_layers,expect", [
    ("rwkv6-1.6b", None, {"rwkv6_scan": 24, "rwkv6_scan_bwd": 24}),
    ("recurrentgemma-9b", 3, {"rglru_scan": 4, "rglru_scan_bwd": 2, "flash_attention": 2,
                              "flash_attention_bwd": 1}),
    ("recurrentgemma-9b", 6, {"rglru_scan": 8, "rglru_scan_bwd": 4, "flash_attention": 4,
                              "flash_attention_bwd": 2}),
    ("smollm-135m", None, {"flash_attention": 30, "flash_attention_bwd": 30}),
])
def test_chip_smoke_expected_train_launches(arch, n_layers, expect):
    """A train step launches each kernel's forward and backward once a layer,
    and with remat (recurrentgemma) each forward once more."""
    import dataclasses

    from repro_torch.configs import get_config
    smoke = _smoke()
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    got = smoke.expected_train_launches(cfg, 2)
    assert got == {n: 2 * expect.get(n, 0) for n in smoke.KERNELS}


@pytest.mark.parametrize("with_h0", [True, False])
def test_chip_smoke_rglru_bound(with_h0):
    smoke = _smoke()
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(7, 2, 30, 24))
    ms, by, flops, nbytes = smoke.rglru_bound(a, b, h0 if with_h0 else None)
    assert flops == 2 * a.numel()
    assert nbytes == 4 * (3 * a.numel() + (h0.numel() if with_h0 else 0))
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


# -- on the card -------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,N,chunk", [
    (8, 512, 32, 64, 32),     # rwkv6-1.6b prefill
    (2, 50, 3, 64, 32),       # ragged last chunk
    (2, 20, 2, 64, 32),       # one chunk shorter than L
    (1, 33, 4, 64, 16),       # one row in the last chunk
    (1, 2051, 2, 64, 32),     # B*H = 2: the chunks are all the parallelism
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_kernel_matches_plain_version_on_card(cuda_device, B, S, H, N, chunk, dtype):
    r, k, v, logw, u, s0 = (torch.from_numpy(a).to(cuda_device)
                            for a in _rwkv_inputs(8, B, S, H, N))
    r, k, v = (t.to(getattr(torch, dtype)) for t in (r, k, v))
    before = pops.rwkv6_scan.launches
    y, s = pops.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert pops.rwkv6_scan.launches == before + 1
    y_ref, s_ref = pref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    assert y.dtype == r.dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=0, atol=RWKV_ATOL[dtype])
    torch.testing.assert_close(s, s_ref, rtol=0, atol=RWKV_ATOL[dtype])


@pytest.mark.gpu
def test_rwkv6_kernel_state_chaining_on_card(cuda_device):
    r, k, v, logw, u, s0 = (torch.from_numpy(a).to(cuda_device)
                            for a in _rwkv_inputs(9, 2, 96, 4, 64))
    y_full, s_full = pops.rwkv6_scan(r, k, v, logw, u, s0)
    y1, s_mid = pops.rwkv6_scan(r[:, :40], k[:, :40], v[:, :40], logw[:, :40], u, s0)
    y2, s_end = pops.rwkv6_scan(r[:, 40:], k[:, 40:], v[:, 40:], logw[:, 40:], u, s_mid)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R", [(8, 512, 4096), (3, 77, 40), (2, 5, 300)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_kernel_matches_plain_version_on_card(cuda_device, B, S, R, with_h0):
    a, b, h0 = (torch.from_numpy(x).to(cuda_device) for x in _rglru_inputs(10, B, S, R))
    h0 = h0 if with_h0 else None
    before = pops.rglru_scan.launches
    h = pops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert pops.rglru_scan.launches == before + 1
    torch.testing.assert_close(h, pref.rglru_scan_ref(a, b, h0), rtol=0, atol=RGLRU_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,N,chunk,with_ds_out,decay", [
    (8, 512, 32, 64, 32, False, USUAL_DECAY),   # rwkv6-1.6b train, the final state unused
    (2, 50, 3, 64, 32, True, USUAL_DECAY),      # ragged last chunk
    (2, 20, 2, 64, 32, True, USUAL_DECAY),      # one chunk shorter than L
    (1, 33, 4, 64, 16, True, USUAL_DECAY),      # one row in the last chunk
    (1, 75, 4, 64, 24, True, USUAL_DECAY),      # chunks not a multiple of the sub-chunk
    (2, 100, 4, 64, 32, True, STRONG_DECAY),    # tens of e-folds within a chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_bwd_kernel_matches_plain_version_on_card(cuda_device, B, S, H, N, chunk,
                                                        with_ds_out, decay, dtype):
    """K2's backward against the plain backward, and two runs bit for bit."""
    r, k, v, logw, u, s0 = (torch.from_numpy(a).to(cuda_device)
                            for a in _rwkv_inputs(18, B, S, H, N, decay))
    dy, ds_out = (torch.from_numpy(a).to(cuda_device) for a in _cotangents(19, B, S, H, N))
    r, k, v, dy = (t.to(getattr(torch, dtype)) for t in (r, k, v, dy))
    ds_out = ds_out if with_ds_out else None
    states = prw.rwkv6_scan_cuda(r, k, v, logw, u, s0, chunk=chunk, return_states=True)[2]
    before = pops.rwkv6_scan_bwd.launches
    got = pops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy, ds_out, chunk=chunk)
    again = pops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy, ds_out, chunk=chunk)
    torch.cuda.synchronize()
    assert pops.rwkv6_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    expect = pref.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dy, ds_out)
    _assert_grads_close([g.cpu() for g in got], [e.float().cpu().numpy() for e in expect],
                        dtype, CARD_GRAD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_fn_matches_autograd_of_plain_on_card(cuda_device, dtype):
    """A call that needs a gradient goes through RWKV6ScanFn: its gradients
    against autograd of the plain forward, in the inputs' dtypes."""
    arrays = _rwkv_inputs(20, 2, 100, 4, 64)
    dy, ds_out = (torch.from_numpy(a).to(cuda_device) for a in _cotangents(21, 2, 100, 4, 64))
    td = getattr(torch, dtype)
    xs = [torch.from_numpy(a).to(cuda_device).to(td if i < 3 else torch.float32)
          .requires_grad_() for i, a in enumerate(arrays)]
    before = (pops.rwkv6_scan.launches, pops.rwkv6_scan_bwd.launches)
    torch.autograd.backward(pops.rwkv6_scan(*xs), [dy.to(td), ds_out])
    assert (pops.rwkv6_scan.launches, pops.rwkv6_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    xr = [x.detach().float().requires_grad_() for x in xs]
    torch.autograd.backward(pref.rwkv6_scan_ref(*xr), [dy.to(td).float(), ds_out])
    assert [x.grad.dtype for x in xs] == [x.dtype for x in xs]
    _assert_grads_close([x.grad.cpu() for x in xs], [x.grad.cpu().numpy() for x in xr], dtype,
                        CARD_GRAD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R", [(8, 512, 4096), (3, 77, 40), (2, 5, 300)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_bwd_kernel_matches_plain_version_on_card(cuda_device, B, S, R, with_h0):
    a, b, h0 = (torch.from_numpy(x).to(cuda_device) for x in _rglru_inputs(22, B, S, R))
    h0 = h0 if with_h0 else None
    dh = torch.randn(a.shape, generator=torch.Generator(device=cuda_device).manual_seed(23),
                     device=cuda_device)
    h = pops.rglru_scan(a, b, h0)
    before = pops.rglru_scan_bwd.launches
    got = pops.rglru_scan_bwd(a, h0, h, dh)
    again = pops.rglru_scan_bwd(a, h0, h, dh)
    torch.cuda.synchronize()
    assert pops.rglru_scan_bwd.launches == before + 2
    assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, again))
    for x, y in zip(got, pref.rglru_scan_bwd_ref(a, h0, h, dh)):
        assert (x is None) == (y is None)
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=RGLRU_ATOL)


@pytest.mark.gpu
def test_rglru_scan_fn_matches_autograd_of_plain_on_card(cuda_device):
    xs = [torch.from_numpy(x).to(cuda_device).requires_grad_()
          for x in _rglru_inputs(24, 2, 300, 1000)]
    dh = torch.randn((2, 300, 1000), device=cuda_device)
    before = (pops.rglru_scan.launches, pops.rglru_scan_bwd.launches)
    pops.rglru_scan(*xs).backward(dh)
    assert (pops.rglru_scan.launches, pops.rglru_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    xr = [x.detach().clone().requires_grad_() for x in xs]
    pref.rglru_scan_ref(*xr).backward(dh)
    for x, y in zip(xs, xr):
        torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=RGLRU_ATOL)
