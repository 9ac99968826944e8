"""The port's MoE layer and router against the JAX package's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.moe_router`` runs its plain
version (``ref.moe_router_ref``); it is held against the JAX Pallas router
(interpret mode, as tests/test_kernels.py runs it) and against
``repro.kernels.ref.moe_router_ref`` on the cases of ``TestMoERouter``.
``models/moe.py``'s functions are held against ``repro.models.moe`` on the
same numpy inputs and weights.  The reduced configs take ``n_experts`` 16
(granite, top 8) and 8 (deepseek, top 6, two shared experts), so that top-k
makes a choice and a group of 32 tokens overflows an expert's capacity (20
and 30 slots).  The CUDA kernel's selection order (its keys, the masked
winner, the lowest index among equals) is emulated in plain PyTorch and
held against JAX's router; its wrapper's check runs without a card.  The
router's plain backward (``ref.moe_router_bwd_ref``) is held against
``jax.vjp`` of JAX's ``_route`` and against torch autograd of the plain
router, and so is the CUDA backward's order of work, emulated: its
probabilities from the forward's saved row max and sum, its Z the
forward's bit for bit.  The CUDA
kernels themselves are held against the plain versions by the ``gpu``
tests, which skip without a card.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe

from repro_torch.configs import get_config
from repro_torch.kernels import moe_router as prouter
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.models import convert
from repro_torch.models import moe as pmoe

# Router: the weights of tests/test_kernels.py::TestMoERouter (1e-5); the
# two softmaxes sum in other orders, a few fp32 ulps (probs below 1).
ROUTER_ATOL, PROB_ATOL = 1e-5, 1e-6
# Layer outputs of order 1 (up to 3.5): fp32 sums in another order than
# XLA's; bf16 rounds at other places, and each side rounds the output once,
# so a value may also land one bf16 ulp (2**-8 relative) away: rtol 2**-7.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
REDUCED = {"granite-moe-3b-a800m": 16, "deepseek-moe-16b": 8}   # n_experts


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _cfgs(arch, dtype="float32", impl="einsum"):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(arch).reduced(n_experts=REDUCED[arch])
        out.append(dataclasses.replace(cfg, param_dtype=dtype, activation_dtype=dtype,
                                       moe=dataclasses.replace(cfg.moe, impl=impl)))
    return out


def _tree(cfg, seed=0):
    """MoE layer weights, numpy, fan-in scaled so that outputs are of order 1."""
    D, E, Fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    tree = {"router": _rand(seed, D, E, scale=D ** -0.5),
            "experts": {"w_gate": _rand(seed + 1, E, D, Fe, scale=D ** -0.5),
                        "w_up": _rand(seed + 2, E, D, Fe, scale=D ** -0.5),
                        "w_down": _rand(seed + 3, E, Fe, D, scale=Fe ** -0.5)}}
    if cfg.moe.n_shared:
        Fs = cfg.moe.n_shared * Fe
        tree["shared"] = {"w_gate": _rand(seed + 4, D, Fs, scale=D ** -0.5),
                          "w_up": _rand(seed + 5, D, Fs, scale=D ** -0.5),
                          "w_down": _rand(seed + 6, Fs, D, scale=Fs ** -0.5)}
    return tree


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


# -- the router: plain version against JAX's kernel and ref --------------------------

def _router_all(logits, k, dtype="float32"):
    """(port, JAX Pallas interpret, JAX ref) as numpy (w, idx) pairs."""
    pw, pi = pops.moe_router(_t(logits, dtype), k)
    assert pw.dtype == torch.float32 and pi.dtype == torch.int32 and pw.shape == (len(logits), k)
    outs = [(pw.numpy(), pi.numpy())]
    for w, i in (jops.moe_router(_j(logits, dtype), k, block_t=64),
                 jref.moe_router_ref(_j(logits, dtype), k)):
        outs.append((np.asarray(w), np.asarray(i)))
    return outs


@pytest.mark.parametrize("T,E,k", [(64, 8, 2), (100, 64, 6), (256, 40, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_shape_sweep(T, E, k, dtype):
    (pw, pi), *others = _router_all(_rand(10, T, E, scale=2.0), k, dtype)
    for w, i in others:
        np.testing.assert_array_equal(pi, i)
        np.testing.assert_allclose(pw, w, atol=ROUTER_ATOL)


@pytest.mark.parametrize("E,k", [(40, 8), (64, 6), (8, 8)])
def test_router_zero_rows_tie_to_the_lowest_indices(E, k):
    """Every expert ties on an all-zero row (decode's padded group): the
    lowest k indices, each with weight 1/k, in JAX and in the port."""
    logits = _rand(11, 16, E)
    logits[3:12] = 0.0
    (pw, pi), *others = _router_all(logits, k)
    np.testing.assert_array_equal(pi[3:12], np.broadcast_to(np.arange(k), (9, k)))
    np.testing.assert_allclose(pw[3:12], 1.0 / k, atol=ROUTER_ATOL)
    for w, i in others:
        np.testing.assert_array_equal(pi, i)
        np.testing.assert_allclose(pw, w, atol=ROUTER_ATOL)


def test_router_weights_normalized_sorted_unique():
    w, idx = pops.moe_router(_t(_rand(12, 32, 16, scale=3.0)), 4)
    torch.testing.assert_close(w.sum(-1), torch.ones(32), rtol=0, atol=1e-5)
    assert bool((w.diff(dim=-1) <= 1e-7).all())
    assert all(len(set(row)) == 4 for row in idx.tolist())


# -- the CUDA kernel's selection order, emulated on the CPU -----------------------------

def _kernel_selection(logits, k, masked_key=0):
    """``csrc/moe_router.cu``'s selection, step for step in plain PyTorch:
    probabilities p = exp(x - m) / s, m the row's max and s its sum of
    exponentials, each keyed as its fp32 bits + 1; each round takes the
    largest key, then the lowest index holding it, and sets the winner's key
    to ``masked_key`` (0 in the kernel).  Z is the winners' probabilities
    summed in round order, round 0 first, then max(that, 1e-9); the weights
    are the winners' probabilities over Z.  Returns (weights, indices, the
    rows' statistics (m, s) as (T, 2), Z)."""
    x = logits.float()
    m = x.max(-1, keepdim=True).values
    e = torch.exp(x - m)
    s = e.sum(-1, keepdim=True)
    p = e / s
    keys = p.view(torch.int32).long() + 1
    rows = torch.arange(len(keys))
    ws, idxs = [], []
    for _ in range(k):
        top = keys.max(-1).values
        win = (keys == top[:, None]).int().argmax(-1)       # the first holder
        keys[rows, win] = masked_key
        ws.append((top - 1).int().view(torch.float32))
        idxs.append(win)
    total = torch.zeros(len(x))
    for pw in ws:
        total = total + pw
    z = total.clamp_min(1e-9)
    return torch.stack(ws, -1) / z[:, None], torch.stack(idxs, -1).int(), torch.cat([m, s], -1), z


def _router_cases():
    """name -> (logits, k, dtype): the edges of the kernel's selection."""
    equal = _rand(30, 24, 40, scale=2.0)
    equal[:8] = 0.0                                   # every expert ties
    equal[8:16] = 3.0                                 # every expert ties, away from 0
    equal[16:, [5, 9, 30]] = 9.0                      # three equal winners, out of order
    under = np.full((6, 40), -200.0, np.float32)      # exp underflows to 0.0 in fp32
    under[0, 0] = under[1, 5] = under[2, 39] = 0.0    # one probability 1, the rest 0.0
    under[3, [2, 11]] = 0.0                           # two of 0.5
    under[4] = _rand(31, 40, scale=2.0)
    under[4, 20:] = -200.0                            # half the row underflows
    under[5, 33] = 0.0
    return {
        "rows of equal logits": (equal, 8, "float32"),
        "probabilities 0.0 beside masked winners": (under, 8, "float32"),
        "E=250": (_rand(32, 77, 250, scale=2.0), 8, "float32"),
        "k=E": (_rand(33, 64, 8, scale=2.0), 8, "float32"),
        "bf16 logits": (_rand(34, 96, 40, scale=2.0), 8, "bfloat16"),
        "deepseek E=64 k=6": (_rand(35, 96, 64, scale=2.0), 6, "float32"),
    }


@pytest.mark.parametrize("case", list(_router_cases()))
def test_kernel_selection_order_matches_jax(case):
    """The kernel's keys (bits + 1, a winner 0, the lowest index among
    equals) select as the JAX Pallas router (interpret mode) and JAX's
    reference do, and as the port's plain version."""
    logits, k, dtype = _router_cases()[case]
    w, idx, _, _ = _kernel_selection(_t(logits, dtype), k)
    (pw, pi), *others = _router_all(logits, k, dtype)
    for ow, oi in [(pw, pi)] + others:
        np.testing.assert_array_equal(idx.numpy(), oi)
        np.testing.assert_allclose(w.numpy(), ow, atol=ROUTER_ATOL)


def test_masked_winner_must_sort_below_an_underflowed_probability():
    """Why a winner's key is 0 and not the bits of JAX's -1.0: read as an
    unsigned key, -1.0 lies above every probability, and the next round
    would pick the winner again where JAX picks the lowest 0.0."""
    logits = np.full((1, 40), -200.0, np.float32)
    logits[0, 5] = 0.0
    idx = _kernel_selection(_t(logits), 8)[1]
    np.testing.assert_array_equal(idx.numpy()[0], [5, 0, 1, 2, 3, 4, 6, 7])
    minus_one = int(np.array(-1.0, np.float32).view(np.uint32)) + 1
    wrong = _kernel_selection(_t(logits), 8, masked_key=minus_one)[1]
    assert wrong.numpy()[0].tolist() == [5] * 8


@pytest.mark.parametrize("case", list(_router_cases()))
def test_saved_statistics_give_the_forwards_weights_bit_for_bit(case):
    """What the backward kernel makes of the forward's row max m and sum s:
    each selected probability exp(x - m) / s, their sum in round order (Z)
    and each weight over it are the forward's bits, on the edges of the
    selection (ties, probabilities 0.0, E=250, k=E, bf16 logits)."""
    logits, k, dtype = _router_cases()[case]
    x = _t(logits, dtype)
    w, idx, stats, z = _kernel_selection(x, k)
    assert stats.shape == (len(x), 2) and stats.dtype == torch.float32
    assert torch.equal(stats[:, 0], x.float().max(-1).values) and bool((stats[:, 1] >= 1).all())
    pk = (torch.exp(x.float() - stats[:, :1]) / stats[:, 1:]).gather(-1, idx.long())
    total = torch.zeros(len(x))
    for r in range(k):
        total = total + pk[:, r]
    assert torch.equal(total.clamp_min(1e-9), z)
    assert torch.equal(pk / z[:, None], w)


# -- the wrapper's check, without a card ------------------------------------------------

@pytest.mark.parametrize("shape,dtype,k,match", [
    ((8, 300), torch.float32, 8, "experts"),
    ((8, 40), torch.float32, 9, "top_k"),
    ((8, 40), torch.float32, 0, "top_k"),
    ((8, 4), torch.float32, 5, "top_k"),
    ((8, 40), torch.float16, 8, "dtype"),
    ((0, 40), torch.float32, 8, "at least one row"),
    ((40,), torch.float32, 8, "must be"),
    ((8, 0, 40), torch.float32, 8, "at least one row"),
    ((2**26, 64), torch.float32, 8, "2\\*\\*31"),
])
def test_router_check_refuses_what_the_kernel_does_not_take(shape, dtype, k, match):
    """``check`` and its remembered form ``plan`` refuse each bad (shape,
    dtype, k) every time: a key that raises is not remembered."""
    for fn in (prouter.check, prouter.plan, prouter.plan):
        with pytest.raises(ValueError, match=match):
            fn(torch.Size(shape), dtype, k)


def test_router_plan_is_checked_once_per_key():
    """A key is checked once; (G, S, E) logits are G*S rows, and the outputs
    are allocated as (2, G, S, k): weights, then indices."""
    before = prouter.plan.cache_info()
    assert prouter.plan(torch.Size((123, 40)), torch.bfloat16, 8) == (123, 40, 1, (2, 123, 8))
    assert prouter.plan(torch.Size((123, 40)), torch.bfloat16, 8) == (123, 40, 1, (2, 123, 8))
    after = prouter.plan.cache_info()
    assert after.hits >= before.hits + 1 and after.misses <= before.misses + 1
    assert prouter.check((16, 256, 64), torch.float32, 6) == (4096, 64, 0, (2, 16, 256, 6))


def test_router_takes_leading_dims_as_rows():
    """(G, S, E) logits route as their G*S rows, on the plain version as on
    the kernel: ``_route`` hands them over without a reshape."""
    logits = _t(_rand(29, 3, 32, 40, scale=2.0))
    w, idx = pops.moe_router(logits, 8)
    w2, idx2 = pops.moe_router(logits.reshape(96, 40), 8)
    assert w.shape == idx.shape == (3, 32, 8)
    assert torch.equal(w.reshape(96, 8), w2) and torch.equal(idx.reshape(96, 8), idx2)


# -- the router's backward: plain version against JAX's autograd ------------------------

# dlogits, normwise (max |a - b| over max(1, max |b|)): in fp32 the sums are
# taken in other orders (readings at most 1.2e-7); in bf16 each side rounds
# dlogits once, so a value may land one bf16 ulp (2**-8 relative) away.
BWD_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}

# (T, E, k, dtype, rows set to zero): top-k of a few, of many, k = E, E=250
# (8 values a kernel lane, the last lane part-filled), all-zero rows (every
# expert ties: the lowest k indices), bf16 logits
BWD_CASES = [(64, 8, 2, "float32", None), (100, 64, 6, "float32", None),
             (256, 40, 8, "float32", None), (64, 8, 8, "float32", None),
             (77, 250, 8, "float32", None), (48, 40, 8, "float32", slice(3, 20)),
             (32, 64, 6, "float32", slice(None)), (96, 40, 8, "bfloat16", None)]


def _bwd_case(T, E, k, dtype, zero, seed=40):
    logits = _rand(seed, T, E, scale=2.0)
    if zero is not None:
        logits[zero] = 0.0
    return logits, _rand(seed + 1, T, k)


def _normwise(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@functools.lru_cache(maxsize=None)
def _jax_route_vjp(case):
    """JAX's top-k indices and the gradient of the logits through ``_route``
    (softmax -> lax.top_k -> renormalise) for ``BWD_CASES[case]``'s logits
    and weight cotangent; each case once per module."""
    T, E, k, dtype, zero = BWD_CASES[case]
    logits, dw = _bwd_case(T, E, k, dtype, zero)
    moe = dataclasses.replace(jax_get_config("granite-moe-3b-a800m").moe, n_experts=E, top_k=k)

    @jax.jit
    def route_vjp(x, g):
        (_, ji), vjp = jax.vjp(lambda x: jmoe._route(x, moe)[:2], x)
        return ji, vjp((g, np.zeros(ji.shape, jax.dtypes.float0)))[0]

    ji, dx = route_vjp(_j(logits, dtype), jnp.asarray(dw))
    return np.asarray(ji), np.asarray(dx, np.float32)


@pytest.mark.parametrize("case", range(len(BWD_CASES)))
def test_router_bwd_ref_matches_jax_vjp(case):
    T, E, k, dtype, zero = BWD_CASES[case]
    logits, dw = _bwd_case(T, E, k, dtype, zero)
    ji, jdx = _jax_route_vjp(case)
    x = _t(logits, dtype)
    w, idx = pref.moe_router_ref(x, k)
    np.testing.assert_array_equal(idx.numpy(), ji)
    dx = pref.moe_router_bwd_ref(x, w, idx, torch.from_numpy(dw))
    assert dx.dtype == x.dtype and dx.shape == (T, E)
    assert _normwise(dx.float().numpy(), jdx) <= BWD_TOL[dtype]
    assert float(dx.float().abs().max()) > 0


@pytest.mark.parametrize("T,E,k,dtype,zero", BWD_CASES)
def test_router_bwd_ref_matches_torch_autograd(T, E, k, dtype, zero):
    """The written-out chain against autograd of ``moe_router_ref`` (the
    plain router that the CPU path trains through) on the same outputs."""
    logits, dw = _bwd_case(T, E, k, dtype, zero)
    x = _t(logits, dtype).requires_grad_()
    w, idx = pref.moe_router_ref(x, k)
    w.backward(torch.from_numpy(dw))
    dx = pref.moe_router_bwd_ref(x.detach(), w.detach(), idx, torch.from_numpy(dw))
    assert x.grad.dtype == dx.dtype
    assert _normwise(dx.float().numpy(), x.grad.float().numpy()) <= BWD_TOL[dtype]


def _kernel_bwd_emulation(logits, stats, w, idx, dw):
    """``csrc/moe_router_bwd.cu``'s order of work in plain PyTorch: each
    selected expert's probability from the forward's saved row max m and
    sum s, exp(x - m) / s, with no reduction over the row (the kernel
    re-reads the k selected logits); Z, sum_m dw_m w_m, each dp_j = (dw_j -
    that sum) times 1/Z and sum_j p[idx_j] dp_j over the k selected only,
    each in round order, round 0 first; an unselected logit's exp(x - m)
    times 1/s times (0 - the last sum), a selected one's p (dp_j - it).
    Returns (dlogits, Z)."""
    x = logits.float()
    e = torch.exp(x - stats[:, :1])
    idx = idx.long()
    pk = (e / stats[:, 1:]).gather(-1, idx)
    total, c, pdp = torch.zeros(len(x)), torch.zeros(len(x)), torch.zeros(len(x))
    for r in range(idx.shape[-1]):
        total = total + pk[:, r]
        c = c + dw[:, r] * w[:, r]
    z = total.clamp_min(1e-9)
    dp = (dw - c[:, None]) * (1 / z)[:, None]
    for r in range(idx.shape[-1]):
        pdp = pdp + pk[:, r] * dp[:, r]
    out = e * (1 / stats[:, 1:]) * (0 - pdp[:, None])
    out.scatter_(-1, idx, pk * (dp - pdp[:, None]))
    return out.to(logits.dtype), z


@pytest.mark.parametrize("case", range(len(BWD_CASES)))
def test_kernel_bwd_order_of_sums_matches_jax(case):
    """The kernel's Z, made from the forward's saved statistics, is the
    forward's Z bit for bit, and its sums over the k selected experts give
    JAX's gradient within the plain version's tolerance."""
    T, E, k, dtype, zero = BWD_CASES[case]
    logits, dw = _bwd_case(T, E, k, dtype, zero)
    x = _t(logits, dtype)
    w, idx, stats, z_fwd = _kernel_selection(x, k)
    ji, jdx = _jax_route_vjp(case)
    np.testing.assert_array_equal(idx.numpy(), ji)
    dx, z = _kernel_bwd_emulation(x, stats, w, idx, torch.from_numpy(dw))
    assert torch.equal(z, z_fwd)
    assert dx.dtype == x.dtype and dx.shape == (T, E)
    assert _normwise(dx.float().numpy(), jdx) <= BWD_TOL[dtype]


def test_cpu_bwd_dispatches_to_the_plain_version_without_counting():
    logits, dw = _bwd_case(256, 40, 8, "float32", None)
    x = _t(logits)
    w, idx = pops.moe_router(x, 8)
    stats = _kernel_selection(x, 8)[2]
    before = pops.moe_router_bwd.launches
    got = pops.moe_router_bwd(x, w, idx, torch.from_numpy(dw))
    with_stats = pops.moe_router_bwd(x, w, idx, torch.from_numpy(dw), stats)
    assert pops.moe_router_bwd.launches == before
    expect = pref.moe_router_bwd_ref(x, w, idx, torch.from_numpy(dw))
    assert torch.equal(got, expect) and torch.equal(with_stats, expect)


# -- dispatch ------------------------------------------------------------------------

def test_cpu_dispatches_to_the_plain_version_without_counting():
    logits = _t(_rand(13, 20, 40))
    before = pops.moe_router.launches
    w, idx = pops.moe_router(logits, 8)
    assert pops.moe_router.launches == before
    w_ref, idx_ref = pref.moe_router_ref(logits, 8)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=0)
    assert torch.equal(idx, idx_ref)


def test_non_cpu_tensors_never_run_the_plain_version():
    """A tensor off the CPU goes to the kernel, which refuses what is not on
    the card: here a meta tensor, as no card is needed to show it."""
    before = pops.moe_router.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.moe_router(torch.empty((8, 40), device="meta"), 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        prouter.moe_router_cuda(_t(_rand(14, 8, 40)), 8)
    assert pops.moe_router.launches == before


# -- models/moe.py against repro.models.moe --------------------------------------------

@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_route_matches_jax(kernel_impl):
    jcfg, pcfg = _cfgs("granite-moe-3b-a800m")
    logits = _rand(15, 3, 32, jcfg.moe.n_experts, scale=2.0)
    logits[2, 5:] = 0.0                      # padded rows: every expert ties
    jw, ji, jp = jmoe._route(_j(logits), jcfg.moe)
    pw, pi, pp = pmoe._route(_t(logits), pcfg.moe, kernel_impl)
    assert pi.dtype == torch.int32 and pi.shape == (3, 32, jcfg.moe.top_k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=PROB_ATOL)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=PROB_ATOL)


@pytest.mark.parametrize("arch", list(REDUCED))
def test_dispatch_tensors_drop_overflowing_tokens_as_jax(arch):
    """Routed to a few experts, most (token, k) pairs overflow capacity:
    their slot row is all zero in both (``jax.nn.one_hot`` of an index >= C
    is zero; ``F.one_hot`` would raise)."""
    jcfg, pcfg = _cfgs(arch)
    moe, S = jcfg.moe, jcfg.moe.group_size
    rng = np.random.default_rng(16)
    idx = np.stack([rng.permutation(moe.n_experts)[:moe.top_k] for _ in range(2 * S)])
    idx[::2] = np.arange(moe.top_k)            # half the tokens pick the same k experts
    idx = idx.reshape(2, S, moe.top_k).astype(np.int32)
    w = np.abs(_rand(17, 2, S, moe.top_k))
    jd, jc = jmoe._dispatch_tensors(_j(w), jnp.asarray(idx), moe, S)
    pd, pc = pmoe._dispatch_tensors(_t(w), torch.from_numpy(idx), pcfg.moe, S)
    C = jd.shape[-1]
    assert C < S * moe.top_k / moe.n_experts * 2 and float(jd.sum()) < idx.size
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("G,live", [(1, 8), (4, 256)])
def test_dispatch_tensors_at_granite_width_match_jax_bit_for_bit(G, live):
    """granite-moe's full router width (E=40, top-8, groups of 256, C=64).
    Decode: 8 tokens padded to one group, whose 248 zero rows all route to
    experts 0-7 and overflow them; prefill-like: every row live.  Dispatch
    and combine equal JAX's bit for bit (slot positions are sums of 0/1,
    exact in fp32 in any order)."""
    jmoe_cfg, pmoe_cfg = jax_get_config("granite-moe-3b-a800m").moe, \
        get_config("granite-moe-3b-a800m").moe
    S, E = jmoe_cfg.group_size, jmoe_cfg.n_experts
    assert (S, E, jmoe_cfg.top_k) == (256, 40, 8)
    logits = _rand(26, G, S, E, scale=2.0)
    logits[:, live:] = 0.0
    top_w, top_idx, _ = jmoe._route(_j(logits), jmoe_cfg)
    jd, jc = jmoe._dispatch_tensors(top_w, top_idx, jmoe_cfg, S)
    pd, pc = pmoe._dispatch_tensors(torch.from_numpy(np.array(top_w)),
                                    torch.from_numpy(np.array(top_idx)), pmoe_cfg, S)
    assert jd.shape == (G, S, E, 64)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    if live < S:
        assert float(jd.sum()) < top_idx.size, "the padded rows overflow no expert"


@pytest.mark.parametrize("G,N,E", [(3, 40, 16), (2, 256, 8), (1, 7, 3)])
def test_rank_within_expert_matches_jax(G, N, E):
    e_flat = np.random.default_rng(18).integers(0, E, (G, N)).astype(np.int32)
    expect = np.asarray(jmoe._rank_within_expert(jnp.asarray(e_flat)))
    got = pmoe._rank_within_expert(torch.from_numpy(e_flat).long())
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", list(REDUCED))
@pytest.mark.parametrize("B,S", [(2, 32), (3, 17)])
def test_apply_moe_layer_matches_jax(arch, impl, dtype, B, S):
    """Output and aux loss; 64 tokens fill two groups of 32, 51 are padded
    to them.  The tokens share a mean, which favours some experts in every
    group, as unbalanced routing does: the router picks k of E and capacity
    drops tokens (checked)."""
    jcfg, pcfg = _cfgs(arch, dtype, impl)
    tree = _tree(jcfg)
    x = (_rand(19, B, S, jcfg.d_model) + _rand(24, jcfg.d_model)) * 0.5 ** 0.5
    layer = convert.load_module(pmoe.MoELayer(pcfg, None, "cpu"), tree)
    jout, jaux = jmoe.apply_moe_layer(jax.tree_util.tree_map(lambda a: _j(a, dtype), tree),
                                      _j(x, dtype), jcfg)
    with torch.no_grad():
        pout, paux = pmoe.apply_moe_layer(layer, _t(x, dtype), pcfg)
    assert pout.dtype == getattr(torch, dtype) and paux.dtype == torch.float32
    np.testing.assert_allclose(pout.float().numpy(), np.asarray(jout, np.float32),
                               rtol=RTOL[dtype], atol=ATOL[dtype])
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)

    moe = jcfg.moe
    g = moe.group_size
    assert moe.top_k < moe.n_experts
    xg = np.pad(x.reshape(B * S, -1), ((0, -B * S % g), (0, 0))).reshape(-1, g, x.shape[-1])
    top_w, top_idx, _ = jmoe._route(_j(xg) @ _j(tree["router"]), moe)
    dispatch, _ = jmoe._dispatch_tensors(top_w, top_idx, moe, g)
    assert float(dispatch.sum()) < top_idx.size, "no token was dropped"


@pytest.mark.parametrize("arch", list(REDUCED))
def test_apply_stack_returns_the_summed_aux_loss_as_jax(arch):
    """The stack's output and the sum of its MoE layers' aux losses, on JAX's
    weights, without caches (JAX's train mode).  With JAX's expert init (std
    1/sqrt(E)) the residual stream reaches ~50, so the output is held
    normwise: fp32 rounding, 1e-5 of its largest value."""
    from repro.models import transformer as jT
    from repro_torch.models import transformer as pT
    jcfg, pcfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(0), jcfg))
    model = convert.from_jax(tree, pcfg, "cpu")
    B, S = 2, 24
    x = _rand(25, B, S, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jx, _, jaux = jT.apply_stack(tree["stack"], jcfg, _j(x), jnp.asarray(pos), None, "train")
    with torch.no_grad():
        px, caches, paux = pT.apply_stack(model.stack, pcfg, _t(x), torch.from_numpy(pos.copy()))
    assert caches is None and paux.dtype == torch.float32
    jx = np.asarray(jx)
    assert np.abs(px.numpy() - jx).max() <= 1e-5 * max(1.0, np.abs(jx).max())
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)
    assert float(paux) > 0


def test_convert_loads_moe_leaves_in_their_layouts():
    """``router`` and ``experts`` are plain parameters in JAX's layout and
    load untransposed; ``shared`` lands in ``nn.Linear``s and is transposed.
    Each is held against JAX's ``x @ w`` on one model's leaves."""
    jcfg, pcfg = _cfgs("deepseek-moe-16b")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jax.random.key(0), jcfg))
    model = convert.from_jax(tree, pcfg, "cpu")
    jblock = jax.tree_util.tree_map(lambda a: a[1], tree["stack"][0]["blocks"][0]["moe"])
    layer = model.stack[0][0][1].moe
    D = jcfg.d_model
    x = _rand(20, 5, D)
    np.testing.assert_allclose((_t(x) @ layer.router).detach().numpy(),
                               x @ jblock["router"], atol=1e-5)
    for name in ("w_gate", "w_up", "w_down"):
        w, jw = layer.experts[name].detach().numpy(), jblock["experts"][name]
        assert w.shape == jw.shape
        xe = _rand(21, jw.shape[0], 5, jw.shape[1])
        np.testing.assert_allclose(np.einsum("ebd,edf->ebf", xe, w),
                                   np.einsum("ebd,edf->ebf", xe, jw), atol=1e-5)
    for name in ("w_gate", "w_up", "w_down"):
        lin, jw = getattr(layer.shared, name), jblock["shared"][name]
        xs = _rand(22, 5, jw.shape[0])
        np.testing.assert_allclose(lin(_t(xs)).detach().numpy(), xs @ jw, atol=1e-5)


# -- the bound chip_smoke.py reports -----------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("T,E,k,dtype", [(4096, 40, 8, "float32"), (4096, 64, 6, "float32"),
                                         (77, 250, 8, "bfloat16")])
def test_chip_smoke_moe_router_bound(T, E, k, dtype):
    """Bytes: the logits read once, weights and indices written once.
    Operations per row: max, subtract, exponential, sum and divide over E,
    k rounds of E compares, and the k-term sum and k divides."""
    smoke = _smoke()
    logits = torch.zeros((T, E), dtype=getattr(torch, dtype))
    ms, by, flops, nbytes = smoke.moe_router_bound(logits, k)
    assert flops == T * ((5 + k) * E + 2 * k)
    assert nbytes == T * E * logits.element_size() + T * k * 8
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


@pytest.mark.parametrize("T,E,k,dtype", [(4096, 40, 8, "float32"), (4096, 64, 6, "float32"),
                                         (77, 250, 8, "bfloat16")])
def test_chip_smoke_moe_router_bwd_bound(T, E, k, dtype):
    """Bytes: the logits, weights, indices and weight gradients read once,
    dlogits written once: 416 B a row at granite-moe's shape.  Operations
    per row: 9E (the softmax again, p * dp and its sum, each logit's
    difference and product) and 5k."""
    smoke = _smoke()
    logits = torch.zeros((T, E), dtype=getattr(torch, dtype))
    ms, by, flops, nbytes = smoke.moe_router_bwd_bound(logits, k)
    assert flops == T * (9 * E + 5 * k)
    assert nbytes == 2 * T * E * logits.element_size() + T * k * 12
    if (T, E, k, dtype) == (4096, 40, 8, "float32"):
        assert nbytes == 4096 * 416
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


@pytest.mark.parametrize("E", [8, 40, 64, 250])
def test_chip_smoke_row_exp_sum_is_the_forwards_order(E):
    """``row_exp_sum`` (the plain recomputation chip_smoke holds K4's row
    sums to) adds in ``row_exp``'s order: each of 32 lanes its experts j*32
    + lane from slot 0, then a butterfly in which lane l adds lane l ^ o's
    sum for o = 16, 8, 4, 2, 1.  Written here lane by lane, bit for bit."""
    e = torch.exp(_t(_rand(60, 16, E, scale=2.0)) - 4.0)
    vpl = next(v for v in (1, 2, 4, 8) if 32 * v >= E)
    lanes = [torch.zeros(16) for _ in range(32)]
    for lane in range(32):
        for j in range(vpl):
            if j * 32 + lane < E:
                lanes[lane] = lanes[lane] + e[:, j * 32 + lane]
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[lane] + lanes[lane ^ o] for lane in range(32)]
    got = _smoke().row_exp_sum(torch, e)
    assert all(torch.equal(lane, lanes[0]) for lane in lanes)
    assert torch.equal(got, lanes[0])
    torch.testing.assert_close(got, e.sum(-1), rtol=1e-6, atol=0)


def test_chip_smoke_router_bwd_lanes_match_the_kernel():
    """chip_smoke's lanes a row of K4's backward (to pick the instantiation
    it reports) are the kernel's: the fewest of 4, 8, 16, 32 holding at
    most 8 experts a lane, written out in ``lanes_per_row``."""
    src = (Path(prouter.__file__).parent / "csrc" / "moe_router_bwd.cu").read_text()
    assert "return E <= 32 ? 4 : E <= 64 ? 8 : E <= 128 ? 16 : 32;" in src
    smoke = _smoke()
    got = [smoke.router_bwd_lanes(E) for E in (1, 8, 32, 33, 40, 64, 65, 128, 129, 250, 256)]
    assert got == [4, 4, 4, 8, 8, 8, 16, 16, 32, 32, 32]


@pytest.mark.parametrize("arch,n_layers,remat,expect", [
    ("granite-moe-3b-a800m", None, True, {"flash_attention": 64, "flash_attention_bwd": 32,
                                          "moe_router": 64, "moe_router_bwd": 32}),
    ("granite-moe-3b-a800m", 3, False, {"flash_attention": 3, "flash_attention_bwd": 3,
                                        "moe_router": 3, "moe_router_bwd": 3}),
    ("deepseek-moe-16b", None, True, {"flash_attention": 56, "flash_attention_bwd": 28,
                                      "moe_router": 56, "moe_router_bwd": 28}),
])
def test_chip_smoke_expected_train_launches_of_the_moe_family(arch, n_layers, remat, expect):
    """A moe train step launches K1 and K4 forward and backward once a
    layer, and with remat each forward once more (phase 3d: granite-moe at
    full depth with remat, 64 forwards and 32 backwards of each)."""
    smoke = _smoke()
    cfg = dataclasses.replace(get_config(arch), remat=remat)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    assert smoke.expected_train_launches(cfg, 3) == {n: 3 * expect.get(n, 0)
                                                     for n in smoke.KERNELS}


def test_k4_kernel_names_match_the_trace_filter():
    """chip_smoke finds K4's kernels by name: each filter takes its own
    kernel and not the other's, one launch a call each way."""
    smoke = _smoke()
    csrc = Path(prouter.__file__).parent / "csrc"
    for name in ("moe_router", "moe_router_bwd"):
        assert f"{name}_kernel(" in (csrc / f"{name}.cu").read_text()
        key = f"void (anonymous namespace)::{name}_kernel<float, 2>(float const*, float*)"
        assert [n for n in smoke.KERNELS if smoke.ours(n, key)] == [name], key
        assert smoke.KERNELS_PER_CALL[name] == 1


def test_routing_check_names_a_train_steps_calls():
    """Under remat a train step routes each layer in its forward, layer 0
    first, then in the backward's recompute, the last layer first; a
    forward alone routes each layer once."""
    where = _smoke().train_call(4)
    assert [where(c) for c in (0, 3, 4, 7, 8)] == [
        ("step 0", "step 0 forward", 0), ("step 0", "step 0 forward", 3),
        ("step 0", "step 0 recompute", 3), ("step 0", "step 0 recompute", 0),
        ("step 1", "step 1 forward", 0)]
    where = _smoke().train_call(4, remat=False)
    assert [where(c) for c in (3, 4)] == [("step 0", "step 0 forward", 3),
                                          ("step 1", "step 1 forward", 0)]
    serve = _smoke().serve_call(4)
    assert [serve(c) for c in (3, 4, 9)] == [("prefill", "prefill", 3),
                                             ("decode", "decode step 1", 0),
                                             ("decode", "decode step 2", 1)]


# -- on the card -------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,dtype,zero", [
    (4096, 40, 8, "float32", False),     # granite-moe prefill
    (256, 40, 8, "float32", True),       # granite-moe decode: 248 padded rows
    (4096, 64, 6, "float32", False),     # deepseek-moe
    (77, 250, 8, "float32", False),      # 8 values a lane, the last lane part-filled
    (64, 8, 8, "float32", False),        # k = E
    (4096, 40, 8, "bfloat16", False),
])
def test_moe_router_kernel_matches_plain_version_on_card(cuda_device, T, E, k, dtype, zero):
    logits = _t(_rand(23, T, E, scale=2.0), dtype).to(cuda_device)
    if zero:
        logits[8:] = 0
    before = pops.moe_router.launches
    w, idx = pops.moe_router(logits, k)
    torch.cuda.synchronize()
    assert pops.moe_router.launches == before + 1
    w_ref, idx_ref = pref.moe_router_ref(logits, k)
    assert w.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(idx, idx_ref)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=ROUTER_ATOL)


@pytest.mark.gpu
def test_moe_router_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((8, 40), device=cuda_device)
    for bad, k in ((torch.zeros((8, 300), device=cuda_device), 8), (x, 9), (x, 0),
                   (x.half(), 8), (x[:0], 8), (x[0], 8)):
        with pytest.raises(ValueError):
            prouter.moe_router_cuda(bad, k)


@pytest.mark.gpu
def test_moe_router_outputs_are_contiguous_typed_and_fresh(cuda_device):
    """Both outputs are contiguous views of one allocation made for this
    call: a second call's outputs share no storage with the first's, so a
    layer's routing that lives on through dispatch is never overwritten."""
    logits = _t(_rand(27, 1, 256, 40, scale=2.0)).to(cuda_device)     # decode's (G, S, E)
    w1, i1 = prouter.moe_router_cuda(logits, 8)
    w2, i2 = prouter.moe_router_cuda(logits, 8)
    torch.cuda.synchronize()
    for w, i in ((w1, i1), (w2, i2)):
        assert w.shape == i.shape == (1, 256, 8)
        assert w.dtype == torch.float32 and i.dtype == torch.int32
        assert w.is_contiguous() and i.is_contiguous()
    w_ref, idx_ref = pref.moe_router_ref(logits, 8)
    assert torch.equal(i1, idx_ref)
    torch.testing.assert_close(w1, w_ref, rtol=0, atol=ROUTER_ATOL)
    first = {w1.untyped_storage().data_ptr(), i1.untyped_storage().data_ptr()}
    second = {w2.untyped_storage().data_ptr(), i2.untyped_storage().data_ptr()}
    assert not first & second
    assert torch.equal(w1, w2) and torch.equal(i1, i2)


@pytest.mark.gpu
def test_moe_router_takes_strided_logits_and_the_current_stream(cuda_device):
    """A transposed view is copied before the launch; the launch goes to
    PyTorch's current stream, here a side stream."""
    logits = _t(_rand(28, 40, 300, scale=2.0)).to(cuda_device).t()
    w_ref, idx_ref = pref.moe_router_ref(logits, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w, idx = pops.moe_router(logits, 8)
    side.synchronize()
    assert torch.equal(idx, idx_ref)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=ROUTER_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,dtype,zero", [
    (4096, 40, 8, "float32", False),     # granite-moe training
    (256, 40, 8, "float32", True),       # 248 padded rows: every expert ties
    (4096, 64, 6, "float32", False),     # deepseek-moe
    (77, 250, 8, "float32", False),      # 8 values a lane, the last lane part-filled
    (64, 8, 8, "float32", False),        # k = E
    (4096, 40, 8, "bfloat16", False),
])
def test_moe_router_bwd_kernel_matches_plain_version_on_card(cuda_device, T, E, k, dtype, zero):
    """On the kernel forward's own outputs and row statistics: dlogits
    against the plain backward (``BWD_TOL``), a second run bit for bit, one
    launch counted each; the forward's weights and indices the same bits
    with and without its statistics, and the backward's Z the forward's."""
    logits = _t(_rand(41, T, E, scale=2.0), dtype).to(cuda_device)
    if zero:
        logits[8:] = 0
    dw = _t(_rand(42, T, k)).to(cuda_device)
    z_fwd, z_bwd = (torch.empty(T, device=cuda_device) for _ in range(2))
    w, idx, stats = prouter.moe_router_cuda(logits, k, return_stats=True, z=z_fwd)
    w0, idx0 = prouter.moe_router_cuda(logits, k)
    before = pops.moe_router_bwd.launches
    got = pops.moe_router_bwd(logits, w, idx, dw, stats)
    again = prouter.moe_router_bwd_cuda(logits, w, idx, dw, stats, z=z_bwd)
    torch.cuda.synchronize()
    assert pops.moe_router_bwd.launches == before + 1
    assert torch.equal(w, w0) and torch.equal(idx, idx0) and stats.shape == (T, 2)
    assert torch.equal(z_fwd, z_bwd)
    assert got.dtype == logits.dtype and got.shape == (T, E) and torch.equal(got, again)
    exp = pref.moe_router_bwd_ref(logits, w, idx, dw)
    assert _normwise(got.float().cpu().numpy(), exp.float().cpu().numpy()) <= BWD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_router_fn_matches_autograd_of_the_plain_router_on_card(cuda_device, dtype):
    """``ops.moe_router`` on logits that need a gradient runs MoERouterFn:
    the forward kernel, then the backward kernel, against autograd of the
    plain router (no near-tie in these draws: the indices are equal)."""
    logits = _t(_rand(43, 3, 256, 40, scale=2.0), dtype).to(cuda_device)
    dw = _t(_rand(44, 3, 256, 8)).to(cuda_device)
    x, xr = logits.clone().requires_grad_(), logits.clone().requires_grad_()
    before = pops.moe_router.launches, pops.moe_router_bwd.launches
    w, idx = pops.moe_router(x, 8)
    w.backward(dw)
    torch.cuda.synchronize()
    assert (pops.moe_router.launches, pops.moe_router_bwd.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    assert w.grad_fn is not None and not idx.requires_grad
    wr, idxr = pref.moe_router_ref(xr, 8)
    wr.backward(dw)
    assert torch.equal(idx, idxr) and x.grad.dtype == logits.dtype
    assert _normwise(x.grad.float().cpu().numpy(), xr.grad.float().cpu().numpy()) \
        <= BWD_TOL[dtype]


@pytest.mark.gpu
def test_moe_router_bwd_kernel_refuses_what_it_does_not_take(cuda_device):
    logits = torch.zeros((8, 40), device=cuda_device)
    w, idx, st = prouter.moe_router_cuda(logits, 8, return_stats=True)
    dw = torch.zeros_like(w)
    before = pops.moe_router_bwd.launches
    for args in ((logits.cpu(), w, idx, dw, st), (logits, w, idx.long(), dw, st),
                 (logits, w[:4], idx[:4], dw[:4], st), (logits.half(), w, idx, dw, st),
                 (torch.zeros((8, 300), device=cuda_device), w, idx, dw, st),
                 (logits, w, idx, dw, None), (logits, w, idx, dw, st[:4]),
                 (logits, w, idx, dw, st.double())):
        with pytest.raises(ValueError):
            prouter.moe_router_bwd_cuda(*args)
    with pytest.raises(ValueError, match="row statistics"):
        pops.moe_router_bwd(logits, w, idx, dw)
    assert pops.moe_router_bwd.launches == before
