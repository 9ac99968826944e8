"""Each ported function of repro/models/rwkv6.py and repro/models/rglru.py
against JAX, in fp32 and bf16, on the same numpy inputs and weights (weights
go through ``repro_torch.models.convert``, the one place that knows the
layouts).  Every leaf of the JAX init is redrawn at random first, so that no
zero-initialised mix or bias hides a term."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import rglru as JG
from repro.models import rwkv6 as JW

from repro_torch.configs import get_config
from repro_torch.models import convert, segment_specs
from repro_torch.models import rglru as PG
from repro_torch.models import rwkv6 as PW

DTYPES = ["float32", "bfloat16"]
# fp32: a few hundred fp32 operations per output taken in another order.
# bf16: the two frameworks round intermediates to bf16 at other places; the
# outputs are O(1), so 2e-2 is a few bf16 ulps.  The recurrent states are
# compared relative to their size (the WKV state grows with the prompt).
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 40


def _cfgs(dtype, arch, **kw):
    kw = dict(param_dtype=dtype, activation_dtype=dtype, **kw)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _close(port, jax_out, dtype):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(jax_out, np.float32),
                               atol=ATOL[dtype], rtol=RTOL[dtype])


def _trees(jinit, seed):
    """(JAX tree, numpy tree for the port): each leaf of the JAX init redrawn
    around its mean (std of the leaf, or 0.3 for a constant), in the init's
    dtype; the numpy tree holds the same values exactly."""
    rng = np.random.default_rng(seed)

    def redraw(leaf):
        a = np.asarray(leaf, np.float32)
        std = float(a.std()) or 0.3
        return jnp.asarray(a.mean() + std * rng.standard_normal(a.shape)).astype(leaf.dtype)

    jtree = jax.tree_util.tree_map(redraw, jinit)
    return jtree, jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), jtree)


def _load(module, tree):
    return convert.load_module(module, tree)


def _rwkv_inputs(dtype, seed=0, H=4, N=64):
    r, k, v = (_rand(seed + i, B, S, H, N, scale=0.5) for i in range(3))
    logw = -np.exp(_rand(seed + 3, B, S, H, N, scale=0.5) - 2.0)
    u, s0 = _rand(seed + 4, H, N, scale=0.3), _rand(seed + 5, B, H, N, N, scale=0.2)
    return ((_j(r, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(logw), jnp.asarray(u),
             jnp.asarray(s0)),
            (_t(r, dtype), _t(k, dtype), _t(v, dtype), _t(logw, "float32"), _t(u, "float32"),
             _t(s0, "float32")))


# -- RWKV-6 -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [16, 64])      # 40 steps: ragged last chunk / one chunk
def test_wkv_chunked(dtype, chunk):
    jin, pin = _rwkv_inputs(dtype)
    jy, js = JW._wkv_chunked(*jin, chunk)
    py, ps = PW._wkv_chunked(*pin, chunk)
    assert py.dtype == pin[0].dtype and ps.dtype == torch.float32
    _close(py, jy, dtype)
    _close(ps, js, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv_step(dtype):
    jin, pin = _rwkv_inputs(dtype, seed=10)
    jy, js = JW._wkv_step(*(a[:, 3] for a in jin[:4]), *jin[4:])
    py, ps = PW._wkv_step(*(a[:, 3] for a in pin[:4]), *pin[4:])
    _close(py, jy, dtype)
    _close(ps, js, dtype)


def _time_mix(dtype, seed=20):
    jcfg, pcfg = _cfgs(dtype, "rwkv6-1.6b", rwkv_chunk=16)
    jtree, tree = _trees(JW.init_time_mix(jax.random.key(0), jcfg), seed)
    return jcfg, pcfg, jtree, _load(PW.TimeMix(pcfg, None, "cpu"), tree)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("seq,with_state", [(S, False), (S, True), (1, True)])
def test_apply_time_mix(dtype, kernel_impl, seq, with_state):
    """Prefill (40 tokens in chunks of 16, fresh or carried state) and the
    one-token decode step; ``pallas`` is the plain scan on the port's CPU
    side and the interpret-mode kernel on JAX's."""
    jcfg, pcfg, jtree, mod = _time_mix(dtype)
    jcfg, pcfg = (dataclasses.replace(c, kernel_impl=kernel_impl) for c in (jcfg, pcfg))
    D, H, N = jcfg.d_model, jcfg.d_model // 64, 64
    x = _rand(21, B, seq, D)
    jstate = pstate = None
    if with_state:
        prev, wkv = _rand(22, B, D), _rand(23, B, H, N, N, scale=0.5)
        jstate = {"prev": _j(prev, dtype), "wkv": jnp.asarray(wkv)}
        pstate = {"prev": _t(prev, dtype), "wkv": _t(wkv, "float32")}
    jout, jst = JW.apply_time_mix(jtree, _j(x, dtype), jcfg, jstate)
    pout, pst = PW.apply_time_mix(mod, _t(x, dtype), pcfg, pstate)
    _close(pout, jout, dtype)
    assert sorted(pst) == sorted(jst) == ["prev", "wkv"]
    for leaf in pst:
        _close(pst[leaf], jst[leaf], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,with_state", [(S, False), (S, True), (1, True)])
def test_apply_channel_mix(dtype, seq, with_state):
    jcfg, pcfg = _cfgs(dtype, "rwkv6-1.6b")
    jtree, tree = _trees(JW.init_channel_mix(jax.random.key(1), jcfg), 30)
    mod = _load(PW.ChannelMix(pcfg, None, "cpu"), tree)
    x = _rand(31, B, seq, jcfg.d_model)
    prev = _rand(32, B, jcfg.d_model)
    jout, jst = JW.apply_channel_mix(jtree, _j(x, dtype), jcfg,
                                     {"prev": _j(prev, dtype)} if with_state else None)
    pout, pst = PW.apply_channel_mix(mod, _t(x, dtype), pcfg,
                                     {"prev": _t(prev, dtype)} if with_state else None)
    _close(pout, jout, dtype)
    _close(pst["prev"], jst["prev"], dtype)


# -- RG-LRU ---------------------------------------------------------------------------

def _rglru(dtype, seed=40):
    jcfg, pcfg = _cfgs(dtype, "recurrentgemma-9b")
    jtree, tree = _trees(JG.init_rglru_block(jax.random.key(2), jcfg), seed)
    return jcfg, pcfg, jtree, _load(PG.RGLRU(pcfg, None, "cpu"), tree)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq,with_state", [(S, False), (S, True), (1, True), (2, False)])
def test_causal_conv1d(dtype, seq, with_state):
    jcfg, pcfg, jtree, mod = _rglru(dtype)
    R, W = jcfg.rglru_d_rnn, jcfg.conv1d_width
    u, st = _rand(41, B, seq, R), _rand(42, B, W - 1, R)
    jout, jst = JG._causal_conv1d(jtree, _j(u, dtype), _j(st, dtype) if with_state else None)
    pout, pst = PG._causal_conv1d(mod, _t(u, dtype), _t(st, dtype) if with_state else None)
    _close(pout, jout, dtype)
    _close(pst, jst, dtype)


@pytest.mark.parametrize("seq", [1, 2, 40, 77])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_scan(seq, with_h0):
    """The port's log-depth scan against JAX's associative scan (fp32 on the
    model path)."""
    a = 1 / (1 + np.exp(-_rand(50, B, seq, 24)))
    b, h0 = _rand(51, B, seq, 24, scale=0.3), _rand(52, B, 24, scale=0.2)
    jh = JG._rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0) if with_h0 else None)
    ph = PG._rglru_scan(_t(a, "float32"), _t(b, "float32"),
                        _t(h0, "float32") if with_h0 else None)
    _close(ph, jh, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("seq,with_state", [(S, False), (S, True), (1, True)])
def test_apply_rglru_block(dtype, kernel_impl, seq, with_state):
    jcfg, pcfg, jtree, mod = _rglru(dtype)
    jcfg, pcfg = (dataclasses.replace(c, kernel_impl=kernel_impl) for c in (jcfg, pcfg))
    D, R, W = jcfg.d_model, jcfg.rglru_d_rnn, jcfg.conv1d_width
    x = _rand(60, B, seq, D)
    jstate = pstate = None
    if with_state:
        h, conv = _rand(61, B, R), _rand(62, B, W - 1, R)
        jstate = {"h": jnp.asarray(h), "conv": _j(conv, dtype)}
        pstate = {"h": _t(h, "float32"), "conv": _t(conv, dtype)}
    jout, jst = JG.apply_rglru_block(jtree, _j(x, dtype), jcfg, jstate)
    pout, pst = PG.apply_rglru_block(mod, _t(x, dtype), pcfg, pstate)
    _close(pout, jout, dtype)
    assert sorted(pst) == sorted(jst) == ["conv", "h"]
    assert pst["h"].dtype == torch.float32
    for leaf in pst:
        _close(pst[leaf], jst[leaf], dtype)


# -- inits and weight layouts ------------------------------------------------------------

@pytest.mark.parametrize("which", ["time_mix", "channel_mix", "rglru"])
def test_inits_have_jax_shapes_and_scales(which):
    """Each block's own init: the JAX init's leaves (as convert names them),
    shapes and dtypes, each leaf's std within 10%, constants equal.  At
    d_model 1024, so that the smallest random leaf (u, 16x64) has 1024
    draws."""
    arch = "recurrentgemma-9b" if which == "rglru" else "rwkv6-1.6b"
    jcfg = jax_get_config(arch).reduced(d_model=1024)
    pcfg = get_config(arch).reduced(d_model=1024)
    key, gen = jax.random.key(0), torch.Generator().manual_seed(0)
    jtree, mod = {
        "time_mix": lambda: (JW.init_time_mix(key, jcfg), PW.TimeMix(pcfg, gen, "cpu")),
        "channel_mix": lambda: (JW.init_channel_mix(key, jcfg), PW.ChannelMix(pcfg, gen, "cpu")),
        "rglru": lambda: (JG.init_rglru_block(key, jcfg), PG.RGLRU(pcfg, gen, "cpu")),
    }[which]()
    jstate = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, jtree), mod)
    pstate = mod.state_dict()
    assert sorted(pstate) == sorted(jstate)
    for name, t in pstate.items():
        p, j = t.numpy(), jstate[name]
        assert p.shape == j.shape and str(t.dtype).split(".")[1] == str(j.dtype), name
        if j.std() == 0:
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            assert abs(p.std() / j.std() - 1) < 0.1, (name, p.std(), j.std())
            assert abs(p.mean() - j.mean()) < 0.1 * j.std() + 1e-6, (name, p.mean(), j.mean())


@pytest.mark.parametrize("arch,kinds", [
    ("rwkv6-1.6b", {"rwkv6"}),
    ("recurrentgemma-9b", {"rglru", "local_attn"}),
])
def test_convert_loads_square_matrices_transposed(arch, kinds):
    """Every square ``nn.Linear`` of a reduced model, as ``from_jax`` loads
    it, computes JAX's ``x @ w``: a square matrix loaded untransposed passes
    every shape check, so only the product shows it.  Each block kind of the
    model holds at least one."""
    jcfg, pcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_init_params(jax.random.key(0), jcfg)
    model = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg, "cpu")
    patterns = [types for types, _ in segment_specs(pcfg)]
    seen = set()
    for si, seg in enumerate(jparams["stack"]):
        for bi, block in enumerate(seg["blocks"]):
            for path, w in jax.tree_util.tree_flatten_with_path(block)[0]:
                names = [p.key for p in path]
                for r in range(w.shape[0]):
                    try:
                        lin = model.get_submodule(".".join(["stack", str(si), str(bi), str(r),
                                                            *names]))
                    except AttributeError:
                        continue
                    if not isinstance(lin, torch.nn.Linear) or w.shape[1] != w.shape[2]:
                        continue
                    x = _rand(70 + r, 3, w.shape[1])
                    np.testing.assert_allclose(
                        F.linear(torch.from_numpy(x), lin.weight).detach().numpy(),
                        np.asarray(jnp.asarray(x) @ w[r]), atol=2e-5, rtol=1e-5,
                        err_msg="/".join(map(str, [si, bi, r, *names])))
                    seen.add(patterns[si][bi])
    assert seen == kinds
