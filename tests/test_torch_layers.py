"""Each ported function of repro/models/layers.py against JAX, in fp32 and
bf16, on the same numpy inputs and weights (weights go through
``repro_torch.models.convert``, the one place that knows the layouts)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL

from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import layers as PL

DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S = 2, 40


def _cfgs(dtype, arch="smollm-135m", **kw):
    kw = dict(param_dtype=dtype, activation_dtype=dtype, **kw)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _jtree(tree, dtype):
    return jax.tree_util.tree_map(lambda a: _j(a, dtype), tree)


def _close(port, jax_out, dtype, atol=None):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(jax_out, np.float32),
                               atol=atol or ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm, dtype):
    jcfg, pcfg = _cfgs(dtype, norm=norm)
    D = jcfg.d_model
    tree = {"scale": 1 + _rand(1, D, scale=0.1)}
    if norm == "layernorm":
        tree["bias"] = _rand(2, D, scale=0.1)
    x = _rand(3, B, S, D) + 0.5
    mod = convert.load_module(PL.Norm(D, pcfg, "cpu"), tree)
    _close(mod(_t(x, dtype)), JL.apply_norm(_jtree(tree, dtype), _j(x, dtype), jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    hd, theta = 64, 10000.0
    pos = np.arange(7, 7 + S, dtype=np.int32)[None].repeat(B, 0)
    x = _rand(4, B, S, 3, hd)
    jcos, jsin = JL.rope_angles(jnp.asarray(pos), hd, theta)
    pcos, psin = PL.rope_angles(torch.from_numpy(pos), hd, theta)
    _close(pcos, jcos, "float32")
    _close(psin, jsin, "float32")
    _close(PL.apply_rope(_t(x, dtype), pcos, psin),
           JL.apply_rope(_j(x, dtype), jcos, jsin), dtype)


def _attn_tree(jcfg, bias: bool):
    D, H, K, hd = jcfg.d_model, jcfg.n_heads, jcfg.kv_heads, jcfg.hd
    s = 1 / np.sqrt(D)
    tree = {"wq": _rand(5, D, H * hd, scale=s), "wk": _rand(6, D, K * hd, scale=s),
            "wv": _rand(7, D, K * hd, scale=s), "wo": _rand(8, H * hd, D, scale=1 / np.sqrt(H * hd))}
    if bias:
        tree.update(bq=_rand(9, H * hd, scale=0.1), bk=_rand(10, K * hd, scale=0.1),
                    bv=_rand(11, K * hd, scale=0.1))
    return tree


@pytest.mark.parametrize("dtype", DTYPES)
def test_qkv_with_bias(dtype):
    jcfg, pcfg = _cfgs(dtype, arch="qwen1.5-110b")
    assert jcfg.qkv_bias
    tree = _attn_tree(jcfg, bias=True)
    x = _rand(12, B, S, jcfg.d_model)
    attn = convert.load_module(PL.Attention(pcfg, None, "cpu"), tree)
    for p, j in zip(attn._qkv(_t(x, dtype), pcfg), JL._qkv(_jtree(tree, dtype), _j(x, dtype), jcfg)):
        _close(p, j, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("window", [None, 12])
def test_attend(impl, window, dtype):
    """attend() on post-RoPE q/k/v; ``pallas`` is the plain version on CPU on
    the port's side and the interpret-mode kernel on JAX's."""
    jcfg, pcfg = _cfgs(dtype, attn_chunk=16)    # 40 queries: 3 chunks, the last short
    H, K, hd = jcfg.n_heads, jcfg.kv_heads, jcfg.hd
    q, k, v = _rand(13, B, S, H, hd), _rand(14, B, S, K, hd), _rand(15, B, S, K, hd)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    jout = JL.attend(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(pos),
                     jnp.asarray(pos), jcfg, window=window, impl=impl)
    pout = PL.attend(_t(q, dtype), _t(k, dtype), _t(v, dtype), torch.from_numpy(pos),
                     torch.from_numpy(pos), pcfg, window=window, impl=impl)
    _close(pout, jout, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_layer(dtype):
    jcfg, pcfg = _cfgs(dtype)
    tree = _attn_tree(jcfg, bias=False)
    x = _rand(16, B, S, jcfg.d_model)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    attn = convert.load_module(PL.Attention(pcfg, None, "cpu"), tree)
    py, (pk, pv) = attn(_t(x, dtype), pcfg, torch.from_numpy(pos))
    jy, (jk, jv) = JL.attention(_jtree(tree, dtype), _j(x, dtype), jcfg, jnp.asarray(pos))
    for p, j in ((py, jy), (pk, jk), (pv, jv)):
        _close(p, j, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,activation", [
    ("smollm-135m", "swiglu"), ("gemma-2b", "geglu"), ("hubert-xlarge", "gelu")])
def test_mlp(arch, activation, dtype):
    jcfg, pcfg = _cfgs(dtype, arch=arch)
    assert jcfg.activation == activation
    D, Fd = jcfg.d_model, jcfg.d_ff
    if activation == "gelu":
        tree = {"w_in": _rand(17, D, Fd, scale=D ** -0.5), "b_in": _rand(18, Fd, scale=0.1),
                "w_out": _rand(19, Fd, D, scale=Fd ** -0.5), "b_out": _rand(20, D, scale=0.1)}
    else:
        tree = {"w_gate": _rand(17, D, Fd, scale=D ** -0.5), "w_up": _rand(18, D, Fd, scale=D ** -0.5),
                "w_down": _rand(19, Fd, D, scale=Fd ** -0.5)}
    x = _rand(21, B, S, D)
    mlp = convert.load_module(PL.MLP(pcfg, None, "cpu"), tree)
    _close(mlp(_t(x, dtype)), JL.apply_mlp(_jtree(tree, dtype), _j(x, dtype), jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b"])
def test_embed_tokens(arch, dtype):
    jcfg, pcfg = _cfgs(dtype, arch=arch)
    tree = {"tok": _rand(22, jcfg.vocab_size, jcfg.d_model, scale=0.02)}
    tokens = np.random.default_rng(23).integers(0, jcfg.vocab_size, (B, S), np.int32)
    emb = convert.load_module(PL.Embedding(pcfg, None, "cpu"), tree)
    _close(emb.embed_tokens(torch.from_numpy(tokens), pcfg),
           JL.embed_tokens(_jtree(tree, dtype), jnp.asarray(tokens), jcfg), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_padded_vocab(tied, dtype):
    jcfg, pcfg = _cfgs(dtype, tie_embeddings=tied, padded_vocab=640)
    D, V = jcfg.d_model, 640
    embed = {"tok": _rand(24, V, D, scale=0.02)}
    head = None if tied else {"w": _rand(25, D, V, scale=0.02)}
    x = _rand(26, B, S, D)
    pemb = convert.load_module(PL.Embedding(pcfg, None, "cpu"), embed)
    phead = None if tied else convert.load_module(PL.init_lm_head(pcfg, None, "cpu"), head)
    pout = PL.lm_logits(pemb, phead, _t(x, dtype), pcfg)
    jout = JL.lm_logits(_jtree(embed, dtype), None if tied else _jtree(head, dtype),
                        _j(x, dtype), jcfg)
    assert tuple(pout.shape) == (B, S, V)
    assert torch.all(pout[..., jcfg.vocab_size:].float() < -9.9e29)   # -1e30, rounded
    _close(pout, jout, dtype)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b", "qwen1.5-110b", "hubert-xlarge"])
def test_inits_have_jax_shapes_and_scales(arch):
    """Each layer's own init: the JAX init's leaves (as convert names them),
    shapes, and per-leaf std within 10%; constants (ones, zeros) equal."""
    jcfg, pcfg = _cfgs("float32", arch=arch)
    key, gen = jax.random.key(0), torch.Generator().manual_seed(0)
    pairs = [(JL.init_attention(key, jcfg), PL.Attention(pcfg, gen, "cpu")),
             (JL.init_mlp(key, jcfg), PL.MLP(pcfg, gen, "cpu")),
             (JL.init_norm(jcfg.d_model, jcfg), PL.Norm(jcfg.d_model, pcfg, "cpu")),
             (JL.init_embedding(key, jcfg), PL.Embedding(pcfg, gen, "cpu"))]
    if not jcfg.tie_embeddings:
        pairs.append((JL.init_lm_head(key, jcfg), PL.init_lm_head(pcfg, gen, "cpu")))
    for jtree, mod in pairs:
        jstate = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, jtree), mod)
        pstate = mod.state_dict()
        assert sorted(pstate) == sorted(jstate)
        for name, t in pstate.items():
            p, j = t.numpy(), jstate[name]
            assert p.shape == j.shape and t.dtype == torch.float32, name
            if j.std() == 0:
                np.testing.assert_array_equal(p, j, err_msg=name)
            else:
                assert abs(p.std() / j.std() - 1) < 0.1, (name, p.std(), j.std())
