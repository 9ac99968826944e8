"""The port's training slice for the moe family against the JAX package's,
on the CPU.

``granite-moe-3b-a800m.reduced(n_experts=16)`` (top 8 of 16) and
``deepseek-moe-16b.reduced(n_experts=8)`` (top 6 of 8, two shared
experts): two layers of d 256, groups of 32 tokens, so that top-k makes a
choice.  JAX initialises the weights and every leaf is redrawn around its
mean with its spread (0.3 for a constant); ``repro_torch.models.convert``
carries them into the port, and carries JAX's gradient trees onto the
port's parameter names.  The loss, the aux loss and every parameter's
gradient of the port's ``forward_train`` under both MoE dispatches
(``moe.impl`` einsum and scatter), both ``kernel_impl``s (``"pallas"`` is
``ops.moe_router``, on the CPU its plain version under autograd) and remat
off and on are held against ``jax.value_and_grad`` of JAX's
``forward_train``; and once with ``capacity_factor`` 0.5, where every group
must drop tokens.  80 tokens a batch are padded to three groups.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig, SyntheticLMDataset

from repro_torch.configs import get_config
from repro_torch.models import convert, forward_train

# Normwise errors, max |port - jax| over max(1, max |jax|): fp32 sums taken
# in another order than XLA's; the fp32 kernel tolerance of
# tests/test_kernels.py and tests/test_torch_train.py (readings at most
# 5.4e-7, a gradient with dropped tokens; the aux loss within 6.2e-8 of its
# size).  The aux loss: rtol 1e-5, as tests/test_torch_moe.py holds it.
TOL, AUX_RTOL = 2e-5, 1e-5
B, S = 2, 40
REDUCED = {"granite-moe-3b-a800m": 16, "deepseek-moe-16b": 8}   # n_experts
ARCHS = tuple(REDUCED)
IMPLS = ("einsum", "scatter")
DROP = 0.5   # capacity_factor of the case that must drop tokens


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes: two intra-op threads are enough, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _normwise(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(1.0, np.abs(ref).max()))


def _redrawn(jinit, seed):
    rng = np.random.default_rng(seed)

    def redraw(leaf):
        a = np.asarray(leaf, np.float32)
        std = float(a.std()) or 0.3
        return jnp.asarray(a.mean() + std * rng.standard_normal(a.shape)).astype(leaf.dtype)

    return jax.tree_util.tree_map(redraw, jinit)


def _cfg(get, arch, impl, capacity, remat=False):
    cfg = get(arch).reduced(n_experts=REDUCED[arch])
    moe = dataclasses.replace(cfg.moe, impl=impl,
                              capacity_factor=capacity or cfg.moe.capacity_factor)
    return dataclasses.replace(cfg, moe=moe, remat=remat)


def _setup(arch, impl, capacity=None, remat=False):
    jcfg = _cfg(jax_get_config, arch, impl, capacity)
    pcfg = _cfg(get_config, arch, impl, capacity, remat)
    jparams = _redrawn(jm.init_params(jax.random.key(0), jcfg), seed=3)
    model = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg, "cpu")
    batch = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S,
                                          vocab_size=jcfg.vocab_size, seed=2)).batch_at(0)
    return jcfg, pcfg, jparams, model, batch


REFS = [(arch, impl, None) for arch in ARCHS for impl in IMPLS] + \
    [("granite-moe-3b-a800m", impl, DROP) for impl in IMPLS]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's loss, aux loss and gradients, one per (arch, impl, capacity)."""
    out = {}
    for key in REFS:
        jcfg, _, jparams, _, batch = _setup(*key)
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jm.forward_train(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
            has_aux=True)(jparams)
        out[key] = (float(loss), float(metrics["aux_loss"]),
                    jax.tree_util.tree_map(np.asarray, grads))
    return out


def _check(jax_reference, key, kernel_impl, remat):
    _, pcfg, _, model, batch = _setup(*key, remat=remat)
    cfg = dataclasses.replace(pcfg, kernel_impl=kernel_impl)
    loss, metrics = forward_train(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    jloss, jaux, jgrads = jax_reference[key]
    expect = convert.to_state_dict(jgrads, model)
    assert sorted(expect) == sorted(names)
    assert _normwise(float(loss.detach()), jloss) <= TOL
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()), jaux, rtol=AUX_RTOL)
    errs = {n: _normwise(g.numpy(), expect[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
    routers = [g for n, g in zip(names, grads) if n.endswith("moe.router")]
    assert len(routers) == pcfg.n_layers
    assert all(float(g.abs().max()) > 0 for g in routers)
    return pcfg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_loss_aux_and_every_gradient_match_jax(jax_reference, arch, impl,
                                                             kernel_impl, remat):
    pcfg = _check(jax_reference, (arch, impl, None), kernel_impl, remat)
    assert pcfg.moe.top_k < pcfg.moe.n_experts


@pytest.mark.parametrize("impl", IMPLS)
def test_dropped_tokens_train_as_in_jax(jax_reference, impl):
    """capacity_factor 0.5: an expert takes C = ceil(32 * 8 / 16 * 0.5) = 8
    tokens of a group, so the group's 16 experts hold 128 of its 256 (token,
    expert) pairs and the rest are dropped, whatever the routing."""
    pcfg = _check(jax_reference, ("granite-moe-3b-a800m", impl, DROP), "pallas", False)
    moe = pcfg.moe
    C = max(1, math.ceil(moe.group_size * moe.top_k / moe.n_experts * moe.capacity_factor))
    assert moe.n_experts * C < moe.group_size * moe.top_k
