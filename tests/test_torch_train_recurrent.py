"""The port's training slice for the ssm and hybrid families against the JAX
package's, on the CPU.

``rwkv6-1.6b.reduced()`` (two RWKV-6 layers, four heads of 64) and
``recurrentgemma-9b.reduced()`` (rglru, rglru, local_attn): JAX initialises
the weights and every leaf is redrawn around its mean with its spread (0.3
for a constant), so that no zero-initialised mix or bias hides a term;
``repro_torch.models.convert`` carries them into the port, and carries JAX's
gradient trees onto the port's parameter names.  The loss and every
parameter's gradient of the port's ``forward_train`` under
``kernel_impl="jnp"`` (the chunked WKV scan and the associative RG-LRU scan)
and under ``"pallas"`` (on the CPU the kernels' plain versions, the
sequential scans, differentiated by autograd) are held against
``jax.value_and_grad`` of JAX's ``forward_train`` under ``"jnp"``.  Then the
kernels that ``launch/train.py`` and ``launch/tune.py`` pick on a card.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig, SyntheticLMDataset

from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.launch import tune
from repro_torch.models import convert, forward_train

# Normwise errors, max |port - jax| over max(1, max |jax|): fp32 sums taken
# in another order than XLA's, and under "pallas" a sequential scan for a
# chunked or associative one.  recurrentgemma: the fp32 kernel tolerance of
# tests/test_kernels.py and tests/test_torch_train.py, 2e-5 (readings at
# most 4.1e-7).  rwkv6: the fp32 tolerance that tests/test_kernels.py gives
# the WKV scan itself, 1e-4, since a sequential and a chunked scan sum in
# other orders and the layers above amplify it (readings at most 1.5e-5
# under "jnp" and 2.9e-5 under "pallas", both in the embedding's gradient).
TOL = {"rwkv6-1.6b": 1e-4, "recurrentgemma-9b": 2e-5}
# 40 tokens: rwkv6's chunks of 16 leave a ragged last chunk.
B, S, CHUNK = 2, 40, 16
ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b")


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


def _setup(arch, remat=False):
    over = dict(remat=remat, rwkv_chunk=CHUNK)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    pcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jparams = _redrawn(jm.init_params(jax.random.key(0), jcfg), seed=3)
    model = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), pcfg, "cpu")
    batch = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S,
                                          vocab_size=jcfg.vocab_size, seed=2)).batch_at(0)
    return jcfg, pcfg, jparams, model, batch


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's loss and gradients under kernel_impl="jnp", one per arch."""
    out = {}
    for arch in ARCHS:
        jcfg, _, jparams, _, batch = _setup(arch)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jm.forward_train(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
            has_aux=True)(jparams)
        out[arch] = float(loss), jax.tree_util.tree_map(np.asarray, grads)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_loss_and_every_gradient_match_jax(jax_reference, arch, kernel_impl,
                                                         remat):
    _, pcfg, _, model, batch = _setup(arch, remat)
    cfg = dataclasses.replace(pcfg, kernel_impl=kernel_impl)
    loss, _ = forward_train(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    jloss, jgrads = jax_reference[arch]
    expect = convert.to_state_dict(jgrads, model)
    assert sorted(expect) == sorted(names)
    assert _normwise(float(loss.detach()), jloss) <= TOL[arch]
    errs = {n: _normwise(g.numpy(), expect[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL[arch], (worst, errs[worst])
    assert all(float(np.abs(g.numpy()).max()) > 0 for g in grads if g.numel() > 1)


def test_chip_smoke_float64_gradients_of_the_plain_path(jax_reference):
    """``chip_smoke.first_step_grads_f64``, which phase 3c holds rwkv6's
    gradients against: every gradient in float64 and within the fp32
    tolerance of JAX's, the weights back in float32 bit for bit, and for
    each norm's leaves the sum of its terms' absolute values at least the
    size of the sum itself."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, pcfg, _, model, batch = _setup("rwkv6-1.6b", remat=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, grads, sums = smoke.first_step_grads_f64(
        torch, forward_train, model, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    assert all(p.dtype == torch.float32 and torch.equal(p, before[n])
               for n, p in model.named_parameters())
    assert {g.dtype for g in grads.values()} == {torch.float64}
    jloss, jgrads = jax_reference["rwkv6-1.6b"]
    expect = convert.to_state_dict(jgrads, model)
    assert sorted(grads) == sorted(expect)
    assert _normwise(loss, jloss) <= TOL["rwkv6-1.6b"]
    errs = {n: _normwise(g.numpy(), expect[n]) for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL["rwkv6-1.6b"], (worst, errs[worst])
    norms = {n for n in grads if n.endswith(("norm1.scale", "norm1.bias", "norm2.scale",
                                             "norm2.bias"))}
    assert norms and norms <= set(sums)
    for n, total in sums.items():
        assert bool((total >= grads[n].abs() * (1 - 1e-12)).all()), n


# -- the kernels a run picks on the card --------------------------------------------

@pytest.mark.parametrize("arch,kernel_impl", [
    ("smollm-135m", "jnp"), ("rwkv6-1.6b", "pallas"), ("recurrentgemma-9b", "pallas"),
    ("granite-moe-3b-a800m", "pallas"), ("deepseek-moe-16b", "pallas"),
])
def test_training_on_the_card_picks_the_scan_kernels(monkeypatch, arch, kernel_impl):
    """On a card, ``launch/train.py`` and ``tune.trial_model`` train the ssm
    and hybrid families through their scan kernels and the moe family
    through its router kernel (``kernel_impl="pallas"``, each forward and
    backward); attention runs its kernel everywhere.  On the CPU the config is left as
    it is.  The device check is monkeypatched: no card is needed."""
    cfg = get_config(arch)
    assert launch_train.device_model(cfg, torch.device("cpu")) == cfg
    assert tune.trial_model(cfg, "cpu") == cfg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for got in (launch_train.device_model(cfg, torch.device("cuda")),
                tune.trial_model(cfg, "cuda")):
        assert (got.attn_impl, got.kernel_impl) == ("pallas", kernel_impl)
        assert got == dataclasses.replace(cfg, attn_impl="pallas", kernel_impl=kernel_impl)


def test_launch_train_runs_the_picked_config(monkeypatch):
    """``launch.train.train`` trains the config ``device_model`` returns for
    its device: on the CPU, rwkv6's own ``kernel_impl``."""
    seen = []
    real = launch_train.device_model
    monkeypatch.setattr(launch_train, "device_model",
                        lambda cfg, dev: seen.append(dev) or real(cfg, dev))
    res = launch_train.train(get_config("rwkv6-1.6b").reduced(), steps=1, batch=2, seq_len=8,
                             device="cpu", log_every=1)
    assert seen == [torch.device("cpu")] and res.cfg.kernel_impl == "jnp"
    assert np.isfinite(res.losses[0])
