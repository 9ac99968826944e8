"""The sharded train step of a token family on 8 gloo ranks, against one
rank and against JAX: the tests that ``test_torch_multidevice_ssm.py``,
``_hybrid.py`` and ``_moe.py`` each import for their family.

JAX's ``test_multidevice_exec`` contract, run on the port for the ssm,
hybrid and moe families: the reduced config of ``_torch_sharded_worker.
reduced_config`` (``kernel_impl="pallas"`` and ``attn_impl="pallas"``, so
that K2, K3 and K4, and K1 in the hybrid's local attention and the MoE's
attention, reach their wrappers through ``dist.sharding``'s helpers, whose
plain versions run on each rank's CPU shards) takes 5 AdamW steps on JAX's
weights, carried across by ``models/convert.py``, and ``SyntheticLMDataset``
batches (B=8, S=64), under a ``(1,1)`` mesh, ``(4,2) fsdp_tp`` and ``(4,2)
dp_only`` (``test_torch_multidevice.py`` holds smollm-135m to the same).
Held: each sharded run's losses within rtol 2e-3 of the ``(1,1)`` run's
(DESIGN.md §3); the ``(1,1)`` run's within ``TRAJ_TOL`` of JAX's
single-device losses (``kernel_impl="jnp"``; for rwkv6 with JAX's
sequential WKV reference, ``sequential_wkv``) on the same weights; the loss
falling; the placements kept; the first step's gradient of every parameter
under ``(4,2)`` against ``(1,1)``'s, and of the parameter that the family's
kernel differentiates (``Family.named``) on its own; every parameter
replicated over a mesh dim equal on that dim's ranks after the steps; each
wrapper called on plain local shards of the stated shapes; and on ``(4,2)
fsdp_tp`` a prefill of the first batch's 32-token prompt (and for the moe
family one greedy decode step), its logits and every cache leaf against
the ``(1,1)`` run's.

A test file names its ``Family`` in a module fixture ``family`` and builds
its runs in a module fixture ``runs`` (``family_runs``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # noqa: F401  (both packages in one process, as in every test_torch_* file)

import _torch_sharded_worker as worker
import repro.models as jm
import repro.models.rwkv6 as jrwkv6
import repro.train as jtrain
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro_torch.models import convert, init_params

WORLD, STEPS, SETUPS = worker.WORLD, worker.STEPS, worker.SETUPS
SETUP_NAMES = [name for name, _, _ in SETUPS]
SHARDED = [name for name, shape, _ in SETUPS if shape != (1, 1)]
SERVED = [name for name in worker.SERVE_SETUPS if name != "(1,1)"]
# DESIGN.md §3: a sharded run's losses stay within this of one device's.
SHARD_RTOL = 2e-3
# tests/test_torch_train.py's bound on AdamW steps of the port against JAX.
TRAJ_TOL = 1e-4
# The whole spawn: 8 ranks importing torch, then 3 setups of a first-step
# gradient and 5 steps, and two of them serving (about 55-65 s alone on 8
# cores; pytest-timeout may be absent, so the spawn keeps its own deadline).
DEADLINE_S = 600


@dataclasses.dataclass(frozen=True)
class Family:
    """What a test file holds its family to."""
    arch: str
    # each wrapper's local first argument (its shape) on a rank, by setup
    local: Dict[str, Dict[str, Tuple[int, ...]]]
    # first-step gradients under (4,2) against (1,1): normwise, max |a - b|
    # over max(1, max |b|), about 10x the largest reading
    grad_tol: float
    # the parameter (a suffix of its name) that the family's kernel
    # differentiates, held in an assertion of its own
    named: str
    # the serve check's limit (tests/test_torch_serve.py's), normwise
    serve_tol: float = 1e-4
    # the MoE dispatch, where not the config's
    moe_impl: Optional[str] = None


def normwise(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def family_runs(arch: str, tmp, moe_impl: Optional[str] = None) -> Tuple[dict, List[float]]:
    """({rank: the worker's results}, JAX's single-device losses) of
    ``arch``'s reduced config (with the MoE dispatch ``moe_impl`` in both
    packages, where one is given), on JAX's weights (seed 0); JAX trains
    while the ranks run."""
    cfg = worker.reduced_config(arch, moe_impl)
    jcfg = worker.with_moe_impl(jax_get_config(arch).reduced(**worker.ARCHS[arch]), moe_impl)
    jparams = jm.init_params(jax.random.key(0), jcfg)
    weights = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, jparams),
                                    init_params(None, cfg, "meta"))
    batches = worker.batches_for(cfg)
    jax_losses = []

    def jax_steps():
        opt = jtrain.adamw(1e-3)
        state = jtrain.TrainState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
        with sequential_wkv(arch):
            step = jax.jit(jtrain.make_train_step(jcfg, opt))
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                jax_losses.append(float(m["loss"]))

    try:
        results = worker.spawn_ranks(tmp, cfg, weights, batches, DEADLINE_S, serve=True,
                                     checks=False, meanwhile=jax_steps)
    except RuntimeError as e:
        pytest.fail(str(e))
    return results, jax_losses


@contextlib.contextmanager
def sequential_wkv(arch: str):
    """For rwkv6-1.6b, JAX's ``"jnp"`` path with its WKV scan run by the JAX
    package's own sequential reference (``repro.kernels.ref.
    rwkv6_scan_ref``, which the port's plain version mirrors) in place of
    its chunked scan, inside the block: the port's kernel path runs that
    plain version on the CPU, and at this random init AdamW amplifies the
    rounding by which a sequential and a chunked scan differ (JAX's own two
    scans read 1.1e-3 apart by the fifth step, the port and JAX's
    sequential scan at most 5.4e-5).  Other archs as they are."""
    if arch != "rwkv6-1.6b":
        yield
        return
    real = jrwkv6._wkv_chunked
    jrwkv6._wkv_chunked = lambda r, k, v, logw, u, state, chunk: \
        jref.rwkv6_scan_ref(r, k, v, logw, u, state)
    try:
        yield
    finally:
        jrwkv6._wkv_chunked = real


@pytest.mark.parametrize("setup", SHARDED)
def test_sharded_losses_stay_within_rtol_of_one_device(runs, setup):
    results, _ = runs
    ref = results[0]["(1,1)"]["losses"]
    for rank in range(WORLD):
        np.testing.assert_allclose(results[rank][setup]["losses"], ref, rtol=SHARD_RTOL)
    # every rank read the same loss: the metric is the full value
    assert len({tuple(results[r][setup]["losses"]) for r in range(WORLD)}) == 1


def test_one_device_losses_match_jax(runs):
    results, jax_losses = runs
    assert "(1,1)" in results[0] and "(1,1)" not in results[1]
    np.testing.assert_allclose(results[0]["(1,1)"]["losses"], jax_losses, rtol=0,
                               atol=TRAJ_TOL)


@pytest.mark.parametrize("setup", SETUP_NAMES)
def test_loss_falls(runs, setup):
    losses = runs[0][0][setup]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("setup", SETUP_NAMES)
def test_parameters_and_moments_keep_their_placements(runs, setup):
    results, _ = runs
    for rank in ([0] if setup == "(1,1)" else range(WORLD)):
        assert results[rank][setup]["misplaced"] == []
    if setup != "(1,1)":   # FSDP at least: the weight matrices are sharded
        assert len(results[0][setup]["sharded"]) > 0


@pytest.mark.parametrize("setup", SHARDED)
def test_replicated_parameters_stay_equal_across_ranks(runs, family, setup):
    """After the steps, every parameter's local value is the same on the
    ranks of each mesh dim that it is replicated over; the family's named
    parameter is among those checked wherever it is replicated (under
    dp_only, over ``model``, which splits the batch)."""
    results, _ = runs
    for rank in range(WORLD):
        got = results[rank][setup]
        assert got["unequal_replicas"] == [], (rank, got["unequal_replicas"])
        assert got["replicated"], "no parameter replicated over a mesh dim"
    if setup == "(4,2) dp_only":
        assert any(n.endswith(family.named) for n in results[0][setup]["replicated"])


@pytest.mark.parametrize("setup", SHARDED)
def test_first_step_gradients_match_one_device(runs, family, setup):
    results, _ = runs
    ref, got = results[0]["(1,1)"]["grads"], results[0][setup]["grads"]
    assert sorted(got) == sorted(ref)
    errs = {n: normwise(g, ref[n]) for n, g in got.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= family.grad_tol, (worst, errs[worst])


@pytest.mark.parametrize("setup", SHARDED)
def test_named_parameter_gradient_matches_one_device(runs, family, setup):
    """The gradient of the parameter that the family's kernel
    differentiates (rwkv6's ``u``, summed over the batch rows of every
    rank; the RG-LRU's ``lam``; granite's ``router``), in every layer, is
    not zero and matches the one-rank run's."""
    results, _ = runs
    ref, got = results[0]["(1,1)"]["grads"], results[0][setup]["grads"]
    names = [n for n in ref if n.endswith(family.named)]
    assert names
    for n in names:
        assert np.abs(ref[n]).max() > 0, n
        assert normwise(got[n], ref[n]) <= family.grad_tol, n


@pytest.mark.parametrize("setup", SETUP_NAMES)
def test_kernels_run_on_local_shards(runs, family, setup):
    """Each wrapper sees plain tensors, each rank's shard: no helper
    gathers the batch or the heads and runs whole."""
    calls = runs[0][0][setup]["calls"]
    assert calls == {name: [("Tensor", shape)] for name, shape in family.local[setup].items()}


@pytest.mark.parametrize("setup", SERVED)
def test_prefill_matches_one_device(runs, family, setup):
    """The prefill's logits and every cache or state leaf, sharded against
    the one-rank run, through the kernels' wrappers on local shards."""
    results, _ = runs
    ref, got = results[0]["(1,1)"]["serve"]["prefill"], results[0][setup]["serve"]["prefill"]
    assert sorted(got) == sorted(ref) and "logits" in got
    errs = {k: normwise(v, ref[k]) for k, v in got.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= family.serve_tol, (worst, errs[worst])
    assert all(all(kind == "Tensor" for kind, _ in c)
               for c in results[0][setup]["serve_calls"].values())
    assert set(results[0][setup]["serve_calls"]) == set(family.local[setup])
