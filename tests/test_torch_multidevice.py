"""The port's sharded train step on 8 ranks, against one rank and against JAX.

JAX's ``test_multidevice_exec`` contract, run on the port: the reduced
smollm-135m (remat on, ``attn_impl="pallas"``, so that attention goes
through ``dist.sharding.local_shards`` to K1's wrapper, whose plain version
runs on the CPU shards) takes 5 AdamW steps on JAX's weights, carried
across by ``models/convert.py``, and ``SyntheticLMDataset`` batches (B=8,
S=64), under
three setups: a ``(1,1)`` mesh; ``(4,2)`` with the ``fsdp_tp`` strategy;
``(4,2)`` with ``dp_only``.  The meshes come from a device-mode
``SlicePool`` over the ranks of a gloo process group of 8 spawned
processes (``_torch_sharded_worker.py``), joined through a file store under
the test's temporary directory, one thread each.  Held: each sharded run's
losses within rtol 2e-3 of the ``(1,1)`` run's (DESIGN.md §3), the
``(1,1)`` run's within ``TRAJ_TOL`` of JAX's single-device losses on the
same weights, the loss falling, every parameter's and moment's placements
after the steps equal to ``make_shardings``' output, K1's wrapper called on
plain local shards of the expected shapes, ``MeshSlice.make_mesh`` in
device and virtual mode, and the refusals: every kernel wrapper given a
DTensor (each names its helper in ``dist.sharding``), ``constrain`` given a
plain tensor under a policy.  ``test_torch_multidevice_{ssm,hybrid,moe}.py``
hold the other token families to the same contract.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # noqa: F401  (both packages in one process, as in every test_torch_* file)

import _torch_sharded_worker as worker
import repro.models as jm
import repro.train as jtrain
from repro.configs import get_config as jax_get_config
from repro_torch.models import convert, init_params

ARCH, WORLD, STEPS, SETUPS = "smollm-135m", worker.WORLD, worker.STEPS, worker.SETUPS
SHARDED = [name for name, shape, _ in SETUPS if shape != (1, 1)]
# DESIGN.md §3: a sharded run's losses stay within this of one device's.
SHARD_RTOL = 2e-3
# tests/test_torch_train.py's bound on 20 AdamW steps of the port against
# JAX (largest difference read there 3.8e-6).
TRAJ_TOL = 1e-4
# The whole spawn: 8 ranks importing torch, then 3 setups of 5 steps
# (about 30 s alone on 8 cores).
DEADLINE_S = 240
# K1's wrapper's q (B, S, H, hd) on each rank under each setup: the batch
# over the data axes (dp_only: over both), heads over "model" under fsdp_tp
# (4 heads and 2 kv heads divide 2).
LOCAL_Q = {"(1,1)": (8, 64, 4, 64), "(4,2) fsdp_tp": (2, 64, 2, 64),
           "(4,2) dp_only": (1, 64, 4, 64)}
# The helper that each kernel wrapper's refusal of a DTensor names.
HELPERS = {"flash_attention": "local_shards", "rwkv6_scan": "local_rwkv6_scan",
           "rglru_scan": "local_rglru_scan", "moe_router": "local_moe_router"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), remat=True)
    cfg = worker.reduced_config()
    jparams = jm.init_params(jax.random.key(0), jcfg)
    weights = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, jparams),
                                    init_params(None, cfg, "meta"))
    batches = worker.batches_for(cfg)
    try:
        results = worker.spawn_ranks(tmp, cfg, weights, batches, DEADLINE_S)
    except RuntimeError as e:
        pytest.fail(str(e))

    # JAX on one device, the same weights and batches
    opt = jtrain.adamw(1e-3)
    state = jtrain.TrainState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
    step = jax.jit(jtrain.make_train_step(jcfg, opt))
    jax_losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        jax_losses.append(float(m["loss"]))
    return results, jax_losses


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
    assert set(results[0]) >= {"(1,1)"} and "(1,1)" not in results[1]
    np.testing.assert_allclose(results[0]["(1,1)"]["losses"], jax_losses, rtol=0,
                               atol=TRAJ_TOL)


@pytest.mark.parametrize("setup", [name for name, _, _ in SETUPS])
def test_loss_falls(runs, setup):
    losses = runs[0][0][setup]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("setup", [name for name, _, _ in SETUPS])
def test_parameters_and_moments_keep_their_placements(runs, setup):
    results, _ = runs
    ranks = [0] if setup == "(1,1)" else range(WORLD)
    for rank in ranks:
        assert results[rank][setup]["misplaced"] == []
    sharded = results[0][setup]["sharded"]
    if setup == "(4,2) fsdp_tp":   # FSDP and TP: every weight matrix, the table too
        assert "embed.tok" in sharded and "stack.0.0.0.attn.wq.weight" in sharded
    if setup == "(4,2) dp_only":   # FSDP over data only: still the matrices
        assert "stack.0.0.1.mlp.w_down.weight" in sharded


@pytest.mark.parametrize("setup", [name for name, _, _ in SETUPS])
def test_attention_runs_on_local_shards(runs, setup):
    """K1's wrapper sees plain tensors, each rank's shard of q."""
    assert runs[0][0][setup]["calls"]["flash_attention"] == [("Tensor", LOCAL_Q[setup])]


def test_make_mesh_device_mode_covers_the_slice_ranks(runs):
    results, _ = runs
    for rank in range(WORLD):
        mesh = results[rank]["mesh"]
        assert mesh["ranks"] == [[4, 5], [6, 7]] and mesh["shape"] == (2, 2)
        assert mesh["names"] == ("data", "model")
        assert mesh["coordinate"] == (None if rank < 4 else ((rank - 4) // 2, rank % 2))
        assert "not inside the process group" in mesh["past the group"]
        assert "cannot be tiled" in mesh["virtual"]


@pytest.mark.parametrize("case", ["flash_attention", "rwkv6_scan", "rglru_scan", "moe_router",
                                  "constrain"])
def test_no_silent_unsharded_run(runs, case):
    """A kernel wrapper refuses a DTensor and names the helper of
    ``dist.sharding`` that runs it on each rank's shards (K1
    ``local_shards``, K2-K4 ``local_rwkv6_scan``, ``local_rglru_scan`` and
    ``local_moe_router``), and ``constrain`` refuses a plain tensor under an
    activation policy."""
    got = runs[0][0]["refusals"]
    assert got["mesh"] == ((WORLD,), ("data",))   # a virtual slice of the whole group
    kind, msg = got[case]
    if case == "constrain":
        assert kind == "TypeError" and "needs a DTensor" in msg
    else:
        assert kind == "NotImplementedError" and f"dist.sharding.{HELPERS[case]}" in msg
