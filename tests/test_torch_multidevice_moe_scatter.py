"""The moe family's sharded step on 8 gloo ranks with the sort/scatter
dispatch (``moe.impl="scatter"``): granite-moe-3b-a800m reduced as in
``test_torch_multidevice_moe.py``, held to the same contract and limits.

``dist.sharding.local_moe_scatter`` runs the dispatch on each rank's groups
and experts: the groups as the batch splits them, the experts over
``model`` as their weights are split (their ``fsdp`` dim gathered), each
rank's share of the routed output partial over ``model``.  K4's wrapper
runs on each rank's rows (``local_moe_router``), K1's on each rank's batch
and heads.  The (1,1) run is held against JAX's scatter path on JAX's
weights; one spawned world serves every case of this file.
"""
import pytest

from _torch_multidevice_family import (  # noqa: F401  (the tests, collected here)
    Family, family_runs, test_first_step_gradients_match_one_device,
    test_kernels_run_on_local_shards, test_loss_falls, test_named_parameter_gradient_matches_one_device,
    test_one_device_losses_match_jax, test_parameters_and_moments_keep_their_placements,
    test_prefill_matches_one_device, test_replicated_parameters_stay_equal_across_ranks,
    test_sharded_losses_stay_within_rtol_of_one_device)
from test_torch_multidevice_moe import FAMILY as EINSUM  # noqa: I001
from test_torch_multidevice_moe import test_decode_step_matches_one_device  # noqa: F401

# the einsum dispatch's family: the same arch, wrappers' local shapes (the
# router's rows and K1's inputs do not depend on the dispatch) and limits
FAMILY = Family(arch=EINSUM.arch, local=EINSUM.local, grad_tol=EINSUM.grad_tol,
                named=EINSUM.named, serve_tol=EINSUM.serve_tol, moe_impl="scatter")


@pytest.fixture(scope="module")
def family():
    return FAMILY


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs(FAMILY.arch, tmp_path_factory.mktemp("sharded"), FAMILY.moe_impl)
