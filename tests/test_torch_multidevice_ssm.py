"""The ssm family's sharded step on 8 gloo ranks: rwkv6-1.6b (reduced).

K2's wrapper runs on each rank's batch and heads through
``dist.sharding.local_rwkv6_scan``; its ``u`` is one parameter for every
batch row, so its local gradient is a partial sum that autograd's backward
sums over the ranks that split the batch.  The tests are
``_torch_multidevice_family.py``'s.
"""
import pytest

from _torch_multidevice_family import (  # noqa: F401  (the tests, collected here)
    Family, family_runs, test_first_step_gradients_match_one_device,
    test_kernels_run_on_local_shards, test_loss_falls, test_named_parameter_gradient_matches_one_device,
    test_one_device_losses_match_jax, test_parameters_and_moments_keep_their_placements,
    test_prefill_matches_one_device, test_replicated_parameters_stay_equal_across_ranks,
    test_sharded_losses_stay_within_rtol_of_one_device)

# First-step gradients under (4,2) against (1,1), normwise: about 10x the
# largest reading (2.29e-7, the embedding's, under fsdp_tp; u's 1.49e-7).
GRAD_TOL = 2.5e-6

FAMILY = Family(
    arch="rwkv6-1.6b",
    # r (B, S, H, N): the batch over the data axes (dp_only: over both), the
    # 4 heads over "model" under fsdp_tp; the sequence and N whole
    local={"(1,1)": {"rwkv6_scan": (8, 64, 4, 64)},
           "(4,2) fsdp_tp": {"rwkv6_scan": (2, 64, 2, 64)},
           "(4,2) dp_only": {"rwkv6_scan": (1, 64, 4, 64)}},
    grad_tol=GRAD_TOL, named="tm.u")


@pytest.fixture(scope="module")
def family():
    return FAMILY


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs(FAMILY.arch, tmp_path_factory.mktemp("sharded"))
