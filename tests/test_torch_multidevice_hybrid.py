"""The hybrid family's sharded step on 8 gloo ranks: recurrentgemma-9b
(reduced: rglru, rglru, local_attn).

K3's wrapper runs on each rank's batch and channels through
``dist.sharding.local_rglru_scan``, K1's (the local attention, MQA) on its
batch and heads through ``local_shards``.  The tests are
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
# largest reading (6.15e-8, the embedding's, under fsdp_tp; lam's 3.9e-9).
GRAD_TOL = 6e-7

FAMILY = Family(
    arch="recurrentgemma-9b",
    # a (B, S, R) and q (B, S, H, hd): the batch over the data axes (dp_only:
    # over both), R = 256 and the 4 query heads over "model" under fsdp_tp
    local={"(1,1)": {"rglru_scan": (8, 64, 256), "flash_attention": (8, 64, 4, 64)},
           "(4,2) fsdp_tp": {"rglru_scan": (2, 64, 128), "flash_attention": (2, 64, 2, 64)},
           "(4,2) dp_only": {"rglru_scan": (1, 64, 256), "flash_attention": (1, 64, 4, 64)}},
    grad_tol=GRAD_TOL, named="rglru.lam")


@pytest.fixture(scope="module")
def family():
    return FAMILY


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs(FAMILY.arch, tmp_path_factory.mktemp("sharded"))
