"""The moe family's sharded step on 8 gloo ranks: granite-moe-3b-a800m
(reduced, 16 of its 40 experts, so that its top 8 make a choice).

K4's wrapper runs on each rank's rows of the (G, S, E) router logits
through ``dist.sharding.local_moe_router``, the experts whole; K1's on each
rank's batch and heads through ``local_shards``.  Beside the family tests
of ``_torch_multidevice_family.py``, one greedy decode step after the
prefill (K4 runs in every MoE decode step) against the one-rank run's.
"""
import pytest

from _torch_multidevice_family import (  # noqa: F401  (the tests, collected here)
    SERVED, Family, family_runs, normwise, test_first_step_gradients_match_one_device,
    test_kernels_run_on_local_shards, test_loss_falls, test_named_parameter_gradient_matches_one_device,
    test_one_device_losses_match_jax, test_parameters_and_moments_keep_their_placements,
    test_prefill_matches_one_device, test_replicated_parameters_stay_equal_across_ranks,
    test_sharded_losses_stay_within_rtol_of_one_device)

# First-step gradients under (4,2) against (1,1), normwise: about 10x the
# largest reading (6.05e-8, the embedding's, under fsdp_tp; the router's 2.24e-8).
GRAD_TOL = 6e-7

FAMILY = Family(
    arch="granite-moe-3b-a800m",
    # logits (G, S, E), 16 groups of 32 tokens: the groups over the data axes
    # as constrain places them (dp_only: over both), the experts whole; q
    # (B, S, H, hd) as smollm-135m's
    local={"(1,1)": {"moe_router": (16, 32, 16), "flash_attention": (8, 64, 4, 64)},
           "(4,2) fsdp_tp": {"moe_router": (4, 32, 16), "flash_attention": (2, 64, 2, 64)},
           "(4,2) dp_only": {"moe_router": (2, 32, 16), "flash_attention": (1, 64, 4, 64)}},
    grad_tol=GRAD_TOL, named="moe.router")


@pytest.fixture(scope="module")
def family():
    return FAMILY


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs(FAMILY.arch, tmp_path_factory.mktemp("sharded"))


@pytest.mark.parametrize("setup", SERVED)
def test_decode_step_matches_one_device(runs, setup):
    """One greedy decode step after the prefill: its logits and every cache
    leaf, sharded against the one-rank run, K4 on each rank's rows."""
    results, _ = runs
    ref, got = results[0]["(1,1)"]["serve"]["decode"], results[0][setup]["serve"]["decode"]
    assert sorted(got) == sorted(ref) and "logits" in got
    errs = {k: normwise(v, ref[k]) for k, v in got.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= FAMILY.serve_tol, (worst, errs[worst])
