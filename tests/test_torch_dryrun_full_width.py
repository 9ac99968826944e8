"""smollm-135m's records at full width on the single-pod mesh (16, 16):
the port's rank 0 (``repro_torch.launch.dryrun.lower_one`` under a fake
group of 256 ranks) against JAX's ``lower_one`` on 256 host devices, for
train_4k, prefill_32k and decode_32k (``_torch_full_width.records``), and
its train_4k on the two-pod mesh (2, 16, 16) against JAX's on 512.  On one
pod their dot FLOPs are equal; on two, but for the products named and
counted in ``_torch_full_width.TWO_POD_DIFFERENCES``.

smollm's 9 heads do not divide ``model``'s 16 ranks, so the head-aware rules
keep the attention weights off ``model`` in both packages.  XLA's
partitioner still splits the q and o projections over ``model`` (36 of
their 576 features a rank, across head boundaries), and in a decode step,
whose 8 tokens a data rank do not split 16 ways, the k and v projections'
contraction; the port splits the same products over ``model``
(``dist.sharding.spread_linear``: their rows, or in a decode step their
features), the same share of each.

Every test leaves no process group behind.
"""
import pytest
import torch.distributed as dist

import _torch_full_width as fw
from repro_torch.configs import get_config

ARCH, SHAPE_NAMES = "smollm-135m", ("train_4k", "prefill_32k", "decode_32k")
DEADLINE_S = 240                # the port's three counts (about 60 s on one CPU core)


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


@pytest.fixture(scope="module")
def records():
    """(port record, JAX record) of each shape; JAX's subprocess compiles
    while the port counts."""
    return fw.records([(ARCH, name) for name in SHAPE_NAMES], deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def two_pods():
    return fw.records([(ARCH, "train_4k")], deadline_s=DEADLINE_S, mesh="pods2x16x16")


def test_the_heads_do_not_divide_model():
    cfg = get_config(ARCH)
    assert cfg.n_heads % fw.MODEL and cfg.kv_heads % fw.MODEL


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_full_width_dot_flops_match_jaxs_but_the_named_products(records, name):
    assert (ARCH, name) not in fw.DIFFERENCES
    fw.check(records, ARCH, name)


@pytest.mark.timeout(600)
def test_two_pod_train_dot_flops_match_jaxs_but_the_named_products(two_pods):
    fw.check(two_pods, ARCH, "train_4k", mesh="pods2x16x16")
