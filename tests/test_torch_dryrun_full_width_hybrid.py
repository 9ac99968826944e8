"""recurrentgemma-9b's three records at full width on the single-pod mesh
(16, 16): the port's rank 0 against JAX's ``lower_one`` on 256 host devices
(``_torch_full_width.records``), equal.

Its train step was the one record that the two torches counted apart: on
torch 2.13 DTensor ran the weight gradient of each RG-LRU block's w_x
(4096 x 4096) whole on every ``model`` rank, where XLA (and torch 2.11)
split it; ``models/rglru.py`` pins u's gradient to u's placements
(``pin_grad``), so both count JAX's.  Each test leaves no process group
behind.
"""
import pytest
import torch.distributed as dist

import _torch_full_width as fw

ARCH = "recurrentgemma-9b"
CASES = [(ARCH, s) for s in ("decode_32k", "prefill_32k", "train_4k")]
DEADLINE_S = 300                # the port's three counts (about 150 s on one CPU core)


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


@pytest.fixture(scope="module")
def records():
    return fw.records(CASES, deadline_s=DEADLINE_S)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch,shape", CASES)
def test_full_width_dot_flops_match_jaxs_but_the_named_products(records, arch, shape):
    fw.check(records, arch, shape)


def test_the_train_step_is_jaxs_count_with_no_named_difference(records):
    assert (ARCH, "train_4k") not in fw.DIFFERENCES
    port, ref = records[f"{ARCH}/train_4k"]
    assert port["device_flops"] == ref["device_flops"] == 308_756_608_974_848
