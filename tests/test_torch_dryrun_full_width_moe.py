"""deepseek-moe-16b's three records at full width on the single-pod mesh
(16, 16): the port's rank 0 against JAX's ``lower_one`` on 256 host devices
(``_torch_full_width.records``), equal but for the products named and
counted in ``_torch_full_width.DIFFERENCES``.

In the decode step the 128 tokens make one group (padded to 256), which the
data axes split by tokens and no further; the 64 experts split over
``model``.  XLA then splits the expert products' d_model over the data axes
(their fan-in in w_gate's and w_up's products, the output in w_down's) and
the combine's with them; the port does the same on each rank's shards
(``models/moe.py``: ``_experts_ffn`` under ``local_einsum``), so its count
is JAX's.  Each test leaves no process group behind.
"""
import pytest
import torch.distributed as dist

import _torch_full_width as fw

ARCH = "deepseek-moe-16b"
CASES = [(ARCH, s) for s in ("decode_32k", "prefill_32k", "train_4k")]
DEADLINE_S = 240                # the port's three counts (about 95 s on one CPU core)


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


def test_the_decode_steps_expert_products_split_d_model_as_xlas(records):
    """9,003,073,536 dot FLOPs a rank, JAX's count on this CPU (jax 0.9.0),
    where the port counted 48,719,986,688 with the expert products whole
    over the data axes."""
    port, _ = records[f"{ARCH}/decode_32k"]
    assert port["device_flops"] == 9_003_073_536
