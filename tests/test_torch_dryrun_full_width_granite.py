"""granite-moe-3b-a800m's, gemma-2b's and paligemma-3b's records at full
width on the single-pod mesh (16, 16): the port's rank 0 against JAX's
``lower_one`` on 256 host devices (``_torch_full_width.records``), equal but
for the products named and counted in ``_torch_full_width.DIFFERENCES``.

Their attention heads (24, 8, 8) do not divide ``model``'s 16 ranks, so the
head-aware rules keep wq, wk, wv and wo off ``model``; granite's vocab
(49,155) keeps its tied LM head off it too.  XLA's partitioner splits those
products over ``model`` all the same, and so does the port
(``dist.sharding.spread_linear``: the rows, or in a decode step the
features or the fan-in).  Granite's experts (40) do not divide ``model``
either: the differences left are in its MoE layers.  Each test leaves no
process group behind.
"""
import pytest
import torch.distributed as dist

import _torch_full_width as fw

CASES = ([("granite-moe-3b-a800m", s) for s in ("decode_32k", "prefill_32k", "train_4k")]
         + [(a, s) for a in ("gemma-2b", "paligemma-3b") for s in ("decode_32k", "prefill_32k")])
DEADLINE_S = 300                # the port's seven counts (about 110 s on one CPU core)


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
