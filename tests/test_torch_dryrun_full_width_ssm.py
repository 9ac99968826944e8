"""rwkv6-1.6b's three records and hubert-xlarge's prefill at full width on
the single-pod mesh (16, 16): the port's rank 0 against JAX's ``lower_one``
on 256 host devices (``_torch_full_width.records``), equal but for the
products named and counted in ``_torch_full_width.DIFFERENCES``.

rwkv6-1.6b's prefill and train step are held at full width and 2 of their
24 layers (``DEPTH``), in both packages: the port's chunked WKV scan is a
Python loop of 1,024 chunks a layer in a 32k prefill, and its full-depth
counts take about 460 s and 260 s of one CPU core.  hubert-xlarge's
prefill is held at 2 of its 48 layers too (about 35 s at full depth).
Every layer is the same, so each count, and each named difference, is
linear in the depth (hubert's frontend projection sits before the
layers); the full-depth counts are in ``PERF.md``'s table.  Each test leaves no
process group behind.
"""
import pytest
import torch.distributed as dist

import _torch_full_width as fw

CASES = ([("rwkv6-1.6b", s) for s in ("decode_32k", "prefill_32k", "train_4k")]
         + [("hubert-xlarge", "prefill_32k")])
DEPTH = {**{f"rwkv6-1.6b/{s}": {"n_layers": 2} for s in ("prefill_32k", "train_4k")},
         "hubert-xlarge/prefill_32k": {"n_layers": 2}}
DEADLINE_S = 300                # the port's four counts (about 80 s on one CPU core)


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


@pytest.fixture(scope="module")
def records():
    return fw.records(CASES, overrides=DEPTH, deadline_s=DEADLINE_S)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch,shape", CASES)
def test_full_width_dot_flops_match_jaxs_but_the_named_products(records, arch, shape):
    fw.check(records, arch, shape, overrides=DEPTH)
