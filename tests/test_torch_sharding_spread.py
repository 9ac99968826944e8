"""``dist.sharding.spread_linear`` and ``split_like`` on rank 0 of a fake
(2, 4) process group with meta tensors (what the dry-run counts): a
product whose weight is whole on ``model`` is split over it by its rows
where they divide, else by the weight's output features, else by its
fan-in, and comes back placed as the rows were, whole on ``model``; each
way rank 0 computes 1/8 of the product (``launch.roofline.step_costs``).
The full-width records that these splits make equal to JAX's are held by
``test_torch_dryrun_full_width*.py``.
"""
import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import step_costs

R = Replicate()


@pytest.fixture
def mesh():
    with fake_group(8):
        yield make_mesh((2, 4), ("data", "model"))
    assert not dist.is_initialized()


def placed(mesh, shape, placements):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh, list(placements))


# case -> (x's shape, w's shape, whether a bias, w's placements, the split rank 0 computes)
CASES = {
    "rows": ((8, 16, 64), (48, 64), False, (R, R), "rows"),
    "features (decode)": ((2, 1, 64), (48, 64), True, (R, R), "features"),
    "fan-in (a vocab that does not divide)": ((2, 1, 64), (50, 64), False, (R, R), "fan-in"),
    "nothing divides": ((2, 1, 62), (50, 62), False, (R, R), None),
    "weight split over model": ((2, 1, 64), (48, 64), False, (R, Shard(0)), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spread_linear_splits_a_product_whole_on_model(mesh, case):
    xs, ws, bias, wp, split = CASES[case]
    x = placed(mesh, xs, (Shard(0), R))
    w = placed(mesh, ws, wp)
    b = placed(mesh, (ws[0],), (R, R)) if bias else None
    y = shd.spread_linear(x, w, b)
    assert tuple(y.shape) == (*xs[:-1], ws[0])
    flops = step_costs(lambda: shd.spread_linear(x, w, b))["dot_flops"]
    whole = 2 * xs[0] * xs[1] * ws[0] * ws[1]
    if split is None:
        # as DTensor runs the product: rows over data, features where w splits them
        assert flops == whole // 2 // (4 if wp[1] == Shard(0) else 1)
    else:
        assert flops == whole // 8
        assert tuple(y.placements) == (Shard(0), R)


def test_spread_linear_on_plain_tensors_is_linear():
    x, w, b = torch.randn(2, 3, 8), torch.randn(5, 8), torch.randn(5)
    torch.testing.assert_close(shd.spread_linear(x, w, b), F.linear(x, w, b), rtol=0, atol=0)
    torch.testing.assert_close(shd.spread_linear(x, w), x @ w.T, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["follows x's split", "x not split", "w already split"])
def test_split_like_splits_the_weight_where_x_splits_the_dim(mesh, case):
    """w_down (E, F, D) after an expert buffer (E, G, C, D) whose d_model
    is split over ``data``: w_down's D splits there too, a local slice."""
    xp, wp, expect = {
        "follows x's split": ((Shard(3), Shard(0)), (R, Shard(0)), (Shard(2), Shard(0))),
        "x not split": ((R, Shard(0)), (R, Shard(0)), (R, Shard(0))),
        "w already split": ((Shard(3), Shard(0)), (Shard(1), Shard(0)), (Shard(1), Shard(0))),
    }[case]
    x = placed(mesh, (4, 1, 6, 16), xp)
    w = placed(mesh, (4, 8, 16), wp)
    assert tuple(shd.split_like(w, x, {3: 2}).placements) == expect


def test_split_like_on_plain_tensors_is_the_weight():
    w = torch.randn(4, 8, 16)
    assert shd.split_like(w, torch.randn(4, 1, 6, 16), {3: 2}) is w
