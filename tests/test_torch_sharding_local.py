"""``dist.sharding.local_einsum`` and ``local_moe_scatter`` place their
inputs, outputs and gradients as their docstrings say, on rank 0 of a fake
(2, 4) process group with meta tensors (what the dry-run counts): the local
shapes each rank computes on, the output's placements (partial where a
split label is summed over, or where a rank holds only its experts), and
the cases where no mesh dim splits anything.  The values are held on 8
gloo ranks by ``test_torch_multidevice_moe_scatter.py`` and the dry-run's
counts by ``test_torch_dryrun.py``.
"""
import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

from repro_torch.dist import sharding as shd
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_mesh

R, P0 = Replicate(), Partial()


@pytest.fixture
def mesh():
    with fake_group(8):
        yield make_mesh((2, 4), ("data", "model"))
    assert not dist.is_initialized()


def placed(mesh, shape, placements, grad=False):
    t = distribute_tensor(torch.empty(shape, device="meta"), mesh, list(placements))
    return t.requires_grad_(grad)


@pytest.mark.parametrize("case", ["decode combine", "train combine", "nothing split"])
def test_local_einsum_splits_each_mesh_dims_label(mesh, case):
    """The combine einsum ``gsac,agcd->gsd``: in decode the slots are split
    over ``data`` and the experts over ``model``, both summed: the output is
    partial on both; in training the groups over ``data`` stay split in the
    output; with nothing split the output is replicated."""
    shapes, placements, expect, local = {
        "decode combine": ([(1, 32, 4, 40), (4, 1, 40, 64)],
                           [(Shard(3), Shard(2)), (Shard(2), Shard(0))], (P0, P0),
                           [(1, 32, 1, 20), (1, 1, 20, 64)]),
        "train combine": ([(16, 32, 4, 40), (4, 16, 40, 64)],
                          [(Shard(0), Shard(2)), (Replicate(), Replicate())], (Shard(0), P0),
                          [(8, 32, 1, 40), (1, 8, 40, 64)]),
        "nothing split": ([(1, 32, 4, 40), (4, 1, 40, 64)], [(R, R), (R, R)], (R, R),
                          [(1, 32, 4, 40), (4, 1, 40, 64)]),
    }[case]
    a, b = (placed(mesh, s, p) for s, p in zip(shapes, placements))
    out = shd.local_einsum("gsac,agcd->gsd", a, b)
    assert tuple(out.shape) == (shapes[0][0], 32, 64)
    assert tuple(out.placements) == tuple(Partial() if p is P0 else p for p in expect)
    assert [tuple(t.shape) for t in (a, b)] == shapes
    assert tuple(out.to_local().shape) == (local[0][0], 32, 64)


def test_local_einsum_gradient_of_an_operand_without_the_label_is_partial(mesh):
    """``_ddlerp``'s ``bsnr,nrd->nbsd``: ``d`` split over ``model`` in the
    weight only, so the lora's gradient on a ``model`` rank sums its share
    of ``d`` and comes back partial there, then summed: the lora's
    gradient is the input's placements again, the weight's its own."""
    lora = placed(mesh, (8, 16, 5, 32), (Shard(0), R), grad=True)
    w = placed(mesh, (5, 32, 256), (R, Shard(2)), grad=True)
    out = shd.local_einsum("bsnr,nrd->nbsd", lora, w)
    assert tuple(out.placements) == (Shard(1), Shard(3))
    assert tuple(out.to_local().shape) == (5, 4, 16, 64)
    out.sum().backward()
    assert tuple(lora.grad.shape) == (8, 16, 5, 32) and tuple(w.grad.shape) == (5, 32, 256)


def test_local_einsum_on_plain_tensors_is_the_einsum():
    a, b = torch.randn(2, 3, 4), torch.randn(4, 5)
    torch.testing.assert_close(shd.local_einsum("bsn,nd->bsd", a, b),
                               torch.einsum("bsn,nd->bsd", a, b), rtol=0, atol=0)


def dispatch_calls(calls):
    def fn(xg, top_w, top_idx, w_gate, w_up, w_down, first):
        calls.append({"xg": tuple(xg.shape), "w": tuple(w_gate.shape),
                      "first": tuple(first.shape) if isinstance(first, torch.Tensor) else first})
        G, S, D = xg.shape
        return xg * 1.0, torch.zeros((G, 40), device=xg.device)
    return fn


@pytest.mark.parametrize("case", ["experts split", "experts whole", "one group"])
def test_local_moe_scatter_takes_its_groups_and_experts(mesh, case):
    """Groups (G, S, D) over ``data``.  With the experts over ``model`` (as
    ``_EXPERT_RULES`` places 40 of them on 4 ranks, their ``fsdp`` dim
    gathered) a rank takes its data rank's groups and its 10 experts, and
    its output is partial over ``model``; with 5 experts, which 4 ranks do
    not divide, the groups split over ``model`` too and the output is split
    as they are; one group (decode) splits nowhere."""
    G, E = {"experts split": (16, 40), "experts whole": (16, 5), "one group": (1, 40)}[case]
    xg = placed(mesh, (G, 32, 64), (Shard(0) if G > 1 else R, R))
    top_w = placed(mesh, (G, 32, 8), (Shard(0) if G > 1 else R, R))
    top_idx = distribute_tensor(torch.empty((G, 32, 8), dtype=torch.int64, device="meta"), mesh,
                                [Shard(0) if G > 1 else R, R])
    expert = Shard(0) if E % 4 == 0 else R
    w_gate, w_up = (placed(mesh, (E, 64, 16), (Shard(1), expert)) for _ in range(2))
    w_down = placed(mesh, (E, 16, 64), (Shard(2), expert))
    calls = []
    y, counts = shd.local_moe_scatter(dispatch_calls(calls), xg, top_w, top_idx,
                                      w_gate, w_up, w_down)
    (call,) = calls
    want = {"experts split": ((8, 32, 64), (10, 64, 16), (Shard(0), Partial())),
            "experts whole": ((2, 32, 64), (5, 64, 16), (Shard(0), Shard(0))),
            "one group": ((1, 32, 64), (10, 64, 16), (R, Partial()))}[case]
    assert (call["xg"], call["w"], call["first"]) == (want[0], want[1], (1,))
    assert tuple(y.placements) == want[2]
    assert tuple(counts.placements) == tuple(R if isinstance(p, Partial) else p
                                             for p in want[2])
    assert tuple(y.shape) == (G, 32, 64) and tuple(counts.shape) == (G, 40)


def test_local_moe_scatter_on_plain_tensors_starts_at_expert_0():
    calls = []
    x = torch.zeros(2, 4, 8)
    w = torch.zeros(3, 8, 5)
    shd.local_moe_scatter(dispatch_calls(calls), x, x, x.long(), w, w, w.transpose(1, 2))
    assert calls == [{"xg": (2, 4, 8), "w": (3, 8, 5), "first": 0}]
