"""Production mesh builders and the hardware constants of the roofline.

Counterpart of ``repro.launch.mesh``.  Functions (not module constants), so
that importing touches no device and no process group.  Target: the NVIDIA
H100 SXM; the meshes keep JAX's shapes and axis names, single-pod (16, 16) =
(data, model) and multi-pod (2, 16, 16) = (pod, data, model), so that a
record made on either package lines up with the other's.  A mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, one device a rank, built by ``dist/submesh.py``'s device mode.
"""
from __future__ import annotations

import math
from typing import Tuple

__all__ = ["make_production_mesh", "make_mesh", "HW"]


class HW:
    """NVIDIA H100 SXM hardware constants used by the roofline analysis."""
    PEAK_FLOPS_BF16 = 989e12       # per card, dense
    HBM_BW = 3.35e12               # bytes/s per card (HBM3)
    ICI_BW = 450e9                 # bytes/s per card, NVLink, one direction
    # torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100
    # 80GB HBM3 with a 700.00 W power limit
    HBM_BYTES = 85_017_493_504
    CHIPS_PER_POD = 256            # the devices of the single-pod production mesh


def _make(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group; raises when no group is initialised or its
    world size is not the mesh's."""
    import torch
    import torch.distributed as dist

    from ..dist.submesh import SlicePool

    if not dist.is_initialized():
        raise RuntimeError("a mesh's devices are ranks of the default process group: "
                           "init_process_group first")
    world, size = dist.get_world_size(), math.prod(shape)
    if world != size:
        raise RuntimeError(f"a {shape} mesh needs {size} ranks; the process group has {world}")
    device = torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")
    return SlicePool(devices=[device] * world).acquire(world).make_mesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """Arbitrary mesh over the process group's ranks (e.g. trial sub-meshes)."""
    return _make(tuple(shape), tuple(axes))
