"""repro_torch.dist — trial placement and sharding (DESIGN.md §2–§3).

Two layers:

* :mod:`repro_torch.dist.submesh` — the port's copy of
  ``repro.dist.submesh``: the ``SlicePool`` that carves the device list into
  contiguous per-trial slices.  In device mode a slice's devices are ranks of
  the default ``torch.distributed`` process group, and
  ``MeshSlice.make_mesh`` builds a ``DeviceMesh`` over them.
* :mod:`repro_torch.dist.sharding` — the rule-based PartitionSpec engine of
  ``repro.dist.sharding`` on DTensor: maps parameters, optimizer moments,
  batches and caches onto a mesh via named rule templates with head-aware
  and divisibility fallbacks, resolved on JAX's layout; places a train
  state and a batch by them; runs the attention kernel on local shards.
"""
from . import sharding, submesh
from .sharding import (activation_policy, batch_specs, cache_specs, constrain,
                       make_shardings, param_specs, shard_batch, shard_train_state,
                       sharding_strategy, spec_for, train_state_specs)
from .submesh import MeshSlice, SlicePool

__all__ = [
    "sharding", "submesh", "SlicePool", "MeshSlice",
    "spec_for", "param_specs", "train_state_specs", "batch_specs",
    "cache_specs", "make_shardings", "constrain", "sharding_strategy",
    "activation_policy", "shard_train_state", "shard_batch",
]
