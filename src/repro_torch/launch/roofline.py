"""Roofline terms of one step, counted while it runs on the meta device.

  compute term    = dot_FLOPs / (chips x peak_FLOP/s)
  memory term     = traffic_bytes / (chips x HBM_bw)
  collective term = collective_bytes / (chips x link_bw)

Counterpart of ``repro.launch.roofline``, with the port's ``HW`` (the H100
SXM's).  JAX counts a step by walking its compiled HLO; the port has no
compiled program, so ``step_costs`` runs the step once under a
``TorchDispatchMode`` and counts every aten op it dispatches.  On tensors of
the meta device the step allocates nothing and launches nothing, so a
full-width step is counted on a host without a card:

  - dot FLOPs: every op of the matmul family (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, which ``matmul``, ``linear`` and ``einsum`` dispatch to),
    2 * prod(result dims) * prod(contracting dims): what XLA lowers to
    ``dot``.  Convolutions are not counted, as JAX's walker counts none.
    A Python loop over layers counts each layer, as the walker weights a
    scanned body by its trip count, and autograd's backward counts what
    XLA's transposed dots count.
  - traffic bytes: every tensor argument of the step once (JAX's entry
    parameters), plus the result bytes of every op that writes memory.  An
    output that is a view or an alias of an input counts nothing (a schema
    that says so, ``view``, ``expand``, ``detach``, ``as_strided``, ...,
    or a storage that is an input's, as ``_unsafe_view``'s and
    ``wait_tensor``'s are); an in-place op counts the tensor it writes.
    This is the eager counterpart of "result buffers of top-level ops
    after fusion": nothing is fused, so every op is top-level.
  - collective bytes: the result bytes of the ``_c10d_functional``
    collectives that DTensor issues, under JAX's kind names
    (``coll:all-gather``, ...); like the walker's, they count as no
    traffic.

``step_costs`` also gives the three sizes JAX reads from
``compiled.memory_analysis()``: ``arg_bytes`` (the arguments),
``output_bytes`` (the result's tensors) and ``temp_bytes`` (the peak of the
live bytes of the storages the step makes, followed through weak
references).

Which path is counted.  JAX's walker counts nothing inside a Pallas kernel
(``custom-call`` is a control op there), so the count both packages agree
on is that of the same function without kernels: a caller counts the
config with ``attn_impl="pallas"`` made ``"auto"`` and ``kernel_impl="jnp"``
(``kernel_free``), which never reaches ``kernels/ops.py``.  The card's
kernels compute the same function, so the count is the function's work, not
the kernel's.

A step on DTensors is counted for one rank, as JAX's walker counts the
SPMD-partitioned program of one device.  The mode returns
``NotImplemented`` for an op with a DTensor among its arguments, so that
DTensor's own handler runs the op, and the mode then sees what the rank
runs: the local op on its shards and the collectives of a redistribution.
On a miss of its sharding-propagation cache DTensor also runs the op once
on global-shape fake tensors, to learn the output's shape, and computes
shard sizes with small tensor ops of its own; that planning is no work of
the rank's and is counted nothing: DTensor runs it under a
``FakeTensorMode``, and the mode skips every op it sees while one is
active.  That one test suffices on torch 2.11 and 2.13: a mark set inside
DTensor's propagation and redistribution-planning functions missed some
planning ops on both, and a test for fake tensors among the arguments
added nothing.  So the count does not depend on the cache's state: a step
counted twice in one process, or once in a fresh one, gives the same
numbers (``tests/test_torch_dryrun.py``).  ``arg_bytes`` and
``output_bytes`` take a DTensor's local shard.  A step without DTensors
is counted as before, op by op.  Re-routing was chosen over reading the
local shapes off the DTensor arguments because DTensor alone knows which
redistribution and which local op it runs.

``normalize_cost_analysis`` has no counterpart: it evens out what XLA's
``compiled.cost_analysis()`` returns across jax versions, and the port has
no compiler and so no cost analysis.  ``RooflineReport.ca_flops_raw`` and
``ca_bytes_raw`` are 0.  MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference)
uses active params for MoE.
"""
from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .mesh import HW

__all__ = ["RooflineReport", "analyze", "kernel_free", "model_flops", "step_costs"]

# the matmul family: the position of the operand whose last dim is contracted
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def kernel_free(cfg):
    """``cfg`` with the hand-written kernels turned off: the path whose
    costs ``step_costs`` counts (see the module docstring)."""
    attn = "auto" if cfg.attn_impl == "pallas" else cfg.attn_impl
    return dataclasses.replace(cfg, attn_impl=attn, kernel_impl="jnp")


def _tensors(tree):
    """The distinct tensors of a nest of tuples, lists, dicts and modules
    (a module's parameters and buffers), each once."""
    out: Dict[int, torch.Tensor] = {}
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.nn.Module):
            for t in list(leaf.parameters()) + list(leaf.buffers()):
                out.setdefault(id(t), t)
        elif isinstance(leaf, torch.Tensor):
            out.setdefault(id(leaf), leaf)
    return list(out.values())


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes; a DTensor's, those of this rank's shard."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _planning() -> bool:
    """Whether DTensor's planning runs this op (the module docstring)."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class _CostMode(TorchDispatchMode):
    """Counts, op by op, what ``step_costs`` returns."""

    def __init__(self):
        super().__init__()
        self.costs: Dict[str, float] = {"dot_flops": 0.0, "traffic_bytes": 0.0,
                                        "collective_bytes": 0.0}
        self.live = self.peak = 0
        self._made = weakref.WeakSet()     # the storages the step has made

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def _add(self, key: str, value: float) -> None:
        self.costs[key] = self.costs.get(key, 0.0) + value

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(x, DTensor) for x in flat):
            return NotImplemented              # DTensor runs it; the local ops come back here
        if _planning():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._opname
        if func.namespace == "aten" and name in _DOTS:
            a = args[_DOTS[name]]
            self._add("dot_flops", 2.0 * out.numel() * a.shape[-1])
        kind = _COLLECTIVES.get(name) if func.namespace == "_c10d_functional" else None
        inputs = [x.untyped_storage() for x in flat if isinstance(x, torch.Tensor)]
        returns = func._schema.returns
        for i, o in enumerate(tree_flatten(out)[0]):
            if not isinstance(o, torch.Tensor):
                continue
            alias = returns[i].alias_info if i < len(returns) else None
            if alias is not None:              # a view, or an in-place op's target
                if alias.is_write:
                    self._add("traffic_bytes", _nbytes(o))
                continue
            storage = o.untyped_storage()
            if any(storage is s for s in inputs):   # an alias the schema leaves unsaid
                continue
            if kind is not None:
                self._add("collective_bytes", _nbytes(o))
                self._add(f"coll:{kind}", _nbytes(o))
            else:
                self._add("traffic_bytes", _nbytes(o))
            if storage not in self._made:
                self._made.add(storage)
                nbytes = storage.nbytes()
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                weakref.finalize(storage, self._freed, nbytes).atexit = False
        return out


def step_costs(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once and count its costs (the module
    docstring has the rules): ``dot_flops``, ``traffic_bytes``,
    ``collective_bytes`` and ``coll:<kind>``, as ``repro``'s ``hlo_costs``
    returns them, and ``arg_bytes``, ``temp_bytes`` and ``output_bytes``.
    Pass tensors on the meta device to count without a card."""
    arg_bytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
    mode = _CostMode()
    with mode:
        out = fn(*args, **kwargs)
    costs = dict(mode.costs)
    costs["traffic_bytes"] += arg_bytes
    costs["arg_bytes"] = float(arg_bytes)
    costs["temp_bytes"] = float(mode.peak)
    costs["output_bytes"] = float(sum(_nbytes(t) for t in _tensors(out)))
    return costs


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6·N·D for a train step (fwd+bwd); 2·N·D for inference-only steps."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device, from the counted step
    device_flops: float          # dot flops
    device_bytes: float          # traffic proxy
    collective_bytes: float
    collectives_by_kind: Dict[str, int]
    # XLA's raw cost_analysis in JAX; 0 here (no compiler)
    ca_flops_raw: float
    ca_bytes_raw: float
    # memory (per device)
    arg_bytes: int
    temp_bytes: int
    output_bytes: int
    # model-level
    model_flops_total: float
    n_tokens: int

    @property
    def compute_s(self) -> float:
        return self.device_flops / HW.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.device_bytes / HW.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / HW.ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global dot flops — catches remat/redundancy waste."""
        total_hlo = self.device_flops * self.chips
        return self.model_flops_total / total_hlo if total_hlo else 0.0

    @property
    def hbm_per_device_gib(self) -> float:
        return (self.arg_bytes + self.temp_bytes) / 2**30

    @property
    def step_time_s(self) -> float:
        """No-overlap roofline estimate: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "device_flops": self.device_flops,
            "device_bytes": self.device_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives_by_kind": self.collectives_by_kind,
            "ca_flops_raw": self.ca_flops_raw, "ca_bytes_raw": self.ca_bytes_raw,
            "arg_bytes": self.arg_bytes, "temp_bytes": self.temp_bytes,
            "output_bytes": self.output_bytes,
            "model_flops_total": self.model_flops_total,
            "n_tokens": self.n_tokens,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "hbm_per_device_gib": self.hbm_per_device_gib,
            "step_time_s": self.step_time_s,
        }


def analyze(
    arch: str, shape_name: str, mesh_name: str, chips: int,
    costs: Dict[str, float], n_params_active: int, n_tokens: int, kind: str,
    arg_bytes: int = 0, temp_bytes: int = 0, output_bytes: int = 0,
) -> RooflineReport:
    """The report of a step from ``step_costs``' dict."""
    by_kind = {k.split(":", 1)[1]: int(v) for k, v in costs.items()
               if k.startswith("coll:")}
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        device_flops=float(costs.get("dot_flops", 0.0)),
        device_bytes=float(costs.get("traffic_bytes", 0.0)),
        collective_bytes=float(costs.get("collective_bytes", 0.0)),
        collectives_by_kind=by_kind,
        ca_flops_raw=0.0, ca_bytes_raw=0.0,
        arg_bytes=int(arg_bytes), temp_bytes=int(temp_bytes),
        output_bytes=int(output_bytes),
        model_flops_total=model_flops(n_params_active, n_tokens, kind),
        n_tokens=n_tokens,
    )
