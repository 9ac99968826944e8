"""Rule-based PartitionSpec engine (DESIGN.md §3), on DTensor.

Counterpart of ``repro.dist.sharding``.  The rule tables, the role
resolution, the template search and the divisibility drop are the
original's, copied: ``spec_for(path, shape, mesh)`` looks the leaf name up
in a table of named rule templates and resolves abstract roles onto
concrete mesh axes.

Roles (resolved per active strategy, see ``sharding_strategy``):

* ``"fsdp"``  — shard over the data axes (all mesh axes except ``model``),
  expressed as an axis *tuple* so multi-pod meshes map to ``("pod","data")``.
* ``"tp"``    — shard over the ``model`` axis (tensor parallelism).
* ``"expert"``— shard over the ``model`` axis (expert parallelism; MoE layers
  trade TP for EP, so both roles target the same axis).
* ``None``    — replicate this dim.

A rule template names roles for the *trailing* dims of a leaf; leading dims
replicate.  Each leaf carries an ordered list of templates; the first whose
every sharded dim is divisible by its axes' total size wins.  If none fits,
the first template is taken and the failing dims are dropped to ``None``
individually (the divisibility drop): sharding degrades per dim, it never
errors and never produces an uneven shard.  Head-aware attention rules
refuse to tensor-shard q/k/v/o projections when ``n_heads`` /
``n_kv_heads`` do not divide the model-axis size.

Strategies: ``fsdp_tp`` (default; FSDP over data axes + TP over model) and
``dp_only`` (model axis unused; the batch may then also shard over the idle
model axis).

What differs from the original:

* A spec is this module's ``P``, a tuple of entries (``None``, an axis name
  or a tuple of names; a one-name tuple reads as the name, as JAX's
  ``PartitionSpec`` reads it).  A mesh is read by ``axis_names``/``shape``
  or, for a ``DeviceMesh``, by ``mesh_dim_names``/``shape``.
* The rules resolve on JAX's layout.  ``param_specs`` takes an ``LM`` and
  resolves each parameter on the JAX leaf it holds
  (``models.convert.jax_layout``): the leaf's path and shape there, with a
  segment's repeat axis in front; then drops the repeat axis (the port has
  one module per repeat, so a layer axis cannot be sharded) and reverses an
  ``nn.Linear`` weight's entries (the port holds it (out, in)).
* ``make_shardings`` gives each spec as DTensor placements, one per mesh
  dim; ``shard_train_state`` and ``shard_batch`` distribute a train state
  and a batch by them (the original's ``jax.jit(..., in_shardings=...)``).
* ``constrain`` redistributes a DTensor activation, sums its partial sums
  and pins its gradient to the same placements; under an active policy a
  plain tensor raises, so that nothing runs unsharded unseen.
* ``local_shards`` runs attention, the kernel's wrapper or the plain
  version, on each rank's shards (``local_map``), which XLA's partitioner
  does for a Pallas call and for a batch- and head-local product;
  ``local_rwkv6_scan``, ``local_rglru_scan`` and ``local_moe_router`` do
  the same for the scans' and the router's wrappers (and their plain
  versions), ``local_moe_scatter`` for the sort/scatter MoE dispatch and
  ``local_einsum`` for an einsum that DTensor refuses.
* DTensor chooses each op's placements by the cost of communication, not
  of compute, and leaves sums partial; XLA's partitioner splits the work.
  Under an active policy the model asks for XLA's choices: ``gathered``
  (FSDP weights gathered for their use), ``constrain`` at residual adds
  and norms, ``spread_over_idle``/``spread_product``/``spread_linear`` (a
  product over the axes nothing else splits), ``split_like`` (a weight
  split as the activation it multiplies), ``lookup`` (the embedding on each rank's
  ids), ``policy_caches``, ``microbatch``.  On plain tensors, or without
  a policy, each leaves the unsharded path as it was.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

__all__ = [
    "P", "spec_for", "param_specs", "train_state_specs", "batch_specs",
    "cache_specs", "make_shardings", "constrain", "sharding_strategy",
    "activation_policy", "STRATEGIES", "shard_train_state", "shard_batch",
    "shard_params", "shard_caches", "policy_caches", "microbatch",
    "pin_grad", "gathered", "spread_over_idle", "spread_product", "spread_linear",
    "split_like", "lookup", "local_shards", "local_rwkv6_scan", "local_rglru_scan",
    "local_moe_router", "local_moe_scatter", "local_einsum", "replicated_like", "whole_on",
    "placed_like", "full_value",
]

STRATEGIES = ("fsdp_tp", "dp_only")

_MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    an axis name, or a tuple of axis names (major to minor)."""

    def __new__(cls, *entries):
        norm = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries]
        return super().__new__(cls, norm)


# -- strategy / activation-policy context ------------------------------------------

_state = {"strategy": "fsdp_tp", "act_mesh": None, "seq_parallel": False}


@contextlib.contextmanager
def sharding_strategy(name: str):
    """Select the active strategy for every spec_* call in the block."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown sharding strategy {name!r}; "
                         f"choose from {STRATEGIES}")
    prev = _state["strategy"]
    _state["strategy"] = name
    try:
        yield
    finally:
        _state["strategy"] = prev


@contextlib.contextmanager
def activation_policy(mesh, seq_parallel: bool = False):
    """Enable ``constrain`` inside model code: activations computed in the
    block are redistributed to batch (and optionally sequence) sharding on
    ``mesh``."""
    prev = (_state["act_mesh"], _state["seq_parallel"])
    _state["act_mesh"] = mesh
    _state["seq_parallel"] = bool(seq_parallel)
    try:
        yield
    finally:
        _state["act_mesh"], _state["seq_parallel"] = prev


# -- mesh helpers -------------------------------------------------------------------

def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_sizes(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(_axis_names(mesh), shape))


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a != _MODEL_AXIS)


def _model_size(mesh) -> int:
    return _axis_sizes(mesh).get(_MODEL_AXIS, 1)


def _resolve_role(role: Optional[str], mesh):
    """Map an abstract role to a PartitionSpec entry under the active strategy."""
    strategy = _state["strategy"]
    if role is None:
        return None
    if role == "fsdp":
        axes = _data_axes(mesh)
        return axes if axes else None
    if role in ("tp", "expert"):
        if strategy == "dp_only" or _MODEL_AXIS not in _axis_names(mesh):
            return None
        return _MODEL_AXIS
    raise ValueError(f"unknown sharding role {role!r}")


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _entry_size(entry, sizes: Dict[str, int]) -> int:
    return math.prod(sizes.get(a, 1) for a in _entry_axes(entry))


# -- rule tables --------------------------------------------------------------------

# name -> ordered fallback templates (roles for trailing dims).  No template
# replicates everything: when none fits, the divisibility-drop fallback takes
# the FIRST template and nulls failing dims individually, which preserves any
# dim that still divides (e.g. TP survives an odd fan-out).
_RULES: Dict[str, List[Tuple[Optional[str], ...]]] = {
    # embeddings: vocab over model first, fall back to feature-only FSDP
    "tok": [("tp", "fsdp"), (None, "fsdp")],
    # untied LM head (d_model, vocab)
    "w": [("fsdp", "tp"), ("fsdp", None)],
    # gated MLP
    "w_gate": [("fsdp", "tp"), ("fsdp", None)],
    "w_up": [("fsdp", "tp"), ("fsdp", None)],
    "w_down": [("tp", "fsdp"), (None, "fsdp")],
    # plain MLP
    "w_in": [("fsdp", "tp"), ("fsdp", None)],
    "w_out": [("tp", "fsdp"), (None, "fsdp")],
    # MoE router (d_model, n_experts)
    "router": [("fsdp", None)],
    # frontend projections
    "proj": [("fsdp", "tp"), ("fsdp", None)],
}

# expert-parallel overrides when "experts" appears on the path:
# (n_experts, d_model, d_expert) for w_gate/w_up, (n_experts, d_expert, d_model)
# for w_down — experts over the model axis, fan-in FSDP over data.
_EXPERT_RULES: Dict[str, List[Tuple[Optional[str], ...]]] = {
    "w_gate": [("expert", "fsdp", None), (None, "fsdp", None)],
    "w_up": [("expert", "fsdp", None), (None, "fsdp", None)],
    "w_down": [("expert", None, "fsdp"), (None, None, "fsdp")],
}

_ATTN_NAMES = ("wq", "wk", "wv", "wo")


def _head_aware_rules(name: str, path_keys: Sequence[str], cfg,
                      mesh) -> List[Tuple[Optional[str], ...]]:
    """Templates for attention projections, refusing TP when heads don't
    divide the model axis (splitting inside a head breaks GQA grouping)."""
    msize = _model_size(mesh)
    if name in ("wq", "wo"):
        heads = cfg.n_heads
    else:  # wk / wv
        heads = cfg.n_kv_heads or cfg.n_heads
    splittable = msize <= 1 or heads % msize == 0
    if name == "wo":  # (n_heads*hd, d_model): heads on the fan-in dim
        return [("tp", "fsdp")] if splittable else [(None, "fsdp")]
    return [("fsdp", "tp")] if splittable else [("fsdp", None)]


def _path_keys(path: Sequence[Any]) -> List[str]:
    keys = []
    for k in path:
        if hasattr(k, "key"):
            keys.append(str(k.key))
        elif hasattr(k, "name"):
            keys.append(str(k.name))
        elif hasattr(k, "idx"):
            keys.append(str(k.idx))
        else:
            keys.append(str(k))
    return keys


def _rules_for(keys: List[str], shape: Tuple[int, ...], cfg,
               mesh) -> List[Tuple[Optional[str], ...]]:
    name = keys[-1] if keys else ""
    if len(shape) <= 1:  # scalars, norm scales, biases: replicate
        return [()]
    if "experts" in keys and name in _EXPERT_RULES:
        return _EXPERT_RULES[name]
    if name in _ATTN_NAMES and cfg is not None:
        return _head_aware_rules(name, keys, cfg, mesh)
    if name in _ATTN_NAMES:  # no cfg: assume divisible
        return [("tp", "fsdp")] if name == "wo" else [("fsdp", "tp")]
    if name in _RULES:
        return _RULES[name]
    # unknown >=2-dim leaf (recurrent-block params etc.): generic matmul rule
    return [("fsdp", "tp"), ("fsdp", None)]


def spec_for(path: Sequence[Any], shape: Tuple[int, ...], mesh,
             cfg=None) -> P:
    """PartitionSpec for one leaf of JAX's layout, by path-based rule
    lookup + divisibility fallback.  ``path`` is the leaf's keys (strings,
    or anything with .key/.name/.idx)."""
    keys = _path_keys(path)
    shape = tuple(shape)
    if not shape:
        return P()
    sizes = _axis_sizes(mesh)
    templates = _rules_for(keys, shape, cfg, mesh)

    def resolve(rule):
        """Roles for trailing dims -> full per-dim entries, or None if a
        sharded dim is not divisible."""
        entries: List[Any] = [None] * (len(shape) - len(rule))
        entries += [_resolve_role(r, mesh) for r in rule]
        for dim, entry in enumerate(entries):
            if entry is not None and shape[dim] % _entry_size(entry, sizes):
                return None
        return entries

    chosen = None
    for rule in templates:
        if len(rule) > len(shape):
            continue
        resolved = resolve(rule)
        if resolved is not None:
            chosen = resolved
            break
    if chosen is None:
        # divisibility-drop: take the first template that fits the leaf's
        # rank, null out failing dims individually
        rule = next((r for r in templates if len(r) <= len(shape)), ())
        entries = [None] * (len(shape) - len(rule))
        entries += [_resolve_role(r, mesh) for r in rule]
        chosen = [e if (e is None or shape[d] % _entry_size(e, sizes) == 0)
                  else None for d, e in enumerate(entries)]
    return P(*chosen)


# -- tree-level spec builders -------------------------------------------------------

def _tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` on every leaf of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, mesh, cfg=None) -> Dict[str, P]:
    """{parameter name: spec} of an ``LM``: each parameter's spec is its JAX
    leaf's, with the repeat axis dropped and an ``nn.Linear`` weight's
    entries reversed."""
    from ..models.convert import jax_layout
    specs = {}
    for name, (path, shape, stacked, transposed) in jax_layout(params).items():
        spec = tuple(spec_for(path, shape, mesh, cfg))
        spec = spec[1:] if stacked else spec
        specs[name] = P(*(spec[::-1] if transposed else spec))
    return specs


def train_state_specs(state, mesh, cfg=None):
    """Specs of a ``TrainState``: the parameters', the optimizer moments'
    (each dict of moments keyed by parameter name takes its parameters'
    specs, as the original's moments mirror the parameter tree and resolve
    by the same leaf names) and the counters' (replicated)."""
    from ..train import TrainState
    pspecs = param_specs(state.params, mesh, cfg)

    def moments(tree):
        if isinstance(tree, dict) and tree and set(tree) == set(pspecs):
            return {k: pspecs[k] for k in tree}
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        return P(*([None] * len(getattr(tree, "shape", ()))))

    return TrainState(params=pspecs, opt_state=moments(state.opt_state), step=P())


def _batch_axis_candidates(mesh) -> List[Tuple[str, ...]]:
    """Ordered axis tuples to try for the batch dim: the full data-parallel
    tuple first, then right-trimmed prefixes (the "prefix fallback")."""
    axes = [a for a in _data_axes(mesh) if _axis_sizes(mesh).get(a, 1) > 1]
    if _state["strategy"] == "dp_only" and _model_size(mesh) > 1:
        axes = axes + [_MODEL_AXIS]  # model axis is idle: use it for DP
    cands = []
    while axes:
        cands.append(tuple(axes))
        axes = axes[:-1]
    cands.append(())
    return cands


def _batch_dim_entry(n: int, mesh):
    sizes = _axis_sizes(mesh)
    for cand in _batch_axis_candidates(mesh):
        if not cand:
            return None
        if n % math.prod(sizes.get(a, 1) for a in cand) == 0:
            return cand
    return None


def batch_specs(batch: Any, mesh) -> Any:
    """Shard dim 0 (the global batch) over the data axes; replicate the rest.
    Axes of size 1 are omitted (no sharding benefit on a trivial mesh)."""

    def one(_, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return P()
        return P(_batch_dim_entry(shape[0], mesh), *([None] * (len(shape) - 1)))

    return _tree_map(one, batch)


def cache_specs(caches: Any, mesh, global_batch: int) -> Any:
    """Decode-cache specs: shard the batch dim over the data axes.

    Cache leaves are segment-stacked, so the batch dim (when a leaf has one)
    is always dim 1: (n_layers, B, cap, K, hd) for k/v, (n_layers, B, ...)
    for recurrent states.  ``global_batch`` is required to match as a
    cross-check — layer-stacking means dim sizes alone are ambiguous (a
    position ring (n_layers, cap) could collide).  ``kpos`` rings carry no
    batch dim and replicate by name.
    """

    def one(path, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return P()
        entries: List[Any] = [None] * len(shape)
        name = path[-1] if path else ""
        if name != "kpos" and len(shape) >= 2 and shape[1] == global_batch:
            entries[1] = _batch_dim_entry(shape[1], mesh)
        return P(*entries)

    return _tree_map(one, caches)


def _placements(spec: P, mesh) -> Tuple[Any, ...]:
    """One spec as DTensor placements, one per mesh dim: ``Shard(d)`` on
    every mesh dim that an entry names for tensor dim ``d``.  An entry's
    axes must be in the mesh's order, which is JAX's major-to-minor."""
    names = _axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _entry_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {entry} are not in the mesh's order {names}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"spec {spec} names mesh axis {names[m]} twice")
            out[m] = Shard(d)
    return tuple(out)


def make_shardings(specs: Any, mesh) -> Any:
    """Spec tree -> tree of DTensor placements (a tuple, one per mesh dim)."""
    if isinstance(specs, P):
        return _placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: make_shardings(v, mesh) for k, v in specs.items()}
    if hasattr(specs, "_fields"):   # a NamedTuple (TrainState)
        return type(specs)(*(make_shardings(v, mesh) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(make_shardings(v, mesh) for v in specs)
    raise TypeError(f"not a spec: {specs!r}")


# -- distributing a train state and a batch ----------------------------------------

def _distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor; the engine
    never yields an uneven shard, and this asserts it."""
    sizes = dict(zip(_axis_names(mesh), mesh.shape))
    per_dim: Dict[int, int] = {}
    for name, p in zip(_axis_names(mesh), placements):
        if isinstance(p, Shard):
            per_dim[p.dim] = per_dim.get(p.dim, 1) * sizes[name]
    for d, n in per_dim.items():
        assert t.shape[d] % n == 0, f"uneven shard: dim {d} of {tuple(t.shape)} over {n}"
    return distribute_tensor(t, mesh, placements)


def _shard_modules(params, mesh, placements: Dict[str, Any]):
    """``params``' parameters replaced, in place, by DTensors placed by
    ``placements`` (parameter name -> placements); returns ``params``."""
    from torch import nn
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        dt = _distribute(p.detach(), mesh, placements[name])
        setattr(module, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return params


def shard_params(params, mesh, cfg=None):
    """An ``LM`` with its parameters replaced, in place, by DTensors placed
    by ``param_specs`` (the original's ``in_shardings`` of a serving
    step's parameters); returns it."""
    return _shard_modules(params, mesh, make_shardings(param_specs(params, mesh, cfg), mesh))


def shard_caches(caches: Any, mesh, global_batch: int) -> Any:
    """Decode caches (the same full caches on every rank) as DTensors placed
    by ``cache_specs``, in the caches' nest."""
    shardings = make_shardings(cache_specs(caches, mesh, global_batch), mesh)

    def place(tree, placements):
        if isinstance(tree, dict):
            return {k: place(v, placements[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(place(v, pl) for v, pl in zip(tree, placements))
        return _distribute(tree, mesh, placements)

    return place(caches, shardings)


def policy_caches(caches: Any, global_batch: int) -> Any:
    """Fresh decode caches placed by ``cache_specs`` on the active
    ``activation_policy``'s mesh (``shard_caches``); as they are when no
    policy is active."""
    mesh = _state["act_mesh"]
    return caches if mesh is None else shard_caches(caches, mesh, global_batch)


def shard_train_state(state, mesh, cfg=None):
    """The state with its ``LM``'s parameters replaced, in place, by
    DTensors placed by ``train_state_specs`` (``make_shardings``), and its
    optimizer moments distributed likewise; counters stay Python ints."""
    from ..train import TrainState
    shardings = make_shardings(train_state_specs(state, mesh, cfg), mesh)
    _shard_modules(state.params, mesh, shardings.params)

    def moments(tree, placements):
        if isinstance(tree, dict):
            return {k: moments(v, placements[k]) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return _distribute(tree, mesh, placements)
        return tree

    return TrainState(state.params, moments(state.opt_state, shardings.opt_state), state.step)


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, DTensor]:
    """A batch (the same full batch on every rank) as DTensors placed by
    ``batch_specs``."""
    shardings = make_shardings(batch_specs(batch, mesh), mesh)
    return {k: _distribute(v, mesh, shardings[k]) for k, v in batch.items()}


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor, else ``t``: a constant that model code
    builds beside DTensor activations (positions, a zero to sum into)."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` redistributed to the placements of the DTensor ``p`` of its
    shape: a parameter's gradient (autograd may hand it back partial or
    otherwise placed), so that the optimizer's moments keep the
    parameter's, or an activation placed as the input it came from (a
    partial placement of ``p`` taken as replicated); a plain tensor as it
    is."""
    if not isinstance(p, DTensor):
        return g
    placements = tuple(Replicate() if isinstance(pl, Partial) else pl for pl in p.placements)
    return g if tuple(g.placements) == placements else g.redistribute(p.device_mesh, placements)


@contextlib.contextmanager
def gathered(*modules):
    """Under an active ``activation_policy``, each DTensor parameter of
    ``modules`` (``None`` skipped) stands, inside the block, as its gather
    over the data axes, its ``model`` split kept: XLA's partitioner
    all-gathers an FSDP-sharded weight before its use, so that the batch
    stays split over the data axes and each matmul runs on 1/ranks of the
    work.  A vector (a norm's scale, a mix or decay vector) is gathered
    whole, as XLA gathers it: split over ``model`` it would make DTensor
    split the activation it scales, and the next matmul's fan-in; a linear
    layer's bias is split as its weight's output dim.  Autograd's
    backward reduce-scatters the gradient onto the parameter.  Without a
    policy nothing changes."""
    mesh = _state["act_mesh"]
    swapped = []
    if mesh is not None:
        data = [i for i, a in enumerate(_axis_names(mesh)) if a != _MODEL_AXIS]
        for module in modules:
            for mod in ([] if module is None else module.modules()):
                for name, p in list(mod._parameters.items()):
                    if not isinstance(p, DTensor):
                        continue
                    if isinstance(mod, torch.nn.Linear) and name == "bias":
                        # split as the (gathered) weight's output dim, which follows it
                        placements = tuple(pl if pl == Shard(0) else Replicate()
                                           for pl in mod._parameters["weight"].placements)
                    else:
                        placements = tuple(Replicate() if i in data or p.ndim <= 1 else pl
                                           for i, pl in enumerate(p.placements))
                    placements = _on_split_dims(placements, p)
                    if placements != tuple(p.placements):
                        swapped.append((mod, name, p))
                        mod._parameters[name] = p.redistribute(p.device_mesh, placements)
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def spread_over_idle(x: torch.Tensor, w: Optional[torch.Tensor] = None,
                     dim: int = 1, over: str = _MODEL_AXIS) -> torch.Tensor:
    """``x`` with ``dim`` split over the ``model`` axis (``over="model"``)
    or over the data axes (``over="data"``) where ``x`` is whole on them,
    and so is the weight ``w`` of the product it feeds when one is given:
    XLA's partitioner splits such a product over the idle axes (a
    projection that the head-aware rules keep off ``model``, a router, the
    dispatch of tokens to experts that ``model`` splits, the one group of a
    decode step's tokens that the data axes cannot split).  Where ``dim``
    does not divide, the batch (dim 0) is split further, if it divides.
    Otherwise, and for a plain tensor, ``x`` as it is."""
    if not isinstance(x, DTensor) or (w is not None and not isinstance(w, DTensor)):
        return x
    names, sizes = _axis_names(x.device_mesh), x.device_mesh.shape
    idle = [i for i, a in enumerate(names) if (a == _MODEL_AXIS) == (over == _MODEL_AXIS)
            and sizes[i] > 1 and isinstance(x.placements[i], (Replicate, Partial))
            and (w is None or isinstance(w.placements[i], Replicate))]
    if not idle:
        return x
    for d in (dim, 0):
        split = math.prod(n for n, p in zip(sizes, x.placements) if p == Shard(d))
        if d < x.ndim and x.shape[d] % (split * math.prod(sizes[i] for i in idle)) == 0:
            placements = list(x.placements)
            for i in idle:
                placements[i] = Shard(d)
            return x.redistribute(x.device_mesh, placements)
    return x


def _spread_rows(fn: Callable, x: DTensor, w: Optional[torch.Tensor],
                 overs: Sequence[str]) -> Optional[torch.Tensor]:
    """``spread_product``'s split: ``fn`` of x's rows split further over the
    idle axes of ``overs``, placed back and unflattened; None where no
    axis is idle or nothing divides."""
    rows = x.reshape(-1, x.shape[-1])
    split = rows
    for over in overs:
        split = spread_over_idle(split, w, dim=0, over=over)
    if split is rows:
        return None
    y = placed_like(fn(split), rows)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def spread_product(fn: Callable, x: torch.Tensor, w: Optional[torch.Tensor] = None,
                   overs: Sequence[str] = (_MODEL_AXIS,)) -> torch.Tensor:
    """``fn(x)`` (a product of ``x`` by the weight ``w``, on x's last dim)
    with x's rows, its other dims flattened, split further over the idle
    axes of ``overs`` in turn (``spread_over_idle``), and the result placed
    back as the rows were before, then unflattened: XLA splits such a
    product over the axes that nothing else splits.  The rows are split as
    one dim because DTensor does not flatten a split sequence dim into a
    matmul's rows alike in every torch version.  A plain ``x``, or one
    with no idle axis, is ``fn(x)``."""
    y = _spread_rows(fn, x, w, overs) if isinstance(x, DTensor) else None
    return fn(x) if y is None else y


def spread_linear(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, bias)`` split over the ``model`` axis where the
    weight ``w`` (out, in) is whole there, as XLA's partitioner splits it
    (a projection that the head-aware rules keep off ``model``, an LM head
    whose vocab does not divide it): x's rows where they divide
    (``spread_product``), else w's output features, else the fan-in (a
    decode step's few rows a data rank), the same share of the product
    each; the result placed as the rows were, whole on ``model``.  A
    weight split over ``model``, a plain ``x``, or one where nothing
    divides: the product as it is."""
    linear = lambda t, w=w, b=bias: torch.nn.functional.linear(t, w, b)
    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return linear(x)
    y = _spread_rows(linear, x, w, (_MODEL_AXIS,))
    if y is not None:
        return y
    mesh = w.device_mesh
    idle = [i for i, (a, n) in enumerate(zip(_axis_names(mesh), mesh.shape))
            if a == _MODEL_AXIS and n > 1 and isinstance(w.placements[i], Replicate)
            and isinstance(x.placements[i], Replicate)]
    n_idle = math.prod(mesh.shape[i] for i in idle)
    by = lambda t, d: _placed(t, tuple(Shard(d % t.ndim) if i in idle else p
                                       for i, p in enumerate(t.placements)))
    if idle and w.shape[0] % n_idle == 0:
        y = linear(x, by(w, 0), None if bias is None else by(bias, 0))
    elif idle and bias is None and w.shape[1] % n_idle == 0:
        y = linear(by(x, -1), by(w, 1))
    else:
        return linear(x)
    return whole_on(y, -1)


def split_like(w: torch.Tensor, x: torch.Tensor, dims: Dict[int, int]) -> torch.Tensor:
    """``w`` split, on each mesh dim where ``x`` splits a dim ``d`` of
    ``dims`` and ``w`` is whole, on its dim ``dims[d]``: a weight whose
    product keeps ``x``'s split (each rank slices its share, no
    communication).  Otherwise, and for plain tensors, ``w`` as it is."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    placements = tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                       and isinstance(q, Replicate) else q
                       for p, q in zip(x.placements, w.placements))
    return _placed(w, placements)


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is in the forward, with its gradient redistributed in
    the backward to the placements ``x`` has (DTensor's redistribute to the
    same placements); a plain tensor, or one on a mesh of one rank (where
    every placement holds the same values), as it is."""
    if not isinstance(x, DTensor) or x.device_mesh.size() == 1:
        return x
    return x.redistribute(x.device_mesh, x.placements)


def _on_split_dims(placements: Sequence[Any], x: DTensor) -> Tuple[Any, ...]:
    """``placements`` where ``x``'s mesh dim has more than one rank, and
    x's own where it has one: a placement on a mesh dim of one rank holds
    the same values whatever it is, so redistributing there only costs a
    dispatch."""
    return tuple(own if n == 1 else pl
                 for pl, own, n in zip(placements, x.placements, x.device_mesh.shape))


def microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Slice ``i`` of ``n`` along dim 0 of a batch leaf, ``x.reshape(n, B //
    n, ...)[i]`` as the original slices it.  A DTensor is gathered whole
    first (DTensor cannot split a sharded dim unevenly, nor index one), and
    the slice placed by ``batch_specs``."""
    if not isinstance(x, DTensor):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
    mesh = x.device_mesh
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    part = whole.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
    return part.redistribute(mesh, make_shardings(batch_specs(part, mesh), mesh))


def full_value(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor, gathered on every rank (a
    collective: every rank must call it); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def whole_on(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with each of ``dims`` whole on every rank: a DTensor's shards
    of those dims gathered (a vocab-split logit row before a gather or an
    argmax along it, an embedding table before a lookup), and a partial
    sum summed; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    placements = tuple(Replicate() if isinstance(p, Partial) or
                       (isinstance(p, Shard) and p.dim in dims) else p
                       for p in x.placements)
    return x if placements == tuple(x.placements) else x.redistribute(x.device_mesh, placements)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  A DTensor table is gathered whole (``whole_on``);
    with DTensor ids each rank looks up its own ids (``local_map``), placed
    as they are, and the table's gradient comes back partial over the mesh
    dims that split the ids: DTensor's own index and its backward differ
    between torch versions."""
    whole = whole_on(table, 0, 1)
    if not isinstance(ids, DTensor):
        return whole[ids]
    pl = tuple(ids.placements)
    rep = (Replicate(),) * len(pl)
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in pl)
    mapped = local_map(lambda t, i: t[i], out_placements=(pl,), in_placements=(rep, pl),
                       in_grad_placements=(grad, pl), device_mesh=ids.device_mesh)
    return mapped(whole, ids)


# -- in-model activation constraints ------------------------------------------------

def constrain(x: torch.Tensor) -> torch.Tensor:
    """Pin an activation's sharding under the ambient ``activation_policy``.

    No policy active -> identity, so model code is unconditionally
    instrumented and single-device tests pay nothing.  Batch dim shards over
    the data axes; the sequence dim additionally shards over ``model`` when
    the policy enables sequence parallelism — each only if divisible.  Under
    a policy, ``x`` must be a DTensor on the policy's mesh.
    """
    mesh = _state["act_mesh"]
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("constrain under an activation_policy needs a DTensor activation, "
                        f"got a plain {type(x).__name__}: shard the state and the batch "
                        "(shard_train_state, shard_batch) on the policy's mesh")
    if x.device_mesh != mesh:
        raise ValueError("the activation is on another mesh than the activation policy's")
    shape = x.shape
    if not shape:
        return x
    entries: List[Any] = [_batch_dim_entry(shape[0], mesh)]
    entries += [None] * (len(shape) - 1)
    if (_state["seq_parallel"] and len(shape) >= 2
            and _state["strategy"] != "dp_only"
            and _model_size(mesh) > 1 and shape[1] % _model_size(mesh) == 0):
        entries[1] = _MODEL_AXIS
    placements = _on_split_dims(_placements(P(*entries), mesh), x)
    if placements != tuple(x.placements):
        if any(isinstance(p, Partial) for p in x.placements):
            x = _SumPartials.apply(x, placements)
        else:
            x = x.redistribute(mesh, placements)
    # the gradient, too, comes back placed so: from a column-split matmul
    # downstream it comes partial, and XLA sums it here
    return pin_grad(x)


class _SumPartials(torch.autograd.Function):
    """A DTensor's partial sums summed into ``placements`` (an all-reduce or
    a reduce-scatter), with its gradient passed back as it comes, as XLA
    differentiates an all-reduce.  DTensor's own backward would hand back a
    partial gradient, which makes the next matmul's backward gather its
    weight and run whole on every rank of the axis."""

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g, None


# -- kernels on local shards --------------------------------------------------------

def _attention_placements(q: DTensor, k: DTensor):
    """Placements under which attention runs on each rank's shards alone:
    per mesh dim, the batch split where q's batch is split, the heads split
    where q's heads are and both head counts divide (the GQA map h -> h // G
    then holds on local heads), else replicated.  Returns those of q/k/v
    and those of the positions (B, S)."""
    H, K = q.shape[2], k.shape[2]
    qkv, pos = [], []
    for n, p in zip(q.device_mesh.shape, q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            qkv.append(Shard(0)), pos.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and H % n == 0 and K % n == 0:
            qkv.append(Shard(2)), pos.append(Replicate())
        else:
            qkv.append(Replicate()), pos.append(Replicate())
    return tuple(qkv), tuple(pos)


def local_shards(fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, **kwargs) -> torch.Tensor:
    """``fn(q, k, v, q_pos, k_pos, **kwargs)`` (an attention kernel's
    wrapper, or the plain attention) on each rank's local shards when ``q``
    is a DTensor, under ``local_map``; the inputs are first redistributed
    by ``_attention_inputs``, and the output is placed as q then is.
    Autograd's backward goes through the same map, so the wrapper's
    backward runs on the local shards of the output's gradient.  A plain
    ``q`` calls ``fn`` as it is."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, q_pos, k_pos, **kwargs)
    args = _attention_inputs(q, k, v, q_pos, k_pos)
    qkv, pos = _attention_placements(args[0], args[1])
    mapped = local_map(lambda *a: fn(*a, **kwargs), out_placements=(qkv,),
                       in_placements=(qkv, qkv, qkv, pos, pos), device_mesh=q.device_mesh)
    return mapped(*args)


def _scan_placements(x: DTensor, dim: int) -> Tuple[Any, ...]:
    """Placements under which a scan or a router runs on each rank's
    shards alone, from those of ``x`` (its batch first): per mesh dim of
    more than one rank, the batch split where x's is, else ``dim`` (the
    heads or channels) split where it divides, with the splits before it,
    else replicated; the sequence is never split.  A mesh dim of one rank
    keeps x's own placement (a partial one as replicated): it holds the
    same values whatever it is."""
    out, split = [], 1
    for n, p in zip(x.device_mesh.shape, x.placements):
        if n == 1:
            out.append(Replicate() if isinstance(p, Partial) else p)
        elif p == Shard(0):
            out.append(p)
        elif x.shape[dim] % (split * n) == 0:
            split *= n
            out.append(Shard(dim))
        else:
            out.append(Replicate())
    return tuple(out)


def _follow(placements: Sequence[Any], dims: Dict[int, int]) -> Tuple[Any, ...]:
    """``placements`` of one tensor carried to another: ``Shard(d)`` becomes
    ``Shard(dims[d])``, any other placement (and a shard of a dim the other
    tensor lacks) ``Replicate()``."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def _placed(t: DTensor, placements: Tuple[Any, ...]) -> DTensor:
    """``t`` redistributed to ``placements``."""
    return t if tuple(t.placements) == placements else t.redistribute(t.device_mesh, placements)


def local_rwkv6_scan(fn: Callable, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                     **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(r, k, v, logw, u, state, **kwargs)`` (the RWKV-6 scan's wrapper)
    on each rank's local shards when ``r`` is a DTensor, under
    ``local_map``: r, k, v and logw (B, S, H, N) split by batch where r's
    batch is split and by heads on the other mesh dims where H divides
    (``_scan_placements``), the sequence and N whole; ``state`` (B, H, N,
    N) and ``u`` (H, N) split alike.  The outputs are placed so: y as r,
    the final state as ``state``.  ``u`` is one parameter for every batch
    row, so its local gradient is a sum over the rank's rows only: it is
    declared partial on each mesh dim that splits the batch, and
    autograd's backward sums it there.  A plain ``r`` calls ``fn`` as it
    is."""
    if not isinstance(r, DTensor):
        return fn(r, k, v, logw, u, state, **kwargs)
    rkv = _scan_placements(r, 2)
    st, up = _follow(rkv, {0: 0, 2: 1}), _follow(rkv, {2: 0})
    u_grad = tuple(Partial() if p == Shard(0) and n > 1 else q
                   for p, q, n in zip(rkv, up, r.device_mesh.shape))
    places = (rkv,) * 4 + (up, st)
    mapped = local_map(lambda *a: fn(*a, **kwargs), out_placements=(rkv, st),
                       in_placements=places, in_grad_placements=(rkv,) * 4 + (u_grad, st),
                       device_mesh=r.device_mesh)
    return mapped(*(_placed(t, pl) for t, pl in zip((r, k, v, logw, u, state), places)))


def local_rglru_scan(fn: Callable, a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fn(a, b, h0)`` (the RG-LRU scan's wrapper) on each rank's local
    shards when ``a`` is a DTensor, under ``local_map``: a and b (B, S, R)
    split by batch where a's batch is split and by channels on the other
    mesh dims where R divides (``_scan_placements``), the sequence whole;
    ``h0`` (B, R), when given, split alike; h placed as a.  A plain ``a``
    calls ``fn`` as it is."""
    if not isinstance(a, DTensor):
        return fn(a, b, h0)
    pl = _scan_placements(a, 2)
    args, places = [_placed(a, pl), _placed(b, pl)], [pl, pl]
    if h0 is not None:
        places.append(_follow(pl, {0: 0, 2: 1}))
        args.append(_placed(h0, places[-1]))
    mapped = local_map(lambda a, b, h0=None: fn(a, b, h0), out_placements=(pl,),
                       in_placements=tuple(places), device_mesh=a.device_mesh)
    return mapped(*args)


def local_moe_router(fn: Callable, logits: torch.Tensor,
                     top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(logits, top_k)`` (the MoE router's wrapper) on each rank's local
    rows when ``logits`` is a DTensor, under ``local_map``: the expert dim
    whole first (``whole_on``), the rows as they are split; the weights and
    the indices (..., k) placed as the rows.  The indices carry no
    gradient.  A plain ``logits`` calls ``fn`` as it is."""
    if not isinstance(logits, DTensor):
        return fn(logits, top_k)
    logits = whole_on(logits, -1)
    pl = tuple(logits.placements)
    mapped = local_map(lambda x: fn(x, top_k), out_placements=(pl, pl), in_placements=(pl,),
                       device_mesh=logits.device_mesh)
    return mapped(logits)


def local_moe_scatter(fn: Callable, xg: torch.Tensor, top_w: torch.Tensor,
                      top_idx: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(xg, top_w, top_idx, w_gate, w_up, w_down, first)`` (the
    sort/scatter MoE dispatch, which returns the routed output (G, S, D)
    and the kept tokens' counts (G, E)) on each rank's groups and experts
    when ``xg`` is a DTensor, under ``local_map``; ``first`` is the id of
    the rank's first expert (a one-element tensor), 0 for plain tensors.
    Per mesh dim of more than one rank: where the groups (dim 0 of xg) are
    split, the rank takes its groups and every expert; else, where the
    expert weights split their expert dim (``_EXPERT_RULES``: over
    ``model``), every group of its data rank and its own experts, with the
    routed output partial there (each rank sums its experts' share), and
    the gradients of xg and top_w too; else the groups split further where
    they divide, as ``spread_over_idle`` splits an idle axis (E = 40 on a
    ``model`` axis of 16 splits no expert); else both whole.  The weights'
    ``fsdp`` dims are gathered first (``whole_on``); their gradients are
    partial over the mesh dims that split the groups.  The counts are
    placed as the groups.  On a mesh dim of one rank xg, top_w and top_idx
    stay split where xg's groups are, the weights where their experts are,
    and nothing is partial."""
    if not isinstance(xg, DTensor):
        return fn(xg, top_w, top_idx, w_gate, w_up, w_down, 0)
    mesh = xg.device_mesh
    ws = [whole_on(w, d) for w, d in ((w_gate, 1), (w_up, 1), (w_down, 2))]
    E, G = ws[0].shape[0], xg.shape[0]
    by_groups = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
    by_experts = (Replicate(), Shard(0), Partial(), Partial(), Shard(0))
    # per mesh dim: (rows, experts, output, rows' gradient, weights' gradient)
    dims, split = [], 1
    for i, n in enumerate(mesh.shape):
        if n == 1:
            row, expert = (Shard(0) if t.placements[i] == Shard(0) else Replicate()
                           for t in (xg, ws[0]))
            dims.append((row, expert, row, row, expert))
        elif xg.placements[i] == Shard(0) or (ws[0].placements[i] != Shard(0)
                                               and G % (split * n) == 0):
            split *= n
            dims.append(by_groups)
        elif ws[0].placements[i] == Shard(0):
            dims.append(by_experts)
        else:
            dims.append((Replicate(),) * 5)
    rows, experts, out, rows_grad, w_grad = (tuple(pl) for pl in zip(*dims))
    counts = tuple(Replicate() if isinstance(p, Partial) else p for p in out)
    ids = _placed(replicated_like(torch.arange(E, device=xg.device), xg), experts)
    mapped = local_map(lambda x, w, i, a, b, c, e: fn(x, w, i, a, b, c, e[:1]),
                       out_placements=(out, counts), in_placements=(rows,) * 3 + (experts,) * 4,
                       in_grad_placements=(rows_grad, rows_grad, rows) + (w_grad,) * 3
                       + (experts,), device_mesh=mesh)
    args = [_placed(t, rows) for t in (xg, top_w, top_idx)] + [_placed(w, experts) for w in ws]
    return mapped(*args, ids)


def local_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, *operands)`` on each rank's local shards when
    the first operand is a DTensor, under ``local_map``: per mesh dim of
    more than one rank, the first label that an operand splits there (in
    operand order) is split in every operand that has it, the others whole
    there, and the output is split there where it keeps that label, partial
    where the label is summed over; the gradient of an operand without the
    label is partial there.  DTensor's own einsum flattens the summed dims
    into one, and torch 2.11's refuses a flatten whose inner dim is split;
    where it runs, its choice of split differs between torch versions.  A
    mesh dim of one rank keeps each operand's own placement (a partial one
    as replicated) and the output replicated.  Plain operands: the einsum
    as it is."""
    if not isinstance(operands[0], DTensor):
        return torch.einsum(spec, *operands)
    ins, out = spec.replace(" ", "").split("->")
    labels = ins.split(",")
    mesh = operands[0].device_mesh
    places: List[List[Any]] = [[] for _ in operands]
    grads: List[List[Any]] = [[] for _ in operands]
    out_pl: List[Any] = []
    for i, n in enumerate(mesh.shape):
        split = [lab[t.placements[i].dim] for lab, t in zip(labels, operands)
                 if isinstance(t.placements[i], Shard)]
        label = split[0] if split and n > 1 else ""
        for pl, grad, lab, t in zip(places, grads, labels, operands):
            own = t.placements[i]
            if n == 1:
                pl.append(Replicate() if isinstance(own, Partial) else own)
            else:
                pl.append(Shard(lab.index(label)) if label and label in lab else Replicate())
            grad.append(Partial() if label and label not in lab else pl[-1])
        out_pl.append(Replicate() if not label else
                      Shard(out.index(label)) if label in out else Partial())
    places = [tuple(pl) for pl in places]
    mapped = local_map(lambda *a: torch.einsum(spec, *a), out_placements=(tuple(out_pl),),
                       in_placements=tuple(places), in_grad_placements=tuple(map(tuple, grads)),
                       device_mesh=mesh)
    return mapped(*(_placed(t, pl) for t, pl in zip(operands, places)))


def _repeat_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """k or v (B, S, K, hd) with each of its K heads repeated for the H // K
    query heads of its group: (B, S, H, hd), the same attention.  A
    DTensor's heads are gathered first."""
    B, S, K, hd = t.shape
    if K == H:
        return t
    t = whole_on(t, 2)[:, :, :, None].expand(B, S, K, H // K, hd)
    return t.reshape(B, S, H, hd)


def _attention_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor):
    """q, k, v and the positions redistributed to ``_attention_placements``
    when ``q`` is a DTensor (a plain position made replicated), so that
    attention runs on each rank's batch and heads alone, the GQA groups
    whole; plain tensors as they are.  Where q's heads are split over a
    mesh dim that the kv heads do not divide, k and v are first repeated to
    q's H heads (each kv head once for each query head of its group, the
    same attention), so that the heads stay split, as XLA splits them."""
    if not isinstance(q, DTensor):
        return q, k, v, q_pos, k_pos
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    if any(isinstance(p, Shard) and p.dim == 2 and H % n == 0 and K % n
           for n, p in zip(mesh.shape, q.placements)):
        k, v = _repeat_heads(k, H), _repeat_heads(v, H)
    qkv, pos = _attention_placements(q, k)
    q_pos, k_pos = (replicated_like(p, q) if not isinstance(p, DTensor) else p
                    for p in (q_pos, k_pos))
    return tuple(t.redistribute(mesh, pl) if tuple(t.placements) != pl else t
                 for t, pl in zip((q, k, v, q_pos, k_pos), (qkv, qkv, qkv, pos, pos)))
