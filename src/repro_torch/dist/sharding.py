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
* ``constrain`` redistributes a DTensor activation; under an active policy a
  plain tensor raises, so that nothing runs unsharded unseen.
* ``local_shards`` runs a kernel wrapper on each rank's shards
  (``local_map``), which XLA's partitioner does for a Pallas call.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

__all__ = [
    "P", "spec_for", "param_specs", "train_state_specs", "batch_specs",
    "cache_specs", "make_shardings", "constrain", "sharding_strategy",
    "activation_policy", "STRATEGIES", "shard_train_state", "shard_batch",
    "local_shards", "replicated_like", "whole_on", "placed_like", "full_value",
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


def shard_train_state(state, mesh, cfg=None):
    """The state with its ``LM``'s parameters replaced, in place, by
    DTensors placed by ``train_state_specs`` (``make_shardings``), and its
    optimizer moments distributed likewise; counters stay Python ints."""
    from torch import nn
    from ..train import TrainState
    shardings = make_shardings(train_state_specs(state, mesh, cfg), mesh)
    for name, p in list(state.params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = state.params.get_submodule(owner) if owner else state.params
        dt = _distribute(p.detach(), mesh, shardings.params[name])
        setattr(module, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))

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
    """A DTensor parameter's gradient redistributed to the parameter's
    placements (autograd may hand it back partial or otherwise placed), so
    that the optimizer's moments keep the parameter's; a plain gradient as
    it is."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def full_value(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value as a plain tensor, gathered on every rank (a
    collective: every rank must call it); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def whole_on(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with each of ``dims`` whole on every rank: a DTensor's shards
    of those dims gathered (a vocab-split logit row before a gather or an
    argmax along it, an embedding table before a lookup); a plain tensor as
    it is."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                       for p in x.placements)
    return x if placements == tuple(x.placements) else x.redistribute(x.device_mesh, placements)


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
    placements = _placements(P(*entries), mesh)
    return x if tuple(x.placements) == placements else x.redistribute(mesh, placements)


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
    wrapper) on each rank's local shards when ``q`` is a DTensor, under
    ``local_map``; the inputs are first redistributed to
    ``_attention_placements``, and the output is placed as q then is.
    Autograd's backward goes through the same map, so the wrapper's
    backward runs on the local shards of the output's gradient.  A plain
    ``q`` calls ``fn`` as it is."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, q_pos, k_pos, **kwargs)
    mesh = q.device_mesh
    qkv, pos = _attention_placements(q, k)
    q_pos, k_pos = (replicated_like(p, q) if not isinstance(p, DTensor) else p
                    for p in (q_pos, k_pos))
    args = [t.redistribute(mesh, pl) if tuple(t.placements) != pl else t
            for t, pl in zip((q, k, v, q_pos, k_pos), (qkv, qkv, qkv, pos, pos))]
    mapped = local_map(lambda *a: fn(*a, **kwargs), out_placements=(qkv,),
                       in_placements=(qkv, qkv, qkv, pos, pos), device_mesh=mesh)
    return mapped(*args)
