"""Carry weights from the JAX package into the port.

Takes the tree that ``repro.models.init_params`` returns, with its leaves
already mapped to numpy arrays by the caller, and loads it into the port's
modules.  This module is the only place that knows how the two layouts
differ:

- JAX stacks a segment's blocks on a leading repeat axis
  (``stack[si]["blocks"][bi][...]`` of shape (n, ...)); the port has one
  module per repeat, ``stack.{si}.{bi}.{r}``.
- JAX stores dense weights (in, out) and computes ``x @ w``; the port's
  ``nn.Linear`` holds (out, in).  A leaf is transposed when it lands in an
  ``nn.Linear`` of the target module, and only then: the decision follows
  the module, not the leaf's name (rglru's ``w_gate`` and rwkv6's ``w_r``
  are ``nn.Linear``s, rwkv6's ``maa_w2`` and rglru's ``conv_w`` are plain
  parameters in JAX's layout), so that a square matrix is never loaded
  untransposed where a shape check could not tell.  The stub frontend's
  ``frontend.proj`` is such an ``nn.Linear``.
- JAX's separate biases (``bq``, ``b_in``, ...) become the bias of the
  ``nn.Linear`` they add to.

Every leaf is consumed; a missing or extra leaf, or a shape that does not
fit, raises.  Neither ``jax`` nor ``repro`` is imported.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Set, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .config import ModelConfig
from .model import LM, init_params

__all__ = ["to_state_dict", "jax_layout", "load_module", "from_jax"]

_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv", "b_in": "w_in", "b_out": "w_out"}


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _port_leaf(path: Tuple[str, ...], arr: np.ndarray,
               linears: Set[str]) -> Tuple[str, np.ndarray]:
    """One JAX leaf (no repeat axis) at the target's ``path`` -> (port
    state-dict name, array).  ``linears`` names the target's ``nn.Linear``s."""
    *head, leaf = path
    join = lambda *parts: ".".join(parts)
    if join(*path) in linears:                       # a dense weight
        return join(*path, "weight"), arr.T
    if leaf == "w" and join(*head) in linears:       # {"w": ...}: the untied LM head
        return join(*head, "weight"), arr.T
    if leaf in _BIAS_OF and join(*head, _BIAS_OF[leaf]) in linears:
        return join(*head, _BIAS_OF[leaf], "bias"), arr
    return join(*path), arr


def to_state_dict(tree: Any, module: nn.Module) -> Dict[str, np.ndarray]:
    """Flatten a JAX parameter tree (numpy leaves) into the names and layouts
    of ``module``, unstacking ``stack`` segments along their repeat axis."""
    linears = {name for name, m in module.named_modules() if isinstance(m, nn.Linear)}
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(tree):
        arr = np.asarray(arr)
        if path[0] == "stack":
            if len(path) < 5 or path[2] != "blocks":
                raise KeyError(f"unexpected stack leaf {'/'.join(path)}")
            _, si, _, bi, *rest = path
            for r in range(arr.shape[0]):
                name, a = _port_leaf(("stack", si, bi, str(r), *rest), arr[r], linears)
                out[name] = a
        else:
            name, a = _port_leaf(path, arr, linears)
            out[name] = a
    return out


def jax_layout(module: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...], bool, bool]]:
    """The inverse of ``to_state_dict``, from the port's side: for each
    parameter of an ``LM``, (the path of the JAX leaf it holds, that leaf's
    shape, whether the leaf is stacked on a segment's repeat axis, whether
    the port holds it transposed).  A stacked leaf's shape has the repeat
    count in front; a bias of an ``nn.Linear`` is JAX's separate bias
    leaf."""
    linears = {name for name, m in module.named_modules() if isinstance(m, nn.Linear)}
    weight_of = {w: b for b, w in _BIAS_OF.items()}
    out = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        owner, leaf = ".".join(parts[:-1]), parts[-1]
        shape, transposed = tuple(p.shape), False
        if owner in linears and leaf == "weight":
            path = parts[:-1] + (["w"] if owner == "lm_head" else [])
            shape, transposed = shape[::-1], True
        elif owner in linears and leaf == "bias":
            path = parts[:-2] + [weight_of[parts[-2]]]
        else:
            path = parts
        stacked = path[0] == "stack"
        if stacked:
            _, si, bi, _, *rest = path
            path = ["stack", si, "blocks", bi, *rest]
            shape = (len(module.stack[int(si)][int(bi)]),) + shape
        out[name] = (tuple(path), shape, stacked, transposed)
    return out


def load_module(module: nn.Module, tree: Any) -> nn.Module:
    """Load a JAX subtree (numpy leaves) into ``module``'s parameters, in
    place.  Raises on a missing, extra or misshapen leaf."""
    state = to_state_dict(tree, module)
    target = module.state_dict()
    missing, extra = sorted(set(target) - set(state)), sorted(set(state) - set(target))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the port: missing {missing}, extra {extra}")
    device = next(iter(target.values())).device
    if device.type == "meta":
        device = torch.device("cpu")
    loaded = {}
    for name, arr in state.items():
        want = target[name]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} vs port {tuple(want.shape)}")
        t = torch.tensor(np.asarray(arr, dtype=np.float32))   # a copy: JAX's buffers are read-only
        loaded[name] = t.to(device=device, dtype=want.dtype)
    module.load_state_dict(loaded, strict=True, assign=True)
    return module


def from_jax(tree: Any, cfg: ModelConfig, device="cuda") -> LM:
    """A port ``LM`` holding the weights of ``repro.models.init_params``, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    model = init_params(None, cfg, device="meta")
    return load_module(model, tree).to(dev)
