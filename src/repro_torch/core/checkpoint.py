"""Checkpoint serialization: pytree <-> bytes (msgpack) and a manager.

The paper relies on checkpoints for (a) fault tolerance, (b) PBT-style clone /
hyperparameter mutation, (c) pause/resume under HyperBand.  In functional JAX
the trial state *is* a pytree, so a checkpoint is an exact, race-free snapshot.

We serialize with msgpack: tree structure as nested lists/dicts, leaves as
(dtype, shape, raw bytes).  No pickle on the wire for arrays (portable), and a
CRC over the payload catches truncation.  The codec covers the narrow dtypes
(``bfloat16``/``float16``/``float8_*`` via ml_dtypes) because for process
workers (DESIGN.md §5) the bytes path is the *only* path — a dtype the codec
can't round-trip is a hard trial failure, not a fallback.

This module deliberately avoids importing ``jax`` at module scope: spawned
worker processes import it on every boot, and a trainable that never touches
device arrays should not pay the ~2s jax import just to checkpoint scalars.
"""
from __future__ import annotations

import itertools
import os
import zlib
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np

from .object_store import ObjectStore
from .trial import Checkpoint

__all__ = ["tree_to_bytes", "tree_from_bytes", "CheckpointManager", "save_pytree", "load_pytree"]

_ARR = "__arr__"
_SCALAR = "__scalar__"
_EXPORT_SEQ = itertools.count()  # uniquifies export_copy keys within a host


def _resolve_dtype(name: str) -> "np.dtype":
    """dtype-by-name, including the ml_dtypes extension types.

    ``np.dtype("bfloat16")`` only resolves once ml_dtypes has been imported
    (jax does that implicitly; a jax-free worker process does not), so fall
    back to looking the name up on ml_dtypes directly.
    """
    try:
        return np.dtype(name)
    except TypeError:
        try:
            import ml_dtypes
            return np.dtype(getattr(ml_dtypes, name))
        except (ImportError, AttributeError):
            raise TypeError(f"unsupported checkpoint dtype {name!r}")


def _encode_leaf(leaf: Any):
    if isinstance(leaf, (bool, int, float, str)) or leaf is None:
        return {_SCALAR: leaf}
    if isinstance(leaf, (np.integer, np.floating)):
        return {_SCALAR: leaf.item()}
    if isinstance(leaf, np.ndarray) or (hasattr(leaf, "dtype") and hasattr(leaf, "shape")):
        # A CUDA tensor raises here, as np.asarray does: snapshots are copied
        # to the host by the trainable (ModelTrainable.save), never quietly here.
        arr = np.asarray(leaf)
        return {_ARR: [str(arr.dtype), list(arr.shape), arr.tobytes()]}
    raise TypeError(f"unsupported checkpoint leaf type: {type(leaf)}")


def _decode_leaf(obj):
    if isinstance(obj, dict) and _ARR in obj:
        dtype, shape, raw = obj[_ARR]
        return np.frombuffer(raw, dtype=_resolve_dtype(dtype)).reshape(shape).copy()
    if isinstance(obj, dict) and _SCALAR in obj:
        return obj[_SCALAR]
    raise TypeError(f"bad checkpoint leaf: {obj!r}")


def _encode(node: Any):
    if isinstance(node, dict) and _ARR not in node and _SCALAR not in node:
        return {"__dict__": {k: _encode(v) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"__list__" if isinstance(node, list) else "__tuple__": [_encode(v) for v in node]}
    return _encode_leaf(node)


def _decode(obj: Any):
    if isinstance(obj, dict):
        if "__dict__" in obj:
            return {k: _decode(v) for k, v in obj["__dict__"].items()}
        if "__list__" in obj:
            return [_decode(v) for v in obj["__list__"]]
        if "__tuple__" in obj:
            return tuple(_decode(v) for v in obj["__tuple__"])
    return _decode_leaf(obj)


def tree_to_bytes(tree: Any) -> bytes:
    payload = msgpack.packb(_encode(tree), use_bin_type=True)
    crc = zlib.crc32(payload)
    return crc.to_bytes(4, "little") + payload


def tree_from_bytes(data: bytes) -> Any:
    crc, payload = int.from_bytes(data[:4], "little"), data[4:]
    if zlib.crc32(payload) != crc:
        raise IOError("checkpoint CRC mismatch (truncated or corrupt)")
    return _decode(msgpack.unpackb(payload, raw=False, strict_map_key=False))


def _write_atomic(data: bytes, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic


def save_pytree(tree: Any, path: str) -> None:
    _write_atomic(tree_to_bytes(tree), path)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return tree_from_bytes(f.read())


class CheckpointManager:
    """Stores trial checkpoints in the object store, optionally mirrored to disk.

    ``keep_last`` bounds per-trial retained checkpoints: rotation deletes both
    the store entry *and* its durable ``iter_N.ckpt`` mirror, unless the
    ``Checkpoint`` is pinned (``Checkpoint.pinned``, set by a scheduler that
    staged it — e.g. a PBT donor awaiting exploit), in which case both survive.

    Stored values are either live pytrees (in-host executors) or
    ``tree_to_bytes`` payloads (process workers); ``restore`` decodes bytes
    transparently so the two execution tiers share one checkpoint namespace.
    """

    def __init__(self, store: ObjectStore, dir: Optional[str] = None,
                 keep_last: int = 2, durable: bool = False):
        self.store = store
        self.dir = dir
        self.keep_last = keep_last
        self.durable = durable  # mirror every checkpoint to disk (fault tolerance)
        self._per_trial: Dict[str, List[Checkpoint]] = {}

    def _mirror_path(self, trial_id: str, iteration: int) -> str:
        safe_id = trial_id.replace("/", "_")
        return os.path.join(self.dir, safe_id, f"iter_{iteration}.ckpt")

    def _record(self, ckpt: Checkpoint) -> Checkpoint:
        """Append to the per-trial history and rotate out old checkpoints —
        store entry and disk mirror both — keeping pinned ones alive.

        A store key or mirror path may be shared by a *newer* history entry
        (a PBT rewind re-reaches an iteration and checkpoints it again);
        deleting through the old entry would destroy the live one's data, so
        shared references are left in place.
        """
        hist = self._per_trial.setdefault(ckpt.trial_id, [])
        hist.append(ckpt)
        keep: List[Checkpoint] = []
        # pinned entries are moved out of hist as they're found, so the loop
        # condition counts only unpinned candidates against keep_last
        while len(hist) > self.keep_last:
            old = hist.pop(0)
            if old.pinned:
                keep.append(old)  # a scheduler staged this one; both copies survive
                continue
            live = hist + keep
            if old.store_key and all(c.store_key != old.store_key for c in live):
                self.store.delete(old.store_key)
            if old.path and all(c.path != old.path for c in live) \
                    and os.path.exists(old.path):
                os.remove(old.path)
        hist[:0] = keep
        return ckpt

    def save(self, trial_id: str, iteration: int, state: Any, to_disk: bool = False) -> Checkpoint:
        key = f"ckpt/{trial_id}/{iteration}"
        self.store.put(state, key=key)
        path = None
        if (to_disk or self.durable) and self.dir:
            path = self._mirror_path(trial_id, iteration)
            save_pytree(state, path)
        return self._record(Checkpoint(trial_id=trial_id, training_iteration=iteration,
                                       store_key=key, path=path))

    def adopt(self, trial_id: str, iteration: int, store_key: str) -> Checkpoint:
        """Record a checkpoint whose payload a worker process already placed in
        the (shared-spill) store as ``tree_to_bytes`` bytes.  The durable mirror
        writes those bytes raw — the file format is identical to
        ``save_pytree``'s, so ``load_pytree`` reads either."""
        path = None
        if self.durable and self.dir:
            # peek, not get: mirroring must not re-admit every checkpoint blob
            # into the host LRU (nor cache a copy a worker may rewrite later)
            data = self.store.peek(store_key)
            path = self._mirror_path(trial_id, iteration)
            if isinstance(data, (bytes, bytearray)):
                _write_atomic(bytes(data), path)
            else:
                save_pytree(data, path)
        return self._record(Checkpoint(trial_id=trial_id, training_iteration=iteration,
                                       store_key=store_key, path=path))

    def export_copy(self, ckpt: Checkpoint) -> str:
        """Snapshot ``ckpt``'s payload under a fresh private key on the spill
        surface for a worker process to consume *asynchronously*.

        A private copy, not the original key: the source may be rotated out or
        unpinned the moment the caller returns (PBT donors keep training and
        checkpointing while the exploited trial's child is still booting), and
        that must not invalidate what the child is about to read."""
        if ckpt.store_key and self.store.contains(ckpt.store_key):
            payload = self.store.peek(ckpt.store_key)
        elif ckpt.path and os.path.exists(ckpt.path):
            with open(ckpt.path, "rb") as f:
                payload = f.read()
        else:
            raise KeyError(f"checkpoint {ckpt.location} unavailable")
        key = (f"export/{ckpt.trial_id}/{ckpt.training_iteration}"
               f".{next(_EXPORT_SEQ)}")
        return self.store.put_spilled(payload, key=key)

    def restore(self, ckpt: Checkpoint) -> Any:
        if ckpt.store_key and self.store.contains(ckpt.store_key):
            state = self.store.get(ckpt.store_key)
            if isinstance(state, (bytes, bytearray)):
                return tree_from_bytes(bytes(state))  # process-worker payload
            return state
        if ckpt.path:
            return load_pytree(ckpt.path)
        raise KeyError(f"checkpoint {ckpt.location} unavailable")

    def latest(self, trial_id: str) -> Optional[Checkpoint]:
        hist = self._per_trial.get(trial_id)
        return hist[-1] if hist else None
