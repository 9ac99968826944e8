"""In-memory object store — the ``ray.put``/``ray.get`` analogue (paper §4.3.2).

Trials broadcast weights/datasets by putting them in the store and passing keys;
PBT clones a trial by ``get``-ing the donor checkpoint.  Content lives in host
memory with optional spill-to-disk for large or evicted entries.  Values are
arbitrary pytrees; we deep-copy nothing — JAX arrays are immutable, so sharing
references is safe and clone-by-reference is O(1) (a functional-state advantage
over actor snapshots, noted in DESIGN.md §2).

Two properties matter for the execution tiers (DESIGN.md §4–§5):

- **Thread/process-host safety** — the store is shared mutable state across the
  runner thread, the concurrent executor's worker threads, and the process
  executor's pump thread, so every public operation holds one ``RLock``.
- **Spill files as an IPC surface** — ``put_spilled`` writes an entry straight
  to the spill directory and ``export`` forces a resident entry out to it, so a
  *separate process* pointed at the same ``spill_dir`` can exchange values by
  key alone (the process-worker checkpoint path, DESIGN.md §5).  ``get`` of a
  spilled entry re-admits it into the in-memory LRU so hot entries stop paying
  a disk read per access.
"""
from __future__ import annotations

import itertools
import os
import pickle
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Optional

__all__ = ["ObjectStore"]


class ObjectStore:
    def __init__(self, capacity_bytes: int = 2 << 30, spill_dir: Optional[str] = None):
        self._mem: "OrderedDict[str, Any]" = OrderedDict()
        self._sizes: dict = {}
        self._capacity = capacity_bytes
        self._used = 0
        self._spill_dir = spill_dir
        self._counter = itertools.count()
        self._lock = threading.RLock()
        self.n_spilled = 0
        self.n_evicted = 0

    @property
    def spill_dir(self) -> Optional[str]:
        return self._spill_dir

    def ensure_spill_dir(self) -> str:
        """The spill directory, creating a private temp one if unconfigured.

        Process workers *require* a spill surface (checkpoint bytes cross the
        process boundary as spill files), so the process executor calls this at
        construction instead of failing on the first checkpoint.
        """
        with self._lock:
            if not self._spill_dir:
                self._spill_dir = tempfile.mkdtemp(prefix="repro-store-")
            os.makedirs(self._spill_dir, exist_ok=True)
            return self._spill_dir

    def _estimate_size(self, value: Any) -> int:
        if isinstance(value, (bytes, bytearray)):
            return max(len(value), 64)
        # The port's snapshots are nests of dicts, lists and tuples of host
        # numpy arrays (ModelTrainable.save), so the walk below sizes them
        # all; the original sizes through jax.tree_util when jax is loaded.
        leaves = []
        stack = [value]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            else:
                leaves.append(node)
        total = 0
        for leaf in leaves:
            if isinstance(leaf, (bytes, bytearray)):
                total += len(leaf)
            elif hasattr(leaf, "nbytes"):
                total += int(leaf.nbytes)
            else:
                total += 64
        return max(total, 64)

    def put(self, value: Any, key: Optional[str] = None) -> str:
        with self._lock:
            key = key or f"obj_{next(self._counter):08d}"
            size = self._estimate_size(value)
            if key in self._mem:
                # replacing: credit the old entry back BEFORE capacity accounting,
                # else a same-key update can spuriously evict (or refuse)
                self._used -= self._sizes.pop(key, 0)
                del self._mem[key]
            self._evict_for(size)
            self._mem[key] = value
            self._sizes[key] = size
            self._used += size
            self._mem.move_to_end(key)
            return key

    def put_spilled(self, value: Any, key: Optional[str] = None) -> str:
        """Write ``value`` directly to the spill surface, bypassing memory.

        This is the cross-process handoff path: a worker process stores
        checkpoint bytes here and sends only the key over the pipe; the host's
        store (same ``spill_dir``) resolves the key via ``get``/``contains``.
        """
        with self._lock:
            if not self._spill_dir:
                raise RuntimeError("put_spilled requires a spill_dir")
            key = key or f"obj_{next(self._counter):08d}"
            self._write_spill(key, value)
            # a stale in-memory copy under the same key would shadow the new file
            if key in self._mem:
                self._used -= self._sizes.pop(key, 0)
                del self._mem[key]
            self.n_spilled += 1
            return key

    def export(self, key: str) -> str:
        """Force ``key`` onto the spill surface (if not already there) and
        return the file path, so another process can read it."""
        with self._lock:
            path = self._spill_path(key)
            if not path:
                raise RuntimeError("export requires a spill_dir")
            if not os.path.exists(path):
                if key not in self._mem:
                    raise KeyError(f"object {key!r} not in store")
                self._write_spill(key, self._mem[key])
                self.n_spilled += 1
            return path

    def get(self, key: str) -> Any:
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)  # LRU touch
                return self._mem[key]
            path = self._spill_path(key)
            if path and os.path.exists(path):
                with open(path, "rb") as f:
                    value = pickle.load(f)
                # Re-admit into the LRU: repeated gets of a hot spilled entry
                # must not pay a disk read each time.  The file stays behind as
                # the durable copy (delete() removes both).
                self.put(value, key=key)
                return value
            raise KeyError(f"object {key!r} not in store")

    def peek(self, key: str) -> Any:
        """``get`` without the LRU touch or spill re-admission: for one-shot
        readers (e.g. mirroring a worker-written checkpoint to disk) that must
        not cache a copy another process may rewrite, nor evict hot entries."""
        with self._lock:
            if key in self._mem:
                return self._mem[key]
            path = self._spill_path(key)
            if path and os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)
            raise KeyError(f"object {key!r} not in store")

    def contains(self, key: str) -> bool:
        with self._lock:
            path = self._spill_path(key)
            return key in self._mem or bool(path and os.path.exists(path))

    def delete(self, key: str) -> None:
        with self._lock:
            if key in self._mem:
                self._used -= self._sizes.pop(key, 0)
                del self._mem[key]
            path = self._spill_path(key)
            if path and os.path.exists(path):
                os.remove(path)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    # -- eviction / spill ------------------------------------------------------
    def _spill_path(self, key: str) -> Optional[str]:
        if not self._spill_dir:
            return None
        return os.path.join(self._spill_dir, f"{key.replace('/', '__')}.pkl")

    def _write_spill(self, key: str, value: Any) -> None:
        path = self._spill_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)  # atomic: a concurrent reader never sees a torn file

    def _evict_for(self, incoming: int) -> None:
        # caller holds self._lock (RLock re-entry from put)
        if self._used + incoming > self._capacity and self._mem and not self._spill_dir:
            # Without a spill_dir, LRU eviction would DESTROY objects and turn
            # later get() calls into KeyErrors.  Refuse: a loud capacity error
            # beats silently losing a trial checkpoint.
            raise RuntimeError(
                f"ObjectStore over capacity ({self._used + incoming} > "
                f"{self._capacity} bytes) and no spill_dir is configured; "
                "evicting would destroy stored objects. Configure spill_dir= "
                "or raise capacity_bytes.")
        while self._mem and self._used + incoming > self._capacity:
            key, value = self._mem.popitem(last=False)  # LRU -> disk
            self._used -= self._sizes.pop(key, 0)
            self._write_spill(key, value)
            self.n_spilled += 1
            self.n_evicted += 1
