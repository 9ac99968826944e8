"""SlicePool — contiguous sub-mesh allocation for trials (DESIGN.md §2).

The runner treats TPU devices like the paper treats cluster nodes: a trial
asks for ``Resources(devices=k)`` and the executor hands it a ``MeshSlice``
of ``k`` contiguous devices from the pool.  Contiguity matters on real
hardware (ICI locality on a torus); here it is first-fit over a linearized
device order with coalescing on release, i.e. the classic free-list
allocator, which keeps fragmentation bounded for the power-of-two slice
sizes trials actually request.

Two modes:

* device mode — ``SlicePool(devices=[...])`` allocates the devices of the
  default process group's ranks, one a rank (``torch.device("cuda", 0)``
  on a card); ``MeshSlice.make_mesh`` builds a ``DeviceMesh`` over the
  slice's ranks.
* virtual mode — ``SlicePool(n_virtual=256)`` tracks capacity only (CPU
  testing / benchmarks); ``make_mesh`` builds a mesh only over a whole
  process group of the slice's size (one rank cannot be tiled into several
  as JAX tiles host devices).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

__all__ = ["MeshSlice", "SlicePool"]


def balanced_shape(size: int, n_axes: int) -> Tuple[int, ...]:
    """Factor ``size`` into ``n_axes`` dims, as square as possible, largest
    first — e.g. 8 over 2 axes -> (4, 2).  Used when a trial mesh has more
    axis names than the slice has natural dimensions."""
    if n_axes <= 0:
        raise ValueError("n_axes must be >= 1")
    dims = [1] * n_axes
    rem = size
    # peel prime factors largest-first onto the currently-smallest axis
    factors: List[int] = []
    d = 2
    while d * d <= rem:
        while rem % d == 0:
            factors.append(d)
            rem //= d
        d += 1
    if rem > 1:
        factors.append(rem)
    for f in sorted(factors, reverse=True):
        dims[dims.index(min(dims))] *= f
    return tuple(sorted(dims, reverse=True))


@dataclass(frozen=True)
class MeshSlice:
    """A contiguous range of the pool's device order.

    ``devices`` is None in virtual mode.  Slices are value objects — the pool
    identifies them by ``(start, size)`` on release.
    """
    start: int
    size: int
    devices: Optional[Tuple[Any, ...]] = None

    def make_mesh(self, axis_names: Sequence[str],
                  shape: Optional[Tuple[int, ...]] = None):
        """A ``torch.distributed`` ``DeviceMesh`` over this slice's ranks.

        ``shape`` defaults to a balanced factorization of ``size`` over
        ``axis_names`` (one axis -> ``(size,)``), which become the mesh's
        ``mesh_dim_names``.  A slice's devices are ranks of the default
        process group: ranks ``start .. start+size-1``, one device each.
        Every rank of the group calls this for the same slice (building a
        mesh is collective).  In virtual mode one rank cannot be tiled into
        several, so the slice must cover the whole group (ranks
        ``0 .. size-1``).  Raises when no group is initialised or the slice
        does not fit in it.
        """
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        axis_names = tuple(axis_names)
        if shape is None:
            shape = balanced_shape(self.size, len(axis_names))
        if math.prod(shape) != self.size:
            raise ValueError(f"mesh shape {shape} does not cover slice of "
                             f"size {self.size}")
        if not dist.is_initialized():
            raise RuntimeError("MeshSlice.make_mesh needs a torch.distributed process group: "
                               "a slice's devices are ranks of the default group "
                               "(init_process_group first)")
        world = dist.get_world_size()
        if self.devices is not None:
            if self.start + self.size > world:
                raise RuntimeError(f"slice [{self.start}, {self.start + self.size}) is not "
                                   f"inside the process group's {world} ranks")
            device_type = torch.device(self.devices[0]).type
        else:
            if world != self.size:
                raise RuntimeError(f"a virtual slice of {self.size} devices needs a process "
                                   f"group of {self.size} ranks, not {world}: one rank "
                                   "cannot be tiled into several")
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        ranks = torch.arange(self.start, self.start + self.size).reshape(shape)
        return DeviceMesh(device_type, ranks, mesh_dim_names=axis_names)


class SlicePool:
    """First-fit contiguous allocator over a linear device order.

    Free ranges are kept sorted by start offset; ``release`` merges with
    adjacent free ranges so a fully-drained pool always coalesces back to one
    range (``can_fit(n_total)`` is the invariant the tests check).
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 n_virtual: Optional[int] = None):
        if (devices is None) == (n_virtual is None):
            raise ValueError("pass exactly one of devices= or n_virtual=")
        self._devices = tuple(devices) if devices is not None else None
        self.n_total = len(self._devices) if self._devices is not None else int(n_virtual)
        if self.n_total <= 0:
            raise ValueError("pool must hold at least one device")
        self._free: List[Tuple[int, int]] = [(0, self.n_total)]  # (start, size)
        self._held: dict = {}  # start -> size, for double-release detection
        self.n_acquired_total = 0  # lifetime acquire count (occupancy metrics)
        self.n_resized_total = 0   # lifetime elastic resize count

    # -- queries -----------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return sum(size for _, size in self._free)

    def can_fit(self, size: int) -> bool:
        if size <= 0:
            raise ValueError(f"slice size must be positive, got {size}")
        return any(sz >= size for _, sz in self._free)

    def fragments(self) -> int:
        """Post-coalesce holes: disjoint free ranges beyond the first.

        Release always coalesces adjacent free ranges, so a single free range
        (wherever it sits) can host any contiguous request up to ``n_free`` —
        that is a *healthy* pool and counts as 0.  Each additional disjoint
        range is a hole that makes ``largest_free_block() < n_free``, i.e.
        real external fragmentation the broker and Console report on.
        """
        return max(0, len(self._free) - 1)

    def utilization(self) -> float:
        """Fraction of devices currently allocated to trials (0.0 - 1.0)."""
        return (self.n_total - self.n_free) / self.n_total

    def largest_free_block(self) -> int:
        """Largest contiguous request that would succeed right now."""
        return max((size for _, size in self._free), default=0)

    def can_resize(self, sl: MeshSlice, new_size: int) -> bool:
        """Would ``resize(sl, new_size)`` succeed?  Shrinks always do; grows
        need a block of ``new_size`` in the free list *as it looks with
        ``sl`` released* — relocation frees the old range first, so the old
        slice coalesced with its free neighbours counts too."""
        if self._held.get(sl.start) != sl.size:
            raise ValueError(f"slice [{sl.start}, {sl.start + sl.size}) is not "
                             "currently held")
        if new_size <= 0:
            return False
        if new_size <= sl.size:
            return True
        merged = sl.size
        for start, size in self._free:
            if start + size == sl.start or start == sl.start + sl.size:
                merged += size
            elif size >= new_size:
                return True  # relocation into a disjoint free block
        return merged >= new_size

    # -- allocate / release -------------------------------------------------------
    def acquire(self, size: int) -> MeshSlice:
        if size <= 0:
            raise ValueError(f"slice size must be positive, got {size}")
        for i, (start, sz) in enumerate(self._free):
            if sz >= size:
                if sz == size:
                    del self._free[i]
                else:
                    self._free[i] = (start + size, sz - size)
                self._held[start] = size
                self.n_acquired_total += 1
                devs = (self._devices[start:start + size]
                        if self._devices is not None else None)
                return MeshSlice(start=start, size=size, devices=devs)
        raise RuntimeError(
            f"SlicePool cannot fit a slice of {size} devices "
            f"(free={self.n_free}/{self.n_total} in {len(self._free)} fragments)")

    def release(self, sl: MeshSlice) -> None:
        if self._held.get(sl.start) != sl.size:
            raise ValueError(f"slice [{sl.start}, {sl.start + sl.size}) is not "
                             "currently held (double release?)")
        del self._held[sl.start]
        self._insert_free(sl.start, sl.size)

    def _insert_free(self, start: int, size: int) -> None:
        """Insert a freed range sorted, then coalesce with neighbours."""
        import bisect
        idx = bisect.bisect_left(self._free, (start, size))
        self._free.insert(idx, (start, size))
        merged: List[Tuple[int, int]] = []
        for s, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((s, sz))
        self._free = merged

    def _slice_at(self, start: int, size: int) -> MeshSlice:
        devs = self._devices[start:start + size] if self._devices is not None else None
        return MeshSlice(start=start, size=size, devices=devs)

    def acquire_at(self, start: int, size: int) -> MeshSlice:
        """Carve an exact range out of the free list (no first-fit search).

        The rollback half of an elastic resize: a failed rebuild must put the
        trial back on the precise device range its live mesh still covers, not
        on whatever first-fit would pick.
        """
        if size <= 0:
            raise ValueError(f"slice size must be positive, got {size}")
        for i, (fs, fsz) in enumerate(self._free):
            if fs <= start and start + size <= fs + fsz:
                del self._free[i]
                if fs < start:
                    self._free.insert(i, (fs, start - fs))
                    i += 1
                if start + size < fs + fsz:
                    self._free.insert(i, (start + size, fs + fsz - (start + size)))
                self._held[start] = size
                return self._slice_at(start, size)
        raise RuntimeError(f"range [{start}, {start + size}) is not free")

    # -- elastic resize -----------------------------------------------------------
    def try_grow(self, sl: MeshSlice, new_size: int) -> Optional[MeshSlice]:
        """In-place growth only: extend ``sl`` into the free range that starts
        exactly at its end.  Returns the grown slice, or None when the
        adjacent range can't supply the delta (caller may then relocate via
        ``resize``).  Never moves devices the trial already holds."""
        if self._held.get(sl.start) != sl.size:
            raise ValueError(f"slice [{sl.start}, {sl.start + sl.size}) is not "
                             "currently held")
        delta = new_size - sl.size
        if delta <= 0:
            raise ValueError(f"try_grow needs new_size > current "
                             f"({new_size} <= {sl.size})")
        end = sl.start + sl.size
        for i, (start, size) in enumerate(self._free):
            if start == end and size >= delta:
                if size == delta:
                    del self._free[i]
                else:
                    self._free[i] = (start + delta, size - delta)
                self._held[sl.start] = new_size
                self.n_resized_total += 1
                return self._slice_at(sl.start, new_size)
        return None

    def resize(self, sl: MeshSlice, new_size: int) -> MeshSlice:
        """Grow or shrink a held slice, preferring in-place moves.

        Shrink trims the tail back into the free list (always succeeds).
        Grow extends into the adjacent free range when possible, otherwise
        relocates to a first-fit block of ``new_size`` — the caller must
        rebuild the trial's mesh either way, so relocation costs nothing
        extra.  Raises ``RuntimeError`` when no placement exists; the held
        slice is unchanged in that case (the operation is atomic).
        """
        if self._held.get(sl.start) != sl.size:
            raise ValueError(f"slice [{sl.start}, {sl.start + sl.size}) is not "
                             "currently held")
        if new_size <= 0:
            raise ValueError(f"slice size must be positive, got {new_size}")
        if new_size == sl.size:
            return sl
        if new_size < sl.size:  # trim the tail
            self._held[sl.start] = new_size
            self._insert_free(sl.start + new_size, sl.size - new_size)
            self.n_resized_total += 1
            return self._slice_at(sl.start, new_size)
        grown = self.try_grow(sl, new_size)
        if grown is not None:
            return grown
        # Relocate: release, then first-fit via acquire (which may land on
        # the coalesced union of the old range and a neighbour).  If nothing
        # fits, carve the exact old range back out — always possible, nothing
        # else allocated in between — so failure leaves the pool untouched.
        del self._held[sl.start]
        self._insert_free(sl.start, sl.size)
        try:
            moved = self.acquire(new_size)
        except RuntimeError:
            restored = self.acquire_at(sl.start, sl.size)
            assert restored.start == sl.start and restored.size == sl.size
            raise RuntimeError(
                f"SlicePool cannot resize slice [{sl.start}, {sl.start + sl.size}) "
                f"to {new_size} devices (free={self.n_free}/{self.n_total}, "
                f"largest block={self.largest_free_block()})") from None
        self.n_acquired_total -= 1  # an internal move, not a new placement
        self.n_resized_total += 1
        return moved

    def __repr__(self) -> str:
        return (f"SlicePool(total={self.n_total}, free={self.n_free}, "
                f"holes={self.fragments()}, "
                f"util={self.utilization():.0%})")
