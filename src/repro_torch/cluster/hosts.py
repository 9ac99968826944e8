"""Host roster for the cluster tier (DESIGN.md §11).

A *host* is one failure domain: its own device pool (SlicePool), its own
checkpoint spill surface (ObjectStore with a private spill dir — simulating a
separate filesystem), and its own liveness state.  The controller schedules
trials *onto* hosts; when a host dies, every trial on it fails together and
each restart is charged to that trial's ``max_failures`` budget.

Checkpoint bytes cross hosts with ``fetch``: a content-addressed copy over the
ObjectStore spill surface.  ``cas/<trial>/<sha256>`` keys carry their own
digest, so the destination re-hashes after the copy and a torn or corrupted
spill file fails the fetch instead of silently restoring garbage.

This module is jax-free: host hardware is described by throughput constants
(the same axes as ``launch/roofline.py``'s ``HW``), not device handles.
"""
from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from ..dist.submesh import SlicePool
from ..core.object_store import ObjectStore

__all__ = ["HostSpec", "HostAgent", "parse_hosts", "fetch"]


@dataclass(frozen=True)
class HostSpec:
    """Static description of one host: capacity + roofline throughputs.

    Defaults describe one HGX node of NVIDIA H100 SXM cards (8 of them), the
    port's device, in the units of ``placement.REF_*``; heterogeneous rosters
    override per host.  Units: FLOP/s, bytes/s.
    """
    name: str
    devices: int = 8
    peak_flops: float = 989e12      # per-device BF16 dense peak
    hbm_bw: float = 3.35e12         # per-device HBM3 bytes/s
    link_bw: float = 450e9          # NVLink bytes/s, each way


class HostAgent:
    """Live controller-side state for one host.

    ``last_seen`` is a ``clock.monotonic()`` instant — liveness age math must
    never touch wall time (an NTP step would age every host at once).
    """

    def __init__(self, spec: HostSpec, clock: Any,
                 spill_root: Optional[str] = None,
                 store_capacity: int = 1 << 20):
        self.spec = spec
        self.name = spec.name
        self.pool = SlicePool(n_virtual=spec.devices)
        spill_dir = None
        if spill_root is not None:
            spill_dir = os.path.join(spill_root, spec.name)
            os.makedirs(spill_dir, exist_ok=True)
        # Small in-memory window: host stores exist as spill surfaces, the
        # payloads live on "the host's disk".
        self.store = ObjectStore(capacity_bytes=store_capacity,
                                 spill_dir=spill_dir)
        if spill_dir is None:
            self.store.ensure_spill_dir()
        self.alive = True
        self.last_seen: float = clock.monotonic()
        self.trials: Set[str] = set()   # trials currently placed here
        self.n_evictions = 0
        self.evicted_reason: Optional[str] = None

    def touch(self, now: float) -> None:
        if now > self.last_seen:
            self.last_seen = now

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"HostAgent({self.name}, devices={self.spec.devices}, "
                f"alive={self.alive}, free={self.pool.n_free})")


_HOSTS_RE = re.compile(r"^(\d+)x(\d+)$")


def parse_hosts(hosts: Any) -> List[HostSpec]:
    """Coerce the ``hosts=`` argument into a HostSpec roster.

    Accepted forms:
      - int ``3``                      -> 3 hosts x 8 devices
      - str ``"3x8"``                  -> 3 hosts x 8 devices
      - str ``"h0:8,h1:4,h2:16"``      -> named hosts with device counts
      - list of HostSpec               -> passed through
      - list of (name, devices) pairs
    """
    if isinstance(hosts, int):
        return [HostSpec(name=f"h{i}") for i in range(hosts)]
    if isinstance(hosts, str):
        m = _HOSTS_RE.match(hosts.strip())
        if m:
            n, dev = int(m.group(1)), int(m.group(2))
            return [HostSpec(name=f"h{i}", devices=dev) for i in range(n)]
        specs = []
        for part in hosts.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                name, dev = part.split(":", 1)
                specs.append(HostSpec(name=name.strip(), devices=int(dev)))
            else:
                specs.append(HostSpec(name=part))
        if not specs:
            raise ValueError(f"unparseable hosts spec {hosts!r}")
        hosts = specs  # fall through to shared roster validation
    out = []
    for h in hosts:
        if isinstance(h, HostSpec):
            out.append(h)
        else:
            name, dev = h
            out.append(HostSpec(name=str(name), devices=int(dev)))
    if not out:
        raise ValueError("empty host roster")
    names = [h.name for h in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate host names in roster: {names}")
    return out


_CAS_RE = re.compile(r"^cas/[^/]+/([0-9a-f]{64})$")


def fetch(key: str, src: ObjectStore, dst: ObjectStore) -> str:
    """Copy ``key``'s payload from one host's store to another's.

    The transfer rides the spill surface (bytes on disk), peeked from the
    source so the copy does not disturb its LRU.  For content-addressed
    (``cas/``) keys the payload is re-hashed and must match the digest baked
    into the key — the cross-host integrity check.  Returns the key.
    """
    payload = src.peek(key)  # KeyError if the host never wrote it
    if not isinstance(payload, (bytes, bytearray)):
        raise TypeError(
            f"fetch: {key!r} holds a live object, not spillable bytes")
    payload = bytes(payload)
    m = _CAS_RE.match(key)
    if m is not None:
        digest = hashlib.sha256(payload).hexdigest()
        if digest != m.group(1):
            raise IOError(
                f"fetch: content digest mismatch for {key!r} "
                f"(got {digest[:12]}..., torn or corrupt spill file)")
    dst.put_spilled(payload, key=key)
    return key
