"""repro_torch.cluster — the multi-host tier (DESIGN.md §11).

Layering: ``repro_torch.core`` never imports this package.  The worker command loop
(``core.workers._child_main``) and the executor pump are transport-agnostic by
duck typing — anything with ``send/recv/poll/close`` works — and this package
supplies the non-pipe transports plus the host-roster executor that schedules
trials across per-host SlicePools.

Public surface:

- ``Transport`` errors + ``SocketTransport`` / ``VirtualTransport`` framing
  (``repro_torch.cluster.transport``)
- ``HostSpec`` / ``HostAgent`` / ``parse_hosts`` roster (``repro_torch.cluster.hosts``)
- ``FixedPlacement`` / ``RooflinePlacement`` (``repro_torch.cluster.placement``)
- ``ClusterMeshExecutor`` (``repro_torch.cluster.executor``)
- ``SimFleet`` scripted host faults under VirtualClock (``repro_torch.cluster.sim``)
"""
from .transport import (FramingError, SocketTransport, TransportClosed,
                        TransportError, VirtualTransport, virtual_pair)
from .hosts import HostAgent, HostSpec, parse_hosts
from .placement import FixedPlacement, RooflinePlacement
from .executor import ClusterMeshExecutor

__all__ = [
    "TransportError", "TransportClosed", "FramingError",
    "SocketTransport", "VirtualTransport", "virtual_pair",
    "HostSpec", "HostAgent", "parse_hosts",
    "FixedPlacement", "RooflinePlacement",
    "ClusterMeshExecutor",
]
