"""Resource requests and accounting.

The paper requires "the ability to handle resource requirements of arbitrary
user code" — each trial declares the resources it needs (there: CPUs/GPUs via
Ray; here: host CPUs plus a *device slice* of the TPU mesh).  The executor's
``SlicePool`` (dist/submesh.py) turns ``devices`` into an actual sub-mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Resources", "ResourceAccountant"]


@dataclass(frozen=True)
class Resources:
    cpu: float = 1.0
    devices: int = 1  # number of mesh devices (chips) the trial wants

    def __post_init__(self):
        if self.cpu < 0 or self.devices < 0:
            raise ValueError(f"negative resource request: {self}")


class ResourceAccountant:
    """Tracks committed vs available resources; never goes negative."""

    def __init__(self, total_cpu: float, total_devices: int):
        self.total = Resources(cpu=total_cpu, devices=total_devices)
        self._used_cpu = 0.0
        self._used_devices = 0

    @property
    def available(self) -> Resources:
        return Resources(
            cpu=self.total.cpu - self._used_cpu,
            devices=self.total.devices - self._used_devices,
        )

    def has_room(self, req: Resources) -> bool:
        return (
            self._used_cpu + req.cpu <= self.total.cpu + 1e-9
            and self._used_devices + req.devices <= self.total.devices
        )

    def acquire(self, req: Resources) -> None:
        if not self.has_room(req):
            raise RuntimeError(f"over-commit: {req} on top of used "
                               f"({self._used_cpu} cpu, {self._used_devices} dev)")
        self._used_cpu += req.cpu
        self._used_devices += req.devices

    def release(self, req: Resources) -> None:
        self._used_cpu -= req.cpu
        self._used_devices -= req.devices
        if self._used_cpu < -1e-9 or self._used_devices < 0:
            raise RuntimeError("resource accounting went negative")
        self._used_cpu = max(self._used_cpu, 0.0)
