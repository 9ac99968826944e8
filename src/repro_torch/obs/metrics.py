"""Metrics registry — counters, gauges, histograms; zero external deps.

The control plane wants aggregates ("how deep does the bus queue get", "what
is the p99 of a first-fit scan"), not a sample stream, so every instrument
keeps O(1) state.  Histograms bucket by power-of-two exponent (``math.frexp``)
— enough resolution to tell a 5µs first-fit from a 5ms one without storing
samples, and quantile estimates come from the bucket boundaries.

Instruments are updated from worker threads and the runner thread alike, so
each carries its own (uncontended, ~100ns) lock; the registry itself is
create-on-first-use under a registry lock.  Hot-path discipline: call sites
resolve the instrument ONCE (``registry.histogram("x")`` at init) and guard
each observation with ``if m is not None`` — with observability off there is
no registry and the per-event cost is a single attribute test.

Values observed here may come from ``time.perf_counter()`` (real host
latency): metrics are a *profiling* surface and are NOT required to be
deterministic under a VirtualClock — that guarantee belongs to the tracer
(tracing.py), which only ever stamps from the injected clock.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotone event count."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> Any:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, pool utilization)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Any:
        return self.value


class Histogram:
    """count/sum/min/max plus power-of-two buckets for quantile estimates.

    ``observe`` takes any non-negative value (µs latencies, byte sizes,
    seconds of heartbeat lag).  Bucket ``e`` holds values in ``[2^(e-1), 2^e)``
    — ``percentile`` answers from the upper boundary, so estimates are
    conservative (never under-report a tail).
    """

    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max", "_buckets")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        e = math.frexp(v)[1] if v > 0 else 0  # v in [2^(e-1), 2^e)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._buckets[e] = self._buckets.get(e, 0) + 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float:
        """Upper-boundary estimate of the q-th percentile (q in [0, 100])."""
        with self._lock:
            if not self._count:
                return 0.0
            target = max(1, math.ceil(self._count * q / 100.0))
            seen = 0
            for e in sorted(self._buckets):
                seen += self._buckets[e]
                if seen >= target:
                    return min(float(2 ** e), self._max)
            return self._max

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if not self._count:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "mean": 0.0}
            return {"count": self._count,
                    "sum": round(self._sum, 6),
                    "min": round(self._min, 6),
                    "max": round(self._max, 6),
                    "mean": round(self._sum / self._count, 6)}


class MetricsRegistry:
    """Named instruments, created on first use, snapshotted as one dict.

    Names are dotted (``bus.fanin_us``, ``pool.acquire_us``, ``trials.
    restarts``) — see DESIGN.md §8 for the full catalogue.  Asking for an
    existing name with a different instrument kind raises: a silent kind
    change would corrupt every dashboard reading the snapshot stream.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls: type) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Any]:
        """``{name: value-or-aggregate-dict}`` for every instrument."""
        with self._lock:
            instruments = list(self._instruments.values())
        return {inst.name: inst.snapshot() for inst in instruments}

    def snapshot_line(self, t: float, schema_version: int = 1) -> str:
        """One JSONL metrics-stream record (loggers/DESIGN.md §8)."""
        return json.dumps({"t": t, "schema_version": schema_version,
                           "metrics": self.snapshot()},
                          sort_keys=True, separators=(",", ":"))
