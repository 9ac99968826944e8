"""repro_torch.obs — control-plane observability (DESIGN.md §8).

One clock-injected bundle threaded through the whole stack:

- ``Tracer`` (tracing.py) — per-trial spans for every lifecycle phase,
  deterministic under a ``VirtualClock``, exported as Chrome trace-event JSON.
- ``MetricsRegistry`` (metrics.py) — counters/gauges/histograms over the hot
  paths (EventBus fan-in, SlicePool first-fit, scheduler decisions,
  checkpoint bytes+latency, heartbeat lag, restarts/kills/resizes),
  snapshotted periodically to a JSONL metrics stream.

``Observability`` owns both plus the snapshot throttle; ``NULL_OBS`` is the
shared disabled instance every component defaults to — its ``active`` flag is
False and every method early-returns, so with observability off the per-event
cost is one attribute test (the bench_overhead acceptance gate).

This package imports nothing from ``repro_torch.core`` at module level (clock
defaults resolve lazily), so ``repro_torch.core`` modules can import it without a
cycle.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .analysis import ExperimentAnalysis, TrialRecord
from .flightrec import FlightRecorder, SearchStateSnapshotter, json_safe
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import NULL_TRACER, Span, Tracer

__all__ = ["Observability", "NULL_OBS",
           "Tracer", "Span", "NULL_TRACER",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "ExperimentAnalysis", "TrialRecord",
           "FlightRecorder", "SearchStateSnapshotter", "json_safe"]

METRICS_SCHEMA_VERSION = 1


class Observability:
    """Tracer + metrics registry + periodic JSONL metrics snapshots.

    - ``trace``: falsy = tracing off; True = collect spans in memory; a path
      string = collect AND export Chrome trace-event JSON there on ``close()``.
    - ``metrics``: falsy = metrics off; True = registry only (queried in
      process); a path string = registry + JSONL snapshot stream at that path,
      flushed every ``metrics_interval`` clock-seconds (plus a final snapshot
      on close).

    All throttling runs on the injected clock's timestamp axis, so a
    VirtualClock run snapshots on virtual seconds.  The heavyweight samplers
    (pool utilization, bus depth) run only inside ``snapshot`` — never per
    event.
    """

    def __init__(self, trace: Any = None, metrics: Any = None,
                 metrics_interval: float = 10.0,
                 clock: Optional[Any] = None):
        if clock is None:
            from ..core.clock import get_default_clock  # lazy: no import cycle
            clock = get_default_clock()
        self.clock = clock
        self.trace_path: Optional[str] = trace if isinstance(trace, str) else None
        self.tracer = Tracer(clock=clock, enabled=bool(trace))
        self.metrics: Optional[MetricsRegistry] = \
            MetricsRegistry() if metrics else None
        self.metrics_path: Optional[str] = \
            metrics if isinstance(metrics, str) else None
        self.metrics_interval = float(metrics_interval)
        self.active = bool(trace) or bool(metrics)
        self._snap_lock = threading.Lock()
        self._next_snap: Optional[float] = None
        self._mfile = None
        self._closed = False
        # Pre-resolved instruments for the event-routing hot path.
        if self.metrics is not None:
            self._m_hb_lag = self.metrics.histogram("hb.lag_s")
            self._m_ckpt_bytes = self.metrics.histogram("ckpt.bytes")
            self._event_counters: Dict[Any, Counter] = {}
        else:
            self._m_hb_lag = self._m_ckpt_bytes = None
            self._event_counters = {}

    def bind_clock(self, clock: Any) -> None:
        """Rebind the bundle (and its tracer) onto ``clock``.  Harnesses that
        construct the Observability before installing a VirtualClock (e.g.
        ``run_scenario``) call this so every span timestamp rides the virtual
        time axis — the precondition for byte-identical trace exports."""
        self.clock = clock
        self.tracer.clock = clock

    # -- event routing (runner thread) -------------------------------------------------
    def on_event(self, event: Any) -> None:
        """Every TrialEvent the runner drains flows through here: count it,
        fold special payloads into metrics, adopt shipped SPAN batches."""
        if not self.active:
            return
        kind = getattr(getattr(event, "type", None), "value", None)
        if self.metrics is not None and kind is not None:
            ctr = self._event_counters.get(kind)
            if ctr is None:
                ctr = self._event_counters[kind] = \
                    self.metrics.counter(f"events.{kind.lower()}")
            ctr.inc()
            if kind == "HEARTBEAT_MISSED":
                stalled = event.info.get("stalled_s")
                if stalled is not None:
                    self._m_hb_lag.observe(float(stalled))
        if kind == "SPAN":
            spans = event.info.get("spans", ())
            if self.tracer.enabled:
                self.tracer.adopt(event.trial_id, spans)
            if self.metrics is not None:
                for sp in spans:
                    nbytes = sp[5].get("bytes") if len(sp) > 5 else None
                    if nbytes is not None:
                        self._m_ckpt_bytes.observe(float(nbytes))

    # -- metrics snapshot stream --------------------------------------------------------
    def maybe_snapshot(self, executor: Any = None) -> bool:
        """Throttled snapshot; call freely from the runner loop."""
        if self.metrics is None or self.metrics_path is None:
            return False
        now = self.clock.time()
        with self._snap_lock:
            if self._next_snap is not None and now < self._next_snap:
                return False
            self._next_snap = now + self.metrics_interval
        self.snapshot(executor)
        return True

    def sample(self, executor: Any = None) -> None:
        """Point-in-time gauges that are too costly to maintain per event."""
        if self.metrics is None:
            return
        if executor is not None:
            bus = getattr(executor, "bus", None)
            if bus is not None:
                self.metrics.gauge("bus.depth").set(len(bus))
            pool = getattr(executor, "slice_pool", None)
            if pool is not None:
                self.metrics.gauge("pool.utilization").set(
                    round(pool.utilization(), 4))
                self.metrics.gauge("pool.fragments").set(pool.fragments())

    def snapshot(self, executor: Any = None) -> None:
        if self.metrics is None or self.metrics_path is None or self._closed:
            return
        self.sample(executor)
        if self._mfile is None:
            import os
            os.makedirs(os.path.dirname(self.metrics_path) or ".",
                        exist_ok=True)
            self._mfile = open(self.metrics_path, "w")
        self._mfile.write(self.metrics.snapshot_line(
            self.clock.time(), METRICS_SCHEMA_VERSION) + "\n")
        self._mfile.flush()

    # -- teardown ------------------------------------------------------------------
    def close(self, executor: Any = None) -> None:
        """Final metrics snapshot + Chrome trace export (when paths are set)."""
        if self._closed:
            return
        self.tracer.end_all()
        self.snapshot(executor)
        self._closed = True
        if self._mfile is not None:
            self._mfile.close()
            self._mfile = None
        if self.trace_path and self.tracer.enabled:
            self.tracer.export_chrome(self.trace_path)


class _NullObservability(Observability):
    """The shared disabled bundle: ``active`` False, tracer disabled, no
    registry — every guard in the hot paths reduces to one attribute test."""

    def __init__(self):
        self.clock = None
        self.trace_path = None
        self.tracer = NULL_TRACER
        self.metrics = None
        self.metrics_path = None
        self.metrics_interval = 0.0
        self.active = False
        self._snap_lock = threading.Lock()
        self._next_snap = None
        self._mfile = None
        self._closed = False
        self._m_hb_lag = self._m_ckpt_bytes = None
        self._event_counters = {}

    def on_event(self, event: Any) -> None:
        pass

    def maybe_snapshot(self, executor: Any = None) -> bool:
        return False

    def snapshot(self, executor: Any = None) -> None:
        pass

    def close(self, executor: Any = None) -> None:
        pass


NULL_OBS = _NullObservability()
