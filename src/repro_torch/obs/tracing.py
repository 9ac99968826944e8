"""Structured tracing — per-trial spans, exported as Chrome trace-event JSON.

A span is one timed control-plane phase of one trial (DESIGN.md §8 taxonomy:
``trial``, ``schedule.decision``, ``slice.acquire``, ``build``, ``step``,
``ckpt.save``, ``ckpt.restore``, ``resize``, ``restart``).  The ``trace`` of a
span is the trial id — every span of a trial's life, across retries, resizes
and even process boundaries (worker children ship their spans back over the
pipe protocol), lands on that trial's timeline row.

Determinism contract: span timestamps and durations are read ONLY from the
injected ``Clock`` (clock.time(), the timestamp axis).  Under a
``VirtualClock`` two identical scenario runs therefore produce *byte-identical*
Chrome exports — ``export_chrome`` canonically sorts events and serializes
with fixed separators to keep that promise.  Real-time profiling numbers
(``time.perf_counter`` deltas) belong in the metrics registry, never here.

The disabled path is one attribute check: ``tracer.enabled`` is False on the
shared null tracer, ``span()`` returns a reused no-op context manager, and
``record``/``begin``/``end`` return immediately.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "NULL_TRACER"]

# JSON-safe span-arg types; anything else is dropped at record time so a
# span can never poison the export (or a SPAN bus event's JSONL record).
_JSON_SCALARS = (int, float, str, bool, type(None))

# Wire format for spans crossing a thread/process boundary (SPAN bus events,
# MSG_SPANS pipe messages): (name, ts, dur, cat, proc, args_dict).
SpanTuple = Tuple[str, float, float, str, str, Dict[str, Any]]


class Span:
    """One completed timed phase.  ``ts``/``dur`` are clock-time seconds."""

    __slots__ = ("name", "trace", "ts", "dur", "cat", "proc", "args")

    def __init__(self, name: str, trace: str, ts: float, dur: float,
                 cat: str = "", proc: str = "host",
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace = trace      # trial id ("" = control plane)
        self.ts = ts
        self.dur = dur
        self.cat = cat
        self.proc = proc        # "host" (runner/worker thread) | "worker" (child process)
        self.args = args or {}

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace!r}, ts={self.ts:.6f}, "
                f"dur={self.dur:.6f}, cat={self.cat!r}, proc={self.proc!r})")


class _NullSpanCtx:
    """Shared no-op context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def arg(self, key: str, value: Any) -> None:
        pass


_NULL_CTX = _NullSpanCtx()


class _SpanCtx:
    """Live ``with tracer.span(...)`` body; ``arg()`` annotates before exit."""

    __slots__ = ("_tracer", "_name", "_trace", "_cat", "_proc", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, trace: str, cat: str,
                 proc: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._trace = trace
        self._cat = cat
        self._proc = proc
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer.clock.time()
        return self

    def arg(self, key: str, value: Any) -> None:
        self._args[key] = value

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._args.setdefault("error", exc_type.__name__)
        self._tracer.record(self._name, self._trace, self._t0,
                            self._tracer.clock.time() - self._t0,
                            cat=self._cat, proc=self._proc, **self._args)
        return False


class Tracer:
    """Thread-safe span collector bound to one injected clock.

    ``record`` appends a finished span; ``span()`` is the context-manager
    form; ``begin``/``end`` bracket phases whose start and finish happen in
    different calls (a trial's lifecycle span opens at launch and closes at
    stop/pause/requeue).  ``adopt`` ingests wire-format tuples that arrived
    over a bus event or a worker pipe.
    """

    def __init__(self, clock: Optional[Any] = None, enabled: bool = True):
        if clock is None:
            from ..core.clock import get_default_clock  # lazy: no import cycle
            clock = get_default_clock()
        self.clock = clock
        self.enabled = enabled
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._open: Dict[Any, Tuple[str, str, str, str, Dict[str, Any], float]] = {}

    # -- recording ----------------------------------------------------------------
    def record(self, name: str, trace: str, ts: float, dur: float,
               cat: str = "", proc: str = "host", **args: Any) -> None:
        if not self.enabled:
            return
        clean = {k: v for k, v in args.items() if isinstance(v, _JSON_SCALARS)}
        with self._lock:
            self._spans.append(Span(name, trace, ts, dur, cat, proc, clean))

    def span(self, name: str, trace: str = "", cat: str = "",
             proc: str = "host", **args: Any):
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, trace, cat, proc, dict(args))

    def begin(self, key: Any, name: str, trace: str, cat: str = "",
              proc: str = "host", **args: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open[key] = (name, trace, cat, proc, dict(args),
                               self.clock.time())

    def end(self, key: Any, **extra: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            rec = self._open.pop(key, None)
        if rec is None:
            return
        name, trace, cat, proc, args, t0 = rec
        args.update(extra)
        self.record(name, trace, t0, self.clock.time() - t0,
                    cat=cat, proc=proc, **args)

    def end_all(self, **extra: Any) -> None:
        with self._lock:
            keys = list(self._open)
        for key in keys:
            self.end(key, **extra)

    def adopt(self, trace: str, spans: List[SpanTuple]) -> None:
        """Ingest wire-format spans shipped from a worker thread/process."""
        if not self.enabled:
            return
        for name, ts, dur, cat, proc, args in spans:
            self.record(name, trace, float(ts), float(dur),
                        cat=str(cat), proc=str(proc), **dict(args))

    # -- introspection ---------------------------------------------------------------
    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()

    # -- Chrome trace-event export (DESIGN.md §8) --------------------------------------
    def chrome_events(self) -> List[Dict[str, Any]]:
        """Canonical trace-event list: metadata rows first, then "X" complete
        events with integer-µs timestamps rebased to the earliest span.

        Canonicalization is what makes identical VirtualClock runs export
        byte-identical files: rows (tids) are assigned from the *sorted* set
        of trace ids, events are sorted by (ts, pid, tid, name, dur), and the
        caller serializes with sorted keys and fixed separators.
        """
        spans = self.spans
        traces = sorted({s.trace for s in spans if s.trace})
        tid_of = {t: i + 1 for i, t in enumerate(traces)}  # tid 0 = control plane
        pid_of = {"host": 1, "worker": 2}
        t0 = min((s.ts for s in spans), default=0.0)
        events: List[Dict[str, Any]] = []
        for pid, label in ((1, "control-plane (host)"), (2, "trial workers (child)")):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": label}})
        for trace, tid in tid_of.items():
            for pid in (1, 2):
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tid, "args": {"name": trace}})
        xs = []
        for s in spans:
            xs.append({
                "ph": "X",
                "name": s.name,
                "cat": s.cat or "span",
                "pid": pid_of.get(s.proc, 1),
                "tid": tid_of.get(s.trace, 0),
                "ts": int(round((s.ts - t0) * 1e6)),
                "dur": max(1, int(round(s.dur * 1e6))),
                "args": dict(sorted(s.args.items())),
            })
        xs.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["name"], e["dur"]))
        return events + xs

    def chrome_json(self) -> str:
        return json.dumps({"displayTimeUnit": "ms",
                           "traceEvents": self.chrome_events()},
                          sort_keys=True, separators=(",", ":")) + "\n"

    def export_chrome(self, path: str) -> str:
        """Write the Perfetto/chrome://tracing-viewable trace; returns path."""
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.chrome_json())
        return path


class _NullClock:
    """Never consulted: the null tracer early-returns before reading time."""

    __slots__ = ()

    def time(self) -> float:  # pragma: no cover — defensive only
        return 0.0


NULL_TRACER = Tracer(clock=_NullClock(), enabled=False)
