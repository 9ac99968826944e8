"""Crash-forensics flight recorder + searcher-state snapshots (DESIGN.md §10).

``FlightRecorder`` keeps bounded ring buffers of the last N bus events and the
last N DECISION records.  Recording is append-only and cheap (one deque append
per event — sanitization is deferred to dump time); on a controller exception,
SIGTERM, or a ``max_experiment_failures`` abort it dumps a self-contained
forensic bundle: ring contents, scheduler/searcher ``state_dict()``, the
active trial table, pool/queue stats, and failure counters.  Everything in
the bundle rides the injected clock's axis and is serialized with sorted keys,
so two identical-token VirtualClock runs dump byte-identical bundles (the same
comparability contract as traces and analysis summaries).

``SearchStateSnapshotter`` checkpoints scheduler+searcher state to a JSON file
on the same clock-throttle pattern as the metrics snapshot stream — the raw
material for durable resume (ROADMAP: crash-tolerant controller).

This module imports nothing from ``repro_torch.core`` (the runner imports us), so
there is no import cycle.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "SearchStateSnapshotter", "json_safe",
           "load_search_state"]

FLIGHTREC_SCHEMA_VERSION = 1
SEARCH_STATE_SCHEMA_VERSION = 2


def _strict_default(obj: Any) -> Any:
    """``json.dumps`` default for search-state snapshots: numpy scalars
    collapse to their Python value, everything else is an error.

    Unlike forensic dumps (``json_safe`` + ``default=repr``), resume state
    must round-trip exactly — a repr'd tuple or RNG word is silent data
    corruption that only surfaces as wrong verdicts after resume, so any
    state_dict() that is not JSON-clean fails loudly at write time.
    """
    fn = getattr(obj, "item", None)
    if callable(fn):
        return fn()  # numpy scalar (arrays of size>1 raise, which we want)
    raise TypeError(
        f"search-state snapshot is not JSON-clean: {type(obj).__name__}: "
        f"{obj!r}")


def json_safe(obj: Any, depth: int = 0) -> Any:
    """Best-effort coercion to JSON-serializable values.

    Decision inputs and event payloads may hold numpy scalars or arbitrary
    objects (a PBT-mutated config value, a Checkpoint); forensic dumps and
    journaling must never crash on them, so anything unknown goes to repr.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if depth > 8:
        # deep enough for every scheduler state_dict (ASHA rung pairs nest 5
        # levels); the cap only guards true pathologies (cyclic/huge graphs)
        return repr(obj)
    if isinstance(obj, dict):
        return {str(k): json_safe(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v, depth + 1) for v in obj]
    fn = getattr(obj, "item", None)  # numpy scalars
    if callable(fn):
        try:
            return json_safe(fn(), depth + 1)
        except Exception:
            pass
    return repr(obj)


class FlightRecorder:
    """Bounded ring buffer over bus events + decisions with forensic dumps.

    - ``record_event`` / ``record_decision``: O(1) deque appends on the runner
      thread; no serialization happens until a dump.
    - ``dump``: write the bundle to ``out_dir/<run_id>-<seq>-<reason>.json``.
      The filename carries a per-recorder dump counter so repeated dumps
      (e.g. SIGTERM during an abort path) never collide.
    - ``install_signal_handler``: dump on SIGTERM then exit 143 via
      ``SystemExit`` so ``finally`` blocks still run.  Main thread only
      (returns False elsewhere — worker threads can't own signal handlers).
    """

    def __init__(self, capacity: int = 512, decision_capacity: int = 256,
                 clock: Optional[Any] = None, run_id: Optional[str] = None,
                 out_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self.decision_capacity = int(decision_capacity)
        self.clock = clock
        self.run_id = run_id or "run-unknown"
        self.out_dir = out_dir or "flightrec"
        self._events: "deque[Any]" = deque(maxlen=self.capacity)
        self._decisions: "deque[Any]" = deque(maxlen=self.decision_capacity)
        self._dump_seq = 0
        self._prev_handlers: Dict[int, Any] = {}
        self.n_events_seen = 0

    def bind_clock(self, clock: Any) -> None:
        self.clock = clock

    # -- recording (runner thread, hot path) ------------------------------------
    def record_event(self, event: Any) -> None:
        self._events.append(event)
        self.n_events_seen += 1

    def record_decision(self, event: Any) -> None:
        self._decisions.append(event)

    # -- bundle assembly ---------------------------------------------------------
    @staticmethod
    def _event_row(ev: Any) -> Dict[str, Any]:
        kind = getattr(getattr(ev, "type", None), "value", None) or "?"
        row: Dict[str, Any] = {
            "type": kind,
            "trial_id": getattr(ev, "trial_id", None),
            "seq": getattr(ev, "seq", -1),
            "t": getattr(ev, "timestamp", None),
        }
        info = getattr(ev, "info", None)
        if info:
            row["info"] = json_safe(info)
        result = getattr(ev, "result", None)
        if result is not None:
            row["iteration"] = getattr(result, "training_iteration", None)
        error = getattr(ev, "error", None)
        if error:
            row["error"] = str(error)[-500:]
        return row

    def bundle(self, runner: Any = None, executor: Any = None,
               reason: str = "abort") -> Dict[str, Any]:
        """Assemble the forensic bundle as a plain dict (JSON-safe)."""
        out: Dict[str, Any] = {
            "schema_version": FLIGHTREC_SCHEMA_VERSION,
            "run_id": self.run_id,
            "reason": reason,
            "t_virtual": self.clock.time() if self.clock is not None else None,
            "n_events_seen": self.n_events_seen,
            "events": [self._event_row(e) for e in self._events],
            "decisions": [self._event_row(e) for e in self._decisions],
        }
        sched = getattr(runner, "scheduler", None)
        if sched is not None and hasattr(sched, "state_dict"):
            try:
                out["scheduler"] = {"type": type(sched).__name__,
                                    "state": json_safe(sched.state_dict())}
            except Exception as e:  # a dump must never fail on state capture
                out["scheduler"] = {"type": type(sched).__name__,
                                    "error": repr(e)}
        else:
            out["scheduler"] = None
        searcher = getattr(runner, "searcher", None)
        if searcher is not None and hasattr(searcher, "state_dict"):
            try:
                out["searcher"] = {"type": type(searcher).__name__,
                                   "state": json_safe(searcher.state_dict())}
            except Exception as e:
                out["searcher"] = {"type": type(searcher).__name__,
                                   "error": repr(e)}
        else:
            out["searcher"] = None
        trials = getattr(runner, "trials", None)
        if trials is not None:
            table = []
            counts: Dict[str, int] = {}
            for t in trials:
                status = getattr(getattr(t, "status", None), "value", "?")
                counts[status] = counts.get(status, 0) + 1
                table.append({
                    "trial_id": t.trial_id,
                    "status": status,
                    "iteration": getattr(t, "training_iteration", None),
                    "failures": getattr(t, "num_failures", 0),
                })
            table.sort(key=lambda r: r["trial_id"])
            out["trials"] = table
            out["status_counts"] = counts
            out["n_errors"] = getattr(runner, "n_errors", None)
            out["n_restarts"] = getattr(runner, "n_restarts", None)
        if executor is not None:
            bus = getattr(executor, "bus", None)
            pool = getattr(executor, "slice_pool", None)
            out["bus_depth"] = len(bus) if bus is not None else None
            out["pool"] = ({
                "utilization": round(pool.utilization(), 4),
                "fragments": pool.fragments(),
            } if pool is not None else None)
            host_state = getattr(executor, "host_state", None)
            if callable(host_state):
                try:
                    out["hosts"] = host_state()
                except Exception:  # noqa: BLE001 — forensics must not raise
                    out["hosts"] = None
        return out

    # -- dumping -----------------------------------------------------------------
    def dump(self, runner: Any = None, executor: Any = None,
             reason: str = "abort") -> str:
        """Write the bundle; returns the written path.

        Sorted keys + compact separators: same run -> byte-identical file.
        """
        bundle = self.bundle(runner=runner, executor=executor, reason=reason)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir, f"{self.run_id}-{self._dump_seq:02d}-{reason}.json")
        self._dump_seq += 1
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, sort_keys=True, separators=(",", ":"),
                      default=repr)
            f.write("\n")
        os.replace(tmp, path)
        return path

    # -- SIGTERM wiring ----------------------------------------------------------
    def install_signal_handler(self, runner: Any = None,
                               executor: Any = None) -> bool:
        """Dump a ``sigterm`` bundle on SIGTERM, then SystemExit(143) so the
        caller's ``finally`` path still runs.  Returns False off-main-thread
        (signal handlers are a main-thread-only facility)."""
        import signal

        def _handler(signum, frame):
            try:
                self.dump(runner=runner, executor=executor, reason="sigterm")
            finally:
                raise SystemExit(143)

        try:
            self._prev_handlers[signal.SIGTERM] = signal.signal(
                signal.SIGTERM, _handler)
            return True
        except ValueError:
            return False

    def remove_signal_handler(self) -> None:
        import signal
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers.clear()


class SearchStateSnapshotter:
    """Clock-throttled scheduler+searcher state checkpoints (DESIGN.md §10).

    Same throttle pattern as ``Observability.maybe_snapshot``: call freely
    from the runner loop; at most one snapshot per ``interval_s`` clock
    seconds.  Writes are atomic (tmp + replace) so a crash mid-write never
    leaves a torn snapshot — the file always holds the last complete state.
    """

    def __init__(self, path: str, clock: Optional[Any] = None,
                 interval_s: float = 10.0,
                 watermark_fn: Optional[Any] = None):
        if clock is None:
            from ..core.clock import get_default_clock  # lazy: no import cycle
            clock = get_default_clock()
        self.path = path
        self.clock = clock
        self.interval_s = float(interval_s)
        # Called at snapshot time; returns the number of journal records the
        # captured state has already been fed (the resume replay watermark).
        self.watermark_fn = watermark_fn
        self._lock = threading.Lock()
        self._next: Optional[float] = None
        self.n_snapshots = 0

    def bind_clock(self, clock: Any) -> None:
        self.clock = clock

    def maybe_snapshot(self, scheduler: Any, searcher: Any = None) -> bool:
        now = self.clock.time()
        with self._lock:
            if self._next is not None and now < self._next:
                return False
            self._next = now + self.interval_s
        self.snapshot(scheduler, searcher)
        return True

    def snapshot(self, scheduler: Any, searcher: Any = None) -> None:
        watermark = None
        if self.watermark_fn is not None:
            watermark = int(self.watermark_fn())
        state: Dict[str, Any] = {
            "schema_version": SEARCH_STATE_SCHEMA_VERSION,
            "t": self.clock.time(),
            "journal_records": watermark,
            "scheduler": ({"type": type(scheduler).__name__,
                           "state": scheduler.state_dict()}
                          if scheduler is not None
                          and hasattr(scheduler, "state_dict") else None),
            "searcher": ({"type": type(searcher).__name__,
                          "state": searcher.state_dict()}
                         if searcher is not None
                         and hasattr(searcher, "state_dict") else None),
        }
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, sort_keys=True, separators=(",", ":"),
                      default=_strict_default)
            f.write("\n")
        os.replace(tmp, self.path)
        self.n_snapshots += 1


def load_search_state(path: str) -> Optional[Dict[str, Any]]:
    """Read a ``search_state.json`` snapshot; None when missing or corrupt.

    Writes are atomic (tmp + replace) so corruption should never happen, but
    resume must degrade to journal-only replay rather than crash on a bad
    file.
    """
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return None
    return state if isinstance(state, dict) else None
