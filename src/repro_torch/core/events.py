"""Typed trial events on a thread-safe bus — the async execution substrate.

The paper's runner is event-based (§4.2): schedulers react to intermediate
results as they arrive, not in lockstep.  With one executor thread that was
implicit — ``get_next_result()`` polled.  Once trials step concurrently on
worker threads (concurrent_executor.py), events need an explicit carrier:

- ``TrialEvent`` — a typed record (RESULT / ERROR / CHECKPOINTED /
  HEARTBEAT_MISSED / RESTARTED) tagged with the trial id and a bus-assigned
  monotone sequence number.
- ``EventBus`` — a thread-safe FIFO.  ``publish`` is callable from any worker
  thread; sequence assignment and enqueue are atomic, so consumers observe
  events in exactly the order they were sequenced (the ordering contract the
  runner's bookkeeping and the JSONL event log rely on).

Only RESULT and ERROR drive scheduler decisions; the rest are observability
events the runner forwards to loggers (DESIGN.md §4).
"""
from __future__ import annotations

import enum
import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from time import perf_counter as _perf

from .clock import Clock, get_default_clock
from .trial import Checkpoint, Result

__all__ = ["EventType", "TrialEvent", "EventBus"]


class EventType(str, enum.Enum):
    RESULT = "RESULT"                      # an intermediate (or final) Result
    ERROR = "ERROR"                        # trainable raised; error carries the traceback
    CHECKPOINTED = "CHECKPOINTED"          # a periodic checkpoint was written
    HEARTBEAT_MISSED = "HEARTBEAT_MISSED"  # a step exceeded the straggler timeout
    RESTARTED = "RESTARTED"                # trial re-queued for restart-from-checkpoint
    KILLED = "KILLED"                      # straggling worker process SIGKILLed (DESIGN.md §5)
    RESIZED = "RESIZED"                    # elastic slice resize applied (DESIGN.md §6)
    RESIZE_FAILED = "RESIZE_FAILED"        # resize rejected/rolled back; trial keeps its old slice
    CREDITS = "CREDITS"                    # lookahead credit grant changed for a trial
    SPAN = "SPAN"                          # batch of trace spans from a worker (repro_torch.obs)
    PROFILE = "PROFILE"                    # per-trial hardware profile (repro_torch.obs, §9)
    DECISION = "DECISION"                  # scheduler/searcher verdict + inputs (DESIGN.md §10)


@dataclass
class TrialEvent:
    type: EventType
    trial_id: str
    result: Optional[Result] = None        # RESULT
    error: Optional[str] = None            # ERROR (formatted traceback)
    checkpoint: Optional[Checkpoint] = None  # CHECKPOINTED
    info: Dict[str, Any] = field(default_factory=dict)
    # Stamped by the bus on publish (or by whoever hands the event straight
    # to a logger); None = "not yet stamped", loggers fall back to their own
    # clock so an unstamped event still gets a usable time.
    timestamp: Optional[float] = None
    seq: int = -1                          # assigned by the bus on publish
    # Real (perf_counter) publish stamp, set only when the bus carries a
    # metrics registry: fan-in latency = how long an event sat queued before
    # the runner drained it.  Profiling only — never on the virtual axis.
    _mono_pub: Optional[float] = None


class EventBus:
    """Thread-safe FIFO of ``TrialEvent``s with atomic sequence numbering.

    Multiple producers (executor worker threads, the heartbeat monitor) and a
    single consumer (the runner's event loop).  ``publish`` holds one lock
    across seq assignment *and* enqueue, so ``seq`` order equals delivery
    order even under concurrent publishers.

    All timing runs through the injected ``Clock`` (DESIGN.md §7): publish
    stamps ``event.timestamp`` from it, blocking ``get`` parks through it (so
    a consumer on a ``VirtualClock`` wakes in virtual time), and publish
    ``kick``s the clock so parked virtual waiters re-check the queue.
    """

    def __init__(self, maxsize: int = 0, clock: Optional[Clock] = None,
                 metrics: Optional[Any] = None):
        self._q: "queue.Queue[TrialEvent]" = queue.Queue(maxsize=maxsize)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.clock = clock or get_default_clock()
        self.n_published = 0
        # Hot-path discipline (repro_torch.obs): resolve instruments once; with no
        # registry every publish/get pays a single None test.
        if metrics is not None:
            self._m_pub = metrics.counter("bus.published")
            self._m_depth = metrics.gauge("bus.depth")
            self._m_fanin = metrics.histogram("bus.fanin_us")
        else:
            self._m_pub = self._m_depth = self._m_fanin = None

    def publish(self, event: TrialEvent) -> TrialEvent:
        with self._lock:
            event.seq = next(self._seq)
            if event.timestamp is None:
                event.timestamp = self.clock.time()
            self._q.put(event)
            self.n_published += 1
        if self._m_pub is not None:
            self._m_pub.inc()
            self._m_depth.set(self._q.qsize())
            event._mono_pub = _perf()
        self.clock.kick(self._q)  # wake a virtual consumer parked on this queue
        return event

    def get(self, timeout: Optional[float] = None) -> Optional[TrialEvent]:
        """Next event, or None after ``timeout`` seconds (None = non-blocking)."""
        if timeout is not None:
            ev = self.clock.queue_get(self._q, timeout)
        else:
            try:
                ev = self._q.get_nowait()
            except queue.Empty:
                return None
        if ev is not None and self._m_fanin is not None and ev._mono_pub is not None:
            self._m_fanin.observe((_perf() - ev._mono_pub) * 1e6)
        return ev

    def drain(self) -> List[TrialEvent]:
        """All currently queued events, in order, without blocking."""
        out: List[TrialEvent] = []
        while True:
            ev = self.get()
            if ev is None:
                return out
            out.append(ev)

    def __len__(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()
