"""Pluggable time — the clock seam under every timing site (DESIGN.md §7).

Heartbeat timeouts, straggler deadlines, logger flush throttling and elastic
boundaries all used to read ``time.time()`` directly, which welded the test
suite to real wall-clock: exercising a 60s heartbeat meant *waiting* 60s.
This module makes time an injected dependency instead:

- ``Clock`` — the protocol.  ``time()`` is the timestamp axis (epoch-like,
  what event records and loggers show); ``monotonic()`` is the deadline axis
  (never jumps backwards, what timeout arithmetic must use); ``sleep``/
  ``wait_for`` and the factory methods (``event()``/``semaphore()``) are the
  blocking primitives executors park on.
- ``WallClock`` — production: thin veneer over ``time``/``threading``.
- ``VirtualClock`` — a cooperative deterministic scheduler for tests: every
  participating thread registers, all blocking goes through the clock, and
  virtual time advances **only when every registered thread is parked**, to
  the earliest pending deadline.  A 60s heartbeat then fires in microseconds
  of real time, in a deterministic order (repro.testing builds on this).

Cooperative contract for ``VirtualClock`` (violations deadlock or mis-time):
registered threads may block *only* through clock primitives — ``sleep``,
``wait_for``, ``queue_get``, ``join_thread``, and the acquire/wait methods of
objects from ``clock.event()``/``clock.semaphore()``.  A registered thread
that blocks on a bare OS primitive while others sleep stalls the virtual
epoch (time cannot advance — the clock believes the thread is runnable).
State changes made *outside* clock objects that could unblock a waiter must
be announced with ``kick()``.
"""
from __future__ import annotations

import contextlib
import math as _math
import queue as _queue
import threading
import time as _time
from typing import Any, Callable, Dict, Iterator, Optional, Set

__all__ = ["Clock", "WallClock", "VirtualClock", "get_default_clock",
           "set_default_clock", "use_clock"]


class Clock:
    """Time + blocking-primitive provider.  Executors, the event bus, loggers
    and trials read all time through one of these."""

    # -- time axes ------------------------------------------------------------------
    def time(self) -> float:
        """Timestamp axis (epoch-like; event records, logger throttling)."""
        raise NotImplementedError

    def monotonic(self) -> float:
        """Deadline axis: never jumps with wall-clock adjustments.  ALL
        timeout arithmetic (``deadline = monotonic() + timeout``) must use
        this, never ``time()``."""
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def sleep_until(self, t: float) -> None:
        """Park until the timestamp axis reaches ``t``.  The default delegates
        to relative ``sleep``; VirtualClock overrides it to land on ``t``
        *bit-exactly* — ``now + (t - now)`` re-associates the float sum, and
        resume phase targets (DESIGN.md §12) cannot afford the ulp."""
        delay = t - self.time()
        if delay > 0:
            self.sleep(delay)

    # -- blocking primitives ---------------------------------------------------------
    def event(self) -> Any:
        """A ``threading.Event``-compatible object whose ``wait`` parks
        through this clock."""
        raise NotImplementedError

    def semaphore(self, value: int = 1) -> Any:
        """A ``threading.Semaphore``-compatible object whose ``acquire``
        parks through this clock."""
        raise NotImplementedError

    def queue_get(self, q: "_queue.Queue", timeout: float) -> Optional[Any]:
        """Next item from ``q`` or None after ``timeout``; producers that do
        not go through clock objects must ``kick(q)`` after putting."""
        raise NotImplementedError

    def join_thread(self, thread: threading.Thread,
                    timeout: Optional[float] = None) -> bool:
        """Wait for ``thread`` to exit; False on timeout."""
        raise NotImplementedError

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: Optional[float] = None,
                 channel: Any = None) -> bool:
        """Park until ``predicate()`` is true (True) or ``timeout`` elapses
        (False).  ``channel`` scopes wakeups: the waiter is re-checked when
        that channel is kicked (plus on any broadcast ``kick()``)."""
        raise NotImplementedError

    def kick(self, channel: Any = None) -> None:
        """Announce an out-of-band state change to parked waiters: wake the
        waiters on ``channel``, or every predicate waiter when None.  No-op
        on the wall clock, where the OS delivers wakeups."""

    # -- thread participation (virtual determinism bookkeeping) ------------------------
    def register_thread(self) -> None:
        """Mark the calling thread as a participant whose runnability gates
        virtual-time advancement.  No-op on the wall clock."""

    def unregister_thread(self) -> None:
        """Participant is exiting; it no longer gates advancement."""

    @contextlib.contextmanager
    def running(self) -> Iterator[None]:
        """Wrap a participating thread's body: register on entry, unregister
        on exit (even via exception)."""
        self.register_thread()
        try:
            yield
        finally:
            self.unregister_thread()


class WallClock(Clock):
    """Production time: defer everything to ``time``/``threading``."""

    def time(self) -> float:
        return _time.time()

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    def event(self) -> threading.Event:
        return threading.Event()

    def semaphore(self, value: int = 1) -> threading.Semaphore:
        return threading.Semaphore(value)

    def queue_get(self, q: "_queue.Queue", timeout: float) -> Optional[Any]:
        try:
            return q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def join_thread(self, thread: threading.Thread,
                    timeout: Optional[float] = None) -> bool:
        thread.join(timeout)
        return not thread.is_alive()

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: Optional[float] = None,
                 channel: Any = None) -> bool:
        # Rarely used on the wall clock (real code parks on events/queues);
        # poll coarsely as a fallback so misuse degrades instead of spinning.
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            if predicate():
                return True
            if deadline is not None and _time.monotonic() >= deadline:
                return False
            _time.sleep(0.01)


class _VirtualEvent:
    """``threading.Event`` veneer over a VirtualClock (waiters channel on the
    event object itself, so ``set`` wakes exactly them)."""

    def __init__(self, clock: "VirtualClock"):
        self._clock = clock
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        with self._clock._lock:
            self._flag = True
            self._clock._notify_channel(self)

    def clear(self) -> None:
        with self._clock._lock:
            self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._clock.wait_for(lambda: self._flag, timeout, channel=self)


class _VirtualSemaphore:
    """``threading.Semaphore`` veneer over a VirtualClock (waiters channel on
    the semaphore object, so ``release`` wakes exactly them)."""

    def __init__(self, clock: "VirtualClock", value: int):
        self._clock = clock
        self._value = value

    def _try_acquire(self) -> bool:
        # only ever evaluated under the clock lock (wait_for predicate)
        if self._value > 0:
            self._value -= 1
            return True
        return False

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        if not blocking:
            with self._clock._lock:
                return self._try_acquire()
        return self._clock.wait_for(self._try_acquire, timeout, channel=self)

    def release(self, n: int = 1) -> None:
        with self._clock._lock:
            self._value += n
            self._clock._notify_channel(self)


class _Waiter:
    """One parked thread: its private condition (targeted wakeups), absolute
    virtual deadline, wake channel, and whether a wakeup is in flight."""

    __slots__ = ("cv", "deadline", "channel", "is_sleep", "woken")

    def __init__(self, cv: threading.Condition, deadline: Optional[float],
                 channel: Any, is_sleep: bool):
        self.cv = cv
        self.deadline = deadline
        self.channel = channel
        self.is_sleep = is_sleep
        self.woken = False


class VirtualClock(Clock):
    """Deterministic cooperative virtual time.

    One lock serializes all clock state; each parked thread waits on its own
    condition over that lock, so wakeups are *targeted*: a semaphore release
    wakes that semaphore's waiters, an advance wakes only the sleepers whose
    deadline arrived, a ``kick(channel)`` wakes that channel.  Advancement —
    moving ``_now`` to the earliest pending deadline — happens only when
    every registered thread is parked AND none has a wakeup in flight (a
    notified-but-not-yet-scheduled thread is runnable; advancing "around" it
    would, e.g., expire a join timeout against a worker that was about to
    exit).  Unregistered threads may park too — they are woken normally but
    never gate advancement (the process tier's pump thread, which blocks on
    real child pipes, stays unregistered).

    ``time()`` reports ``epoch + now`` so timestamps look wall-ish in logs;
    ``monotonic()`` reports raw virtual seconds.  If every registered thread
    parks with no deadline anywhere, no event can ever fire again — that is a
    harness deadlock and raises RuntimeError in the last thread to park.
    """

    def __init__(self, start: float = 0.0, epoch: float = 1_000_000_000.0,
                 register_creator: bool = True):
        self._lock = threading.Lock()
        self._now = float(start)
        self._epoch = float(epoch)
        self._threads: Set[int] = set()
        self._finished: Set[int] = set()
        self._waiting: Dict[int, _Waiter] = {}
        self._cvs: Dict[int, threading.Condition] = {}  # per-thread, reused
        self.n_advances = 0
        if register_creator:
            self._threads.add(threading.get_ident())

    # -- time axes ------------------------------------------------------------------
    def time(self) -> float:
        with self._lock:
            return self._epoch + self._now

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    # -- participation ----------------------------------------------------------------
    def register_thread(self) -> None:
        with self._lock:
            ident = threading.get_ident()
            self._threads.add(ident)
            self._finished.discard(ident)  # OS thread idents get recycled

    def unregister_thread(self) -> None:
        with self._lock:
            ident = threading.get_ident()
            self._threads.discard(ident)
            self._finished.add(ident)
            # Wake joiners (join_thread channels on the ident), then check
            # whether the *remaining* participants are all parked — this
            # thread leaving may be the event that unblocks time.
            self._notify_channel(ident)
            self._maybe_advance()

    # -- wakeup plumbing (caller holds _lock) ------------------------------------------
    def _wake(self, ident: int, waiter: _Waiter) -> None:
        if not waiter.woken:
            waiter.woken = True
            waiter.cv.notify()

    def _notify_channel(self, channel: Any) -> None:
        for ident, waiter in self._waiting.items():
            # == not `is`: join channels are thread idents (equal ints need
            # not be the same object); all other channels are clock-owned
            # objects whose equality IS identity.
            if waiter.channel is channel or waiter.channel == channel:
                self._wake(ident, waiter)

    def _notify_all_predicates(self) -> None:
        for ident, waiter in self._waiting.items():
            if not waiter.is_sleep:
                self._wake(ident, waiter)

    def kick(self, channel: Any = None) -> None:
        with self._lock:
            if channel is None:
                self._notify_all_predicates()
            else:
                self._notify_channel(channel)

    # -- core park/advance machinery ---------------------------------------------------
    def _maybe_advance(self) -> None:
        """Caller holds ``_lock``.  If every registered thread is parked with
        no wakeup in flight, advance to the earliest deadline and wake the
        sleepers/waiters it expires."""
        if not self._threads:
            return
        for ident in self._threads:
            waiter = self._waiting.get(ident)
            if waiter is None or waiter.woken:
                return  # runnable (or about to be): time must hold still
        deadlines = [w.deadline for w in self._waiting.values()
                     if w.deadline is not None]
        if not deadlines:
            raise RuntimeError(
                "VirtualClock deadlock: every registered thread is parked "
                "with no pending deadline — no event can ever fire.  A "
                "non-clock blocking call or a missing kick() is the usual "
                f"cause (registered={len(self._threads)}, "
                f"parked={len(self._waiting)}, now={self._now:.3f})")
        nxt = min(deadlines)
        if nxt > self._now:
            # Quantize the advance to the timestamp axis: pick the smallest
            # ``now' >= nxt`` for which ``epoch + now'`` is exactly
            # representable.  Timestamps (``time()``) then round-trip losslessly
            # through journals, so a resumed run re-entering the timeline via
            # ``sleep_until(journaled_t)`` lands on the *bit-identical* clock
            # state the original process had (DESIGN.md §12).
            tq = self._epoch + nxt
            q = tq - self._epoch  # exact: Sterbenz (operands within 2x)
            if q < nxt:
                q = _math.nextafter(tq, _math.inf) - self._epoch
            self._now = q
            self.n_advances += 1
        for ident, waiter in self._waiting.items():
            if waiter.deadline is not None and waiter.deadline <= self._now:
                self._wake(ident, waiter)

    def _park_cv(self, ident: int) -> threading.Condition:
        cv = self._cvs.get(ident)
        if cv is None:
            cv = self._cvs[ident] = threading.Condition(self._lock)
        return cv

    def wait_for(self, predicate: Optional[Callable[[], bool]],
                 timeout: Optional[float] = None,
                 channel: Any = None) -> bool:
        """``predicate=None`` is a pure sleep: immune to kicks, woken only by
        time reaching its deadline."""
        me = threading.get_ident()
        with self._lock:
            cv = self._park_cv(me)
            deadline = None if timeout is None else self._now + max(0.0, timeout)
            while True:
                if predicate is not None and predicate():
                    return True
                if deadline is not None and self._now >= deadline:
                    return False
                waiter = _Waiter(cv, deadline, channel, predicate is None)
                self._waiting[me] = waiter
                try:
                    self._maybe_advance()
                    if waiter.woken:
                        continue  # the advance expired/woke us: re-check now
                    cv.wait()
                finally:
                    self._waiting.pop(me, None)

    def sleep(self, seconds: float) -> None:
        self.wait_for(None, timeout=max(0.0, seconds))

    def sleep_until(self, t: float) -> None:
        # A pure sleep whose deadline is the absolute target itself, not
        # now + delta: the advance then sets _now to exactly t - epoch.
        me = threading.get_ident()
        with self._lock:
            cv = self._park_cv(me)
            deadline = t - self._epoch
            while self._now < deadline:
                waiter = _Waiter(cv, deadline, None, True)
                self._waiting[me] = waiter
                try:
                    self._maybe_advance()
                    if waiter.woken:
                        continue
                    cv.wait()
                finally:
                    self._waiting.pop(me, None)

    # -- blocking primitives -----------------------------------------------------------
    def event(self) -> _VirtualEvent:
        return _VirtualEvent(self)

    def semaphore(self, value: int = 1) -> _VirtualSemaphore:
        return _VirtualSemaphore(self, value)

    def queue_get(self, q: "_queue.Queue", timeout: float) -> Optional[Any]:
        got = []

        def pred() -> bool:
            if got:
                return True
            try:
                got.append(q.get_nowait())
                return True
            except _queue.Empty:
                return False

        if self.wait_for(pred, timeout, channel=q):
            return got[0]
        return None

    def join_thread(self, thread: threading.Thread,
                    timeout: Optional[float] = None) -> bool:
        ident = thread.ident

        def exited() -> bool:
            return not thread.is_alive() or ident in self._finished

        if not self.wait_for(exited, timeout, channel=ident):
            return False
        # The participant already unregistered (its last act); the OS thread
        # has at most a few instructions left — settle it for real.
        thread.join()
        return True

    def debug_string(self) -> str:
        with self._lock:
            return (f"VirtualClock(now={self._now:.3f}, "
                    f"registered={len(self._threads)}, "
                    f"parked={len(self._waiting)}, advances={self.n_advances})")


# -- default clock ---------------------------------------------------------------------
# Construction-time seam: components take ``clock=None`` and fall back to this
# module default, so a test can place an entire stack (executors, bus, trials,
# loggers) on virtual time with one ``use_clock(...)`` block.
_DEFAULT = WallClock()
_default_clock: Clock = _DEFAULT


def get_default_clock() -> Clock:
    return _default_clock


def set_default_clock(clock: Optional[Clock]) -> Clock:
    """Install ``clock`` (None restores the wall clock); returns the previous
    default so callers can put it back."""
    global _default_clock
    prev = _default_clock
    _default_clock = clock if clock is not None else _DEFAULT
    return prev


@contextlib.contextmanager
def use_clock(clock: Clock) -> Iterator[Clock]:
    """Scoped default-clock override (the repro.testing harness entry)."""
    prev = set_default_clock(clock)
    try:
        yield clock
    finally:
        set_default_clock(prev)
