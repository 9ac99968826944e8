"""Simulated host fleet under VirtualClock (DESIGN.md §11).

Before a single real socket is trusted, every cluster failure mode must be
rehearsable deterministically: ``VirtualWorker`` runs the *unchanged* worker
command loop (``core.workers._child_main``) in a clock-registered thread over
a ``VirtualTransport`` pair, and ``SimFleet`` scripts host faults on the
virtual timeline:

- **crash**: the host goes dark instantly — every worker link drops with EOF
  (``ClusterMeshExecutor.fail_host``), the pump errors each resident trial,
  max_failures restarts them elsewhere.
- **partition**: frames in BOTH directions silently stall (no EOF — exactly
  like a real partition) and the host's heartbeat touches stop; nothing
  detects it except monotonic heartbeat age, which escalates to host
  eviction at ``host_timeout``.  A heal *before* the timeout replays the
  buffered frames in order (TCP retransmission over a surviving
  connection), so a short blip costs latency, not work.

The fleet's heartbeat thread stands in for per-host agent daemons: it touches
every alive, un-partitioned host on a cadence, so a healthy-but-idle host
never ages into eviction while a partitioned one does.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.workers import TrainableFactory, _child_main
from .transport import virtual_pair

__all__ = ["SimNetwork", "SimFleet", "VirtualWorker"]


class _FakeProcess:
    """Just enough of the mp.Process surface for the executor's death path
    (``exitcode`` in ERROR events, ``pid`` in KILLED events)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.exitcode: Optional[int] = None


class SimNetwork:
    """Partition state shared by every virtual link in the fleet.

    While a host is partitioned its frames vanish *silently* in both
    directions — the defining property of a partition is that neither side
    learns anything.  The frames are buffered, not destroyed: on ``heal``
    they are replayed in send order, which is what surviving TCP connections
    do after a blip (retransmission).  A host evicted *during* the partition
    never gets its backlog — its links were closed with the eviction, and
    ``deliver`` drops frames for closed endpoints on the floor.
    """

    def __init__(self) -> None:
        self._partitioned: Set[str] = set()
        self._lock = threading.Lock()
        self._buffered: Dict[str, List[Tuple[Any, Any]]] = {}
        self.n_dropped = 0
        self.n_replayed = 0

    def partition(self, host: str) -> None:
        with self._lock:
            self._partitioned.add(host)

    def heal(self, host: str) -> None:
        with self._lock:
            self._partitioned.discard(host)
            backlog = self._buffered.pop(host, [])
        for endpoint, obj in backlog:
            if endpoint.deliver(obj):
                with self._lock:
                    self.n_replayed += 1

    def is_partitioned(self, host: str) -> bool:
        with self._lock:
            return host in self._partitioned

    def drop_filter(self, host: str):
        def _drop(endpoint: Any, obj: Any) -> bool:
            with self._lock:
                if host not in self._partitioned:
                    return False
                self.n_dropped += 1
                self._buffered.setdefault(host, []).append((endpoint, obj))
            return True
        return _drop


class VirtualWorker:
    """In-process stand-in for a worker process: the real ``_child_main``
    loop in a clock-registered thread over a virtual link.

    Mirrors the ``ProcessWorker`` surface the executor relies on
    (``transport`` / ``send`` / ``kill`` / ``join`` / ``close`` / ``alive`` /
    ``pid`` / ``process.exitcode``) plus ``die()`` — the *crash* primitive:
    the link drops with EOF but nothing is marked as a deliberate kill, so
    the pump takes the same unexpected-death path a SIGKILL'd real child
    triggers."""

    _pids = itertools.count(100000)

    def __init__(self, clock: Any, factory: TrainableFactory, trial_id: str,
                 config: Dict[str, Any], spill_dir: str,
                 checkpoint_freq: int = 0, restore_key: Optional[str] = None,
                 restore_iteration: int = 0, trace: bool = False,
                 network: Optional[SimNetwork] = None,
                 host: Optional[str] = None, inbox_notify: Any = None):
        self.clock = clock
        self.process = _FakeProcess(next(self._pids))
        drop = network.drop_filter(host) if network is not None and host else None
        self.transport, child_tr = virtual_pair(
            clock, name=trial_id, drop=drop, on_deliver_parent=inbox_notify)
        self._child_tr = child_tr
        self._send_lock = threading.Lock()
        spec = {
            "factory": factory,
            "trial_id": trial_id,
            "config": config,
            "spill_dir": spill_dir,
            "checkpoint_freq": checkpoint_freq,
            "restore_key": restore_key,
            "restore_iteration": restore_iteration,
            "nice": 0,
            "trace": trace,
            "cas": True,
        }
        self._thread = threading.Thread(
            target=self._run, args=(child_tr, spec),
            name=f"repro-vworker-{trial_id}", daemon=True)
        self._thread.start()

    def _run(self, transport: Any, spec: Dict[str, Any]) -> None:
        with self.clock.running():
            try:
                _child_main(transport, spec)
            finally:
                if self.process.exitcode is None:
                    self.process.exitcode = 0

    # -- ProcessWorker surface ---------------------------------------------------------
    @property
    def pid(self) -> int:
        return self.process.pid

    def alive(self) -> bool:
        return self._thread.is_alive()

    def send(self, *msg: Any) -> bool:
        try:
            with self._send_lock:
                self.transport.send(msg)
            return True
        except (EOFError, OSError, ValueError):
            return False

    def join(self, timeout: Optional[float] = None) -> bool:
        return self.clock.join_thread(self._thread, timeout=timeout)

    def kill(self, join_timeout: float = 5.0) -> None:
        """Deliberate teardown (evictions, reap escalation): drop the link
        (the child's recv raises EOF and the loop exits) and settle the
        thread."""
        if self.process.exitcode is None:
            self.process.exitcode = -9
        self.transport.close()
        self.clock.join_thread(self._thread, timeout=join_timeout)

    def die(self) -> None:
        """Scripted crash: the CHILD side vanishes — the parent endpoint sees
        EOF exactly as if the process had been SIGKILL'd externally."""
        if self.process.exitcode is None:
            self.process.exitcode = -9
        self._child_tr.close()

    def close(self) -> None:
        self.transport.close()


class SimFleet:
    """Scripted fault driver + host heartbeats on the virtual timeline.

    Usage::

        fleet = SimFleet(executor, clock)
        fleet.script("crash", "h1", at=30.0)
        fleet.script("partition", "h2", at=50.0, duration=40.0)
        executor.sim = fleet   # workers spawned from here on join the network
        fleet.start()
        ... run the experiment ...
        fleet.stop()

    Both threads (heartbeat + fault driver) park through the injected clock,
    so two identical-token runs replay the same fault sequence at the same
    virtual instants.  Times are ``clock.monotonic()`` offsets from start().
    """

    def __init__(self, executor: Any, clock: Any,
                 heartbeat_interval: float = 5.0):
        self.executor = executor
        self.clock = clock
        self.network = SimNetwork()
        self.heartbeat_interval = float(heartbeat_interval)
        self._events: List[Tuple[float, str, str]] = []
        self._stop = clock.event()
        self._threads: List[threading.Thread] = []
        self.n_faults_fired = 0

    def script(self, kind: str, host: str, at: float,
               duration: Optional[float] = None) -> None:
        if kind not in ("crash", "partition", "heal"):
            raise ValueError(f"unknown fault kind {kind!r}")
        self._events.append((float(at), kind, host))
        if kind == "partition" and duration is not None:
            self._events.append((float(at) + float(duration), "heal", host))

    def start(self) -> None:
        self.executor.sim = self
        for target, name in ((self._heartbeat_loop, "repro-sim-heartbeat"),
                             (self._fault_loop, "repro-sim-faults")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.clock.kick()
        for t in self._threads:
            self.clock.join_thread(t, timeout=5.0)
        self._threads.clear()

    # -- loops (clock-registered) ------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        with self.clock.running():
            while not self._stop.wait(self.heartbeat_interval):
                for name, host in list(self.executor.hosts.items()):
                    if host.alive and not self.network.is_partitioned(name):
                        self.executor.touch_host(name)

    def _fault_loop(self) -> None:
        with self.clock.running():
            t0 = self.clock.monotonic()
            for at, kind, host in sorted(self._events):
                while True:
                    remaining = (t0 + at) - self.clock.monotonic()
                    if remaining <= 0:
                        break
                    if self._stop.wait(remaining):
                        return
                if self._stop.is_set():
                    return
                if kind == "crash":
                    self.executor.fail_host(host, reason="scripted host crash")
                elif kind == "partition":
                    self.network.partition(host)
                elif kind == "heal":
                    self.network.heal(host)
                self.n_faults_fired += 1
