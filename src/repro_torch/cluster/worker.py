"""Socket-tier workers: real processes dialing the controller back over TCP.

The child runs the *unchanged* ``core.workers._child_main`` command loop — the
only cluster-specific code is the dial-in: connect to the controller's
listener, complete the magic/version/hello handshake, start a heartbeat
thread, then hand the framed transport to the command loop.

Parent side, ``ClusterListener`` owns the accept loop: it completes the
server handshake, checks the roster token, and hands the attached transport
to the executor keyed by trial_id.  Because the handshake carries the
trial_id, a worker that dials back after a broken connection re-attaches to
its *existing* handle instead of being treated as a stranger — the
reconnect-aware half of the framing contract.

The child's heartbeat cadence is real wall sleep (children are real processes
outside any VirtualClock); the *parent's* age math over those heartbeats rides
``clock.monotonic()`` only (DESIGN.md §7).
"""
from __future__ import annotations

import os
import socket as _socket
import threading
import time as _time
from typing import Any, Callable, Dict, Optional, Tuple

import multiprocessing as mp

from ..core.workers import TrainableFactory, _child_main, _default_context
from .transport import (SocketTransport, TransportError, client_handshake,
                        server_handshake)

__all__ = ["SocketProcessWorker", "ClusterListener", "socket_child_main"]


def socket_child_main(address: Tuple[str, int], token: str,
                      spec: Dict[str, Any]) -> None:
    """Worker process entry for the socket tier (spawn-safe, module-level).

    Dial the controller (with retries — the listener may still be binding, or
    a transient refusal may need riding out), handshake, start the heartbeat
    thread, and serve the standard command loop over the framed transport.
    """
    tr: Optional[SocketTransport] = None
    retries = int(spec.get("connect_retries", 5))
    for attempt in range(retries):
        sock = None
        try:
            sock = _socket.create_connection(tuple(address), timeout=10.0)
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            tr = client_handshake(sock, {
                "trial_id": spec["trial_id"],
                "pid": os.getpid(),
                "token": token,
            })
            break
        except (OSError, TransportError):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            _time.sleep(0.2 * (attempt + 1))
    if tr is None:
        return  # controller unreachable; parent's spawn watchdog reclaims us

    hb = float(spec.get("heartbeat_interval", 0.0) or 0.0)
    if hb > 0:

        def _beat() -> None:
            while True:
                _time.sleep(hb)
                try:
                    tr.send_heartbeat()
                except (TransportError, OSError):
                    return  # controller gone; main loop sees it too

        threading.Thread(target=_beat, name="repro-heartbeat",
                         daemon=True).start()
    _child_main(tr, spec)


class SocketProcessWorker:
    """Parent-side handle on one socket-tier worker process.

    Same surface as ``core.workers.ProcessWorker`` (send/kill/join/close/
    alive/pid/transport) so the executor and pump need no tier branches.  The
    difference: ``transport`` starts as None and is attached by the listener
    when the child dials back — commands before READY are impossible by
    protocol, and the pump simply skips handles that have no transport yet.

    The mp.Process handle is kept even though messaging rides the socket:
    SIGKILL reclamation of a wedged child must not depend on a live TCP
    connection.
    """

    def __init__(
        self,
        factory: TrainableFactory,
        trial_id: str,
        config: Dict[str, Any],
        spill_dir: str,
        address: Tuple[str, int],
        token: str,
        checkpoint_freq: int = 0,
        restore_key: Optional[str] = None,
        restore_iteration: int = 0,
        heartbeat_interval: float = 5.0,
        mp_context: Optional[str] = None,
        nice: int = 1,
        trace: bool = False,
    ):
        spec = {
            "factory": factory,
            "trial_id": trial_id,
            "config": config,
            "spill_dir": spill_dir,
            "checkpoint_freq": checkpoint_freq,
            "restore_key": restore_key,
            "restore_iteration": restore_iteration,
            "nice": nice,
            "trace": trace,
            "cas": True,  # cluster checkpoints are content-addressed
            "heartbeat_interval": heartbeat_interval,
        }
        ctx = mp.get_context(mp_context) if mp_context else _default_context()
        self.transport: Optional[SocketTransport] = None
        self._send_lock = threading.Lock()
        self.process = ctx.Process(
            target=socket_child_main, args=(tuple(address), token, spec),
            name=f"repro-cluster-worker-{trial_id}", daemon=True)
        self.process.start()

    def attach(self, transport: SocketTransport) -> None:
        with self._send_lock:
            old, self.transport = self.transport, transport
        if old is not None:  # reconnect: the stale stream is dead
            old.close()

    @property
    def pid(self) -> Optional[int]:
        return self.process.pid

    def alive(self) -> bool:
        return self.process.is_alive()

    def send(self, *msg: Any) -> bool:
        try:
            with self._send_lock:
                if self.transport is None:
                    return False
                self.transport.send(msg)
            return True
        except (TransportError, OSError, ValueError, EOFError):
            return False

    def join(self, timeout: Optional[float] = None) -> bool:
        self.process.join(timeout=timeout)
        return not self.process.is_alive()

    def kill(self, join_timeout: float = 5.0) -> None:
        try:
            self.process.kill()
        except (OSError, AttributeError, ValueError):
            pass
        self.process.join(timeout=join_timeout)
        self.close()

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()


class ClusterListener:
    """The controller's single accept loop for every socket worker.

    One listening socket (loopback by default — real multi-host deployments
    would bind an interface), one daemon thread: each accepted connection is
    handshaken, token-checked, and delivered to ``on_attach(trial_id,
    transport, hello)``.  A handshake or token failure closes that connection
    and nothing else — a garbage-spewing dialer cannot take the listener down.
    """

    def __init__(self, on_attach: Callable[[str, SocketTransport, dict], None],
                 token: str, clock: Optional[Any] = None,
                 host: str = "127.0.0.1", max_frame: Optional[int] = None):
        self.on_attach = on_attach
        self.token = token
        self.clock = clock
        self._max_frame = max_frame
        self.sock = _socket.create_server((host, 0))
        self.sock.settimeout(0.2)
        self.address: Tuple[str, int] = self.sock.getsockname()[:2]
        self._stop = threading.Event()
        self.n_rejected = 0
        self.thread = threading.Thread(
            target=self._accept_loop, name="repro-cluster-accept", daemon=True)
        self.thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self.sock.accept()
            except _socket.timeout:
                continue
            except OSError:
                return  # listener closed
            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                kwargs = {}
                if self._max_frame is not None:
                    kwargs["max_frame"] = self._max_frame
                tr, hello = server_handshake(sock, clock=self.clock, **kwargs)
            except (TransportError, OSError):
                self.n_rejected += 1
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            if hello.get("token") != self.token:
                self.n_rejected += 1
                tr.close()
                continue
            try:
                self.on_attach(str(hello["trial_id"]), tr, hello)
            except Exception:  # noqa: BLE001 — never kill the accept loop
                tr.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        self.thread.join(timeout=2.0)
