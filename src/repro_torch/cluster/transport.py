"""Wire transports for the cluster tier (DESIGN.md §11).

The worker protocol (``repro_torch.core.workers``) speaks over any *Transport*: an
object with ``send(obj)`` / ``recv() -> obj`` / ``poll(timeout) -> bool`` /
``close()``.  A duplex multiprocessing Connection already is one; this module
adds the two the cluster tier needs:

- ``SocketTransport``: length-prefixed pickle frames over a stream socket,
  with a magic/version handshake, zero-length heartbeat frames, and a hard
  frame-size cap so a corrupt length prefix fails loudly instead of allocating
  gigabytes.  The parent-side executor pump multiplexes sockets and pipe
  Connections through one ``multiprocessing.connection.wait`` call (both are
  selectable), so a mixed roster needs no second pump.
- ``VirtualTransport``: an in-memory endpoint pair whose blocking ``recv``
  parks through an injected clock, so ``repro_torch.testing`` can script host
  crashes and network partitions deterministically under VirtualClock before
  any real socket is trusted.

Error taxonomy (deliberate MRO — the core pump/child loops catch
``(EOFError, OSError)`` and need no cluster imports):

- ``TransportClosed``  subclasses EOFError: the peer is gone (clean close,
  reset, or mid-frame disconnect).  Same recovery as a pipe EOF.
- ``FramingError``     subclasses OSError: the *bytes* are wrong (bad magic,
  oversized/corrupt length prefix, undecodable payload).  The peer may still
  be alive but the stream is unrecoverable — the cluster executor escalates
  this to host eviction rather than a single-worker death.

Heartbeat/reconnect age arithmetic rides ``clock.monotonic()`` exclusively
(never ``time.time()``): an NTP step on either end must not age a healthy
host into eviction, matching the wall-jump-safe contract of DESIGN.md §7.
"""
from __future__ import annotations

import pickle
import queue
import select
import socket as _socket
import struct
import threading
import time as _time
from typing import Any, Callable, Optional, Tuple

__all__ = [
    "TransportError", "TransportClosed", "FramingError",
    "MAGIC", "PROTO_VERSION", "DEFAULT_MAX_FRAME", "HEARTBEAT",
    "SocketTransport", "client_handshake", "server_handshake",
    "VirtualTransport", "virtual_pair",
]

MAGIC = b"RMSH"          # repro mesh
PROTO_VERSION = 1
DEFAULT_MAX_FRAME = 64 << 20   # 64 MiB: > any checkpoint key message, << RAM
_LEN = struct.Struct("!I")

#: Sentinel message a transport yields for a zero-length (heartbeat) frame.
#: It reaches ``_handle_message`` like any other child message; only the
#: cluster executor expects it (pipe children never send heartbeats).
HEARTBEAT: Tuple[str] = ("HEARTBEAT",)


class TransportError(Exception):
    """Base for transport failures."""


class TransportClosed(TransportError, EOFError):
    """Peer closed (cleanly or not).  EOFError-compatible on purpose."""


class FramingError(TransportError, OSError):
    """The byte stream is corrupt; the connection cannot be resynchronized.
    OSError-compatible so transport-agnostic loops treat it as fatal I/O."""


def _mono(clock: Optional[Any]) -> float:
    return clock.monotonic() if clock is not None else _time.monotonic()


class SocketTransport:
    """Length-prefixed pickle frames over a connected stream socket.

    ``send`` is locked (pump kicks vs runner lifecycle commands);  ``recv``
    has a single reader (the pump or the child loop) by protocol.  A
    zero-length frame is a heartbeat: it stamps ``last_recv_mono`` and is
    surfaced as the ``HEARTBEAT`` sentinel message.
    """

    def __init__(self, sock: _socket.socket, clock: Optional[Any] = None,
                 max_frame: int = DEFAULT_MAX_FRAME, name: str = ""):
        self.sock = sock
        self.name = name
        self.max_frame = int(max_frame)
        self._clock = clock
        self._send_lock = threading.Lock()
        self._closed = False
        #: monotonic instant of the last bytes seen from the peer — the ONLY
        #: input to heartbeat/eviction age math (wall time can step).
        self.last_recv_mono = _mono(clock)

    # -- Transport surface -------------------------------------------------------------
    @property
    def waitable(self) -> _socket.socket:
        """What the executor pump hands to ``multiprocessing.connection.wait``."""
        return self.sock

    def fileno(self) -> int:
        return self.sock.fileno()

    def send(self, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > self.max_frame:
            raise FramingError(
                f"outgoing frame of {len(payload)} bytes exceeds the "
                f"{self.max_frame}-byte cap")
        self._send_frame(payload)

    def send_heartbeat(self) -> None:
        """Zero-length liveness frame (child -> parent only)."""
        self._send_frame(b"")

    def _send_frame(self, payload: bytes) -> None:
        with self._send_lock:
            if self._closed:
                raise TransportClosed(f"transport {self.name or '?'} is closed")
            try:
                self.sock.sendall(_LEN.pack(len(payload)) + payload)
            except OSError as e:
                self._closed = True
                raise TransportClosed(f"peer gone during send: {e}") from e

    def recv(self) -> Any:
        hdr = self._read_exact(_LEN.size)
        (length,) = _LEN.unpack(hdr)
        self.last_recv_mono = _mono(self._clock)
        if length == 0:
            return HEARTBEAT
        if length > self.max_frame:
            # A corrupt length prefix looks like a multi-GiB frame; failing
            # here (before any allocation) is what keeps a garbage-spewing
            # peer from wedging or OOMing the pump.
            raise FramingError(
                f"incoming frame claims {length} bytes "
                f"(cap {self.max_frame}); stream is corrupt")
        payload = self._read_exact(length)
        try:
            return pickle.loads(payload)
        except Exception as e:  # noqa: BLE001 — anything unpicklable is framing
            raise FramingError(f"undecodable frame payload: {e!r}") from e

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError as e:
                self._closed = True
                raise TransportClosed(f"recv failed: {e}") from e
            if not chunk:
                self._closed = True
                if buf:
                    raise TransportClosed(
                        f"peer closed mid-frame ({len(buf)}/{n} bytes)")
                raise TransportClosed("peer closed")
            buf += chunk
        return bytes(buf)

    def poll(self, timeout: float = 0.0) -> bool:
        if self._closed:
            return True  # recv will raise TransportClosed promptly
        try:
            r, _, _ = select.select([self.sock], [], [], max(0.0, timeout or 0.0))
        except (OSError, ValueError):
            return True
        return bool(r)

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# -- handshake ------------------------------------------------------------------------
# 5 raw bytes (magic + version) before any frame: a stray connection speaking
# the wrong protocol is rejected without ever being unpickled.  Then one hello
# frame identifies the worker ({"trial_id", "pid", "token"}), which is what
# makes reconnects possible: an acceptor can re-attach a dialing-back worker
# to its existing handle by trial_id instead of treating it as a stranger.

def client_handshake(sock: _socket.socket, hello: dict,
                     timeout: float = 10.0,
                     max_frame: int = DEFAULT_MAX_FRAME) -> SocketTransport:
    """Worker side: send magic+version, then the hello frame; await the ack."""
    sock.settimeout(timeout)
    tr = SocketTransport(sock, max_frame=max_frame,
                         name=str(hello.get("trial_id", "?")))
    try:
        sock.sendall(MAGIC + bytes([PROTO_VERSION]))
        tr.send(dict(hello))
        ack = tr.recv()
        if not (isinstance(ack, dict) and ack.get("ok")):
            raise FramingError(f"handshake rejected: {ack!r}")
    except _socket.timeout as e:
        raise TransportClosed("handshake timed out") from e
    sock.settimeout(None)
    return tr


def server_handshake(sock: _socket.socket, clock: Optional[Any] = None,
                     timeout: float = 10.0,
                     max_frame: int = DEFAULT_MAX_FRAME
                     ) -> Tuple[SocketTransport, dict]:
    """Acceptor side: verify magic+version, read the hello, ack.  Returns the
    framed transport and the hello dict identifying the worker."""
    sock.settimeout(timeout)
    try:
        head = b""
        while len(head) < len(MAGIC) + 1:
            chunk = sock.recv(len(MAGIC) + 1 - len(head))
            if not chunk:
                raise TransportClosed("peer closed during handshake")
            head += chunk
    except _socket.timeout as e:
        raise TransportClosed("handshake timed out") from e
    if head[:len(MAGIC)] != MAGIC:
        raise FramingError(f"bad magic {head[:len(MAGIC)]!r}")
    if head[len(MAGIC)] != PROTO_VERSION:
        raise FramingError(f"protocol version {head[len(MAGIC)]} != {PROTO_VERSION}")
    tr = SocketTransport(sock, clock=clock, max_frame=max_frame)
    hello = tr.recv()
    if not (isinstance(hello, dict) and hello.get("trial_id")):
        raise FramingError(f"malformed hello: {hello!r}")
    tr.name = str(hello["trial_id"])
    tr.send({"ok": True, "proto": PROTO_VERSION})
    sock.settimeout(None)
    return tr, hello


# -- virtual transport ----------------------------------------------------------------

_CLOSED = object()  # in-band EOF marker on a virtual endpoint's inbox


class VirtualTransport:
    """One endpoint of an in-memory duplex link under an injected clock.

    Blocking ``recv`` parks through ``clock.queue_get`` so a VirtualClock can
    advance around it; producers kick the consumer's queue channel.  The link
    owns an optional ``drop(sender_endpoint, obj) -> bool`` filter: returning
    True silently swallows the frame — that is a network partition, which
    (like a real one) produces *no* EOF; only heartbeat age can detect it.
    A filter that wants TCP semantics (a blip delays, retransmission delivers
    after the heal) can stash ``(sender_endpoint, obj)`` and replay later via
    ``deliver``, which bypasses the filter.  ``close`` is a process death:
    the peer sees EOF (``TransportClosed``).
    """

    def __init__(self, clock: Any, side: str, name: str = ""):
        self.clock = clock
        self.side = side
        self.name = name
        self._q: "queue.Queue" = queue.Queue()
        self.peer: Optional["VirtualTransport"] = None
        self.closed = False
        self.drop: Optional[Callable[[str, Any], bool]] = None
        self.on_deliver: Optional[Callable[[], None]] = None
        self.last_recv_mono = clock.monotonic()

    # The virtual pump is driven by on_deliver notifications, not select():
    # there is no OS object to wait on.
    waitable = None

    def send(self, obj: Any) -> None:
        peer = self.peer
        if self.closed or peer is None:
            raise TransportClosed(f"virtual endpoint {self.name} is closed")
        if peer.closed:
            raise TransportClosed(f"peer of {self.name} is closed")
        if self.drop is not None and self.drop(self, obj):
            return  # partitioned: the frame vanishes, no error, no EOF
        self.deliver(obj)

    def deliver(self, obj: Any) -> bool:
        """Put ``obj`` on the peer's inbox, bypassing the drop filter — the
        retransmission path a partition heal replays through.  Returns False
        (frame lost for good) if either end has since closed."""
        peer = self.peer
        if peer is None or peer.closed or self.closed:
            return False
        peer._q.put(obj)
        self.clock.kick(peer._q)
        if peer.on_deliver is not None:
            peer.on_deliver()
        return True

    def send_heartbeat(self) -> None:
        self.send(HEARTBEAT)

    def recv(self) -> Any:
        while True:
            if self.closed and self._q.empty():
                raise TransportClosed(f"virtual endpoint {self.name} is closed")
            got = self.clock.queue_get(self._q, timeout=3600.0)
            if got is None:
                continue  # spurious/virtual timeout: park again
            if got is _CLOSED:
                self.closed = True
                raise TransportClosed(f"peer of {self.name} closed")
            self.last_recv_mono = self.clock.monotonic()
            return got

    def poll(self, timeout: float = 0.0) -> bool:
        if not self._q.empty() or self.closed:
            return True
        if timeout and timeout > 0:
            return self.clock.wait_for(
                lambda: not self._q.empty() or self.closed,
                timeout, channel=self._q)
        return False

    def close(self) -> None:
        """Drop this endpoint; the peer observes EOF (like a process exit).
        Bypasses the partition filter on purpose: a SIGKILL'd process's FIN
        still reaches a reachable peer."""
        if self.closed:
            return
        self.closed = True
        peer = self.peer
        if peer is not None and not peer.closed:
            peer._q.put(_CLOSED)
            self.clock.kick(peer._q)
            if peer.on_deliver is not None:
                peer.on_deliver()
        # Wake our own parked reader too (the child loop blocking in recv).
        self._q.put(_CLOSED)
        self.clock.kick(self._q)


def virtual_pair(clock: Any, name: str = "",
                 drop: Optional[Callable[[str, Any], bool]] = None,
                 on_deliver_parent: Optional[Callable[[], None]] = None
                 ) -> Tuple[VirtualTransport, VirtualTransport]:
    """A connected (parent_end, child_end) VirtualTransport pair.

    ``drop`` filters frames in BOTH directions (sender side is passed);
    ``on_deliver_parent`` fires after a frame lands in the parent's inbox —
    the cluster executor uses it to nudge its virtual pump."""
    parent = VirtualTransport(clock, "parent", name=f"{name}/parent")
    child = VirtualTransport(clock, "child", name=f"{name}/child")
    parent.peer, child.peer = child, parent
    parent.drop = child.drop = drop
    parent.on_deliver = on_deliver_parent
    return parent, child
