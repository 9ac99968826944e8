"""ClusterMeshExecutor: trials scheduled across a roster of host agents.

Extends ``ProcessMeshExecutor`` (so ``BusDrivenExecutor``) with the four
things a multi-host tier adds (DESIGN.md §11):

1. **Per-host SlicePools.**  Each ``HostAgent`` owns its device pool and its
   checkpoint spill surface.  The ``_pool_for(trial)`` seam routes every base
   pool operation (acquire, release, elastic resize) to the trial's host —
   the base executor and broker never learn hosts exist.
2. **Cross-host checkpoints.**  Workers save content-addressed keys
   (``cas/<trial>/<sha256>``) into their host's store; the pump fetches the
   payload to the controller store (digest-verified) *before* adoption, so a
   checkpoint survives its host and a restart on any other host restores it.
3. **Host failure domains.**  Frame traffic and heartbeats stamp
   ``clock.monotonic()`` ages; a host silent past ``host_timeout`` gets
   HEARTBEAT_MISSED on every resident trial, then eviction: every worker is
   killed, every trial errored — restart budgeting is the trial's ordinary
   ``max_failures``, so a host loss is N single-trial failures, not a special
   path.  Framing corruption (``FramingError``) escalates to the same
   eviction: a host spewing garbage cannot be trusted for any resident trial.
4. **Hardware-aware placement.**  ``RooflinePlacement`` right-sizes each
   trial's slice per host from its measured roofline profile (falling back
   to the requested width until a profile arrives).

Two transports, one pump:

- ``transport="socket"``: real worker processes dial back over TCP
  (``cluster.worker``); the pump multiplexes their framed sockets and the
  pipe tier's Connections through one ``multiprocessing.connection.wait``.
- ``transport="virtual"``: in-process workers over ``VirtualTransport``
  under an injected VirtualClock; the pump parks on a notification inbox so
  ``repro_torch.testing`` can script host crashes and partitions deterministically
  (``cluster.sim``).
"""
from __future__ import annotations

import os
import queue
import threading
import traceback
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..core.events import EventType, TrialEvent
from ..core.process_executor import ProcessMeshExecutor, _WorkerHandle
from ..core.resources import Resources
from ..core.trial import Checkpoint, Trial, TrialStatus
from ..core import workers as _w
from .hosts import HostAgent, HostSpec, fetch, parse_hosts
from .placement import FixedPlacement, RooflinePlacement
from .transport import HEARTBEAT, FramingError
from .worker import ClusterListener, SocketProcessWorker

__all__ = ["ClusterMeshExecutor"]


class ClusterMeshExecutor(ProcessMeshExecutor):
    def __init__(
        self,
        trainable_cls_resolver: Optional[Any] = None,
        checkpoint_manager: Optional[Any] = None,
        hosts: Any = 2,
        placement: Any = "roofline",   # "fixed" | "roofline" | policy object
        transport: str = "socket",     # "socket" | "virtual"
        host_timeout: Optional[float] = None,   # silent-host eviction age
        heartbeat_interval: Optional[float] = None,  # child beat cadence
        devices_per_trial: Optional[int] = None,
        total_cpu: float = 64.0,
        slice_pool: Optional[Any] = None,
        **kwargs: Any,
    ):
        if slice_pool is not None:
            raise ValueError(
                "the cluster tier owns one SlicePool per host; size the "
                "roster via hosts=..., not slice_pool=")
        specs = parse_hosts(hosts)
        # Every cluster field the pump/monitor threads may touch must exist
        # BEFORE super().__init__ — both threads start inside it.
        self.hosts: Dict[str, HostAgent] = {}
        self._host_of: Dict[str, HostAgent] = {}
        self._evict_lock = threading.Lock()
        self.transport_kind = transport
        self.n_host_evictions = 0
        self._inbox: "queue.Queue" = queue.Queue()  # virtual pump wake-ups
        self._attach_lock = threading.Lock()
        self._pending_tr: Dict[str, Any] = {}  # dialed in before start_trial won
        self._listener: Optional[ClusterListener] = None
        self._host_timeout = 0.0
        self._hb_interval = 0.0
        self._host_spill_root: Optional[str] = None
        self.sim = None  # cluster.sim.SimFleet attaches here (virtual tier)
        total_devices = sum(s.devices for s in specs)
        kwargs.pop("total_devices", None)  # roster defines capacity
        super().__init__(trainable_cls_resolver, checkpoint_manager,
                         total_cpu=total_cpu, total_devices=total_devices,
                         slice_pool=None, **kwargs)
        self._host_timeout = (
            float(host_timeout) if host_timeout is not None
            else (3.0 * self.heartbeat_timeout
                  if self.heartbeat_timeout > 0 else 0.0))
        self._hb_interval = float(
            heartbeat_interval if heartbeat_interval is not None
            else (min(5.0, self._host_timeout / 4.0)
                  if self._host_timeout > 0 else 5.0))
        self._host_spill_root = os.path.join(self._spill_dir, "hosts")
        for spec in specs:
            self.hosts[spec.name] = HostAgent(
                spec, self.clock, spill_root=self._host_spill_root)
        if placement == "roofline":
            placement = RooflinePlacement(devices_per_trial)
        elif placement == "fixed":
            placement = FixedPlacement(devices_per_trial)
        self._placement = placement
        self._token = uuid.uuid4().hex
        m = self.obs.metrics
        self._m_evict = m.counter("cluster.host_evictions") if m else None
        self._m_fetch = m.histogram("cluster.fetch_us") if m else None
        if transport == "socket":
            self._listener = ClusterListener(
                self._attach_transport, self._token, clock=self.clock)
        elif transport != "virtual":
            raise ValueError(f"unknown cluster transport {transport!r}")

    # -- roster helpers ---------------------------------------------------------------
    def _alive_hosts(self) -> List[HostAgent]:
        return [h for h in self.hosts.values() if h.alive]

    def _pool_for(self, trial: Trial) -> Optional[Any]:
        host = self._host_of.get(trial.trial_id)
        return host.pool if host is not None else None

    def touch_host(self, name: str) -> None:
        """Out-of-band host liveness signal (agent heartbeat / sim fleet)."""
        host = self.hosts.get(name)
        if host is not None:
            host.touch(self.clock.monotonic())

    def host_state(self) -> Dict[str, Dict[str, Any]]:
        """Per-host snapshot for the flight recorder / introspection."""
        return {
            name: {
                "alive": h.alive,
                "devices": h.spec.devices,
                "free": h.pool.n_free,
                "utilization": round(h.pool.utilization(), 4),
                "fragments": h.pool.fragments(),
                "trials": sorted(h.trials),
                "evicted_reason": h.evicted_reason,
            }
            for name, h in sorted(self.hosts.items())
        }

    # -- placement --------------------------------------------------------------------
    def has_resources(self, trial: Trial) -> bool:
        choice = self._placement.place(trial, self._alive_hosts())
        if choice is None:
            return False
        _, n = choice
        res = (trial.resources if n == trial.resources.devices
               else Resources(cpu=trial.resources.cpu, devices=n))
        return self.accountant.has_room(res)

    def _acquire_slice(self, trial: Trial) -> None:
        choice = self._placement.place(trial, self._alive_hosts())
        if choice is None:
            raise RuntimeError(
                f"no alive host can place {trial.trial_id} "
                f"({trial.resources.devices} devices requested)")
        host, n = choice
        if n != trial.resources.devices:
            # Hardware-aware right-sizing: the cost model, not the request,
            # decides the slice width (SHADHO-style).
            trial.resources = Resources(cpu=trial.resources.cpu, devices=n)
        self._host_of[trial.trial_id] = host
        host.trials.add(trial.trial_id)
        try:
            super()._acquire_slice(trial)  # accountant + host pool via _pool_for
        except Exception:
            host.trials.discard(trial.trial_id)
            self._host_of.pop(trial.trial_id, None)
            raise
        tracer = self.obs.tracer
        if tracer.enabled:
            t0 = tracer.clock.time()
            tracer.record("host.place", trial.trial_id, t0, 0.0,
                          cat="placement", host=host.name,
                          devices=trial.resources.devices)

    def _release(self, trial: Trial) -> None:
        super()._release(trial)  # needs _host_of intact for _pool_for
        host = self._host_of.pop(trial.trial_id, None)
        if host is not None:
            host.trials.discard(trial.trial_id)

    def _worker_config(self, trial: Trial) -> Dict[str, Any]:
        config = super()._worker_config(trial)
        host = self._host_of.get(trial.trial_id)
        if host is not None:
            config["_host"] = host.name
        return config

    # -- lifecycle --------------------------------------------------------------------
    def _spawn_worker(self, factory: Any, trial: Trial, host: HostAgent,
                      restore_key: Optional[str], restore_iter: int) -> Any:
        if self.transport_kind == "virtual":
            from .sim import VirtualWorker
            network = self.sim.network if self.sim is not None else None
            return VirtualWorker(
                self.clock, factory, trial.trial_id,
                self._worker_config(trial), host.store.spill_dir,
                checkpoint_freq=self.checkpoint_freq,
                restore_key=restore_key, restore_iteration=restore_iter,
                trace=self.obs.tracer.enabled, network=network,
                host=host.name, inbox_notify=self._notify_inbox(trial.trial_id))
        return SocketProcessWorker(
            factory, trial.trial_id, self._worker_config(trial),
            host.store.spill_dir, self._listener.address, self._token,
            checkpoint_freq=self.checkpoint_freq,
            restore_key=restore_key, restore_iteration=restore_iter,
            heartbeat_interval=self._hb_interval,
            mp_context=self.mp_context, nice=self.worker_nice,
            trace=self.obs.tracer.enabled)

    def start_trial(self, trial: Trial,
                    checkpoint: Optional[Checkpoint] = None) -> bool:
        if not self.has_resources(trial):
            return False
        try:
            factory = self._resolve_factory(trial.trainable_name)
        except KeyError:
            trial.error = traceback.format_exc()
            trial.set_status(TrialStatus.ERROR)
            return False
        try:
            self._acquire_slice(trial)
        except RuntimeError:
            return False  # roster changed between has_resources and here
        host = self._host_of[trial.trial_id]
        restore_key, restore_iter = None, 0
        if checkpoint is not None:
            try:
                with self._ckpt_lock:
                    restore_key = self.ckpt.export_copy(checkpoint)
                # The snapshot crosses to the target host's spill surface;
                # the child consumes (deletes) the host copy after restoring
                # and READY deletes the controller copy.
                fetch(restore_key, self.ckpt.store, host.store)
            except Exception:  # noqa: BLE001
                self._release(trial)
                trial.error = traceback.format_exc()
                trial.set_status(TrialStatus.ERROR)
                return False
            restore_iter = checkpoint.training_iteration
        try:
            worker = self._spawn_worker(factory, trial, host,
                                        restore_key, restore_iter)
        except Exception:  # noqa: BLE001
            self._release(trial)
            trial.error = traceback.format_exc()
            trial.set_status(TrialStatus.ERROR)
            return False
        ws = _WorkerHandle(trial, worker, self.clock)
        ws.restore_key = restore_key
        ws.restore_ckpt = checkpoint
        with self._attach_lock:
            self._workers[trial.trial_id] = ws
            pending = self._pending_tr.pop(trial.trial_id, None)
        if pending is not None:  # child dialed in before we registered
            worker.attach(pending)
        if self.transport_kind == "virtual":
            # A virtual worker may deliver READY before the handle above is
            # registered; the pump drops notifications for unknown trials, so
            # nudge it to drain anything already queued.
            self._notify_inbox(trial.trial_id)()
        trial.set_status(TrialStatus.RUNNING)
        return True

    # -- socket attach ----------------------------------------------------------------
    def _attach_transport(self, trial_id: str, tr: Any, hello: dict) -> None:
        """Listener thread: bind a dialed-in (or dialed-BACK-in) worker's
        framed transport to its handle; the pump picks it up on the next
        roster snapshot."""
        with self._attach_lock:
            ws = self._workers.get(trial_id)
            if ws is None:
                self._pending_tr[trial_id] = tr
                return
        ws.worker.attach(tr)
        host = self._host_of.get(trial_id)
        if host is not None:
            host.touch(self.clock.monotonic())

    def _notify_inbox(self, trial_id: str):
        def _notify() -> None:
            self._inbox.put(trial_id)
            self.clock.kick(self._inbox)
        return _notify

    # -- pump -------------------------------------------------------------------------
    def _pump(self) -> None:
        if self.transport_kind != "virtual":
            return super()._pump()
        # Virtual pump: no OS objects to select on — endpoints notify this
        # inbox on delivery, and the pump parks through the clock so virtual
        # time can advance around it.
        with self.clock.running():
            while not self._pump_shutdown.is_set():
                tid = self.clock.queue_get(self._inbox, timeout=3600.0)
                if tid is None:
                    continue  # timeout tick; re-check shutdown
                if tid is Ellipsis:
                    return  # shutdown sentinel
                ws = self._workers.get(tid)
                if ws is None:
                    continue
                t = ws.transport
                while (t is not None and not ws.dead
                       and not self._pump_shutdown.is_set() and t.poll(0)):
                    try:
                        msg = t.recv()
                    except (EOFError, OSError) as exc:
                        self._on_recv_error(ws, exc)
                        break
                    try:
                        self._handle_message(ws, msg)
                    except Exception:  # noqa: BLE001 — pump must not die
                        ws.dead = True
                        ws.reply_q.put(("DEAD",))
                        self.bus.publish(TrialEvent(
                            EventType.ERROR, ws.trial.trial_id,
                            error=traceback.format_exc()))

    def _on_recv_error(self, ws: _WorkerHandle, exc: BaseException) -> None:
        if isinstance(exc, FramingError):
            # The stream is corrupt, not closed: the host is emitting bytes
            # we cannot trust, so no trial on it can be trusted either.
            host = self._host_of.get(ws.trial.trial_id)
            if host is not None:
                self._evict_host(host, reason=f"framing corruption: {exc}")
                return
        super()._on_recv_error(ws, exc)

    def _handle_message(self, ws: _WorkerHandle, msg: tuple) -> None:
        kind = msg[0]
        host = self._host_of.get(ws.trial.trial_id)
        if kind == HEARTBEAT[0]:
            if host is not None:
                host.touch(self.clock.monotonic())
            return
        if host is not None:
            # Any protocol frame is proof of host life, not just heartbeats.
            host.touch(self.clock.monotonic())
            if kind == _w.MSG_READY and ws.restore_key:
                # The child consumed the HOST copy; the controller's export
                # copy would otherwise be stranded (the base clears the key
                # without a cluster-side delete).
                try:
                    self.ckpt.store.delete(ws.restore_key)
                except OSError:
                    pass
            elif kind in (_w.MSG_CHECKPOINTED, _w.MSG_SAVED):
                # Content-addressed pull BEFORE adoption: the checkpoint must
                # survive this host.  A digest mismatch raises, and the pump's
                # guard turns that into a worker ERROR (max_failures path).
                self._fetch_to_controller(msg[1], host)
            elif kind == _w.MSG_SPANS:
                msg = (kind, [
                    (n, ts, d, c, p, dict(a or {}, host=host.name))
                    for (n, ts, d, c, p, a) in msg[1]])
        super()._handle_message(ws, msg)

    def _fetch_to_controller(self, key: str, host: HostAgent) -> None:
        if self._m_fetch is not None:
            import time as _time
            p0 = _time.perf_counter()
            fetch(key, host.store, self.ckpt.store)
            self._m_fetch.observe((_time.perf_counter() - p0) * 1e6)
        else:
            fetch(key, host.store, self.ckpt.store)

    def _discard_stale_saved(self, key: str) -> None:
        # Content-addressed keys may be shared with an adopted checkpoint
        # (identical payloads dedupe to one key), so a stale SAVED must NOT
        # delete them; the host-dir cleanup at shutdown reclaims the bytes.
        if not key.startswith("cas/"):
            super()._discard_stale_saved(key)

    # -- host failure domain ----------------------------------------------------------
    def _monitor_tick(self, now: float) -> None:
        self._check_hosts(now)
        super()._monitor_tick(now)

    def _check_hosts(self, now: float) -> None:
        if self._host_timeout <= 0:
            return
        last_traffic: Dict[str, float] = {}
        for ws in list(self._workers.values()):
            if ws.dead:
                continue
            host = self._host_of.get(ws.trial.trial_id)
            t = ws.transport
            if host is None or t is None:
                continue
            last = getattr(t, "last_recv_mono", None)
            if last is not None:
                prev = last_traffic.get(host.name, float("-inf"))
                last_traffic[host.name] = max(prev, last)
        for name, host in list(self.hosts.items()):
            if not host.alive or not host.trials:
                continue
            age = now - max(host.last_seen, last_traffic.get(name, float("-inf")))
            if age > self._host_timeout:
                for trial_id in sorted(host.trials):
                    self.bus.publish(TrialEvent(
                        EventType.HEARTBEAT_MISSED, trial_id,
                        info={"host": name, "silent_s": round(age, 3),
                              "deadline_s": self._host_timeout}))
                self._evict_host(
                    host, reason=f"no heartbeat or frame for {age:.1f}s "
                                 f"(timeout {self._host_timeout:.1f}s)")

    def _evict_host(self, host: HostAgent, reason: str) -> None:
        """Host-level escalation: kill every resident worker, error every
        resident trial.  Each trial's restart is budgeted by its own
        ``max_failures`` — the host failure domain folds into the existing
        per-trial retry machinery rather than introducing a new one."""
        with self._evict_lock:
            if not host.alive:
                return
            host.alive = False
            host.evicted_reason = reason
            host.n_evictions += 1
            self.n_host_evictions += 1
        if self._m_evict is not None:
            self._m_evict.inc()
        for ws in list(self._workers.values()):
            if self._host_of.get(ws.trial.trial_id) is not host or ws.dead:
                continue
            ws.killed = True
            ws.dead = True
            ws.in_step = False
            pid = ws.worker.pid
            try:
                ws.worker.kill(join_timeout=self.join_timeout)
            except Exception:  # noqa: BLE001 — eviction must reap everything
                pass
            ws.reply_q.put(("DEAD",))
            self.n_killed += 1
            self.bus.publish(TrialEvent(
                EventType.KILLED, ws.trial.trial_id,
                info={"host": host.name, "pid": pid,
                      "phase": "host_eviction", "reason": reason}))
            self.bus.publish(TrialEvent(
                EventType.ERROR, ws.trial.trial_id,
                error=(f"host {host.name} evicted ({reason}); worker killed, "
                       "restart from the last fetched checkpoint is governed "
                       "by max_failures")))

    def fail_host(self, name: str, reason: str = "scripted host crash") -> None:
        """Abrupt host death (the simulated fleet's crash primitive): the
        host goes dark and every worker link drops with EOF — the pump's
        ordinary worker-death path errors each trial, exactly as a real
        host's processes vanishing would."""
        host = self.hosts.get(name)
        with self._evict_lock:
            if host is None or not host.alive:
                return
            host.alive = False
            host.evicted_reason = reason
            self.n_host_evictions += 1
        if self._m_evict is not None:
            self._m_evict.inc()
        for ws in list(self._workers.values()):
            if self._host_of.get(ws.trial.trial_id) is not host or ws.dead:
                continue
            die = getattr(ws.worker, "die", None)
            if die is not None:
                die()  # virtual: closes the link, parent sees EOF
            else:
                ws.worker.kill(join_timeout=self.join_timeout)

    # -- shutdown ---------------------------------------------------------------------
    def shutdown(self) -> None:
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        self._pump_shutdown.set()
        if self.transport_kind == "virtual":
            self._inbox.put(Ellipsis)
            self.clock.kick(self._inbox)
        super().shutdown()
        if self._host_spill_root is not None:
            import shutil
            shutil.rmtree(self._host_spill_root, ignore_errors=True)
            self._host_spill_root = None
