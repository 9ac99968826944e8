"""ProcessMeshExecutor — one OS process per RUNNING trial, with reclamation.

The third execution tier (DESIGN.md §5).  Where ``ConcurrentMeshExecutor``
gives each trial a worker *thread* (overlapped device work, but host-side code
serializes on the GIL and a hung step leaks its slice forever), this executor
gives each trial a spawned worker *process* driven over the ``repro_torch.core.workers``
command protocol:

- host-compute-heavy trainables step truly in parallel (no shared GIL);
- checkpoint bytes cross the boundary through the ObjectStore's spill surface
  (keys on the pipe, ``tree_to_bytes`` payloads on disk) — live JAX objects
  never pickle across;
- a straggler is *reclaimed*, not abandoned: the monitor escalates a
  ``HEARTBEAT_MISSED`` that exceeds ``straggler_deadline`` to SIGKILL,
  publishes ``KILLED`` + ``ERROR``, and the runner's existing ``max_failures``
  machinery requeues the trial from its last checkpoint while the freed slice
  goes back to the SlicePool for the next trial (the kill-on-straggle state
  machine: RUNNING -> deadline exceeded -> KILLED -> slice released ->
  PAUSED/PENDING -> RESTARTED).

Threading contract: the *runner thread* owns trial lifecycle and all
ResourceAccountant/SlicePool mutation, exactly as in the thread tier.  A
*pump thread* multiplexes every worker pipe, translating child messages into
``EventBus`` events (RESULT/ERROR/CHECKPOINTED) and routing synchronous
replies (SAVED/RESTORED/RESET/STOPPED) to the runner-side waiter.  A *monitor
thread* watches step ages and spawn ages and is the only other place a kill
originates.  Killing a process from the monitor is safe — resource release
still happens on the runner thread when it processes the resulting ERROR.

Clock seam (DESIGN.md §7): children are real OS processes, so their pipes
and the synchronous reply waits stay on *real* time — but all deadline math
(step/spawn ages, monitor interval, kill escalation) reads the injected
``Clock``.  Under a ``VirtualClock`` the monitor's straggler arithmetic can
be fast-forwarded deterministically while the child itself stays wall-bound;
the pump thread deliberately never registers with the clock (it blocks on
real child pipes the clock cannot see).
"""
from __future__ import annotations

import multiprocessing.connection as mp_conn
import os
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from .checkpoint import CheckpointManager
from .clock import Clock
from .events import EventBus, EventType, TrialEvent
from .executor import BusDrivenExecutor
from .trial import Checkpoint, Result, Trial, TrialStatus
from .workers import (CMD_RESET_CONFIG, CMD_RESIZE, CMD_RESTORE, CMD_SAVE,
                      CMD_STEP, CMD_STOP, ProcessWorker, TrainableFactory,
                      resolve_worker_factory)
from . import workers as _w

__all__ = ["ProcessMeshExecutor"]


class _WorkerHandle:
    """Per-trial bookkeeping for one worker process."""

    def __init__(self, trial: Trial, worker: ProcessWorker, clock: Clock):
        self.trial = trial
        self.worker = worker
        self.reply_q: "queue.Queue" = queue.Queue()  # SAVED/RESTORED/RESET/STOPPED
        self.ready = False
        self.in_step = False
        # Lookahead credits (DESIGN.md §6): STEP commands sent but whose
        # RESULT has not come back.  k=1 is PR 3's binary resume gate; k>1
        # queues STEPs in the pipe so the child never idles a round-trip
        # between a RESULT and its next step.  Mutated by the runner thread
        # (_kick via resume) and the pump thread (_kick via READY, decrement
        # on RESULT) — guarded by ctr_lock.
        self.outstanding = 0
        self.ctr_lock = threading.Lock()
        self.step_started = 0.0
        self.spawned_at = clock.monotonic()
        self.last_warned = 0.0
        self.dead = False      # pipe closed / child exited / ERROR published
        self.killed = False    # we SIGKILLed it (straggler or teardown)
        self.stopping = False  # runner-driven teardown in progress
        self.restore_key: Optional[str] = None  # un-consumed export_copy payload
        self.restore_ckpt: Optional[Checkpoint] = None  # pinned until consumed
        # True while a runner-side call (SAVE/RESTORE/RESET) awaits its reply:
        # a child failure then belongs to that caller, NOT the event bus — the
        # caller handles it inline (e.g. PBT falls back to a full rebuild), and
        # a bus ERROR would later hit the healthy rebuilt worker.
        self.expecting_reply = False

    @property
    def transport(self):
        """The worker's duplex message channel (pipe Connection or a cluster
        Transport).  None while a socket worker is still dialing in."""
        return self.worker.transport


class ProcessMeshExecutor(BusDrivenExecutor):
    def __init__(
        self,
        trainable_cls_resolver: Optional[Callable[[str], type]] = None,
        checkpoint_manager: Optional[CheckpointManager] = None,
        total_cpu: float = 64.0,
        total_devices: int = 256,
        slice_pool: Optional[Any] = None,  # dist.submesh.SlicePool
        checkpoint_freq: int = 0,
        heartbeat_timeout: float = 60.0,    # <=0 disables HEARTBEAT_MISSED
        straggler_deadline: float = 0.0,    # <=0 disables kill-on-straggle
        event_bus: Optional[EventBus] = None,
        factory_resolver: Optional[Callable[[str], TrainableFactory]] = None,
        join_timeout: float = 5.0,          # STOP -> SIGKILL escalation window
        spawn_timeout: float = 120.0,       # spawn -> READY deadline
        reply_timeout: float = 30.0,        # synchronous SAVE/RESTORE/RESET waits
        mp_context: Optional[str] = None,   # None = forkserver-preloaded/spawn
        worker_nice: int = 1,               # children yield to the control plane
        clock: Optional[Clock] = None,      # deadline math only; children stay wall
        obs: Optional[Any] = None,
    ):
        # trainable_cls_resolver is accepted for signature parity with the
        # in-host executors but never used to instantiate: the child rebuilds
        # from the factory.
        if checkpoint_manager is None:
            from .object_store import ObjectStore
            checkpoint_manager = CheckpointManager(ObjectStore())
        super().__init__(trainable_cls_resolver or (lambda name: None),
                         checkpoint_manager, total_cpu, total_devices,
                         slice_pool, checkpoint_freq, event_bus=event_bus,
                         clock=clock, obs=obs)
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_deadline = straggler_deadline
        self.join_timeout = join_timeout
        self.spawn_timeout = spawn_timeout
        self.reply_timeout = reply_timeout
        self.mp_context = mp_context
        self.worker_nice = worker_nice
        self._resolve_factory = factory_resolver or resolve_worker_factory
        self._owns_spill_dir = self.ckpt.store.spill_dir is None
        self._spill_dir = self.ckpt.store.ensure_spill_dir()
        self._ckpt_lock = threading.Lock()  # CheckpointManager access (pump + runner)
        self._shutdown_evt = self.clock.event()
        # The pump blocks on real child pipes the clock cannot see, so it
        # needs a real shutdown signal of its own (a virtual event would
        # require the pump to park through the clock to observe it).
        self._pump_shutdown = threading.Event()
        self.n_killed = 0
        self._pump_thread = threading.Thread(
            target=self._pump, name="repro-proc-pump", daemon=True)
        self._pump_thread.start()
        # The monitor doubles as the spawn watchdog, so it always runs; the
        # per-feature timeouts (<=0) disable their own escalations only.
        ready = threading.Event()
        self._monitor_thread = threading.Thread(
            target=self._monitor, args=(ready,),
            name="repro-proc-monitor", daemon=True)
        self._monitor_thread.start()
        # Roster handshake (virtual determinism): fail loudly on timeout
        # rather than let virtual time advance around a booting monitor.
        if not ready.wait(timeout=10.0):
            raise RuntimeError(
                "process monitor failed to enroll with the clock within 10s")

    def _events_guaranteed(self) -> bool:
        # An unbounded runner wait is safe only when the monitor covers BOTH
        # hang phases: heartbeats / kill deadline for a child stuck mid-step,
        # and the spawn watchdog for one that never becomes READY.
        return ((self.heartbeat_timeout > 0 or self.straggler_deadline > 0)
                and self.spawn_timeout > 0)

    # -- pump: child messages -> events / replies -------------------------------------
    def _pump(self) -> None:
        # Transport-agnostic multiplexing: ``mp_conn.wait`` accepts pipe
        # Connections AND sockets, so one pump serves both tiers.  A framed
        # transport exposes its selectable object via ``waitable``; a raw
        # Connection is its own waitable.
        while not self._pump_shutdown.is_set():
            handles: Dict[Any, _WorkerHandle] = {}
            transports: Dict[Any, Any] = {}
            for ws in list(self._workers.values()):
                if ws.dead:
                    continue
                t = ws.transport
                if t is None:
                    continue  # socket worker still dialing in
                w = getattr(t, "waitable", t)
                handles[w] = ws
                transports[w] = t
            if not handles:
                self._pump_shutdown.wait(0.05)
                continue
            try:
                ready = mp_conn.wait(list(handles), timeout=0.2)
            except OSError:
                continue  # a conn was torn down mid-wait; re-snapshot
            for w in ready:
                ws = handles[w]
                try:
                    msg = transports[w].recv()
                except (EOFError, OSError) as exc:
                    if ws.transport is not transports[w]:
                        # The worker re-attached a fresh transport (cluster
                        # reconnect) while this snapshot was in flight; the
                        # stale stream's EOF is not a death.
                        continue
                    self._on_recv_error(ws, exc)
                    continue
                try:
                    self._handle_message(ws, msg)
                except Exception:  # noqa: BLE001 — never let the pump die silently
                    ws.dead = True
                    ws.reply_q.put(("DEAD",))
                    self.bus.publish(TrialEvent(
                        EventType.ERROR, ws.trial.trial_id,
                        error=traceback.format_exc()))
            # No clock kick needed here: bus.publish kicks its own queue
            # channel, and reply_q is consumed by _await_reply's *real*
            # queue.get (reply latency is real-child latency by design).

    def _on_recv_error(self, ws: _WorkerHandle, exc: BaseException) -> None:
        """A transport recv failed.  For pipes every failure is child death;
        the cluster tier overrides this to escalate framing corruption to
        host eviction (DESIGN.md §11) — the pump itself never wedges."""
        self._on_worker_death(ws)

    def _on_worker_death(self, ws: _WorkerHandle) -> None:
        """Pipe hit EOF: the child exited without a protocol goodbye."""
        if ws.dead:
            return
        ws.dead = True
        ws.in_step = False
        ws.reply_q.put(("DEAD",))
        if (ws.killed or ws.stopping or ws.expecting_reply
                or self._shutdown_evt.is_set()):
            return  # deliberate teardown or a synchronous caller owns the outcome
        exitcode = ws.worker.process.exitcode
        self.bus.publish(TrialEvent(
            EventType.ERROR, ws.trial.trial_id,
            error=(f"worker process for {ws.trial.trial_id} died unexpectedly "
                   f"(exitcode={exitcode}); restarting from last checkpoint "
                   "is governed by max_failures"),
            info={"exitcode": exitcode, "pid": ws.worker.pid}))

    def _handle_message(self, ws: _WorkerHandle, msg: tuple) -> None:
        kind = msg[0]
        trial_id = ws.trial.trial_id
        if kind == _w.MSG_READY:
            ws.ready = True
            ws.restore_key = None  # child restored and consumed the payload
            if ws.restore_ckpt is not None:
                # The restore actually happened — only now may rotation
                # reclaim the source (a boot crash instead keeps the pin so
                # the max_failures retry can re-export it).
                ws.restore_ckpt.pinned = False
                ws.restore_ckpt = None
            self._kick(ws, n=self.lookahead)  # initial credit grant
        elif kind == _w.MSG_RESULT:
            _, iteration, metrics, done = msg
            with ws.ctr_lock:
                ws.outstanding = max(0, ws.outstanding - 1)
                ws.in_step = ws.outstanding > 0
                # One result back = the next queued step begins now; restart
                # the straggler clock so k queued steps aren't judged as one.
                ws.step_started = self.clock.monotonic()
            self.bus.publish(TrialEvent(
                EventType.RESULT, trial_id,
                result=Result(trial_id=trial_id, training_iteration=iteration,
                              metrics=dict(metrics), done=bool(done),
                              timestamp=self.clock.time())))
        elif kind == _w.MSG_CHECKPOINTED:
            _, key, iteration = msg
            with self._ckpt_lock:
                ckpt = self.ckpt.adopt(trial_id, iteration, key)
            ws.trial.checkpoint = ckpt
            self.bus.publish(TrialEvent(
                EventType.CHECKPOINTED, trial_id, checkpoint=ckpt))
        elif kind == _w.MSG_SPANS:
            # Child-side trace spans (build/step/ckpt.*): republish on the bus
            # so the runner's obs adopts them onto the parent trace — the
            # child's spans nest inside the trial's lifecycle span.
            self.bus.publish(TrialEvent(
                EventType.SPAN, trial_id, info={"spans": msg[1]}))
        elif kind == _w.MSG_ERROR:
            ws.dead = True
            ws.in_step = False
            ws.reply_q.put(("DEAD", msg[1]))
            if not ws.expecting_reply and not ws.stopping:
                self.bus.publish(TrialEvent(EventType.ERROR, trial_id, error=msg[1]))
        else:  # SAVED / RESTORED / RESET / RESIZED / STOPPED — a runner-side call waits
            ws.reply_q.put(msg)

    def _kick(self, ws: _WorkerHandle, n: int = 1) -> None:
        """Grant ``n`` step credits: send that many STEPs down the pipe (the
        resume gate re-opened ``n`` results wide).  Pump or runner thread."""
        with ws.ctr_lock:
            if ws.outstanding == 0:
                ws.step_started = self.clock.monotonic()
            for _ in range(max(1, n)):
                if not ws.worker.send(CMD_STEP):
                    break  # pipe dead; pump will surface the EOF
                ws.outstanding += 1
            ws.in_step = ws.outstanding > 0

    # -- monitor: heartbeats, spawn watchdog, kill-on-straggle ------------------------
    def _monitor(self, ready: threading.Event) -> None:
        beats = [t for t in (self.heartbeat_timeout, self.straggler_deadline) if t > 0]
        interval = max(0.05, min([1.0] + [t / 4 for t in beats]))
        with self.clock.running():
            ready.set()
            self._monitor_loop(interval)

    def _monitor_loop(self, interval: float) -> None:
        while not self._shutdown_evt.wait(interval):
            self._monitor_tick(self.clock.monotonic())

    def _monitor_tick(self, now: float) -> None:
        """One monitor pass over the roster; every age compare rides
        ``clock.monotonic()`` (wall-jump-safe — DESIGN.md §7).  The cluster
        tier extends this with host-level heartbeat ages."""
        for ws in list(self._workers.values()):
            if ws.dead or ws.killed or ws.stopping:
                continue
            if not ws.ready:
                if self.spawn_timeout > 0 and now - ws.spawned_at > self.spawn_timeout:
                    self._kill_straggler(ws, now - ws.spawned_at, phase="spawn")
                continue
            if not ws.in_step:
                continue
            elapsed = now - ws.step_started
            if (self.heartbeat_timeout > 0 and elapsed > self.heartbeat_timeout
                    and now - ws.last_warned > self.heartbeat_timeout):
                ws.last_warned = now
                self.bus.publish(TrialEvent(
                    EventType.HEARTBEAT_MISSED, ws.trial.trial_id,
                    info={"stalled_s": round(elapsed, 3),
                          "deadline_s": self.straggler_deadline}))
            if self.straggler_deadline > 0 and elapsed > self.straggler_deadline:
                self._kill_straggler(ws, elapsed, phase="step")

    def _kill_straggler(self, ws: _WorkerHandle, elapsed: float, phase: str) -> None:
        """Escalation: SIGKILL the worker, then hand the failure to the
        runner's retry machinery as an ERROR.  The slice itself is released on
        the runner thread when it requeues/stops the trial."""
        ws.killed = True
        ws.dead = True
        pid = ws.worker.pid
        ws.worker.kill(join_timeout=self.join_timeout)
        ws.in_step = False
        ws.reply_q.put(("DEAD",))
        self.n_killed += 1
        self.bus.publish(TrialEvent(
            EventType.KILLED, ws.trial.trial_id,
            info={"stalled_s": round(elapsed, 3), "pid": pid, "phase": phase,
                  "deadline_s": (self.straggler_deadline if phase == "step"
                                 else self.spawn_timeout)}))
        self.bus.publish(TrialEvent(
            EventType.ERROR, ws.trial.trial_id,
            error=(f"straggling worker (pid {pid}) killed: {phase} exceeded "
                   f"{elapsed:.1f}s (kill-on-straggle deadline); slice "
                   "reclaimed, restart governed by max_failures")))

    # -- lifecycle --------------------------------------------------------------------
    def _worker_config(self, trial: Trial) -> Dict[str, Any]:
        config = dict(trial.config)
        if trial.trial_id in self._slices:
            sl = self._slices[trial.trial_id]
            # Device handles can't cross a process boundary: ship the slice as
            # a virtual (start, size) window; the child's make_mesh tiles its
            # own devices (dist/submesh.py virtual mode).
            from ..dist.submesh import MeshSlice
            config["_slice"] = MeshSlice(sl.start, sl.size, None)
        return config

    def start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None) -> bool:
        if not self.has_resources(trial):
            return False
        try:
            factory = self._resolve_factory(trial.trainable_name)
        except KeyError:
            trial.error = traceback.format_exc()
            trial.set_status(TrialStatus.ERROR)
            return False
        restore_key, restore_iter = None, 0
        if checkpoint is not None:
            try:
                with self._ckpt_lock:
                    # a private snapshot: the child consumes it asynchronously,
                    # so the source may be unpinned/rotated from here on
                    restore_key = self.ckpt.export_copy(checkpoint)
            except Exception:  # noqa: BLE001
                trial.error = traceback.format_exc()
                trial.set_status(TrialStatus.ERROR)
                return False
            restore_iter = checkpoint.training_iteration
        self._acquire_slice(trial)
        try:
            worker = ProcessWorker(
                factory, trial.trial_id, self._worker_config(trial),
                self._spill_dir, checkpoint_freq=self.checkpoint_freq,
                restore_key=restore_key, restore_iteration=restore_iter,
                mp_context=self.mp_context, nice=self.worker_nice,
                trace=self.obs.tracer.enabled)
        except Exception:  # noqa: BLE001 — unpicklable config, spawn failure, ...
            self._release(trial)
            trial.error = traceback.format_exc()
            trial.set_status(TrialStatus.ERROR)
            return False
        # Spawn is asynchronous on purpose: the child's interpreter boot and
        # optional restore overlap across trials; the pump sends the first
        # STEP on READY, and a child that errors during build publishes ERROR
        # into the normal retry path.
        ws = _WorkerHandle(trial, worker, self.clock)
        ws.restore_key = restore_key
        ws.restore_ckpt = checkpoint
        self._workers[trial.trial_id] = ws
        trial.set_status(TrialStatus.RUNNING)
        return True

    def _sync_exchange(self, ws: _WorkerHandle, cmd: tuple, tag: str,
                       timeout: Optional[float] = None) -> Optional[tuple]:
        """Send a command and wait for its reply (runner thread only).

        While the exchange is open, a child failure is routed here (None
        return) instead of the event bus — the caller owns the fallback, and
        the runner must not later apply a stale ERROR to a rebuilt worker.
        """
        # Drain leftovers from an earlier timed-out exchange first: a late
        # reply with the SAME tag (e.g. a slow SAVE's MSG_SAVED arriving
        # after its caller gave up) must never satisfy this exchange — it
        # would hand back a stale checkpoint key and skew every subsequent
        # reply by one.  Only this (runner) thread opens exchanges, so
        # anything queued here predates this call; a DEAD sentinel is the
        # one message that stays meaningful.
        while True:
            try:
                stale = ws.reply_q.get_nowait()
            except queue.Empty:
                break
            if stale[0] == "DEAD":
                return None
            if stale[0] == _w.MSG_SAVED:
                self._discard_stale_saved(stale[1])
        ws.expecting_reply = True
        try:
            if not ws.worker.send(*cmd):
                return None
            return self._await_reply(ws, tag, timeout)
        finally:
            ws.expecting_reply = False

    def _discard_stale_saved(self, key: str) -> None:
        """A timed-out SAVE's payload was spilled but never adopted: delete
        it or it strands a checkpoint-sized file for the life of the spill
        dir.  Safe here because pipe-tier keys are unique per save — the
        cluster tier overrides this for content-addressed keys, which CAN be
        shared with an adopted checkpoint."""
        try:
            self.ckpt.store.delete(key)
        except OSError:
            pass

    def _await_reply(self, ws: _WorkerHandle, tag: str,
                     timeout: Optional[float] = None) -> Optional[tuple]:
        """Wait for a synchronous reply routed by the pump; None on timeout or
        worker death.  Real (monotonic) time on purpose, even under a virtual
        clock: the reply is produced by a real child process whose latency
        virtual time cannot model — and monotonic, not wall, so an NTP step
        can neither strand nor instantly expire the wait."""
        deadline = time.monotonic() + (timeout if timeout is not None else self.reply_timeout)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                msg = ws.reply_q.get(timeout=remaining)
            except queue.Empty:
                return None
            if msg[0] == tag:
                return msg
            if msg[0] == "DEAD":
                return None
            # stale reply from an earlier, timed-out exchange: drop it

    def _reap(self, trial: Trial) -> Optional[_WorkerHandle]:
        """Stop (or kill) the worker process and release its resources.

        Unlike the thread tier there is no abandonment branch: a worker that
        ignores STOP is SIGKILLed, so the slice is *always* reclaimed."""
        ws = self._workers.pop(trial.trial_id, None)
        if ws is None:
            return None
        ws.stopping = True
        if not ws.dead and ws.worker.alive():
            ws.worker.send(CMD_STOP)
            if not ws.worker.join(timeout=self.join_timeout):
                ws.worker.kill(join_timeout=self.join_timeout)
        elif ws.worker.alive():
            ws.worker.kill(join_timeout=self.join_timeout)
        ws.dead = True
        ws.worker.close()
        if ws.restore_key:  # child died before consuming its export snapshot
            self.ckpt.store.delete(ws.restore_key)
            ws.restore_key = None
        self._release(trial)
        return ws

    # -- checkpoints ------------------------------------------------------------------
    def _adopt_saved(self, ws: _WorkerHandle, trial: Trial) -> Optional[Checkpoint]:
        """Sync SAVE -> adopt the child-written key -> trial.checkpoint.
        None when the worker didn't reply in time (caller owns the fallback)."""
        rep = self._sync_exchange(ws, (CMD_SAVE,), _w.MSG_SAVED)
        if rep is None:
            return None
        _, key, iteration = rep
        with self._ckpt_lock:
            ckpt = self.ckpt.adopt(trial.trial_id, iteration, key)
        trial.checkpoint = ckpt
        return ckpt

    def save_checkpoint(self, trial: Trial) -> Checkpoint:
        ws = self._workers[trial.trial_id]
        if ws.dead or not ws.ready:
            raise RuntimeError(
                f"cannot checkpoint {trial.trial_id}: worker not serving "
                f"(ready={ws.ready}, dead={ws.dead})")
        ckpt = self._adopt_saved(ws, trial)
        if ckpt is None:
            raise RuntimeError(f"worker for {trial.trial_id} did not SAVE in time")
        return ckpt

    # -- runner-driven transitions ----------------------------------------------------
    def resume_trial(self, trial: Trial) -> None:
        ws = self._workers.get(trial.trial_id)
        if ws is not None and ws.ready and not ws.dead:
            self._kick(ws)

    def trial_idle(self, trial: Trial) -> bool:
        # Unlike the thread tier, a worker mid-step is still resizable: the
        # pipe serializes, so a queued SAVE lands *after* any outstanding
        # STEPs — it is its own drain barrier and no result is ever torn.
        ws = self._workers.get(trial.trial_id)
        return ws is not None and ws.ready and not ws.dead

    def resize_trial(self, trial: Trial, new_devices: int) -> bool:
        """Checkpoint-boundary slice resize over the pipe protocol
        (DESIGN.md §6): sync SAVE (queued behind any outstanding STEPs — the
        pipe is the drain barrier — and adopted so a failed resize restarts
        from *this* state), swap the pool slice on the runner thread, then
        CMD_RESIZE — the child rebuilds the trainable over the new virtual
        window and restores, all inside the warm process.  A child-side
        rebuild failure is non-fatal: the old trainable keeps serving, and
        the pool swap is rolled back to the exact old range.  A SAVE that
        can't drain within reply_timeout aborts the resize (its late reply
        is reaped by the _sync_exchange drain)."""
        ws = self._workers.get(trial.trial_id)
        if (ws is None or ws.dead or not ws.ready
                or self._pool_for(trial) is None
                or new_devices == trial.resources.devices):
            return False
        ckpt = self._adopt_saved(ws, trial)
        if ckpt is None:
            if ws.dead:
                # Child died during the boundary SAVE.  _sync_exchange
                # swallowed the pipe-EOF ERROR (the caller owns the outcome),
                # so surface it here or the trial is stranded RUNNING forever.
                self.bus.publish(TrialEvent(
                    EventType.ERROR, trial.trial_id,
                    error=(f"worker for {trial.trial_id} died during the "
                           "resize boundary SAVE; restart from the last "
                           "checkpoint is governed by max_failures")))
            return False
        key, iteration = ckpt.store_key, ckpt.training_iteration
        try:
            old_res, old_sl, new_sl = self._swap_slice(trial, new_devices)
        except RuntimeError:
            return False
        rep = self._sync_exchange(
            ws, (CMD_RESIZE, self._worker_config(trial), key, iteration),
            _w.MSG_RESIZED, timeout=max(self.reply_timeout, self.spawn_timeout))
        if rep is None:
            # Child died (or hung) mid-resize.  Roll the bookkeeping back to
            # the old range so the retry restarts at the original size, and
            # surface the death as a normal trial ERROR — _sync_exchange
            # swallowed the pipe-EOF event, so publish it here.
            ws.dead = True
            self._unswap_slice(trial, old_res, old_sl, new_sl)
            self.bus.publish(TrialEvent(
                EventType.ERROR, trial.trial_id,
                error=(f"worker for {trial.trial_id} died during RESIZE "
                       f"({old_sl.size} -> {new_devices} devices); restart "
                       "from the boundary checkpoint is governed by "
                       "max_failures")))
            return False
        if not rep[1]:  # child kept the old trainable; fall back to old slice
            self._unswap_slice(trial, old_res, old_sl, new_sl)
            return False
        # No credit top-up: the window maintains itself.  STEPs sent = initial
        # k + one per consumed CONTINUE, so at this boundary (outstanding 0)
        # exactly k results sit un-consumed, and each of their resumes will
        # kick one STEP — granting more here would inflate the window past k.
        return True

    def pause_trial(self, trial: Trial) -> None:
        ws = self._workers.get(trial.trial_id)
        if ws is not None:
            if ws.ready and not ws.dead and not ws.in_step:
                try:
                    self.save_checkpoint(trial)
                except Exception:  # noqa: BLE001 — fall back to last periodic ckpt
                    pass
            self._reap(trial)
        trial.set_status(TrialStatus.PAUSED)

    def stop_trial(self, trial: Trial, error: Optional[str] = None) -> None:
        self._reap(trial)
        if error:
            trial.error = error
            trial.set_status(TrialStatus.ERROR)
        else:
            trial.set_status(TrialStatus.TERMINATED)

    def requeue_trial(self, trial: Trial) -> None:
        """Tear down a failed (possibly killed) worker, keeping the trial
        restartable from its last checkpoint.  This is where a straggler's
        slice actually returns to the SlicePool — before the runner's launch
        loop runs again, so a waiting trial can take it within one step."""
        self._reap(trial)
        self._set_requeue_status(trial)

    def restart_trial_with_config(
        self, trial: Trial, checkpoint: Checkpoint, new_config: Dict[str, Any]
    ) -> None:
        """PBT exploit: in-place RESET_CONFIG + RESTORE when the child
        cooperates, full process rebuild otherwise."""
        trial.config = dict(new_config)
        ws = self._workers.get(trial.trial_id)
        if ws is not None:
            if ws.ready and not ws.dead and not ws.in_step:
                try:
                    with self._ckpt_lock:
                        ws.restore_key = self.ckpt.export_copy(checkpoint)
                except Exception:  # noqa: BLE001
                    trial.error = traceback.format_exc()
                    trial.set_status(TrialStatus.ERROR)
                    self._reap(trial)
                    return
                rep = self._sync_exchange(
                    ws, (CMD_RESET_CONFIG, dict(new_config)), _w.MSG_RESET)
                if rep is not None and rep[1]:
                    restored = self._sync_exchange(
                        ws, (CMD_RESTORE, ws.restore_key,
                             checkpoint.training_iteration), _w.MSG_RESTORED)
                    if restored is not None:
                        ws.restore_key = None  # consumed (deleted) by the child
                        checkpoint.pinned = False
                        self._kick(ws)
                        return
            self._reap(trial)
            trial.set_status(TrialStatus.PAUSED)
        # Full rebuild: fresh process restoring the donor state before READY.
        if not self.has_resources(trial):
            trial.checkpoint = checkpoint  # re-queue; next launch restores donor
            trial.set_status(TrialStatus.PAUSED)
            return
        self.start_trial(trial, checkpoint=checkpoint)

    # -- introspection ----------------------------------------------------------------
    def worker_pid(self, trial_id: str) -> Optional[int]:
        ws = self._workers.get(trial_id)
        return ws.worker.pid if ws is not None else None

    def shutdown(self) -> None:
        self._shutdown_evt.set()
        self._pump_shutdown.set()
        for trial_id in list(self._workers):
            self._reap(self._workers[trial_id].trial)
        if self._pump_thread.is_alive():
            self._pump_thread.join(timeout=2.0)  # real thread, real join
        if self._monitor_thread is not None and self._monitor_thread.is_alive():
            self.clock.join_thread(self._monitor_thread, timeout=2.0)
        if self._owns_spill_dir:
            # We mkdtemp'd this dir (the user configured no spill): the
            # checkpoint payloads in it die with the experiment.
            import shutil
            shutil.rmtree(self._spill_dir, ignore_errors=True)
