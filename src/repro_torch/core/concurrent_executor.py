"""ConcurrentMeshExecutor — asynchronous trial execution over mesh slices.

``SerialMeshExecutor`` time-slices RUNNING trainables one at a time on the
host thread, so trials holding *disjoint* SlicePool sub-meshes still step
sequentially.  Here each RUNNING trial gets its own worker thread:

- the worker loops ``train()`` → publish RESULT on the shared ``EventBus``,
  then parks on a resume gate until the runner has applied the scheduler's
  decision (``resume_trial`` re-opens the gate on CONTINUE);
- JAX dispatch from concurrent host threads overlaps device work across the
  disjoint slices — while the runner processes trial A's result, trials
  B..N have their steps in flight;
- a heartbeat monitor publishes HEARTBEAT_MISSED when a step exceeds the
  straggler timeout, so the runner's event loop always makes progress (and
  can surface stuck trials) even when no result arrives.

Scheduler semantics are preserved exactly at the default ``lookahead=1``: at
most one un-consumed result per trial is ever in flight, so PAUSE/STOP/
PBT-clone decisions apply before the trial advances past the result they
were made on.  The gate is a credit *semaphore* (DESIGN.md §6): the elastic
broker may grant ``k>1`` credits — but only for schedulers that declare
``decision_interval() == 0`` (pure run-to-completion), where no decision can
be stale.  With ``k>1`` a stop can land mid-step; teardown then waits out
``join_timeout`` and falls back to the same abandoned-worker contract as a
straggler (at most k-1 extra steps are computed and fenced as stale).
Failure handling is checkpoint-based (paper §4.2): a worker that raises
publishes ERROR and the runner re-queues the trial from its last checkpoint,
bounded by ``max_failures`` (runner.py).

Threading contract (DESIGN.md §4): the runner thread owns trial lifecycle
(start/pause/stop/restart) and all ResourceAccountant/SlicePool mutation;
worker threads own their trainable and touch only the bus and the checkpoint
manager (serialized by ``_ckpt_lock``).  ``ws.lock`` guards the trainable so
``save_checkpoint`` from the runner thread waits out an in-flight step.
"""
from __future__ import annotations

import threading
import traceback
from time import perf_counter as _perf
from typing import Any, Callable, Dict, Optional

from .api import Trainable
from .checkpoint import CheckpointManager
from .clock import Clock
from .events import EventBus, EventType, TrialEvent
from .executor import BusDrivenExecutor
from .trial import Checkpoint, Result, Trial, TrialStatus

__all__ = ["ConcurrentMeshExecutor"]


class _WorkerState:
    """Per-trial worker bookkeeping; one instance per (re)launched thread."""

    def __init__(self, trial: Trial, trainable: Trainable, clock: Clock,
                 credits: int = 1):
        self.trial = trial
        self.trainable = trainable
        self.thread: Optional[threading.Thread] = None
        # Credit-counting resume gate (DESIGN.md §6): each credit is one step
        # the runner has granted.  credits=1 is exactly PR 2's binary gate —
        # at most one un-consumed result per trial; k>1 lets the worker run
        # ahead for run-to-completion schedulers.  The semaphore comes from
        # the clock so a parked worker is visible to virtual time (§7).
        self.credits = clock.semaphore(credits)
        self.granted = credits            # runner-thread writes only
        self.published = 0                # worker-thread writes only
        self.stop = threading.Event()     # runner halt request (checked, never waited)
        self.registered = threading.Event()  # thread joined the clock's roster
        self.lock = threading.Lock()      # guards the trainable
        self.in_step = False
        self.step_started = 0.0
        self.last_warned = 0.0
        self.dead = False                 # worker exited after publishing ERROR

    @property
    def parked(self) -> bool:
        """No granted-but-unpublished steps: the worker thread is blocked on
        the credit gate (or about to be) and the trainable is quiescent.  Each
        counter has a single writer; `published` is incremented *before* the
        bus publish, so by the time the runner processes a result the counters
        already agree."""
        return self.granted == self.published


class ConcurrentMeshExecutor(BusDrivenExecutor):
    def __init__(
        self,
        trainable_cls_resolver: Callable[[str], type],
        checkpoint_manager: CheckpointManager,
        total_cpu: float = 64.0,
        total_devices: int = 256,
        slice_pool: Optional[Any] = None,  # dist.submesh.SlicePool
        checkpoint_freq: int = 0,
        heartbeat_timeout: float = 60.0,   # <=0 disables the monitor
        event_bus: Optional[EventBus] = None,
        join_timeout: float = 10.0,
        clock: Optional[Clock] = None,
        obs: Optional[Any] = None,
    ):
        super().__init__(trainable_cls_resolver, checkpoint_manager,
                         total_cpu, total_devices, slice_pool, checkpoint_freq,
                         event_bus=event_bus, clock=clock, obs=obs)
        self.heartbeat_timeout = heartbeat_timeout
        self.join_timeout = join_timeout
        self._event_wait_bound = max(60.0, join_timeout)
        self._ckpt_lock = threading.Lock()  # CheckpointManager/ObjectStore access
        self._shutdown_evt = self.clock.event()
        if heartbeat_timeout and heartbeat_timeout > 0:
            ready = threading.Event()
            self._monitor_thread = threading.Thread(
                target=self._monitor, args=(ready,),
                name="repro-heartbeat", daemon=True)
            self._monitor_thread.start()
            # Wait out the roster handshake so virtual time can never advance
            # while the monitor is still booting (its interval phase would
            # drift nondeterministically otherwise).  Microseconds in real
            # time; the monitor has not parked yet so this cannot block long.
            if not ready.wait(timeout=10.0):
                raise RuntimeError(
                    "heartbeat monitor failed to enroll with the clock "
                    "within 10s")

    # -- worker loop ----------------------------------------------------------------
    def _worker_main(self, ws: _WorkerState) -> None:
        """Thread body: enroll in the clock roster (virtual time only advances
        when every enrolled thread is parked in a clock primitive), then run."""
        with self.clock.running():
            ws.registered.set()
            self._run_worker(ws)

    def _run_worker(self, ws: _WorkerState) -> None:
        trial_id = ws.trial.trial_id
        # Worker-side spans (step, ckpt.save) are batched per result and
        # shipped on the bus as ONE SPAN event just before the RESULT, so the
        # runner adopts them onto the trial's trace row (DESIGN.md §8).
        # Timestamps come from the shared clock — deterministic under virtual
        # time.  With tracing off this adds one attribute test per step.
        traced = self.obs.tracer.enabled
        # Durable resume (DESIGN.md §12): a restored trial carries the virtual
        # timestamp it had reached when the original controller died.  Sleep
        # the clock to that point before the first step so every subsequent
        # result lands at the same virtual time — and hence in the same
        # cross-trial arrival order — as in the uninterrupted run.  One-shot:
        # consumed here so respawns (resize, exploit) never re-apply it.
        phase_t = ws.trial.resume_phase_t
        if phase_t is not None:
            ws.trial.resume_phase_t = None
            self.clock.sleep_until(phase_t)
        while True:
            # Acquire one step credit; the runner grants them on CONTINUE
            # (and _halt releases one after setting stop, so a halted worker
            # wakes here exactly once and exits; no polling).
            ws.credits.acquire()
            if ws.stop.is_set():
                return
            spans = []
            if traced:
                t_step = self.clock.time()
            with ws.lock:
                ws.step_started = self.clock.monotonic()
                ws.in_step = True
                try:
                    metrics = ws.trainable.train()
                except Exception:  # noqa: BLE001 — trial error, not framework error
                    ws.dead = True
                    self.bus.publish(TrialEvent(
                        EventType.ERROR, trial_id, error=traceback.format_exc()))
                    return
                finally:
                    ws.in_step = False
            if ws.stop.is_set():
                # Halted mid-step (shutdown, abort, or abandoned after a join
                # timeout): the runner has moved on — possibly relaunched this
                # trial — so publishing this result or checkpointing now would
                # corrupt the live instance's state.  Discard and exit.
                return
            if traced:
                spans.append(("step", t_step, self.clock.time() - t_step,
                              "train", "host",
                              {"iteration": ws.trainable.iteration}))
            done = bool(metrics.pop("done", False))
            result = Result(
                trial_id=trial_id,
                training_iteration=ws.trainable.iteration,
                metrics=metrics,
                done=done,
                timestamp=self.clock.time(),
            )
            if (
                self.checkpoint_freq
                and ws.trainable.iteration % self.checkpoint_freq == 0
                and not done
            ):
                try:
                    if traced:
                        t_ck = self.clock.time()
                    with ws.lock:
                        ckpt = self._save_locked(ws)
                    if traced:
                        spans.append(("ckpt.save", t_ck,
                                      self.clock.time() - t_ck, "ckpt", "host",
                                      {"iteration": ws.trainable.iteration}))
                    self.bus.publish(TrialEvent(
                        EventType.CHECKPOINTED, trial_id, checkpoint=ckpt,
                        info={"iteration": ws.trainable.iteration}))
                except NotImplementedError:
                    pass
                except Exception:  # noqa: BLE001 — checkpoint failure kills the trial
                    ws.dead = True
                    self.bus.publish(TrialEvent(
                        EventType.ERROR, trial_id, error=traceback.format_exc()))
                    return
            if spans:
                self.bus.publish(TrialEvent(
                    EventType.SPAN, trial_id, info={"spans": spans}))
            ws.published += 1  # before publish: see _WorkerState.parked
            self.bus.publish(TrialEvent(EventType.RESULT, trial_id, result=result))
            if done:
                return  # the runner will stop_trial on the final result

    def _monitor(self, ready: threading.Event) -> None:
        interval = max(0.05, min(1.0, self.heartbeat_timeout / 4))
        with self.clock.running():
            ready.set()
            while not self._shutdown_evt.wait(interval):
                now = self.clock.monotonic()
                for ws in list(self._workers.values()):
                    stalled = ws.in_step and now - ws.step_started > self.heartbeat_timeout
                    if stalled and now - ws.last_warned > self.heartbeat_timeout:
                        ws.last_warned = now
                        self.bus.publish(TrialEvent(
                            EventType.HEARTBEAT_MISSED, ws.trial.trial_id,
                            info={"stalled_s": round(now - ws.step_started, 3)}))

    # -- lifecycle ------------------------------------------------------------------
    def _spawn(self, trial: Trial, trainable: Trainable,
               credits: Optional[int] = None) -> None:
        # A fresh trial starts with the full lookahead grant; a worker
        # respawned mid-decision (resize) starts with 0 — the k un-consumed
        # results' CONTINUEs re-grant the window one resume at a time.
        ws = _WorkerState(trial, trainable, self.clock,
                          credits=self.lookahead if credits is None else credits)
        ws.thread = threading.Thread(
            target=self._worker_main, args=(ws,),
            name=f"repro-worker-{trial.trial_id}", daemon=True)
        self._workers[trial.trial_id] = ws
        trial.set_status(TrialStatus.RUNNING)
        ws.thread.start()
        # Roster handshake (see _worker_main): once start_trial returns, the
        # worker counts toward the virtual clock's all-parked check, so time
        # can never advance "around" a thread that is still booting.  A
        # timeout here is pathological (thread never started registering) —
        # fail loudly rather than run with silently nondeterministic time.
        if not ws.registered.wait(timeout=10.0):
            raise RuntimeError(
                f"worker thread for {trial.trial_id} failed to enroll with "
                "the clock within 10s")

    def _acquire_and_build(
        self, trial: Trial, state: Any = None, iteration: int = 0
    ) -> Optional[Trainable]:
        """Acquire resources + slice and build the trainable (restoring
        ``state`` first, so a worker can never step before the restore lands);
        on any failure roll back the acquisition and mark the trial ERROR."""
        self._acquire_slice(trial)
        try:
            with self.obs.tracer.span("build", trial.trial_id, cat="lifecycle"):
                trainable = self._instantiate(trial)
                if state is not None:
                    trainable.restore(state)
                    trainable.iteration = iteration
            return trainable
        except Exception:
            self._release(trial)
            trial.error = traceback.format_exc()
            trial.set_status(TrialStatus.ERROR)
            return None

    def start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None) -> bool:
        if not self.has_resources(trial):
            return False
        state, iteration = None, 0
        if checkpoint is not None:
            try:
                with self.obs.tracer.span("ckpt.restore", trial.trial_id,
                                          cat="ckpt",
                                          iteration=checkpoint.training_iteration):
                    p0 = _perf()
                    with self._ckpt_lock:
                        state = self.ckpt.restore(checkpoint)
                if self._m_ckpt_restore is not None:
                    self._m_ckpt_restore.observe((_perf() - p0) * 1e6)
            except Exception:
                trial.error = traceback.format_exc()
                trial.set_status(TrialStatus.ERROR)
                return False
            iteration = checkpoint.training_iteration
        trainable = self._acquire_and_build(trial, state, iteration)
        if trainable is None:
            return False
        if checkpoint is not None:
            checkpoint.pinned = False  # consumed; rotation may reclaim it
        self._spawn(trial, trainable)
        return True

    def _halt(self, ws: _WorkerState) -> bool:
        """Stop the worker thread and wait for it to exit (runner thread only).
        Returns False when the join timed out — the worker is still inside a
        straggling step and must be treated as abandoned."""
        ws.stop.set()
        ws.credits.release()  # wake a parked worker; it re-checks stop first
        if ws.thread is not None and ws.thread.is_alive():
            # clock.join_thread, not thread.join: under virtual time the
            # worker may be asleep inside its step, and only the clock can
            # run that sleep down while we wait.
            return self.clock.join_thread(ws.thread, timeout=self.join_timeout)
        return True

    def _reap(self, trial: Trial) -> Optional[_WorkerState]:
        """Halt + remove the worker, clean up the trainable, release resources.

        An abandoned worker (join timed out mid-step) keeps its resources and
        slice leaked on purpose: the thread is still dispatching on that
        sub-mesh, and releasing it would let a new trial step on the same
        devices concurrently."""
        ws = self._workers.pop(trial.trial_id, None)
        if ws is None:
            return None
        if not self._halt(ws):
            return ws
        try:
            ws.trainable.cleanup()
        except Exception:  # noqa: BLE001
            pass
        self._release(trial)
        return ws

    # -- checkpoints ------------------------------------------------------------------
    def _save_locked(self, ws: _WorkerState) -> Checkpoint:
        """Caller holds ws.lock (or the thread is joined)."""
        p0 = _perf()
        state = ws.trainable.save()
        with self._ckpt_lock:
            ckpt = self.ckpt.save(ws.trial.trial_id, ws.trainable.iteration, state)
        if self._m_ckpt_save is not None:
            self._m_ckpt_save.observe((_perf() - p0) * 1e6)
        ws.trial.checkpoint = ckpt
        return ckpt

    def save_checkpoint(self, trial: Trial) -> Checkpoint:
        ws = self._workers[trial.trial_id]
        # Never block bare on ws.lock: a worker mid-step holds it while
        # parked in clock.sleep, and a runnable-but-OS-blocked runner would
        # freeze virtual time (the worker's step could then never finish).
        # Pacing the acquisition through the clock lets virtual time run the
        # in-flight step down while we wait; on the wall clock the contended
        # path degrades to a 5ms poll of a lock held for a full step anyway.
        while not ws.lock.acquire(blocking=False):
            self.clock.sleep(0.005)
        try:
            return self._save_locked(ws)
        finally:
            ws.lock.release()

    # -- runner-driven transitions -------------------------------------------------
    def resume_trial(self, trial: Trial) -> None:
        ws = self._workers.get(trial.trial_id)
        if ws is not None and not ws.dead:
            ws.granted += 1
            ws.credits.release()

    def trial_idle(self, trial: Trial) -> bool:
        ws = self._workers.get(trial.trial_id)
        return ws is not None and not ws.dead and ws.parked

    def resize_trial(self, trial: Trial, new_devices: int) -> bool:
        """Checkpoint-boundary slice resize (DESIGN.md §6): the worker is
        parked at the credit gate, so halting it is immediate.  The rebuild
        core (`_resize_rebuild`) rolls back to the exact old slice on any
        failure, in which case the old trainable is respawned — the trial
        never observes a torn state."""
        ws = self._workers.get(trial.trial_id)
        if (ws is None or ws.dead or self.slice_pool is None
                or new_devices == trial.resources.devices
                or not ws.parked):
            return False
        # The worker is parked (no granted-but-unpublished steps), so once
        # stop is set its only remaining action is the side-effect-free
        # stop-check right after the credit gate — it can never touch the
        # trainable again.  Even a starved join (timeout) is therefore safe
        # to proceed past; the thread exits on its own without stepping.
        self._halt(ws)
        del self._workers[trial.trial_id]  # resources stay acquired
        new_trainable = self._resize_rebuild(trial, ws.trainable, new_devices)
        # Respawn with 0 credits: at this boundary exactly k results are
        # un-consumed (credits granted = k + consumed, all stepped), and each
        # of their CONTINUEs — starting with the resume_trial that follows
        # this resize — grants one credit, restoring the k-wide window.
        # Seeding more here would inflate it past k.
        self._spawn(trial, new_trainable if new_trainable is not None
                    else ws.trainable, credits=0)
        return new_trainable is not None

    def pause_trial(self, trial: Trial) -> None:
        ws = self._workers.get(trial.trial_id)
        if ws is not None:
            joined = self._halt(ws)
            if joined and not ws.dead:
                self._save_locked(ws)  # safe: thread exited, no torn state
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
        """Tear down a failed instance, keeping the trial restartable from its
        last checkpoint (the runner's max_failures retry path).  The runner
        logs the RESTARTED event itself — publishing here too would deliver
        every retry twice."""
        self._reap(trial)
        self._set_requeue_status(trial)

    def restart_trial_with_config(
        self, trial: Trial, checkpoint: Checkpoint, new_config: Dict[str, Any]
    ) -> None:
        """PBT exploit: restore donor state under a mutated config.

        The worker is parked at the resume gate when this is called (the
        decision was made on its latest result), so halting it is immediate.
        """
        trial.config = dict(new_config)
        with self._ckpt_lock:
            state = self.ckpt.restore(checkpoint)
        ws = self._workers.get(trial.trial_id)
        if ws is not None:
            joined = self._halt(ws)
            if joined and not ws.dead and ws.trainable.reset_config(new_config):
                ws.trainable.restore(state)
                ws.trainable.iteration = checkpoint.training_iteration
                del self._workers[trial.trial_id]  # resources stay acquired
                self._spawn(trial, ws.trainable)
                return
            self._reap(trial)
            trial.set_status(TrialStatus.PAUSED)
        # Full rebuild with the donor state restored before launch.
        if not self.has_resources(trial):
            trial.checkpoint = checkpoint  # re-queue; next launch restores donor
            trial.set_status(TrialStatus.PAUSED)
            return
        trainable = self._acquire_and_build(
            trial, state, checkpoint.training_iteration)
        if trainable is not None:
            self._spawn(trial, trainable)

    # -- event delivery: BusDrivenExecutor.get_next_event -----------------------------
    def get_trainable(self, trial_id: str) -> Optional[Trainable]:
        ws = self._workers.get(trial_id)
        return ws.trainable if ws is not None else None

    def shutdown(self) -> None:
        self._shutdown_evt.set()
        for trial_id in list(self._workers):
            self._reap(self._workers[trial_id].trial)
        if self._monitor_thread is not None and self._monitor_thread.is_alive():
            self.clock.join_thread(self._monitor_thread, timeout=2.0)
