"""Trial executors — the Ray-actor analogue on a TPU mesh (DESIGN.md §2).

``SerialMeshExecutor`` steps RUNNING trainables round-robin from the host loop:
TPU slices are the scarce resource, so cooperative time-slicing on the host
preserves the paper's event semantics (irregular trial lengths, intermediate
results, pause/clone) while the accelerator work inside each ``step`` is the
jitted, sharded computation.  The ``SlicePool`` (dist/submesh.py) hands each
trial a sub-mesh sized to its resource request.

``VmapExecutor`` lives in vmap_executor.py (beyond-paper optimization).
"""
from __future__ import annotations

import traceback
from collections import deque
from time import perf_counter as _perf
from typing import Any, Callable, Dict, Optional, Tuple

from ..obs import NULL_OBS
from .api import Trainable
from .checkpoint import CheckpointManager
from .clock import Clock, get_default_clock
from .events import EventBus, EventType, TrialEvent
from .resources import ResourceAccountant, Resources
from .trial import Checkpoint, Result, Trial, TrialStatus

__all__ = ["TrialExecutor", "SerialMeshExecutor", "BusDrivenExecutor"]


class TrialExecutor:
    """Interface the runner drives."""

    lookahead = 1  # un-consumed results a worker may run ahead of the scheduler

    def set_lookahead(self, k: int) -> None:
        """Installed by the elastic ResourceBroker (DESIGN.md §6) before any
        trial starts.  Gated tiers spawn workers with this many step credits;
        poll-style executors are inherently one-at-a-time and ignore it."""
        self.lookahead = max(1, int(k))

    def resize_trial(self, trial: Trial, new_devices: int) -> bool:
        """Grow/shrink the trial's mesh slice at a checkpoint boundary
        (SAVE -> swap slice -> rebuild + re-shard -> RESTORE).  Returns False
        when unsupported or rolled back — the trial then keeps stepping on its
        old slice.  Default: unsupported."""
        return False

    def trial_idle(self, trial: Trial) -> bool:
        """True when the trial's worker is parked at the resume gate with no
        granted-but-unfinished steps — the only state a resize may interrupt.
        Poll-style executors only step while the runner waits, so whenever the
        runner holds control every trial is at a boundary."""
        return True

    def held_slice(self, trial_id: str):
        """The MeshSlice the trial currently holds, or None."""
        return None

    def start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None) -> bool:
        raise NotImplementedError

    def pause_trial(self, trial: Trial) -> None:
        raise NotImplementedError

    def stop_trial(self, trial: Trial, error: Optional[str] = None) -> None:
        raise NotImplementedError

    def requeue_trial(self, trial: Trial) -> None:
        """Tear down a failed trial instance without finishing the trial, so the
        runner can restart it from its last checkpoint (max_failures retry)."""
        raise NotImplementedError

    def restart_trial_with_config(
        self, trial: Trial, checkpoint: Checkpoint, new_config: Dict[str, Any]
    ) -> None:
        raise NotImplementedError

    def get_next_result(self) -> Optional[Tuple[Trial, Any]]:
        raise NotImplementedError

    def get_next_event(self) -> Optional[TrialEvent]:
        """Next ``TrialEvent`` for the runner's event loop.

        Compat shim for poll-style executors: wraps ``get_next_result()``
        pairs into typed events.  Push-style executors (concurrent_executor)
        override this to drain their EventBus instead.
        """
        pair = self.get_next_result()
        if pair is None:
            return None
        trial, payload = pair
        if isinstance(payload, Exception):
            return TrialEvent(EventType.ERROR, trial.trial_id, error=str(payload))
        return TrialEvent(EventType.RESULT, trial.trial_id, result=payload)

    def resume_trial(self, trial: Trial) -> None:
        """CONTINUE decision applied; gated executors let the trial's next
        step proceed.  Poll-style executors advance implicitly — no-op."""

    def has_resources(self, trial: Trial) -> bool:
        raise NotImplementedError

    def has_running(self) -> bool:
        raise NotImplementedError

    def save_checkpoint(self, trial: Trial) -> Checkpoint:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class _SlicedExecutor(TrialExecutor):
    """Shared capacity/placement accounting for executors that place each
    trial on a SlicePool sub-mesh (serial and concurrent).  One copy of the
    acquire/instantiate/release logic keeps their placement behavior from
    drifting apart."""

    def __init__(
        self,
        trainable_cls_resolver: Callable[[str], type],
        checkpoint_manager: CheckpointManager,
        total_cpu: float = 64.0,
        total_devices: int = 256,
        slice_pool: Optional[Any] = None,  # dist.submesh.SlicePool
        checkpoint_freq: int = 0,
        clock: Optional[Clock] = None,
        obs: Optional[Any] = None,  # repro_torch.obs.Observability
    ):
        self._resolve = trainable_cls_resolver
        self.ckpt = checkpoint_manager
        self.accountant = ResourceAccountant(total_cpu, total_devices)
        self.slice_pool = slice_pool
        self.checkpoint_freq = checkpoint_freq
        self.clock = clock or get_default_clock()
        self.obs = obs or NULL_OBS
        self._slices: Dict[str, Any] = {}
        # Pre-resolved hot-path instruments (DESIGN.md §8): with obs off each
        # guard is a single None test.
        m = self.obs.metrics
        if m is not None:
            self._m_acquire = m.histogram("pool.acquire_us")
            self._m_ckpt_save = m.histogram("ckpt.save_us")
            self._m_ckpt_restore = m.histogram("ckpt.restore_us")
        else:
            self._m_acquire = self._m_ckpt_save = self._m_ckpt_restore = None

    def _pool_for(self, trial: Trial) -> Optional[Any]:
        """The SlicePool this trial places on.  Single-host tiers share one
        pool; the cluster tier overrides this to the trial's host pool, which
        is what lets ``resize_trial`` / the elastic broker / slice release all
        stay host-correct without knowing about hosts."""
        return self.slice_pool

    def has_resources(self, trial: Trial) -> bool:
        pool = self._pool_for(trial)
        if pool is not None and not pool.can_fit(trial.resources.devices):
            return False
        return self.accountant.has_room(trial.resources)

    def _acquire_slice(self, trial: Trial) -> None:
        """Accountant + pool placement for one trial — the shared first-fit
        hot path, timed (``pool.acquire_us``) and traced (``slice.acquire``)."""
        self.accountant.acquire(trial.resources)
        pool = self._pool_for(trial)
        if pool is None:
            return
        tracer = self.obs.tracer
        if self._m_acquire is None and not tracer.enabled:
            self._slices[trial.trial_id] = \
                pool.acquire(trial.resources.devices)
            return
        t0 = tracer.clock.time() if tracer.enabled else 0.0
        p0 = _perf()
        sl = pool.acquire(trial.resources.devices)
        if self._m_acquire is not None:
            self._m_acquire.observe((_perf() - p0) * 1e6)
        self._slices[trial.trial_id] = sl
        if tracer.enabled:
            tracer.record("slice.acquire", trial.trial_id, t0,
                          tracer.clock.time() - t0, cat="placement",
                          devices=trial.resources.devices, start=sl.start)

    def _instantiate(self, trial: Trial) -> Trainable:
        cls = self._resolve(trial.trainable_name)
        config = dict(trial.config)
        if trial.trial_id in self._slices:
            config["_slice"] = self._slices[trial.trial_id]
        return cls(config)

    def _release(self, trial: Trial) -> None:
        self.accountant.release(trial.resources)
        pool = self._pool_for(trial)
        if pool is not None and trial.trial_id in self._slices:
            pool.release(self._slices.pop(trial.trial_id))

    def _set_requeue_status(self, trial: Trial) -> None:
        trial.set_status(
            TrialStatus.PAUSED if trial.checkpoint is not None else TrialStatus.PENDING)

    def held_slice(self, trial_id: str):
        return self._slices.get(trial_id)

    # -- elastic slice swap (DESIGN.md §6) ------------------------------------------
    def _swap_slice(self, trial: Trial, new_devices: int) -> Tuple[Any, Any, Any]:
        """Move the trial's pool slice and accounting to ``new_devices``.

        Returns ``(old_resources, old_slice, new_slice)`` for a later rollback
        via ``_unswap_slice``; raises RuntimeError (pool or accountant full)
        with everything unchanged.  No trainable side effects — the caller
        rebuilds the mesh around this.
        """
        from .resources import Resources
        pool = self._pool_for(trial)
        old_res = trial.resources
        new_res = Resources(cpu=old_res.cpu, devices=new_devices)
        old_sl = self._slices[trial.trial_id]
        new_sl = pool.resize(old_sl, new_devices)
        try:
            self.accountant.release(old_res)
            self.accountant.acquire(new_res)
        except RuntimeError:
            # Pool moved but the accountant refused: put the exact old range
            # back (nothing else allocated in between — runner thread).
            self.accountant.acquire(old_res)
            pool.release(new_sl)
            restored = pool.acquire_at(old_sl.start, old_sl.size)
            self._slices[trial.trial_id] = restored
            raise
        self._slices[trial.trial_id] = new_sl
        trial.resources = new_res
        return old_res, old_sl, new_sl

    def _unswap_slice(self, trial: Trial, old_res: Any, old_sl: Any,
                      new_sl: Any) -> None:
        """Roll a ``_swap_slice`` back after a failed rebuild: the trial ends
        up on the *exact* old device range its live mesh still covers."""
        pool = self._pool_for(trial)
        pool.release(new_sl)
        restored = pool.acquire_at(old_sl.start, old_sl.size)
        self.accountant.release(trial.resources)
        self.accountant.acquire(old_res)
        self._slices[trial.trial_id] = restored
        trial.resources = old_res

    def _resize_rebuild(self, trial: Trial, trainable: Trainable,
                        new_devices: int):
        """The in-host resize core shared by the serial and thread tiers:
        SAVE (in-memory) -> swap the pool slice -> rebuild the trainable over
        the new sub-mesh (its setup re-shards via repro_torch.dist.sharding from
        the new ``_slice``) -> RESTORE, iteration preserved.  Returns the
        rebuilt trainable, or None with the swap fully rolled back — the
        caller then keeps ``trainable`` serving on the old slice."""
        try:
            state = trainable.save()
        except Exception:  # noqa: BLE001 — unsaveable trainables can't resize
            return None
        try:
            old_res, old_sl, new_sl = self._swap_slice(trial, new_devices)
        except RuntimeError:
            return None
        new_trainable = None
        try:
            new_trainable = self._instantiate(trial)
            new_trainable.restore(state)
            new_trainable.iteration = trainable.iteration
        except Exception:  # noqa: BLE001 — fall back to the old slice
            if new_trainable is not None:  # built but failed to restore
                try:
                    new_trainable.cleanup()
                except Exception:  # noqa: BLE001
                    pass
            self._unswap_slice(trial, old_res, old_sl, new_sl)
            return None
        try:
            trainable.cleanup()
        except Exception:  # noqa: BLE001
            pass
        return new_trainable


class BusDrivenExecutor(_SlicedExecutor):
    """Base for push-style executors whose workers (threads or processes)
    publish ``TrialEvent``s on a shared ``EventBus`` while the runner blocks in
    ``get_next_event``.  Subclasses keep live workers in ``self._workers``
    (mutated only from the runner thread) and may run a monitor thread in
    ``self._monitor_thread`` that guarantees an eventual event for stuck steps.
    """

    def __init__(self, *args, event_bus: Optional[EventBus] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.bus = event_bus or EventBus(clock=self.clock,
                                         metrics=self.obs.metrics)
        self._workers: Dict[str, Any] = {}
        self._monitor_thread: Optional[Any] = None
        self._event_wait_bound = 60.0

    def _events_guaranteed(self) -> bool:
        """True when a monitor thread will eventually publish an event even if
        every worker is stuck (so an unbounded runner wait is safe)."""
        return self._monitor_thread is not None

    def has_running(self) -> bool:
        return bool(self._workers)

    def get_next_event(self, timeout: Optional[float] = None) -> Optional[TrialEvent]:
        """Block until an event arrives or no worker can produce one.

        With live workers this waits (bounded only by their progress — the
        monitor thread guarantees an eventual event for stuck steps); with
        none it drains whatever is queued and then returns None.  When the
        monitor is disabled that guarantee is gone, so the wait is bounded
        (~60s) instead: the runner's stall detector stays reachable and a
        hung step surfaces as a stall error rather than a silent hang.

        Deadline arithmetic runs on ``clock.monotonic()`` — never the wall
        timestamp axis, which NTP steps or a suspended laptop can jump by
        hours, silently expiring (or never expiring) a 0.5s wait.
        """
        deadline = None if timeout is None else self.clock.monotonic() + timeout
        if deadline is None and not self._events_guaranteed():
            deadline = self.clock.monotonic() + self._event_wait_bound
        while True:
            # _workers is mutated only by this (runner) thread, so the check
            # can't race; block on the queue in long slices instead of polling.
            if not self._workers:
                return self.bus.get()
            wait = 0.5
            if deadline is not None:
                wait = min(wait, deadline - self.clock.monotonic())
                if wait <= 0:
                    return None
            ev = self.bus.get(timeout=wait)
            if ev is not None:
                return ev


class SerialMeshExecutor(_SlicedExecutor):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._running: Dict[str, Trainable] = {}
        self._queue: deque = deque()  # round-robin order of trial_ids
        self._trials: Dict[str, Trial] = {}

    def has_running(self) -> bool:
        return bool(self._running)

    def start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None) -> bool:
        if not self.has_resources(trial):
            return False
        self._acquire_slice(trial)
        tracer = self.obs.tracer
        try:
            with tracer.span("build", trial.trial_id, cat="lifecycle"):
                trainable = self._instantiate(trial)
            if checkpoint is not None:
                with tracer.span("ckpt.restore", trial.trial_id, cat="ckpt",
                                 iteration=checkpoint.training_iteration):
                    p0 = _perf()
                    state = self.ckpt.restore(checkpoint)
                    trainable.restore(state)
                if self._m_ckpt_restore is not None:
                    self._m_ckpt_restore.observe((_perf() - p0) * 1e6)
                trainable.iteration = checkpoint.training_iteration
                checkpoint.pinned = False  # consumed; rotation may reclaim it
        except Exception:
            self._release(trial)
            trial.error = traceback.format_exc()
            trial.set_status(TrialStatus.ERROR)
            return False
        self._running[trial.trial_id] = trainable
        self._trials[trial.trial_id] = trial
        self._queue.append(trial.trial_id)
        trial.set_status(TrialStatus.RUNNING)
        return True

    def _teardown(self, trial: Trial) -> None:
        trainable = self._running.pop(trial.trial_id, None)
        if trainable is not None:
            try:
                trainable.cleanup()
            except Exception:
                pass
            self._release(trial)
        try:
            self._queue.remove(trial.trial_id)
        except ValueError:
            pass

    def save_checkpoint(self, trial: Trial) -> Checkpoint:
        trainable = self._running[trial.trial_id]
        with self.obs.tracer.span("ckpt.save", trial.trial_id, cat="ckpt",
                                  iteration=trainable.iteration):
            p0 = _perf()
            state = trainable.save()
            ckpt = self.ckpt.save(trial.trial_id, trainable.iteration, state)
        if self._m_ckpt_save is not None:
            self._m_ckpt_save.observe((_perf() - p0) * 1e6)
        trial.checkpoint = ckpt
        return ckpt

    def pause_trial(self, trial: Trial) -> None:
        if trial.trial_id in self._running:
            self.save_checkpoint(trial)
            self._teardown(trial)
        trial.set_status(TrialStatus.PAUSED)

    def stop_trial(self, trial: Trial, error: Optional[str] = None) -> None:
        self._teardown(trial)
        if error:
            trial.error = error
            trial.set_status(TrialStatus.ERROR)
        else:
            trial.set_status(TrialStatus.TERMINATED)

    def requeue_trial(self, trial: Trial) -> None:
        """Tear down a failed instance, keeping the trial restartable from its
        last checkpoint (the runner's max_failures retry path)."""
        self._teardown(trial)
        self._set_requeue_status(trial)

    def restart_trial_with_config(self, trial, checkpoint, new_config) -> None:
        """PBT exploit: restore donor state under a mutated config.

        Tries in-place ``reset_config`` first (cheap); falls back to full
        teardown + rebuild, exactly like Ray Tune's reuse_actors path.
        """
        trial.config = dict(new_config)
        trainable = self._running.get(trial.trial_id)
        state = self.ckpt.restore(checkpoint)
        if trainable is not None and trainable.reset_config(new_config):
            trainable.restore(state)
            trainable.iteration = checkpoint.training_iteration
        else:
            if trainable is not None:
                self._teardown(trial)
                trial.set_status(TrialStatus.PAUSED)
            started = self.start_trial(trial, checkpoint=None)
            if not started:
                if trial.status != TrialStatus.ERROR:
                    # No capacity to rebuild right now: re-queue PAUSED with
                    # the donor checkpoint attached so the next launch
                    # restores it — never leave the trial sliceless in limbo.
                    trial.checkpoint = checkpoint
                    trial.set_status(TrialStatus.PAUSED)
                return
            new_trainable = self._running[trial.trial_id]
            new_trainable.restore(state)
            new_trainable.iteration = checkpoint.training_iteration

    # -- elastic resize (DESIGN.md §6) ----------------------------------------------
    def resize_trial(self, trial: Trial, new_devices: int) -> bool:
        """Checkpoint-boundary slice resize; on any rebuild failure the swap
        is rolled back and the old trainable keeps running on its old slice
        (see ``_resize_rebuild``)."""
        trainable = self._running.get(trial.trial_id)
        if (trainable is None or self.slice_pool is None
                or new_devices == trial.resources.devices):
            return False
        new_trainable = self._resize_rebuild(trial, trainable, new_devices)
        if new_trainable is None:
            return False
        self._running[trial.trial_id] = new_trainable
        return True

    # -- stepping -------------------------------------------------------------------
    def get_next_result(self) -> Optional[Tuple[Trial, Any]]:
        """Step the next running trainable one unit; return (trial, Result|Exception)."""
        while self._queue:
            trial_id = self._queue[0]
            self._queue.rotate(-1)
            trainable = self._running.get(trial_id)
            if trainable is None:
                try:
                    self._queue.remove(trial_id)
                except ValueError:
                    pass
                continue
            trial = self._trials[trial_id]
            tracer = self.obs.tracer
            try:
                if tracer.enabled:
                    t0 = tracer.clock.time()
                    metrics = trainable.train()
                    tracer.record("step", trial_id, t0,
                                  tracer.clock.time() - t0, cat="train",
                                  iteration=trainable.iteration)
                else:
                    metrics = trainable.train()
            except Exception as e:  # noqa: BLE001 — trial error, not framework error
                return trial, e
            done = bool(metrics.pop("done", False))
            result = Result(
                trial_id=trial_id,
                training_iteration=trainable.iteration,
                metrics=metrics,
                done=done,
                timestamp=self.clock.time(),
            )
            if (
                self.checkpoint_freq
                and trainable.iteration % self.checkpoint_freq == 0
                and not done
            ):
                try:
                    self.save_checkpoint(trial)
                except NotImplementedError:
                    pass
                except Exception as e:  # noqa: BLE001 — checkpoint failure is a
                    return trial, e     # trial error (retryable), not framework death
            return trial, result
        return None

    def get_trainable(self, trial_id: str) -> Optional[Trainable]:
        return self._running.get(trial_id)

    def shutdown(self) -> None:
        for trial_id in list(self._running):
            trial = self._trials[trial_id]
            self._teardown(trial)
