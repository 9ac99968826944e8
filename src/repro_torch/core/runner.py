"""TrialRunner — the event loop wiring trials, scheduler, searcher and executor.

One ``step()`` = (1) launch trials while the scheduler offers one and resources
allow (pulling fresh suggestions from the searcher when the explicit trial list
is exhausted); (2) drain the next ``TrialEvent`` from the executor (worker
threads push RESULT/ERROR/CHECKPOINTED/HEARTBEAT_MISSED onto an EventBus;
poll-style executors are adapted by ``TrialExecutor.get_next_event``'s compat
shim); (3) let the scheduler decide CONTINUE / PAUSE / STOP /
RESTART_WITH_CONFIG and apply it.  Trial metadata is kept in memory; fault
tolerance is via checkpoints (paper §4.2): a trial whose trainable raises is
restarted from its last checkpoint up to ``max_failures`` times before it is
marked ERROR, and the experiment aborts when errored trials exceed
``max_experiment_failures``.
"""
from __future__ import annotations

import itertools
from time import perf_counter as _perf
from typing import Any, Callable, Dict, List, Optional, Union

from ..obs import NULL_OBS
from ..obs.flightrec import json_safe as _json_safe
from .events import EventType, TrialEvent
from .executor import TrialExecutor
from .loggers import Logger
from .resources import Resources
from .schedulers.base import SchedulerDecision, TrialScheduler
from .search.basic import Searcher
from .trial import Result, Trial, TrialStatus

__all__ = ["TrialRunner"]


class TrialRunner:
    def __init__(
        self,
        scheduler: TrialScheduler,
        executor: TrialExecutor,
        searcher: Optional[Searcher] = None,
        logger: Optional[Logger] = None,
        trainable_name: str = "trainable",
        default_resources: Optional[Resources] = None,
        stopping_criteria: Optional[Dict[str, float]] = None,
        max_pending_from_searcher: int = 0,  # 0 = unlimited
        max_failures: int = 0,               # per-trial restarts-from-checkpoint
        max_experiment_failures: int = 0,    # 0 = unlimited errored trials
        broker: Optional[Any] = None,        # elastic.ResourceBroker (DESIGN.md §6)
        obs: Optional[Any] = None,           # repro_torch.obs.Observability (§8)
        decisions: Union[bool, str] = True,  # DECISION journaling (§10): True |
                                             # "full" (incl. CONTINUE) | False
        flight_recorder: Optional[Any] = None,    # repro_torch.obs.FlightRecorder (§10)
        state_snapshotter: Optional[Any] = None,  # SearchStateSnapshotter (§10)
    ):
        self.scheduler = scheduler
        self.executor = executor
        self.obs = obs or NULL_OBS
        self.decisions = decisions
        self.flightrec = flight_recorder
        self.state_snapshotter = state_snapshotter
        # Pre-resolved hot-path instruments (one None test per use when off).
        m = self.obs.metrics
        if m is not None:
            self._m_choose = m.histogram("sched.choose_us")
            self._m_decide = m.histogram("sched.decision_us")
            self._m_restarts = m.counter("trials.restarts")
        else:
            self._m_choose = self._m_decide = self._m_restarts = None
        self.searcher = searcher
        self.logger = logger or Logger()
        self.trainable_name = trainable_name
        self.default_resources = default_resources or Resources()
        self.stopping_criteria = dict(stopping_criteria or {})
        self.max_pending_from_searcher = max_pending_from_searcher
        self.max_failures = max_failures
        self.max_experiment_failures = max_experiment_failures
        self.trials: List[Trial] = []
        self._by_id: Dict[str, Trial] = {}
        # Indexed ready-queue (DESIGN.md §9): trials bucketed by
        # (status, resource shape) so choose_trial_to_run / is_finished cost
        # O(#shapes) instead of scanning all n trials.  Maintained by the
        # status listener installed on every trial in add_trial; all status
        # transitions happen on the runner thread (executors call
        # trial.set_status from start/stop/pause paths the runner drives), so
        # plain dicts need no lock.  Dicts are insertion-ordered: within a
        # bucket the head is the oldest (re)queued trial of that shape.
        self._status_index: Dict[TrialStatus, Dict[Resources, Dict[str, Trial]]] = {
            s: {} for s in TrialStatus}
        self._enq_counter = itertools.count()
        self._n_finished = 0  # TERMINATED + ERROR, kept by the listener
        self._searcher_exhausted = searcher is None
        self._suggest_counter = itertools.count()
        self.n_errors = 0
        self.n_restarts = 0
        # Durable resume (DESIGN.md §12), installed by apply_resume_plan:
        # - result fences: re-executed iterations <= fence were already
        #   journaled before the crash — drop them (re-opening the credit
        #   gate) so the merged journal carries each result exactly once;
        # - event fences: ditto for iteration-stamped non-result events
        #   (CHECKPOINTED), keyed per event kind;
        # - resume queue: restored trials launched (phase-ordered) ahead of
        #   the scheduler's own choose loop so fresh PENDING trials cannot
        #   steal their capacity.
        self._resume_result_fence: Dict[str, int] = {}
        self._resume_event_fence: Dict[str, Dict[str, int]] = {}
        self._resume_queue: List[str] = []
        self.broker = broker
        if broker is not None:
            # Installs the effective lookahead on the executor (clamped to 1
            # unless the scheduler declares decision_interval() == 0).
            broker.bind(self)

    # -- trial management ------------------------------------------------------
    def add_trial(self, trial: Trial) -> None:
        self.trials.append(trial)
        self._by_id[trial.trial_id] = trial
        trial._status_listener = self._on_status_change
        if trial.status.is_finished():
            self._n_finished += 1
        self._index_insert(trial)
        self.scheduler.on_trial_add(self, trial)

    def adopt_trial(self, trial: Trial) -> None:
        """Add a restored trial WITHOUT notifying the scheduler.

        Durable resume rebuilds scheduler state from its snapshot / the
        journal replay, which already reflects every ``on_trial_add`` of the
        original run — re-firing the hook here would double-register the
        trial (and burn scheduler RNG draws, e.g. ASHA's per-add bracket
        choice), diverging every later verdict.
        """
        self.trials.append(trial)
        self._by_id[trial.trial_id] = trial
        trial._status_listener = self._on_status_change
        if trial.status.is_finished():
            self._n_finished += 1
        self._index_insert(trial)

    def apply_resume_plan(self, plan: Any) -> None:
        """Install a ``repro_torch.core.resume.ResumePlan``: adopt its trials and
        arm the fences + phase-ordered relaunch queue (DESIGN.md §12)."""
        for trial in plan.trials:
            if trial.trial_id not in self._by_id:
                self.adopt_trial(trial)
        self._resume_result_fence = dict(plan.result_fences)
        self._resume_event_fence = {
            tid: dict(kinds) for tid, kinds in plan.event_fences.items()}
        self._resume_queue = [
            tid for tid in plan.resume_order
            if not self.scheduler.holds_trial(tid)]
        if plan.next_suggest_index:
            self._suggest_counter = itertools.count(plan.next_suggest_index)

    # -- status index ------------------------------------------------------------
    def _index_insert(self, trial: Trial) -> None:
        key = (trial.status, trial.resources)
        self._status_index[key[0]].setdefault(key[1], {})[trial.trial_id] = trial
        # Remember the exact bucket: an elastic resize may swap
        # trial.resources while the trial sits in a bucket keyed by the old
        # shape, so removal must not re-derive the key from the trial.
        trial._index_key = key
        trial._enq_seq = next(self._enq_counter)

    def _index_remove(self, trial: Trial) -> None:
        key = getattr(trial, "_index_key", None)
        if key is None:
            return
        bucket = self._status_index[key[0]].get(key[1])
        if bucket is not None:
            bucket.pop(trial.trial_id, None)
        trial._index_key = None

    def _on_status_change(self, trial: Trial, old: TrialStatus,
                          new: TrialStatus) -> None:
        self._n_finished += new.is_finished() - old.is_finished()
        self._index_remove(trial)
        self._index_insert(trial)

    def next_ready(self, status: TrialStatus,
                   fit: Optional[Callable[[Trial], bool]] = None
                   ) -> Optional[Trial]:
        """Oldest trial in ``status`` that the executor can place right now.

        ``has_resources`` is a pure function of the resource shape given pool
        state (frozen across this call), so it runs once per bucket — the
        indexed replacement for the per-trial O(n) scan.  ``fit`` filters
        candidates within a bucket (e.g. HyperBand's crash-requeue test);
        oldest is by (re)queue order, so a requeued trial goes to the back of
        the line rather than retaking its original submission slot.
        """
        best: Optional[Trial] = None
        for bucket in self._status_index[status].values():
            if not bucket:
                continue
            probe = next(iter(bucket.values()))
            if not self.executor.has_resources(probe):
                continue
            for t in bucket.values():
                if fit is None or fit(t):
                    if best is None or t._enq_seq < best._enq_seq:
                        best = t
                    break  # bucket is ordered: first fit-passing is oldest
        return best

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        return self._by_id.get(trial_id)

    def has_resources(self, trial: Trial) -> bool:
        return self.executor.has_resources(trial)

    def stop_trial(self, trial: Trial) -> None:
        self.executor.stop_trial(trial)
        self.obs.tracer.end(("trial", trial.trial_id), status=trial.status.name)
        self.scheduler.on_trial_complete(self, trial)
        self.logger.on_trial_complete(trial)
        self._observe(trial, final=True)

    # -- decision provenance (DESIGN.md §10) -------------------------------------
    def _emit_decision(self, trial_id: str, source: str, by: str,
                       record: Dict[str, Any]) -> None:
        """Journal one decision record as a DECISION TrialEvent."""
        info = {"source": source, "by": by,
                "verdict": record.get("verdict"),
                "iteration": record.get("iteration"),
                "inputs": _json_safe(record.get("inputs") or {})}
        clock = getattr(self.executor, "clock", None)
        event = TrialEvent(
            EventType.DECISION, trial_id, info=info,
            timestamp=clock.time() if clock is not None else None)
        trial = self.get_trial(trial_id)
        if trial is not None:
            self.logger.on_event(trial, event)
        if self.flightrec is not None:
            self.flightrec.record_decision(event)

    def _drain_scheduler_decisions(self) -> None:
        """Journal verdicts the scheduler recorded during its last call.

        Drained after every on_result/on_trial_error so peer verdicts (e.g.
        a HyperBand cut stopping PAUSED peers directly) land in the journal
        even though they never surface as a returned decision.
        """
        records = self.scheduler.pop_decisions()
        if not records or self.decisions is False:
            return
        by = type(self.scheduler).__name__
        for rec in records:
            if self.decisions != "full" and rec.get("verdict") == "CONTINUE":
                continue
            self._emit_decision(rec["trial_id"], "scheduler", by, rec)

    # -- searcher integration ----------------------------------------------------
    def _maybe_suggest(self) -> Optional[Trial]:
        if self._searcher_exhausted:
            return None
        live = len(self.trials) - self._n_finished
        if self.max_pending_from_searcher and live >= self.max_pending_from_searcher:
            return None

        # Only pull a suggestion when it can actually start now: suggesting
        # ahead of capacity would drain the searcher before any results come
        # back, degrading TPE/BayesOpt to random search.
        class _Probe:
            resources = self.default_resources
        if not self.executor.has_resources(_Probe()):
            return None
        trial_id = f"{self.trainable_name}_sugg_{next(self._suggest_counter):05d}"
        config = self.searcher.suggest(trial_id)
        if config is None:
            self._searcher_exhausted = True
            return None
        if self.decisions is not False:
            rec = self.searcher.explain_last()
            if rec is not None and rec.get("trial_id") == trial_id:
                # Emitted after add_trial below so the logger can resolve the
                # trial; buffer the record until then.
                pending_suggest = rec
            else:
                pending_suggest = None
        else:
            pending_suggest = None
        trial = Trial(
            config=config,
            trainable_name=self.trainable_name,
            resources=self.default_resources,
            stopping_criteria=self.stopping_criteria,
            trial_id=trial_id,
        )
        self.add_trial(trial)
        if pending_suggest is not None:
            self._emit_decision(trial_id, "searcher",
                                type(self.searcher).__name__, pending_suggest)
        return trial

    def _observe(self, trial: Trial, final: bool) -> None:
        if self.searcher is None or trial.last_result is None:
            return
        metric = self.searcher.metric
        if metric in trial.last_result.metrics:
            self.searcher.observe(
                trial.trial_id, trial.config, trial.last_result.value(metric), final
            )

    # -- main loop -----------------------------------------------------------------
    def is_finished(self) -> bool:
        if self.executor.has_running():
            return False
        # One has_resources probe per (status, shape) bucket via the index —
        # this runs after every event, so it must not scan all n trials.
        for status in (TrialStatus.PENDING, TrialStatus.PAUSED):
            for bucket in self._status_index[status].values():
                if not bucket:
                    continue
                if self.executor.has_resources(next(iter(bucket.values()))):
                    return False
        if not self._searcher_exhausted:
            return False
        return True

    def _choose(self) -> Optional[Trial]:
        """``choose_trial_to_run``, timed into ``sched.choose_us`` — one of
        the three profiled control-plane hot paths (DESIGN.md §8)."""
        if self._m_choose is None:
            return self.scheduler.choose_trial_to_run(self)
        p0 = _perf()
        trial = self.scheduler.choose_trial_to_run(self)
        self._m_choose.observe((_perf() - p0) * 1e6)
        return trial

    def _drain_resume_queue(self) -> None:
        """Launch restored trials (phase order) before the scheduler's own
        choose loop runs: the base ``choose_trial_to_run`` is PENDING-first,
        so fresh never-started trials would otherwise steal the capacity the
        restored trials held when the original controller died."""
        tracer = self.obs.tracer
        while self._resume_queue:
            trial = self.get_trial(self._resume_queue[0])
            if trial is None or trial.status not in (
                    TrialStatus.PAUSED, TrialStatus.PENDING):
                self._resume_queue.pop(0)
                continue
            if not self.executor.has_resources(trial):
                return
            checkpoint = (trial.checkpoint
                          if trial.status == TrialStatus.PAUSED else None)
            ok = self.executor.start_trial(trial, checkpoint=checkpoint)
            if not ok:
                if trial.status == TrialStatus.ERROR:
                    self._resume_queue.pop(0)
                    self._finalize_error(trial)
                    continue
                return  # no resources after all
            self._resume_queue.pop(0)
            if tracer.enabled:
                tracer.begin(("trial", trial.trial_id), "trial",
                             trial.trial_id, cat="lifecycle",
                             trainable=trial.trainable_name, restored=True)

    def _launch_loop(self) -> None:
        if self._resume_queue:
            self._drain_resume_queue()
            if self._resume_queue and self.executor.has_running():
                # Out of capacity with restored trials still waiting: don't
                # let the scheduler's choose loop hand their slots to fresh
                # PENDING trials.  (If nothing is running we fall through —
                # the head must be blocked on something else, and stalling
                # the whole loop would deadlock.)
                return
        tracer = self.obs.tracer
        while True:
            t_dec = tracer.clock.time() if tracer.enabled else 0.0
            trial = self._choose()
            if trial is None:
                suggested = self._maybe_suggest()
                if suggested is None:
                    return
                trial = self._choose()
                if trial is None:
                    return
            if tracer.enabled:
                tracer.record("schedule.decision", trial.trial_id, t_dec,
                              tracer.clock.time() - t_dec, cat="sched")
            checkpoint = trial.checkpoint if trial.status == TrialStatus.PAUSED else None
            restored = checkpoint is not None
            ok = self.executor.start_trial(trial, checkpoint=checkpoint)
            if not ok:
                if trial.status == TrialStatus.ERROR:
                    self._finalize_error(trial)
                    continue
                return  # no resources after all
            if tracer.enabled:
                # The trial's lifecycle span: opened per (re)launch, closed at
                # stop/pause/requeue — every other span of this trial nests
                # inside it on the trace row.
                tracer.begin(("trial", trial.trial_id), "trial",
                             trial.trial_id, cat="lifecycle",
                             trainable=trial.trainable_name, restored=restored)

    def step(self) -> bool:
        """Process one event. Returns False when the experiment is finished."""
        self._launch_loop()
        event = self.executor.get_next_event()
        if event is None:
            if not self.is_finished():
                self._stall_count = getattr(self, "_stall_count", 0) + 1
                if self._stall_count > 3:
                    stuck = [t.trial_id for t in self.trials
                             if t.status in (TrialStatus.PENDING, TrialStatus.PAUSED)]
                    raise RuntimeError(
                        f"trial runner stalled: no runnable events but experiment "
                        f"not finished (stuck trials: {stuck}); scheduler deadlock?"
                    )
                return True
            return False
        self._stall_count = 0
        self.obs.on_event(event)          # count + adopt shipped SPAN batches
        self.obs.maybe_snapshot(self.executor)
        if self.flightrec is not None:
            self.flightrec.record_event(event)
        if self.state_snapshotter is not None:
            self.state_snapshotter.maybe_snapshot(self.scheduler, self.searcher)
        if event.type == EventType.SPAN:
            # Spans live in the trace export, not the event log — fully
            # consumed by obs.on_event above.
            return not self.is_finished()
        trial = self.get_trial(event.trial_id)
        if trial is None:  # event for a trial this runner never adopted
            return not self.is_finished()
        if self.broker is not None:
            self.broker.observe(self, event)

        if event.type not in (EventType.RESULT, EventType.ERROR):
            # Observability events (CHECKPOINTED / HEARTBEAT_MISSED /
            # RESTARTED / KILLED / RESIZED / ...): no scheduler decision,
            # just the loggers.
            kinds = self._resume_event_fence.get(trial.trial_id)
            if kinds:
                # Re-executed pre-crash iteration (durable resume): already
                # journaled by the original run — keep the merged journal
                # duplicate-free.
                kind = getattr(event.type, "value", str(event.type)).lower()
                bound = kinds.get(kind)
                if bound is not None:
                    iteration = (event.info or {}).get("iteration")
                    if iteration is not None and iteration <= bound:
                        return not self.is_finished()
                    kinds.pop(kind, None)
            self.logger.on_event(trial, event)
            return not self.is_finished()

        if event.type == EventType.ERROR:
            return self._handle_trial_error(trial, event.error or "unknown trial error")

        if trial.status != TrialStatus.RUNNING:
            # Stale RESULT from a worker halted mid-step (e.g. abandoned after
            # a join timeout, trial since requeued): acting on it would gate a
            # relaunched instance twice.  Drop it.
            return not self.is_finished()

        fence = self._resume_result_fence.get(trial.trial_id)
        if fence is not None:
            if event.result.training_iteration <= fence:
                # Durable resume replaying through an already-journaled
                # stretch: the original run's records for these iterations
                # survive in the (appended-to) journal, so drop the re-run's
                # copy — but still re-open the credit gate, or the worker
                # would park forever waiting for a verdict on it.
                self.executor.resume_trial(trial)
                return not self.is_finished()
            # First live result past the fence: normal processing resumes
            # (and a later PBT rewind below the old fence must not be
            # dropped, so the fence is retired rather than kept around).
            del self._resume_result_fence[trial.trial_id]

        result: Result = event.result
        profile = result.metrics.pop("_profile", None)
        if profile is not None:
            # Hardware profile smuggled on the first result after a (re)build
            # (train/trainable.py): publish it as trial metadata + a PROFILE
            # event so loggers/analysis see it, and keep it out of the
            # metric stream proper.
            trial.profile = profile
            self.logger.on_event(trial, TrialEvent(
                EventType.PROFILE, trial.trial_id, info=profile,
                timestamp=result.timestamp))
        trial.record_result(result)
        self.logger.on_result(trial, result)

        if result.done or trial.should_stop(result):
            if self.decisions is not False:
                self._emit_decision(trial.trial_id, "runner", "TrialRunner", {
                    "verdict": "STOP",
                    "iteration": result.training_iteration,
                    "inputs": self._stop_reason(trial, result)})
            self.stop_trial(trial)
            return not self.is_finished()

        if self._m_decide is None:
            decision = self.scheduler.on_result(self, trial, result)
        else:
            p0 = _perf()
            decision = self.scheduler.on_result(self, trial, result)
            self._m_decide.observe((_perf() - p0) * 1e6)
        self._drain_scheduler_decisions()
        self._observe(trial, final=False)
        self._apply(trial, decision)
        return not self.is_finished()

    def _stop_reason(self, trial: Trial, result: Result) -> Dict[str, Any]:
        """Why the runner (not the scheduler) is stopping this trial."""
        if result.done:
            return {"reason": "result_done"}
        for metric, bound in trial.stopping_criteria.items():
            if metric == "training_iteration":
                if result.training_iteration >= bound:
                    return {"reason": "stopping_criterion", "criterion": metric,
                            "bound": bound, "value": result.training_iteration}
            elif metric in result.metrics and result.value(metric) >= bound:
                return {"reason": "stopping_criterion", "criterion": metric,
                        "bound": bound, "value": result.value(metric)}
        return {"reason": "unknown"}

    # -- failure handling --------------------------------------------------------
    def _handle_trial_error(self, trial: Trial, error: str) -> bool:
        if trial.status.is_finished():
            # Stale ERROR racing a clean stop (e.g. the straggler monitor
            # killed a worker whose final result the runner had already
            # consumed): the trial's outcome is decided — drop it, exactly
            # like stale RESULTs below.
            return not self.is_finished()
        trial.num_failures = getattr(trial, "num_failures", 0) + 1
        retryable = (
            self.max_failures > 0
            and trial.num_failures <= self.max_failures
            and not trial.status.is_finished()
        )
        tracer = self.obs.tracer
        if retryable:
            # Tear down the dead instance; the trial re-enters the launch loop
            # PAUSED (restore from last checkpoint) or PENDING (from scratch).
            self.n_restarts += 1
            if self._m_restarts is not None:
                self._m_restarts.inc()
            self.executor.requeue_trial(trial)
            tracer.end(("trial", trial.trial_id), status="REQUEUED")
            if tracer.enabled:
                # Instant marker: the fault boundary between two lifecycle
                # spans of the same trial.
                tracer.record("restart", trial.trial_id, tracer.clock.time(),
                              0.0, cat="fault",
                              num_failures=trial.num_failures)
            clock = getattr(self.executor, "clock", None)
            self.logger.on_event(trial, TrialEvent(
                EventType.RESTARTED, trial.trial_id, error=error,
                checkpoint=trial.checkpoint,
                timestamp=clock.time() if clock is not None else None,
                info={"num_failures": trial.num_failures,
                      "max_failures": self.max_failures,
                      # where the retry restarts from (0 = from scratch) —
                      # durable resume reconstructs the iteration frontier
                      # and failure counters from this (DESIGN.md §12)
                      "checkpoint_iteration": (
                          trial.checkpoint.training_iteration
                          if trial.checkpoint is not None else 0),
                      # keep the cause on record even when the retry succeeds
                      "error": error[-2000:]}))
            return True
        self.executor.stop_trial(trial, error=error)
        tracer.end(("trial", trial.trial_id), status="ERROR")
        self._finalize_error(trial)
        return not self.is_finished()

    def _finalize_error(self, trial: Trial) -> None:
        self.n_errors += 1
        self.scheduler.on_trial_error(self, trial)
        # An error can trigger peer verdicts (HyperBand re-checks its cut when
        # the awaited peer died) — journal them like any result-path decision.
        self._drain_scheduler_decisions()
        # Errored trials get a final journal record too — without it the
        # JSONL stream has no terminal marker for them and post-hoc analysis
        # would report them as still in flight.
        self.logger.on_trial_complete(trial)
        self._observe(trial, final=True)
        if self.max_experiment_failures and self.n_errors > self.max_experiment_failures:
            self.executor.shutdown()
            raise RuntimeError(
                f"experiment aborted: {self.n_errors} errored trials exceed "
                f"max_experiment_failures={self.max_experiment_failures} "
                f"(last error on {trial.trial_id}: {trial.error})"
            )

    def _apply(self, trial: Trial, decision: SchedulerDecision) -> None:
        if decision == SchedulerDecision.CONTINUE:
            if self.broker is not None:
                # Checkpoint boundary: the trial's worker is parked awaiting
                # this resume, so the broker may resize its slice here
                # (DESIGN.md §6) before the gate re-opens.
                self.broker.before_resume(self, trial)
            self.executor.resume_trial(trial)
            return
        if decision == SchedulerDecision.PAUSE:
            self.executor.pause_trial(trial)
            self.obs.tracer.end(("trial", trial.trial_id), status="PAUSED")
        elif decision == SchedulerDecision.STOP:
            self.stop_trial(trial)
        elif decision == SchedulerDecision.RESTART_WITH_CONFIG:
            ckpt = trial.scheduler_state.pop("restore_from", None)
            new_config = trial.scheduler_state.pop("new_config", None)
            if ckpt is None or new_config is None:
                raise RuntimeError(
                    "RESTART_WITH_CONFIG requires scheduler_state['restore_from'/'new_config']"
                )
            try:
                self.executor.restart_trial_with_config(trial, ckpt, new_config)
            finally:
                # Unpin once the donor state was consumed.  A deferred restart
                # (no capacity: executor re-queued the trial with the donor
                # checkpoint attached) keeps the pin until the relaunch's
                # restore actually happens (executors unpin at consumption).
                if trial.checkpoint is not ckpt:
                    ckpt.pinned = False
            if trial.status == TrialStatus.ERROR:
                self._finalize_error(trial)
        else:
            raise ValueError(f"unknown scheduler decision {decision}")

    def run(self, max_steps: int = 10_000_000) -> List[Trial]:
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        self.executor.shutdown()
        self.logger.on_experiment_end(self.trials)
        return self.trials
