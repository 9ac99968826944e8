"""Experiment spec and ``run_experiments`` — the paper's §4.3 entry point.

    def my_func(tune): ...
    tune.run_experiments(my_func, {
        "lr": tune.grid_search([0.01, 0.001, 0.0001]),
        "activation": tune.grid_search(["relu", "tanh"]),
    }, scheduler=HyperBandScheduler(...))

Accepts a function-based trainable, a Trainable subclass, or a registered name.
Grid axes become the initial trial set; ``num_samples`` repeats stochastic
draws; a ``searcher`` (TPE/random) can generate trials on demand instead.
"""
from __future__ import annotations

import inspect
import os
import re
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Optional, Union

from .api import Trainable, wrap_function
from .checkpoint import CheckpointManager
from .concurrent_executor import ConcurrentMeshExecutor
from .executor import SerialMeshExecutor, TrialExecutor
from .loggers import (CompositeLogger, ConsoleLogger, CSVLogger, JSONLLogger,
                      LiveReporter, Logger)
from .object_store import ObjectStore
from .process_executor import ProcessMeshExecutor
from .resources import Resources
from .runner import TrialRunner
from .schedulers.base import TrialScheduler
from .schedulers.fifo import FIFOScheduler
from .search.basic import Searcher
from .search.variants import count_grid_variants, format_variant_tag, generate_variants
from .trial import Trial, TrialStatus
from .workers import (TrainableFactory, factory_from_class,
                      register_worker_factory, resolve_worker_factory)

__all__ = ["run_experiments", "ExperimentAnalysis", "register_trainable"]

_REGISTRY: Dict[str, type] = {}


def register_trainable(name: str, cls_or_fn: Union[type, Callable]) -> None:
    _REGISTRY[name] = (
        cls_or_fn if inspect.isclass(cls_or_fn) else wrap_function(cls_or_fn)
    )
    if inspect.isclass(cls_or_fn):
        # Opportunistically mirror importable classes into the process-worker
        # registry so `executor="process"` works without extra ceremony.
        factory = factory_from_class(cls_or_fn)
        if factory is not None:
            register_worker_factory(name, factory)


class _StatePersister(Logger):
    """Fault tolerance (paper §4.2): trial metadata lives in memory, durability
    comes from checkpoints + this periodic metadata snapshot.  On restart,
    ``run_experiments(..., resume=True)`` rebuilds the trial list: finished
    trials keep their results, interrupted ones restart from their last disk
    checkpoint (or from scratch if none was written).

    Dumps fire on trial completion and experiment end, and — clock-throttled —
    on fault-recovery events (RESTARTED / KILLED / ERROR) plus the first
    result of the run, so a controller killed early or mid-fault-storm still
    leaves a usable pkl behind (DESIGN.md §12)."""

    def __init__(self, path: str, runner_ref, clock=None,
                 min_interval_s: float = 5.0):
        self.path = path
        self.runner_ref = runner_ref
        self.clock = clock
        self.min_interval_s = min_interval_s
        self._last_dump: Optional[float] = None
        self._saw_result = False

    def _dump(self) -> None:
        import pickle
        runner = self.runner_ref()
        if runner is None:
            return
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            pickle.dump(runner.trials, f)
        os.replace(tmp, self.path)
        if self.clock is not None:
            self._last_dump = self.clock.time()

    def _throttled_dump(self) -> None:
        if (self.clock is not None and self._last_dump is not None
                and self.clock.time() - self._last_dump < self.min_interval_s):
            return
        self._dump()

    def on_result(self, trial, result) -> None:
        if not self._saw_result:
            self._saw_result = True
            self._throttled_dump()

    def on_event(self, trial, event) -> None:
        kind = getattr(getattr(event, "type", None), "value", None)
        if kind in ("RESTARTED", "KILLED", "ERROR"):
            self._throttled_dump()

    def on_trial_complete(self, trial) -> None:
        self._dump()

    def on_experiment_end(self, trials) -> None:
        self._dump()


def load_experiment_state(log_dir: str) -> List[Trial]:
    """Trials from a previous (possibly interrupted) run in ``log_dir``."""
    import pickle
    path = os.path.join(log_dir, "experiment_state.pkl")
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        trials: List[Trial] = pickle.load(f)
    for t in trials:
        if not t.status.is_finished():
            # interrupted mid-flight: resume from the last durable checkpoint
            if t.checkpoint is not None and t.checkpoint.path \
                    and os.path.exists(t.checkpoint.path):
                t.status = TrialStatus.PAUSED
            else:
                t.status = TrialStatus.PENDING
                t.results.clear()
                t.checkpoint = None
    return trials


def _infer_initial_id_offset(journal_path: str, name: str) -> int:
    """The original process's Trial auto-id counter need not have started at
    zero (other trials may have been created first): recover the offset from
    the smallest ``{name}_{NNNNN}`` suffix the journal recorded."""
    import json
    pat = re.compile(rf"^{re.escape(name)}_(\d+)$")
    best: Optional[int] = None
    try:
        with open(journal_path) as f:
            for line in f:
                try:
                    obj = json.loads(line)
                except (ValueError, TypeError):
                    continue
                tid = obj.get("trial_id") if isinstance(obj, dict) else None
                if isinstance(tid, str):
                    m = pat.match(tid)
                    if m:
                        v = int(m.group(1))
                        if best is None or v < best:
                            best = v
    except OSError:
        return 0
    return best or 0


def _resume_base_trials(log_dir: str, journal_path: str, name: str,
                        space_variants: Optional[List[Dict[str, Any]]],
                        resources: Resources,
                        stop: Optional[Dict[str, float]]) -> List[Trial]:
    """Identity source for the resumed run's *initial* trial set: the legacy
    pkl when one survives (authoritative ids + configs), else the space
    regenerated with the original id offset, else nothing (journal-only —
    configs then come from result records)."""
    import pickle
    pkl = os.path.join(log_dir, "experiment_state.pkl")
    if os.path.exists(pkl):
        try:
            with open(pkl, "rb") as f:
                return pickle.load(f)
        except Exception:
            pass  # torn by the crash: fall through to regeneration
    if space_variants is not None:
        offset = _infer_initial_id_offset(journal_path, name)
        return [Trial(config=config, trainable_name=name, resources=resources,
                      stopping_criteria=stop, tag=format_variant_tag(config),
                      trial_id=f"{name}_{offset + i:05d}")
                for i, config in enumerate(space_variants)]
    return []


class ExperimentAnalysis:
    """Post-hoc queries over a finished experiment (best trial, result table)."""

    def __init__(self, trials: List[Trial], metric: str, mode: str):
        self.trials = trials
        self.metric = metric
        self.mode = mode

    def best_trial(self) -> Optional[Trial]:
        best, best_v = None, None
        for t in self.trials:
            v = t.best_value(self.metric, self.mode)
            if v is None:
                continue
            if best_v is None or (v > best_v if self.mode == "max" else v < best_v):
                best, best_v = t, v
        return best

    def best_config(self) -> Optional[Dict[str, Any]]:
        t = self.best_trial()
        return dict(t.config) if t else None

    def best_value(self) -> Optional[float]:
        t = self.best_trial()
        return t.best_value(self.metric, self.mode) if t else None

    def results_table(self) -> List[Dict[str, Any]]:
        rows = []
        for t in self.trials:
            rows.append({
                "trial_id": t.trial_id,
                "status": t.status.value,
                "iterations": t.training_iteration,
                "best": t.best_value(self.metric, self.mode),
                "config": {k: v for k, v in t.config.items() if not k.startswith("_")},
            })
        return rows

    def total_iterations(self) -> int:
        return sum(t.training_iteration for t in self.trials)


def run_experiments(
    trainable: Union[str, type, Callable],
    space: Optional[Dict[str, Any]] = None,
    *,
    scheduler: Optional[TrialScheduler] = None,
    searcher: Optional[Searcher] = None,
    num_samples: int = 1,
    stop: Optional[Dict[str, float]] = None,
    resources_per_trial: Optional[Resources] = None,
    total_cpu: float = 64.0,
    total_devices: int = 256,
    slice_pool: Optional[Any] = None,
    checkpoint_freq: int = 1,
    log_dir: Optional[str] = None,
    verbose: bool = False,
    seed: int = 0,
    max_steps: int = 10_000_000,
    executor: Union[None, str, TrialExecutor] = None,
    hosts: Any = None,                      # cluster tier: roster (int/str/specs)
    placement: Any = "roofline",            # cluster tier: placement policy
    max_failures: int = 0,
    max_experiment_failures: int = 0,
    heartbeat_timeout: float = 60.0,
    straggler_deadline: float = 0.0,
    elastic: Union[None, str, Any] = None,
    lookahead: int = 1,
    metric: Optional[str] = None,
    mode: Optional[str] = None,
    resume: bool = False,
    clock: Optional[Any] = None,  # repro_torch.core.clock.Clock; None = default
    trace: Union[None, bool, str] = None,   # Chrome trace-event JSON path
    metrics_interval: float = 0.0,          # >0 = JSONL metrics snapshots
    search_state_interval: float = 10.0,    # search_state.json snapshot throttle
    obs: Optional[Any] = None,              # pre-built repro_torch.obs.Observability
    report: Union[None, bool, str] = None,  # HTML run report (needs log_dir)
    live_table: bool = False,               # LiveReporter trial table
    decisions: Union[bool, str] = True,     # DECISION journaling (§10)
    flight_recorder: Union[None, bool, str, Any] = None,  # crash forensics (§10)
) -> ExperimentAnalysis:
    """Run one experiment to completion; returns an ExperimentAnalysis.

    ``executor`` is a TrialExecutor instance, or ``"serial"``/``"concurrent"``/
    ``"process"`` to build one here (``"concurrent"`` steps trials on worker
    threads with heartbeat/straggler detection — DESIGN.md §4; ``"process"``
    runs each trial in a spawned worker process with GIL-free host stepping
    and kill-on-straggle reclamation after ``straggler_deadline`` seconds —
    DESIGN.md §5; it needs a spawn-safe trainable: an importable class or a
    ``TrainableFactory``).  ``max_failures`` restarts a crashed trial from its
    last checkpoint up to that many times before marking it ERROR;
    ``max_experiment_failures`` aborts the whole experiment once more trials
    than that have errored.

    ``elastic`` turns on the elastic resource control plane (DESIGN.md §6):
    ``"greedy"`` (survivors absorb devices freed by early-stopped trials),
    ``"fair"`` (rebalance the pool across running trials), ``"off"``/None, or
    a ``repro_torch.core.elastic.ResizePolicy`` instance.  Resizes happen at
    checkpoint boundaries (SAVE -> swap slice -> rebuild + re-shard ->
    RESTORE) and need a ``slice_pool``.  ``lookahead`` lets each worker run
    up to K un-consumed results ahead of the scheduler on throughput-bound
    sweeps; it is clamped to 1 automatically whenever the scheduler can
    stop/pause/perturb trials (``Scheduler.decision_interval() != 0``), so
    scheduler decisions stay serial-exact.

    ``resume=True`` (requires ``log_dir``) rebuilds an interrupted — even
    kill -9'd — run from its durable artifacts (DESIGN.md §12): trial
    statuses, iteration counts and metric histories replay from
    ``log_dir/events.jsonl``; scheduler and searcher state load from the
    watermarked ``log_dir/search_state.json`` snapshot (the journal tail
    past the watermark is replayed through them); weights restore from the
    per-trial checkpoint mirrors under ``log_dir/ckpt``.  Finished trials
    are kept; a trial with a valid mirror continues from that iteration; a
    trial with none restarts from scratch with its failure counters intact.
    The journal is appended to, not truncated, so a resumed run's decision
    stream continues the original one.  Runs from before the journal era
    fall back to the legacy ``experiment_state.pkl`` path.  ``space=`` is
    only used to regenerate the original trial identities — changing it
    between runs is ignored (and warned about); a changed ``num_samples``
    that conflicts with the restored trial count raises.
    ``search_state_interval`` throttles the search-state snapshots (seconds
    on the injected clock, default 10, independent of ``metrics_interval``).

    ``clock`` injects the time source (DESIGN.md §7) into the executor, the
    event bus, the loggers and the broker in one stroke — a ``VirtualClock``
    here runs the whole control plane on deterministic virtual time (the
    repro.testing harness does exactly this).

    Observability (DESIGN.md §8): ``trace="out.json"`` records per-trial spans
    for every lifecycle phase and exports a Perfetto/chrome://tracing-viewable
    Chrome trace on completion; ``metrics_interval=S`` turns on the metrics
    registry and (with ``log_dir``) snapshots it to ``log_dir/metrics.jsonl``
    every S clock-seconds, plus a status table at experiment end.  Pass a
    pre-built ``repro_torch.obs.Observability`` via ``obs`` to control both.

    ``report=True`` (needs ``log_dir``: the JSONL journal is the source)
    renders the self-contained HTML run report to ``log_dir/report.html`` —
    or to an explicit path when ``report`` is a string — after the run ends,
    even when it ends by abort (DESIGN.md §9).  ``live_table=True`` attaches
    a ``LiveReporter`` rendering the live trial status table, throttled on
    the injected clock.

    Decision provenance (DESIGN.md §10): ``decisions=True`` (default)
    journals every scheduler/searcher/runner verdict as a typed DECISION
    record with its inputs; ``"full"`` includes CONTINUE verdicts; ``False``
    disables.  ``flight_recorder`` arms the crash-forensics ring buffer:
    with a ``log_dir`` it defaults on (dumping to ``log_dir/flightrec``);
    pass True (dump dir from ``$REPRO_FLIGHTREC_DIR``, default
    ``flightrec``), a directory path, or a pre-built ``FlightRecorder``.  On
    SIGTERM, a controller exception, or a max_experiment_failures abort it
    dumps a self-contained forensic bundle; scheduler+searcher state is also
    checkpointed to ``log_dir/search_state.json`` on the metrics-snapshot
    throttle."""
    from .clock import get_default_clock
    clock = clock or get_default_clock()
    scheduler = scheduler or FIFOScheduler()
    metric = metric or scheduler.metric
    mode = mode or scheduler.mode
    if report and not log_dir:
        raise ValueError("report=... requires log_dir (the JSONL journal is "
                         "the report's source)")

    # -- resolve trainable -------------------------------------------------------
    if isinstance(trainable, str):
        name = trainable
        if name not in _REGISTRY:
            raise KeyError(f"trainable {name!r} not registered")
    elif isinstance(trainable, TrainableFactory):
        # Spawn-safe recipe: register the resolved class for in-host executors
        # AND the factory itself for process workers.
        cls = trainable.resolve()
        name = getattr(cls, "__name__", "trainable")
        _REGISTRY[name] = cls
        register_worker_factory(name, trainable)
    else:
        name = getattr(trainable, "__name__", "trainable")
        register_trainable(name, trainable)
    if executor in ("process", "cluster"):
        try:
            resolve_worker_factory(name)
        except KeyError as e:
            raise ValueError(str(e)) from None

    # -- observability (repro_torch.obs, DESIGN.md §8) -----------------------------------
    if obs is None and (trace or metrics_interval > 0):
        from ..obs import Observability
        metrics_target: Any = metrics_interval > 0
        if metrics_target and log_dir:
            metrics_target = os.path.join(log_dir, "metrics.jsonl")
        obs = Observability(trace=trace, metrics=metrics_target,
                            metrics_interval=metrics_interval or 10.0,
                            clock=clock)
    from ..obs import NULL_OBS
    obs = obs or NULL_OBS

    # -- plumbing ------------------------------------------------------------------
    store = ObjectStore(spill_dir=os.path.join(log_dir, "spill") if log_dir else None)
    ckpt_mgr = CheckpointManager(store,
                                 dir=os.path.join(log_dir, "ckpt") if log_dir else None,
                                 durable=log_dir is not None)
    if executor is None or isinstance(executor, str):
        kind = executor or "serial"
        common = dict(
            trainable_cls_resolver=_REGISTRY.__getitem__,
            checkpoint_manager=ckpt_mgr,
            total_cpu=total_cpu,
            total_devices=total_devices,
            slice_pool=slice_pool,
            checkpoint_freq=checkpoint_freq,
            clock=clock,
            obs=obs,
        )
        if kind == "serial":
            executor = SerialMeshExecutor(**common)
        elif kind == "concurrent":
            executor = ConcurrentMeshExecutor(
                heartbeat_timeout=heartbeat_timeout, **common)
        elif kind == "process":
            executor = ProcessMeshExecutor(
                heartbeat_timeout=heartbeat_timeout,
                straggler_deadline=straggler_deadline, **common)
        elif kind == "cluster":
            from ..cluster import ClusterMeshExecutor
            common.pop("slice_pool", None)  # cluster builds per-host pools
            executor = ClusterMeshExecutor(
                hosts=hosts if hosts is not None else 2,
                placement=placement,
                heartbeat_timeout=heartbeat_timeout,
                straggler_deadline=straggler_deadline, **common)
        else:
            raise ValueError(
                f"unknown executor {kind!r}; pass 'serial', 'concurrent', "
                f"'process', 'cluster', or a TrialExecutor instance "
                f"(VmapExecutor needs a VectorTrainableSpec)")
    exec_kind = (executor if isinstance(executor, str)
                 else type(executor).__name__)

    # -- durable resume (DESIGN.md §12): plan BEFORE the journal reopens ----------
    plan = None
    restored: List[Trial] = []
    if resume:
        if not log_dir:
            raise ValueError("resume=True requires log_dir")
        if space is not None:
            warnings.warn(
                "resume=True restores the original run's trials from its "
                "journal; `space=` is only used to regenerate their identity "
                "— any changes to its values are IGNORED on resume",
                UserWarning, stacklevel=2)
        journal_path = os.path.join(log_dir, "events.jsonl")
        if os.path.exists(journal_path):
            from .resume import prepare_resume
            space_variants = (list(generate_variants(
                space, num_samples=num_samples, seed=seed))
                if space is not None else None)
            base = _resume_base_trials(
                log_dir, journal_path, name, space_variants,
                resources_per_trial or Resources(), stop)
            plan = prepare_resume(
                journal_path,
                os.path.join(log_dir, "search_state.json"),
                scheduler, searcher=searcher, base_trials=base,
                checkpoint_dir=os.path.join(log_dir, "ckpt"),
                trainable_name=name,
                default_resources=resources_per_trial or Resources(),
                stopping_criteria=stop)
            if space_variants is not None:
                sugg = re.compile(rf"^{re.escape(name)}_sugg_\d+$")
                n_initial = sum(1 for t in plan.trials
                                if not sugg.match(t.trial_id))
                if n_initial != len(space_variants):
                    raise ValueError(
                        f"resume=True: the restored run has {n_initial} "
                        f"initial trials but space/num_samples would generate "
                        f"{len(space_variants)}; refusing to mix — resume "
                        f"with the original space and num_samples, or start "
                        f"a fresh log_dir")
        else:
            # Pre-journal run: experiment_state.pkl is all there is.
            restored = load_experiment_state(log_dir)

    loggers: List[Logger] = [ConsoleLogger(verbose=verbose, clock=clock,
                                           obs=obs if obs.active else None)]
    if live_table:
        loggers.append(LiveReporter(metric=metric, clock=clock))
    jsonl_logger: Optional[JSONLLogger] = None
    if log_dir:
        loggers.append(CSVLogger(os.path.join(log_dir, "csv")))
        jsonl_logger = JSONLLogger(
            os.path.join(log_dir, "events.jsonl"), clock=clock,
            executor=exec_kind, decisions=decisions is not False,
            resumed=plan is not None,
            initial_records=plan.n_journal_records if plan is not None else 0)
        loggers.append(jsonl_logger)
    logger = CompositeLogger(loggers)

    # -- crash forensics + searcher-state checkpoints (DESIGN.md §10) -------------
    from ..obs.flightrec import FlightRecorder, SearchStateSnapshotter
    if flight_recorder is None and log_dir:
        flight_recorder = os.path.join(log_dir, "flightrec")
    if flight_recorder is True:
        flight_recorder = os.environ.get("REPRO_FLIGHTREC_DIR", "flightrec")
    if isinstance(flight_recorder, str):
        flightrec: Optional[FlightRecorder] = FlightRecorder(
            clock=clock, out_dir=flight_recorder)
    else:
        flightrec = flight_recorder or None
    if flightrec is not None:
        flightrec.bind_clock(clock)
        for lg in loggers:
            if isinstance(lg, JSONLLogger):
                flightrec.run_id = lg.run_id  # one id across journal + dumps
                break
    snapshotter = None
    if log_dir:
        # Watermarked on the journal's record count: a snapshot taken at
        # watermark W reflects exactly journal records [0..W), which is what
        # lets resume replay only the tail (DESIGN.md §12).
        snapshotter = SearchStateSnapshotter(
            os.path.join(log_dir, "search_state.json"), clock=clock,
            interval_s=search_state_interval,
            watermark_fn=((lambda: jsonl_logger.n_records)
                          if jsonl_logger is not None else None))

    broker = None
    if (elastic not in (None, "off")) or lookahead != 1:
        from .elastic import ResourceBroker, resolve_policy
        broker = ResourceBroker(policy=resolve_policy(elastic),
                                lookahead=lookahead, clock=clock)

    runner = TrialRunner(
        scheduler=scheduler,
        executor=executor,
        searcher=searcher,
        logger=logger,
        trainable_name=name,
        default_resources=resources_per_trial or Resources(),
        stopping_criteria=stop,
        max_failures=max_failures,
        max_experiment_failures=max_experiment_failures,
        broker=broker,
        obs=obs,
        decisions=decisions,
        flight_recorder=flightrec,
        state_snapshotter=snapshotter,
    )
    if log_dir:
        import weakref
        loggers.append(_StatePersister(
            os.path.join(log_dir, "experiment_state.pkl"), weakref.ref(runner),
            clock=clock))

    # -- initial trials ---------------------------------------------------------------
    if plan is not None:
        runner.apply_resume_plan(plan)
        for w in plan.warnings:
            warnings.warn(f"resume: {w}", UserWarning, stacklevel=2)
        if verbose:
            print(f"[repro] {plan.summary()}")
    elif restored:
        for trial in restored:
            trial.trainable_name = name  # rebind to this process's registration
            runner.add_trial(trial)
    if plan is not None or restored:
        pass  # resumed experiments keep their original trial set
    elif space is not None:
        for config in generate_variants(space, num_samples=num_samples, seed=seed):
            runner.add_trial(Trial(
                config=config,
                trainable_name=name,
                resources=resources_per_trial or Resources(),
                stopping_criteria=stop,
                tag=format_variant_tag(config),
            ))
    elif searcher is None:
        raise ValueError("provide a space, a searcher, or both")

    # The teardown below runs even when the sweep aborts (max_experiment_
    # failures, KeyboardInterrupt): traces, the metrics snapshot stream, the
    # journal's final records, and the HTML report must survive the abort —
    # an aborted run is exactly the one worth inspecting.
    completed = False
    sigterm_armed = (flightrec.install_signal_handler(runner, executor)
                     if flightrec is not None else False)
    try:
        runner.run(max_steps=max_steps)
        completed = True
    finally:
        if sigterm_armed:
            flightrec.remove_signal_handler()
        if not completed:
            # runner.run does both of these on its clean path; an exception
            # skipped them.  Neither may mask the original exception.
            if flightrec is not None:
                # The abort is exactly what the flight recorder exists for:
                # dump the forensic bundle before anything is torn down.
                try:
                    flightrec.dump(runner, executor, reason="abort")
                except Exception:
                    pass
            try:
                executor.shutdown()
            except Exception:
                pass
            try:
                logger.on_experiment_end(runner.trials)
            except Exception:
                pass
        if snapshotter is not None:
            try:
                snapshotter.snapshot(scheduler, searcher)  # final state
            except Exception:
                if completed:
                    raise
        obs.close(executor)  # final metrics snapshot + Chrome trace export
        logger.close()
        if report and log_dir:
            try:
                from ..obs.report import build_report
                journal = os.path.join(log_dir, "events.jsonl")
                out = (report if isinstance(report, str)
                       else os.path.join(log_dir, "report.html"))
                with open(out, "w") as f:
                    f.write(build_report(
                        journal_path=journal, trace_path=obs.trace_path,
                        metrics_path=obs.metrics_path,
                        metric=metric, mode=mode))
            except Exception:
                if completed:
                    raise
                # aborting run: the abort is the story, not a report failure
    return ExperimentAnalysis(runner.trials, metric=metric, mode=mode)
