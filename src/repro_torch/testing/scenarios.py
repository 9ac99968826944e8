"""Scenario DSL + runner — fault sweeps on deterministic virtual time.

A scenario is a list of ``SimTrainable`` configs plus expectations about the
faults scripted into them.  ``run_scenario`` places the whole execution stack
(executor, event bus, loggers, broker, trials) on one ``VirtualClock`` and
runs it to completion, returning a ``ScenarioResult`` the invariant checkers
(invariants.py) interrogate.  Three generators cover the failure classes the
execution tiers were built for:

- ``crash_storm``       — a fraction of trials crash mid-run (some more times
                          than max_failures absorbs, ending ERROR on purpose),
- ``straggler_cascade`` — a fraction of trials stall far past the heartbeat
                          timeout, driving HEARTBEAT_MISSED monitoring,
- ``resize_churn``      — elastic policy on, so early stops + completions
                          keep resizing the survivors' slices.

Everything is seeded and the virtual clock serializes thread wake order, so
a thousand-trial sweep is reproducible enough to assert exact bookkeeping
(crash counts, restart counts, leak-freedom) rather than just "it finished".
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..core.clock import VirtualClock, WallClock, use_clock
from ..core.checkpoint import CheckpointManager
from ..core.concurrent_executor import ConcurrentMeshExecutor
from ..core.elastic import ResourceBroker, resolve_policy
from ..core.executor import SerialMeshExecutor
from ..core.loggers import CompositeLogger, JSONLLogger, Logger
from ..core.object_store import ObjectStore
from ..core.resources import Resources
from ..core.runner import TrialRunner
from ..core.trial import Trial
from ..dist.submesh import SlicePool
from ..obs.flightrec import FlightRecorder
from .sim import SimTrainable, reset_faults

__all__ = ["Scenario", "ScenarioResult", "RecordingLogger", "run_scenario",
           "crash_storm", "straggler_cascade", "resize_churn"]

_token_counter = itertools.count()


class RecordingLogger(Logger):
    """Captures every event and result the runner routes to loggers (the
    runner thread is the only caller, so plain lists suffice)."""

    def __init__(self):
        self.events: List[Any] = []
        self.results: List[Any] = []

    def on_event(self, trial, event):
        self.events.append(event)

    def on_result(self, trial, result):
        self.results.append(result)

    def of(self, kind):
        return [e for e in self.events if e.type == kind]


@dataclass
class Scenario:
    name: str
    configs: List[Dict[str, Any]]     # one SimTrainable config per trial
    stop_iteration: int = 5
    max_failures: int = 1
    elastic: Optional[str] = None     # "greedy" / "fair" / None
    heartbeat_timeout: float = 60.0
    # scripted-fault accounting the invariants cross-check
    expected_crashes: int = 0         # total injected step failures (incl. kills)
    expected_fatal: int = 0           # trials whose budget those exhaust
    expected_stragglers: int = 0
    # cluster tier (executor="cluster"): roster + host-level fault script
    hosts: Any = None                 # parse_hosts input, e.g. "4x4"
    host_faults: List[Any] = field(default_factory=list)
    #   entries: (kind, host, at_s) or (kind, host, at_s, duration_s)
    #   kinds: "crash" (abrupt death), "partition" (heals after duration)
    host_timeout: float = 0.0         # silent-host eviction age (0 = default)


@dataclass
class ScenarioResult:
    scenario: Scenario
    trials: List[Trial]
    runner: TrialRunner
    executor: Any
    pool: Optional[SlicePool]         # None on the cluster tier (per-host pools)
    clock: Any                        # VirtualClock (WallClock on "process")
    recorder: RecordingLogger
    flightrec: Optional[FlightRecorder] = None
    wall_elapsed_s: float = 0.0
    fleet: Optional[Any] = None       # cluster tier's SimFleet (fault script)

    @property
    def virtual_elapsed_s(self) -> float:
        return self.clock.monotonic()

    def by_status(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t in self.trials:
            out[t.status.value] = out.get(t.status.value, 0) + 1
        return out


def run_scenario(
    scenario: Scenario,
    scheduler_factory: Callable[[], Any],
    executor: str = "concurrent",
    pool_devices: int = 16,
    lookahead: int = 1,
    max_steps: int = 10_000_000,
    obs: Optional[Any] = None,
    token: Optional[str] = None,
    journal_path: Optional[str] = None,
    decisions: Any = True,
    log_dir: Optional[str] = None,
    resume: bool = False,
    interrupt_after_steps: Optional[int] = None,
    search_state_interval: float = 10.0,
    keep_last: int = 2,
) -> ScenarioResult:
    """Run one scenario on a fresh ``VirtualClock`` to completion.

    ``executor="serial"`` is the reference tier for equivalence checks; with
    ``pool_devices=1`` both tiers execute trials one at a time, so their
    event streams — and every scheduler decision — must coincide exactly.

    ``obs`` attaches a ``repro_torch.obs.Observability`` bundle (tracing/metrics)
    to the stack.  ``token`` overrides the run nonce baked into trial ids —
    pass a fixed token to make trial ids (hence trace ids) identical across
    runs, which is what the byte-identical-trace determinism tests and
    ``bench_faults`` rely on.

    ``journal_path`` additionally tees the event stream through a
    ``JSONLLogger`` (v3 journal with run_header), so a scenario run leaves
    an ``ExperimentAnalysis``-readable artifact on disk.  The header's
    ``run_id`` is pinned to ``token`` to keep same-token runs byte-identical
    — the flight recorder is pinned to the same id, so forensic bundles from
    identical-token runs are byte-identical too (ISSUE 8 comparability fix).

    ``log_dir`` arms the full durable-resume stack (DESIGN.md §12): the
    journal at ``log_dir/events.jsonl``, durable checkpoint mirrors under
    ``log_dir/ckpt`` (rotated to ``keep_last``), and watermarked
    search-state snapshots at ``log_dir/search_state.json`` every
    ``search_state_interval`` virtual seconds.  ``interrupt_after_steps=N``
    simulates a controller kill -9: the runner is abandoned after N events —
    no final snapshot, no ``on_experiment_end`` — and a *partial*
    ScenarioResult comes back.  ``resume=True`` (same ``token`` required, so
    trial identities line up) rebuilds the runner from those artifacts via
    ``prepare_resume`` and continues the sweep in a fresh stack.
    """
    import os as _os
    import tempfile as _tempfile
    import time as _wall

    token = token if token is not None else f"{scenario.name}-{next(_token_counter)}"
    reset_faults()
    if log_dir is not None:
        _os.makedirs(log_dir, exist_ok=True)
        if journal_path is None:
            journal_path = _os.path.join(log_dir, "events.jsonl")
    if resume and (log_dir is None or journal_path is None
                   or not _os.path.exists(journal_path)):
        raise ValueError("resume=True needs a log_dir holding the journal of "
                         "the interrupted run (pass the same token too, so "
                         "trial identities line up)")
    # The process tier runs REAL worker processes: the clock cannot see them,
    # so fast-forwarding virtual time between their (real) deliveries would
    # trip the runner's stall detector long before any child speaks.  That
    # tier runs on wall time with wall-scaled faults; every in-process tier
    # (serial/concurrent/cluster-virtual) runs on deterministic virtual time.
    # (The virtual-deadline escalation over real children IS still testable —
    # by driving the executor directly, as test_virtual_deadline_math does.)
    clock = WallClock() if executor == "process" else VirtualClock()
    if obs is not None:
        obs.bind_clock(clock)  # span timestamps must ride the virtual axis
    pool = SlicePool(n_virtual=pool_devices)
    recorder = RecordingLogger()
    # The journal is opened AFTER the resume plan is prepared (below): a
    # resumed run re-opens it in append mode with the surviving record count.
    journal = None
    flightrec = FlightRecorder(
        clock=clock, run_id=f"run-{token}",
        out_dir=_os.environ.get("REPRO_FLIGHTREC_DIR", "flightrec"))
    t0 = _wall.monotonic()
    with use_clock(clock):
        store = ObjectStore()
        ckpt = (CheckpointManager(store, dir=_os.path.join(log_dir, "ckpt"),
                                  durable=True, keep_last=keep_last)
                if log_dir is not None else CheckpointManager(store))
        common = dict(
            trainable_cls_resolver=lambda name: SimTrainable,
            checkpoint_manager=ckpt,
            total_devices=pool_devices,
            total_cpu=4 * pool_devices,
            slice_pool=pool,
            checkpoint_freq=1,
            clock=clock,
            obs=obs,
        )
        fleet = None
        fault_dir = None
        trainable_name = "SimTrainable"
        if executor == "serial":
            ex = SerialMeshExecutor(**common)
        elif executor == "concurrent":
            ex = ConcurrentMeshExecutor(
                heartbeat_timeout=scenario.heartbeat_timeout, **common)
        elif executor == "process":
            # Satellite tier: the same fault matrix on REAL worker processes.
            # SimWorkerTrainable persists fault firings as marker files (a
            # module registry dies at the spawn boundary); the controller
            # keeps the VirtualClock for its deadline arithmetic while the
            # children live on wall time — the PR 5 virtual-deadline contract.
            from ..core.workers import TrainableFactory
            trainable_name = "SimWorkerTrainable"
            fault_dir = _tempfile.mkdtemp(prefix=f"repro-simworker-{token}-")
            factory = TrainableFactory(
                target="repro_torch.testing.simworker:SimWorkerTrainable")
            common.pop("trainable_cls_resolver")
            from ..core.process_executor import ProcessMeshExecutor
            ex = ProcessMeshExecutor(
                factory_resolver=lambda _n: factory,
                heartbeat_timeout=scenario.heartbeat_timeout,
                spawn_timeout=0,  # spawn ages would fast-forward too
                **common)
        elif executor == "cluster":
            # Simulated host fleet: virtual transports + scripted host faults
            # on the same deterministic timeline (DESIGN.md §11).
            from ..cluster import ClusterMeshExecutor
            from ..cluster.sim import SimFleet
            from ..core.workers import TrainableFactory
            common.pop("slice_pool")
            common.pop("total_devices")  # the roster defines capacity
            # Virtual workers run in-process, so the import-path factory
            # resolves to the SAME sim module — scripted faults keep their
            # shared registry across "process" rebuilds.
            sim_factory = TrainableFactory(
                target="repro_torch.testing.sim:SimTrainable")
            ex = ClusterMeshExecutor(
                hosts=scenario.hosts if scenario.hosts is not None else "4x4",
                transport="virtual", placement="fixed",
                heartbeat_timeout=scenario.heartbeat_timeout,
                host_timeout=scenario.host_timeout or None,
                spawn_timeout=0,
                factory_resolver=lambda _n: sim_factory,
                **common)
            fleet = SimFleet(ex, clock)
            for fault in scenario.host_faults:
                fleet.script(*fault[:2], at=fault[2],
                             duration=fault[3] if len(fault) > 3 else None)
        else:
            raise ValueError(f"run_scenario drives serial/concurrent/process/"
                             f"cluster tiers, not {executor!r}")
        broker = None
        if scenario.elastic is not None or lookahead != 1:
            broker = ResourceBroker(policy=resolve_policy(scenario.elastic),
                                    lookahead=lookahead, clock=clock)

        def _build_trials() -> List[Trial]:
            out = []
            for i, config in enumerate(scenario.configs):
                cfg = dict(config)
                cfg.setdefault("sim_id", f"{scenario.name}-{i:05d}")
                cfg["sim_token"] = token
                if fault_dir is not None:
                    # Process tier: wall-time fault vocabulary.  Virtual
                    # durations make no sense for real children (they'd sleep
                    # real hours), so scripted timing is dropped and
                    # stragglers sleep a short real interval the virtual
                    # deadline math escalates around.
                    cfg.pop("step_s", None)
                    cfg.pop("jitter_s", None)
                    cfg.pop("durations", None)
                    cfg["fault_dir"] = fault_dir
                    if cfg.pop("straggle_s", None) is not None:
                        cfg.setdefault("straggle_wall_s", 3.0)
                out.append(Trial(
                    cfg, trainable_name=trainable_name,
                    resources=Resources(cpu=1.0,
                                        devices=int(cfg.get("devices_req", 1))),
                    stopping_criteria={
                        "training_iteration": scenario.stop_iteration},
                    trial_id=f"{token}-{i:05d}",
                ))
            return out

        scheduler = scheduler_factory()
        plan = None
        if resume:
            from ..core.resume import prepare_resume
            plan = prepare_resume(
                journal_path,
                _os.path.join(log_dir, "search_state.json"),
                scheduler, base_trials=_build_trials(),
                checkpoint_dir=_os.path.join(log_dir, "ckpt"),
                trainable_name=trainable_name,
                stopping_criteria={
                    "training_iteration": scenario.stop_iteration})
        logger: Logger = recorder
        if journal_path is not None:
            journal = JSONLLogger(
                journal_path, clock=clock, run_id=f"run-{token}",
                executor=executor, decisions=decisions is not False,
                resumed=plan is not None,
                initial_records=plan.n_journal_records if plan is not None else 0)
            logger = CompositeLogger([recorder, journal])
        snapshotter = None
        if log_dir is not None:
            from ..obs.flightrec import SearchStateSnapshotter
            snapshotter = SearchStateSnapshotter(
                _os.path.join(log_dir, "search_state.json"), clock=clock,
                interval_s=search_state_interval,
                watermark_fn=((lambda: journal.n_records)
                              if journal is not None else None))

        runner = TrialRunner(
            scheduler,
            ex,
            logger=logger,
            trainable_name=trainable_name,
            stopping_criteria={"training_iteration": scenario.stop_iteration},
            max_failures=scenario.max_failures,
            broker=broker,
            obs=obs,
            decisions=decisions,
            flight_recorder=flightrec,
            state_snapshotter=snapshotter,
        )
        if plan is not None:
            runner.apply_resume_plan(plan)
        else:
            for trial in _build_trials():
                runner.add_trial(trial)
        if fleet is not None:
            fleet.start()
        try:
            if interrupt_after_steps is not None:
                # Simulated controller kill -9: abandon the runner mid-sweep.
                # No final search-state snapshot, no on_experiment_end — only
                # what the original process had already flushed survives.
                for _ in range(interrupt_after_steps):
                    if not runner.step():
                        break
                ex.shutdown()  # reap worker threads; journals nothing
                trials = runner.trials
            else:
                trials = runner.run(max_steps=max_steps)
        except BaseException:
            # A controller exception IS the crash-forensics use case: leave a
            # bundle behind (CI uploads the dump dir with if: failure()).
            try:
                flightrec.dump(runner, ex, reason="abort")
            except Exception:
                pass
            raise
        finally:
            if fleet is not None:
                fleet.stop()
    if journal is not None:
        journal.close()
    reset_faults(token)
    return ScenarioResult(
        scenario=scenario, trials=trials, runner=runner, executor=ex,
        pool=None if executor == "cluster" else pool, clock=clock,
        recorder=recorder, flightrec=flightrec,
        wall_elapsed_s=_wall.monotonic() - t0, fleet=fleet)


# -- scenario generators ---------------------------------------------------------------

def _base_config(rng: random.Random, i: int) -> Dict[str, Any]:
    return {
        "lr": 10 ** rng.uniform(-3, -1),
        "step_s": rng.choice([0.5, 1.0, 2.0]),
        "jitter_s": 0.25,
        "sim_id": f"trial-{i:05d}",
    }


def crash_storm(n_trials: int = 250, seed: int = 0, stop_iteration: int = 5,
                crash_frac: float = 0.3, fatal_frac: float = 0.05) -> Scenario:
    """A fraction of trials crash once mid-run (absorbed by max_failures=1);
    ``fatal_frac`` of them crash twice and must exhaust the budget."""
    rng = random.Random(seed)
    configs, crashes, fatal = [], 0, 0
    for i in range(n_trials):
        cfg = _base_config(rng, i)
        r = rng.random()
        if r < fatal_frac:
            cfg["crash_at"] = rng.randint(1, stop_iteration)
            cfg["crash_count"] = 2  # retry crashes again -> ERROR
            crashes += 2
            fatal += 1
        elif r < crash_frac:
            site = rng.random()
            if site < 0.3:
                cfg["kill_at"] = rng.randint(1, stop_iteration)
            else:
                cfg["crash_at"] = rng.randint(1, stop_iteration)
            crashes += 1
        configs.append(cfg)
    return Scenario(name="crash-storm", configs=configs,
                    stop_iteration=stop_iteration, max_failures=1,
                    expected_crashes=crashes, expected_fatal=fatal)


def straggler_cascade(n_trials: int = 250, seed: int = 0,
                      stop_iteration: int = 4,
                      straggle_frac: float = 0.2,
                      heartbeat_timeout: float = 30.0) -> Scenario:
    """A fraction of trials stall one step far past the heartbeat timeout;
    the monitor must surface every one of them without perturbing any
    scheduler decision."""
    rng = random.Random(seed)
    configs, stragglers = [], 0
    for i in range(n_trials):
        cfg = _base_config(rng, i)
        if rng.random() < straggle_frac:
            cfg["straggle_at"] = rng.randint(1, stop_iteration)
            cfg["straggle_s"] = heartbeat_timeout * rng.uniform(2.5, 6.0)
            stragglers += 1
        configs.append(cfg)
    return Scenario(name="straggler-cascade", configs=configs,
                    stop_iteration=stop_iteration, max_failures=0,
                    heartbeat_timeout=heartbeat_timeout,
                    expected_stragglers=stragglers)


def resize_churn(n_trials: int = 250, seed: int = 0, stop_iteration: int = 5,
                 crash_frac: float = 0.1) -> Scenario:
    """Elastic fair-share on: every completion/stop frees capacity the broker
    immediately redistributes, so slices churn constantly while a sprinkle of
    crashes exercises resize-vs-restart interleavings."""
    rng = random.Random(seed)
    configs, crashes = [], 0
    for i in range(n_trials):
        cfg = _base_config(rng, i)
        if rng.random() < crash_frac:
            cfg["crash_at"] = rng.randint(1, stop_iteration)
            crashes += 1
        configs.append(cfg)
    return Scenario(name="resize-churn", configs=configs,
                    stop_iteration=stop_iteration, max_failures=1,
                    elastic="fair", expected_crashes=crashes)
