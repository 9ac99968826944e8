"""The scenario harness (``repro_torch.testing``) on the port's copy of the
control plane, on the CPU.

These are the contracts of the JAX package's ``tests/test_scenarios.py``,
``test_sim_worker.py``, ``test_resume_equivalence.py`` and
``test_resume_kill9.py``, run on ``repro_torch.core`` and
``repro_torch.testing``, each limit as the original has it:

- the fault-scenario matrix (crash storm, straggler cascade, resize churn)
  across FIFO/ASHA/HyperBand/PBT on virtual time, and serial equivalence on
  a capacity-1 pool;
- the same fault vocabulary in real worker processes
  (``SimWorkerTrainable``), forked from the port's own forkserver;
- durable resume: a sweep interrupted in-process, or its controller
  SIGKILLed (``python -m repro_torch.testing.kill9``), and resumed from its
  on-disk artifacts ends bit-identical to the uninterrupted sweep.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import pytest
import torch  # noqa: F401

from repro_torch.core import (ASHAScheduler, CheckpointManager, EventType,
                              FIFOScheduler, HyperBandScheduler, ObjectStore,
                              PopulationBasedTraining, Resources, Trial,
                              TrialStatus)
from repro_torch.core.clock import VirtualClock
from repro_torch.core.process_executor import ProcessMeshExecutor
from repro_torch.core.schedulers.asha import AsyncHyperBandScheduler
from repro_torch.core.workers import TrainableFactory
from repro_torch.obs.analysis import ExperimentAnalysis
from repro_torch.testing import (Scenario, SimTrainable, check_all,
                                 check_serial_equivalence, crash_storm,
                                 reset_faults, resize_churn, run_scenario,
                                 straggler_cascade)
from repro_torch.testing.simworker import SimWorkerTrainable, _fire

REPO_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


# -- the fault-scenario matrix (test_scenarios.py) -------------------------------------

N_PER_CELL = 250  # x 4 schedulers = a 1000-trial sweep per scenario class

SCHEDULERS = {
    "fifo": lambda: FIFOScheduler(metric="loss", mode="min"),
    "asha": lambda: ASHAScheduler(metric="loss", mode="min", max_t=5,
                                  grace_period=2, reduction_factor=2),
    "hyperband": lambda: HyperBandScheduler(metric="loss", mode="min",
                                            max_t=4, eta=2),
    "pbt": lambda: PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.005, 0.02, 0.08]}, seed=0),
}

SCENARIOS = {
    "crash-storm": lambda n, seed: crash_storm(n_trials=n, seed=seed),
    "straggler-cascade": lambda n, seed: straggler_cascade(n_trials=n, seed=seed),
    "resize-churn": lambda n, seed: resize_churn(n_trials=n, seed=seed),
}

# Wall budget per 250-trial cell; the whole 12-cell matrix must land far
# under the 60s acceptance bound, so a single cell creeping past this is a
# perf regression worth failing on.
CELL_WALL_BUDGET_S = 20.0


@pytest.mark.timeout(300)
class TestFaultScenarioMatrix:
    @pytest.mark.parametrize("scenario_name", list(SCENARIOS))
    @pytest.mark.parametrize("sched_name", list(SCHEDULERS))
    def test_sweep_cell(self, scenario_name, sched_name):
        scenario = SCENARIOS[scenario_name](N_PER_CELL, seed=11)
        t0 = time.monotonic()
        result = run_scenario(scenario, SCHEDULERS[sched_name],
                              executor="concurrent", pool_devices=8)
        wall = time.monotonic() - t0
        # Only FIFO runs every trial to completion, so only there do the
        # scripted fault counts reconcile exactly; early-stopping schedulers
        # may cancel a trial before its fault fires (bounds still hold).
        check_all(result,
                  strict=(sched_name == "fifo"),
                  gapless=(sched_name != "pbt"))
        assert result.virtual_elapsed_s > 10.0, "suspiciously little virtual time"
        assert wall < CELL_WALL_BUDGET_S, (
            f"{scenario_name} x {sched_name}: {N_PER_CELL} trials took "
            f"{wall:.1f}s wall (> {CELL_WALL_BUDGET_S}s) — virtual-time "
            f"harness perf regression")
        # State continuity through every restart/resize: the counter a trial
        # reports must track its iteration exactly (PBT clones excepted — a
        # donor's counter legitimately jumps the stream forward).
        if sched_name != "pbt":
            for t in result.trials:
                for r in t.results:
                    assert r.metrics["n"] == r.training_iteration, (
                        t.trial_id, r.training_iteration, r.metrics)

    def test_resize_churn_actually_churns(self):
        scenario = resize_churn(n_trials=80, seed=3)
        result = run_scenario(scenario, SCHEDULERS["asha"],
                              executor="concurrent", pool_devices=8)
        check_all(result, strict=False)
        assert result.runner.broker is not None
        assert result.runner.broker.n_resized >= 1, (
            "fair-share churn scenario produced no resizes")

    def test_straggler_cascade_surfaces_every_straggler(self):

        scenario = straggler_cascade(n_trials=120, seed=5)
        result = run_scenario(scenario, SCHEDULERS["fifo"],
                              executor="concurrent", pool_devices=8)
        check_all(result, strict=True)
        warned = {e.trial_id for e in result.recorder.of(EventType.HEARTBEAT_MISSED)}
        assert len(warned) == scenario.expected_stragglers
        # heartbeats never perturbed an outcome: every trial still finished
        assert all(t.status.value == "TERMINATED" for t in result.trials)


@pytest.mark.timeout(300)
class TestSerialEquivalence:
    """On a capacity-1 pool the concurrent tier (virtual worker threads,
    heartbeat monitor running) must reproduce the serial executor's statuses,
    result streams and losses exactly — faults included."""

    @pytest.mark.parametrize("sched_name", list(SCHEDULERS))
    def test_equivalence_under_faults(self, sched_name):
        scenario = crash_storm(n_trials=10, seed=23, crash_frac=0.5,
                               fatal_frac=0.1)
        check_serial_equivalence(scenario, SCHEDULERS[sched_name])

    def test_equivalence_with_stragglers(self):
        # Heartbeat events fire on the concurrent run only; decisions must
        # not notice.
        scenario = straggler_cascade(n_trials=8, seed=2, straggle_frac=0.5,
                                     heartbeat_timeout=10.0)
        check_serial_equivalence(scenario, SCHEDULERS["asha"])


class TestSimTrainableFaults:
    def test_crash_fires_limited_times(self):
        reset_faults()
        cfg = {"sim_id": "x", "sim_token": "tok", "step_s": 0.0,
               "crash_at": 2, "crash_count": 2}
        for incarnation in range(3):
            tr = SimTrainable(dict(cfg))
            tr.restore({"n": 1})
            if incarnation < 2:
                with pytest.raises(RuntimeError, match="injected crash"):
                    tr.step()
            else:
                assert tr.step()["n"] == 2  # budget spent; step succeeds
        reset_faults("tok")

    def test_kill_is_distinct_exception(self):
        from repro_torch.testing import SimKilled

        reset_faults()
        tr = SimTrainable({"sim_id": "k", "sim_token": "tok2", "step_s": 0.0,
                           "kill_at": 1})
        with pytest.raises(SimKilled):
            tr.step()
        assert tr.step()["n"] == 1  # kill fires once
        reset_faults("tok2")

    def test_straggle_consumes_virtual_time(self):
        from repro_torch.core import VirtualClock, use_clock

        reset_faults()
        with use_clock(VirtualClock()) as vc:
            tr = SimTrainable({"sim_id": "s", "sim_token": "tok3",
                               "step_s": 1.0, "straggle_at": 2,
                               "straggle_s": 300.0})
            tr.step()
            assert vc.monotonic() == pytest.approx(1.0)
            tr.step()  # the straggle
            assert vc.monotonic() == pytest.approx(301.0)
            tr.step()  # fired once; back to scripted pace
            assert vc.monotonic() == pytest.approx(302.0)
        reset_faults("tok3")


# -- scenarios in real worker processes (test_sim_worker.py) ---------------------------

def _fifo():
    return FIFOScheduler(metric="loss", mode="min")


class TestFireMarkers:
    def test_fire_consumes_exactly_limit_across_incarnations(self, tmp_path):
        d = str(tmp_path)
        assert _fire(d, "s0", "crash", 2)       # incarnation 1
        assert _fire(d, "s0", "crash", 2)       # incarnation 2
        assert not _fire(d, "s0", "crash", 2)   # budget durably spent
        assert not _fire(d, "s0", "crash", 0)   # limit 0 never fires
        assert not _fire("", "s0", "crash", 5)  # no dir -> no faults
        assert sorted(os.listdir(d)) == ["s0.crash.0", "s0.crash.1"]

    def test_fire_sites_are_independent(self, tmp_path):
        d = str(tmp_path)
        assert _fire(d, "s0", "crash", 1)
        assert _fire(d, "s0", "kill", 1)        # different site, own budget
        assert _fire(d, "s1", "crash", 1)       # different trial, own budget
        assert not _fire(d, "s0", "crash", 1)


@pytest.mark.timeout(600)
class TestProcessTierScenarios:
    def test_fault_storm_in_real_processes(self):
        """The pscen acceptance run: 8 trials, one mid-run raise, one real
        ``os._exit`` kill, one double-crash that exhausts max_failures=1 —
        all faults reconcile through check_all."""
        cfgs = []
        crashes = fatal = 0
        for i in range(8):
            cfg = {"lr": 0.01 + i * 0.001}
            if i == 2:
                cfg["crash_at"] = 2
                crashes += 1
            if i == 5:
                cfg["kill_at"] = 3
                crashes += 1
            if i == 7:
                cfg["crash_at"] = 1
                cfg["crash_count"] = 2
                crashes += 2
                fatal += 1
            cfgs.append(cfg)
        sc = Scenario(name="pstorm", configs=cfgs, stop_iteration=4,
                      max_failures=1, heartbeat_timeout=60.0,
                      expected_crashes=crashes, expected_fatal=fatal)
        res = run_scenario(sc, _fifo, executor="process", pool_devices=8)
        check_all(res)
        by = res.by_status()
        assert by == {"TERMINATED": 7, "ERROR": 1}, by
        # crash@2, kill@3, and the double-crasher's FIRST crash all restart.
        assert res.runner.n_restarts == 3
        assert res.runner.n_errors == 1
        # The killed/crashed trials RESUMED (gapless streams already checked
        # by check_all; the ERROR trial is the double-crasher).
        (err,) = [t for t in res.trials if t.status == TrialStatus.ERROR]
        assert err.config.get("crash_count") == 2

    def test_virtual_deadline_kills_real_straggler(self, tmp_path):
        """A child stuck in a *real* sleep is reaped by a five-minute
        straggler deadline that elapses in virtual milliseconds: deadline
        arithmetic reads the injected clock, never the child's wall."""
        clock = VirtualClock()
        factory = TrainableFactory(
            target="repro_torch.testing.simworker:SimWorkerTrainable")
        ex = ProcessMeshExecutor(
            factory_resolver=lambda _n: factory,
            checkpoint_manager=CheckpointManager(ObjectStore()),
            clock=clock, heartbeat_timeout=0.0, straggler_deadline=300.0,
            spawn_timeout=0, checkpoint_freq=1)
        # Stall on the FIRST step: that one is credited by READY's initial
        # grant, so no runner is needed to put the worker in_step.
        trial = Trial({"sim_id": "strag", "fault_dir": str(tmp_path),
                       "straggle_at": 1, "straggle_wall_s": 60.0},
                      trainable_name="SimWorkerTrainable",
                      resources=Resources(cpu=1.0, devices=1),
                      stopping_criteria={"training_iteration": 5},
                      trial_id="strag-0")
        try:
            assert ex.start_trial(trial)
            seen = []
            while not any(e.type == EventType.ERROR for e in seen):
                ev = ex.get_next_event(timeout=30.0)  # 30 virtual s per call
                if ev is not None:
                    seen.append(ev)
                assert clock.monotonic() < 100_000.0, (
                    f"no ERROR after huge virtual wait; saw "
                    f"{[e.type for e in seen]}")
            kinds = [e.type for e in seen]
            assert EventType.HEARTBEAT_MISSED not in kinds  # warnings off
            assert EventType.KILLED in kinds, kinds
            killed = next(e for e in seen if e.type == EventType.KILLED)
            assert killed.info.get("stalled_s", 0) >= 300.0
            assert clock.monotonic() >= 300.0   # the deadline truly elapsed
            assert EventType.RESULT not in kinds  # it never finished a step
        finally:
            ex.shutdown()

    def test_straggler_scenario_roundtrip(self):
        """The DSL path: ``straggle_at`` in a process-tier scenario produces
        HEARTBEAT_MISSED warnings that reconcile in check_all."""
        cfgs = [{"lr": 0.01}, {"lr": 0.012, "straggle_at": 2}]
        sc = Scenario(name="pstrag", configs=cfgs, stop_iteration=3,
                      max_failures=1, heartbeat_timeout=0.5,
                      expected_stragglers=1)
        res = run_scenario(sc, _fifo, executor="process", pool_devices=4)
        check_all(res)
        assert res.by_status() == {"TERMINATED": 2}


class TestSimWorkerTrainableUnit:
    """In-process contract checks (no spawn): loss shape, save/restore,
    reset_config — the parts every scheduler in the matrix leans on."""

    def test_loss_and_checkpoint_roundtrip(self, tmp_path):
        t = SimWorkerTrainable({"lr": 0.03, "sim_id": "u0",
                                "fault_dir": str(tmp_path)})
        r1 = t.step()
        assert r1["loss"] == pytest.approx((0.03 - 0.01) ** 2 + 1.0)
        state = t.save()
        t.step()
        t.restore(state)
        assert t.step()["n"] == 2

    def test_reset_config_moves_lr(self, tmp_path):
        t = SimWorkerTrainable({"lr": 0.03, "sim_id": "u1",
                                "fault_dir": str(tmp_path)})
        assert t.reset_config({"lr": 0.01})
        assert t.step()["loss"] == pytest.approx(1.0)

    def test_crash_durably_consumed(self, tmp_path):
        cfg = {"lr": 0.01, "sim_id": "u2", "fault_dir": str(tmp_path),
               "crash_at": 1}
        t = SimWorkerTrainable(cfg)
        with pytest.raises(RuntimeError, match="injected crash"):
            t.step()
        # A rebuilt incarnation sees the marker and sails through.
        t2 = SimWorkerTrainable(cfg)
        assert t2.step()["n"] == 1


# -- durable resume, in-process interrupts (test_resume_equivalence.py) ----------------

STEP_S = [0.5, 0.7, 0.9, 1.1, 1.3, 1.7, 1.9, 2.3]

RESUME_SCHEDULERS = {
    "asha": lambda: AsyncHyperBandScheduler(
        metric="loss", mode="min", max_t=9, grace_period=1,
        reduction_factor=3),
    "hyperband": lambda: HyperBandScheduler(
        metric="loss", mode="min", max_t=9, eta=3),
    "pbt": lambda: PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.001, 0.004, 0.008, 0.02]}, seed=7),
}

# Cooperative-interrupt points (runner steps).  Early (most trials PENDING),
# mid-sweep (rungs/brackets part-filled; PBT mid-exploit window), and late
# (some trials TERMINATED, exploits of finished donors still ahead).
KILL_POINTS = {"asha": (9, 23, 41), "hyperband": (13, 29), "pbt": (19, 47, 71)}


def scenario(name):
    configs = [{"lr": 0.001 * (i + 1), "step_s": STEP_S[i],
                "jitter_s": 0.25} for i in range(8)]
    return Scenario(name=name, configs=configs, stop_iteration=9,
                    max_failures=0)


def sweep(kind, log_dir, **kw):
    return run_scenario(scenario(f"eqv-{kind}"), RESUME_SCHEDULERS[kind],
                        executor="concurrent", pool_devices=8,
                        token=f"eqv-{kind}", log_dir=log_dir,
                        search_state_interval=3.0, keep_last=50, **kw)


def table(res):
    return sorted((t.trial_id, t.status.value, t.training_iteration,
                   round(t.best_value("loss", "min") or -1.0, 9))
                  for t in res.trials)


def decisions(log_dir):
    """Per-trial decision streams: (source, verdict, iteration, inputs, t)."""
    out = {}
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        for line in f:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if obj.get("event") == "decision":
                info = dict(obj.get("info") or {})
                out.setdefault(obj.get("trial_id"), []).append(
                    (info.get("source"), info.get("verdict"),
                     info.get("iteration"),
                     json.dumps(info.get("inputs"), sort_keys=True),
                     obj.get("t")))
    return out


def summary(log_dir):
    return ExperimentAnalysis.from_journal(
        os.path.join(log_dir, "events.jsonl")).summary_json(
            metric="loss", mode="min")


def save_artifacts(*dirs, prefix=""):
    dest = os.environ.get("REPRO_RESUME_ARTIFACT_DIR")
    if not dest:
        return
    os.makedirs(dest, exist_ok=True)
    for d in dirs:
        shutil.copytree(d, os.path.join(dest, prefix + os.path.basename(d)),
                        dirs_exist_ok=True)


def assert_equivalent(clean_res, clean_dir, resumed_res, resumed_dir, label):
    problems = []
    if table(clean_res) != table(resumed_res):
        problems.append(f"trial table differs:\n  clean : {table(clean_res)}"
                        f"\n  resume: {table(resumed_res)}")
    dc, dr = decisions(clean_dir), decisions(resumed_dir)
    for tid in sorted(set(dc) | set(dr)):
        if dc.get(tid) != dr.get(tid):
            problems.append(f"decision stream differs for {tid}:"
                            f"\n  clean : {dc.get(tid)}"
                            f"\n  resume: {dr.get(tid)}")
    if summary(clean_dir) != summary(resumed_dir):
        problems.append("summary_json differs")
    if problems:
        save_artifacts(clean_dir, resumed_dir)
        pytest.fail(f"[{label}] resumed run is not bit-identical:\n"
                    + "\n".join(problems))


@pytest.fixture(scope="module")
def clean_runs(tmp_path_factory):
    """One uninterrupted reference sweep per scheduler."""
    out = {}
    for kind in RESUME_SCHEDULERS:
        d = str(tmp_path_factory.mktemp(f"clean_{kind}"))
        out[kind] = (sweep(kind, d), d)
    return out


@pytest.mark.parametrize("kind", list(RESUME_SCHEDULERS))
def test_resume_bit_identical(kind, clean_runs, tmp_path):
    clean_res, clean_dir = clean_runs[kind]
    for kill in KILL_POINTS[kind]:
        d = str(tmp_path / f"kill{kill}")
        sweep(kind, d, interrupt_after_steps=kill)
        resumed = sweep(kind, d, resume=True)
        assert_equivalent(clean_res, clean_dir, resumed, d,
                          f"{kind} kill@{kill}")


@pytest.mark.parametrize("kind", ["asha", "pbt"])
def test_double_interrupt(kind, clean_runs, tmp_path):
    """Kill the sweep, resume, kill the resumed run, resume again."""
    clean_res, clean_dir = clean_runs[kind]
    d = str(tmp_path / "twice")
    sweep(kind, d, interrupt_after_steps=23)
    sweep(kind, d, resume=True, interrupt_after_steps=8)
    resumed = sweep(kind, d, resume=True)
    assert_equivalent(clean_res, clean_dir, resumed, d,
                      f"{kind} double-interrupt")


def test_resume_without_journal_raises(tmp_path):
    with pytest.raises(ValueError):
        sweep("asha", str(tmp_path / "empty"), resume=True)


# -- durable resume after a SIGKILLed controller (test_resume_kill9.py) ----------------

def run_child(log_dir, scheduler, *extra, expect_kill=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.kill9", "--log-dir", log_dir,
         "--scheduler", scheduler, *extra],
        env=env, capture_output=True, text=True, timeout=300)
    if expect_kill:
        assert proc.returncode == -signal.SIGKILL, (
            f"child should have SIGKILLed itself, got rc={proc.returncode}\n"
            f"stderr: {proc.stderr[-2000:]}")
    else:
        assert proc.returncode == 0, (
            f"child failed rc={proc.returncode}\n"
            f"stderr: {proc.stderr[-2000:]}")
    return proc


@pytest.mark.parametrize("scheduler,kill_after",
                         [("asha", 12), ("hyperband", 9), ("pbt", 17)])
def test_kill9_resume_bit_identical(tmp_path, scheduler, kill_after):
    clean = str(tmp_path / f"{scheduler}_clean")
    killed = str(tmp_path / f"{scheduler}_killed")

    run_child(clean, scheduler)
    run_child(killed, scheduler, "--kill-after", str(kill_after),
              expect_kill=True)
    # The SIGKILLed controller must have left durable artifacts behind.
    assert os.path.exists(os.path.join(killed, "events.jsonl"))
    assert not os.path.exists(os.path.join(killed, "final.json"))
    run_child(killed, scheduler, "--resume")

    with open(os.path.join(clean, "final.json"), "rb") as f:
        final_clean = f.read()
    with open(os.path.join(killed, "final.json"), "rb") as f:
        final_resumed = f.read()
    dc, dr = decisions(clean), decisions(killed)
    problems = []
    if final_clean != final_resumed:
        problems.append("final.json differs (trial table / summary)")
    for tid in sorted(set(dc) | set(dr)):
        if dc.get(tid) != dr.get(tid):
            problems.append(f"decision stream differs for {tid}:"
                            f"\n  clean : {dc.get(tid)}"
                            f"\n  resume: {dr.get(tid)}")
    if problems:
        save_artifacts(clean, killed, prefix="kill9-")
        pytest.fail(f"[{scheduler} kill9@{kill_after}] resumed run is not "
                    "bit-identical:\n" + "\n".join(problems))
