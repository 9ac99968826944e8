"""``repro_torch.launch.tune`` and the port's ``ModelTrainable`` under the
control plane, on the CPU (reduced smollm-135m, ``device="cpu"``).

A process-executor sweep of the port's trainable runs right after one of the
JAX package's in the same process: each package forks its workers from a
server of its own, so the port's workers hold no module of ``jax`` or of
``repro``, whatever ran before them.  PBT's exploit reaches a trial only
through ``save()``'s host copies.  The command line finishes with its results
table, refuses the executor that is not ported, and refuses the card when
there is none.  On the cluster tier (``--executor cluster``) a sweep's losses
are the process tier's, bit for bit, and a trial whose socket worker is
SIGKILLed after its second checkpoint restarts from that checkpoint and ends
with an uninterrupted run's losses.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import numpy as np
import pytest
import torch

import _worker_trainables as JW
import repro.core as jcore
import repro_torch.core as pcore
from repro_torch.configs import get_config
from repro_torch.launch import tune
from repro_torch.train.trainable import ModelTrainable, model_trainable_factory

ROOT = Path(__file__).resolve().parents[1]
TESTS_DIR = str(Path(__file__).resolve().parent)
ARCH = "smollm-135m"
WORKLOAD = dict(batch=2, seq_len=16, steps_per_iter=1, total_steps=4, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_model_trainable_factory_names_the_ports_module():
    cfg = get_config(ARCH).reduced()
    f = pickle.loads(pickle.dumps(model_trainable_factory(cfg, **WORKLOAD)))
    assert f.target == "repro_torch.train.trainable:make_model_trainable" and f.call
    assert f.kwargs == {"model_cfg": cfg, **WORKLOAD}
    cls = f.resolve()
    assert issubclass(cls, ModelTrainable) and cls.__name__ == f"ModelTrainable[{ARCH}]"
    t = cls({"lr": 1e-3})
    assert t.device == torch.device("cpu") and t.batch == 2 and t.steps_per_iter == 1


@pytest.mark.timeout(300)
def test_process_sweep_after_a_jax_one_loads_neither_jax_nor_repro():
    """The JAX package's process executor starts multiprocessing's forkserver
    first, preloaded with ``repro.core.workers``; the port's workers must not
    fork from it.  Each worker rebuilds ``model_trainable_factory``'s class
    and reports the modules it holds."""
    jcore.register_worker_factory("Counter", jcore.TrainableFactory(
        target="_worker_trainables:Counter", sys_path=(TESTS_DIR,)))
    ref = jcore.run_experiments(JW.Counter, {}, num_samples=1, executor="process",
                                stop={"training_iteration": 2}, total_devices=2)
    assert [t.status.value for t in ref.trials] == ["TERMINATED"]

    cfg = get_config(ARCH).reduced()
    factory = pcore.TrainableFactory(
        target="_torch_worker_trainables:make_probed_model_trainable",
        kwargs={"model_cfg": cfg, **WORKLOAD}, call=True, sys_path=(TESTS_DIR,))
    pcore.register_worker_factory("Probed", factory)
    run = pcore.run_experiments(factory, {"lr": pcore.grid_search([1e-3, 3e-3])},
                                executor="process", stop={"training_iteration": 2},
                                total_devices=4, resources_per_trial=pcore.Resources(devices=2))
    assert [t.status.value for t in run.trials] == ["TERMINATED"] * 2
    for t in run.trials:
        assert [r.training_iteration for r in t.results] == [1, 2]
        for r in t.results:
            assert r.metrics["foreign_modules"] == ""
            assert r.metrics["trainable_class"] == f"ModelTrainable[{ARCH}]"
            assert np.isfinite(r.metrics["loss"])
        assert t.profile["param_count"] == 1312000


class RestoreSpy(ModelTrainable):
    """Records the leaf types of every snapshot it is restored from."""

    restored = []

    def setup(self, config):
        super().setup({**WORKLOAD, "model_cfg": get_config(ARCH).reduced(), **config})

    def restore(self, snapshot):
        leaves, stack = [], [snapshot]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                leaves.append(node)
        RestoreSpy.restored.append({type(x).__name__ for x in leaves})
        super().restore(snapshot)


@pytest.mark.timeout(300)
def test_pbt_exploits_through_host_copies():
    RestoreSpy.restored = []
    run = pcore.run_experiments(
        RestoreSpy, {"lr": pcore.grid_search([1e-4, 3e-3, 1e-2, 3e-2])},
        scheduler=pcore.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=1,
            hyperparam_mutations={"lr": pcore.loguniform(1e-4, 1e-1)}, seed=0),
        stop={"training_iteration": 4}, total_devices=4,
        resources_per_trial=pcore.Resources(devices=1))
    assert {t.status.value for t in run.trials} == {"TERMINATED"}
    assert RestoreSpy.restored, "PBT exploited no trial"
    for kinds in RestoreSpy.restored:
        assert "Tensor" not in kinds and "ndarray" in kinds, kinds
    for t in run.trials:
        assert all(np.isfinite(r.metrics["loss"]) for r in t.results)


def test_tune_command_line_finishes_with_a_results_table():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--arch", ARCH, "--reduced",
         "--device", "cpu", "--scheduler", "asha", "--num-samples", "3", "--max-iters", "3",
         "--batch", "2", "--seq-len", "16", "--steps-per-iter", "1", "--total-devices", "16",
         "--devices-per-trial", "4"],
        capture_output=True, text=True, timeout=180, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[tune] results:" in out.stdout
    assert out.stdout.count(f"ModelTrainable[{ARCH}]_0000") >= 3
    assert "[tune] best loss:" in out.stdout


def test_tune_main_returns_the_analysis_and_binds_the_device():
    an = tune.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--scheduler", "fifo",
                    "--num-samples", "2", "--max-iters", "2", "--batch", "2", "--seq-len", "16",
                    "--steps-per-iter", "1", "--total-devices", "4", "--devices-per-trial", "2",
                    "--searcher", "tpe"])
    assert [t.status.value for t in an.trials] == ["TERMINATED"] * 2
    assert an.total_iterations() == 4 and np.isfinite(an.best_value())


@pytest.mark.parametrize("executor,item", [("vmap", "core/vmap_executor.py")])
def test_tune_refuses_the_executors_not_ported(executor, item, capsys):
    with pytest.raises(SystemExit):
        tune.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--executor", executor])
    assert item in capsys.readouterr().err


def test_tune_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--arch", ARCH, "--reduced", "--num-samples", "1", "--max-iters", "1"])


def test_a_trial_on_the_card_runs_the_kernel_path(monkeypatch):
    """On the card a trial's attention is the CUDA kernel, which launches or
    raises; it never runs the plain version."""
    cfg = get_config(ARCH).reduced()
    assert tune.trial_model(cfg, "cpu") == cfg
    monkeypatch.setattr(tune, "resolve_device", lambda device: torch.device("cuda"))
    assert tune.trial_model(cfg, "cuda").attn_impl == "pallas"


def test_chip_smoke_reads_the_sweeps_trace(tmp_path):
    """Phase 3b's control-plane share comes from the trace's step spans: one
    a trial iteration, each within the sweep's wall time."""
    import importlib.util
    import time

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    trace = tmp_path / "trace.json"
    t0 = time.perf_counter()
    an = tune.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--scheduler", "asha",
                    "--num-samples", "3", "--max-iters", "3", "--batch", "2", "--seq-len", "16",
                    "--steps-per-iter", "1", "--total-devices", "4", "--devices-per-trial", "1",
                    "--trace", str(trace)])
    wall = time.perf_counter() - t0
    spans = smoke.sweep_spans(json.loads(trace.read_text())["traceEvents"])
    n, seconds = spans["step"]
    assert n == an.total_iterations() and 0 < seconds < wall
    assert spans["build"][0] == spans["trial"][0] == 3


@pytest.fixture
def one_thread_workers(monkeypatch):
    """Worker processes forked from a forkserver of their own, started with
    ``OMP_NUM_THREADS=1``: the default thread pools of a few workers at once
    spin against each other on a few shared cores, two orders of magnitude
    slower a step.  The server is stopped after the test."""
    from repro_torch.core import workers

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(workers, "_DEFAULT_CTX", None)
    yield
    server = getattr(workers._DEFAULT_CTX, "server", None)
    if server is not None:
        server._stop()


def test_the_forkserver_preloads_with_this_process_path(one_thread_workers, monkeypatch):
    """The port's server is launched with every ``sys.path`` entry of this
    process on its ``PYTHONPATH`` (a Python whose forkserver ignores the
    path it is handed would otherwise fail the preload without a word), has
    the preload's torch in its image, and leaves this process's environment
    as it was."""
    from repro_torch.core import workers

    monkeypatch.setenv("PYTHONPATH", "/nonexistent")
    path = [p for p in sys.path if p]
    ctx = workers._default_context()
    p = ctx.Process(target=time.sleep, args=(0,))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 0
    pid = ctx.server._forkserver_pid
    env = dict(kv.split("=", 1) for kv in
               Path(f"/proc/{pid}/environ").read_text().split("\0") if "=" in kv)
    assert env["PYTHONPATH"].split(os.pathsep) == path
    assert "libtorch" in Path(f"/proc/{pid}/maps").read_text()
    assert os.environ["PYTHONPATH"] == "/nonexistent"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SWEEP = ["--arch", ARCH, "--reduced", "--device", "cpu", "--num-samples", "2", "--max-iters",
         "3", "--batch", "2", "--seq-len", "16", "--steps-per-iter", "1",
         "--devices-per-trial", "2", "--seed", "0"]


def _streams(an):
    return {json.dumps(t.config, sort_keys=True): (
        t.status.value, [r.training_iteration for r in t.results],
        [r.metrics["loss"] for r in t.results]) for t in an.trials}


@pytest.mark.timeout(300)
def test_tune_cluster_executor_gives_the_process_executors_losses(tmp_path, one_thread_workers):
    """Two simulated hosts of 2 devices, one trial a host, each a socket
    worker: every trial ends TERMINATED with the losses of the same sweep on
    the process executor, bit for bit."""
    ref = tune.main([*SWEEP, "--scheduler", "fifo", "--executor", "process",
                     "--total-devices", "4", "--log-dir", str(tmp_path / "process")])
    got = tune.main([*SWEEP, "--scheduler", "fifo", "--executor", "cluster", "--hosts", "2x2",
                     "--placement", "fixed", "--log-dir", str(tmp_path / "cluster")])
    assert _streams(got) == _streams(ref)
    assert [s for s, its, _ in _streams(got).values()] == ["TERMINATED"] * 2
    assert all(its == [1, 2, 3] for _, its, _ in _streams(got).values())


@pytest.mark.timeout(300)
def test_socket_worker_killed_after_its_second_checkpoint_restores_from_it(
        tmp_path, one_thread_workers):
    """chip_smoke's phase 3e failure run at reduced size: the worker is
    SIGKILLed as the controller adopts checkpoint 2; the trial restarts on a
    host from iteration 2, with one failure, and its losses are those of the
    same trial left alone."""
    smoke = _chip_smoke()
    args = [*SWEEP, "--num-samples", "1", "--max-iters", "4", "--scheduler", "fifo",
            "--executor", "cluster", "--hosts", "2x2", "--placement", "fixed"]
    ref = _streams(tune.main([*args, "--log-dir", str(tmp_path / "alone")]))
    killed, fetches = {}, []
    with smoke.killing_worker_after_checkpoint(2, killed), smoke.timed_fetches(fetches):
        an = tune.main([*args, "--max-failures", "1", "--trace", str(tmp_path / "trace.json"),
                        "--log-dir", str(tmp_path / "killed")])
    (t,) = an.trials
    assert killed["trial_id"] == t.trial_id
    assert t.status.value == "TERMINATED" and t.num_failures == 1
    its = [r.training_iteration for r in t.results]
    assert its[:2] == [1, 2] and min(its[2:]) == 3 and its[-1] == 4, its
    losses = {r.training_iteration: r.metrics["loss"] for r in t.results}
    ((_, ref_its, ref_losses),) = ref.values()
    assert losses == dict(zip(ref_its, ref_losses))
    rows = smoke.trace_rows(json.loads((tmp_path / "trace.json").read_text())["traceEvents"])
    split = smoke.restart_split(rows[t.trial_id], killed, fetches)
    assert split["restored_iteration"] == 2
    assert [f["to"] for f in fetches].count("host") == 1     # the restart's copy to its host
    assert all(v >= 0 for k, v in split.items() if k not in ("fork_and_dial", "to_step"))
    parts = sum(v for k, v in split.items() if k not in ("total", "restored_iteration"))
    assert abs(parts - split["total"]) < 1e-4          # the trace keeps whole microseconds
    assert not smoke.live_workers()


_LEAVES_PROCESSES = """
import json, os, subprocess, sys, time
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from multiprocessing import resource_tracker
from repro_torch.core import workers
assert smoke.adopt_orphans()
worker = workers._default_context().Process(target=time.sleep, args=(60,), name="trial-sleeper")
worker.start()
# a child that leaves a grandchild running and exits at once
subprocess.run([sys.executable, "-c",
                "import subprocess; subprocess.Popen(['sleep', '61'])"], check=True)
(orphan,) = [p for p, cmd in smoke.descendants(os.getpid()).items() if cmd == "sleep 61"]
started = {"worker": worker.pid, "forkserver": workers._DEFAULT_CTX.server._forkserver_pid,
           "tracker": resource_tracker._resource_tracker._pid, "orphan": orphan}
left = smoke.stop_started_processes()
print(json.dumps({"started": started, "left": {str(p): c for p, c in left.items()},
                  "after": list(smoke.descendants(os.getpid())),
                  "again": list(smoke.stop_started_processes())}))
"""


@pytest.mark.timeout(120)
def test_chip_smoke_stops_every_process_it_started(tmp_path):
    """chip_smoke's last step stops a trial worker, the port's forkserver
    and the resource tracker, and a process orphaned below it (which the
    subreaper brought back), and waits for each; a second call finds none."""
    script = tmp_path / "leaves.py"
    script.write_text(_LEAVES_PROCESSES)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(script), str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=100)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    started = got["started"]
    assert all(started.values()), started
    assert got["left"] == {str(started["orphan"]): "sleep 61"}
    assert got["after"] == [] and got["again"] == []
    for pid in started.values():
        assert not Path(f"/proc/{pid}").exists(), (pid, started)


def test_chip_smoke_counts_launches_in_the_trainable():
    """Phase 3e's trainable reports each wrapper's launches with every
    result; on the CPU the plain versions run and nothing counts."""
    smoke = _chip_smoke()
    cfg = get_config(ARCH).reduced()
    f = smoke.counted_factory(cfg, **WORKLOAD)
    assert f.target == "chip_smoke:counted_model_trainable" and f.call
    cls = f.resolve()
    assert cls.__name__ == f"ModelTrainable[{ARCH}]"
    base = model_trainable_factory(cfg, **WORKLOAD).resolve()
    out, ref = cls({"lr": 1e-3}).train(), base({"lr": 1e-3}).train()
    assert out["loss"] == ref["loss"]
    assert {k: out[k] for k in out if k.startswith("launches.")} == {
        f"launches.{name}": 0 for name in smoke.KERNELS}

    class R:
        def __init__(self, **m):
            self.metrics = m

    trials = [type("T", (), {"results": [R(**{"launches.flash_attention": 30}), R()]})()] * 2
    assert smoke.worker_launches(trials)["flash_attention"] == 60
    assert smoke.with_flags(("--a", "1", "--executor", "serial"), executor="cluster",
                            max_failures=1) == ("--a", "1", "--executor", "cluster",
                                                "--max-failures", "1")
