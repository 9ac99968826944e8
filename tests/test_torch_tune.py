"""``repro_torch.launch.tune`` and the port's ``ModelTrainable`` under the
control plane, on the CPU (reduced smollm-135m, ``device="cpu"``).

A process-executor sweep of the port's trainable runs right after one of the
JAX package's in the same process: each package forks its workers from a
server of its own, so the port's workers hold no module of ``jax`` or of
``repro``, whatever ran before them.  PBT's exploit reaches a trial only
through ``save()``'s host copies.  The command line finishes with its results
table, refuses the executors that are not ported, and refuses the card when
there is none.
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


@pytest.mark.parametrize("executor,item", [("cluster", "--executor cluster"),
                                           ("vmap", "core/vmap_executor.py")])
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
