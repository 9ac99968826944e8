"""The trial's roofline profile (``profile_roofline=True``) and the copied
``launch/report.py`` and ``launch/explain.py`` CLIs, on the CPU.

The profile contract of JAX's ``tests/test_train.py::TestHardwareProfile::
test_roofline_tag`` on the port's ``ModelTrainable``; its count against JAX's
trainable's own (``hlo_costs`` of the step it compiles under the same flag);
a profiled trial trains bit for bit as one without the flag; the count runs
on the kernel-free config and reaches no kernel wrapper; a failed count
leaves the profile without its roofline keys and the trial running; the
port's ``HW`` is the placement tier's reference; and on the cluster tier
(``--hosts 2x2``) ``RooflinePlacement`` is handed the profiles' costs.

Then the originals' CLI contracts on the copies: JAX's
``tests/test_analysis_report.py`` cases of ``launch.report.main`` and
``tests/test_provenance.py``'s ``explain_main`` cases, on journals of the
port's sweeps, and a profiled trial's ``predicted_step_s`` and ``dominant``
in ``report.html``'s profile table.
"""
import dataclasses
import os

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import numpy as np
import pytest
import torch

import repro.launch.roofline as jroof
import repro.train.trainable as jtrainable
from repro.configs import get_config as jax_get_config
from repro_torch.cluster import HostSpec, RooflinePlacement
from repro_torch.cluster import placement as pplacement
from repro_torch.cluster.placement import workload_cost
from repro_torch.configs import get_config
from repro_torch.core import (ASHAScheduler, CheckpointManager, FIFOScheduler,
                              HyperBandScheduler, MedianStoppingRule, ObjectStore,
                              PopulationBasedTraining, Result, SerialMeshExecutor, Trainable,
                              Trial, TrialRunner, TrialStatus, run_experiments, uniform)
from repro_torch.core.loggers import CompositeLogger, JSONLLogger
from repro_torch.kernels import ops
from repro_torch.launch.explain import main as explain_main
from repro_torch.launch.mesh import HW
from repro_torch.launch.report import main as report_main
from repro_torch.models import ModelConfig
from repro_torch.obs.analysis import ExperimentAnalysis
from repro_torch.obs.report import _fmt
from repro_torch.testing import RecordingLogger, crash_storm, run_scenario
from repro_torch.train.trainable import (ModelTrainable, make_model_trainable,
                                        model_trainable_factory)

CFG = ModelConfig(arch_id="t", family="dense", n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=2, d_ff=128, vocab_size=64).validate()
WORKLOAD = dict(batch=4, seq_len=32, steps_per_iter=3, total_steps=10)
TERMS = ("compute", "memory", "collective")


def trainable(cfg=CFG, **hp):
    cls = make_model_trainable(cfg, device="cpu", **WORKLOAD)
    return cls({"lr": 1e-3, **hp})


@pytest.fixture
def one_thread():
    """One torch thread: the CPU's embedding backward accumulates in an
    order its threads race for, so two runs agree bit for bit only on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the profile contract ----------------------------------------------------------------

def test_roofline_tag():
    p = trainable(profile_roofline=True).step()["_profile"]
    assert p["predicted_step_s"] > 0
    assert p["dominant"] in TERMS
    assert p["achieved_vs_predicted"] > 0
    assert p["arg_bytes"] > 0 and p["temp_bytes"] > 0 and p["output_bytes"] > 0
    assert p["predicted_step_s"] == max(p[f"roofline_{t}_s"] for t in TERMS)


def test_without_the_flag_the_profile_has_no_roofline():
    p = trainable().step()["_profile"]
    assert not {"predicted_step_s", "dominant", "arg_bytes", "roofline_compute_s"} & set(p)


def test_terms_are_the_count_over_the_h100s_rates():
    tr = trainable(profile_roofline=True)
    p = tr.step()["_profile"]
    costs = tr._roofline_costs()
    assert p["roofline_compute_s"] == round(costs["dot_flops"] / 989e12, 6)
    assert p["roofline_memory_s"] == round(costs["traffic_bytes"] / 3.35e12, 6)
    assert p["roofline_collective_s"] == 0.0
    assert (p["arg_bytes"], p["temp_bytes"], p["output_bytes"]) == tuple(
        int(costs[k]) for k in ("arg_bytes", "temp_bytes", "output_bytes"))
    # parameters, both AdamW moments and the (B, S) int32 tokens and labels
    n = sum(q.numel() for q in tr.state.params.parameters())
    assert p["arg_bytes"] == 3 * 4 * n + 2 * 4 * 4 * 32


@pytest.mark.parametrize("microbatch", [0, 2])
def test_the_count_is_jax_trainables_count(microbatch):
    """JAX's trainable compiles its step ahead of time under the flag and
    walks that HLO; the port's meta replica of the same trial counts the
    same dot FLOPs, microbatched or not."""
    cfg = get_config("smollm-135m").reduced()
    jcls = jtrainable.make_model_trainable(jax_get_config("smollm-135m").reduced(),
                                           **WORKLOAD)
    jt = jcls({"lr": 1e-3, "profile_roofline": True, "microbatch": microbatch})
    want = jroof.hlo_costs(jt._compiled.as_text())["dot_flops"]
    tr = trainable(cfg, profile_roofline=True, microbatch=microbatch)
    assert tr._roofline_costs()["dot_flops"] == want


def test_a_profiled_trial_trains_bit_for_bit_as_one_without(one_thread):
    a, b = trainable(profile_roofline=True), trainable()
    ra = [a.step() for _ in range(2)]
    rb = [b.step() for _ in range(2)]
    assert "predicted_step_s" in ra[0]["_profile"]
    assert [r["loss"] for r in ra] == [r["loss"] for r in rb]
    assert [r["grad_norm"] for r in ra] == [r["grad_norm"] for r in rb]
    for (name, x), y in zip(a.state.params.named_parameters(), b.state.params.parameters()):
        assert torch.equal(x, y), name
    for key in ("m", "v"):
        for name, x in a.state.opt_state[key].items():
            assert torch.equal(x, b.state.opt_state[key][name]), (key, name)


def test_the_count_never_reaches_a_kernel_wrapper(monkeypatch):
    """With every kernel asked for, the counting pass runs the kernel-free
    config: the same costs as the defaults', and no wrapper is called."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    kernels = dataclasses.replace(cfg, attn_impl="pallas", kernel_impl="pallas")
    want = trainable(cfg)._roofline_costs()
    tr = trainable(kernels)

    def refuse(*args, **kwargs):
        raise AssertionError("the count reached a kernel wrapper")

    for name in ("flash_attention", "flash_attention_bwd", "moe_router", "moe_router_bwd",
                 "rwkv6_scan", "rglru_scan"):
        monkeypatch.setattr(ops, name, refuse)
    assert tr._roofline_costs() == want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_the_scans_count_as_their_kernel_free_path(arch):
    cfg = get_config(arch).reduced()
    kernels = dataclasses.replace(cfg, attn_impl="pallas", kernel_impl="pallas")
    assert trainable(kernels)._roofline_costs() == trainable(cfg)._roofline_costs()


def test_a_failed_count_is_no_failure(monkeypatch):
    def broken(self):
        raise RuntimeError("no count")

    monkeypatch.setattr(ModelTrainable, "_roofline_costs", broken)
    out = trainable(profile_roofline=True).step()
    assert np.isfinite(out["loss"]) and "steady_step_s" in out["_profile"]
    assert "predicted_step_s" not in out["_profile"]
    assert out["_profile"]["roofline_error"] == "RuntimeError: no count"


def test_hw_is_the_placement_tiers_reference():
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.ICI_BW) == (
        pplacement.REF_PEAK_FLOPS_BF16, pplacement.REF_HBM_BW, pplacement.REF_ICI_BW)
    spec = HostSpec(name="h")
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.ICI_BW) == (spec.peak_flops, spec.hbm_bw,
                                                          spec.link_bw)


def test_a_profile_gives_placement_the_counted_work():
    tr = trainable(profile_roofline=True)
    p = tr.step()["_profile"]
    t = Trial({"lr": 1e-3})
    t.profile = p
    cost = workload_cost(t)
    assert cost["flops"] == pytest.approx(p["roofline_compute_s"] * 989e12)
    assert cost["bytes"] == pytest.approx(p["roofline_memory_s"] * 3.35e12)
    assert cost["coll_bytes"] == 0.0


class RecordingPlacement(RooflinePlacement):
    """``RooflinePlacement`` that keeps the profile and cost of each trial it
    is asked to place."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.asked = []

    def place(self, trial, hosts):
        self.asked.append((trial.trial_id, dict(getattr(trial, "profile", None) or {}),
                           workload_cost(trial)))
        return super().place(trial, hosts)


@pytest.fixture
def one_thread_workers(monkeypatch):
    """Socket workers forked from a forkserver of their own, started with
    ``OMP_NUM_THREADS=1`` (a few default thread pools at once spin against
    each other on a few cores); the server is stopped after the test."""
    from repro_torch.core import workers

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(workers, "_DEFAULT_CTX", None)
    yield
    server = getattr(workers._DEFAULT_CTX, "server", None)
    if server is not None:
        server._stop()


def test_cluster_tier_places_profiled_trials_by_their_costs(tmp_path, one_thread_workers):
    """The reduced smollm on two simulated hosts of 2 devices, HyperBand
    pausing and resuming its trials, each a socket worker with
    ``profile_roofline=True``: every trial ends TERMINATED, and each resumed
    trial is placed with a profile that carries ``roofline_compute_s`` and
    the cost it stands for."""
    cfg = get_config("smollm-135m").reduced()
    placement = RecordingPlacement(devices_per_trial=1)
    an = run_experiments(
        model_trainable_factory(cfg, batch=2, seq_len=16, steps_per_iter=1, total_steps=9,
                                device="cpu", profile_roofline=True),
        {"lr": uniform(1e-4, 1e-2)}, num_samples=3,
        scheduler=HyperBandScheduler(metric="loss", mode="min", max_t=9, eta=3),
        stop={"training_iteration": 9}, executor="cluster", hosts="2x2",
        placement=placement, log_dir=str(tmp_path), seed=0)
    assert {t.status for t in an.trials} == {TrialStatus.TERMINATED}
    profiled = [(tid, prof, cost) for tid, prof, cost in placement.asked if prof]
    assert profiled, "no trial was placed with its profile"
    for tid, prof, cost in profiled:
        assert prof["roofline_compute_s"] >= 0 and prof["dominant"] in TERMS
        assert cost["flops"] == prof["roofline_compute_s"] * 989e12
        assert cost["bytes"] == prof["roofline_memory_s"] * 3.35e12
    for t in an.trials:
        assert "predicted_step_s" in t.profile


# -- launch.report (tests/test_analysis_report.py) ----------------------------------------

def test_report_cli_discovers_log_dir(tmp_path):
    jp = str(tmp_path / "events.jsonl")
    lg = JSONLLogger(jp)
    t = Trial({"lr": 0.1})
    for i in range(3):
        lg.on_result(t, Result(t.trial_id, i + 1, {"loss": 1.0 / (i + 1)}))
    t.set_status(TrialStatus.TERMINATED)
    lg.on_trial_complete(t)
    lg.close()
    assert report_main([str(tmp_path), "--mode", "min"]) == 0
    out = tmp_path / "report.html"
    assert out.exists() and "<svg" in out.read_text()


def test_report_cli_requires_journal(tmp_path):
    with pytest.raises(SystemExit):
        report_main([str(tmp_path)])  # empty dir: no journal to be found


def test_report_shows_a_profiled_trials_roofline(tmp_path):
    """A port sweep of the reduced smollm, one trial with
    ``profile_roofline=True``: ``report.html``'s profile table shows its
    ``predicted_step_s`` and ``dominant``."""
    cfg = get_config("smollm-135m").reduced()
    log_dir = str(tmp_path / "run")
    run_experiments(make_model_trainable(cfg, batch=2, seq_len=16, steps_per_iter=2,
                                         total_steps=4, device="cpu", profile_roofline=True),
                    {"lr": 1e-3}, scheduler=FIFOScheduler(metric="loss", mode="min"),
                    stop={"training_iteration": 2}, log_dir=log_dir)
    (tid,) = ExperimentAnalysis.from_journal(os.path.join(log_dir, "events.jsonl")).trial_ids()
    prof = ExperimentAnalysis.from_journal(os.path.join(log_dir, "events.jsonl")).get(
        tid).profile
    assert report_main([log_dir, "--metric", "loss"]) == 0
    html = open(os.path.join(log_dir, "report.html")).read()
    table = html[html.index("<h2>Hardware profiles</h2>"):]
    table = table[:table.index("</table>")]
    assert "predicted_step_s" in table and "dominant" in table
    row = table[table.index(f"<td>{tid}</td>"):]
    assert (f"<td class='num'>{_fmt(prof['predicted_step_s'])}</td>"
            f"<td class='num'>{_fmt(prof['dominant'])}</td>") in row
    assert prof["dominant"] in TERMS and prof["predicted_step_s"] > 0


# -- launch.explain (tests/test_provenance.py's explain CLI cases) -------------------------

class DecayTrainable(Trainable):
    """loss = quality + 0.8^iter — separable per-trial quality."""

    def setup(self, config):
        self.q = config["quality"]
        self.x = 1.0

    def step(self):
        self.x *= 0.8
        return {"loss": self.q + self.x}

    def save(self):
        return {"x": self.x, "q": self.q}

    def restore(self, state):
        self.x = state["x"]
        self.q = state["q"]

    def reset_config(self, cfg):
        self.q = cfg["quality"]
        return True


def run_qualities(qualities, scheduler, max_iter=20, devices=4, journal_path=None):
    """One quality per trial on the port's serial executor, journaled."""
    executor = SerialMeshExecutor(
        trainable_cls_resolver=lambda name: DecayTrainable,
        checkpoint_manager=CheckpointManager(ObjectStore()),
        total_devices=devices, checkpoint_freq=1)
    recorder = RecordingLogger()
    journal = JSONLLogger(journal_path, run_id="run-prov")
    runner = TrialRunner(scheduler, executor, logger=CompositeLogger([recorder, journal]),
                         stopping_criteria={"training_iteration": max_iter})
    for i, q in enumerate(qualities):
        runner.add_trial(Trial({"quality": q}, trial_id=f"t{i:03d}",
                               stopping_criteria={"training_iteration": max_iter}))
    runner.run()
    journal.close()


def trial_with(jp, verdict, reason=None):
    an = ExperimentAnalysis.from_journal(jp)
    return next(t for t in an.trial_ids()
                if any(d["info"]["verdict"] == verdict
                       and (reason is None or (d["info"]["inputs"] or {}).get("reason") == reason)
                       for d in an.decisions(t)))


def explain(capsys, *args):
    assert explain_main(list(args)) == 0
    return capsys.readouterr().out


def test_fifo_stop_answer(tmp_path, capsys):
    jp = str(tmp_path / "ev.jsonl")
    run_qualities([0.1], FIFOScheduler(metric="loss", mode="min"), max_iter=5, journal_path=jp)
    out = explain(capsys, "--journal", jp, "--trial", "t000")
    assert "trial t000: TERMINATED, 5 iterations" in out
    assert "training_iteration reached its bound (5 >= 5)" in out
    assert "fate: STOP by TrialRunner" in out


def test_asha_stop_answer(tmp_path, capsys):
    jp = str(tmp_path / "ev.jsonl")
    sched = ASHAScheduler(metric="loss", mode="min", max_t=20, grace_period=2,
                          reduction_factor=3)
    run_qualities(list(np.linspace(0.0, 2.0, 16)), sched, max_iter=20, journal_path=jp)
    out = explain(capsys, "--journal", jp, "--trial", trial_with(jp, "STOP", "rung"))
    assert "STOP by AsyncHyperBandScheduler" in out
    assert "rung@" in out and "vs cutoff" in out


def test_hyperband_cut_answer(tmp_path, capsys):
    jp = str(tmp_path / "ev.jsonl")
    sched = HyperBandScheduler(metric="loss", mode="min", max_t=9, eta=3)
    run_qualities(list(np.linspace(0.0, 2.0, 9)), sched, max_iter=9, devices=3,
                  journal_path=jp)
    out = explain(capsys, "--journal", jp, "--trial", trial_with(jp, "STOP", "cut"))
    assert "halving cut@" in out and "STOP by HyperBandScheduler" in out


def test_median_stop_answer(tmp_path, capsys):
    jp = str(tmp_path / "ev.jsonl")
    sched = MedianStoppingRule(metric="loss", mode="min", grace_period=2,
                               min_samples_required=2)
    run_qualities([0.0, 0.1, 0.2, 1.5, 1.6, 1.7], sched, max_iter=15, journal_path=jp)
    out = explain(capsys, "--journal", jp, "--trial", trial_with(jp, "STOP", "median"))
    assert "best-so-far" in out and "vs median" in out


def test_pbt_perturb_answer(tmp_path, capsys):
    jp = str(tmp_path / "ev.jsonl")
    sched = PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=3,
        hyperparam_mutations={"quality": uniform(0.0, 2.0)},
        quantile_fraction=0.34, seed=0)
    run_qualities([0.0, 1.0, 2.0], sched, max_iter=15, devices=3, journal_path=jp)
    out = explain(capsys, "--journal", jp, "--trial", trial_with(jp, "RESTART_WITH_CONFIG"))
    assert "RESTART_WITH_CONFIG by PopulationBasedTraining" in out
    assert "exploit donor" in out


def test_unknown_trial(tmp_path, capsys):
    jp = str(tmp_path / "ev.jsonl")
    run_qualities([0.1], FIFOScheduler(metric="loss", mode="min"), max_iter=3, journal_path=jp)
    assert "not in journal" in explain(capsys, "--journal", jp, "--trial", "nope")


def test_no_source_errors(tmp_path):
    with pytest.raises(SystemExit):
        explain_main([str(tmp_path)])  # empty dir: no events.jsonl


def test_bundle_source(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_FLIGHTREC_DIR", str(tmp_path / "fr"))
    res = run_scenario(crash_storm(n_trials=20, seed=4),
                       lambda: FIFOScheduler(metric="loss", mode="min"),
                       pool_devices=8, token="cli-bundle")
    path = res.flightrec.dump(res.runner, res.executor, reason="manual")
    tid = next(t.trial_id for t in res.trials if t.status == TrialStatus.TERMINATED)
    out = explain(capsys, "--bundle", path, "--trial", tid)
    assert "bundle run-cli-bundle: reason=manual" in out
    assert f"trial {tid}: TERMINATED" in out
    assert "reached its bound" in out


def test_log_dir_discovery_explains_a_model_sweep(tmp_path, capsys):
    """``explain`` pointed at a port sweep's log directory finds its journal
    and answers for every trial that has decision records."""
    cfg = get_config("smollm-135m").reduced()
    log_dir = str(tmp_path / "run")
    run_experiments(make_model_trainable(cfg, batch=2, seq_len=16, steps_per_iter=1,
                                         total_steps=3, device="cpu"),
                    {"lr": uniform(1e-4, 1e-2)}, num_samples=2,
                    scheduler=FIFOScheduler(metric="loss", mode="min"),
                    stop={"training_iteration": 3}, log_dir=log_dir)
    out = explain(capsys, log_dir)
    assert out.count("fate: STOP by TrialRunner") == 2
