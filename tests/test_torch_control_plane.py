"""The port's copy of Tune's control plane against the original, on the CPU.

Each copied module must be the original's text, with ``repro_torch`` read as
``repro``, outside the places listed in ``DEVIATIONS``: a copy that drifts, or
a change that is not on the list, fails.  Then the same sweeps of the same
toy trainables (``_worker_trainables`` in the JAX package,
``_torch_worker_trainables`` in the port, with the same arithmetic) must give
the same journal in both packages: every result (trial, iteration, config,
metrics), every scheduler and runner decision with its inputs, and every
trial's end.  FIFO, ASHA, HyperBand and PBT run on the serial executor; FIFO
also on the concurrent and the process executors, whose trials interleave as
threads and processes are scheduled, so there each trial's own stream is
compared.  The searchers must suggest the same configs from the same seed.
"""
import ast
import difflib
import json
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import numpy as np
import pytest
import torch  # noqa: F401

import _torch_worker_trainables as PW
import _worker_trainables as JW
import repro.core as jcore
import repro_torch.core as pcore

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TESTS_DIR = str(Path(__file__).resolve().parent)

COPIES = """core/api.py core/clock.py core/resources.py core/trial.py core/events.py
core/object_store.py core/checkpoint.py obs/tracing.py obs/metrics.py obs/flightrec.py
obs/analysis.py obs/report.py obs/__init__.py core/search/__init__.py core/search/space.py
core/search/variants.py core/search/basic.py core/search/tpe.py core/search/gp.py
core/schedulers/__init__.py core/schedulers/base.py core/schedulers/fifo.py
core/schedulers/median_stopping.py core/schedulers/asha.py core/schedulers/hyperband.py
core/schedulers/pbt.py core/loggers.py core/executor.py core/runner.py
core/concurrent_executor.py core/workers.py core/process_executor.py dist/submesh.py
core/elastic.py core/resume.py core/experiment.py core/__init__.py
testing/sim.py testing/simworker.py testing/scenarios.py testing/invariants.py
testing/kill9.py testing/__init__.py cluster/transport.py cluster/hosts.py
cluster/placement.py cluster/worker.py cluster/sim.py cluster/executor.py
cluster/__init__.py""".split()

# Modules of the original the port leaves out, each for its ROADMAP item.
NOT_COPIED = {"core/vmap_executor.py"}

# The places where a copy differs from its original.  Keyed by module, then
# by the innermost function or class that holds each changed line
# ("<module>" for lines outside any): (lines of the original removed, lines
# of the copy added, why).
DEVIATIONS = {
    "core/api.py": {
        "<module>": (0, 3, "the docstring names the copy"),
    },
    "core/object_store.py": {
        "<module>": (1, 0, "sys was imported for the jax branch only"),
        "ObjectStore._estimate_size": (
            13, 13, "walks nested dicts, lists and tuples itself: never "
                    "jax.tree_util, which the original uses when jax is loaded"),
    },
    "core/checkpoint.py": {
        "_encode_leaf": (1, 3, "the comment on jax.Array goes: a CUDA tensor "
                               "raises, as np.asarray does"),
    },
    "core/workers.py": {
        "<module>": (0, 8, "imports io and forkserver for the server's launch; "
                           "blank lines"),
        "_ForkServer": (0, 10, "the server is first launched with this process's "
                               "sys.path as its PYTHONPATH: 3.12.3's forkserver "
                               "ignores the sys_path it is handed, and its preload "
                               "then fails silently"),
        "_ForkServer.ensure_running": (0, 13, "the same"),
        "_ForkServerContext": (0, 13, "a forkserver of the port's own: multiprocessing "
                                      "keeps one a process, preloaded once"),
        "_ForkServerContext.__init__": (0, 4, "the port's own server"),
        "_ForkServerProcess": (0, 6, "a worker of that server"),
        "_ForkServerProcess._Popen": (0, 9, "launches through that server"),
        "_ForkServerProcess._Popen.Popen": (0, 1, "launches through that server"),
        "_ForkServerProcess._Popen.Popen._launch": (0, 18, "popen_forkserver's _launch, "
                                                           "on that server"),
        "_default_context": (5, 5, "uses the port's own server"),
    },
    "dist/submesh.py": {
        "<module>": (1, 0, "math was used by make_mesh only"),
        "MeshSlice.make_mesh": (23, 6, "raises: device mode is a ROADMAP item"),
    },
    "cluster/hosts.py": {
        "HostSpec": (6, 6, "defaults and their docstring are an H100 SXM node's "
                           "(989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s "
                           "NVLink), not a TPU-class device's: the port states "
                           "no rate taken on or for a TPU"),
    },
    "cluster/placement.py": {
        "<module>": (7, 7, "REF_* and their comments are the H100 SXM's, the "
                           "units the port's profiles are written in, not "
                           "launch.mesh.HW's TPU v5e figures"),
    },
}


def _owners(lines):
    """(first line, last line, qualname) of every function and class."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = prefix + child.name
                first = min([child.lineno] + [d.lineno for d in child.decorator_list])
                out.append((first, child.end_lineno, name))
                walk(child, name + ".")
            else:
                walk(child, prefix)

    walk(ast.parse("\n".join(lines)), "")
    return out


def _owner(owners, line):
    inside = [(first, name) for first, last, name in owners if first <= line <= last]
    return max(inside)[1] if inside else "<module>"


def changed_lines(rel):
    """{qualname: (lines of the original removed, lines of the copy added)}
    of the copy of ``rel``, read with ``repro_torch`` as ``repro``."""
    orig = (SRC / "repro" / rel).read_text().splitlines()
    copy = (SRC / "repro_torch" / rel).read_text().replace("repro_torch", "repro").splitlines()
    o_own, c_own = _owners(orig), _owners(copy)
    out = {}
    matcher = difflib.SequenceMatcher(None, orig, copy, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        for i in range(i1, i2):
            out.setdefault(_owner(o_own, i + 1), [0, 0])[0] += 1
        for j in range(j1, j2):
            out.setdefault(_owner(c_own, j + 1), [0, 0])[1] += 1
    return {name: tuple(n) for name, n in out.items()}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original_outside_the_listed_deviations(rel):
    want = {name: (rm, add) for name, (rm, add, _why) in DEVIATIONS.get(rel, {}).items()}
    assert changed_lines(rel) == want


def test_every_module_of_the_control_plane_is_copied():
    orig = {p.relative_to(SRC / "repro").as_posix()
            for d in ("core", "obs", "testing", "cluster")
            for p in (SRC / "repro" / d).rglob("*.py")}
    assert orig - NOT_COPIED == set(COPIES) - {"dist/submesh.py"}
    assert set(DEVIATIONS) <= set(COPIES)
    assert not (SRC / "repro_torch" / "core" / "vmap_executor.py").exists()


def test_the_deviation_scan_sees_a_change(tmp_path, monkeypatch):
    """A one-line drift inside a function shows as that function's change."""
    (tmp_path / "repro" / "core").mkdir(parents=True)
    (tmp_path / "repro_torch" / "core").mkdir(parents=True)
    text = (SRC / "repro" / "core" / "resources.py").read_text()
    (tmp_path / "repro" / "core" / "resources.py").write_text(text)
    (tmp_path / "repro_torch" / "core" / "resources.py").write_text(
        text.replace("self._used_devices -= req.devices",
                     "self._used_devices -= 2 * req.devices"))
    monkeypatch.setattr(sys.modules[__name__], "SRC", tmp_path)
    assert changed_lines("core/resources.py") == {"ResourceAccountant.release": (1, 1)}


# -- the same sweeps in both packages ------------------------------------------------------

SCHEDULERS = {
    "fifo": lambda p: p.FIFOScheduler(metric="loss", mode="min"),
    "asha": lambda p: p.ASHAScheduler(metric="loss", mode="min", max_t=9, grace_period=1,
                                      reduction_factor=3),
    "hyperband": lambda p: p.HyperBandScheduler(metric="loss", mode="min", max_t=9, eta=3),
    "pbt": lambda p: p.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": p.loguniform(1e-4, 1e-1)}, seed=0),
}


def _journal(pkg, tmp_path, scheduler, executor, samples, iters):
    """The sweep's journal: results, decisions and trial ends, in order."""
    log_dir = tmp_path / pkg.__name__
    if executor == "process":
        module = "_worker_trainables" if pkg is jcore else "_torch_worker_trainables"
        pkg.register_worker_factory("LrCounter", pkg.TrainableFactory(
            target=f"{module}:LrCounter", sys_path=(TESTS_DIR,)))
    run = pkg.run_experiments(
        (JW if pkg is jcore else PW).LrCounter, {"lr": pkg.loguniform(1e-3, 1e-1)},
        scheduler=SCHEDULERS[scheduler](pkg), num_samples=samples,
        stop={"training_iteration": iters}, total_devices=4, checkpoint_freq=1,
        executor=executor, seed=0, log_dir=str(log_dir), decisions="full")
    assert {t.status.value for t in run.trials} == {"TERMINATED"}
    out = []
    for line in (log_dir / "events.jsonl").read_text().splitlines():
        e = json.loads(line)
        if e["event"] == "result":
            out.append(("result", e["trial_id"], e["iteration"], json.dumps(e["config"]),
                        json.dumps(e["metrics"], sort_keys=True)))
        elif e["event"] == "decision":
            info = e["info"]
            out.append(("decision", e["trial_id"], info["iteration"], info["source"],
                        info["by"], info["verdict"], json.dumps(info["inputs"], sort_keys=True)))
        elif e["event"] == "complete":
            out.append(("complete", e["trial_id"], e["iterations"], e["status"]))
    return out


SWEEPS = [("fifo", "serial", 4, 5), ("asha", "serial", 6, 9), ("hyperband", "serial", 6, 9),
          ("pbt", "serial", 6, 9), ("fifo", "concurrent", 3, 5), ("fifo", "process", 3, 4)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("scheduler,executor,samples,iters", SWEEPS,
                         ids=[f"{s}-{e}" for s, e, _, _ in SWEEPS])
def test_the_same_sweep_gives_the_same_journal(tmp_path, scheduler, executor, samples, iters):
    ref = _journal(jcore, tmp_path, scheduler, executor, samples, iters)
    got = _journal(pcore, tmp_path, scheduler, executor, samples, iters)
    if executor != "serial":       # trials interleave as threads and processes run
        ref, got = sorted(ref), sorted(got)
    assert got == ref
    kinds = {(e[0], e[5]) for e in ref if e[0] == "decision"}
    results = [e for e in ref if e[0] == "result"]
    assert len({e[1] for e in results}) == samples
    if scheduler == "asha":        # each sweep makes the decisions it exists for
        assert ("decision", "STOP") in kinds and len(results) < samples * iters
    elif scheduler == "hyperband":
        assert {("decision", "PAUSE"), ("decision", "PROMOTE")} <= kinds
    elif scheduler == "pbt":
        assert ("decision", "RESTART_WITH_CONFIG") in kinds
    else:
        assert len(results) == samples * iters


@pytest.mark.parametrize("name", ["random", "tpe", "gp"])
def test_searchers_suggest_the_same_configs(name):
    def suggestions(pkg):
        cls = {"random": pkg.RandomSearcher, "tpe": pkg.TPESearcher, "gp": pkg.GPSearcher}[name]
        space = {"lr": pkg.loguniform(1e-4, 1e-1), "warmup": 5,
                 "weight_decay": pkg.uniform(0.0, 0.2), "opt": pkg.choice(["adamw", "sgd"])}
        searcher = cls(space, metric="loss", mode="min", max_trials=14, seed=3)
        out = []
        for i in range(14):
            cfg = searcher.suggest(f"t{i}")
            loss = (np.log10(cfg["lr"]) + 2.5) ** 2 + cfg["weight_decay"] \
                + (cfg["opt"] == "sgd")
            searcher.observe(f"t{i}", cfg, loss, True)
            out.append(cfg)
        assert searcher.suggest("t14") is None
        return out

    ref = suggestions(jcore)
    assert suggestions(pcore) == ref
    assert len({c["lr"] for c in ref}) == 14


def test_object_store_sizes_host_snapshots_without_jax():
    snap = {"params": {"w": np.zeros((4, 8), np.float32), "b": {"bfloat16": np.zeros(8, np.uint16)}},
            "opt": [np.zeros(3, np.int64), (np.zeros(2), 7)], "step": 3}
    size = 4 * 8 * 4 + 8 * 2 + 3 * 8 + 2 * 8 + 64 + 64
    assert pcore.ObjectStore()._estimate_size(snap) == size
    assert jcore.ObjectStore()._estimate_size(snap) == size


def test_checkpoint_codec_refuses_a_device_tensor_it_cannot_read():
    """A tensor that numpy cannot read raises in the codec: nothing copies it
    to the host behind the trainable's back."""
    class OnTheCard:
        dtype, shape = "float32", (2,)

        def __array__(self, *args, **kwargs):
            raise TypeError("can't convert cuda:0 device type tensor to numpy")

    with pytest.raises(TypeError, match="cuda"):
        pcore.tree_to_bytes({"w": OnTheCard()})
    tree = {"w": np.arange(3.0), "n": 2}
    back = pcore.tree_from_bytes(pcore.tree_to_bytes(tree))
    assert np.array_equal(back["w"], tree["w"]) and back["n"] == 2


def test_cluster_executor_and_device_meshes_name_their_roadmap_items():
    """Device meshes name their ROADMAP item; the cluster executor is ported
    (``tests/test_torch_cluster.py``), so only the mesh half is left here."""
    from repro_torch.dist.submesh import MeshSlice, SlicePool

    with pytest.raises(NotImplementedError, match="device mode"):
        MeshSlice(0, 2).make_mesh(("data",))
    pool = SlicePool(n_virtual=8)
    a, b = pool.acquire(4), pool.acquire(4)
    assert (a.start, b.start) == (0, 4) and not pool.can_fit(2)
    pool.release(a), pool.release(b)
    assert pool.can_fit(8)
