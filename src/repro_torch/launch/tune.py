"""Distributed hyperparameter search launcher — the paper's workload.

    PYTHONPATH=src python -m repro_torch.launch.tune --arch smollm-135m \\
        --scheduler asha --num-samples 4 --max-iters 4 --batch 8 --seq-len 512 \\
        --steps-per-iter 2 --total-devices 8 --devices-per-trial 2      # on the card
    PYTHONPATH=src python -m repro_torch.launch.tune --arch smollm-135m --reduced \\
        --device cpu --scheduler asha --num-samples 3 --max-iters 3 --batch 2 \\
        --seq-len 16 --steps-per-iter 1 --total-devices 16 --devices-per-trial 4

Counterpart of ``repro.launch.tune``, with the same flags, schedulers,
searchers, results table and closing lines, plus ``--device`` (default
``cuda``; with no card it raises, as ``launch/train.py`` does).  Each trial is
a ``ModelTrainable`` on that device; on the card it trains through the
kernels ``launch/train.py`` picks (``device_model``: flash attention, and the
RWKV-6 and RG-LRU scans of the ssm and hybrid families, forward and
backward), and never through their plain versions.

``--executor`` picks the execution tier over a virtual ``SlicePool`` of
``--total-devices``: ``serial`` (host time-slicing), ``concurrent`` (one
worker thread per trial; on one card the threads share its default stream,
so trials interleave on the device rather than overlap) or ``process`` (one
worker process per trial, forked from the port's own forkserver, checkpoint
bytes over the ObjectStore spill surface, kill-on-straggle after
``--straggler-deadline`` seconds) or ``cluster`` (worker processes, forked
from the same server, scheduled across a roster of simulated hosts: each
dials the controller back over loopback TCP, saves content-addressed
checkpoints to its host's spill directory, and a host that stops
heartbeating is evicted, its trials restarting elsewhere from their last
fetched checkpoint under ``--max-failures``).  ``vmap`` is not ported yet
and exits with an error.

Cluster quickstart (2 simulated hosts of 2 devices, on the CPU; one thread
a worker, or four workers' thread pools contend for the cores)::

    OMP_NUM_THREADS=1 PYTHONPATH=src python -m repro_torch.launch.tune \\
        --arch smollm-135m --reduced --device cpu --scheduler asha \\
        --num-samples 4 --max-iters 3 --batch 2 --seq-len 16 --steps-per-iter 1 \\
        --devices-per-trial 1 --executor cluster --hosts 2x2 --placement fixed

``--hosts`` shapes the roster (``2x8`` = two hosts of eight devices;
``a:8,b:16`` names heterogeneous ones).  ``--placement roofline``
right-sizes each trial's slice from its roofline profile; the port's
profiles have no roofline fields yet, so it places ``--devices-per-trial``,
as ``fixed`` does.

``--trace``, ``--metrics-interval``, ``--live-table``, ``--report``,
``--decisions``, ``--flightrec``, ``--resume``, ``--log-dir``, ``--elastic``
and ``--lookahead`` work as in the original (its docstring has the
quickstarts), through the port's copy of the control plane.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

from .. import resolve_device
from ..configs import get_config, list_archs
from ..core import (ASHAScheduler, FIFOScheduler, GPSearcher,
                    HyperBandScheduler, MedianStoppingRule,
                    PopulationBasedTraining, Resources, TPESearcher,
                    RandomSearcher, loguniform, run_experiments, uniform)
from ..dist.submesh import SlicePool
from ..models import ModelConfig
from ..train.trainable import make_model_trainable, model_trainable_factory
from .train import device_model

# Executors of the original that the port does not run yet, and the ROADMAP
# item (Queue 1) that ports each.
NOT_PORTED = {"vmap": "core/vmap_executor.py"}

SPACE = {"lr": loguniform(1e-4, 1e-1), "warmup": 5,
         "weight_decay": uniform(0.0, 0.2)}


def build_scheduler(name: str, max_iters: int):
    if name == "fifo":
        return FIFOScheduler(metric="loss", mode="min")
    if name == "asha":
        return ASHAScheduler(metric="loss", mode="min", max_t=max_iters,
                             grace_period=max(1, max_iters // 8),
                             reduction_factor=3)
    if name == "hyperband":
        return HyperBandScheduler(metric="loss", mode="min", max_t=max_iters)
    if name == "median":
        return MedianStoppingRule(metric="loss", mode="min", grace_period=2)
    if name == "pbt":
        return PopulationBasedTraining(
            metric="loss", mode="min",
            perturbation_interval=max(2, max_iters // 5),
            hyperparam_mutations={"lr": loguniform(1e-4, 1e-1)})
    raise ValueError(name)


def trial_model(cfg: ModelConfig, device) -> ModelConfig:
    """The config a trial trains on ``device``: the kernels of
    ``launch/train.py`` (``device_model``) on the card."""
    return device_model(cfg, resolve_device(device))


def sweep_model(args: argparse.Namespace) -> ModelConfig:
    """The model every trial of the sweep trains."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return trial_model(cfg, args.device)


def workload(args: argparse.Namespace) -> Dict[str, Any]:
    """The workload every trial of a sweep binds, the device among it."""
    return dict(batch=args.batch, seq_len=args.seq_len,
                steps_per_iter=args.steps_per_iter,
                total_steps=args.max_iters * args.steps_per_iter,
                device=args.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--scheduler", default="asha",
                    choices=["fifo", "asha", "hyperband", "median", "pbt"])
    ap.add_argument("--searcher", default=None, choices=[None, "tpe", "gp", "random"])
    ap.add_argument("--num-samples", type=int, default=8)
    ap.add_argument("--max-iters", type=int, default=10)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps-per-iter", type=int, default=3)
    ap.add_argument("--devices-per-trial", type=int, default=8)
    ap.add_argument("--total-devices", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="device every trial trains on (cuda, or cpu)")
    ap.add_argument("--executor", default="serial",
                    choices=["serial", "concurrent", "process", "cluster",
                             *NOT_PORTED])
    ap.add_argument("--hosts", default="2x8",
                    help="cluster executor roster: N (hosts x 8 devices), "
                         "'3x8', or 'name:devs,...' per host (see "
                         "repro_torch.cluster.parse_hosts)")
    ap.add_argument("--placement", default="roofline",
                    choices=["roofline", "fixed"],
                    help="cluster executor: right-size slices from roofline "
                         "cost profiles, or place the requested width as-is")
    ap.add_argument("--max-failures", type=int, default=0,
                    help="restart a crashed trial from its last checkpoint up "
                         "to N times before marking it ERROR")
    ap.add_argument("--max-experiment-failures", type=int, default=0,
                    help="abort the experiment once more than N trials errored "
                         "(0 = never)")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0,
                    help="concurrent/process executors: seconds before a "
                         "stalled step emits HEARTBEAT_MISSED")
    ap.add_argument("--straggler-deadline", type=float, default=300.0,
                    help="process executor: hard per-step deadline after which "
                         "a straggling worker is SIGKILLed, its slice returned "
                         "to the pool, and the trial requeued from its last "
                         "checkpoint under --max-failures (0 disables)")
    ap.add_argument("--elastic", default="off",
                    choices=["off", "greedy", "fair"],
                    help="elastic slice resize at checkpoint boundaries: "
                         "'greedy' grows survivors into capacity freed by "
                         "early-stopped trials, 'fair' rebalances the pool "
                         "across running trials")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="max un-consumed results a worker may run ahead of "
                         "the scheduler (saves a control-plane round-trip per "
                         "step for process workers); automatically clamped to "
                         "1 unless the scheduler never stops/perturbs trials "
                         "(fifo)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Chrome trace-event JSON of every control-"
                         "plane span (schedule decision, slice acquire, "
                         "build, step, ckpt save/restore, resize, restart) "
                         "to PATH; view in Perfetto or chrome://tracing")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="snapshot the control-plane metrics registry every "
                         "S seconds to <log-dir>/metrics.jsonl and print a "
                         "status table at experiment end (0 disables)")
    ap.add_argument("--live-table", action="store_true",
                    help="render the live trial status table (status / iter / "
                         "metric / devices / restarts) as results stream in")
    ap.add_argument("--report", action="store_true",
                    help="write the self-contained HTML run report to "
                         "<log-dir>/report.html at experiment end (requires "
                         "--log-dir; survives an aborting sweep)")
    ap.add_argument("--decisions", default="on",
                    choices=["on", "full", "off"],
                    help="journal scheduler/searcher verdicts as typed "
                         "DECISION records with their inputs; 'full' includes "
                         "CONTINUE verdicts, 'off' disables")
    ap.add_argument("--flightrec", default=None, metavar="DIR",
                    help="dump a crash-forensics bundle (last-N events + "
                         "decisions, scheduler/searcher state, trial table) "
                         "to DIR on SIGTERM/abort; defaults to "
                         "<log-dir>/flightrec when --log-dir is set")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted (even kill -9'd) sweep from "
                         "<log-dir>'s durable artifacts: journal replay + "
                         "search-state snapshot + checkpoint mirrors; pass the "
                         "same sweep arguments as the original run")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Run the sweep the arguments describe, print its results table, and
    return its ``ExperimentAnalysis``."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.executor in NOT_PORTED:
        ap.error(f"--executor {args.executor} is not yet ported to repro_torch "
                 f"(see ROADMAP.md, Queue 1: \"{NOT_PORTED[args.executor]}\")")
    if args.report and not args.log_dir:
        ap.error("--report requires --log-dir (the JSONL journal feeds it)")
    if args.resume and not args.log_dir:
        ap.error("--resume requires --log-dir (the run's artifacts live there)")

    cfg = sweep_model(args)
    if args.executor in ("process", "cluster"):
        # Spawn-safe recipe: worker processes rebuild the bound trainable by
        # re-importing make_model_trainable in the child.
        trainable = model_trainable_factory(cfg, **workload(args))
    else:
        trainable = make_model_trainable(cfg, **workload(args))

    searcher = None
    if args.searcher == "tpe":
        searcher = TPESearcher(SPACE, metric="loss", mode="min",
                               max_trials=args.num_samples, seed=args.seed)
    elif args.searcher == "gp":
        searcher = GPSearcher(SPACE, metric="loss", mode="min",
                              max_trials=args.num_samples, seed=args.seed)
    elif args.searcher == "random":
        searcher = RandomSearcher(SPACE, metric="loss", mode="min",
                                  max_trials=args.num_samples, seed=args.seed)

    analysis = run_experiments(
        trainable,
        None if searcher else SPACE,
        scheduler=build_scheduler(args.scheduler, args.max_iters),
        searcher=searcher,
        num_samples=args.num_samples if not searcher else 1,
        stop={"training_iteration": args.max_iters},
        resources_per_trial=Resources(cpu=1, devices=args.devices_per_trial),
        total_devices=args.total_devices,
        # per-host pools on the cluster tier: the roster is the capacity
        slice_pool=(None if args.executor == "cluster"
                    else SlicePool(n_virtual=args.total_devices)),
        executor=args.executor,
        hosts=args.hosts if args.executor == "cluster" else None,
        placement=args.placement,
        max_failures=args.max_failures,
        max_experiment_failures=args.max_experiment_failures,
        heartbeat_timeout=args.heartbeat_timeout,
        straggler_deadline=args.straggler_deadline,
        elastic=args.elastic,
        lookahead=args.lookahead,
        trace=args.trace,
        metrics_interval=args.metrics_interval,
        log_dir=args.log_dir,
        report=args.report,
        decisions={"on": True, "full": "full", "off": False}[args.decisions],
        flight_recorder=args.flightrec,
        live_table=args.live_table,
        resume=args.resume,
        verbose=True,
        seed=args.seed,
    )

    print("\n[tune] results:")
    for row in analysis.results_table():
        cfg_str = {k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in row["config"].items()
                   if isinstance(v, (int, float, str))}
        best = "   n/a" if row["best"] is None else f"{row['best']:.4f}"
        print(f"  {row['trial_id']}: {row['status']:10s} iters={row['iterations']:3d} "
              f"best={best} {cfg_str}")
    if analysis.best_value() is None:
        print("[tune] no trial produced a result (check that "
              "--devices-per-trial fits --total-devices)")
        return analysis
    print(f"[tune] best config: {json.dumps({k: v for k, v in analysis.best_config().items() if isinstance(v, (int, float, str))})}")
    print(f"[tune] best loss:   {analysis.best_value():.4f}")
    print(f"[tune] total training iterations across trials: {analysis.total_iterations()}")
    return analysis


if __name__ == "__main__":
    main()
