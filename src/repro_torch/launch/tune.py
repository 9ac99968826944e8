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
RWKV-6 and RG-LRU scans and the MoE router of the ssm, hybrid and moe
families, forward and backward), and never through their plain versions.

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
fetched checkpoint under ``--max-failures``) or ``vmap`` (homogeneous sweeps
as one SPMD program: ``min(--num-samples, 8)`` trials stacked as lanes of
one ``torch.func.vmap`` step, momentum SGD over (lr, weight_decay), each
kernel launched once for all lanes, the config's remat kept;
``build_vmap_executor``).  ``vmap``
takes every token family (dense, ssm, hybrid, moe): on the card each of
their kernels, forward and backward, has a ``vmap`` rule.  The audio and
vision families' frontends take no token batch, so those exit with an
error on either device.

Vmap quickstart (three lanes of the reduced model on the CPU; any token
arch, e.g. ``--arch rwkv6-1.6b``)::

    PYTHONPATH=src python -m repro_torch.launch.tune --arch smollm-135m \\
        --reduced --device cpu --executor vmap --scheduler asha \\
        --num-samples 3 --max-iters 3 --batch 2 --seq-len 16 --steps-per-iter 1

Cluster quickstart (2 simulated hosts of 2 devices, on the CPU; one thread
a worker, or four workers' thread pools contend for the cores)::

    OMP_NUM_THREADS=1 PYTHONPATH=src python -m repro_torch.launch.tune \\
        --arch smollm-135m --reduced --device cpu --scheduler asha \\
        --num-samples 4 --max-iters 3 --batch 2 --seq-len 16 --steps-per-iter 1 \\
        --devices-per-trial 1 --executor cluster --hosts 2x2 --placement fixed

``--hosts`` shapes the roster (``2x8`` = two hosts of eight devices;
``a:8,b:16`` names heterogeneous ones).  ``--placement roofline``
right-sizes each trial's slice from its roofline profile: a trial bound
with ``profile_roofline=True`` (``make_model_trainable``) counts one step
of itself on the meta device after its first iteration, and its profile's
``roofline_*_s`` give the placement its costs from then on (a resumed or
restarted trial); until a trial has one, it places ``--devices-per-trial``,
as ``fixed`` does.

``--trace``, ``--metrics-interval``, ``--live-table``, ``--report``,
``--decisions``, ``--flightrec``, ``--resume``, ``--log-dir``, ``--elastic``
and ``--lookahead`` work as in the original (its docstring has the
quickstarts), through the port's copy of the control plane.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

import torch

from .. import resolve_device
from ..configs import get_config, list_archs
from ..core import (ASHAScheduler, FIFOScheduler, GPSearcher,
                    HyperBandScheduler, MedianStoppingRule,
                    PopulationBasedTraining, Resources, TPESearcher,
                    RandomSearcher, loguniform, run_experiments, uniform)
from ..dist.submesh import SlicePool
from ..models import (LM, ModelConfig, aux_loss_coef, forward_train, train_loss,
                      train_stages)
from ..train.trainable import make_model_trainable, model_trainable_factory
from .train import device_model

# Families ``--executor vmap`` does not take, and why.
VMAP_REFUSED = dict.fromkeys(
    ("audio", "vlm"),
    "the vmap executor feeds token batches (SyntheticLMDataset), which its frontend does not "
    "take")

SPACE = {"lr": loguniform(1e-4, 1e-1), "warmup": 5,
         "weight_decay": uniform(0.0, 0.2)}
# Batches of the synthetic stream that the vmap executor keeps on the device;
# lane i's step s reads batch s % VMAP_BANKED.
VMAP_BANKED = 8


class TrainForward(LM):
    """An ``LM`` with no weights of its own (the meta device) whose forward
    is ``forward_train``: the module ``torch.func.functional_call`` runs on
    a lane's weights, which ``LM``, with no forward, cannot be.  With
    ``stage``, one stage of ``train_stages`` runs instead, on ``xs``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, None, torch.device("meta"))
        self.cfg = cfg

    def forward(self, *xs, stage=None):
        return forward_train(self, xs[0], self.cfg) if stage is None else stage(self, *xs)


def loss_and_grads(module: TrainForward, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]):
    """(gradients by parameter name, (loss, metrics)) of ``forward_train``
    at ``params``, through ``torch.func`` (so that ``vmap`` can take it).

    The gradients come from ``torch.func.vjp``'s pull-back called with
    ``create_graph=False``: ``torch.func.grad`` runs autograd with
    ``create_graph=True``, so its backward records a graph of itself, which
    keeps the activations and every intermediate gradient alive until the
    last gradient of the step is out.  With ``cfg.remat`` the forward is
    rematerialised a repeat at a time, as JAX's ``jax.checkpoint`` on the
    scan body does (``_remat_loss_and_grads``)."""
    if module.cfg.remat:
        return _remat_loss_and_grads(module, params, batch)
    loss, pull, metrics = torch.func.vjp(
        lambda p: torch.func.functional_call(module, p, (batch,)), params, has_aux=True)
    (grads,) = _pull(pull, torch.ones_like(loss))
    return grads, (loss, metrics)


def _pull(pull, cotangents):
    """A ``torch.func.vjp`` pull-back run once, without a graph of itself
    and freeing what its forward saved (the wrapper's defaults keep the
    graph and, with grad mode on, record one)."""
    return pull(cotangents, retain_graph=False, create_graph=False)


def _remat_loss_and_grads(module: TrainForward, params: Dict[str, torch.Tensor],
                          batch: Dict[str, torch.Tensor]):
    """``loss_and_grads`` as a chain of ``train_stages``, each a function of
    its own parameters only (a ``vjp`` over the whole dict would make a
    zero gradient of every parameter at every stage).  The embedding keeps
    its pull-back; the repeats run forward without autograd and keep only
    their inputs; the head and the loss run through ``vjp``; then each
    repeat, from the top, runs again through ``vjp`` and is pulled back at
    once (the cotangent of its aux loss is the loss's coefficient of it),
    its input dropped.  ``torch.utils.checkpoint``, the autograd paths'
    remat, cannot run under ``torch.func`` (it saves through saved-tensor
    hooks); nor can an ``autograd.Function`` that recomputes a repeat in its
    backward once that backward runs without a graph (functorch's batching
    asserts)."""
    cfg = module.cfg
    embed, repeats, head = train_stages(cfg, batch)
    coef = aux_loss_coef(cfg)

    def own(stage):
        return {n: t for n, t in params.items() if n.startswith(stage.prefixes)}

    def call(stage):
        return lambda p, *xs: torch.func.functional_call(module, p, xs, {"stage": stage.fn})

    grads: Dict[str, torch.Tensor] = {}

    def add(g):
        for n, t in g.items():
            grads[n] = grads[n] + t if n in grads else t

    x, embed_pull = torch.func.vjp(call(embed), own(embed))
    inputs, auxes = [], []
    with torch.no_grad():
        for stage in repeats:
            inputs.append(x)
            x, aux = call(stage)(own(stage), x)
            auxes.append(aux)
    ce, pull, acc = torch.func.vjp(call(head), own(head), x, has_aux=True)
    del x
    dp, dx = _pull(pull, torch.ones_like(ce))
    add(dp)
    for stage, aux in zip(reversed(repeats), reversed(auxes)):
        run = call(stage)
        if aux is None:
            _, pull = torch.func.vjp(lambda p, x: run(p, x)[0], own(stage), inputs.pop())
            dp, dx = _pull(pull, dx)
        else:
            _, pull = torch.func.vjp(run, own(stage), inputs.pop())
            dp, dx = _pull(pull, (dx, torch.full_like(aux, coef)))
        add(dp)
    add(_pull(embed_pull, dx)[0])
    aux_total = torch.zeros((), dtype=torch.float32, device=ce.device)
    for aux in auxes:
        if aux is not None:
            aux_total = aux_total + aux
    return {n: grads[n] for n in params}, train_loss(ce, acc, aux_total, cfg)


def build_vmap_executor(cfg: ModelConfig, args: argparse.Namespace):
    """Model selection as one SPMD program: ``min(--num-samples, 8)`` lanes
    of ``cfg``, vmapped over (lr, weight_decay) with momentum SGD.

    A lane's state is {"p": parameters by name, "m": momentum, "i": the
    step}; ``init_fn`` draws the parameters from a generator seeded with the
    trial's ``init_seed`` on ``--device``.  Step i of a lane reads batch
    i % 8 of the synthetic stream, banked on the device; its update is
    m = 0.9 m + g, then p = p - lr (m + weight_decay p).  With ``--log-dir``
    the executor's object store spills to ``<log-dir>/vmap-spill``: at
    smollm-135m's full width a lane's snapshot is 1.08 GB, and the store's
    2 GiB in memory would refuse the second.

    The lanes train ``cfg`` as given, its remat too, as JAX's lanes do:
    ``loss_and_grads`` pulls the gradients back without a graph of the
    backward, and with ``cfg.remat`` keeps only each repeat's input between
    the forward and the backward, running the repeat again for its
    gradients (each kernel of a repeat runs its forward twice a step and its
    backward once, for all lanes at a time)."""
    from ..core import CheckpointManager, ObjectStore
    from ..core.vmap_executor import VectorTrainableSpec, VmapExecutor
    from ..data import DataConfig, SyntheticLMDataset
    from ..models import init_params

    dev = resolve_device(args.device)
    data = SyntheticLMDataset(DataConfig(global_batch=args.batch, seq_len=args.seq_len,
                                         vocab_size=cfg.vocab_size))
    drawn = [data.batch_at(i) for i in range(VMAP_BANKED)]
    batches = {k: torch.stack([torch.from_numpy(b[k]) for b in drawn]).to(dev)
               for k in drawn[0]}
    module = TrainForward(cfg)

    def init_fn(seed, hypers):
        params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
        p = {n: t.detach() for n, t in params.named_parameters()}
        return {"p": p, "m": {n: torch.zeros_like(t) for n, t in p.items()},
                "i": torch.zeros((), dtype=torch.int32, device=dev)}

    def step_fn(state, hypers):
        batch = {k: x[state["i"] % VMAP_BANKED] for k, x in batches.items()}
        grads, (_, metrics) = loss_and_grads(module, state["p"], batch)
        m = {n: 0.9 * state["m"][n] + g for n, g in grads.items()}
        p = {n: w - hypers["lr"] * (m[n] + hypers["weight_decay"] * w)
             for n, w in state["p"].items()}
        return {"p": p, "m": m, "i": state["i"] + 1}, {"loss": metrics["loss"]}

    spec = VectorTrainableSpec(init_fn, step_fn, ("lr", "weight_decay"),
                               steps_per_iter=args.steps_per_iter)
    spill = os.path.join(args.log_dir, "vmap-spill") if args.log_dir else None
    return VmapExecutor(spec, CheckpointManager(ObjectStore(spill_dir=spill)),
                        n_lanes=min(args.num_samples, 8), total_devices=args.total_devices)


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
                    choices=["serial", "concurrent", "process", "cluster", "vmap"])
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
    if args.report and not args.log_dir:
        ap.error("--report requires --log-dir (the JSONL journal feeds it)")
    if args.resume and not args.log_dir:
        ap.error("--resume requires --log-dir (the run's artifacts live there)")

    cfg = sweep_model(args)
    if args.executor == "vmap" and cfg.family in VMAP_REFUSED:
        ap.error(f"--executor vmap does not take {args.arch} ({cfg.family} family): "
                 f"{VMAP_REFUSED[cfg.family]}")
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

    if args.executor == "vmap":
        executor = build_vmap_executor(cfg, args)
        pool = None  # lanes replace slices; placement is the stacked program's
    elif args.executor == "cluster":
        executor = args.executor
        pool = None  # per-host pools: the roster is the capacity
    else:
        executor = args.executor
        pool = SlicePool(n_virtual=args.total_devices)
    analysis = run_experiments(
        trainable,
        None if searcher else SPACE,
        scheduler=build_scheduler(args.scheduler, args.max_iters),
        searcher=searcher,
        num_samples=args.num_samples if not searcher else 1,
        stop={"training_iteration": args.max_iters},
        resources_per_trial=Resources(cpu=1, devices=args.devices_per_trial),
        total_devices=args.total_devices,
        slice_pool=pool,
        executor=executor,
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
