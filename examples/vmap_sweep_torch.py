"""Beyond-paper: a hyperparameter sweep as ONE SPMD program, on the PyTorch port.

Eight trials of a small LM are stacked into a single ``torch.func.vmap``
train step and scheduled by ASHA — identical scheduling semantics to the
serial executor, each kernel launched once for all eight lanes.  The
counterpart of ``examples/vmap_sweep.py``, with its model two heads of 64
rather than of 32 (the CUDA flash attention takes head sizes 64, 80, 128 and
256).  Trials train on ``--device`` (default ``cuda``, where attention runs
the CUDA kernel and its backward under ``vmap``; with no card it raises), or
on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/vmap_sweep_torch.py
    PYTHONPATH=src python examples/vmap_sweep_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (ASHAScheduler, CheckpointManager, ObjectStore, Trial,
                              TrialRunner)
from repro_torch.core.vmap_executor import VectorTrainableSpec, VmapExecutor
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.tune import TrainForward, loss_and_grads, trial_model
from repro_torch.models import ModelConfig, init_params

CFG = ModelConfig(arch_id="sweep", family="dense", n_layers=2, d_model=128,
                  n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=128).validate()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = trial_model(CFG, dev)
    data = SyntheticLMDataset(DataConfig(global_batch=4, seq_len=32,
                                         vocab_size=cfg.vocab_size, noise=0.05))
    drawn = [data.batch_at(i) for i in range(8)]
    batches = {k: torch.stack([torch.from_numpy(b[k]) for b in drawn]).to(dev)
               for k in drawn[0]}
    module = TrainForward(cfg)

    def init_fn(seed, hypers):
        params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
        p = {n: t.detach() for n, t in params.named_parameters()}
        return {"p": p, "m": {n: torch.zeros_like(t) for n, t in p.items()},
                "i": torch.zeros((), dtype=torch.int32, device=dev)}

    def step_fn(state, hypers):
        batch = {k: x[state["i"] % 8] for k, x in batches.items()}
        grads, (_, metrics) = loss_and_grads(module, state["p"], batch)
        m = {n: 0.9 * state["m"][n] + g for n, g in grads.items()}
        p = {n: w - hypers["lr"] * m[n] for n, w in state["p"].items()}
        return {"p": p, "m": m, "i": state["i"] + 1}, {"loss": metrics["loss"]}

    spec = VectorTrainableSpec(init_fn, step_fn, ("lr",), steps_per_iter=2)
    executor = VmapExecutor(spec, CheckpointManager(ObjectStore()), n_lanes=8)
    runner = TrialRunner(
        ASHAScheduler(metric="loss", mode="min", max_t=10, grace_period=3,
                      reduction_factor=2),
        executor, stopping_criteria={"training_iteration": 10})
    for i, lr in enumerate(np.logspace(-3.5, -0.5, 8)):
        runner.add_trial(Trial({"lr": float(lr), "init_seed": i},
                               stopping_criteria={"training_iteration": 10}))
    trials = runner.run()
    print("lane-stacked ASHA sweep (8 trials, one vmapped step):")
    for t in trials:
        print(f"  {t.trial_id}: lr={t.config['lr']:.5f} iters={t.training_iteration:2d} "
              f"best={t.best_value('loss', 'min'):.4f} [{t.status.value}]")
    budget = sum(t.training_iteration for t in trials)
    print(f"budget spent: {budget}/{8*10} iterations "
          f"({100*budget/80:.0f}% — ASHA early-stopped the rest)")


if __name__ == "__main__":
    main()
