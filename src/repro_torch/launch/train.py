"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq-len 512                    # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 20 --batch 8 --seq-len 128 --reduced --device cpu

Counterpart of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``; with no card it raises).  AdamW under a linear-warmup
cosine schedule, on the synthetic LM stream of ``data/pipeline.py`` (for a
config with a frontend, ``synthetic_batch``'s frames or image prefix and
text, seeded with the step, as JAX draws them).  On the
card (``device_model``) attention runs the CUDA flash-attention kernel,
forward and backward (``attn_impl="pallas"``, as ``launch/serve.py`` sets
it), and so do the RWKV-6 and RG-LRU scans of the ssm and hybrid families
and the MoE router of the moe family (``kernel_impl="pallas"``); on the CPU the plain versions run,
differentiated by autograd.  Weights are random, drawn on
the training device from seed 0, as JAX draws them from ``key(0)``.
``train`` is the function behind the command line; it also times each step
(to the device's end).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, list_archs
from ..data.pipeline import DataConfig, SyntheticLMDataset, synthetic_batch
from ..models import ModelConfig, param_count
from ..train import TrainState, adamw, linear_warmup_cosine, make_train_state, make_train_step


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    state: TrainState
    losses: List[float]            # every step's loss
    step_s: List[float]            # every step's time, the device's work included


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_model(cfg: ModelConfig, dev: torch.device) -> ModelConfig:
    """The config trained on ``dev``: on the card attention runs the CUDA
    kernel (``attn_impl="pallas"``), and the ssm, hybrid and moe families'
    scans and router theirs (``kernel_impl="pallas"``), forward and
    backward, each launched or raising.  Elsewhere the config is returned
    as it is."""
    if dev.type != "cuda":
        return cfg
    kernel_impl = "pallas" if cfg.family in ("ssm", "hybrid", "moe") else cfg.kernel_impl
    return dataclasses.replace(cfg, attn_impl="pallas", kernel_impl=kernel_impl)


def batch_source(cfg: ModelConfig, batch: int,
                 seq_len: int) -> Callable[[int], Dict[str, np.ndarray]]:
    """Step i's batch as JAX's ``launch.train`` draws it: the synthetic LM
    stream, or for a config with a frontend ``synthetic_batch`` seeded with
    i (``seq_len`` frames; for a VLM the image prefix and the text after it
    together)."""
    if cfg.frontend is None:
        data = SyntheticLMDataset(DataConfig(global_batch=batch, seq_len=seq_len,
                                             vocab_size=cfg.vocab_size))
        return data.batch_at
    return lambda i: synthetic_batch(cfg, batch, seq_len, seed=i)


def train(cfg: ModelConfig, steps: int, batch: int, seq_len: int, lr: float = 3e-4,
          warmup: int = 10, device="cuda", log_every: int = 10,
          out: Optional[str] = None) -> TrainResult:
    dev = resolve_device(device)
    cfg = device_model(cfg, dev)
    opt = adamw(linear_warmup_cosine(lr, warmup, steps))
    state = make_train_state(torch.Generator(device=dev).manual_seed(0), cfg, opt, dev)
    step = make_train_step(cfg, opt)
    print(f"[train] {cfg.arch_id}: {param_count(state.params):,} params on {dev}")
    batch_at = batch_source(cfg, batch, seq_len)
    losses, step_s = [], []
    t0 = time.time()
    with open(out, "w") if out else contextlib.nullcontext() as out_f:
        for i in range(steps):
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(i).items()}
            _sync(dev)
            s0 = time.perf_counter()
            state, metrics = step(state, b)
            _sync(dev)
            step_s.append(time.perf_counter() - s0)
            losses.append(float(metrics["loss"]))
            if i % log_every == 0 or i == steps - 1:
                row = {"step": i, "loss": losses[-1], "accuracy": float(metrics["accuracy"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "elapsed_s": round(time.time() - t0, 2)}
                print(f"[train] {json.dumps(row)}")
                if out_f:
                    out_f.write(json.dumps(row) + "\n")
    print(f"[train] done: final loss {losses[-1]:.4f} in {time.time() - t0:.1f}s")
    return TrainResult(cfg, state, losses, step_s)


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke-scale variant")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="JSONL metrics path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return train(cfg, args.steps, args.batch, args.seq_len, args.lr, args.warmup,
                 args.device, args.log_every, args.out)


if __name__ == "__main__":
    main()
