"""Multi-pod dry-run: count every (arch x input-shape x mesh) combo, per rank.

Counterpart of ``repro.launch.dryrun``.  It proves that the distribution
config holds together without hardware: for each combo it builds the inputs
on the meta device, places state, batch and caches by the rule engine
(``dist/sharding.py``) on the production mesh (single-pod 16x16 and
multi-pod 2x16x16), runs the step once under ``launch.roofline.step_costs``
and derives the roofline terms of one rank from the count (``analyze``).

JAX lowers and compiles on 256 or 512 virtual host devices; the port has no
compiler, so a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``, one process, no
communication) stands under the ``DeviceMesh``, and the step runs on
DTensors whose local shards are meta tensors: what ``step_costs`` counts is
the work of rank 0.  The count runs the kernel-free config
(``roofline.kernel_free``), as JAX's walker counts nothing inside a Pallas
kernel.  Nothing is placed on any device.

What differs from the original's record (the keys are JAX's where they mean
the same):
  - ``status`` is ``"counted"`` where JAX's is ``"compiled"``;
  - ``t_count_s`` stands in place of ``t_compile_s``; ``t_lower_s`` times
    building and placing the state and the inputs;
  - ``compile_=False`` (``--no-compile``) builds and places them, counts
    nothing, and gives status ``"lowered"``;
  - the fake group's collectives are a CPU group's: DTensor falls back to
    an all-gather and a chunk where NCCL or XLA would run an all-to-all.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs import get_config, list_archs
from ..dist.sharding import (activation_policy, shard_batch, shard_caches, shard_params,
                             shard_train_state, sharding_strategy)
from ..models import ModelConfig, decode_step, forward_encode, init_params, prefill
from ..train import TrainState, adamw, linear_warmup_cosine, make_train_step
from .mesh import make_production_mesh
from .roofline import analyze, kernel_free, step_costs
from .shapes import SHAPES, ShapeSpec, dryrun_config, input_specs, skip_reason

__all__ = ["active_param_count", "lower_one", "fake_group", "main"]

MESHES = {"pod16x16": False, "pods2x16x16": True}     # name -> multi_pod


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` ranks in this one process, as rank 0,
    that communicates nothing; destroyed on exit."""
    # the one import of the fake group: a private module of torch's tests
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def active_param_count(cfg: ModelConfig) -> int:
    """Total params, counting only top_k/n_experts of routed expert weights."""
    params = init_params(None, cfg, "meta")
    total = sum(p.numel() for p in params.parameters())
    if cfg.moe is None:
        return total
    expert = sum(p.numel() for name, p in params.named_parameters()
                 if "experts" in name.split("."))
    frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - expert * (1.0 - frac))


def _step(cfg: ModelConfig, shape: ShapeSpec, mesh, specs: Dict[str, Any]):
    """The step of ``shape.kind`` and its arguments, placed on ``mesh``
    (``shape``'s kind built as JAX's ``lower_one`` builds it), and the
    tokens it processes."""
    if shape.kind == "train":
        opt = adamw(linear_warmup_cosine(3e-4, 100, 10_000),
                    moment_dtype=getattr(torch, cfg.opt_moment_dtype))
        params = init_params(None, cfg, "meta")
        state = TrainState(params, opt.init(dict(params.named_parameters())), 0)
        state = shard_train_state(state, mesh, cfg)
        batch = shard_batch(specs["batch"], mesh)
        step = make_train_step(cfg, opt, microbatch=cfg.train_microbatch)
        return step, (state, batch), shape.global_batch * shape.seq_len
    params = shard_params(init_params(None, cfg, "meta"), mesh, cfg)
    if shape.kind == "prefill":
        batch = shard_batch(specs["batch"], mesh)
        if cfg.encoder_only:
            fn = torch.no_grad()(lambda p, b: forward_encode(p, b, cfg))
        else:
            fn = lambda p, b: prefill(p, b, cfg, shape.seq_len)
        return fn, (params, batch), shape.global_batch * shape.seq_len
    caches = shard_caches(specs["caches"], mesh, shape.global_batch)
    tokens = shard_batch({"tokens": specs["tokens"]}, mesh)["tokens"]
    fn = lambda p, c, t, pos: decode_step(p, c, t, pos, cfg)
    return fn, (params, caches, tokens, specs["pos"]), shape.global_batch


def lower_one(
    arch: str, shape: ShapeSpec, mesh, mesh_name: str,
    verbose: bool = True, compile_: bool = True,
    strategy: str = "fsdp_tp", seq_parallel: bool = False,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    variant: str = "",
) -> Optional[Dict[str, Any]]:
    """Place and count one combo.  ``strategy``/``seq_parallel``/
    ``cfg_overrides`` parameterize §Perf variants; ``variant`` labels the
    record."""
    cfg = dryrun_config(get_config(arch))
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cfg = kernel_free(cfg)
    reason = skip_reason(cfg, shape)
    if reason is not None:
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape.name}: {reason}")
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    chips = mesh.size()
    specs = input_specs(cfg, shape)
    t0 = time.time()
    with sharding_strategy(strategy), activation_policy(mesh, seq_parallel=seq_parallel):
        fn, args, n_tokens = _step(cfg, shape, mesh, specs)
        t_lower = time.time() - t0
        record: Dict[str, Any] = {
            "arch": arch, "shape": shape.name, "mesh": mesh_name, "chips": int(chips),
            "status": "lowered", "t_lower_s": round(t_lower, 2),
            "variant": variant or "baseline",
        }
        if not compile_:
            if verbose:
                print(f"[dryrun] {arch} x {shape.name} x {mesh_name}: placed "
                      f"in {t_lower:.1f}s (count skipped)")
            return record
        t0 = time.time()
        costs = step_costs(fn, *args)
        t_count = time.time() - t0

    report = analyze(
        arch, shape.name, mesh_name, int(chips), costs,
        n_params_active=active_param_count(cfg), n_tokens=n_tokens, kind=shape.kind,
        arg_bytes=costs["arg_bytes"], temp_bytes=costs["temp_bytes"],
        output_bytes=costs["output_bytes"])
    record.update(status="counted", t_count_s=round(t_count, 2), **report.to_dict())

    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {mesh_name} "
              f"(place {t_lower:.1f}s, count {t_count:.1f}s)")
        print(f"  memory (rank 0): arg={report.arg_bytes} temp={report.temp_bytes} "
              f"output={report.output_bytes} bytes")
        print(f"  costs (rank 0): dot_flops={report.device_flops:.3e} "
              f"bytes={report.device_bytes:.3e} collectives={report.collectives_by_kind}")
        print(f"  roofline: compute={report.compute_s*1e3:.2f}ms "
              f"memory={report.memory_s*1e3:.2f}ms "
              f"collective={report.collective_s*1e3:.2f}ms "
              f"-> {report.dominant}-bound; "
              f"useful-flops={report.useful_flops_ratio:.2f} "
              f"hbm/dev={report.hbm_per_device_gib:.2f}GiB")
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all archs x shapes")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--no-compile", action="store_true",
                    help="place state and inputs only, count nothing")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.arch == "all" or args.all) else [args.arch]
    shapes = list(SHAPES.values()) if (args.shape == "all" or args.all) \
        else [SHAPES[args.shape]]
    mesh_names = {"single": ["pod16x16"], "multi": ["pods2x16x16"],
                  "both": ["pod16x16", "pods2x16x16"]}[args.mesh]

    records = []
    for mesh_name in mesh_names:
        multi = MESHES[mesh_name]
        with fake_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            for arch in archs:
                for shape in shapes:
                    try:
                        rec = lower_one(arch, shape, mesh, mesh_name,
                                        compile_=not args.no_compile)
                    except Exception as e:  # noqa: BLE001 — record and continue
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                               "status": "error", "error": f"{type(e).__name__}: {e}"}
                    if rec is not None:
                        records.append(rec)
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        path = os.path.join(args.out, f"dryrun_{args.mesh}.json")
                        with open(path, "w") as f:
                            json.dump(records, f, indent=1, default=str)

    n_ok = sum(1 for r in records if r["status"] == "counted")
    n_skip = sum(1 for r in records if r["status"] == "skipped")
    n_err = sum(1 for r in records if r["status"] == "error")
    print(f"\n[dryrun] {n_ok} counted, {n_skip} skipped (documented), {n_err} errors")
    if n_err:
        for r in records:
            if r["status"] == "error":
                print(f"  ERROR {r['arch']} x {r['shape']} x {r['mesh']}: {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
