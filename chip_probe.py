#!/usr/bin/env python3
"""Two measurements on one NVIDIA GPU that ``chip_smoke.py`` leaves out of its
every pass, on the port's own paths and its helpers.

    python3 chip_probe.py                  # both
    python3 chip_probe.py --lane-memory    # or either one
    python3 chip_probe.py --k2-backward

--lane-memory: one lane of phase 3g's stacked step (smollm-135m at full
   width, B=8 S=512, seed 0's weights, the executor's ``step_fn``
   unvmapped, its gradients through ``launch.tune.loss_and_grads``) with
   the allocator's history recorded: the peak of the memory allocated over
   the step and the blocks live at that peak, grouped by what allocated
   them (the autograd node of a backward, else the innermost frames in
   ``src/repro_torch``, else the first ATen frame).  It is what keeps the
   executor from more lanes.
--k2-backward: K2's backward on rwkv6-1.6b's own inputs with its depth cut
   to K2_PROBE_LAYERS of 24, at full width, B=8 S=512: for each of
   K2_PROBE_SEEDS, the weights ``launch.train`` draws from that seed on the
   card and batch 0 of its token stream, the inputs and ``dy`` of the first
   and the last K2 backward of one ``forward_train`` (the last layer's and
   the first's) kept; on each, K2's backward twice, the plain chunked
   scan's autograd in fp32 on the card and on the CPU, and the plain
   sequential backward, each gradient against autograd of the recurrence
   in float64: max |g - g64| over max |g64|, and K2's over each witness's.
   Seed 0 gives phase 3c's inputs at that depth.  Prints; asserts nothing
   but that the runs are finite.

Every line that holds a number ends with the card's name and power limit.
Exits 2 without a card.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

# --lane-memory: the groups printed, and the allocator events recorded (a
# step makes ~15,000).
LANE_SPLIT_TOP, LANE_SPLIT_EVENTS = 14, 200_000
# --k2-backward: the model, its depth, the weights' seeds.
K2_PROBE_ARCH, K2_PROBE_LAYERS, K2_PROBE_SEEDS = "rwkv6-1.6b", 12, (0, 1, 2)


def allocated_by(frames) -> str:
    """What made a block, from the frames the allocator recorded: the
    autograd node of a backward (its C++ frame), else the innermost three
    frames in ``src/repro_torch``, else the first ATen frame."""
    node = next((f["name"] for f in frames if "autograd::generated::" in f["name"]), None)
    if node:
        node = node.split("autograd::generated::")[1].replace("details::", "")
        return "backward " + node.split("(")[0].split("::")[0]
    ours = [f for f in frames if "repro_torch" in f["filename"]]
    if ours:
        return " <- ".join(f"{Path(f['filename']).name}:{f['line']} {f['name']}" for f in ours[:3])
    aten = next((f["name"] for f in frames if f["name"].startswith("at::")), "not recorded")
    return aten[:80]


def peak_blocks(torch, fn, top: int = LANE_SPLIT_TOP) -> tuple:
    """``fn()`` with the allocator's history recorded: (the peak of the
    memory allocated over the trace, [(what made them, bytes)] of the
    blocks live at that peak, grouped by ``allocated_by``, largest
    first).  Naming the C++ frames starts ``addr2line`` processes that
    torch keeps; ``chip_smoke.stop_started_processes`` stops them."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=LANE_SPLIT_EVENTS, stacks="all")
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    groups = collections.Counter()
    for ev in at_peak.values():
        groups[allocated_by(ev.get("frames", []))] += ev["size"]
    return peak, groups.most_common(top)


def lane_memory(card: str, torch, dev) -> None:
    """--lane-memory (see the module's docstring)."""
    from repro_torch.launch import tune

    args = tune.parser().parse_args(cs.VMAP_SWEEP_ARGS)
    spec = tune.build_vmap_executor(tune.sweep_model(args), args).spec
    state = spec.init_fn(0, {})
    hypers = {"lr": torch.tensor(0.01, device=dev), "weight_decay": torch.tensor(0.1, device=dev)}
    spec.step_fn(state, hypers)   # warm: the kernels loaded, cuBLAS's workspace made
    gc.collect()
    torch.cuda.empty_cache()
    peak, groups = peak_blocks(torch, lambda: spec.step_fn(state, hypers))
    cs.log(f"[lane-memory] {cs.TRAIN_ARCH} one lane's step through loss_and_grads (B={args.batch} "
           f"S={args.seq_len}, step_fn unvmapped), allocator history recorded: "
           f"{peak / 2**20:.1f} MiB at its peak over the lane's state; the blocks live there by "
           f"what made them (MiB): " + "; ".join(f"{b / 2**20:.1f} {what}" for what, b in groups)
           + f" {card}")
    del state, spec
    gc.collect()
    torch.cuda.empty_cache()


def k2_backward(card: str, torch, dev) -> None:
    """--k2-backward (see the module's docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as k2
    from repro_torch.launch import train as launch_train
    from repro_torch.models import forward_train, init_params
    from repro_torch.models.rwkv6 import _wkv_chunked

    full = get_config(K2_PROBE_ARCH)
    cfg = launch_train.device_model(dataclasses.replace(full, n_layers=K2_PROBE_LAYERS), dev)
    batch = {k: torch.from_numpy(x).to(dev)
             for k, x in launch_train.batch_source(cfg, cs.B, cs.S)(0).items()}
    chunk, real = cfg.rwkv_chunk, k2.rwkv6_scan_bwd_cuda
    cpu = torch.device("cpu")

    def grads_of(fn, dtype, xs, dy, on=None):
        leaves = [x.detach().to(device=on or x.device, dtype=dtype).requires_grad_() for x in xs]
        y, _ = fn(*leaves)
        return [g.to(dev) for g in torch.autograd.grad(y, leaves, dy.to(y.device, y.dtype))]

    for seed in K2_PROBE_SEEDS:
        params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
        kept = []   # the first K2 backward's arguments (the last layer's) and the last one's

        def keep(*a, **kw):
            kept[min(len(kept), 1):] = [[x.detach().clone() if torch.is_tensor(x) else x
                                         for x in a]]
            return real(*a, **kw)

        with cs.patched(k2, "rwkv6_scan_bwd_cuda", keep):
            loss, grads = cs.first_step_grads(torch, forward_train, params, batch, cfg)
        del params, grads
        gc.collect()
        torch.cuda.empty_cache()
        tag = f"{K2_PROBE_ARCH} ({K2_PROBE_LAYERS} of {full.n_layers} layers) seed {seed}"
        for which, a in zip(("last layer", "first layer"), kept):
            r, k, v, logw, u, s0, states, dy = a[:8]
            xs = (r, k, v, logw, u, s0)
            g64 = grads_of(lambda *x: cs.wkv_f64(torch, *x), torch.float64, xs, dy)
            runs = {"kernel": real(*xs, states, dy, None, chunk=chunk),
                    "kernel again": real(*xs, states, dy, None, chunk=chunk),
                    "plain chunked": grads_of(lambda *x: _wkv_chunked(*x, chunk), torch.float32,
                                              xs, dy),
                    "plain chunked, CPU": grads_of(lambda *x: _wkv_chunked(*x, chunk),
                                                   torch.float32, xs, dy, on=cpu),
                    "plain sequential": ref.rwkv6_scan_bwd_ref(*xs, dy)}
            same = all(torch.equal(x, y) for x, y in zip(runs["kernel"], runs["kernel again"]))
            rel = {name: {n: float((x.double() - b).abs().max() / b.abs().max())
                          for n, x, b in zip(cs.RWKV_GRADS, gs, g64)} for name, gs in runs.items()}
            assert all(math.isfinite(e) for errs in rel.values() for e in errs.values()), rel
            del runs
            cs.log(f"[k2-backward] {tag}, loss {loss!r}, K2 backward of the {which}: max |g| "
                   f"{ {n: float(b.abs().max()) for n, b in zip(cs.RWKV_GRADS, g64)} }; max abs "
                   f"err vs float64 over max |g|: {rel}; the kernel's two runs bit for bit "
                   f"{same} {card}")
            for witness in ("plain chunked", "plain chunked, CPU", "plain sequential"):
                cs.log(f"[k2-backward] {tag} {which}, kernel / {witness}: "
                       + ", ".join(f"{n} {rel['kernel'][n] / rel[witness][n]:.4g}"
                                   for n in cs.RWKV_GRADS) + f" {card}")
            del g64
        del kept
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lane-memory", action="store_true")
    parser.add_argument("--k2-backward", action="store_true")
    opts = parser.parse_args()
    both = not (opts.lane_memory or opts.k2_backward)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    card, dev = f"[{smi}]", torch.device("cuda", 0)
    cs.log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:   # one nvcc per source, all at once
        list(pool.map(_build.build, cs.KERNELS))
    if both or opts.lane_memory:
        lane_memory(card, torch, dev)
    if both or opts.k2_backward:
        k2_backward(card, torch, dev)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        cs.stop_started_processes()
    sys.exit(code)
