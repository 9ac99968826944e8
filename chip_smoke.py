#!/usr/bin/env python3
"""Run the PyTorch port's training and serving paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with its traceback and a
non-zero exit:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
   build the eight CUDA libraries from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, all started together) and print ptxas' reports; K1's
   tiles, shared memory and blocks an SM for each (dtype, head_dim), and the
   HMMA (tensor-core) instructions in each of its kernels' SASS; the same
   for K1's two backward kernels, with their registers and spills; K4's
   SASS and its backward's registers and spills.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and edge cases (ragged lengths, initial states, a
   sequence run in two halves, a sequence whose chunks are all K2's
   parallelism, tied router rows, bf16), with stated tolerances; K1's
   backward against its plain version at the forward's cases, fp32 and
   bf16, two runs of it bit for bit, and ``FlashAttentionFn`` against
   autograd of the plain forward; the same for K2's and K3's backwards at
   the training shapes and edge cases (a ragged last chunk, an initial
   state, a final-state gradient), with ``RWKV6ScanFn`` and ``RGLRUScanFn``;
   and K4's backward at K4's cases, on the kernel forward's outputs, with
   ``MoERouterFn`` against autograd of the plain router.
   Then K4's times: at granite-moe's prefill and decode shapes and
   deepseek-moe's, its device time a launch, the wrapper's time a call
   paced by the host, the bound, and beside them the card's launch floor
   (a one-element fill kernel's device time, a one-element in-place op's
   time a call); the same for K4's backward at granite-moe's and
   deepseek-moe's training shapes, beside its plain version's; K2's and its
   backward's kernels: registers, shared memory, blocks an SM and device
   ms.
3. train: ``repro_torch.launch.train`` at full width on smollm-135m (fp32,
   batch 8, sequence 512, 4 steps), every launch count set to 0 just before
   and read just after (30 K1 forwards and 30 K1 backwards a step); the
   plain path (``attn_impl="naive"``) on the same weights and batches: the
   first step's gradient of every parameter and the four losses within
   stated limits; the steady step time, tokens/s, peak device memory and a
   trace of one warm step.
3b. sweep: the paper's workload, ``repro_torch.launch.tune`` in-process on
   smollm-135m at full width (fp32, batch 8, sequence 512): ASHA (max_t 4,
   grace 1, reduction 3) over 4 samples of the launcher's space, seed 0, 2
   steps an iteration, on the serial executor with 4 trials resident (8
   virtual devices, 2 a trial), traced, with a log directory (each
   iteration's checkpoint spills and is mirrored to disk under a temp
   directory).  Every launch count set to 0 just
   before and read just after: K1's forward and backward each 30 times the
   steps run.  Every trial must end TERMINATED, and the device memory in
   use must come back within 64 MiB.  Printed: trials finished, wall time,
   trials/hour, each trial's iterations and first and steady step, the
   trace's spans and the control plane's share of the wall time (1 - trial
   steps / wall), peak memory.  Then the first trial's config alone on the
   process executor (FIFO, 2 iterations), in a worker forked from the port's
   own forkserver: its losses within the train phase's loss limit of the
   serial trial's, its first step (a fresh CUDA context) printed.
3e. cluster: the same sweep through ``launch.tune`` with ``--executor
   cluster --hosts 2x4 --placement fixed``: two simulated hosts of 4
   virtual devices, each trial a socket worker forked from the port's
   forkserver, all four on the card at once, dialing the controller back
   over loopback TCP; checkpoints content-addressed through each host's
   spill directory and fetched to the controller.  The workers report their
   launches with each result: K1's forward and backward each 30 times the
   steps run.  Every trial must end TERMINATED with its loss at every
   iteration within the train phase's loss limit of an uninterrupted serial
   run of its config (which must itself equal 3b's trials), no worker may
   outlive the sweep, and the card's free memory must come back within 64
   MiB.  Printed: wall time and trials/hour beside 3b's, each trial's host
   and first and steady step, the trace's spans, the control plane's share,
   the fetch histogram and every fetch's seconds, the card's peak memory in
   use over all processes.  Then 3b's first config alone (FIFO, 4
   iterations, ``--max-failures 1``) on two hosts of 2 devices, its worker
   SIGKILLed as the controller adopts its second checkpoint: it must end
   TERMINATED with one failure, restarted from iteration 2, its later
   losses within the same limit; the restart's wall time is printed, from
   the kill to the end of the first step after it, split into the killed
   process's exit, the requeue, the controller's export copy, the fetch to
   the host, the new worker's fork and dial-in, its trainable and fresh CUDA
   context, the restore and the first step.
3c. train the ssm and hybrid families through ``repro_torch.launch.train``
   at full width, fp32, batch 8, sequence 512, 3 steps each: rwkv6-1.6b at
   full depth (24 K2 forwards and backwards a step), then recurrentgemma-9b
   cut to 3 of its 38 layers (2 K3 and 1 K1 backwards a step, and twice as
   many forwards under its remat), each with every launch count set to 0
   just before and read just after; the steady step time, tokens/s, peak
   memory and a trace of one warm step; the plain path (``attn_impl=
   "naive"``, ``kernel_impl="jnp"``, remat) on the same weights and
   batches: the first step's gradients and the losses within stated
   limits.  On rwkv6, both paths' first-step gradients against the plain
   path in float64, and K2's gradients on the model's own inputs against
   float64, within 2x the plain chunked scan's distance.
3d. train the moe family the same way: granite-moe-3b-a800m at full width
   with remat, its depth cut to 26 of 32 layers (26 K1 and 26 K4
   backwards a step, twice as many forwards), every launch count set to 0
   just before and read just after, its routing recorded; the steady step
   time, tokens/s, peak memory and a trace of one warm step; the plain
   path on the same weights and batches,
   its routing teacher-forced to the kernel path's (each flip a near-tie):
   the first step's gradients and the losses within stated limits.
4. serve: ``repro_torch.launch.serve`` at full width (batch 8, prompt 512,
   32 new tokens, greedy) on smollm-135m, rwkv6-1.6b, recurrentgemma-9b and
   granite-moe-3b-a800m, one model resident at a time.  Every launch count
   is set to 0 just before each path and read just after; then the same
   tokens are teacher-forced through the plain path (``attn_impl="naive"``,
   ``kernel_impl="jnp"``) and the prefill logits, every layer's cache or
   recurrent state and every decode step's logits must agree within a
   stated share of their scale (``SERVE_TOL``).  On rwkv6-1.6b, K2 and the
   plain scans are also held against float64 on the model's own inputs,
   and the model's sensitivity to one ulp of rounding is measured.  On
   granite-moe the plain path's routing is teacher-forced too, to the
   kernel path's experts; each routing decision in which the two paths
   differ is counted and must be a near-tie on the plain path.
5. times: each path's prefill and decode times and a ``torch.profiler``
   trace of one warm prefill and 8 warm decode steps (wall time, the
   device's busy and idle share, the kernels that took the most device
   time and the MoE dispatch's scans; this repo's kernel launches the
   trace kept against those made, with busy time and idle share marked as
   bounds where records were dropped); then each kernel, its plain
   version and, where one exists, the PyTorch library call (CUDA events),
   each printed with the card.  K1 is
   timed at the smollm, granite-moe and recurrentgemma shapes, in fp32 and
   bf16, beside ``scaled_dot_product_attention`` (and the CUDA kernel it
   launched, by its profiler name) and both of its bounds.  K2 is timed
   in fp32 and bf16 beside its bound and its two-kernel design's floor,
   and each of its two kernels is reported: registers and spills, shared
   memory, blocks an SM and device time.  K1's backward is timed at K1's
   three shapes in fp32 and bf16, beside its plain version, the backward
   of ``scaled_dot_product_attention`` and both of its bounds.  K2's and
   K3's backwards are timed at the training shapes beside their plain
   versions and bounds.

The script leaves no process behind, whether it passes or fails.  It makes
itself the reaper of its orphaned descendants, and before the last two lines
(or after a failure) stops, and waits for, every trial worker, the port's
forkserver, ``multiprocessing``'s resource tracker and anything else still
below it; the run fails if a process outlives that.

Every ``torch.profiler`` session keeps 50 ms of idle at each end, and one
that comes back with no kernel record, or with fewer records of this repo's
kernels than the launches made under it, is profiled again (``profiled``),
up to three times in all; its reading is never used.  The line before the
``kernels`` record counts the sessions and the retries.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet, dense, at the full 700 W: CUDA-core fp32, tensor-core
# TF32 and bf16, and HBM rates.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
KERNELS = ("flash_attention", "flash_attention_bwd", "rwkv6_scan", "rwkv6_scan_bwd",
           "rglru_scan", "rglru_scan_bwd", "moe_router", "moe_router_bwd")
# CUDA kernels a wrapper call launches and what their names hold: K1's
# backward runs its dq kernel, then its dkdv kernel; K2 its chunk-states
# kernel, then its outputs kernel; K2's backward its reverse chunk-states
# kernel, its grads kernel and its du kernel.
KERNELS_PER_CALL = {"flash_attention": 1, "flash_attention_bwd": 2, "rwkv6_scan": 2,
                    "rwkv6_scan_bwd": 3, "rglru_scan": 1, "rglru_scan_bwd": 1, "moe_router": 1,
                    "moe_router_bwd": 1}
KERNEL_PREFIX = {"flash_attention": ("flash_attention_fwd_",),
                 "flash_attention_bwd": ("flash_attention_bwd_",),
                 "rwkv6_scan": ("rwkv6_scan_states_kernel", "rwkv6_scan_outputs_kernel"),
                 "rwkv6_scan_bwd": ("rwkv6_scan_bwd_",),
                 "rglru_scan": ("rglru_scan_kernel",), "rglru_scan_bwd": ("rglru_scan_bwd_kernel",),
                 "moe_router": ("moe_router_kernel",),
                 "moe_router_bwd": ("moe_router_bwd_kernel",)}


def ours(name: str, key: str) -> bool:
    """Whether the profiler's kernel ``key`` is one of ``name``'s kernels."""
    return any(p in key for p in KERNEL_PREFIX[name])
# torch.profiler: idle kept inside every session before the first launch and
# after the last synchronise (on an H100, with none about 1 session in 100
# came back with no kernel record or with some dropped; with 50 ms at each
# end none of 1,524 did), and the attempts a session gets before the run
# fails.
PROFILER_PAD_S, PROFILER_ATTEMPTS = 0.05, 3
# Kernel against plain version: the tolerances of tests/test_kernels.py.
# With bf16 outputs each side rounds y once, so a value may also land one
# bf16 ulp (2**-8 relative) away: rtol 2**-7 allows that for |y| above 6.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RWKV_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
BF16_RTOL = 2.0 ** -7
RGLRU_ATOL = 1e-5
ROUTER_ATOL = 1e-5
B, S, NEW = 8, 512, 32
# Serve check, kernel path vs plain path: for the logits and each cache or
# state leaf, max |plain - kernel| over max(1, max |kernel|), a normwise
# error: rounding that a deep stack amplifies grows with a tensor's scale,
# not with each element's.  Each limit is about 10x the largest reading on
# an H100:
# smollm-135m: 30 layers of fp32 sums taken in another order (blocked online
# softmax vs one einsum and softmax); at most 2.1e-6 (logits, caches): 2e-5.
# recurrentgemma-9b: at most 7.8e-6 (the local-attention k cache): 1e-4.
# rwkv6-1.6b: its 24 random layers amplify rounding about a thousandfold:
# one fp32 ulp of noise on every K2 output moves the logits by 1.5e-3 to
# 4.1e-3 (``wkv_precision``, over noise draws and weight draws), as far as
# kernel and plain path differ; at most 1.46e-3 (the WKV state), while
# ``wkv_precision`` holds K2 within 2x of the plain chunked scan's distance
# from float64: 1.5e-2.
# granite-moe-3b-a800m, with the plain path's routing teacher-forced to the
# kernel path's experts: its random 32 layers (experts drawn with std
# 1/sqrt(40), as JAX draws them) carry activations far above 1; at most
# 2.56e-5 (the v cache): 2.5e-4.
SERVE_TOL = {"smollm-135m": 2e-5, "rwkv6-1.6b": 1.5e-2, "recurrentgemma-9b": 1e-4,
             "granite-moe-3b-a800m": 2.5e-4}
ARCHS = tuple(SERVE_TOL)
# A routing decision in which the kernel path picks another expert than the
# plain path must be a near-tie: the two experts' plain probabilities at
# most this far apart (the paths' inputs differ by rounding).  On an H100,
# 41 of 385,024 decisions differed, with gaps up to 1.18e-6: 1e-5.
FLIP_GAP = 1e-5
TRACE_DECODE_STEPS, TRACE_TOP = 8, 10
# PyTorch kernels a trace also prints when they are not in its top: the
# scans of the MoE dispatch's slot positions (``models/moe.py``).
TRACE_ALSO = ("tensor_kernel_scan",)
# wkv_precision: K2 within this factor of the plain chunked scan's distance
# from float64; the noise draws of its one-ulp experiment.
K2_PRECISION_FACTOR, NOISE_SEEDS = 2.0, (3, 4, 5, 6)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 5, iters: int = 50) -> float:
    """Mean time of one call on the card, from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace_summary(records, wall_us: float, calls: dict) -> dict:
    """What one trace says, from its kernel records (name, launches kept,
    device us) and the wrapper calls made under it ({kernel: calls}): the
    device's busy time (the kept records summed: one stream, so they do not
    overlap) and idle share, and for each kernel of this repo the launches
    kept against those made (``KERNELS_PER_CALL`` a call).  Where the
    profiler dropped some of this repo's records it may have dropped others
    too, so busy time is then a lower bound and the idle share an upper
    bound (``dropped``); ``profiled`` profiles such a session again."""
    busy_us = sum(us for _, _, us in records)
    kept = {n: sum(c for key, c, _ in records if ours(n, key)) for n in calls}
    expected = {n: calls[n] * KERNELS_PER_CALL[n] for n in calls}
    return {"busy_us": busy_us, "idle_share": 1 - busy_us / wall_us, "kept": kept,
            "expected": expected, "dropped": any(kept[n] < expected[n] for n in calls)}


def trace_head(name: str, wall_us: float, records, calls: dict, card: str) -> str:
    """The first ``[trace]`` line of a trace (``trace_summary``); busy time
    and idle share are marked as bounds where records were dropped."""
    t = trace_summary(records, wall_us, calls)
    ours = {n: f"{t['kept'][n]} of {t['expected'][n]}" for n in calls if t["expected"][n]}
    busy, idle = f"{t['busy_us'] / 1e3!r} ms", f"{t['idle_share']!r}"
    if t["dropped"]:
        busy, idle = f"at least {busy}", f"at most {idle}"
    dropped = "; the profiler dropped records" if t["dropped"] else ""
    return (f"[trace] {name}: wall {wall_us / 1e3!r} ms, device busy {busy}, idle share {idle}, "
            f"{sum(c for _, c, _ in records)} kernel launches kept; this repo's kernels, launches "
            f"kept of made: {ours}{dropped} {card}")


# Sessions of torch.profiler opened in this run, and those profiled again.
PROFILER = {"sessions": 0, "retried": 0, "unmeasured": 0}


def profiled(name: str, attempt):
    """One profiler measurement, held to the rule of every session.
    ``attempt()`` profiles it once and returns (records, wall_us, calls):
    the kernel records (name, launches kept, device us), the wall time and
    this repo's wrapper calls made under it ({kernel: calls}).  A session
    with no kernel record is empty; one that kept fewer records of a kernel
    of this repo than the launches made under it is partial.  Either is
    profiled again, up to ``PROFILER_ATTEMPTS`` in all, with a
    ``[profiler]`` line naming the measurement; its reading is never used.
    Fails when every attempt came back empty; returns None, so that the
    measurement is reported as not measured, when none came back whole.
    Correctness checks never come here: only measurements are repeated."""
    empty = 0
    for i in range(PROFILER_ATTEMPTS):
        PROFILER["sessions"] += 1
        records, wall_us, calls = attempt()
        t = trace_summary(records, wall_us, calls)
        if records and not t["dropped"]:
            return records, wall_us, calls
        empty += not records
        what = "empty" if not records else "partial (this repo's launches kept of made: " + \
            ", ".join(f"{n} {t['kept'][n]} of {t['expected'][n]}" for n in calls
                      if t["kept"][n] < t["expected"][n]) + ")"
        if i + 1 < PROFILER_ATTEMPTS:
            PROFILER["retried"] += 1
            log(f"[profiler] {name}: session {i + 1} of {PROFILER_ATTEMPTS} came back {what}; "
                "profiling it again")
    assert empty < PROFILER_ATTEMPTS, f"{name}: {PROFILER_ATTEMPTS} profiler sessions came back empty"
    PROFILER["unmeasured"] += 1
    log(f"[profiler] {name}: no session of {PROFILER_ATTEMPTS} came back whole (the last "
        f"{what}); not measured")
    return None


def _profile_once(torch, fn, cpu: bool):
    """(torch.profiler's key averages, wall us, this repo's wrapper calls)
    of one call of ``fn``, with ``PROFILER_PAD_S`` of idle inside the
    session at each end, outside the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    before = {n: getattr(ops, n).launches for n in KERNELS}
    with profile(activities=acts) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILER_PAD_S)
    return prof.key_averages(), wall_us, {n: getattr(ops, n).launches - before[n]
                                          for n in KERNELS}


def _kernel_events(events) -> list:
    """The device-side events with device time (a CPU op's device time
    repeats its kernels')."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def trace(name: str, fn, card: str, ops) -> None:
    """Run ``fn`` once under ``torch.profiler`` (``profiled``); print wall
    time, the device's busy time and idle share, and the kernels with the
    most device time.  The launches of this repo's kernels that the trace
    kept are held against the ``ops.<name>.launches`` made during it
    (``trace_head``)."""
    import torch
    events = {}

    def attempt():
        evs, wall_us, calls = _profile_once(torch, fn, cpu=True)
        events["kernels"] = _kernel_events(evs)
        return ([(e.key, e.count, e.self_device_time_total) for e in events["kernels"]],
                wall_us, calls)

    got = profiled(f"trace {name}", attempt)
    if got is None:
        return
    records, wall_us, calls = got
    kernels = events["kernels"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(trace_head(name, wall_us, records, calls, card))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TRACE_TOP]
    repo = [e for e in kernels if e not in top and (any(ours(n, e.key) for n in KERNELS)
                                                    or any(n in e.key for n in TRACE_ALSO))]
    for e in top + repo:   # the top kernels, then this repo's kernels and TRACE_ALSO below them
        log(f"[trace]   {e.self_device_time_total / 1e3:10.4f} ms  {e.count:5d}x  "
            f"{e.self_device_time_total / busy_us:6.1%}  {e.key[:90]}")


def device_ms(torch, name: str, fn, match: str = "", iters: int = 50):
    """Mean device time per call of ``fn`` (``torch.profiler``): the time of
    the kernels whose name contains ``match`` (every kernel for ""), over
    ``iters`` calls after a warm-up; None if not measured (``profiled``).
    Unlike ``time_ms`` it leaves out the host's time between launches,
    which paces a call whose kernels take a few microseconds."""
    found = device_kernels(torch, name, fn, iters)
    if found is None:
        return None
    ms = per_call_ms(found, iters, match)
    assert ms > 0, f"{name}: no device time for {match!r}"
    return ms


def device_kernels(torch, name: str, fn, calls: int = 10) -> list:
    """(name, launches kept, total device ms) of each CUDA kernel that
    ``calls`` warm calls of ``fn`` launch, from one whole ``torch.profiler``
    session (``profiled``; ``name`` names the measurement); None if no
    session came back whole."""
    for _ in range(5):
        fn()

    def attempt():
        evs, wall_us, calls_made = _profile_once(
            torch, lambda: [fn() for _ in range(calls)], cpu=False)
        return ([(e.key, e.count, e.self_device_time_total) for e in _kernel_events(evs)],
                wall_us, calls_made)

    got = profiled(name, attempt)
    return None if got is None else [(key, n, us / 1e3) for key, n, us in got[0]]


def per_call_ms(kernels, calls: int, match: str = "") -> float:
    """Device ms a call from ``device_kernels``' records of ``calls`` calls:
    each kernel's mean over the launches the profiler kept, times its
    launches a call (ceil(kept / calls)).  ``profiled`` repeats a session
    that dropped records of this repo's kernels; for other kernels (a
    library call, a plain version) a dropped record is not seen, and a
    total divided by the calls would read low."""
    return sum(ms / n * math.ceil(n / calls) for name, n, ms in kernels if match in name)


def attention_inputs(torch, dev, seed, B, Sq, Sk, H, K, hd, dtype, q0=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    q0 = Sk - Sq if q0 is None else q0
    qp = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    return q, k, v, qp, kp


def allowed_pairs(qp, kp, causal=True, window=None) -> int:
    """The (query, key) pairs the mask allows, counted from the positions."""
    d = qp[:, :, None] - kp[:, None, :]
    ok = kp[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return int(ok.sum())


def attention_bound(q, k, v, qp, kp, causal=True, window=None):
    """Least time for the function on this card: operations (4*hd per allowed
    (query, key) pair, counted from these positions) over the fp32 CUDA-core
    peak, or bytes (each input read once, the output written once) over HBM.
    Then the bound of K1's tensor-core scheme: fp32 runs each product as
    three TF32 products (3 x operations over the TF32 peak); bf16 runs
    Q K^T once and P V twice (P as bf16 hi + lo), 1.5 x operations over the
    bf16 peak; or bytes, whichever is larger.  Returns (ms, bound_by, flops,
    bytes, tensor-core ms, its bound_by)."""
    import torch
    H, hd = q.shape[2], q.shape[3]
    flops = 4.0 * hd * H * allowed_pairs(qp, kp, causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, qp, kp)) \
        + q.numel() * q.element_size()
    if q.dtype == torch.bfloat16:
        t_ops = 1.5 * flops / PEAK_BF16_FLOPS
    else:
        t_ops = 3.0 * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return _bound(flops, nbytes) + (max(t_ops, t_bytes) * 1e3,
                                    "operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_bound(q, k, v, qp, kp, causal=True, window=None):
    """Least time for K1's backward on this card: operations (10*hd per
    allowed (query, key) pair: q.k and dO.v again, dS^T Q, P^T dO and dS K)
    over the fp32 CUDA-core peak, or bytes (q, k, v, the forward's output,
    dO, its LSE and the positions read once, dq, dk, dv written once) over
    HBM.  Then the bound on the tensor cores: fp32 as 3xTF32 (3 x operations
    over the TF32 peak), bf16 as one bf16 product each (operations over the
    bf16 peak), or bytes.  Returns (ms, bound_by, flops, bytes, tensor-core
    ms, its bound_by)."""
    import torch
    B, Sq, H, hd = q.shape
    flops = 10.0 * hd * H * allowed_pairs(qp, kp, causal, window)
    nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * q.element_size() \
        + B * H * Sq * 4 + _nbytes(qp, kp)
    tc = 3.0 * flops / PEAK_TF32_FLOPS if q.dtype == torch.float32 else flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return _bound(flops, nbytes) + (max(tc, t_bytes) * 1e3,
                                    "operations" if tc >= t_bytes else "bytes")


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rwkv6_bound(r, k, v, logw, u, state, chunk=32):
    """Least time for the chunked WKV on this card.  Operations, per (b, h)
    and chunk of n rows (a multiply, add or exponential is one, all fp32):
    running sums 2nN; A below the diagonal 5N per pair (difference,
    exponential, two products, sum), on it 3N per row; r and k rescaled 5nN;
    A @ V 2N per entry of A at or below the diagonal; (r e^c) @ S 2nN^2 and
    its sum with A @ V nN; the state update 2nN^2 + 2N^2 + N.  Bytes: each
    input read once, y and the final state written once."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    ops = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n - 1) // 2
        ops += (2 * n * N + 5 * N * pairs + 3 * N * n + 5 * n * N + 2 * N * (pairs + n)
                + 2 * n * N * N + n * N + 2 * n * N * N + 2 * N * N + N)
    return _bound(B * H * ops, _nbytes(r, k, v, logw, u, state, r, state))


def rwkv6_design_floor(r, k, v, logw, u, state, chunk=32):
    """Least time of K2's two-kernel design on this card: the bytes it must
    move over HBM.  The states kernel reads k, v, logw and the initial state
    and writes the state entering each chunk after the first (the
    workspace) and the final state; the outputs kernel reads r, k, v, logw,
    u, the initial state (for chunk 0) and the workspace, and writes y.
    Returns (ms, bytes)."""
    B, S, H, N = r.shape
    ws = B * H * (-(-S // min(chunk, S)) - 1) * N * N * 4
    nbytes = (_nbytes(k, v, logw, state) + ws + _nbytes(state)
              + _nbytes(r, k, v, logw, u, state) + ws + _nbytes(r))
    return nbytes / PEAK_HBM_BYTES * 1e3, nbytes


def rwkv6_bwd_design_floor(r, k, v, logw, u, state, dy, ds_out=None, chunk=32):
    """Least time of K2's backward as its three passes are designed, on this
    card: the bytes they must move over HBM, workspaces included.  The
    states kernel reads r, logw, dy (and ds_out) and writes dS' of every
    chunk (the workspace dws, (B, H, nc, N, N) fp32) and dstate; the grads
    kernel reads r, k, v, dy, logw, u, the initial state, the forward's
    workspace (the state entering chunks 1 .. nc-1) and dws, and writes dr,
    dk, dv, dlogw and a partial of du a (b, chunk) (B, nc, H, N fp32); the
    du kernel reads the partials and writes du.  Returns (ms, bytes)."""
    B, S, H, N = r.shape
    nc = -(-S // min(chunk, S))
    ws, dws, du_part = (B * H * (nc - 1) * N * N * 4, B * H * nc * N * N * 4,
                        B * nc * H * N * 4)
    nbytes = (_nbytes(r, logw, dy, ds_out) + dws + _nbytes(state)
              + _nbytes(r, k, v, dy, logw, u, state) + ws + dws + _nbytes(r, k, v, logw) + du_part
              + du_part + _nbytes(u))
    return nbytes / PEAK_HBM_BYTES * 1e3, nbytes


def rglru_bound(a, b, h0=None):
    """Least time for h_t = a_t h_{t-1} + b_t: 2 flops per element; a and b
    (and h0) read once, h written once."""
    return _bound(2 * a.numel(), _nbytes(a, b, h0, a))


def rwkv6_bwd_bound(r, k, v, logw, u, state, dy, ds_out=None, chunk=32):
    """Least time for the WKV scan's backward on this card.  Operations, per
    (b, h) and chunk of n rows with P = n(n-1)/2 pairs below the diagonal
    (a multiply, add or exponential is one, all fp32), each needed once:
    running sums 2nN; k e^{cL-c} 3nN and r e^{ce} 2nN; for each pair and
    channel one difference and one exponential e^{ce_t-c_s}, shared by A,
    dr and dk, and two products and a sum for each of the three: 11N a
    pair; A on the diagonal 3N a row; dA 2N an entry at or below it; S dy
    and dS' v 2nN^2 each, their factors 2nN and 3nN; A^T dy 2N an entry and
    (k e^{cL-c}) dS' 2nN^2; dr, dk and dv summed 9nN; rho, kappa and the
    partials of sigma and du 9nN; sigma's S (.) dS' 2N^2 + 2N; dlogw's
    running sum 2nN; the state's gradient 2nN^2 + 2N^2 + N.  Bytes: each
    input (dy and ds_out among them) read once, each gradient written once.
    Then the bound with the four N^2 products (S dy, dS' v, (k e^{cL-c})
    dS' and the state's gradient) on the tensor cores as 3xTF32 (3 x their
    operations over the TF32 peak) and the rest on the CUDA cores: the
    larger of the two units' times, or bytes.  Returns (ms, bound_by,
    flops, bytes, tensor-core ms, its bound_by)."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    ops = mm = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        P = n * (n - 1) // 2
        mm += 4 * 2 * n * N * N
        ops += (2 * n * N + 3 * n * N + 2 * n * N + 11 * N * P + 3 * N * n + 2 * N * (P + n)
                + 2 * n * N + 3 * n * N + 2 * N * (P + n) + 9 * n * N + 9 * n * N
                + 2 * N * N + 2 * N + 2 * n * N + 2 * N * N + N)
    nbytes = _nbytes(r, k, v, logw, u, state, dy, ds_out) + _nbytes(r, k, v, logw, u, state)
    tc = max(B * H * ops / PEAK_FP32_FLOPS, 3.0 * B * H * mm / PEAK_TF32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return _bound(B * H * (ops + mm), nbytes) + (max(tc, t_bytes) * 1e3,
                                                 "operations" if tc >= t_bytes else "bytes")


def rglru_bwd_bound(a, h0, h, dh):
    """Least time for the RG-LRU scan's backward: 3 flops an element (g =
    dh + a g, da = g h) and 2 for each lane's dh0; a, h, dh (and h0) read
    once, da and db (and dh0) written once."""
    return _bound(3 * a.numel() + (2 * h0.numel() if h0 is not None else 0),
                  _nbytes(a, h, dh, h0) + 2 * _nbytes(a) + _nbytes(h0))


def moe_router_bound(logits, top_k):
    """Least time for softmax -> top-k -> renormalise.  Operations per row:
    max, subtract, exponential, sum and divide over the E logits, k rounds
    of E compares, the k-term sum and k divides.  Bytes: the logits read
    once, the fp32 weights and int32 indices written once."""
    T, E = logits.shape
    return _bound(T * ((5 + top_k) * E + 2 * top_k), _nbytes(logits) + T * top_k * 8)


def moe_router_bwd_bound(logits, top_k):
    """Least time for the router's backward.  Operations per row: the
    softmax again (max, subtract, exponential, sum and divide over E), p *
    dp and its sum over E, each logit's difference and product (9E); over
    the k selected, Z's sum, dw * w and its sum, dp's difference and
    quotient (5k).  Bytes: the logits, the fp32 weights, the int32 indices
    and the fp32 weight gradients read once, dlogits (the logits' dtype)
    written once."""
    T, E = logits.shape
    return _bound(T * (9 * E + 5 * top_k), 2 * _nbytes(logits) + T * top_k * 12)


# logw = -exp(N(0, 0.5) + shift): TestRWKV6Scan's draw, about 0.14 an
# e-fold a step; STRONG_DECAY about 3.1, so e^{ce_t - c_s} spans tens of
# e-folds within a chunk (about 100 over 32 rows).
USUAL_DECAY, STRONG_DECAY = -2.0, 1.0


def rwkv_inputs(torch, dev, seed, B, S, H, N, dtype, decay=USUAL_DECAY):
    """The draws of TestRWKV6Scan, on the card: r/k/v in ``dtype``; logw, u
    and the initial state in fp32; ``decay`` shifts log(-logw)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda shape, scale: torch.randn(shape, generator=g, device=dev) * scale
    r, k, v = (n((B, S, H, N), 0.5).to(dtype) for _ in range(3))
    logw = -torch.exp(n((B, S, H, N), 0.5) + decay)
    return r, k, v, logw, n((H, N), 0.3), n((B, H, N, N), 0.2)


def rglru_inputs(torch, dev, seed, B, S, R):
    """The draws of TestRGLRUScan, on the card: a in (0, 1), b, h0; fp32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda shape: torch.randn(shape, generator=g, device=dev)
    return torch.sigmoid(n((B, S, R))), n((B, S, R)) * 0.3, n((B, R)) * 0.2


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def sass_instructions(nvcc: str, lib: Path) -> dict:
    """Each kernel's instructions in ``lib``'s SASS (``cuobjdump -sass``),
    keyed by its mangled name (``parse_sass``)."""
    return parse_sass(subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
                                     capture_output=True, text=True, timeout=120,
                                     check=True).stdout)


def parse_sass(sass: str) -> dict:
    """{kernel: [(address, opcode with its modifiers, branch target or None)]}
    from a ``cuobjdump -sass`` listing."""
    import re
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*)", line)
        if fn and m:
            tgt = re.match(r"0x([0-9a-f]+)", m.group(3).strip()) if m.group(2) == "BRA" else None
            out[fn].append((int(m.group(1), 16), m.group(2),
                            int(tgt.group(1), 16) if tgt else None))
    return out


def sass_loops(ins) -> tuple:
    """One kernel's instructions (``parse_sass``) counted as (instructions,
    MUFU.EX2, LDS): all of them, then each loop (a branch back to an earlier
    address closes one)."""
    def count(xs):
        return (len(xs), sum(op == "MUFU.EX2" for _, op, _ in xs),
                sum(op.startswith("LDS") for _, op, _ in xs))
    return count(ins), [count([x for x in ins if tgt <= x[0] <= at])
                        for at, op, tgt in ins if op == "BRA" and tgt is not None and tgt < at]


def report_k1_build(torch, fa, nvcc: str, lib: Path, card: str) -> None:
    """K1's keys per tile, shared memory and blocks an SM for each (dtype,
    head_dim), as the card reports them; then the instructions in each of
    its kernels' SASS (``cuobjdump -sass``), HMMA (tensor core) and LDSM
    (ldmatrix) counted apart."""
    import re
    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            log(f"[build] flash_attention {str(dtype)[6:]} hd {hd}: "
                f"{fa.tile_config(dtype, hd)} {card}")
    counts = {}
    for fn, ins in sass_instructions(nvcc, lib).items():
        m = re.search(r"fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", fn)
        if m:
            ops = [op.split(".")[0] for _, op, _ in ins]
            counts["float32" if m.group(1) == "f" else "bfloat16", int(m.group(2))] = {
                "instructions": len(ops), "HMMA": ops.count("HMMA"), "LDSM": ops.count("LDSM")}
    for (dtype, hd), c in sorted(counts.items()):
        log(f"[build] flash_attention {dtype} hd {hd} SASS: {c}")
    assert counts and all(c["HMMA"] > 0 for c in counts.values()), "K1 runs no HMMA"


def report_k1_bwd_build(torch, fa, nvcc: str, lib: Path, build_log: str, card: str) -> None:
    """K1's backward: for each (dtype, head_dim) its tiles, each kernel's
    dynamic shared memory and blocks an SM (the card), its registers and
    spills (ptxas), and the instructions in its SASS with HMMA (tensor core)
    and LDSM (ldmatrix) counted apart; every kernel must hold HMMA."""
    import re
    ptx = ptxas_kernels(build_log)
    sass = {}
    for fn, ins in sass_instructions(nvcc, lib).items():
        m = re.search(r"bwd_(dq|dkdv)_kernelI(f|13__nv_bfloat16)Li(\d+)E", fn)
        if m:
            ops = [op.split(".")[0] for _, op, _ in ins]
            sass[m.group(1), m.group(2), int(m.group(3))] = {
                "instructions": len(ops), "HMMA": ops.count("HMMA"), "LDSM": ops.count("LDSM")}
    for dtype, tag in ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16")):
        for hd in fa.HEAD_DIMS:
            regs = {k: [c for fn, c in ptx.items() if f"bwd_{k}_kernelI{tag}Li{hd}E" in fn]
                    for k in ("dq", "dkdv")}
            assert all(len(r) == 1 for r in regs.values()), f"no single bwd kernel {dtype} {hd}"
            code = {k: sass.get((k, tag, hd)) for k in ("dq", "dkdv")}
            log(f"[build] flash_attention_bwd {str(dtype)[6:]} hd {hd}: "
                f"{fa.bwd_tile_config(dtype, hd)}; ptxas "
                f"{ {k: r[0] for k, r in regs.items()} }; SASS {code} {card}")
            assert all(c and c["HMMA"] > 0 for c in code.values()), \
                f"K1's backward runs no HMMA ({dtype}, hd {hd})"


def router_sass(nvcc: str, lib: Path) -> dict:
    """For each instantiation of the router kernel in ``lib`` (by its
    template arguments: dtype and values a lane), its SASS instructions and
    the warp-wide ones among them: REDUX (redux.sync), VOTE (ballots), SHFL
    (shuffles)."""
    import re
    out = {}
    for fn, ins in sass_instructions(nvcc, lib).items():
        m = re.search(r"moe_router_kernelI(f|13__nv_bfloat16)Li(\d+)E", fn)
        if m:
            ops = [op.split(".")[0] for _, op, _ in ins]
            out["float32" if m.group(1) == "f" else "bfloat16", int(m.group(2))] = {
                "instructions": len(ops), **{o: ops.count(o) for o in ("REDUX", "VOTE", "SHFL")}}
    return dict(sorted(out.items()))


def ptxas_kernels(log: str) -> dict:
    """Registers, spill stores and loads and stack frame of each entry
    function in ``nvcc -Xptxas -v``'s log, keyed by its mangled name."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn].update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def report_k2_build(torch, ops, rw, nvcc: str, lib: Path, build_log: str, card: str) -> dict:
    """For each of K2's kernels (``rw.PASSES``) and dtype: registers and
    spills (ptxas), dynamic shared memory and blocks an SM (the card), its
    SASS instructions and its innermost loop with the most exponentials
    (``sass_loops``), and device ms a call at the serving shape
    (``device_kernels``, B=8 S=512 H=32 N=64 L=32).  Returns {dtype: {pass:
    ms}}."""
    ptx = ptxas_kernels(build_log)
    sass = {fn: sass_loops(ins) for fn, ins in sass_instructions(nvcc, lib).items()}
    dev = torch.device("cuda", 0)
    out = {}
    for dtype, tag in ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16")):
        name = str(dtype)[6:]
        r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 200, 8, 512, 32, 64, dtype)
        found = device_kernels(torch, f"rwkv6_scan {name} kernels",
                               lambda: ops.rwkv6_scan(r, k, v, logw, u, s0))
        occ = rw.occupancy(dtype, 32)
        out[name] = {}
        for pas in rw.PASSES:
            kernel = f"rwkv6_scan_{pas}_kernel"
            regs = [c for fn, c in ptx.items() if f"{kernel}I{tag}E" in fn]
            code = [c for fn, c in sass.items() if f"{kernel}I{tag}E" in fn]
            assert len(regs) == 1 and len(code) == 1, f"no single {kernel} for {name}"
            loop = max(code[0][1], key=lambda x: (x[1], -x[0]), default=None)
            out[name][pas] = None if found is None else per_call_ms(found, 10, kernel)
            assert out[name][pas] is None or out[name][pas] > 0, f"no device time for {kernel}"
            log(f"[build] rwkv6_scan {pas} kernel {name}: {regs[0]}, {occ[pas]['smem_bytes']} B "
                f"of dynamic shared memory (L=32), {occ[pas]['blocks_per_sm']} blocks an SM; "
                f"SASS (instructions, MUFU.EX2, LDS) {code[0][0]}, the innermost loop with the "
                f"most exponentials {loop}; {out[name][pas]!r} ms device time a call at B=8 "
                f"S=512 H=32 N=64 L=32 {card}")
    return out


def sass_counts(ins) -> dict:
    """One kernel's SASS (``parse_sass``) counted: all its instructions,
    HMMA (tensor core), MUFU.EX2 (exponentials), LDS (shared-memory loads,
    LDSM among them) and LDSM (ldmatrix)."""
    ops_ = [op for _, op, _ in ins]
    return {"instructions": len(ops_), "HMMA": sum(o.startswith("HMMA") for o in ops_),
            "MUFU.EX2": ops_.count("MUFU.EX2"), "LDS": sum(o.startswith("LDS") for o in ops_),
            "LDSM": sum(o.startswith("LDSM") for o in ops_)}


def report_k2_bwd_build(torch, ops, rw, nvcc: str, lib: Path, build_log: str,
                        card: str) -> tuple:
    """For each of the kernels of K2's backward (``rw.BWD_PASSES``) and
    dtype: registers and spills (ptxas), dynamic shared memory and blocks an
    SM (the card), its SASS counted (``sass_counts``: instructions, HMMA,
    MUFU.EX2, LDS), and device ms a call at the training shape
    (``device_kernels``, B=8 S=512 H=32 N=64 L=32, no final-state
    gradient).  The grads kernel must hold HMMA: its products run on the
    tensor cores.  Returns {dtype: {pass: ms}} and {dtype: {pass: counts}}."""
    ptx = ptxas_kernels(build_log)
    sass = {fn: sass_counts(ins) for fn, ins in sass_instructions(nvcc, lib).items()}
    dev = torch.device("cuda", 0)
    out, counts = {}, {}
    for dtype, tag in ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16")):
        name = str(dtype)[6:]
        r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 700, 8, 512, 32, 64, dtype)
        s0.zero_()
        dy, _ = rwkv_cotangents(torch, dev, 750, r, s0, dtype)
        states = rw.rwkv6_scan_cuda(r, k, v, logw, u, s0, return_states=True)[2]
        found = device_kernels(torch, f"rwkv6_scan_bwd {name} kernels",
                               lambda: ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy))
        occ = rw.bwd_occupancy(dtype, 32)
        out[name], counts[name] = {}, {}
        for pas in rw.BWD_PASSES:
            kernel = f"rwkv6_scan_bwd_{pas}_kernel"
            mine = lambda fn: kernel in fn and (pas == "du" or f"I{tag}E" in fn)
            regs = [c for fn, c in ptx.items() if mine(fn)]
            code = [c for fn, c in sass.items() if mine(fn)]
            assert len(regs) == 1 and len(code) == 1, f"no single {kernel} for {name}"
            counts[name][pas] = code[0]
            out[name][pas] = None if found is None else per_call_ms(found, 10, kernel)
            assert out[name][pas] is None or out[name][pas] > 0, f"no device time for {kernel}"
            log(f"[build] rwkv6_scan_bwd {pas} kernel {name}: {regs[0]}, "
                f"{occ[pas]['smem_bytes']} B of dynamic shared memory (L=32), "
                f"{occ[pas]['blocks_per_sm']} blocks an SM; SASS {code[0]}; "
                f"{out[name][pas]!r} ms device time a call at B=8 S=512 H=32 N=64 L=32 {card}")
        assert counts[name]["grads"]["HMMA"] > 0, f"K2's backward grads kernel runs no HMMA ({name})"
    return out, counts


# -- phase 2 ---------------------------------------------------------------------------

def check_flash_attention(torch, dev, ops, ref) -> float:
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, (B, Sq, Sk, H, K, hd), dtype, kwargs, edit
        ("smollm prefill fp32", (8, 512, 512, 9, 3, 64), f32, {}, None),
        ("smollm prefill bf16", (8, 512, 512, 9, 3, 64), bf16, {}, None),
        ("odd lengths MQA", (2, 96, 160, 4, 1, 64), f32, {}, None),
        ("odd lengths MQA bf16", (2, 96, 160, 4, 1, 64), bf16, {}, None),
        ("window+softcap hd128", (2, 300, 300, 4, 2, 128), f32,
         {"window": 64, "softcap": 30.0}, None),
        ("ring holes", (2, 64, 256, 4, 2, 64), f32, {}, "holes"),
        ("fully masked row", (2, 128, 128, 9, 3, 64), f32, {}, "masked_row"),
        ("recurrentgemma local_attn prefill hd256 MQA", (8, 512, 512, 16, 1, 256), f32,
         {"window": 2048}, None),
        ("gemma-2b hd256 MQA bf16", (2, 256, 256, 8, 1, 256), bf16, {}, None),
        ("granite-moe prefill", (8, 512, 512, 24, 8, 64), f32, {}, None),
        # tile edges: lengths off the 64-row block and the 32/64-key tile,
        # queries short of the last keys (chunked prefill), hd 128/256 in bf16,
        # and a q whose pointer and strides are not 16-byte multiples
        ("tile edges S=77", (2, 77, 77, 4, 2, 64), f32, {}, None),
        ("tile edges S=77 bf16", (2, 77, 77, 4, 2, 64), bf16, {}, None),
        ("chunked prefill, queries at 54..149 of 300 keys", (2, 96, 300, 4, 2, 64), f32, {},
         "chunked"),
        ("chunked prefill bf16", (2, 96, 300, 4, 2, 64), bf16, {}, "chunked"),
        ("hd256 short block, window, queries at 17..49 of 200 keys", (2, 33, 200, 8, 1, 256),
         f32, {"window": 24}, "chunked"),
        ("hd128 bf16 ragged", (2, 130, 170, 4, 2, 128), bf16, {}, None),
        ("hd256 bf16 ragged", (2, 130, 170, 8, 1, 256), bf16, {}, None),
        ("unaligned q view", (2, 100, 100, 4, 2, 64), f32, {}, "unaligned"),
        ("unaligned q view bf16", (2, 100, 100, 4, 2, 64), bf16, {}, "unaligned"),
    ]
    main_err = None
    for i, (name, shape, dtype, kw, edit) in enumerate(cases):
        q, k, v, qp, kp = attention_inputs(torch, dev, 100 + i, *shape, dtype)
        if edit == "holes":
            qp += 300
            kp[:, 96:200] = -1
        if edit == "masked_row":
            qp[1, 7] = -1
        if edit == "chunked":
            qp -= 150
        if edit == "unaligned":   # the same values, one element into a wider row
            q = torch.nn.functional.pad(q, (1, 0))[..., 1:]
            assert q.data_ptr() % 16 and q.stride(2) * q.element_size() % 16
        out = ops.flash_attention(q, k, v, qp, kp, causal=True, **kw)
        torch.cuda.synchronize()
        exp = ref.flash_attention_ref(q, k, v, qp, kp, causal=True, **kw)
        assert out.shape == exp.shape and out.dtype == exp.dtype, name
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite output"
        err = max_err(out, exp)
        atol = ATOL[str(dtype).split(".")[1]]
        log(f"[kernel] flash_attention {name} {shape} {dtype}: max_abs_err {err!r} (atol {atol})")
        assert err <= atol, f"{name}: max_abs_err {err} > {atol}"
        if edit == "masked_row":
            assert int(torch.count_nonzero(out[1, 7])) == 0, "fully masked row is not 0"
        if i == 0:
            main_err = err
    return main_err


# K1's backward against its plain version: normwise, max |kernel - plain|
# over max(1, max |plain|) for each of dq, dk, dv.  The two take fp32 sums in
# other orders, and the kernel's P comes from the forward's LSE (3xTF32
# scores).  On an H100 at most 3.0e-6 in fp32 (recurrentgemma's MQA, whose
# dK and dV sum over 16 heads) and 3.1e-3 in bf16 (about one bf16 ulp of a
# gradient): 1e-5 and 1.5e-2.  FlashAttentionFn against autograd of the
# plain forward adds the forward's own difference: at most 2.5e-6 and
# 4.0e-3: 2e-5 and 3.5e-2.
BWD_TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}
FN_TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}


def normwise(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return max_err(a, b) / max(1.0, float(b.float().abs().max()))


def check_flash_attention_bwd(torch, dev, ops, ref) -> float:
    """K1's backward (``ops.flash_attention_bwd``) against
    ``ref.flash_attention_bwd_ref`` at the forward's cases, fp32 and bf16,
    and against a second run of itself, bit for bit;
    then ``FlashAttentionFn`` (``ops.flash_attention`` on tensors that need a
    gradient) against autograd of the plain forward at smollm's train
    shape.  Returns the max abs error of dq, dk, dv at smollm's train
    shape, fp32."""
    from repro_torch.kernels import flash_attention as fa
    cases = [  # name, (B, Sq, Sk, H, K, hd), kwargs, edit
        ("smollm train", (8, 512, 512, 9, 3, 64), {}, None),
        ("granite-moe heads", (8, 512, 512, 24, 8, 64), {}, None),
        ("window+softcap hd128", (2, 200, 200, 4, 2, 128), {"window": 48, "softcap": 30.0},
         None),
        ("recurrentgemma local_attn hd256 MQA", (2, 512, 512, 16, 1, 256), {"window": 2048},
         None),
        ("ragged Sq < Sk, MQA", (2, 96, 160, 4, 1, 64), {}, None),
        ("empty key slots", (2, 64, 256, 4, 2, 64), {}, "holes"),
        ("fully masked row", (2, 128, 128, 9, 3, 64), {}, "masked_row"),
        ("tile edges S=77", (2, 77, 77, 4, 2, 64), {}, None),
        ("hd256 ragged", (2, 130, 170, 8, 1, 256), {}, None),
        ("unaligned q view", (2, 100, 100, 4, 2, 64), {}, "unaligned"),
    ]
    main_err = None
    for i, (name, shape, kw, edit) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, qp, kp = attention_inputs(torch, dev, 500 + i, *shape, dtype)
            if edit == "holes":
                qp += 300
                kp[:, 96:200] = -1
            if edit == "masked_row":
                qp[1, 7] = -1
            if edit == "unaligned":
                q = torch.nn.functional.pad(q, (1, 0))[..., 1:]
            out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, return_lse=True, **kw)
            g = torch.Generator(device=dev).manual_seed(600 + i)
            dout = torch.randn(out.shape, generator=g, device=dev).to(dtype)
            got = ops.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout, **kw)
            again = ops.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{name}: two runs differ"
            exp = ref.flash_attention_bwd_ref(q, k, v, qp, kp, out, lse, dout, **kw)
            tol = BWD_TOL[str(dtype)[6:]]
            errs = [max_err(a, b) for a, b in zip(got, exp)]
            rels = [normwise(a, b) for a, b in zip(got, exp)]
            log(f"[kernel] flash_attention_bwd {name} {shape} {dtype} {kw}: max_abs_err "
                f"dq/dk/dv {errs}, over max(1, max |g|) {rels} (tol {tol})")
            assert all(bool(torch.isfinite(a.float()).all()) for a in got), name
            assert all(a.dtype == dtype and a.shape == b.shape for a, b in zip(got, exp)), name
            assert max(rels) <= tol, f"{name} {dtype}: {rels} > {tol}"
            if edit == "masked_row":
                assert int(torch.count_nonzero(got[0][1, 7])) == 0, "masked row's dq is not 0"
            if i == 0 and dtype == torch.float32:
                main_err = max(errs)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, qp, kp = attention_inputs(torch, dev, 500, 8, 512, 512, 9, 3, 64, dtype)
        dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(650),
                           device=dev).to(dtype)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        ops.flash_attention(q, k, v, qp, kp).backward(dout)
        # the plain forward in fp32 on the same values
        qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
        ref.flash_attention_ref(qr, kr, vr, qp, kp).backward(dout.float())
        torch.cuda.synchronize()
        rels = [normwise(a.grad, b.grad) for a, b in ((q, qr), (k, kr), (v, vr))]
        tol = FN_TOL[str(dtype)[6:]]
        log(f"[kernel] FlashAttentionFn smollm train {dtype} vs autograd of the plain forward "
            f"(fp32): dq/dk/dv over max(1, max |g|) {rels} (tol {tol})")
        assert max(rels) <= tol, f"FlashAttentionFn {dtype}: {rels} > {tol}"
    return main_err


def check_rwkv6(torch, dev, ops, ref) -> float:
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, (B, S, H, N), chunk, dtype, zero initial state
        ("rwkv6-1.6b prefill fp32", (8, 512, 32, 64), 32, f32, True),
        ("rwkv6-1.6b prefill, initial state", (8, 512, 32, 64), 32, f32, False),
        ("rwkv6-1.6b prefill bf16", (8, 512, 32, 64), 32, bf16, False),
        ("ragged S=50 L=32", (2, 50, 32, 64), 32, f32, False),
        ("ragged S=50 L=32 bf16", (2, 50, 32, 64), 32, bf16, False),
        ("one row in the last chunk", (1, 33, 4, 64), 16, f32, False),
        ("one chunk shorter than L", (2, 20, 4, 64), 32, f32, False),
        ("chunks are all the parallelism", (1, 2051, 2, 64), 32, f32, False),
    ]
    main_err = None
    for i, (name, shape, chunk, dtype, zero) in enumerate(cases):
        r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 200 + i, *shape, dtype)
        if zero:
            s0.zero_()
        y, s = ops.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
        torch.cuda.synchronize()
        y_ref, s_ref = ref.rwkv6_scan_ref(r, k, v, logw, u, s0)
        assert y.dtype == r.dtype and s.dtype == f32 and y.shape == y_ref.shape, name
        assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all()), name
        atol = RWKV_ATOL[str(dtype).split(".")[1]]
        rtol = BF16_RTOL if dtype == bf16 else 0.0
        err = max(max_err(y, y_ref), max_err(s, s_ref))
        log(f"[kernel] rwkv6_scan {name} (B,S,H,N)={shape} L={chunk} {dtype}: max_abs_err "
            f"{err!r} (atol {atol}, rtol {rtol})")
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(s, s_ref, rtol=rtol, atol=atol)
        if i == 0:
            main_err = err
    r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 250, 2, 96, 32, 64, f32)
    y_full, s_full = ops.rwkv6_scan(r, k, v, logw, u, s0)
    y1, s_mid = ops.rwkv6_scan(r[:, :40], k[:, :40], v[:, :40], logw[:, :40], u, s0)
    y2, s_end = ops.rwkv6_scan(r[:, 40:], k[:, 40:], v[:, 40:], logw[:, 40:], u, s_mid)
    torch.cuda.synchronize()
    err = max(max_err(torch.cat([y1, y2], 1), y_full), max_err(s_end, s_full))
    log(f"[kernel] rwkv6_scan two halves (40 + 56 steps) vs one run: max_abs_err {err!r} "
        f"(atol {RWKV_ATOL['float32']})")
    assert err <= RWKV_ATOL["float32"]
    return main_err


def check_rglru(torch, dev, ops, ref) -> float:
    cases = [  # name, (B, S, R), with h0
        ("recurrentgemma-9b prefill, zero h0", (8, 512, 4096), "zeros"),
        ("recurrentgemma-9b prefill, h0", (8, 512, 4096), True),
        ("h0=None", (8, 512, 4096), False),
        ("odd sizes", (3, 77, 40), True),
        ("S < 8, R not a multiple of 128", (2, 5, 300), False),
    ]
    main_err = None
    for i, (name, shape, h0_kind) in enumerate(cases):
        a, b, h0 = rglru_inputs(torch, dev, 300 + i, *shape)
        h0 = None if h0_kind is False else (h0.zero_() if h0_kind == "zeros" else h0)
        h = ops.rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        h_ref = ref.rglru_scan_ref(a, b, h0)
        assert h.dtype == torch.float32 and h.shape == h_ref.shape, name
        err = max_err(h, h_ref)
        log(f"[kernel] rglru_scan {name} (B,S,R)={shape}: max_abs_err {err!r} "
            f"(atol {RGLRU_ATOL})")
        assert err <= RGLRU_ATOL, f"{name}: max_abs_err {err} > {RGLRU_ATOL}"
        if i == 0:
            main_err = err
    a, b, h0 = rglru_inputs(torch, dev, 350, 2, 300, 1000)
    h_full = ops.rglru_scan(a, b, h0)
    h1 = ops.rglru_scan(a[:, :137], b[:, :137], h0)
    h2 = ops.rglru_scan(a[:, 137:], b[:, 137:], h1[:, -1].contiguous())
    torch.cuda.synchronize()
    err = max_err(torch.cat([h1, h2], 1), h_full)
    log(f"[kernel] rglru_scan two halves (137 + 163 steps) vs one run: max_abs_err {err!r} "
        f"(atol {RGLRU_ATOL})")
    assert err <= RGLRU_ATOL
    return main_err


# K2's and K3's backwards against their plain versions (autograd of the
# sequential fp32 recurrence; K3's written out), normwise, max |kernel -
# plain| over max(1, max |plain|) for each gradient.  The two take their fp32
# sums in other orders (chunks against steps for K2).  On an H100, K2 at most
# 1.0e-6 in fp32 (du at the training shape, a sum over 8 x 512 steps) and
# 3.6e-3 with bf16 r/k/v (about one bf16 ulp of dr): 1e-5 and 1.5e-2, K1's
# backward's limits; RWKV6ScanFn against autograd of the plain forward at
# most 3.9e-7.  With strong decay (STRONG_DECAY) fp32 reads 5.5e-6, whatever
# the kernel's design: a chunked scan takes each exponent as a difference of
# running sums of logw near -100, which rounds it by about 6e-6.  K3 at most
# 9.5e-7 (RGLRUScanFn 1.9e-6): 1e-5, the RG-LRU tolerance of
# tests/test_kernels.py.
K2_BWD_TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}
K3_BWD_TOL = 1e-5
RWKV_GRADS = ("dr", "dk", "dv", "dlogw", "du", "dstate")


def rwkv_cotangents(torch, dev, seed, r, state, dtype):
    """dy (in r/k/v's dtype) and ds_out (fp32) for a backward check."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(r.shape, generator=g, device=dev).to(dtype),
            torch.randn(state.shape, generator=g, device=dev))


def check_rwkv6_bwd(torch, dev, ops, ref, rw) -> float:
    """K2's backward (``ops.rwkv6_scan_bwd``) against
    ``ref.rwkv6_scan_bwd_ref`` at the training shape and edge cases (a
    ragged last chunk, an initial state, a final-state gradient), fp32 and
    bf16, and against a second run of itself, bit for bit; then
    ``RWKV6ScanFn`` (``ops.rwkv6_scan`` on tensors that need a gradient)
    against autograd of the plain forward.  Returns the max abs error over
    the gradients at the training shape, fp32."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, (B, S, H, N), chunk, dtype, zero initial state, final-state gradient
        ("rwkv6-1.6b train fp32", (8, 512, 32, 64), 32, f32, True, False),
        ("rwkv6-1.6b train bf16", (8, 512, 32, 64), 32, bf16, True, False),
        ("train shape, initial state and final-state gradient", (8, 512, 32, 64), 32, f32,
         False, True),
        ("ragged S=50 L=32", (2, 50, 32, 64), 32, f32, False, True),
        ("ragged S=50 L=32 bf16", (2, 50, 32, 64), 32, bf16, False, True),
        ("one row in the last chunk", (1, 33, 4, 64), 16, f32, False, True),
        ("one chunk shorter than L", (2, 20, 4, 64), 32, f32, False, True),
        ("chunks are all the parallelism", (1, 2051, 2, 64), 32, f32, False, False),
        # the grads kernel's sub-chunks are 16 rows: chunks of 24 (and a
        # last one of 3) cut one short; strong decay, tens of e-folds a chunk
        ("chunk 24, not a multiple of 16", (1, 75, 4, 64), 24, f32, False, True),
        ("chunk 24 bf16", (1, 75, 4, 64), 24, bf16, False, True),
        ("strong decay", (2, 100, 32, 64), 32, f32, False, True),
        ("strong decay bf16", (2, 100, 32, 64), 32, bf16, False, True),
    ]
    main_err = None
    for i, (name, shape, chunk, dtype, zero, with_ds) in enumerate(cases):
        decay = STRONG_DECAY if name.startswith("strong") else USUAL_DECAY
        r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 700 + i, *shape, dtype, decay)
        if zero:
            s0.zero_()
        dy, ds_out = rwkv_cotangents(torch, dev, 750 + i, r, s0, dtype)
        ds_out = ds_out if with_ds else None
        states = rw.rwkv6_scan_cuda(r, k, v, logw, u, s0, chunk=chunk, return_states=True)[2]
        got = ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy, ds_out, chunk=chunk)
        again = ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy, ds_out, chunk=chunk)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{name}: two runs differ"
        exp = ref.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dy, ds_out)
        assert [a.dtype for a in got] == [a.dtype for a in exp], name
        assert all(bool(torch.isfinite(a.float()).all()) for a in got), f"{name}: non-finite"
        errs = {n: max_err(a, b) for n, a, b in zip(RWKV_GRADS, got, exp)}
        rels = {n: normwise(a, b) for n, a, b in zip(RWKV_GRADS, got, exp)}
        tol = K2_BWD_TOL[str(dtype)[6:]]
        log(f"[kernel] rwkv6_scan_bwd {name} (B,S,H,N)={shape} L={chunk} {dtype}: max_abs_err "
            f"{errs}, over max(1, max |g|) {rels} (tol {tol})")
        assert max(rels.values()) <= tol, f"{name}: {rels} > {tol}"
        if i == 0:
            main_err = max(errs.values())
    for dtype in (f32, bf16):
        r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 780, 2, 100, 32, 64, dtype)
        dy, ds_out = rwkv_cotangents(torch, dev, 781, r, s0, dtype)
        xs = [x.clone().requires_grad_() for x in (r, k, v, logw, u, s0)]
        torch.autograd.backward(ops.rwkv6_scan(*xs), [dy, ds_out])
        xr = [x.detach().float().requires_grad_() for x in (r, k, v, logw, u, s0)]
        torch.autograd.backward(ref.rwkv6_scan_ref(*xr), [dy.float(), ds_out])
        torch.cuda.synchronize()
        rels = {n: normwise(a.grad, b.grad) for n, a, b in zip(RWKV_GRADS, xs, xr)}
        tol = K2_BWD_TOL[str(dtype)[6:]]
        log(f"[kernel] RWKV6ScanFn (B,S,H,N)=(2, 100, 32, 64) {dtype} vs autograd of the plain "
            f"forward (fp32): over max(1, max |g|) {rels} (tol {tol})")
        assert all(a.grad.dtype == a.dtype for a in xs), "a gradient in another dtype"
        assert max(rels.values()) <= tol, f"RWKV6ScanFn {dtype}: {rels} > {tol}"
    return main_err


def check_rglru_bwd(torch, dev, ops, ref) -> float:
    """K3's backward (``ops.rglru_scan_bwd``) against
    ``ref.rglru_scan_bwd_ref`` at the training shape and edge cases, and
    against a second run of itself, bit for bit; then ``RGLRUScanFn``
    against autograd of the plain forward.  Returns the max abs error at
    the training shape."""
    cases = [  # name, (B, S, R), with h0
        ("recurrentgemma-9b train, h0=None", (8, 512, 4096), False),
        ("recurrentgemma-9b train shape, h0", (8, 512, 4096), True),
        ("odd sizes", (3, 77, 40), True),
        ("S < 8, R not a multiple of 128", (2, 5, 300), False),
    ]
    main_err = None
    for i, (name, shape, with_h0) in enumerate(cases):
        a, b, h0 = rglru_inputs(torch, dev, 800 + i, *shape)
        h0 = h0 if with_h0 else None
        dh = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(850 + i),
                         device=dev)
        h = ops.rglru_scan(a, b, h0)
        got = ops.rglru_scan_bwd(a, h0, h, dh)
        again = ops.rglru_scan_bwd(a, h0, h, dh)
        torch.cuda.synchronize()
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, again)), \
            f"{name}: two runs differ"
        exp = ref.rglru_scan_bwd_ref(a, h0, h, dh)
        assert (got[2] is None) == (h0 is None), name
        errs = [max_err(x, y) for x, y in zip(got, exp) if x is not None]
        rels = [normwise(x, y) for x, y in zip(got, exp) if x is not None]
        log(f"[kernel] rglru_scan_bwd {name} (B,S,R)={shape}: max_abs_err da/db/dh0 {errs}, "
            f"over max(1, max |g|) {rels} (tol {K3_BWD_TOL})")
        assert max(rels) <= K3_BWD_TOL, f"{name}: {rels} > {K3_BWD_TOL}"
        if i == 0:
            main_err = max(errs)
    a, b, h0 = rglru_inputs(torch, dev, 880, 2, 300, 1000)
    dh = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(881), device=dev)
    xs = [x.clone().requires_grad_() for x in (a, b, h0)]
    ops.rglru_scan(*xs).backward(dh)
    xr = [x.clone().requires_grad_() for x in (a, b, h0)]
    ref.rglru_scan_ref(*xr).backward(dh)
    torch.cuda.synchronize()
    rels = [normwise(x.grad, y.grad) for x, y in zip(xs, xr)]
    log(f"[kernel] RGLRUScanFn (B,S,R)=(2, 300, 1000) vs autograd of the plain forward: "
        f"da/db/dh0 over max(1, max |g|) {rels} (tol {K3_BWD_TOL})")
    assert max(rels) <= K3_BWD_TOL, f"RGLRUScanFn: {rels} > {K3_BWD_TOL}"
    return main_err


# K4's cases on the card: name, (T, E, k), dtype, rows set to zero.  The
# logits of case i are ``router_logits`` of seed 400 + i.
ROUTER_CASES = (
    ("granite-moe prefill", (4096, 40, 8), "float32", None),
    ("granite-moe decode, 248 padded rows", (256, 40, 8), "float32", slice(8, None)),
    ("deepseek-moe", (4096, 64, 6), "float32", None),
    ("all rows zero", (512, 64, 6), "float32", slice(None)),
    ("odd T, E=250", (77, 250, 8), "float32", None),
    ("k = E", (64, 8, 8), "float32", None),
    ("granite-moe prefill bf16", (4096, 40, 8), "bfloat16", None),
)


def check_moe_router(torch, dev, ops, ref) -> float:
    """K4 against ``ref.moe_router_ref``: equal indices, weights within
    ``ROUTER_ATOL``.  On random logits an index may differ only where the
    two candidates' plain probabilities are within one fp32 ulp (the two
    softmaxes sum in other orders); each such case is printed and counted.
    Rows that tie (all zero) must match exactly."""
    f32 = torch.float32
    main_err, near_ties = None, 0
    for i, (name, (T, E, k), dtype, zero) in enumerate(ROUTER_CASES):
        dtype = getattr(torch, dtype)
        logits = router_logits(torch, dev, T, E, 400 + i).to(dtype)
        if zero is not None:
            logits[zero] = 0
        w, idx = ops.moe_router(logits, k)
        torch.cuda.synchronize()
        w_ref, idx_ref = ref.moe_router_ref(logits, k)
        assert w.shape == (T, k) and w.dtype == f32 and idx.dtype == torch.int32, name
        diff = idx != idx_ref
        if zero is not None:
            assert not bool(diff[zero].any()), f"{name}: tied rows differ"
            assert bool((idx[zero] == torch.arange(k, device=dev)).all()), name
        probs = torch.softmax(logits.float(), dim=-1)
        for r, j in diff.nonzero().tolist():
            a, b = probs[r, idx[r, j]], probs[r, idx_ref[r, j]]
            m = torch.maximum(a, b)
            ulp = float(m - torch.nextafter(m, torch.zeros_like(m)))
            log(f"[kernel] moe_router {name}: row {r} slot {j} picks {int(idx[r, j])} where "
                f"plain picks {int(idx_ref[r, j])}; plain probs {float(a)!r} {float(b)!r}")
            assert abs(float(a - b)) <= ulp, f"{name}: index differs beyond one ulp"
            near_ties += 1
        err = max_err(w, w_ref)
        log(f"[kernel] moe_router {name} (T,E,k)={(T, E, k)} {dtype}: max_abs_err {err!r} "
            f"(atol {ROUTER_ATOL}), {int(diff.any(-1).sum())} rows with another index")
        assert err <= ROUTER_ATOL, f"{name}: max_abs_err {err} > {ROUTER_ATOL}"
        if i == 0:
            main_err = err
    log(f"[kernel] moe_router: {near_ties} index differences, each within one fp32 ulp")
    return main_err


# K4's backward against its plain version (``ref.moe_router_bwd_ref``, the
# chain of JAX's autograd written out), normwise, max |kernel - plain| over
# max(1, max |plain|) of dlogits, at ``ROUTER_CASES``.  The
# sums over the k selected experts are taken in another order; in bf16 each
# side rounds dlogits once, so a value may land one bf16 ulp (2**-8
# relative) away.  ``MoERouterFn`` against autograd of the plain router on
# the rows where the two select the same experts: the same limits.  On an
# H100, fp32 at most 1.79e-7 (1.79e-7 granite-moe prefill, 2.38e-7 for
# MoERouterFn): 2e-6; bf16 1.95e-3 (2**-9, one bf16 ulp of a gradient
# between 0.25 and 0.5): one ulp of a gradient up to 1, 2**-8.
K4_BWD_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -8}


def router_cotangent(torch, dev, seed, T, k):
    """A seeded gradient of the router's (T, k) weights."""
    return torch.randn((T, k), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def check_moe_router_bwd(torch, dev, ops, ref, router) -> float:
    """K4's backward (``ops.moe_router_bwd``) on the kernel's own forward
    outputs against ``ref.moe_router_bwd_ref`` at the cases of
    ``check_moe_router`` (the same logits), with seeded weight gradients,
    and against a second run of itself, bit for bit.  Rows where the
    kernel's experts differ from the plain version's (near-ties) are held
    against the plain backward fed the kernel's own indices and weights.
    Then ``MoERouterFn`` (``ops.moe_router`` on logits that need a
    gradient) against autograd of ``ref.moe_router_ref``, on the rows where
    both select the same experts.  Returns the max abs error of the first
    case."""
    main_err = None
    for i, (name, (T, E, k), dtype, zero) in enumerate(ROUTER_CASES):
        logits = router_logits(torch, dev, T, E, 400 + i).to(getattr(torch, dtype))
        if zero is not None:
            logits[zero] = 0
        dw = router_cotangent(torch, dev, 450 + i, T, k)
        w, idx = router.moe_router_cuda(logits, k)
        got = ops.moe_router_bwd(logits, w, idx, dw)
        again = ops.moe_router_bwd(logits, w, idx, dw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: two runs differ"
        assert got.dtype == logits.dtype and got.shape == logits.shape, name
        assert bool(torch.isfinite(got.float()).all()), f"{name}: non-finite"
        w_ref, idx_ref = ref.moe_router_ref(logits, k)
        flips = (idx != idx_ref).any(-1, keepdim=True)
        exp = ref.moe_router_bwd_ref(logits, torch.where(flips, w, w_ref),
                                     torch.where(flips, idx, idx_ref), dw)
        err, rel = max_err(got, exp), normwise(got, exp)
        tol = K4_BWD_TOL[dtype]

        x = logits.clone().requires_grad_()
        before = ops.moe_router_bwd.launches
        wk, ik = ops.moe_router(x, k)
        wk.backward(dw)
        torch.cuda.synchronize()
        assert ops.moe_router_bwd.launches == before + 1, f"{name}: MoERouterFn ran no kernel"
        assert torch.equal(ik, idx) and torch.equal(x.grad, got), \
            f"{name}: MoERouterFn is not the kernels' forward and backward"
        xr = logits.clone().requires_grad_()
        ref.moe_router_ref(xr, k)[0].backward(dw)
        keep = ~flips[:, 0]
        fn_rel = normwise(x.grad[keep], xr.grad[keep])
        log(f"[kernel] moe_router_bwd {name} (T,E,k)={(T, E, k)} {logits.dtype}: max_abs_err "
            f"{err!r}, over max(1, max |g|) {rel!r}; MoERouterFn vs autograd of the plain router "
            f"{fn_rel!r} on {int(keep.sum())} of {T} rows (tol {tol}); {int(flips.sum())} rows "
            "with another index, fed the kernel's")
        assert rel <= tol, f"{name}: {rel} > {tol}"
        assert fn_rel <= tol, f"{name}: MoERouterFn {fn_rel} > {tol}"
        if i == 0:
            main_err = err
    return main_err


# -- phases 3 and 4, one model at a time -------------------------------------------------

def wkv_f64(torch, r, k, v, logw, u, s0):
    """(y, final state) of the WKV recurrence, one step at a time in float64."""
    r, k, v, logw, u, state = (x.double() for x in (r, k, v, logw, u, s0))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + u[None, :, :, None] * kv))
        state = torch.exp(logw[:, t])[..., None] * state + kv
    return torch.stack(ys, 1), state


def wkv_precision(torch, res, prefill) -> None:
    """Why the rwkv6 serve check needs a looser tolerance.  K2, the plain
    chunked scan and the plain sequential scan, each on the first and the
    last layer's own inputs, against float64 (y and the final state); then
    how far the prefill logits move when every K2 output carries one fp32
    ulp (2**-23) of relative noise, for each of ``NOISE_SEEDS``.  Fails if
    K2's y or state is more than ``K2_PRECISION_FACTOR`` times as far from
    float64 as the plain chunked scan's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as k2
    from repro_torch.models.rwkv6 import _wkv_chunked
    real, calls, L = k2.rwkv6_scan_cuda, [], res.cfg.rwkv_chunk

    def noisy(g):
        def fn(*a, **kw):
            y, s = real(*a, **kw)
            return y * (1 + 2.0 ** -23 * torch.randn(y.shape, generator=g, device=y.device)), s
        return fn

    runs = [("exact", lambda *a, **kw: calls.append(a) or real(*a, **kw))]
    runs += [(seed, noisy(torch.Generator(device=res.prompts.device).manual_seed(seed)))
             for seed in NOISE_SEEDS]
    logits = {}
    for name, fn in runs:
        k2.rwkv6_scan_cuda = fn
        try:
            logits[name], _ = prefill(res.params, {"tokens": res.prompts}, res.cfg, S + NEW)
        finally:
            k2.rwkv6_scan_cuda = real
    for layer in (0, len(calls) - 1):
        args = [a.detach() for a in calls[layer]]   # u is a parameter
        y64, s64 = wkv_f64(torch, *args)
        rel = {}
        for name, (y, st) in (("kernel", real(*args, chunk=L)),
                              ("plain chunked", _wkv_chunked(*args, L)),
                              ("plain sequential", ref.rwkv6_scan_ref(*args))):
            rel[name] = tuple(float((a.double() - b).abs().max() / b.abs().max())
                              for a, b in ((y, y64), (st, s64)))
        log(f"[precision] rwkv6 layer {layer}: max abs err vs float64 over max |x| of "
            f"(y, state) (max |y| {float(y64.abs().max())!r}, max |state| "
            f"{float(s64.abs().max())!r}): {rel}")
        for i, what in enumerate(("y", "state")):
            ratio = rel["kernel"][i] / rel["plain chunked"][i]
            log(f"[precision] rwkv6 layer {layer} {what}: kernel / plain chunked {ratio!r} "
                f"(limit {K2_PRECISION_FACTOR})")
            assert ratio <= K2_PRECISION_FACTOR, (layer, what, rel)
    shifts = [float((logits[seed] - logits["exact"]).abs().max()) for seed in NOISE_SEEDS]
    log(f"[precision] rwkv6: one fp32 ulp of relative noise on every K2 output moves the "
        f"prefill logits by max {shifts} (seeds {list(NOISE_SEEDS)}; max |logit| "
        f"{float(logits['exact'].abs().max())!r})")


@contextlib.contextmanager
def patched(obj, name: str, fn):
    """``obj.<name>`` replaced by ``fn`` inside the block (an attribute a
    class inherits is deleted again, not copied onto it)."""
    own = name in vars(obj)
    real = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, real)
        else:
            delattr(obj, name)


class RoutingCheck:
    """Teacher-forces the plain path's MoE routing to the kernel path's.

    ``record`` stands in for ``moe._route`` on the kernel path and keeps
    each call's experts.  ``forced`` stands in for it on the plain path: it
    routes by the plain version, compares the experts with the kernel
    path's same call, and returns the kernel path's experts with weights
    gathered from the plain probabilities and renormalised, so that one
    near-tie decided the other way does not change which tokens every later
    layer sees.  For each token row whose experts differ, the gap is the
    plain probability of the plain path's expert less that of the kernel
    path's, at the first slot where they differ."""

    def __init__(self, torch, moe_mod):
        self.torch, self.real = torch, moe_mod._route
        self.kernel_idx, self.gaps, self.calls = [], [], 0

    def record(self, logits, moe, kernel_impl="jnp"):
        out = self.real(logits, moe, kernel_impl)
        self.kernel_idx.append(out[1])
        return out

    def forced(self, logits, moe, kernel_impl="jnp"):
        torch = self.torch
        _, idx, probs = self.real(logits, moe, "jnp")
        kidx = self.kernel_idx[self.calls]
        diff = idx != kidx
        rows = diff.any(-1)
        if bool(rows.any()):
            j = diff[rows].int().argmax(-1)               # the first slot that differs
            n = torch.arange(len(j), device=j.device)
            p = probs.detach()[rows]
            self.gaps.append((self.calls, p[n, idx[rows][n, j].long()]
                              - p[n, kidx[rows][n, j].long()]))
        self.calls += 1
        w = probs.gather(-1, kidx.long())
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), kidx, probs

    def report(self, tag: str, where) -> dict:
        """Count the decisions that differ; each must be a near-tie.
        ``where(call)`` names a call as (group, step, layer): the counts are
        printed by group (prefill and decode; a train step), the first
        calls with a difference by step and layer.  Returns the counts."""
        assert self.calls == len(self.kernel_idx), (self.calls, len(self.kernel_idx))
        rows = sum(int(k.shape[0] * k.shape[1]) for k in self.kernel_idx)
        n = sum(len(g) for _, g in self.gaps)
        by_group = {where(c)[0]: 0 for c in range(self.calls)}
        for c, g in self.gaps:
            by_group[where(c)[0]] += len(g)
        gaps = [float(x) for _, g in self.gaps for x in g.tolist()]
        log(f"{tag}: routing decisions (layer, token row) that differ between the paths: {n} of "
            f"{rows} ({', '.join(f'{v} in {k}' for k, v in by_group.items())}); "
            f"plain-probability gaps: max {max(gaps, default=0.0)!r}, min "
            f"{min(gaps, default=0.0)!r} (limit {FLIP_GAP})")
        for c, g in self.gaps[:20]:
            _, step, layer = where(c)
            log(f"{tag.split()[0]}   {step} layer {layer}: {len(g)} rows, gaps {g.tolist()}")
        assert all(0.0 <= x <= FLIP_GAP for x in gaps), f"{tag}: a routing flip beyond {FLIP_GAP}"
        return {"differ": n, "decisions": rows, "max_gap": max(gaps, default=0.0)}


def serve_call(n_layers: int):
    """``RoutingCheck.report``'s names of a serve's router calls: a prefill,
    then one decode step after another, ``n_layers`` calls each."""
    def where(c):
        step = "prefill" if c < n_layers else f"decode step {c // n_layers}"
        return step.split()[0], step, c % n_layers
    return where


def train_call(n_layers: int, remat: bool = True):
    """``RoutingCheck.report``'s names of the router calls of one step after
    another: the forward, layer 0 first, then under remat the backward's
    recompute, the last layer first."""
    per = 2 * n_layers if remat else n_layers

    def where(c):
        step, i = c // per, c % per
        part, layer = ("forward", i) if i < n_layers else ("recompute", per - 1 - i)
        return f"step {step}", f"step {step} {part}", layer
    return where


# The train phase: smollm-135m at full width, fp32, B x S tokens a step.
# Kernel path (K1 forward and backward) against the plain path
# (attn_impl="naive") on the same weights and batches: the first step's
# gradient of every parameter, max |plain - kernel| over max(1, max
# |kernel|), and each step's loss, |plain - kernel| over max(1, |kernel|).
# Each limit is about 10x the largest reading on an H100: 2.07e-7 (the
# embedding table) and 8.75e-8.
TRAIN_ARCH, TRAIN_STEPS = "smollm-135m", 4
TRAIN_GRAD_TOL, TRAIN_LOSS_TOL = 2e-6, 1e-6


def run_train(card: str, torch, ops, dev) -> dict:
    """Train ``TRAIN_ARCH`` for ``TRAIN_STEPS`` steps through
    ``repro_torch.launch.train``, with every launch count set to 0 just
    before and read just after; hold it against the plain path; time it and
    trace one warm step."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train as launch_train
    from repro_torch.models import forward_train, init_params
    from repro_torch.train import TrainState, adamw, linear_warmup_cosine, make_train_step

    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    res = launch_train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(B),
                             "--seq-len", str(S), "--log-every", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    cfg = res.cfg
    n_attn = sum(t in ("attention", "local_attn") for t in cfg.pattern_for_layers())
    expect = expected_train_launches(cfg, TRAIN_STEPS)
    log(f"[train] {TRAIN_ARCH}: kernel launches on the main path: {launches} ({TRAIN_STEPS} "
        f"steps; {n_attn} attention layers a step)")
    assert launches == expect, f"{TRAIN_ARCH} train: expected {expect} launches"
    assert cfg.attn_impl == "pallas" and len(res.losses) == TRAIN_STEPS
    assert all(math.isfinite(x) for x in res.losses)
    steady = min(res.step_s[1:])
    log(f"[time] {TRAIN_ARCH} train step B={B} S={S} fp32: first {res.step_s[0]!r} s, steady "
        f"(min of the other {TRAIN_STEPS - 1}) {steady!r} s (steps {res.step_s}), "
        f"{B * S / steady!r} tokens/s, peak device memory {peak / 2**20:.1f} MiB {card}")

    # the plain path on the same weights (the same seed on the same device) and batches
    plain = dataclasses.replace(cfg, attn_impl="naive")
    data = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S, vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(x).to(dev) for k, x in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    first = {tag: first_step_grads(torch, forward_train, params, batches[0], c)
             for tag, c in (("kernel", cfg), ("plain", plain))}
    rel = {n: normwise(first["plain"][1][n], g) for n, g in first["kernel"][1].items()}
    worst = max(rel, key=rel.get)
    grad_err = rel[worst]
    log(f"[train] {TRAIN_ARCH} first-step gradients, kernel path vs plain path, max abs err "
        f"over max(1, max |g|): {grad_err!r} ({worst}; median over the {len(rel)} parameters "
        f"{statistics.median(rel.values())!r}); loss {first['kernel'][0]!r} vs "
        f"{first['plain'][0]!r} (tol {TRAIN_GRAD_TOL})")
    assert grad_err <= TRAIN_GRAD_TOL, f"first-step gradient {worst}: {grad_err}"
    del first
    opt = adamw(linear_warmup_cosine(3e-4, 10, TRAIN_STEPS))   # launch.train's defaults
    step = make_train_step(plain, opt)
    state = TrainState(params, opt.init(dict(params.named_parameters())), 0)
    plain_losses = []
    for b in batches:
        state, metrics = step(state, b)
        plain_losses.append(float(metrics["loss"]))
    loss_err = [abs(p - k) / max(1.0, abs(k)) for p, k in zip(plain_losses, res.losses)]
    log(f"[train] {TRAIN_ARCH} losses, kernel path {res.losses}, plain path {plain_losses}; "
        f"differences over max(1, |loss|) {loss_err} (tol {TRAIN_LOSS_TOL})")
    assert max(loss_err) <= TRAIN_LOSS_TOL, f"losses differ: {loss_err}"
    del state, params, step

    kstep, held = make_train_step(cfg, opt), {"state": res.state}

    def one_step():
        held["state"], _ = kstep(held["state"], batches[0])

    one_step()                                                # warm-up
    trace(f"{TRAIN_ARCH} train step (warm)", one_step, card, ops)
    return {"launches": launches, "steady_step_s": steady, "tokens_per_s": B * S / steady,
            "peak_bytes": peak, "grad_rel_err": grad_err, "loss_rel_err": max(loss_err)}


# Phase 3c: the ssm and hybrid families trained through ``launch.train`` at
# full width, fp32, B x S tokens a step, TRAIN_R_STEPS steps each, on the
# scan kernels and their backwards: rwkv6-1.6b at full depth (24 layers, no
# remat), then recurrentgemma-9b with its depth cut to one repeat of
# (rglru, rglru, local_attn), 3 of its 38 layers (remat as configured, so
# the repeat's forward runs again in the backward; at two repeats, 2.36 B
# parameters, the first step's AdamW update ran out of the card's 80 GB).
# Kernel path against the plain path (``attn_impl="naive"``,
# ``kernel_impl="jnp"``, with remat: it leaves the gradients as they are,
# and rwkv6's plain chunked scan keeps a (B, L, L, H, N) tensor for each
# chunk, too many for the card without it) on the same weights and batches:
# the first step's gradient of every parameter, max |plain - kernel| over
# max(1, max |kernel|), and each step's loss, |plain - kernel| over max(1,
# |kernel|).
# rwkv6-1.6b's are held against the plain path in float64 instead
# (``grads_vs_f64``): at this random init its first-step gradients are
# chaotic.  On an H100 one fp32 ulp of relative noise on every WKV output
# moved the float64 gradients by up to 8.79 of a parameter's largest value
# (median 0.391; 0.072 in layer 23, 8.79 in layer 3), and the fp32 paths
# are as far from float64: the median parameter 0.691 (kernel) and 0.648
# (plain).  Only the decay's parameters (w0, w_lora_a, w_lora_b, through
# K2's dlogw) and the final norm were resolved: 53 of 580 within
# F64_RESOLVED = 1e-2 of float64 on the plain path, and there the kernel
# path within 1.16x of the plain path's error.  So each resolved parameter
# on the kernel path must be within F64_GRAD_FACTOR of the plain path's
# error or of F64_GRAD_FLOOR, whichever is larger, and the median over all
# within F64_GRAD_FACTOR of the plain path's.  Its losses, after AdamW
# steps on those gradients, differed by at most 3.86e-4 of their size:
# 4e-3; they check the forward and the update, not the backward.
# recurrentgemma-9b's gradients are not chaotic: at most 2.37e-8 (a gate
# weight) and 6.53e-8 on an H100, so its limits are about 10x those, as
# phase 3's: 2.5e-7 and 1e-6.
TRAIN_R_STEPS = 3
TRAIN_R = (("rwkv6-1.6b", None), ("recurrentgemma-9b", 3))
F64_GRAD_FACTOR, F64_GRAD_FLOOR, F64_RESOLVED, F64_GRAD_SHOWN = 2.0, 1e-5, 1e-2, 8
TRAIN_R_GRAD_TOL = {"recurrentgemma-9b": 2.5e-7}
TRAIN_R_LOSS_TOL = {"rwkv6-1.6b": 4e-3, "recurrentgemma-9b": 1e-6}


def expected_train_launches(cfg, steps: int) -> dict:
    """Launches of each wrapper in ``steps`` train steps of ``cfg`` on the
    kernel path: a forward and a backward for each attention, RWKV-6,
    RG-LRU and MoE layer (every attention layer of the moe family), and
    with remat one more forward (``torch.utils.checkpoint`` runs each
    repeat's forward again in the backward)."""
    pattern = cfg.pattern_for_layers()
    fwd = 2 if cfg.remat else 1
    n_attn = sum(t in ("attention", "local_attn") for t in pattern)
    n = {"flash_attention": n_attn, "rwkv6_scan": pattern.count("rwkv6"),
         "rglru_scan": pattern.count("rglru"),
         "moe_router": n_attn if cfg.family == "moe" else 0}
    expect = {name: 0 for name in KERNELS}
    for name, layers in n.items():
        expect[name] = fwd * layers * steps
        expect[f"{name}_bwd"] = layers * steps
    return expect


def first_step_grads(torch, forward_train, params, batch, cfg):
    """(loss, {name: gradient}) of one ``forward_train`` of ``cfg``."""
    loss, _ = forward_train(params, batch, cfg)
    names, tensors = zip(*params.named_parameters())
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss, tensors)))


def train_traced(card, torch, ops, dev, cfg, tag: str) -> dict:
    """Train ``cfg`` for ``TRAIN_R_STEPS`` steps through ``launch.train``,
    with every launch count set to 0 just before and read just after and
    held to ``expected_train_launches``; print the steady step time,
    tokens/s and peak memory; trace one warm step.  Returns the config
    trained (``device_model``'s), its losses, the launch counts, the
    figures, the batches and the optimizer, with the trained state freed."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train as launch_train
    from repro_torch.models import param_count
    from repro_torch.train import adamw, linear_warmup_cosine, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    res = launch_train.train(cfg, TRAIN_R_STEPS, B, S, device="cuda", log_every=1)
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    cfg = res.cfg
    expect = expected_train_launches(cfg, TRAIN_R_STEPS)
    log(f"[train] {tag}: kernel launches on the main path: {launches} ({TRAIN_R_STEPS} steps; "
        f"remat {cfg.remat}; expected {expect})")
    assert launches == expect, f"{cfg.arch_id} train: expected {expect} launches"
    assert (cfg.attn_impl, cfg.kernel_impl) == ("pallas", "pallas")
    assert len(res.losses) == TRAIN_R_STEPS and all(math.isfinite(x) for x in res.losses)
    steady = min(res.step_s[1:])
    n_params = param_count(res.state.params)
    log(f"[time] {tag} train step B={B} S={S} fp32, {n_params:,} parameters: first "
        f"{res.step_s[0]!r} s, steady (min of the other {TRAIN_R_STEPS - 1}) {steady!r} s "
        f"(steps {res.step_s}), {B * S / steady!r} tokens/s, peak device memory "
        f"{peak / 2**20:.1f} MiB {card}")

    data = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S, vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(x).to(dev) for k, x in data.batch_at(i).items()}
               for i in range(TRAIN_R_STEPS)]
    opt = adamw(linear_warmup_cosine(3e-4, 10, TRAIN_R_STEPS))   # launch.train's defaults
    kstep, held = make_train_step(cfg, opt), {"state": res.state}
    losses = res.losses
    # ``held`` alone keeps the trained state: a step makes new moments, and
    # for granite-moe the old ones kept alive beside them would not fit
    del res

    def one_step():
        held["state"], _ = kstep(held["state"], batches[0])

    one_step()                                                # warm-up
    trace(f"{tag} train step (warm)", one_step, card, ops)
    del held, kstep
    gc.collect()
    torch.cuda.empty_cache()
    return {"cfg": cfg, "losses": losses, "launches": launches, "batches": batches, "opt": opt,
            "figures": {"steady_step_s": steady, "tokens_per_s": B * S / steady,
                        "peak_bytes": peak, "params": n_params}}


def run_train_recurrent(card, torch, ops, dev, arch, n_layers) -> dict:
    """Phase 3c for one model: train it through ``launch.train`` with every
    launch count set to 0 just before and read just after; time it and
    trace one warm step; hold it against the plain path; on rwkv6 also
    measure how far one fp32 ulp on K2's outputs moves the first step's
    gradients, and hold K2's gradients on the model's own inputs against
    float64 (``wkv_bwd_precision``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as k2
    from repro_torch.models import forward_train, init_params
    from repro_torch.train import TrainState, make_train_step

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tag = f"{arch}" + (f" ({n_layers} of {get_config(arch).n_layers} layers)" if n_layers else "")
    run = train_traced(card, torch, ops, dev, cfg, tag)
    cfg, batches, opt, kernel_losses = run["cfg"], run["batches"], run["opt"], run["losses"]

    # the first step's gradients, kernel path and plain path, on the weights
    # launch.train drew (seed 0 on the same device); on rwkv6 the inputs of
    # the first and last K2 backward are kept for wkv_bwd_precision
    plain = dataclasses.replace(cfg, attn_impl="naive", kernel_impl="jnp", remat=True)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    kept = []   # the arguments of the first K2 backward (the last layer's) and the last one

    def keep(*a, **kw):
        kept[min(len(kept), 1):] = [[x.detach().clone() if torch.is_tensor(x) else x for x in a]]
        return real_bwd(*a, **kw)

    real_bwd = k2.rwkv6_scan_bwd_cuda
    with patched(k2, "rwkv6_scan_bwd_cuda", keep):
        first = {"kernel": first_step_grads(torch, forward_train, params, batches[0], cfg)}
    first["plain"] = first_step_grads(torch, forward_train, params, batches[0], plain)
    rel = {n: normwise(first["plain"][1][n], g) for n, g in first["kernel"][1].items()}
    worst = max(rel, key=rel.get)
    grad_err, median = rel[worst], statistics.median(rel.values())
    log(f"[train] {tag} first-step gradients, kernel path vs plain path, max abs err over "
        f"max(1, max |g|): {grad_err!r} ({worst}; median over the {len(rel)} parameters "
        f"{median!r}); loss {first['kernel'][0]!r} vs {first['plain'][0]!r}" +
        ("" if cfg.family == "ssm" else f" (limit {TRAIN_R_GRAD_TOL[arch]})"))
    f64 = {}
    if cfg.family == "ssm":
        f64 = check_grads_vs_f64(
            grads_vs_f64(torch, forward_train, params, batches[0], plain, first, tag), tag)
    else:
        assert grad_err <= TRAIN_R_GRAD_TOL[arch], \
            f"{arch} first-step gradient {worst}: {grad_err} > {TRAIN_R_GRAD_TOL[arch]}"
    del first
    gc.collect()
    torch.cuda.empty_cache()

    step = make_train_step(plain, opt)
    state = TrainState(params, opt.init(dict(params.named_parameters())), 0)
    plain_losses = []
    for b in batches:
        state, metrics = step(state, b)
        plain_losses.append(float(metrics["loss"]))
    loss_err = [abs(p - k) / max(1.0, abs(k)) for p, k in zip(plain_losses, kernel_losses)]
    log(f"[train] {tag} losses, kernel path {kernel_losses}, plain path {plain_losses}; "
        f"differences over max(1, |loss|) {loss_err} (tol {TRAIN_R_LOSS_TOL[arch]})")
    assert max(loss_err) <= TRAIN_R_LOSS_TOL[arch], f"{arch} losses differ: {loss_err}"
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    if kept:
        wkv_bwd_precision(torch, kept, cfg.rwkv_chunk)
    return {"launches": run["launches"], **run["figures"], "grad_rel_err": grad_err,
            "loss_rel_err": max(loss_err), **f64}


# Phase 3d: the moe family trained through ``launch.train`` at full width,
# fp32, B x S tokens a step, TRAIN_R_STEPS steps, on K4's forward and
# backward and K1's: granite-moe-3b-a800m (32 layers, d 1536, 24 heads / 8
# kv heads, 40 experts top-8, d_expert 512, vocab 49,155; 3.30 B parameters,
# 52.8 GB with their gradients and two AdamW moments) with remat, its
# config's own field: without it the einsum dispatch keeps about 1.4 GB a
# layer for the backward (disp_k (G,S,k,E,C) 336 MB, expert_in and
# expert_out 252 MB each, the hidden tensors), past the card over 32
# layers.  At full depth the first step's AdamW update ran out of the card
# (on an H100 80GB HBM3 at 700 W, 77.48 GiB allocated): it holds the
# parameters, gradients, clipped gradients and old and new moments, 28 B a
# parameter, 92.4 GB at 3.30 B.  So the depth is cut to TRAIN_MOE_LAYERS of
# 32: 26 layers, 2.69 B parameters, 75.4 GB at the update.  Kernel path
# against the plain path (``attn_impl="naive"``, ``kernel_impl="jnp"``,
# remat) on the same weights and batches, its routing
# teacher-forced to the kernel path's (``RoutingCheck``; each flip must be a
# near-tie within FLIP_GAP): the first step's gradient of every parameter,
# max |plain - kernel| over max(1, max |kernel|), both paths with remat so
# that their router calls line up, forward then recompute; and each step's
# loss, |plain - kernel| over max(1, |kernel|), the plain path's forward on
# the kernel path's weights of that step.  Not on a trajectory of its own,
# as phase 3c's plain path: AdamW's first update is about lr times the sign
# of each gradient, so an element whose gradient the two paths give within
# rounding of 0 moves by up to 2 lr apart, and the weights after it differ
# beyond rounding (on an H100: flips with plain-probability gaps up to
# 1.54e-4 in steps 1 and 2 against 3.10e-6 in step 0).
# Each limit is about 10x the largest reading on an H100: the first-step
# gradients 3.24e-6 (the first layer's router), the losses 8.59e-8: 3e-5
# and 1e-6.  The same training run again must repeat launch.train's losses
# within the loss limit (it read them bit for bit).
TRAIN_MOE, TRAIN_MOE_LAYERS = "granite-moe-3b-a800m", 26
TRAIN_MOE_GRAD_TOL, TRAIN_MOE_LOSS_TOL = 3e-5, 1e-6


def run_train_moe(card, torch, ops, dev) -> dict:
    """Phase 3d: train ``TRAIN_MOE`` through ``launch.train`` with every
    launch count set to 0 just before and read just after; time it and
    trace one warm step; hold its first step's gradients against the plain
    path, and then at each step of the same training its loss against the
    plain path's on the same weights, each time with the plain path's
    routing teacher-forced to the kernel path's."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward_train, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import TrainState, make_train_step

    full = get_config(TRAIN_MOE)
    cfg = dataclasses.replace(full, remat=True, n_layers=TRAIN_MOE_LAYERS)
    tag = f"{TRAIN_MOE} ({TRAIN_MOE_LAYERS} of {full.n_layers} layers)"
    run = train_traced(card, torch, ops, dev, cfg, tag)
    cfg, batches, opt, kernel_losses = run["cfg"], run["batches"], run["opt"], run["losses"]
    assert cfg.remat
    n_moe = cfg.n_layers

    # the first step's gradients, kernel path and plain path, on the weights
    # launch.train drew (seed 0 on the same device); the plain path's
    # routing teacher-forced to the kernel path's
    plain = dataclasses.replace(cfg, attn_impl="naive", kernel_impl="jnp")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    first_routing = RoutingCheck(torch, moe_mod)
    with patched(moe_mod, "_route", first_routing.record):
        first = {"kernel": first_step_grads(torch, forward_train, params, batches[0], cfg)}
    with patched(moe_mod, "_route", first_routing.forced):
        first["plain"] = first_step_grads(torch, forward_train, params, batches[0], plain)
    first_flips = first_routing.report(f"[train] {tag} first step", train_call(n_moe))
    rel = {n: normwise(first["plain"][1][n], g) for n, g in first["kernel"][1].items()}
    worst = max(rel, key=rel.get)
    grad_err, median = rel[worst], statistics.median(rel.values())
    routers = [n for n in rel if n.endswith("moe.router")]
    assert len(routers) == n_moe and all(float(first["kernel"][1][n].abs().max()) > 0
                                         for n in routers), "a router took no gradient"
    log(f"[train] {tag} first-step gradients, kernel path vs plain path, max abs err over "
        f"max(1, max |g|): {grad_err!r} ({worst}; median over the {len(rel)} parameters "
        f"{median!r}; the routers' at most {max(rel[n] for n in routers)!r}); loss "
        f"{first['kernel'][0]!r} vs {first['plain'][0]!r} (limit {TRAIN_MOE_GRAD_TOL})")
    assert grad_err <= TRAIN_MOE_GRAD_TOL, \
        f"{TRAIN_MOE} first-step gradient {worst}: {grad_err} > {TRAIN_MOE_GRAD_TOL}"
    del first
    gc.collect()
    torch.cuda.empty_cache()

    # the same training again, step by step: before each step the kernel
    # path's loss (its routing recorded) and the plain path's on the same
    # weights and batch, teacher-forced; then the kernel path's step
    step = make_train_step(cfg, opt)
    state = TrainState(params, opt.init(dict(params.named_parameters())), 0)
    routing = RoutingCheck(torch, moe_mod)
    losses = {"kernel": [], "plain": [], "step": []}
    for b in batches:
        with torch.no_grad():
            for path, c, check in (("kernel", cfg, routing.record),
                                   ("plain", plain, routing.forced)):
                with patched(moe_mod, "_route", check):
                    losses[path].append(float(forward_train(state.params, b, c)[1]["loss"]))
        state, metrics = step(state, b)
        losses["step"].append(float(metrics["loss"]))
    flips = routing.report(f"[train] {tag} {TRAIN_R_STEPS} steps' forwards",
                           train_call(n_moe, remat=False))
    loss_err = [abs(p - k) / max(1.0, abs(k)) for p, k in zip(losses["plain"], losses["kernel"])]
    again = [abs(a - k) / max(1.0, abs(k)) for a, k in zip(losses["step"], kernel_losses)]
    log(f"[train] {tag} losses at each step's weights, kernel path {losses['kernel']}, plain "
        f"path {losses['plain']}; differences over max(1, |loss|) {loss_err} (limit "
        f"{TRAIN_MOE_LOSS_TOL}); the same training's step losses {losses['step']} against "
        f"launch.train's {kernel_losses}: {again}")
    assert max(loss_err) <= TRAIN_MOE_LOSS_TOL, f"{TRAIN_MOE} losses differ: {loss_err}"
    assert max(again) <= TRAIN_MOE_LOSS_TOL, f"{TRAIN_MOE}: the training did not repeat: {again}"
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run["launches"], **run["figures"], "grad_rel_err": grad_err,
            "loss_rel_err": max(loss_err), "layers": cfg.n_layers, "routing_flips": flips,
            "first_step_routing_flips": first_flips}


def first_step_grads_f64(torch, forward_train, params, batch, cfg, noise_seed=None):
    """``first_step_grads`` in float64: ``params`` converted in place (and
    back to float32 after, which is exact), activations in float64, every
    ``.float()`` of a float64 tensor in the model left in float64, and the
    chunked WKV scan's initial state (zeros, fp32) in float64.  With
    ``noise_seed``, one fp32 ulp (2**-23) of relative noise drawn from it on
    every WKV output.
    Also, for each norm's scale and bias, the sum over the tokens of the
    absolute values of the terms its gradient sums ({name: (D,)}), from
    hooks on the norms.  Returns (loss, {name: gradient}, {name: sum})."""
    from repro_torch.models import rwkv6
    from repro_torch.models.layers import Norm

    cfg64 = dataclasses.replace(cfg, param_dtype="float64", activation_dtype="float64")
    real_float, real_wkv = torch.Tensor.float, rwkv6._wkv_chunked

    def keep64(t, *a, **kw):
        return t if t.dtype == torch.float64 else real_float(t, *a, **kw)

    gen = None if noise_seed is None else \
        torch.Generator(device=batch["tokens"].device).manual_seed(noise_seed)

    def wkv64(r, k, v, logw, u, state, chunk):
        y, s = real_wkv(r, k, v, logw, u, state.to(r.dtype), chunk)
        if gen is not None:
            y = y * (1 + 2.0 ** -23 * torch.randn(y.shape, generator=gen, device=y.device,
                                                   dtype=y.dtype))
        return y, s

    sums, hooks = {}, []

    def norm_hook(name, mod):
        def hook(_, inp, out):
            if name in sums or not out.requires_grad:   # remat runs the forward again
                return
            x = inp[0].detach()
            if mod.kind == "layernorm":
                x = x - x.mean(-1, keepdim=True)
            xhat = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + mod.eps)
            sums[f"{name}.scale"] = sums[f"{name}.bias"] = None

            def grad_hook(g):
                sums[f"{name}.scale"] = (g * xhat).abs().sum((0, 1))
                sums[f"{name}.bias"] = g.abs().sum((0, 1))
            out.register_hook(grad_hook)
        return hook

    params.double()
    try:
        for name, mod in params.named_modules():
            if isinstance(mod, Norm):
                hooks.append(mod.register_forward_hook(norm_hook(name, mod)))
        with patched(torch.Tensor, "float", keep64), patched(rwkv6, "_wkv_chunked", wkv64):
            loss, grads = first_step_grads(torch, forward_train, params, batch, cfg64)
    finally:
        for h in hooks:
            h.remove()
        params.float()
    return loss, grads, {n: x for n, x in sums.items() if x is not None and n in grads}


def grads_vs_f64(torch, forward_train, params, batch, plain, first, tag) -> dict:
    """The first step's gradient of every parameter on the kernel path and
    on the plain path (fp32, ``first``, emptied here) against the plain path
    in float64 (``first_step_grads_f64``): for each parameter max |g - g64|
    over max |g64|.  Logs the worst parameters (for the norms' among them,
    how much their sums over the tokens cancel: the sum of the terms'
    absolute values against the sum) and, layer by layer, the largest
    error on each path and how far one fp32 ulp of noise on the WKV outputs
    moves the float64 gradients (seed NOISE_SEEDS[0]).  Returns {"kernel":
    {name: e}, "plain": {...}}."""
    host = {path: {n: g.cpu() for n, g in gs.items()} for path, (_, gs) in first.items()}
    first.clear()
    gc.collect()
    torch.cuda.empty_cache()
    loss64, g64, sums = first_step_grads_f64(torch, forward_train, params, batch, plain)
    errs = {path: {} for path in host}
    for n, exact in g64.items():
        scale = float(exact.abs().max()) or 1.0   # a gradient that is 0 is 0 on every path
        for path, gs in host.items():
            errs[path][n] = float((gs[n].to(exact) - exact).abs().max()) / scale
    e_k, e_p = errs["kernel"], errs["plain"]
    log(f"[precision] {tag} first-step gradients of the {len(g64)} parameters against the "
        f"plain path in float64 (loss {loss64!r}), max |g - g64| over max |g64|")
    for n in sorted(e_k, key=e_k.get, reverse=True)[:F64_GRAD_SHOWN]:
        line = (f"[precision] {tag}   {n} (max |g64| {float(g64[n].abs().max())!r}): kernel "
                f"path {e_k[n]!r}, plain path {e_p[n]!r}")
        if n in sums:
            c = int((host["kernel"][n].to(g64[n]) - g64[n]).abs().argmax())
            line += (f"; a sum over {batch['tokens'].numel()} tokens, its terms' absolute "
                     f"values {float(sums[n].max() / g64[n].abs().max())!r} x max |g64| "
                     f"(worst channel {c}: {float(sums[n][c])!r} against the sum "
                     f"{float(g64[n][c])!r})")
        log(line)
    del host, sums
    g64 = {n: g.cpu() for n, g in g64.items()}
    gc.collect()
    torch.cuda.empty_cache()
    _, moved, _ = first_step_grads_f64(torch, forward_train, params, batch, plain,
                                       noise_seed=NOISE_SEEDS[0])
    shift = {n: float((g.cpu() - g64[n]).abs().max()) / (float(g64[n].abs().max()) or 1.0)
             for n, g in moved.items()}
    del moved, g64
    gc.collect()
    torch.cuda.empty_cache()
    top = max(shift, key=shift.get)
    log(f"[precision] {tag}: one fp32 ulp of relative noise on every WKV output (seed "
        f"{NOISE_SEEDS[0]}) moves the float64 gradients by up to {shift[top]!r} ({top}; median "
        f"{statistics.median(shift.values())!r}) of max |g64|")
    layers = {}
    for n in shift:
        layers.setdefault(layer_of(n), []).append(n)
    log(f"[precision] {tag} by layer (None: embedding, final norm, head), the largest e on the "
        f"kernel path / on the plain path / of the float64 gradients under that noise: " +
        ", ".join(f"{i}: {max(e_k[n] for n in ns):.3g} / {max(e_p[n] for n in ns):.3g} / "
                  f"{max(shift[n] for n in ns):.3g}"
                  for i, ns in sorted(layers.items(), key=lambda kv: (kv[0] is None, kv[0] or 0))))
    return errs


def layer_of(name: str):
    """The layer of a parameter's name (``stack.<segment>.<block>.<layer>.``),
    or None for the embedding, the final norm and the head."""
    parts = name.split(".")
    return int(parts[3]) if parts[0] == "stack" and len(parts) > 4 else None


def check_grads_vs_f64(errs, tag) -> dict:
    """Holds ``grads_vs_f64``'s errors to the limits of F64_GRAD_FACTOR (see
    phase 3c's note); returns the figures for the kernels line."""
    e_k, e_p = errs["kernel"], errs["plain"]
    resolved = [n for n in e_p if e_p[n] <= F64_RESOLVED]
    ratio = {n: e_k[n] / max(e_p[n], F64_GRAD_FLOOR) for n in resolved}
    worst = max(ratio, key=ratio.get)
    med = {path: statistics.median(e.values()) for path, e in errs.items()}
    log(f"[precision] {tag}: {len(resolved)} of {len(e_p)} parameters resolved in fp32 (plain "
        f"path within {F64_RESOLVED} of float64); among them the largest e_kernel / "
        f"max(e_plain, {F64_GRAD_FLOOR}) {ratio[worst]!r} ({worst}: {e_k[worst]!r} / "
        f"{e_p[worst]!r}); median e over all, kernel path {med['kernel']!r}, plain path "
        f"{med['plain']!r} (limit {F64_GRAD_FACTOR}x for both)")
    assert ratio[worst] <= F64_GRAD_FACTOR, f"{tag}: {worst} {e_k[worst]} vs {e_p[worst]}"
    assert med["kernel"] <= F64_GRAD_FACTOR * med["plain"], f"{tag}: medians {med}"
    return {"grad_rel_err_f64_resolved": e_k[worst], "grad_f64_resolved": len(resolved),
            "grad_rel_err_f64_median": med["kernel"], "plain_grad_rel_err_f64_median": med["plain"]}


def wkv_bwd_precision(torch, kept, chunk) -> None:
    """K2's backward, the plain chunked scan's autograd and the plain
    sequential backward, each on the inputs and dy of the first and last K2
    backward of an rwkv6 train step, against autograd of the recurrence in
    float64 (``wkv_f64``).  Fails if any of K2's gradients is more than
    ``K2_PRECISION_FACTOR`` times as far from float64 as the plain chunked
    scan's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as k2
    from repro_torch.models.rwkv6 import _wkv_chunked

    def grads_of(fn, dtype, xs, dy):
        leaves = [x.detach().to(dtype).requires_grad_() for x in xs]
        y, _ = fn(*leaves)
        return torch.autograd.grad(y, leaves, dy.to(y.dtype))

    for which, args in zip(("last layer", "first layer"), kept):
        r, k, v, logw, u, s0, states, dy = args[:8]
        xs = (r, k, v, logw, u, s0)
        g64 = grads_of(lambda *a: wkv_f64(torch, *a), torch.float64, xs, dy)
        runs = {"kernel": k2.rwkv6_scan_bwd_cuda(*xs, states, dy, None, chunk=chunk),
                "plain chunked": grads_of(lambda *a: _wkv_chunked(*a, chunk), torch.float32,
                                          xs, dy),
                "plain sequential": ref.rwkv6_scan_bwd_ref(*xs, dy)}
        rel = {name: {n: float((a.double() - b).abs().max() / b.abs().max())
                      for n, a, b in zip(RWKV_GRADS, gs, g64)} for name, gs in runs.items()}
        del runs
        log(f"[precision] rwkv6 train, K2 backward of the {which}: max abs err vs float64 over "
            f"max |g| (max |g|: { {n: float(b.abs().max()) for n, b in zip(RWKV_GRADS, g64)} }): "
            f"{rel}")
        for n in RWKV_GRADS:
            ratio = rel["kernel"][n] / rel["plain chunked"][n]
            log(f"[precision] rwkv6 train {which} {n}: kernel / plain chunked {ratio!r} "
                f"(limit {K2_PRECISION_FACTOR})")
            assert ratio <= K2_PRECISION_FACTOR, (which, n, rel)


# The sweep phase (3b): the paper's workload, an ASHA sweep of TRAIN_ARCH at
# full width through ``repro_torch.launch.tune`` on the serial executor, 4
# trials resident at once (8 virtual devices, 2 a trial); then the first
# trial's config alone on the process executor for SWEEP_PROCESS_ITERS
# iterations, in a worker forked from the port's own forkserver, so CUDA
# starts fresh there.  Its losses must be the serial trial's at the same
# iterations within TRAIN_LOSS_TOL (same weights, data and kernels), and the
# device memory in use after the sweep within SWEEP_MEM_SLACK of before it:
# a stopped trial holds none.
SWEEP_ARGS = ("--arch", TRAIN_ARCH, "--scheduler", "asha", "--num-samples", "4",
              "--max-iters", "4", "--batch", str(B), "--seq-len", str(S),
              "--steps-per-iter", "2", "--executor", "serial", "--total-devices", "8",
              "--devices-per-trial", "2", "--seed", "0", "--device", "cuda")
SWEEP_PROCESS_ITERS = 2
SWEEP_MEM_SLACK = 64 * 2**20


def sweep_spans(events) -> dict:
    """{span name: (count, seconds)} of a control-plane trace's complete
    events (Chrome trace-event JSON, microseconds)."""
    out = {}
    for e in events:
        if e.get("ph") == "X":
            n, s = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, s + e["dur"] / 1e6)
    return out


def run_sweep(card: str, torch, ops) -> dict:
    """Phase 3b: the sweep, with every launch count set to 0 just before and
    read just after, its trace's summary, and the process trial."""
    import os
    import shutil
    import tempfile

    from repro_torch.launch import tune

    args = tune.parser().parse_args(SWEEP_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # A log directory gives the object store a spill surface and mirrors
    # every checkpoint to disk: at full width one checkpoint (parameters and
    # two AdamW moments, 1.6 GB) is most of the store's 2 GiB, and without
    # one the second is refused.
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "sweep_trace.json")
        for name in KERNELS:
            getattr(ops, name).launches = 0
        t0 = time.perf_counter()
        analysis = tune.main([*SWEEP_ARGS, "--trace", trace_path,
                              "--log-dir", os.path.join(tmp, "sweep")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(ops, name).launches for name in KERNELS}
        with open(trace_path) as f:
            spans = sweep_spans(json.load(f)["traceEvents"])
        free_gb = shutil.disk_usage(tmp).free / 1e9
        peak = torch.cuda.max_memory_allocated()
        proc = run_process_trial(args, analysis.trials[0], os.path.join(tmp, "process"))
    trials = analysis.trials
    steps = sum(t.training_iteration for t in trials) * args.steps_per_iter
    n_attn = sum(t in ("attention", "local_attn")
                 for t in tune.sweep_model(args).pattern_for_layers())
    finished = sum(t.status.value == "TERMINATED" for t in trials)
    step_s = spans.get("step", (0, 0.0))[1]
    log(f"[sweep] {TRAIN_ARCH} ASHA sweep ({' '.join(SWEEP_ARGS)}): {finished} of "
        f"{len(trials)} trials finished in {wall!r} s wall, {finished * 3600 / wall!r} "
        f"trials/hour {card}")
    for t in trials:
        p = t.profile or {}
        log(f"[sweep]   {t.trial_id} {t.status.value}: {t.training_iteration} iterations, "
            f"steady step {p.get('steady_step_s')!r} s, first step {p.get('first_step_s')!r} s, "
            f"losses {[r.metrics['loss'] for r in t.results]} {card}")
        if t.error:
            log(f"[sweep]   {t.trial_id} error: {t.error}")
    for name, (n, s) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"[sweep]   trace span {name}: {n} spans, {s!r} s {card}")
    log(f"[sweep] control plane's share of the sweep's wall time, 1 - (trial-step spans "
        f"{step_s!r} s) / (wall {wall!r} s): {1 - step_s / wall!r} {card}")
    log(f"[sweep] kernel launches on the sweep's path: {launches} ({steps} steps in the "
        f"parent; {n_attn} attention layers a step); {free_gb:.1f} GB left on the log "
        f"directory's disk at the sweep's end")
    assert finished == len(trials) == 4, "every trial of the sweep must end TERMINATED"
    expect = expected_train_launches(tune.sweep_model(args), steps)
    assert launches == expect, f"sweep: expected {expect} launches"
    first = trials[0]
    serial_losses = {r.training_iteration: r.metrics["loss"] for r in first.results}
    losses = {config_key(t.config): {r.training_iteration: r.metrics["loss"] for r in t.results}
              for t in trials}
    del analysis, trials, t
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    log(f"[sweep] device memory: peak {peak / 2**20:.1f} MiB; allocated before the sweep "
        f"{before / 2**20:.1f} MiB, after {after / 2**20:.1f} MiB {card}")
    assert abs(after - before) <= SWEEP_MEM_SLACK, "a stopped trial still holds device memory"

    log(f"[sweep] process trial {proc['config']}: {proc['iterations']} iterations in "
        f"{proc['wall_s']!r} s wall (forkserver, CUDA context, model and kernel loads "
        f"included); first step {proc['first_step_s']!r} s, steady step "
        f"{proc['steady_step_s']!r} s {card}")
    gaps = {i: abs(loss - serial_losses[i]) / max(1.0, abs(serial_losses[i]))
            for i, loss in proc["losses"].items() if i in serial_losses}
    log(f"[sweep] process trial losses {proc['losses']} against the serial trial's "
        f"{serial_losses}: differences over max(1, |loss|) {gaps} (tol {TRAIN_LOSS_TOL}) {card}")
    assert gaps and max(gaps.values()) <= TRAIN_LOSS_TOL, f"process trial's losses differ: {gaps}"
    return {"launches": launches, "wall_s": wall, "trials_per_hour": finished * 3600 / wall,
            "control_plane_share": 1 - step_s / wall, "peak_bytes": peak,
            "process_first_step_s": proc["first_step_s"], "process_loss_gap": max(gaps.values()),
            "losses": losses}


def config_key(config) -> str:
    """A trial's hyperparameters, without the executor's own keys, as a key."""
    return json.dumps({k: v for k, v in config.items() if not k.startswith("_")},
                      sort_keys=True)


def run_process_trial(args, trial, log_dir: str) -> dict:
    """``trial``'s config alone on the process executor under FIFO, for
    SWEEP_PROCESS_ITERS iterations of the sweep's workload."""
    from repro_torch.core import FIFOScheduler, Resources, run_experiments
    from repro_torch.dist.submesh import SlicePool
    from repro_torch.launch import tune
    from repro_torch.train.trainable import model_trainable_factory

    hp = {k: v for k, v in trial.config.items() if not k.startswith("_")}
    factory = model_trainable_factory(tune.sweep_model(args), **tune.workload(args))
    t0 = time.perf_counter()
    # No checkpoints: the sweep measured them, and this trial is here for
    # its fresh CUDA context and its losses.
    run = run_experiments(factory, hp, scheduler=FIFOScheduler(metric="loss", mode="min"),
                          stop={"training_iteration": SWEEP_PROCESS_ITERS},
                          resources_per_trial=Resources(cpu=1, devices=args.devices_per_trial),
                          total_devices=args.total_devices,
                          slice_pool=SlicePool(n_virtual=args.total_devices),
                          executor="process", checkpoint_freq=0, log_dir=log_dir, seed=0)
    wall = time.perf_counter() - t0
    (pt,) = run.trials
    assert pt.status.value == "TERMINATED", f"process trial: {pt.status.value} {pt.error}"
    p = pt.profile or {}
    return {"config": hp, "iterations": pt.training_iteration, "wall_s": wall,
            "first_step_s": p.get("first_step_s"), "steady_step_s": p.get("steady_step_s"),
            "losses": {r.training_iteration: r.metrics["loss"] for r in pt.results}}


def with_flags(args, **flags) -> tuple:
    """``args`` with the value of each ``--flag`` in ``flags`` (underscores read
    as dashes) replaced, or the flag appended."""
    out = list(args)
    for name, value in flags.items():
        flag = "--" + name.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return tuple(out)


# The cluster phase (3e): phase 3b's sweep on the cluster tier, through
# ``repro_torch.launch.tune`` in-process with ``--executor cluster``: a roster
# of two simulated hosts of 4 virtual devices (3b's pool of 8), placement
# fixed at 2 devices a trial, so two trials a host and all four at once.  Each
# trial is a socket worker forked from the port's own forkserver (whose image
# never touched CUDA) that dials the controller back over loopback TCP and
# trains on the card through the kernels; each checkpoint is
# content-addressed, spilled to its host's directory and fetched to the
# controller before it is adopted.  The parent's launch counters never see a
# worker's launches, so the worker's trainable is the launcher's own class,
# subclassed to report with each result the launches each kernel wrapper
# counted in that worker during the step (``counted_model_trainable``).
# Then a worker failure: the first config alone (FIFO, 4 iterations, a
# checkpoint each, --max-failures 1) on two hosts of 2 devices, its worker
# SIGKILLed when the controller adopts its second checkpoint; the trial must
# restart from that checkpoint, fetched back across the controller's store,
# and end with one failure.  Losses are held, within TRAIN_LOSS_TOL, against
# an uninterrupted serial run of the sweep's four configs for 4 iterations
# with no checkpoints, which must itself equal 3b's trials where they ran.
CLUSTER_SWEEP_ARGS = with_flags(SWEEP_ARGS, executor="cluster", hosts="2x4",
                                placement="fixed", metrics_interval=60)
FAILURE_ARGS = with_flags(SWEEP_ARGS, scheduler="fifo", num_samples=1, executor="cluster",
                          hosts="2x2", placement="fixed", max_failures=1)
FAILURE_KILL_AFTER = 2
WORKER_NAMES = ("repro-worker-", "repro-cluster-worker-")


def counted_model_trainable(model_cfg, **workload):
    """``make_model_trainable``'s class, whose results also carry the
    launches each kernel wrapper counted in this process during the step."""
    from repro_torch.kernels import ops
    from repro_torch.train.trainable import make_model_trainable

    base = make_model_trainable(model_cfg, **workload)

    class Counted(base):
        def step(self):
            before = {name: getattr(ops, name).launches for name in KERNELS}
            out = super().step()
            out.update({f"launches.{name}": getattr(ops, name).launches - before[name]
                        for name in KERNELS})
            return out

    Counted.__name__ = Counted.__qualname__ = base.__name__
    return Counted


def counted_factory(model_cfg, **workload):
    """``model_trainable_factory``'s recipe for ``counted_model_trainable``,
    which a worker process rebuilds by importing this script."""
    from repro_torch.core import TrainableFactory

    return TrainableFactory(target="chip_smoke:counted_model_trainable",
                            kwargs={"model_cfg": model_cfg, **workload}, call=True,
                            sys_path=(str(ROOT),))


def worker_launches(trials) -> dict:
    """Each kernel's launches over every result of ``trials``."""
    return {name: sum(int(r.metrics.get(f"launches.{name}", 0))
                      for t in trials for r in t.results) for name in KERNELS}


@contextlib.contextmanager
def killing_worker_after_checkpoint(n: int, record: dict):
    """Inside the block, the controller's adoption of a trial's ``n``-th
    checkpoint SIGKILLs that trial's socket worker at once, from the
    controller, before a later checkpoint can be adopted.  ``record`` gets
    the trial, the pid and the wall time of the kill, then of the
    controller's steps that follow: when its pump saw the worker's end
    (``death_seen``), and the start and seconds of the runner's requeue
    (``requeue``, which reaps the killed process) and of the controller's
    export copy of the checkpoint for the new worker (``export``)."""
    import multiprocessing as mp
    import os
    import signal

    from repro_torch.core.checkpoint import CheckpointManager
    from repro_torch.core.process_executor import ProcessMeshExecutor

    adopt, export_copy = CheckpointManager.adopt, CheckpointManager.export_copy
    on_death, requeue = ProcessMeshExecutor._on_worker_death, ProcessMeshExecutor.requeue_trial

    def adopt_then_kill(self, trial_id, iteration, store_key):
        ckpt = adopt(self, trial_id, iteration, store_key)
        if iteration == n and "pid" not in record:
            (proc,) = [p for p in mp.active_children()
                       if p.name == f"repro-cluster-worker-{trial_id}"]
            record.update(trial_id=trial_id, pid=proc.pid, t=time.time())
            os.kill(proc.pid, signal.SIGKILL)
        return ckpt

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            if "pid" in record:
                record.setdefault(name, (t0, time.time() - t0))
            return out
        return call

    def seen(self, ws):
        if "pid" in record:
            record.setdefault("death_seen", time.time())
        return on_death(self, ws)

    with patched(CheckpointManager, "adopt", adopt_then_kill), \
            patched(CheckpointManager, "export_copy", timed("export", export_copy)), \
            patched(ProcessMeshExecutor, "_on_worker_death", seen), \
            patched(ProcessMeshExecutor, "requeue_trial", timed("requeue", requeue)):
        yield record


@contextlib.contextmanager
def timed_fetches(record: list):
    """Inside the block, each cross-host fetch of the cluster executor is
    timed into ``record``: key, direction, start, seconds and bytes."""
    import os
    from pathlib import PurePath

    from repro_torch.cluster import executor as cluster_executor

    fetch = cluster_executor.fetch

    def timed(key, src, dst):
        t0 = time.time()
        out = fetch(key, src, dst)
        to = "host" if "hosts" in PurePath(dst.spill_dir or "").parts else "controller"
        record.append({"key": key, "to": to, "t": t0, "s": time.time() - t0,
                       "bytes": os.path.getsize(dst._spill_path(key))})
        return out

    with patched(cluster_executor, "fetch", timed):
        yield record


def live_workers() -> list:
    """Pids of trial worker processes still alive: this process's children
    of that name, and the children of the port's forkserver."""
    import multiprocessing as mp
    import os

    from repro_torch.core import workers

    pids = {p.pid for p in mp.active_children() if p.name.startswith(WORKER_NAMES)}
    server = getattr(workers._DEFAULT_CTX, "server", None)
    parent = getattr(server, "_forkserver_pid", None)
    for status in Path("/proc").glob("[0-9]*/status") if parent else ():
        try:
            fields = dict(line.split(":\t", 1) for line in status.read_text().splitlines()
                          if ":\t" in line)
        except OSError:
            continue
        if fields.get("PPid", "").strip() == str(parent) and not fields.get(
                "State", "").startswith("Z"):
            pids.add(int(status.parent.name))
    return sorted(pids - {os.getpid()})


def adopt_orphans() -> bool:
    """Make this process the reaper of its orphaned descendants (Linux
    ``PR_SET_CHILD_SUBREAPER``): a worker whose forkserver has exited comes
    back to this process, not to init, so ``stop_started_processes`` still
    finds it below this process.  False where the kernel refuses."""
    import ctypes

    return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0


def descendants(pid: int) -> dict:
    """{pid: command line} of every process below ``pid`` in the process
    tree, zombies included, from /proc."""
    children = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:
            continue
        ppid = int(text[text.rindex(")") + 2:].split()[1])
        children.setdefault(ppid, []).append(int(stat.parent.name))
    out, todo = {}, [pid]
    while todo:
        for child in children.get(todo.pop(), ()):
            try:
                cmd = (Path("/proc") / str(child) / "cmdline").read_bytes()
            except OSError:
                cmd = b""
            out[child] = cmd.replace(b"\0", b" ").decode(errors="replace").strip()
            todo.append(child)
    return out


def _gone(pid: int) -> bool:
    """Reap ``pid`` if it is this process's child and has ended; whether it
    no longer runs (ended, or a zombie that its own parent will reap)."""
    import os

    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        try:
            text = (Path("/proc") / str(pid) / "stat").read_text()
        except OSError:
            return True
        return text[text.rindex(")") + 2] in "ZX"


def _stop_pid(pid: int, grace_s: float, sig=None) -> None:
    """Send ``sig`` (if any) to ``pid``; SIGKILL it if it still runs after
    ``grace_s``; return once it no longer runs."""
    import os
    import signal

    for s, wait_s in ((sig, grace_s), (signal.SIGKILL, 60.0)):
        if s is not None:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, s)
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if _gone(pid):
                return
            time.sleep(0.02)
    raise RuntimeError(f"process {pid} still runs after SIGKILL")


def _close_helper(obj, fd_attr: str, pid_attr: str, grace_s: float) -> None:
    """Stop a multiprocessing helper process (a forkserver, the resource
    tracker) as its own ``_stop`` does: close the pipe it waits on, so it
    exits, and wait for it."""
    import os

    pid, fd = getattr(obj, pid_attr, None), getattr(obj, fd_attr, None)
    if pid is None:
        return
    if fd is not None:
        with contextlib.suppress(OSError):
            os.close(fd)
    setattr(obj, fd_attr, None)
    setattr(obj, pid_attr, None)
    _stop_pid(pid, grace_s)


def stop_started_processes(grace_s: float = 10.0) -> dict:
    """Stop every process this script started, and wait for each to end: the
    trial workers still registered with ``multiprocessing``, the port's
    forkserver and ``multiprocessing``'s own, its resource tracker (which
    ends only once the forkservers and every worker have closed its pipe),
    then anything else still below this process, SIGTERM then SIGKILL.
    Returns {pid: command line} of that last group: a clean run leaves none.
    Safe to call again, and where none of these was started."""
    import multiprocessing as mp
    import os
    import signal
    from multiprocessing import forkserver, resource_tracker

    for p in mp.active_children():
        with contextlib.suppress(ProcessLookupError):
            p.terminate()
        p.join(grace_s)
        if p.exitcode is None:
            p.kill()
            p.join(grace_s)
    workers = sys.modules.get("repro_torch.core.workers")
    port_server = getattr(getattr(workers, "_DEFAULT_CTX", None), "server", None)
    for server in (port_server, forkserver._forkserver):
        if server is not None:
            _close_helper(server, "_forkserver_alive_fd", "_forkserver_pid", grace_s)
    _close_helper(resource_tracker._resource_tracker, "_fd", "_pid", grace_s)
    left = descendants(os.getpid())
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
    for pid in left:
        _stop_pid(pid, grace_s)
    for pid in descendants(os.getpid()):        # zombies handed to this reaper meanwhile
        _stop_pid(pid, grace_s, signal.SIGKILL)
    return left


class DeviceMemorySampler:
    """The card's memory in use by every process, sampled from
    ``torch.cuda.mem_get_info`` on a thread while the block runs."""

    def __init__(self, torch, every_s: float = 0.05):
        import threading

        self.torch, self.every_s = torch, every_s
        self.peak_used = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="mem-sampler", daemon=True)

    def _run(self):
        while not self._stop.is_set():
            free, total = self.torch.cuda.mem_get_info()
            self.peak_used = max(self.peak_used, total - free)
            self._stop.wait(self.every_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def free_device_memory(torch) -> int:
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def trace_rows(events) -> dict:
    """{trial id: its complete events, in time order} of a control-plane
    trace (Chrome trace-event JSON; row 0 is the control plane's own)."""
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    out = {}
    for e in events:
        if e.get("ph") == "X":
            out.setdefault(names.get(e["tid"], ""), []).append(e)
    for rows in out.values():
        rows.sort(key=lambda e: e["ts"])
    return out


def last_metrics(path) -> dict:
    """The last snapshot of a run's metrics stream (``metrics.jsonl``)."""
    lines = Path(path).read_text().splitlines()
    return json.loads(lines[-1])["metrics"] if lines else {}


def serial_reference(args) -> dict:
    """{config key: {iteration: loss}} of the sweep's configs run
    uninterrupted on the serial executor under FIFO for every iteration,
    without checkpoints, in this process."""
    from repro_torch.core import FIFOScheduler, Resources, run_experiments
    from repro_torch.dist.submesh import SlicePool
    from repro_torch.launch import tune
    from repro_torch.train.trainable import make_model_trainable

    run = run_experiments(make_model_trainable(tune.sweep_model(args), **tune.workload(args)),
                          tune.SPACE, scheduler=FIFOScheduler(metric="loss", mode="min"),
                          num_samples=args.num_samples,
                          stop={"training_iteration": args.max_iters},
                          resources_per_trial=Resources(cpu=1, devices=args.devices_per_trial),
                          total_devices=args.total_devices,
                          slice_pool=SlicePool(n_virtual=args.total_devices),
                          executor="serial", checkpoint_freq=0, seed=args.seed)
    assert {t.status.value for t in run.trials} == {"TERMINATED"}
    return {config_key(t.config): {r.training_iteration: r.metrics["loss"] for r in t.results}
            for t in run.trials}


def loss_gaps(losses: dict, reference: dict) -> dict:
    """{iteration: |loss - reference| / max(1, |reference|)}; every
    iteration of ``losses`` must be in ``reference``."""
    return {i: abs(x - reference[i]) / max(1.0, abs(reference[i])) for i, x in losses.items()}


def run_cluster(card: str, torch, sweep: dict) -> dict:
    """Phase 3e: the sweep on the cluster tier, then a worker killed after
    its second checkpoint; see the constants above."""
    import os
    import shutil
    import tempfile

    from repro_torch.launch import tune

    args = tune.parser().parse_args(CLUSTER_SWEEP_ARGS)
    t0 = time.perf_counter()
    reference = serial_reference(args)
    log(f"[cluster] uninterrupted serial reference, {args.num_samples} configs x "
        f"{args.max_iters} iterations without checkpoints: {time.perf_counter() - t0!r} s "
        f"{card}")
    assert set(reference) == set(sweep["losses"]), "the reference runs other configs than 3b"
    for key, losses in sweep["losses"].items():
        gaps = loss_gaps(losses, reference[key])
        log(f"[cluster]   3b's trial {key}: differences from the reference {gaps}")
        assert max(gaps.values()) <= TRAIN_LOSS_TOL, f"3b's trial differs from the reference: {gaps}"

    # (i) the sweep, four socket workers at once
    before = free_device_memory(torch)
    fetches = []
    with tempfile.TemporaryDirectory() as tmp:
        log(f"[cluster] {shutil.disk_usage(tmp).free / 1e9:.1f} GB free on the log directory's "
            f"disk before the sweep")
        trace_path = os.path.join(tmp, "cluster_trace.json")
        log_dir = os.path.join(tmp, "cluster")
        with patched(tune, "model_trainable_factory", counted_factory), \
                timed_fetches(fetches), DeviceMemorySampler(torch) as mem:
            t0 = time.perf_counter()
            analysis = tune.main([*CLUSTER_SWEEP_ARGS, "--trace", trace_path,
                                  "--log-dir", log_dir])
            wall = time.perf_counter() - t0
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        fetch_us = last_metrics(os.path.join(log_dir, "metrics.jsonl")).get("cluster.fetch_us")
        log(f"[cluster] {shutil.disk_usage(tmp).free / 1e9:.1f} GB free on the log directory's "
            f"disk after the sweep")
    alive = live_workers()
    after = free_device_memory(torch)
    for _ in range(100):            # a process's memory is returned as it is reaped
        if abs(after - before) <= SWEEP_MEM_SLACK:
            break
        time.sleep(0.1)
        after = free_device_memory(torch)
    trials = analysis.trials
    finished = sum(t.status.value == "TERMINATED" for t in trials)
    spans, rows = sweep_spans(events), trace_rows(events)
    step_s = spans.get("step", (0, 0.0))[1]
    steps = sum(t.training_iteration for t in trials) * args.steps_per_iter
    launches = worker_launches(trials)
    log(f"[cluster] {TRAIN_ARCH} ASHA sweep on the cluster tier ({' '.join(CLUSTER_SWEEP_ARGS)}):"
        f" {finished} of {len(trials)} trials finished in {wall!r} s wall, "
        f"{finished * 3600 / wall!r} trials/hour; phase 3b on the serial executor: "
        f"{sweep['wall_s']!r} s, {sweep['trials_per_hour']!r} trials/hour {card}")
    for t in trials:
        p = t.profile or {}
        place = [e["args"] for e in rows.get(t.trial_id, []) if e["name"] == "host.place"]
        log(f"[cluster]   {t.trial_id} {t.status.value} on {[a.get('host') for a in place]}: "
            f"{t.training_iteration} iterations, first step {p.get('first_step_s')!r} s, "
            f"steady step {p.get('steady_step_s')!r} s, losses "
            f"{[r.metrics['loss'] for r in t.results]} {card}")
        if t.error:
            log(f"[cluster]   {t.trial_id} error: {t.error}")
    for name, (n, s) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"[cluster]   trace span {name}: {n} spans, {s!r} s {card}")
    log(f"[cluster] control plane's share of the sweep's wall time, 1 - (trial-step spans "
        f"{step_s!r} s) / (wall {wall!r} s): {1 - step_s / wall!r} (the four workers' steps "
        f"overlap on the card) {card}")
    log(f"[cluster] fetch histogram cluster.fetch_us (host to controller): {fetch_us} {card}")
    for f in fetches:
        log(f"[cluster]   fetch to the {f['to']} {f['key'][:24]}...: {f['s']!r} s, "
            f"{f['bytes']} bytes {card}")
    log(f"[cluster] card memory in use by every process: peak {mem.peak_used / 2**20:.1f} MiB "
        f"(mem_get_info every 50 ms); free before the sweep {before / 2**20:.1f} MiB, after "
        f"{after / 2**20:.1f} MiB {card}")
    log(f"[cluster] kernel launches in the workers: {launches} ({steps} steps; live workers "
        f"after the sweep: {alive})")
    assert finished == len(trials) == 4, "every trial of the cluster sweep must end TERMINATED"
    expect = expected_train_launches(tune.sweep_model(args), steps)
    assert launches == expect, f"cluster sweep: expected {expect} launches in the workers"
    for t in trials:
        gaps = loss_gaps({r.training_iteration: r.metrics["loss"] for r in t.results},
                         reference[config_key(t.config)])
        log(f"[cluster]   {t.trial_id} losses against the reference: differences over "
            f"max(1, |loss|) {gaps} (tol {TRAIN_LOSS_TOL})")
        assert max(gaps.values()) <= TRAIN_LOSS_TOL, f"{t.trial_id}'s losses differ: {gaps}"
    assert not alive, f"worker processes outlived the sweep: {alive}"
    assert abs(after - before) <= SWEEP_MEM_SLACK, "a worker's memory was not returned"
    out = {"launches": launches, "wall_s": wall, "trials_per_hour": finished * 3600 / wall,
           "control_plane_share": 1 - step_s / wall, "peak_used_bytes": mem.peak_used,
           "fetch_us": fetch_us}
    del analysis, trials

    # (ii) the worker of a lone trial SIGKILLed after its second checkpoint
    first = next(iter(sweep["losses"]))
    killed, fetches = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "failure_trace.json")
        with killing_worker_after_checkpoint(FAILURE_KILL_AFTER, killed), \
                timed_fetches(fetches):
            analysis = tune.main([*FAILURE_ARGS, "--trace", trace_path,
                                  "--log-dir", os.path.join(tmp, "failure")])
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        with open(os.path.join(tmp, "failure", "events.jsonl")) as f:
            restarts = [e for e in map(json.loads, f) if e.get("event") == "restarted"]
    (t,) = analysis.trials
    rows = trace_rows(events)[t.trial_id]
    its = [r.training_iteration for r in t.results]
    log(f"[cluster] worker failure ({' '.join(FAILURE_ARGS)}): {t.trial_id} {t.status.value}, "
        f"{t.num_failures} failure(s), iterations reported {its}; worker {killed.get('pid')} "
        f"SIGKILLed when checkpoint {FAILURE_KILL_AFTER} was adopted; restarted from "
        f"iteration {[e['info']['checkpoint_iteration'] for e in restarts]} on hosts "
        f"{[e['args'].get('host') for e in rows if e['name'] == 'host.place']} {card}")
    if t.error:
        log(f"[cluster]   {t.trial_id} error: {t.error}")
    assert config_key(t.config) == first, "the lone trial is not 3b's first config"
    assert t.status.value == "TERMINATED" and t.num_failures == 1, (t.status, t.num_failures)
    assert killed and [e["info"]["checkpoint_iteration"] for e in restarts] == [FAILURE_KILL_AFTER]
    assert its[:FAILURE_KILL_AFTER] == list(range(1, FAILURE_KILL_AFTER + 1))
    assert min(its[FAILURE_KILL_AFTER:]) > FAILURE_KILL_AFTER and its[-1] == args.max_iters, its
    split = restart_split(rows, killed, fetches)
    log(f"[cluster] restart, seconds from the kill to the end of the first step after it: "
        f"{split} {card}")
    gaps = loss_gaps({r.training_iteration: r.metrics["loss"] for r in t.results
                      if r.training_iteration > FAILURE_KILL_AFTER}, reference[first])
    log(f"[cluster] restarted trial's losses after the kill against the reference: "
        f"differences over max(1, |loss|) {gaps} (tol {TRAIN_LOSS_TOL}) {card}")
    assert sorted(gaps) == list(range(FAILURE_KILL_AFTER + 1, args.max_iters + 1))
    assert max(gaps.values()) <= TRAIN_LOSS_TOL, f"the restarted trial's losses differ: {gaps}"
    assert not live_workers(), "worker processes outlived the failure run"
    out["restart"] = split
    return out


def restart_split(rows, killed: dict, fetches: list) -> dict:
    """Seconds from the kill to the end of the first step after the
    restart, in turn: ``exit`` (the kill to the controller seeing the
    worker's end), ``to_requeue`` (to the runner's requeue), ``requeue``
    (reaping the dead worker), ``to_export`` (placing the trial again),
    ``export_copy`` (the controller's private copy of the checkpoint),
    ``fetch_to_host`` (that copy to the host's spill directory),
    ``fork_and_dial`` (the new worker forked from the forkserver, its
    imports, its dial-in), ``spawn_and_context`` (its build span less the
    restore: the trainable and its CUDA context), ``restore`` (the
    checkpoint read and put on the card), ``to_step`` and ``first_step``
    (the kernels' first launches in the process).  Wall times come from
    ``killed`` (``killing_worker_after_checkpoint``) and ``fetches``; the
    new worker's spans from the trial's trace row, placed on the wall clock
    by its first checkpoint's save, which ends as the controller's fetch of
    it starts."""
    (restart,) = [e for e in rows if e["name"] == "restart"]
    after = [e for e in rows if e["ts"] >= restart["ts"]]
    build = next(e for e in after if e["name"] == "build")
    restore = next(e for e in after if e["name"] == "ckpt.restore")
    step = next(e for e in after if e["name"] == "step" and e["ts"] >= build["ts"])
    save = next(e for e in after if e["name"] == "ckpt.save" and e["ts"] >= step["ts"])
    (to_host,) = [f for f in fetches if f["to"] == "host" and f["t"] >= killed["t"]]
    back = min(f["t"] for f in fetches if f["to"] == "controller" and f["t"] >= to_host["t"])
    us = 1e-6
    build_t = back - (save["ts"] + save["dur"] - build["ts"]) * us
    step_end = build_t + (step["ts"] + step["dur"] - build["ts"]) * us
    (req_t, req_s), (exp_t, exp_s) = killed["requeue"], killed["export"]
    return {"total": step_end - killed["t"],
            "exit": killed["death_seen"] - killed["t"],
            "to_requeue": req_t - killed["death_seen"],
            "requeue": req_s,
            "to_export": exp_t - req_t - req_s,
            "export_copy": exp_s,
            "fetch_to_host": to_host["s"],
            "fork_and_dial": build_t - to_host["t"] - to_host["s"],
            "spawn_and_context": (build["dur"] - restore["dur"]) * us,
            "restore": restore["dur"] * us,
            "restored_iteration": restore["args"].get("iteration"),
            "to_step": (step["ts"] - build["ts"] - build["dur"]) * us,
            "first_step": step["dur"] * us}


def run_path(arch: str, card: str, torch, ops, serve, prefill, decode_step, get_config,
             leaves):
    """Serve ``arch`` at full width with every launch count set to 0 just
    before and read just after; hold it against the plain path; time it and
    trace it.  Returns the launch counts."""
    cfg = get_config(arch)
    pattern = cfg.pattern_for_layers()
    n_attn = sum(t in ("attention", "local_attn") for t in pattern)
    n_moe = n_attn if cfg.family == "moe" else 0
    # K1 in prefill only; the router in every MoE layer of prefill and of each decode step
    expect = {name: 0 for name in KERNELS}
    expect.update(flash_attention=n_attn, rwkv6_scan=pattern.count("rwkv6"),
                  rglru_scan=pattern.count("rglru"), moe_router=n_moe * NEW)
    routing, hook = None, contextlib.nullcontext()
    if n_moe:
        from repro_torch.models import moe as moe_mod
        routing = RoutingCheck(torch, moe_mod)
        hook = patched(moe_mod, "_route", routing.record)
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    with hook:
        res = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(S),
                          "--new-tokens", str(NEW), "--device", "cuda"])
        torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    log(f"[serve] {arch}: kernel launches on the main path: {launches} (one prefill, "
        f"{NEW - 1} decode steps)")
    assert launches == expect, f"{arch}: expected {expect} launches"
    assert res.prefill_logits.shape == (B, cfg.vocab_size)
    assert res.tokens.shape == (B, NEW) and len(res.step_logits) == NEW - 1
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert all(bool(torch.isfinite(x).all()) for x in res.step_logits)

    tol = SERVE_TOL[arch]
    errs, rels = {}, {}

    def close(key, plain_t, kernel_t):
        """max |plain - kernel| over max(1, max |kernel|) must be <= tol."""
        err = float((plain_t.float() - kernel_t.float()).abs().max())
        rel = err / max(1.0, float(kernel_t.float().abs().max()))
        errs[key], rels[key] = max(errs.get(key, 0.0), err), max(rels.get(key, 0.0), rel)
        assert rel <= tol, f"{arch} {key}: max abs err {err} is {rel} of its scale > {tol}"

    plain = dataclasses.replace(res.cfg, attn_impl="naive", kernel_impl="jnp")
    with patched(moe_mod, "_route", routing.forced) if routing else contextlib.nullcontext():
        logits, caches = prefill(res.params, {"tokens": res.prompts}, plain, S + NEW)
        close("prefill_logits", logits, res.prefill_logits)
        for i in range(NEW - 1):
            logits, caches = decode_step(res.params, caches, res.tokens[:, i], S + i, plain)
            close("decode_logits", logits, res.step_logits[i])
    if routing:
        routing.report(f"[serve] {arch}", serve_call(n_moe))
    for pseg, kseg in zip(caches, res.caches):
        for pst, kst in zip(pseg, kseg):
            pl, kl = list(leaves(pst)), list(leaves(kst))
            assert [p for p, _ in pl] == [p for p, _ in kl]
            for (path, pt), (_, kt) in zip(pl, kl):
                key = "/".join(path)
                if key == "kpos":
                    assert torch.equal(pt, kt)
                    continue
                close(key, pt, kt)
    log(f"[serve] {arch}: kernel path vs plain path after {NEW - 1} decode steps, max abs "
        f"err: {errs}; over max(1, max |kernel|): {rels} (tol {tol})")
    log(f"[serve] {arch}: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if "rwkv6" in pattern:
        wkv_precision(torch, res, prefill)

    params, prompts, kcfg = res.params, res.prompts, res.cfg
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompts}, kcfg, S + NEW)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    log(f"[time] {arch} prefill {B}x{S} in serve (first call): {res.prefill_s!r} s {card}")
    log(f"[time] {arch} prefill {B}x{S} warm, median of 3: {statistics.median(pre)!r} s "
        f"(runs {pre}) {card}")
    log(f"[time] {arch} decode {NEW - 1} steps x batch {B}: {res.decode_s!r} s, "
        f"{B * (NEW - 1) / res.decode_s!r} tokens/s {card}")

    def run_decode(caches, first):
        tok = prompts[:, -1]
        for i in range(TRACE_DECODE_STEPS):
            logits, caches = decode_step(params, caches, tok, first + i, kcfg)
            tok = logits.argmax(-1)

    _, caches = prefill(params, {"tokens": prompts}, kcfg, S + NEW)
    trace(f"{arch} prefill (warm)",
          lambda: prefill(params, {"tokens": prompts}, kcfg, S + NEW), card, ops)
    run_decode(caches, S)                                   # warm-up
    trace(f"{arch} decode x{TRACE_DECODE_STEPS} (warm)",
          lambda: run_decode(caches, S + TRACE_DECODE_STEPS), card, ops)
    return launches


def topk_chain(torch, logits, k):
    """The router as unfused PyTorch calls: softmax, ``topk``, renormalise.
    A yardstick only: ``topk`` does not promise an order among equal
    values, so the port does not use it."""
    w, idx = torch.topk(torch.softmax(logits.float(), dim=-1), k)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), idx


def time_pair(kernel_fn, plain_fn, iters_plain: int):
    """Kernel and plain version interleaved on one card (plain, kernel,
    kernel, plain); the faster of each pair of readings."""
    runs = {}
    for turn in ("plain", "kernel", "kernel", "plain"):
        fn, iters = (kernel_fn, 50) if turn == "kernel" else (plain_fn, iters_plain)
        runs.setdefault(turn, []).append(time_ms(fn, iters=iters))
    return min(runs["kernel"]), min(runs["plain"]), runs


# K1's timed shapes: label, (B, Sq, Sk, H, K, hd), window, seed (the phase-2
# case of the same shape).  With S=512 recurrentgemma's window of 2048 masks
# nothing beyond causal, so SDPA with is_causal computes the same function.
ATTN_SHAPES = (
    ("smollm", (8, 512, 512, 9, 3, 64), None, 100),
    ("granite-moe", (8, 512, 512, 24, 8, 64), None, 109),
    ("recurrentgemma local_attn", (8, 512, 512, 16, 1, 256), 2048, 107),
)


def time_attention(torch, dev, ops, ref, card, label, shape, window, seed) -> dict:
    """K1 at one serving shape: fp32 kernel and plain version interleaved,
    the bf16 kernel, PyTorch's ``scaled_dot_product_attention`` on the same
    fp32 inputs (kv heads expanded beforehand, not timed) and the kernels it
    launched, and both bounds."""
    import torch.nn.functional as F
    q, k, v, qp, kp = attention_inputs(torch, dev, seed, *shape, torch.float32)
    G = shape[3] // shape[4]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    plain = lambda: ref.flash_attention_ref(q, k, v, qp, kp, window=window)
    lib_err = max_err(sdpa().transpose(1, 2), plain())
    kms, pms, runs = time_pair(lambda: ops.flash_attention(q, k, v, qp, kp, window=window),
                               plain, 20)
    library_ms = time_ms(sdpa)
    lib_kernels = [(name, n, ms / n) for name, n, ms in
                   device_kernels(torch, f"scaled_dot_product_attention {label}", sdpa)]
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    bf16_ms = time_ms(lambda: ops.flash_attention(qb, kb, vb, qp, kp, window=window))
    bound = attention_bound(q, k, v, qp, kp, window=window)
    bound_bf16 = attention_bound(qb, kb, vb, qp, kp, window=window)
    B, S, _, H, K, hd = shape
    where = f"{label} B={B} S={S} H={H} K={K} hd={hd}" + (f" window {window}" if window else "")
    log(f"[time] flash_attention kernel fp32 {where}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] flash_attention kernel bf16 {where}: {bf16_ms!r} ms {card}")
    log(f"[time] flash_attention plain version fp32 {where}: {pms!r} ms {card}")
    log(f"[time] torch scaled_dot_product_attention fp32 {where} (kv heads expanded "
        f"beforehand; max_abs_err vs plain {lib_err!r}): {library_ms!r} ms {card}; its "
        f"kernels (name, launches the profiler kept of 10, device ms a launch): {lib_kernels}")
    log(f"[time] flash_attention bounds {where}: fp32 {bound[0]!r} ms by {bound[1]} on the "
        f"CUDA cores, {bound[4]!r} ms by {bound[5]} as 3xTF32 on the tensor cores; bf16 "
        f"{bound_bf16[4]!r} ms by {bound_bf16[5]} on the tensor cores ({bound[2]:.4g} flop, "
        f"{bound[3]:.4g} bytes fp32) {card}")
    return {"ms": kms, "bf16_ms": bf16_ms, "plain_ms": pms, "library_ms": library_ms,
            "library_kernels": [name for name, _, _ in lib_kernels], "bound": bound[:4],
            "bound_ms": bound[0], "tensor_core_bound_ms": bound[4],
            "bf16_tensor_core_bound_ms": bound_bf16[4]}


def time_attention_bwd(torch, dev, ops, ref, card, label, shape, window, seed) -> dict:
    """K1's backward at one of K1's shapes: the fp32 kernel and its plain
    version interleaved, the bf16 kernel, the backward of PyTorch's
    ``scaled_dot_product_attention`` on the same fp32 inputs (kv heads
    expanded beforehand, not timed) and the kernels it launched, and both
    bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B_, S_, _, H, K, hd = shape
    q, k, v, qp, kp = attention_inputs(torch, dev, seed, *shape, torch.float32)
    out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, return_lse=True, window=window)
    dout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(seed + 150),
                       device=dev)
    kernel = lambda: ops.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout, window=window)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, qp, kp, out, lse, dout, window=window)
    kms, pms, runs = time_pair(kernel, plain, 10)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    outb, lseb = fa.flash_attention_cuda(qb, kb, vb, qp, kp, return_lse=True, window=window)
    doutb = dout.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: ops.flash_attention_bwd(qb, kb, vb, qp, kp, outb, lseb, doutb,
                                                      window=window))
    G = H // K
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = dout.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    gq, gk, gv = sdpa_bwd()
    regroup = lambda g: g.transpose(1, 2).reshape(B_, S_, K, G, hd).sum(3)   # expanded heads summed
    lib_err = max(normwise(a, b) for a, b in zip(
        (gq.transpose(1, 2), regroup(gk), regroup(gv)), plain()))
    library_ms = time_ms(sdpa_bwd)
    lib_kernels = [(name, n, ms / n) for name, n, ms in
                   device_kernels(torch, f"scaled_dot_product_attention backward {label}", sdpa_bwd)
                   or []]
    bound = attention_bwd_bound(q, k, v, qp, kp, window=window)
    bound_bf16 = attention_bwd_bound(qb, kb, vb, qp, kp, window=window)
    where = f"{label} B={B_} S={S_} H={H} K={K} hd={hd}" + (f" window {window}" if window else "")
    log(f"[time] flash_attention_bwd kernel fp32 {where}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] flash_attention_bwd kernel bf16 {where}: {bf16_ms!r} ms {card}")
    log(f"[time] flash_attention_bwd plain version fp32 {where}: {pms!r} ms {card}")
    log(f"[time] torch scaled_dot_product_attention backward fp32 {where} (kv heads expanded "
        f"beforehand; max normwise err vs plain {lib_err!r}): {library_ms!r} ms {card}; its "
        f"kernels (name, launches the profiler kept of 10, device ms a launch): {lib_kernels}")
    log(f"[time] flash_attention_bwd bounds {where}: fp32 {bound[0]!r} ms by {bound[1]} on the "
        f"CUDA cores, {bound[4]!r} ms by {bound[5]} as 3xTF32 on the tensor cores; bf16 "
        f"{bound_bf16[4]!r} ms by {bound_bf16[5]} on the tensor cores ({bound[2]:.4g} flop, "
        f"{bound[3]:.4g} bytes fp32) {card}")
    return {"ms": kms, "bf16_ms": bf16_ms, "plain_ms": pms, "library_ms": library_ms,
            "library_kernels": [name for name, _, _ in lib_kernels], "bound": bound[:4],
            "bound_ms": bound[0], "tensor_core_bound_ms": bound[4],
            "bf16_tensor_core_bound_ms": bound_bf16[4]}


def time_scan_backwards(torch, dev, ops, ref, rw, card) -> dict:
    """K2's and K3's backwards at the training shapes, as the train phase
    calls them (no final-state gradient, h0 None): each kernel and its plain
    version interleaved (``time_pair``), the bound, and K2's in bf16, its
    bound on the tensor cores and its design's floor
    (``rwkv6_bwd_design_floor``).  Returns {name: (ms, plain ms, bound,
    library ms, bf16 ms, tensor-core bound ms, design floor ms)}."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 700, 8, 512, 32, 64, f32)
    s0.zero_()
    dy, _ = rwkv_cotangents(torch, dev, 750, r, s0, f32)
    states = rw.rwkv6_scan_cuda(r, k, v, logw, u, s0, return_states=True)[2]
    kms, pms, runs = time_pair(
        lambda: ops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy),
        lambda: ref.rwkv6_scan_bwd_ref(r, k, v, logw, u, s0, dy), 5)
    rb, kb, vb, dyb = (x.to(bf16) for x in (r, k, v, dy))
    states_b = rw.rwkv6_scan_cuda(rb, kb, vb, logw, u, s0, return_states=True)[2]
    bf16_ms = time_ms(lambda: ops.rwkv6_scan_bwd(rb, kb, vb, logw, u, s0, states_b, dyb))
    bound = rwkv6_bwd_bound(r, k, v, logw, u, s0, dy)
    floor_ms, floor_bytes = rwkv6_bwd_design_floor(r, k, v, logw, u, s0, dy)
    out["rwkv6_scan_bwd"] = (kms, pms, bound[:4], None, bf16_ms, bound[4], floor_ms)
    shape = "B=8 S=512 H=32 N=64 L=32, no final-state gradient"
    log(f"[time] rwkv6_scan_bwd kernel fp32 {shape}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] rwkv6_scan_bwd kernel bf16 r/k/v {shape}: {bf16_ms!r} ms {card}")
    log(f"[time] rwkv6_scan_bwd plain version fp32 (autograd of the sequential scan) {shape}: "
        f"{pms!r} ms {card}")
    log(f"[time] rwkv6_scan_bwd bound with its four N^2 products as 3xTF32 on the tensor "
        f"cores: {bound[4]!r} ms by {bound[5]} {card}")
    log(f"[time] rwkv6_scan_bwd three-pass design's floor fp32 {shape}: {floor_ms!r} ms by "
        f"bytes ({floor_bytes:.4g} bytes, workspaces included) {card}")
    del r, k, v, logw, u, s0, dy, states, rb, kb, vb, dyb, states_b

    a, b, _ = rglru_inputs(torch, dev, 800, 8, 512, 4096)
    h = ops.rglru_scan(a, b, None)
    dh = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(850), device=dev)
    kms, pms, runs = time_pair(lambda: ops.rglru_scan_bwd(a, None, h, dh),
                               lambda: ref.rglru_scan_bwd_ref(a, None, h, dh), 10)
    out["rglru_scan_bwd"] = (kms, pms, rglru_bwd_bound(a, None, h, dh), None, None, None, None)
    log(f"[time] rglru_scan_bwd kernel fp32 B=8 S=512 R=4096, h0=None: {kms!r} ms {card} "
        f"(runs {runs})")
    log(f"[time] rglru_scan_bwd plain version fp32 B=8 S=512 R=4096: {pms!r} ms {card}")
    return out


# K4's timed shapes: label, (T, E, k); the draws of phase 2's case of the
# same shape (seed 400 + position).
ROUTER_SHAPES = (
    ("granite-moe prefill", (4096, 40, 8)),
    ("granite-moe decode", (256, 40, 8)),
    ("deepseek-moe", (4096, 64, 6)),
)
# calls a host-paced reading averages over
HOST_CALLS = 2000


def router_logits(torch, dev, T, E, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((T, E), generator=g, device=dev) * 2.0


def paced_ms(torch, fn) -> float:
    """ms a call of ``fn`` paced by the host: ``time.perf_counter`` around
    ``HOST_CALLS`` back-to-back calls and the synchronise after them, after
    50 of warm-up.  Where a call's host work takes longer than its kernels,
    as the router's does, this is the host's time a call."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e3


def launch_floor(torch, dev, card) -> dict:
    """What no call of a kernel of a few microseconds goes below on this card
    and host: the profiler's device time of a one-element fill kernel, and
    a one-element in-place PyTorch op's time a call paced by the host
    (``paced_ms``, as the router's wrapper is timed)."""
    x = torch.zeros(1, device=dev)
    fill = device_ms(torch, "one-element fill", lambda: x.fill_(1.0))
    op = paced_ms(torch, lambda: x.add_(1.0))
    log(f"[time] launch floor: one-element fill kernel {fill!r} ms device time a launch; "
        f"one-element in-place op (add_) {op!r} ms a call paced by the host {card}")
    return {"fill_device_ms": fill, "inplace_op_ms": op}


def time_router(torch, dev, ops, ref, card, label, shape, seed) -> dict:
    """K4 at one shape: its device time a launch in turns with the plain
    version's a call (profiler; a few microseconds of work, which CUDA
    events around back-to-back calls would read as the host's time), the
    unfused PyTorch chain's, each one's time a call paced by the host
    (``paced_ms``), and the bound."""
    T, E, k = shape
    logits = router_logits(torch, dev, T, E, seed)
    kernel, plain = (lambda: ops.moe_router(logits, k)), (lambda: ref.moe_router_ref(logits, k))
    chain = lambda: topk_chain(torch, logits, k)
    runs = {}
    for turn in ("plain", "kernel", "kernel", "plain"):
        runs.setdefault(turn, []).append(
            device_ms(torch, f"moe_router {label}", kernel, "moe_router_kernel")
            if turn == "kernel" else device_ms(torch, f"moe_router plain {label}", plain))
    kms = min((x for x in runs["kernel"] if x is not None), default=None)
    pms = min(runs["plain"])
    chain_ms = device_ms(torch, f"softmax-topk chain {label}", chain)
    host = {"kernel": paced_ms(torch, kernel), "plain": paced_ms(torch, plain),
            "chain": paced_ms(torch, chain)}
    bound = moe_router_bound(logits, k)
    where = f"{label} T={T} E={E} k={k}"
    log(f"[time] moe_router kernel fp32 {where}: {kms!r} ms device time a launch, bound "
        f"{bound[0]!r} ms by {bound[1]} {card} (runs {runs})")
    log(f"[time] moe_router plain version fp32 {where}: {pms!r} ms device time a call {card}")
    log(f"[time] softmax -> topk -> renormalise, PyTorch calls unfused (not used by the "
        f"port), fp32 {where}: {chain_ms!r} ms device time a call {card}")
    log(f"[time] moe_router per call, paced by the host (perf_counter over {HOST_CALLS} "
        f"back-to-back calls), fp32 {where}: kernel wrapper {host['kernel']!r} ms, plain "
        f"version {host['plain']!r} ms, unfused PyTorch calls {host['chain']!r} ms {card}")
    return {"ms": kms, "plain_ms": pms, "chain_ms": chain_ms, "host_ms": host["kernel"],
            "plain_host_ms": host["plain"], "chain_host_ms": host["chain"],
            "bound": bound, "bound_ms": bound[0]}


# K4's backward's timed shapes: label, (T, E, k); the logits of phase 2's
# case of the same shape (seed 400 + position there).
ROUTER_BWD_SHAPES = (
    ("granite-moe train", (4096, 40, 8), 400),
    ("deepseek-moe train", (4096, 64, 6), 402),
)


def time_router_bwd(torch, dev, ops, ref, router, card, label, shape, seed) -> dict:
    """K4's backward at one training shape, on the kernel forward's outputs
    and a seeded weight gradient: its device time a launch in turns with
    the plain version's a call (profiler), each one's time a call paced by
    the host (``paced_ms``), and the bound.  No single PyTorch call computes
    this gradient."""
    T, E, k = shape
    logits = router_logits(torch, dev, T, E, seed)
    dw = router_cotangent(torch, dev, seed + 50, T, k)
    w, idx = router.moe_router_cuda(logits, k)
    kernel = lambda: ops.moe_router_bwd(logits, w, idx, dw)
    plain = lambda: ref.moe_router_bwd_ref(logits, w, idx, dw)
    runs = {}
    for turn in ("plain", "kernel", "kernel", "plain"):
        runs.setdefault(turn, []).append(
            device_ms(torch, f"moe_router_bwd {label}", kernel, "moe_router_bwd_kernel")
            if turn == "kernel" else device_ms(torch, f"moe_router_bwd plain {label}", plain))
    kms, pms = (min((x for x in runs[t] if x is not None), default=None)
                for t in ("kernel", "plain"))
    host = {"kernel": paced_ms(torch, kernel), "plain": paced_ms(torch, plain)}
    bound = moe_router_bwd_bound(logits, k)
    where = f"{label} T={T} E={E} k={k}"
    log(f"[time] moe_router_bwd kernel fp32 {where}: {kms!r} ms device time a launch, bound "
        f"{bound[0]!r} ms by {bound[1]} ({bound[2]:.4g} flop, {bound[3]:.4g} bytes) {card} "
        f"(runs {runs})")
    log(f"[time] moe_router_bwd plain version fp32 {where}: {pms!r} ms device time a call {card}")
    log(f"[time] moe_router_bwd per call, paced by the host (perf_counter over {HOST_CALLS} "
        f"back-to-back calls), fp32 {where}: kernel wrapper {host['kernel']!r} ms, plain "
        f"version {host['plain']!r} ms {card}")
    return {"ms": kms, "plain_ms": pms, "host_ms": host["kernel"],
            "plain_host_ms": host["plain"], "bound": bound, "bound_ms": bound[0]}


def main() -> int:
    import os

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    # an orphan of a worker or a forkserver comes back here, so that
    # stop_started_processes finds it
    if not adopt_orphans():
        log("[processes] prctl(PR_SET_CHILD_SUBREAPER) refused: an orphaned process would "
            "escape the final sweep")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_router as k4
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.transformer import leaves

    # -- 1. device and build ---------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source, all at once
        infos = list(pool.map(_build.build, KERNELS))
    log(f"[build] {len(KERNELS)} libraries in {time.perf_counter() - t0:.2f}s wall")
    for name, info in zip(KERNELS, infos):
        log(f"[build] {name}: {info.seconds:.2f}s{' (cached)' if info.cached else ''} "
            f"-> {info.path.name}")
        for line in info.log.splitlines():
            log(f"[build]   {line}")
    report_k1_build(torch, fa, _build._nvcc(), infos[KERNELS.index("flash_attention")].path,
                    card)
    k1b_info = infos[KERNELS.index("flash_attention_bwd")]
    report_k1_bwd_build(torch, fa, _build._nvcc(), k1b_info.path, k1b_info.log, card)
    k4_sass = router_sass(_build._nvcc(), infos[KERNELS.index("moe_router")].path)
    for (dtype, vpl), c in k4_sass.items():
        log(f"[build] moe_router {dtype}, {vpl} values a lane, SASS: {c}")
    assert k4_sass and all(c["REDUX"] > 0 for c in k4_sass.values()), "K4 runs no redux.sync"
    for fn, c in ptxas_kernels(infos[KERNELS.index("moe_router_bwd")].log).items():
        log(f"[build] moe_router_bwd ptxas {fn}: {c}")

    # -- 2. kernels against their plain versions, on the card --------------------------------
    errs = {"flash_attention": check_flash_attention(torch, dev, ops, ref),
            "flash_attention_bwd": check_flash_attention_bwd(torch, dev, ops, ref),
            "rwkv6_scan": check_rwkv6(torch, dev, ops, ref),
            "rwkv6_scan_bwd": check_rwkv6_bwd(torch, dev, ops, ref, rw),
            "rglru_scan": check_rglru(torch, dev, ops, ref),
            "rglru_scan_bwd": check_rglru_bwd(torch, dev, ops, ref),
            "moe_router": check_moe_router(torch, dev, ops, ref),
            "moe_router_bwd": check_moe_router_bwd(torch, dev, ops, ref, k4)}
    # K4's few microseconds a launch and K2's two kernels' device times are
    # read from the profiler here, early: late in a long run, sessions have
    # kept some records and dropped others.
    floor = launch_floor(torch, dev, card)
    router = {label: time_router(torch, dev, ops, ref, card, label, shape, 400 + i)
              for i, (label, shape) in enumerate(ROUTER_SHAPES)}
    r0 = router[ROUTER_SHAPES[0][0]]
    router_bwd = {label: time_router_bwd(torch, dev, ops, ref, k4, card, label, shape, seed)
                  for label, shape, seed in ROUTER_BWD_SHAPES}
    rb0 = router_bwd[ROUTER_BWD_SHAPES[0][0]]
    k2_info = infos[KERNELS.index("rwkv6_scan")]
    k2_passes = report_k2_build(torch, ops, rw, _build._nvcc(), k2_info.path, k2_info.log, card)
    k2b_info = infos[KERNELS.index("rwkv6_scan_bwd")]
    k2_bwd_passes, k2_bwd_sass = report_k2_bwd_build(torch, ops, rw, _build._nvcc(),
                                                     k2b_info.path, k2b_info.log, card)

    # -- 3. train smollm-135m at full width --------------------------------------------------------
    train = run_train(card, torch, ops, dev)
    per_path = {f"{TRAIN_ARCH} train": train["launches"]}
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3b. an ASHA sweep of it through launch.tune, and one trial in a worker process ------
    sweep = run_sweep(card, torch, ops)
    per_path[f"{TRAIN_ARCH} sweep"] = sweep["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3e. the same sweep on the cluster tier, then a worker killed and restored -------------
    cluster = run_cluster(card, torch, sweep)
    per_path[f"{TRAIN_ARCH} cluster sweep"] = cluster["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3c. train rwkv6-1.6b and a cut recurrentgemma-9b through the scan kernels -------------
    train_r = {}
    for arch, n_layers in TRAIN_R:
        train_r[arch] = run_train_recurrent(card, torch, ops, dev, arch, n_layers)
        per_path[f"{arch} train"] = train_r[arch]["launches"]
        gc.collect()
        torch.cuda.empty_cache()

    # -- 3d. train granite-moe-3b-a800m through K4's forward and backward ------------------------
    train_moe = run_train_moe(card, torch, ops, dev)
    per_path[f"{TRAIN_MOE} train"] = train_moe["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4 and 5. serve each model at full width, then its times -----------------------------------
    for arch in ARCHS:
        per_path[arch] = run_path(arch, card, torch, ops, serve, prefill, decode_step,
                                  get_config, leaves)
        gc.collect()
        torch.cuda.empty_cache()

    # -- 5. kernel times at the serving and training shapes -----------------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    attn = {label: time_attention(torch, dev, ops, ref, card, label, shape, window, seed)
            for label, shape, window, seed in ATTN_SHAPES}
    k1 = attn[ATTN_SHAPES[0][0]]
    times["flash_attention"] = (k1["ms"], k1["plain_ms"], k1["bound"], k1["library_ms"])
    attn_bwd = {label: time_attention_bwd(torch, dev, ops, ref, card, label, shape, window,
                                          seed + 400)
                for label, shape, window, seed in ATTN_SHAPES}
    k1b = attn_bwd[ATTN_SHAPES[0][0]]
    times["flash_attention_bwd"] = (k1b["ms"], k1b["plain_ms"], k1b["bound"], k1b["library_ms"])

    r, k, v, logw, u, s0 = rwkv_inputs(torch, dev, 200, 8, 512, 32, 64, f32)
    kms, pms, runs = time_pair(lambda: ops.rwkv6_scan(r, k, v, logw, u, s0),
                               lambda: ref.rwkv6_scan_ref(r, k, v, logw, u, s0), 10)
    times["rwkv6_scan"] = (kms, pms, rwkv6_bound(r, k, v, logw, u, s0, chunk=32), None)
    floor_ms, floor_bytes = rwkv6_design_floor(r, k, v, logw, u, s0, chunk=32)
    rb, kb, vb = (x.to(bf16) for x in (r, k, v))
    bf16_ms = time_ms(lambda: ops.rwkv6_scan(rb, kb, vb, logw, u, s0))
    shape = "B=8 S=512 H=32 N=64 L=32"
    log(f"[time] rwkv6_scan kernel fp32 {shape}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] rwkv6_scan kernel bf16 r/k/v {shape}: {bf16_ms!r} ms {card}")
    log(f"[time] rwkv6_scan plain version fp32 {shape}: {pms!r} ms {card}")
    log(f"[time] rwkv6_scan two-kernel design's floor fp32 {shape}: {floor_ms!r} ms by bytes "
        f"({floor_bytes:.4g} bytes, workspace included) {card}")
    del r, k, v, logw, u, s0, rb, kb, vb

    a, b, h0 = rglru_inputs(torch, dev, 300, 8, 512, 4096)
    h0.zero_()                                      # as in a prefill
    kms, pms, runs = time_pair(lambda: ops.rglru_scan(a, b, h0),
                               lambda: ref.rglru_scan_ref(a, b, h0), 10)
    times["rglru_scan"] = (kms, pms, rglru_bound(a, b, h0), None)
    shape = "B=8 S=512 R=4096"
    log(f"[time] rglru_scan kernel fp32 {shape}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] rglru_scan plain version fp32 {shape}: {pms!r} ms {card}")
    del a, b, h0

    bwd_times = time_scan_backwards(torch, dev, ops, ref, rw, card)
    times.update((name, t[:4]) for name, t in bwd_times.items())
    times["moe_router"] = (r0["ms"], r0["plain_ms"], r0["bound"], None)
    times["moe_router_bwd"] = (rb0["ms"], rb0["plain_ms"], rb0["bound"], None)
    log("[time] rwkv6_scan, rwkv6_scan_bwd, rglru_scan, rglru_scan_bwd, moe_router, "
        "moe_router_bwd: no single PyTorch call computes any of these functions, so library_ms "
        "is null")
    for name, (kms, pms, (bms, by, flops, nbytes), lms) in times.items():
        log(f"[time] {name} bound: {bms!r} ms by {by} ({flops:.4g} flop, {nbytes:.4g} bytes; "
            f"H100 SXM peaks at 700 W) {card}")

    # The backwards are the gradients of the same TPU kernels (forward-only in JAX)
    sources = {"flash_attention": "src/repro/kernels/flash_attention.py:77",
               "flash_attention_bwd": "src/repro/kernels/flash_attention.py:77",
               "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:74",
               "rwkv6_scan_bwd": "src/repro/kernels/rwkv6_scan.py:74",
               "rglru_scan": "src/repro/kernels/rglru_scan.py:44",
               "rglru_scan_bwd": "src/repro/kernels/rglru_scan.py:44",
               "moe_router": "src/repro/kernels/moe_router.py:45",
               "moe_router_bwd": "src/repro/kernels/moe_router.py:45"}
    kernels = []
    for name in KERNELS:
        kms, pms, (bms, by, _, _), lms = times[name]
        paths = {arch: n[name] for arch, n in per_path.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu", "replaces": sources[name],
            "launches": sum(paths.values()), "launches_per_path": paths,
            "max_abs_err": errs[name], "ms": kms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by, "library_ms": lms,
            # the bound on the tensor cores (3xTF32 in fp32): K1's forward and backward
            # run there; K2's backward could run its N^2 products there
            "tensor_core_bound_ms": {"flash_attention": k1["tensor_core_bound_ms"],
                                     "flash_attention_bwd": k1b["tensor_core_bound_ms"],
                                     "rwkv6_scan_bwd": bwd_times["rwkv6_scan_bwd"][5]}.get(name),
        })
    kernels[KERNELS.index("moe_router")].update(
        host_ms=r0["host_ms"], launch_floor=floor,
        shapes={label: {key: val for key, val in r.items() if key != "bound"}
                for label, r in router.items()})
    kernels[KERNELS.index("moe_router_bwd")].update(
        host_ms=rb0["host_ms"], launch_floor=floor,
        shapes={label: {key: val for key, val in r.items() if key != "bound"}
                for label, r in router_bwd.items()},
        train_step={k: v for k, v in train_moe.items() if k != "launches"})
    k2 = kernels[KERNELS.index("rwkv6_scan")]
    k2.update(bf16_ms=bf16_ms, pass_ms=k2_passes, design_floor_ms=floor_ms)
    kernels[KERNELS.index("rwkv6_scan_bwd")].update(
        bf16_ms=bwd_times["rwkv6_scan_bwd"][4], pass_ms=k2_bwd_passes, sass=k2_bwd_sass,
        design_floor_ms=bwd_times["rwkv6_scan_bwd"][6],
        train_step={k: v for k, v in train_r["rwkv6-1.6b"].items() if k != "launches"})
    kernels[KERNELS.index("rglru_scan_bwd")]["train_step"] = {
        k: v for k, v in train_r["recurrentgemma-9b"].items() if k != "launches"}
    kernels[KERNELS.index("flash_attention")]["shapes"] = {
        label: {key: val for key, val in r.items() if key != "bound"} for label, r in attn.items()}
    kernels[KERNELS.index("flash_attention_bwd")].update(
        bf16_ms=k1b["bf16_ms"], bf16_tensor_core_bound_ms=k1b["bf16_tensor_core_bound_ms"],
        library_kernels=k1b["library_kernels"],
        shapes={label: {key: val for key, val in r.items() if key != "bound"}
                for label, r in attn_bwd.items()},
        train_step={key: val for key, val in train.items() if key != "launches"},
        sweep={key: val for key, val in sweep.items() if key not in ("launches", "losses")},
        cluster_sweep={key: val for key, val in cluster.items() if key != "launches"})
    log(f"[profiler] {PROFILER['sessions']} sessions, {PROFILER['retried']} retried, "
        f"{PROFILER['unmeasured']} measurements with no whole session (not measured)")
    left = stop_started_processes()
    log(f"[processes] trial workers, forkservers and resource tracker stopped; other processes "
        f"that still ran below this one, stopped now: {left or 'none'}")
    assert not descendants(os.getpid()), "a process outlived stop_started_processes"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:    # a phase that failed may have left workers and forkservers
        stop_started_processes()
    sys.exit(code)
