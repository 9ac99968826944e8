#!/usr/bin/env python3
"""Run the PyTorch port's training and serving paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with its traceback and a
non-zero exit:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
   build the eight CUDA libraries from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, all started together) and print ptxas' reports; K1's
   tiles, shared memory, blocks an SM, registers and spills for each
   (dtype, head_dim: 64, 80, 128, 256), and the HMMA (tensor-core)
   instructions in each of its kernels' SASS; the same for K1's two
   backward kernels; K4's
   SASS and its backward's SASS (no REDUX, at most 8 SHFL), registers and
   spills.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and edge cases (ragged lengths, initial states, a
   sequence run in two halves, a sequence whose chunks are all K2's
   parallelism, tied router rows, bf16), with stated tolerances; K1's
   backward against its plain version at the forward's cases, fp32 and
   bf16, two runs of it bit for bit, and ``FlashAttentionFn`` against
   autograd of the plain forward; K1 at head size 80 (hubert-xlarge's
   train shape, bidirectional, and ragged lengths both ways, forward and
   backward, fp32 and bf16) and at paligemma-3b's prefill (768 positions,
   MQA, hd 256); K1 under ``torch.func.vmap``, forward and ``vmap(grad)``,
   at 8 lanes of smollm's train shape, fp32 and bf16: one launch of each
   pass a call, every lane's output and gradients bit for bit the
   lane-by-lane calls, and within K1's limits of ``vmap`` of the plain
   version, the vmapped calls timed; K2, K3 and K4 under ``torch.func.vmap``
   the same way at 4 lanes of their training shapes (fp32, and bf16 for K2
   and K4; K2's lanes each with its own ``u``, then with one shared zero
   state; K3's ``h0`` None, a lane's own, one for every lane), one launch of
   each pass a call and every lane bit for bit its lane-by-lane ``*_cuda``
   calls; the same for K2's and K3's backwards at
   the training shapes and edge cases (a ragged last chunk, an initial
   state, a final-state gradient), with ``RWKV6ScanFn`` and ``RGLRUScanFn``;
   and K4's backward at K4's cases, on the kernel forward's outputs and row
   statistics (the forward's weights and indices the same bits with and
   without them, the statistics against a plain fp32 recomputation, the
   backward's Z the forward's bit for bit), with ``MoERouterFn`` against
   autograd of the plain router.
   Then K4's times: at granite-moe's prefill and decode shapes and
   deepseek-moe's, its device time a launch, the wrapper's time a call
   paced by the host, the bound, and beside them the card's launch floor
   (a one-element fill kernel's device time, a one-element in-place op's
   time a call), and the forward's device time with its row statistics;
   the kernels ``scaled_dot_product_attention`` launches at K1's timed
   shapes and their device time (phase 5 prints them beside its time);
   the same for K4's backward at granite-moe's and deepseek-moe's training
   shapes, beside its plain version's, its SASS counts and registers; K2's
   and its
   backward's kernels: registers, shared memory, blocks an SM and device
   ms.
3. train: ``repro_torch.launch.train`` at full width on smollm-135m (fp32,
   batch 8, sequence 512, 4 steps), every launch count set to 0 just before
   and read just after (30 K1 forwards and 30 K1 backwards a step); the
   plain path (``attn_impl="naive"``) on the same weights and batches: the
   first step's gradient of every parameter and the four losses within
   stated limits; the steady step time, tokens/s, peak device memory and a
   trace of one warm step.
3h. sharded: the same training on DTensor, through ``make_train_state`` /
   ``make_train_step``: a world of one rank (NCCL, joined through a
   ``FileStore`` under a temp directory), the (1,1) mesh of
   ``SlicePool(devices=[cuda:0]).acquire(1).make_mesh(("data", "model"))``,
   the ``fsdp_tp`` strategy and an ``activation_policy``, the state and
   batches placed by ``dist.sharding``; K1 under ``local_map``.  Every
   launch count set to 0 just before and read just after (30 K1 forwards
   and 30 backwards a step); the four losses and the first step's
   gradients (``full_tensor()``) against phase 3's unsharded kernel path
   within the train phase's limits; the steady step beside phase 3's, the
   launches a step, and a trace of one warm step (idle share, NCCL's
   kernels).  Then, in the same world and on the same mesh, the ssm,
   hybrid and moe families at full width, fp32, batch 8, sequence 512, 3
   steps each, their scans and router on each rank's shards under
   ``local_map`` (``local_rwkv6_scan``, ``local_rglru_scan``,
   ``local_moe_router``): rwkv6-1.6b at 3 of 24 layers (3 K2 forwards and
   3 backwards a step), recurrentgemma-9b at one repeat, 3 of 38 layers,
   with its remat (4 K3 and 2 K1 forwards, 2 K3 and 1 K1 backwards a step)
   and granite-moe-3b-a800m at 3 of 32 layers with phase 3d's remat (6 K1
   and 6 K4 forwards, 3 of each backward a step), with its einsum dispatch
   and then with the sort/scatter one (``moe.impl="scatter"``, on each
   rank's groups and experts through ``local_moe_scatter``).  Each against the
   unsharded kernel path of the same config on the same weights and
   batches: the launch counts of both equal ``expected_train_launches``;
   the first step's loss and every gradient (``full_tensor()``) and every
   step's loss bit for bit, or within phases 3c's and 3d's limits with the
   gap printed (rwkv6: where its chaotic gradients are not bit for bit,
   each K2 forward's outputs of the first step bit for bit, and the losses
   within 4e-3).  Printed: each path's steady step, peak memory and the
   idle share of a traced warm step.  The group is destroyed before the
   next phase.
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
3g. vmap: 3b's sweep through ``launch.tune`` with ``--executor vmap`` and
   ``--num-samples 6``, the most lanes that fit the card at B=8, S=512 (7
   run out of it in an iteration's second step, the CLI's default 8 in its
   first): the 6 trials are the 6 lanes of
   one ``torch.func.vmap`` step of ``build_vmap_executor`` (momentum SGD
   over lr and weight_decay, a checkpoint of each live lane every
   iteration, its store spilling under the temp log directory; the lanes'
   gradients pulled back without a graph of the backward), K1's forward
   and backward each launched once a layer for all lanes: 30 each way a
   stacked step, every launch count set to 0 just before and read just
   after.  Every trial must end TERMINATED and the device memory in use
   must come back within 64 MiB.  Then 6 lanes of different weights and
   batches under the sweep's hyperparameters: each lane's first-step loss
   and gradients against the plain path under the same ``vmap`` (2 lanes
   at a time) within the train phase's limits, and each lane's loss
   against the lane stepped alone through the unvmapped ``step_fn``.
   Printed: wall time and trials/hour beside 3b's, each stacked call's
   time and the checkpoints' share, peak memory, the stacked step's time
   beside 6 train-phase steps, tokens/s over all lanes and a trace of one
   warm stacked step.  Then one lane's step, in turns, with its gradients
   through ``loss_and_grads``, ``torch.func.grad_and_value`` and autograd's
   backward of ``forward_train``: each way's peak memory, the losses
   within the train phase's limit, and ``loss_and_grads``' peak at most
   two thirds of ``grad_and_value``'s.
3k. vmap of the other token families: 3g's sweep through ``launch.tune
   --executor vmap`` for rwkv6-1.6b (4 lanes, 3 of its 24 layers, B=8),
   recurrentgemma-9b (2 lanes, one repeat: 3 of its 38 layers, B=2) and
   granite-moe-3b-a800m (4 lanes, 3 of its 32 layers, B=8), each at full
   width (S=512, fp32, ASHA over 2 iterations of 1 step, no checkpoints),
   each with its config's remat (recurrentgemma-9b's: each repeat run
   forward without autograd, then again for its gradients): every launch
   count set to 0 just before and read just after, K1, K2, K3 and K4
   forward and backward each once a layer for all lanes, and each forward
   twice under remat (``expected_train_launches``), every trial
   TERMINATED and the device memory in use back within 64 MiB.
   Then lanes of different weights and batches: each lane's first-step
   loss and gradients against the plain path under the same ``vmap``
   within phases 3c's and 3d's limits (rwkv6 against float64 on the
   parameters its plain fp32 path resolves; granite's routing
   teacher-forced, each flip a near-tie), each lane's loss against the
   lane stepped alone within 3g's limit.  Printed: trials/hour, the stacked
   step beside n x the lane alone, tokens/s over all lanes, peak memory and
   a trace of one warm stacked step.
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
   time, tokens/s, peak memory and a trace of one warm step, with K4's
   backward's device ms in it; the plain path on the same weights and
   batches, its routing teacher-forced to the kernel path's (each flip a
   near-tie):
   the first step's gradients and the losses within stated limits.
3f. train the audio family: hubert-xlarge at full width and full depth
   (48 layers, 945,758,720 parameters, fp32, batch 8 x 512 frames of
   conv-feature stubs, 3 steps) through ``launch.train``, every launch
   count set to 0 just before and read just after (48 K1 forwards and 48
   backwards a step, bidirectional at hd 80); the steady step time,
   frames/s, peak memory and a trace of one warm step; the plain path
   (``attn_impl="naive"``) on the same weights and batches: one
   ``forward_encode``'s logits, the first step's gradients and the losses
   within stated limits.
4. serve: ``repro_torch.launch.serve`` at full width (batch 8, prompt 512,
   32 new tokens, greedy) on smollm-135m, rwkv6-1.6b, recurrentgemma-9b,
   granite-moe-3b-a800m and paligemma-3b (its prompt 256 image patches
   before the 512 tokens: 18 K1 launches over 768 positions in prefill),
   one model resident at a time.  Every launch count
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
   timed at the smollm, granite-moe and recurrentgemma shapes, at
   hubert-xlarge's (hd 80, bidirectional), at 8 smollm lanes (the CLI's
   default count) folded into one batch of 64 and at phase 3j's 8 x 4096,
   in fp32 and bf16, beside ``scaled_dot_product_attention`` in fp32 and
   bf16 (``is_causal`` as the shape's mask;
   and the CUDA kernel it launched, by its profiler name) and both of its
   bounds.  K2 is timed
   in fp32 and bf16 beside its bound and its two-kernel design's floor,
   and each of its two kernels is reported: registers and spills, shared
   memory, blocks an SM and device time.  K1's backward is timed at K1's
   shapes in fp32 and bf16, beside its plain version, the backward
   of ``scaled_dot_product_attention`` and both of its bounds.  K2's and
   K3's backwards are timed at the training shapes beside their plain
   versions and bounds.
3i. roofline: ``ModelTrainable`` of smollm-135m at full width on the card
   under ``launch.train.device_model``'s config (K1 forward and backward),
   fp32, batch 8, sequence 512, 4 steps an iteration, 2 iterations, with
   ``profile_roofline=True``: after its profiled steps the trial counts one
   step of a replica on the meta device (``launch/roofline.py``'s
   ``step_costs`` on the kernel-free config).  Every launch count set to 0
   just before and read just after; the counting pass timed, its launches
   and the card's memory read around it.  Printed: the whole ``_profile``,
   the counting pass's wall seconds, ``launch.mesh.HW.HBM_BYTES`` beside
   the card's ``total_memory``.  Checks: the step's dot FLOPs are
   3,739,842,772,992, the count of JAX's ``hlo_costs`` for the same step;
   ``dominant`` is one of the three terms, every term above 0 but the
   collective one, which is 0 on one rank; the trial's losses and final
   parameters are bit for bit those of the same trial without the flag,
   run here too; K1 runs 30 times each way a step and the counting pass
   launches nothing; the card's memory after the count is within 64 MiB of
   before it.  It runs after every phase that needs whole profiler
   sessions.
3j. dry-run: ``python -m repro_torch.launch.dryrun`` for smollm-135m on the
   single-pod mesh (every shape: 3 counted, long_500k skipped) and its
   train_4k on the multi-pod mesh, for rwkv6-1.6b's, granite-moe-3b-a800m's
   and recurrentgemma-9b's train_4k and deepseek-moe-16b's decode_32k on
   the single-pod mesh, six subprocesses at once, each counting rank 0 of a
   fake process group of 256 or 512 ranks on the meta device, on the host
   with no card visible to them (``CUDA_VISIBLE_DEVICES`` empty), started
   before phase 4 and running while phases 4, 5, 3i, the one-card config
   below and the examples (3l) use the card (rwkv6's and recurrentgemma's
   counts take minutes).  Each record's dot FLOPs must equal JAX's count of
   the record less the difference named in ``tests/_torch_full_width.py``
   (``DRYRUN_FLOPS``); each record's roofline line and ``t_count_s`` are
   printed.  Then the record's config on one card: smollm-135m under
   ``dryrun_config`` (bf16, remat) at B=8, S=4096, counted by ``lower_one``
   on a (1,1) mesh (``DRYRUN_ONE_RANK_FLOPS``), and 3 AdamW steps of it on
   the card twice from the same weights and batches, on the kernel-free
   path that was counted and with ``attn_impl="pallas"`` (K1 forward and
   backward, bf16, hd 64: 60 forwards and 30 backwards a step under
   remat), every launch count set to 0 just before each and read just
   after.  Each path's peak memory is printed beside the record's
   ``arg_bytes + temp_bytes`` and its steady step beside ``step_time_s``
   (findings, not gates); the losses must be finite and the two paths'
   first-step losses within 2e-2 relative.
3l. examples: the port's four ``examples/*_torch.py`` run on the card as
   their scripts run with no arguments, four subprocesses at once; each
   must exit 0, its seconds printed.

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
# paligemma-3b, its prompt 256 image patches and 512 text tokens, MQA at hd
# 256 over 768 positions, 18 layers: at most 6.54e-6 (the v cache): 7e-5.
SERVE_TOL = {"smollm-135m": 2e-5, "rwkv6-1.6b": 1.5e-2, "recurrentgemma-9b": 1e-4,
             "granite-moe-3b-a800m": 2.5e-4, "paligemma-3b": 7e-5}
ARCHS = tuple(SERVE_TOL)
# A routing decision in which the kernel path picks another expert than the
# plain path must be a near-tie: the two experts' plain probabilities at
# most this far apart (the paths' inputs differ by rounding).  On an H100,
# 41 of 385,024 decisions differed, with gaps up to 1.18e-6: 1e-5.
FLIP_GAP = 1e-5
TRACE_DECODE_STEPS, TRACE_TOP = 8, 10
# PyTorch kernels a trace also prints when they are not in its top: the
# scans of the MoE dispatch's slot positions (``models/moe.py``), and NCCL's
# collectives (phase 3h's DTensor step).
TRACE_ALSO = ("tensor_kernel_scan", "nccl")
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


def trace(name: str, fn, card: str, ops):
    """Run ``fn`` once under ``torch.profiler`` (``profiled``); print wall
    time, the device's busy time and idle share, and the kernels with the
    most device time.  The launches of this repo's kernels that the trace
    kept are held against the ``ops.<name>.launches`` made during it
    (``trace_head``).  Returns {kernel of this repo: (device ms, launches
    kept)} and the device's busy ms under "busy", or None if not measured."""
    import torch
    events = {}

    def attempt():
        evs, wall_us, calls = _profile_once(torch, fn, cpu=True)
        events["kernels"] = _kernel_events(evs)
        return ([(e.key, e.count, e.self_device_time_total) for e in events["kernels"]],
                wall_us, calls)

    got = profiled(f"trace {name}", attempt)
    if got is None:
        return None
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
    out = {n: (sum(us for key, _, us in records if ours(n, key)) / 1e3,
               sum(c for key, c, _ in records if ours(n, key))) for n in KERNELS}
    nccl = [(c, us) for key, c, us in records if "nccl" in key.lower()]
    return {**{n: v for n, v in out.items() if v[1]}, "busy": busy_us / 1e3,
            "wall": wall_us / 1e3, "idle_share": 1 - busy_us / wall_us,
            "nccl": (sum(c for c, _ in nccl), sum(us for _, us in nccl) / 1e3)}


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
    ok = (kp[:, None, :] >= 0).expand_as(d)   # every query of a key in use, without a mask
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return int(ok.sum())


def attention_bound(q, k, v, qp, kp, causal=True, window=None):
    """Least time for the function on this card: operations (4*hd per allowed
    (query, key) pair, counted from these positions) over the fp32 CUDA-core
    peak, or bytes (each input read once, the output written once) over HBM.
    Then the bound on the tensor cores: fp32 as K1 runs each product, three
    TF32 products (3 x operations over the TF32 peak); bf16 the function's
    operations over the bf16 peak (K1 itself runs P V twice, P as bf16 hi +
    lo, so 1.5 x that is its scheme's floor); or bytes, whichever is
    larger.  Returns (ms, bound_by, flops, bytes, tensor-core ms, its
    bound_by)."""
    import torch
    H, hd = q.shape[2], q.shape[3]
    flops = 4.0 * hd * H * allowed_pairs(qp, kp, causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, qp, kp)) \
        + q.numel() * q.element_size()
    if q.dtype == torch.bfloat16:
        t_ops = flops / PEAK_BF16_FLOPS
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


def report_k1_build(torch, fa, nvcc: str, lib: Path, build_log: str, card: str) -> None:
    """K1's keys per tile, shared memory and blocks an SM for each (dtype,
    head_dim), as the card reports them, with its registers and spills
    (ptxas); then the instructions in each of its kernels' SASS
    (``cuobjdump -sass``), HMMA (tensor core) and LDSM (ldmatrix) counted
    apart."""
    import re
    ptx = ptxas_kernels(build_log)
    for dtype, tag in ((torch.float32, "f"), (torch.bfloat16, "13__nv_bfloat16")):
        for hd in fa.HEAD_DIMS:
            regs = [c for fn, c in ptx.items() if f"fwd_kernelI{tag}Li{hd}E" in fn]
            assert len(regs) == 1, f"no single forward kernel {dtype} {hd}"
            log(f"[build] flash_attention {str(dtype)[6:]} hd {hd}: "
                f"{fa.tile_config(dtype, hd)}; ptxas {regs[0]} {card}")
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


def router_sass(nvcc: str, lib: Path, kernel: str = "moe_router_kernel") -> dict:
    """For each instantiation of the router's ``kernel`` in ``lib`` (by its
    template arguments: dtype, then values a lane for the forward and lanes
    a row for the backward; the forward's that writes the row statistics
    marked "statistics"), its SASS instructions and the warp-wide ones
    among them: REDUX (redux.sync), VOTE (ballots), SHFL (shuffles)."""
    import re
    out = {}
    for fn, ins in sass_instructions(nvcc, lib).items():
        m = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)E(Lb1E)?", fn)
        if m:
            ops = [op.split(".")[0] for _, op, _ in ins]
            out[("float32" if m.group(1) == "f" else "bfloat16", int(m.group(2)))
                + (("statistics",) if m.group(3) else ())] = {
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
        # hd 80: hubert-xlarge's encoder (bidirectional) at its train shape, and
        # ragged lengths off the 64-row block and the 32-key tile both ways
        ("hubert-xlarge hd80 bidirectional", (8, 512, 512, 16, 16, 80), f32, {"causal": False},
         None),
        ("hubert-xlarge hd80 bidirectional bf16", (8, 512, 512, 16, 16, 80), bf16,
         {"causal": False}, None),
        ("hd80 ragged", (2, 77, 130, 4, 2, 80), f32, {}, None),
        ("hd80 ragged bf16", (2, 77, 130, 4, 2, 80), bf16, {}, None),
        ("hd80 ragged bidirectional", (2, 77, 130, 4, 2, 80), f32, {"causal": False}, None),
        ("hd80 ragged bidirectional bf16", (2, 77, 130, 4, 2, 80), bf16, {"causal": False},
         None),
        # paligemma-3b's prefill: 256 image patches and 512 text tokens, MQA hd 256
        ("paligemma-3b prefill hd256 MQA", (8, 768, 768, 8, 1, 256), f32, {}, None),
        # phase 3j's train step: smollm-135m under dryrun_config, 64 key tiles a row
        ("smollm dry-run config S=4096 bf16", (8, 4096, 4096, 9, 3, 64), bf16, {}, None),
    ]
    main_err = None
    for i, (name, shape, dtype, kw, edit) in enumerate(cases):
        kw = {"causal": True, **kw}
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
        out = ops.flash_attention(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        exp = ref.flash_attention_ref(q, k, v, qp, kp, **kw)
        assert out.shape == exp.shape and out.dtype == exp.dtype, name
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite output"
        err = max_err(out, exp)
        atol = ATOL[str(dtype).split(".")[1]]
        log(f"[kernel] flash_attention {name} {shape} {dtype} causal {kw['causal']}: max_abs_err "
            f"{err!r} (atol {atol})")
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
    shape, hubert-xlarge's (bidirectional, hd 80) and phase 3j's (S=4096).
    Returns the max abs
    error of dq, dk, dv at smollm's train shape, fp32."""
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
        ("hubert-xlarge train hd80 bidirectional", (8, 512, 512, 16, 16, 80), {"causal": False},
         None),
        ("hd80 ragged", (2, 77, 130, 4, 2, 80), {}, None),
        ("hd80 ragged bidirectional", (2, 77, 130, 4, 2, 80), {"causal": False}, None),
        ("smollm dry-run config S=4096", (8, 4096, 4096, 9, 3, 64), {}, None),
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
    for label, shape, causal in (("smollm train", (8, 512, 512, 9, 3, 64), True),
                                 ("hubert-xlarge train", (8, 512, 512, 16, 16, 80), False),
                                 ("smollm dry-run config", (8, 4096, 4096, 9, 3, 64), True)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, qp, kp = attention_inputs(torch, dev, 500, *shape, dtype)
            dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(650),
                               device=dev).to(dtype)
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            ops.flash_attention(q, k, v, qp, kp, causal=causal).backward(dout)
            # the plain forward in fp32 on the same values
            qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
            ref.flash_attention_ref(qr, kr, vr, qp, kp, causal=causal).backward(dout.float())
            torch.cuda.synchronize()
            rels = [normwise(a.grad, b.grad) for a, b in ((q, qr), (k, kr), (v, vr))]
            tol = FN_TOL[str(dtype)[6:]]
            log(f"[kernel] FlashAttentionFn {label} {shape} causal {causal} {dtype} vs autograd "
                f"of the plain forward (fp32): dq/dk/dv over max(1, max |g|) {rels} (tol {tol})")
            assert max(rels) <= tol, f"FlashAttentionFn {label} {dtype}: {rels} > {tol}"
    return main_err


# K1 under torch.func.vmap: smollm's train shape with VMAP_LANES lanes, the
# lanes folded into the batch axis by the vmap rules of FlashAttentionFn and
# FlashAttentionBwdFn.  The kernels treat each batch row alone, so every
# lane's output and gradients must be the lane-by-lane calls' bits; against
# vmap of the plain version (the plain forward in fp32 on the same values)
# K1's own limits hold: ATOL for the forward, FN_TOL for the gradients.
VMAP_LANES = 8
VMAP_SHAPE = (8, 512, 512, 9, 3, 64)


def check_flash_attention_vmap(torch, dev, ops, ref, card) -> dict:
    """K1's forward and ``vmap(grad)`` of it at VMAP_LANES x smollm's train
    shape, positions unbatched as the model builds them, fp32 and bf16: one
    launch each a call, every lane bit for bit the lane-by-lane calls, and
    within K1's limits of ``vmap`` of the plain version; the vmapped calls'
    times.  Returns the fp32 forward's max abs error against the plain
    version and the times."""
    from repro_torch.kernels import flash_attention as fa
    N, (B_, S_, _, H, K, hd) = VMAP_LANES, VMAP_SHAPE
    fwd = torch.func.vmap(lambda q, k, v, qp, kp: ops.flash_attention(q, k, v, qp, kp),
                          in_dims=(0, 0, 0, None, None))

    def loss(attn):
        return lambda q, k, v, qp, kp, d: (attn(q, k, v, qp, kp) * d).float().sum()

    grads = {name: torch.func.vmap(torch.func.grad(loss(attn), argnums=(0, 1, 2)),
                                   in_dims=(0, 0, 0, None, None, 0))
             for name, attn in (("kernel", ops.flash_attention),
                                ("plain", ref.flash_attention_ref))}
    out_fig = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, _ = attention_inputs(torch, dev, 700, N * B_, S_, S_, H, K, hd, dtype)
        q, k, v = (x.reshape(N, B_, *x.shape[1:]) for x in (q, k, v))
        qp = kp = torch.arange(S_, dtype=torch.int32, device=dev)[None].expand(B_, S_)
        dout = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(701),
                           device=dev).to(dtype)
        f0, b0 = ops.flash_attention.launches, ops.flash_attention_bwd.launches
        out = fwd(q, k, v, qp, kp)
        assert ops.flash_attention.launches - f0 == 1, "vmap of K1 launched it more than once"
        got = grads["kernel"](q, k, v, qp, kp, dout)
        torch.cuda.synchronize()
        assert (ops.flash_attention.launches - f0, ops.flash_attention_bwd.launches - b0) \
            == (2, 1), "vmap(grad) of K1 launched a pass more than once"
        for n in range(N):
            o, lse = fa.flash_attention_cuda(q[n], k[n], v[n], qp, kp, return_lse=True)
            lane = fa.flash_attention_bwd_cuda(q[n], k[n], v[n], qp, kp, o, lse, dout[n])
            assert torch.equal(out[n], o), f"{dtype} lane {n}: the forward's bits differ"
            assert all(torch.equal(a[n], b) for a, b in zip(got, lane)), \
                f"{dtype} lane {n}: the gradients' bits differ"
        plain_out = torch.func.vmap(lambda q, k, v: ref.flash_attention_ref(q, k, v, qp, kp))(
            q, k, v)
        err = max_err(out, plain_out)
        want = grads["plain"](q.float(), k.float(), v.float(), qp, kp, dout.float())
        rels = [max(normwise(a[n], b[n]) for n in range(N)) for a, b in zip(got, want)]
        name = str(dtype)[6:]
        atol, tol = ATOL[name], FN_TOL[name]
        fwd_ms = time_ms(lambda: fwd(q, k, v, qp, kp), iters=20)
        grad_ms = time_ms(lambda: grads["kernel"](q, k, v, qp, kp, dout), iters=10)
        log(f"[kernel] flash_attention under vmap, {N} lanes x {VMAP_SHAPE} {dtype}: one launch "
            f"of each pass a call, every lane bit for bit the lane-by-lane calls; against vmap of "
            f"the plain version: forward max_abs_err {err!r} (atol {atol}), dq/dk/dv over max(1, "
            f"max |g|) {rels} (tol {tol})")
        log(f"[time] flash_attention under vmap {dtype}, {N} lanes x B={B_} S={S_} H={H} K={K} "
            f"hd={hd}: forward {fwd_ms!r} ms, vmap(grad) (forward and backward) {grad_ms!r} ms "
            f"a call {card}")
        assert err <= atol, f"vmap of K1 {dtype}: max_abs_err {err} > {atol}"
        assert max(rels) <= tol, f"vmap(grad) of K1 {dtype}: {rels} > {tol}"
        out_fig[name] = {"max_abs_err": err, "grad_rel_err": max(rels), "fwd_ms": fwd_ms,
                         "grad_ms": grad_ms}
        del q, k, v, dout, out, got, want, plain_out
    return out_fig


# K2, K3 and K4 under torch.func.vmap, forward and vmap(grad), at
# VMAP_SCAN_LANES lanes of each kernel's training shape (phase 3k runs 2-4):
# K2 (B=8 S=512 H=32 N=64, chunk 32) folds the lanes into its heads, K3
# (B=8 S=512 R=4096) into its batch, K4 (granite's 16 groups x 256 tokens,
# E=40 k=8) puts them first as one more row axis.  Every (batch row,
# head), (batch row, channel) and row is then worked as in the lane's own
# call, so every lane's outputs and gradients must be the lane-by-lane
# ``*_cuda`` calls' bits, with one launch of each pass a call.
VMAP_SCAN_LANES = 4
VMAP_K2 = (8, 512, 32, 64)
VMAP_K3 = (8, 512, 4096)
VMAP_K4 = (16, 256, 40, 8)


def vmap_launches(ops, names, fn):
    """(``fn()``, the launches each wrapper of ``names`` made during it)."""
    before = [getattr(ops, n).launches for n in names]
    out = fn()
    return out, tuple(getattr(ops, n).launches - b for n, b in zip(names, before))


def check_scans_router_vmap(torch, dev, ops, card) -> dict:
    """K2's, K3's and K4's forwards and ``vmap(grad)`` of them at
    VMAP_SCAN_LANES lanes of their training shapes, fp32 and, where the kernel takes it,
    bf16: one launch of each pass a call, and every lane bit for bit the
    lane-by-lane calls.  K2's cases give every lane its own ``u`` (each
    lane's ``du`` must be its own) and its own initial state with a
    final-state gradient, then the model's: one zero state for every lane
    (unbatched, so expanded) and no final-state gradient.  K3's: ``h0``
    None, one a lane, one for every lane.  Returns each vmapped call's
    time."""
    from repro_torch.kernels import moe_router as k4
    from repro_torch.kernels import rglru_scan as k3
    from repro_torch.kernels import rwkv6_scan as k2
    n, fig = VMAP_SCAN_LANES, {}
    grad_of = lambda loss, argnums, dims: torch.func.vmap(
        torch.func.grad(loss, argnums=argnums), in_dims=dims)

    # K2: r, k, v, logw, u, state, dy, ds (None: the final state is not used)
    B_, S_, H, N = VMAP_K2
    for dtype in (torch.float32, torch.bfloat16):
        lanes = [rwkv_inputs(torch, dev, 800 + i, B_, S_, H, N, dtype) for i in range(n)]
        r, k, v, logw, u, s0 = (torch.stack(xs) for xs in zip(*lanes))
        del lanes
        g = torch.Generator(device=dev).manual_seed(810)
        dy = torch.randn(r.shape, generator=g, device=dev).to(dtype)
        ds = torch.randn(s0.shape, generator=g, device=dev)
        for case, state, ds_case in (("own u, own state, final-state gradient", s0, ds),
                                     ("own u, one zero state, no final-state gradient",
                                      torch.zeros_like(s0[0]), None)):
            sdim = 0 if state.dim() == 5 else None

            def loss(r, k, v, logw, u, st, dy, ds):
                y, s_out = ops.rwkv6_scan(r, k, v, logw, u, st)
                out = (y.float() * dy.float()).sum()
                return out if ds is None else out + (s_out * ds).sum()

            fwd = torch.func.vmap(ops.rwkv6_scan, in_dims=(0, 0, 0, 0, 0, sdim))
            grads = grad_of(loss, (0, 1, 2, 3, 4), (0, 0, 0, 0, 0, sdim, 0,
                                                    None if ds_case is None else 0))
            (y, s_out), f_n = vmap_launches(ops, ("rwkv6_scan",),
                                            lambda: fwd(r, k, v, logw, u, state))
            got, g_n = vmap_launches(ops, ("rwkv6_scan", "rwkv6_scan_bwd"),
                                     lambda: grads(r, k, v, logw, u, state, dy, ds_case))
            torch.cuda.synchronize()
            assert (f_n, g_n) == ((1,), (1, 1)), f"K2 under vmap, {case}: launches {f_n} {g_n}"
            for i in range(n):
                st = state if sdim is None else state[i]
                y1, s1, ws = k2.rwkv6_scan_cuda(r[i], k[i], v[i], logw[i], u[i], st,
                                                return_states=True)
                assert torch.equal(y[i], y1) and torch.equal(s_out[i], s1), \
                    f"K2 {dtype} {case} lane {i}: the forward's bits differ"
                lane = k2.rwkv6_scan_bwd_cuda(r[i], k[i], v[i], logw[i], u[i], st, ws, dy[i],
                                              None if ds_case is None else ds_case[i])
                assert all(torch.equal(a[i], b) for a, b in zip(got, lane[:5])), \
                    f"K2 {dtype} {case} lane {i}: the gradients' bits differ"
            du_spread = float((got[4][1:] - got[4][:1]).abs().amax(dim=(1, 2)).min())
            fwd_ms = time_ms(lambda: fwd(r, k, v, logw, u, state), iters=10)
            grad_ms = time_ms(lambda: grads(r, k, v, logw, u, state, dy, ds_case), iters=5)
            log(f"[kernel] rwkv6_scan under vmap, {n} lanes x {VMAP_K2} {dtype}, {case}: one "
                f"launch of each pass a call (lanes folded into the heads), every lane's y, "
                f"final state and dr/dk/dv/dlogw/du bit for bit its lane-by-lane calls' (the "
                f"lanes' du differ from lane 0's by at least {du_spread!r})")
            log(f"[time] rwkv6_scan under vmap {dtype}, {n} lanes x B={B_} S={S_} H={H} N={N}, "
                f"{case}: forward {fwd_ms!r} ms, vmap(grad) {grad_ms!r} ms a call {card}")
            fig[f"rwkv6_scan {str(dtype)[6:]} {case}"] = {"fwd_ms": fwd_ms, "grad_ms": grad_ms}
            del y, s_out, got
        del r, k, v, logw, u, s0, dy, ds

    # K3: a, b, h0 (None, one a lane, one for every lane), dh
    B_, S_, R = VMAP_K3
    lanes = [rglru_inputs(torch, dev, 820 + i, B_, S_, R) for i in range(n)]
    a, b, h0 = (torch.stack(xs) for xs in zip(*lanes))
    del lanes
    dh = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(830), device=dev)
    for case, h, hdim in (("h0 None", None, None), ("h0 one a lane", h0, 0),
                          ("h0 one for every lane", h0[0], None)):
        def loss(a, b, h, dh):
            return (ops.rglru_scan(a, b, h) * dh).sum()

        argnums = (0, 1) if h is None or hdim is None else (0, 1, 2)
        fwd = torch.func.vmap(ops.rglru_scan, in_dims=(0, 0, hdim))
        grads = grad_of(loss, argnums, (0, 0, hdim, 0))
        out, f_n = vmap_launches(ops, ("rglru_scan",), lambda: fwd(a, b, h))
        got, g_n = vmap_launches(ops, ("rglru_scan", "rglru_scan_bwd"),
                                 lambda: grads(a, b, h, dh))
        torch.cuda.synchronize()
        assert (f_n, g_n) == ((1,), (1, 1)), f"K3 under vmap, {case}: launches {f_n} {g_n}"
        for i in range(n):
            hi = h if h is None or hdim is None else h[i]
            h1 = k3.rglru_scan_cuda(a[i], b[i], hi)
            assert torch.equal(out[i], h1), f"K3 {case} lane {i}: the forward's bits differ"
            lane = k3.rglru_scan_bwd_cuda(a[i], hi, h1, dh[i])
            assert all(torch.equal(x[i], y) for x, y in zip(got, lane)), \
                f"K3 {case} lane {i}: the gradients' bits differ"
        fwd_ms = time_ms(lambda: fwd(a, b, h), iters=10)
        grad_ms = time_ms(lambda: grads(a, b, h, dh), iters=5)
        log(f"[kernel] rglru_scan under vmap, {n} lanes x {VMAP_K3} fp32, {case}: one launch of "
            f"each pass a call (lanes folded into the batch), every lane's h and gradients bit "
            f"for bit its lane-by-lane calls'")
        log(f"[time] rglru_scan under vmap, {n} lanes x B={B_} S={S_} R={R}, {case}: forward "
            f"{fwd_ms!r} ms, vmap(grad) {grad_ms!r} ms a call {card}")
        fig[f"rglru_scan {case}"] = {"fwd_ms": fwd_ms, "grad_ms": grad_ms}
        del out, got
    del a, b, h0, dh

    # K4: logits (G, S, E) a lane, the gradient dw of the weights
    G, S_, E, top_k = VMAP_K4
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.stack([router_logits(torch, dev, G * S_, E, 840 + i).reshape(G, S_, E)
                              for i in range(n)]).to(dtype)
        dw = torch.randn((n, G, S_, top_k), generator=torch.Generator(device=dev).manual_seed(850),
                         device=dev)
        fwd = torch.func.vmap(lambda x: ops.moe_router(x, top_k))
        grads = grad_of(lambda x, d: (ops.moe_router(x, top_k)[0] * d).sum(), 0, (0, 0))
        (w, idx), f_n = vmap_launches(ops, ("moe_router",), lambda: fwd(logits))
        got, g_n = vmap_launches(ops, ("moe_router", "moe_router_bwd"), lambda: grads(logits, dw))
        torch.cuda.synchronize()
        assert (f_n, g_n) == ((1,), (1, 1)), f"K4 under vmap {dtype}: launches {f_n} {g_n}"
        for i in range(n):
            w1, idx1, stats = k4.moe_router_cuda(logits[i], top_k, return_stats=True)
            assert torch.equal(w[i], w1) and torch.equal(idx[i], idx1), \
                f"K4 {dtype} lane {i}: the forward's bits differ"
            assert torch.equal(got[i], k4.moe_router_bwd_cuda(logits[i], w1, idx1, dw[i], stats)), \
                f"K4 {dtype} lane {i}: the gradient's bits differ"
        fwd_ms = time_ms(lambda: fwd(logits), iters=20)
        grad_ms = time_ms(lambda: grads(logits, dw), iters=10)
        log(f"[kernel] moe_router under vmap, {n} lanes x (G, S, E, k) {VMAP_K4} {dtype}: one "
            f"launch of each pass a call (lanes first, one more row axis), every lane's weights, "
            f"experts and dlogits bit for bit its lane-by-lane calls'")
        log(f"[time] moe_router under vmap {dtype}, {n} lanes x T={G * S_} E={E} k={top_k}: "
            f"forward {fwd_ms!r} ms, vmap(grad) {grad_ms!r} ms a call (host included) {card}")
        fig[f"moe_router {str(dtype)[6:]}"] = {"fwd_ms": fwd_ms, "grad_ms": grad_ms}
        del logits, dw, w, idx, got
    return fig


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


def row_exp_sum(torch, e):
    """Each row's sum of the exponentials ``e`` (T, E), in fp32 in the order
    of ``row_exp`` (``csrc/moe_router.cuh``): lane l adds its experts j*32 +
    l from slot 0 on (ceil(E/32) slots, rounded up to 1, 2, 4 or 8), then
    the 32 lanes' sums meet in a butterfly (offsets 16, 8, 4, 2, 1)."""
    T, E = e.shape
    vpl = next(v for v in (1, 2, 4, 8) if 32 * v >= E)
    lanes = torch.zeros((T, vpl * 32), dtype=torch.float32, device=e.device)
    lanes[:, :E] = e
    s = torch.zeros((T, 32), dtype=torch.float32, device=e.device)
    for j in range(vpl):
        s = s + lanes[:, 32 * j:32 * (j + 1)]
    while s.shape[1] > 1:
        s = s[:, :s.shape[1] // 2] + s[:, s.shape[1] // 2:]
    return s[:, 0]


def check_moe_router(torch, dev, ops, ref, router) -> float:
    """K4 against ``ref.moe_router_ref``: equal indices, weights within
    ``ROUTER_ATOL``.  On random logits an index may differ only where the
    two candidates' plain probabilities are within one fp32 ulp (the two
    softmaxes sum in other orders); each such case is printed and counted.
    Rows that tie (all zero) must match exactly.  Asked for its row
    statistics, the kernel gives the same weights and indices bit for bit;
    each row's max equals the plain fp32 max, and its sum of exponentials is
    within one ulp of the plain fp32 sum taken in the kernel's order
    (``row_exp_sum``)."""
    f32 = torch.float32
    main_err, near_ties = None, 0
    for i, (name, (T, E, k), dtype, zero) in enumerate(ROUTER_CASES):
        dtype = getattr(torch, dtype)
        logits = router_logits(torch, dev, T, E, 400 + i).to(dtype)
        if zero is not None:
            logits[zero] = 0
        w, idx = ops.moe_router(logits, k)
        ws, idxs, stats = router.moe_router_cuda(logits, k, return_stats=True)
        torch.cuda.synchronize()
        assert torch.equal(ws, w) and torch.equal(idxs, idx), \
            f"{name}: the statistics changed the weights or indices"
        x = logits.float()
        m = x.max(-1).values
        assert stats.shape == (T, 2) and torch.equal(stats[:, 0], m), f"{name}: row max differs"
        e = torch.exp(x - m[:, None])
        plain_s = row_exp_sum(torch, e)
        ulp = torch.nextafter(plain_s, torch.full_like(plain_s, math.inf)) - plain_s
        s_ulps = float(((stats[:, 1] - plain_s).abs() / ulp).max())
        any_order = float(((stats[:, 1] - e.sum(-1)).abs() / ulp).max())
        log(f"[kernel] moe_router {name} statistics: weights and indices bit for bit those "
            f"without them; max equal to the plain fp32 max; sum within {s_ulps!r} ulp of the "
            f"plain fp32 sum in the kernel's order (limit 1), {any_order!r} ulp of torch's sum")
        assert s_ulps <= 1, f"{name}: row sum {s_ulps} ulp from the plain sum"
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
    outputs and row statistics against ``ref.moe_router_bwd_ref`` at the
    cases of ``check_moe_router`` (the same logits), with seeded weight
    gradients, and against a second run of itself, bit for bit; each row's
    Z in the backward equal to the forward's bit for bit (both kernels write
    it on request).  Without the statistics the wrapper raises and launches
    nothing.  Rows where the
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
        z_fwd, z_bwd = (torch.empty(T, device=dev) for _ in range(2))
        w, idx, stats = router.moe_router_cuda(logits, k, return_stats=True, z=z_fwd)
        got = ops.moe_router_bwd(logits, w, idx, dw, stats)
        again = router.moe_router_bwd_cuda(logits, w, idx, dw, stats, z=z_bwd)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: two runs differ"
        assert torch.equal(z_fwd, z_bwd), f"{name}: the backward's Z is not the forward's"
        if i == 0:
            before = ops.moe_router_bwd.launches
            try:
                ops.moe_router_bwd(logits, w, idx, dw)
            except ValueError:
                pass
            else:
                raise AssertionError("the backward ran without the forward's statistics")
            assert ops.moe_router_bwd.launches == before
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
            "with another index, fed the kernel's; two runs and Z (forward and backward) bit "
            "for bit")
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
        _, idx, probs = self.real(logits, moe, "jnp")
        kidx = self.kernel_idx[self.calls]
        self.compare(idx, kidx, probs.detach())
        w = probs.gather(-1, kidx.long())
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), kidx, probs

    def compare(self, idx, kidx, probs):
        """Keep the gaps of call ``self.calls``'s rows whose experts differ
        between the plain path (``idx``, ``probs``) and the kernel path
        (``kidx``); count the call."""
        diff = idx != kidx
        rows = diff.any(-1)
        if bool(rows.any()):
            j = diff[rows].int().argmax(-1)               # the first slot that differs
            n = self.torch.arange(len(j), device=j.device)
            p = probs[rows]
            self.gaps.append((self.calls, p[n, idx[rows][n, j].long()]
                              - p[n, kidx[rows][n, j].long()]))
        self.calls += 1

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
    traced = trace(f"{TRAIN_ARCH} train step (warm)", one_step, card, ops)
    return {"launches": launches, "steady_step_s": steady, "tokens_per_s": B * S / steady,
            "peak_bytes": peak, "grad_rel_err": grad_err, "loss_rel_err": max(loss_err),
            "losses": res.losses, "idle_share": traced and traced["idle_share"]}


# Phase 3h: phase 3's train step on DTensor.  One card, so a world of one
# rank (NCCL, joined through a file store under a temp directory) and the
# (1,1) mesh of ``SlicePool(devices=[cuda:0]).acquire(1).make_mesh``: the
# ``fsdp_tp`` strategy's placements (every fsdp and tp entry a shard over a
# mesh dim of size 1), an ``activation_policy`` (``constrain`` at the
# embedding and every block boundary), K1 under ``local_map``
# (``dist.sharding.local_shards``).  The same weights and batches as phase
# 3's kernel path, so its losses and first-step gradients are held to phase
# 3's with phase 3's limits (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL).
SHARDED_STRATEGY, SHARDED_AXES = "fsdp_tp", ("data", "model")


def run_train_sharded(card: str, torch, ops, dev, train: dict) -> dict:
    """Phase 3h: ``TRAIN_ARCH`` trained ``TRAIN_STEPS`` steps on a sharded
    state through ``make_train_state`` / ``make_train_step``, every launch
    count set to 0 just before and read just after; losses and first-step
    gradients (``full_tensor()``) against phase 3's unsharded kernel path;
    the steady step beside phase 3's, and a trace of one warm step (idle
    share, NCCL's kernels).  The process group is destroyed before it
    returns."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.dist import SlicePool
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as launch_train
    from repro_torch.models import forward_train
    from repro_torch.train import adamw, linear_warmup_cosine, make_train_state, make_train_step

    cfg = launch_train.device_model(get_config(TRAIN_ARCH), dev)
    data = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S, vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(x).to(dev) for k, x in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    opt = adamw(linear_warmup_cosine(3e-4, 10, TRAIN_STEPS))   # launch.train's defaults
    gen = lambda: torch.Generator(device=dev).manual_seed(0)   # phase 3's weights

    # phase 3's kernel path, unsharded: its first-step gradients
    plain_state = make_train_state(gen(), cfg, opt, dev)
    ref_loss, ref_grads = first_step_grads(torch, forward_train, plain_state.params, batches[0],
                                           cfg)
    del plain_state
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = SlicePool(devices=[dev]).acquire(1).make_mesh(SHARDED_AXES)
            log(f"[sharded] {TRAIN_ARCH}: world of 1 rank (nccl), mesh {tuple(mesh.shape)} "
                f"{mesh.mesh_dim_names} over ranks {mesh.mesh.tolist()}, strategy "
                f"{SHARDED_STRATEGY}")
            with shd.sharding_strategy(SHARDED_STRATEGY), shd.activation_policy(mesh):
                state = shd.shard_train_state(make_train_state(gen(), cfg, opt, dev), mesh, cfg)
                placements = {str(tuple(p.placements)) for _, p in state.params.named_parameters()}
                sbatches = [shd.shard_batch(b, mesh) for b in batches]
                loss, grads = first_step_grads(torch, forward_train, state.params, sbatches[0],
                                               cfg)
                rel = {n: normwise(ref_grads[n], g.full_tensor()) for n, g in grads.items()}
                del grads, ref_grads
                worst = max(rel, key=rel.get)
                how = "bit for bit" if max(rel.values()) == 0 else \
                    f"max abs err over max(1, max |g|) {rel[worst]!r} ({worst})"
                log(f"[sharded] {TRAIN_ARCH} first-step gradients, sharded vs phase 3's "
                    f"unsharded kernel path: {how}; loss {loss!r} vs {ref_loss!r} (tol "
                    f"{TRAIN_GRAD_TOL}); parameter placements {sorted(placements)}")
                assert rel[worst] <= TRAIN_GRAD_TOL, f"sharded first-step gradient {worst}"

                step = make_train_step(cfg, opt)
                torch.cuda.synchronize()
                for name in KERNELS:
                    getattr(ops, name).launches = 0
                losses, step_s = [], []
                for b in sbatches:
                    t0 = time.perf_counter()
                    state, metrics = step(state, b)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    losses.append(float(metrics["loss"]))
                launches = {name: getattr(ops, name).launches for name in KERNELS}
                expect = expected_train_launches(cfg, TRAIN_STEPS)
                log(f"[sharded] {TRAIN_ARCH}: kernel launches on the main path: {launches} "
                    f"({TRAIN_STEPS} steps; expected {expect})")
                assert launches == expect, f"sharded train: expected {expect} launches"
                loss_err = [abs(p - k) / max(1.0, abs(k)) for p, k in zip(losses, train["losses"])]
                how = "bit for bit" if max(loss_err) == 0 else \
                    f"differences over max(1, |loss|) {loss_err}"
                log(f"[sharded] {TRAIN_ARCH} losses {losses} vs phase 3's {train['losses']}: "
                    f"{how} (tol {TRAIN_LOSS_TOL})")
                assert max(loss_err) <= TRAIN_LOSS_TOL, f"sharded losses differ: {loss_err}"
                steady = min(step_s[1:])
                held = {"state": state}

                def one_step():
                    held["state"], _ = step(held["state"], sbatches[0])

                one_step()                                            # warm-up
                traced = trace(f"{TRAIN_ARCH} sharded train step (warm)", one_step, card, ops)
            del held, state, sbatches
            gc.collect()
            torch.cuda.empty_cache()
            families = {sharded_family_key(arch, impl): run_family_sharded(
                card, torch, ops, dev, mesh, arch, layers, remat, impl)
                for arch, layers, remat, impl in SHARDED_FAMILIES}
        finally:
            dist.destroy_process_group()
    per_step = {name: n // TRAIN_STEPS for name, n in launches.items() if n}
    nccl = traced and traced["nccl"]
    log(f"[time] {TRAIN_ARCH} sharded train step B={B} S={S} fp32, mesh (1,1): first "
        f"{step_s[0]!r} s, steady (min of the other {TRAIN_STEPS - 1}) {steady!r} s (steps "
        f"{step_s}) vs phase 3's steady {train['steady_step_s']!r} s "
        f"({steady / train['steady_step_s']!r}x); launches a step {per_step}; idle share "
        f"{traced and traced['idle_share']!r} (phase 3's {train['idle_share']!r}); NCCL kernels "
        f"in the warm step's trace: {nccl[0] if nccl else 'not measured'} launches, "
        f"{nccl[1] if nccl else 'not measured'} ms {card}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steady_step_s": steady, "first_step_s": step_s[0],
            "unsharded_steady_step_s": train["steady_step_s"],
            "idle_share": traced and traced["idle_share"], "nccl_kernels": nccl,
            "grad_rel_err": rel[worst], "loss_rel_err": max(loss_err), "families": families}


# Phase 3c: the ssm and hybrid families trained through ``launch.train`` at
# full width, fp32, B x S tokens a step, TRAIN_R_STEPS steps each, on the
# scan kernels and their backwards: rwkv6-1.6b at full depth (24 layers, no
# remat; at 12 layers ``wkv_bwd_precision``'s ratios ran from 0.16 to 3.66
# over three weight draws on an H100, ``chip_probe.py --k2-backward``: where
# the plain chunked scan's own error falls below an fp32 ulp of max |g|,
# any kernel error of a few ulps reads as a large ratio; at 24 layers they
# stay within the limit of 2), then recurrentgemma-9b with its depth cut to one
# repeat of (rglru, rglru, local_attn), 3 of its 38 layers (remat as
# configured, so the repeat's forward runs again in the backward; at two
# repeats, 2.36 B parameters, the first step's AdamW update ran out of the
# card's 80 GB).
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
    with remat one more forward (``torch.utils.checkpoint``, or the vmapped
    lanes' chain of stages in ``launch.tune.loss_and_grads``, runs each
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
    """(loss, {name: gradient}) of one ``forward_train`` of ``cfg``; of a
    DTensor loss, its full value."""
    loss, _ = forward_train(params, batch, cfg)
    names, tensors = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, tensors)))
    loss = loss.detach()
    return float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss), grads


def train_traced(card, torch, ops, dev, cfg, tag: str) -> dict:
    """Train ``cfg`` for ``TRAIN_R_STEPS`` steps through ``launch.train``,
    with every launch count set to 0 just before and read just after and
    held to ``expected_train_launches``; print the steady step time,
    tokens/s and peak memory; trace one warm step.  Returns the config
    trained (``device_model``'s), its losses, the launch counts, the
    figures, the batches and the optimizer, with the trained state freed.
    An audio config's B x S are frames."""
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
    assert cfg == launch_train.device_model(cfg, dev) and cfg.attn_impl == "pallas"
    assert len(res.losses) == TRAIN_R_STEPS and all(math.isfinite(x) for x in res.losses)
    steady = min(res.step_s[1:])
    n_params = param_count(res.state.params)
    unit = "frames" if cfg.frontend == "audio_stub" else "tokens"
    log(f"[time] {tag} train step B={B} S={S} fp32, {n_params:,} parameters: first "
        f"{res.step_s[0]!r} s, steady (min of the other {TRAIN_R_STEPS - 1}) {steady!r} s "
        f"(steps {res.step_s}), {B * S / steady!r} {unit}/s, peak device memory "
        f"{peak / 2**20:.1f} MiB {card}")

    batch_at = launch_train.batch_source(cfg, B, S)   # the batches launch.train drew
    batches = [{k: torch.from_numpy(x).to(dev) for k, x in batch_at(i).items()}
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
    traced = trace(f"{tag} train step (warm)", one_step, card, ops)
    del held, kstep
    gc.collect()
    torch.cuda.empty_cache()
    return {"cfg": cfg, "losses": losses, "launches": launches, "batches": batches, "opt": opt,
            "trace": traced, "figures": {"steady_step_s": steady, f"{unit}_per_s": B * S / steady,
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
    k4_bwd = (run["trace"] or {}).get("moe_router_bwd")
    if k4_bwd is None:
        log(f"[train] {tag}: K4's backward in the warm step's trace: not measured")
    else:
        ms, n = k4_bwd
        log(f"[train] {tag}: K4's backward in the warm step's trace: {ms!r} device ms over {n} "
            f"launches ({1e3 * ms / n!r} us each), {ms / run['trace']['busy']!r} of the step's "
            f"{run['trace']['busy']!r} device busy ms {card}")

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
            "first_step_routing_flips": first_flips,
            "k4_bwd_trace_ms": None if k4_bwd is None else k4_bwd[0]}


# Phase 3h's other token families, after smollm-135m and in the same world
# and on the same (1,1) mesh, ``fsdp_tp`` and ``activation_policy``: each
# at full width, fp32, B x S tokens a step, SHARDED_FAMILY_STEPS steps
# through ``make_train_state`` / ``make_train_step``, its kernels on each
# rank's shards under ``local_map`` (``dist.sharding.local_rwkv6_scan``,
# ``local_rglru_scan``, ``local_moe_router``, and K1's ``local_shards``).
# (arch, layers, remat, MoE dispatch), phase 3k's depths: rwkv6-1.6b 3 of
# 24 layers (3 K2 each way a step), recurrentgemma-9b one repeat, 3 of 38
# layers, with its config's remat (4 K3 and 2 K1 forwards, 2 K3 and 1 K1
# backwards a step), granite-moe-3b-a800m 3 of 32 layers with phase 3d's
# remat (6 K1 and 6 K4 forwards, 3 of each backward), with its einsum
# dispatch and with the sort/scatter one (``local_moe_scatter``; the same
# launches).  Held against the unsharded
# kernel path of the same config on the same weights (seed 0 on the card)
# and batches: the launch counts equal (``expected_train_launches``), and
# on a mesh of one rank the same kernels run on the same tensors, so the
# first step's loss and every parameter's gradient (``full_tensor()``) and
# every step's loss are expected bit for bit; where not, within phases
# 3c's and 3d's limits (TRAIN_R_GRAD_TOL, TRAIN_R_LOSS_TOL,
# TRAIN_MOE_GRAD_TOL, TRAIN_MOE_LOSS_TOL; rwkv6's losses within 4e-3), the
# gap printed.  rwkv6's random-init gradients are chaotic (phase 3c), so
# where they are not bit for bit, each K2 forward's outputs of the first
# step must be, between the two paths.
SHARDED_FAMILIES = (("rwkv6-1.6b", 3, False, None), ("recurrentgemma-9b", 3, True, None),
                    ("granite-moe-3b-a800m", 3, True, None),
                    ("granite-moe-3b-a800m", 3, True, "scatter"))
SHARDED_FAMILY_STEPS = 3
SHARDED_GRAD_TOL = {"recurrentgemma-9b": TRAIN_R_GRAD_TOL["recurrentgemma-9b"],
                    "granite-moe-3b-a800m": TRAIN_MOE_GRAD_TOL}
SHARDED_LOSS_TOL = {**TRAIN_R_LOSS_TOL, "granite-moe-3b-a800m": TRAIN_MOE_LOSS_TOL}


def sharded_family_key(arch: str, moe_impl) -> str:
    """A ``SHARDED_FAMILIES`` entry's name: the arch, and the MoE dispatch
    where one is named."""
    return f"{arch} {moe_impl}" if moe_impl else arch


def run_family_sharded(card: str, torch, ops, dev, mesh, arch: str, n_layers: int,
                       remat: bool, moe_impl=None) -> dict:
    """Phase 3h for one of ``SHARDED_FAMILIES`` on ``mesh``: the first
    step's loss and gradients and then SHARDED_FAMILY_STEPS steps, each on
    the sharded state and on the unsharded one (every launch count set to 0
    just before the steps and read just after), held against each other;
    each path's steady step, peak memory and a trace of one warm step."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import rwkv6_scan as k2
    from repro_torch.launch import train as launch_train
    from repro_torch.models import forward_train
    from repro_torch.train import adamw, linear_warmup_cosine, make_train_state, make_train_step

    full, steps = get_config(arch), SHARDED_FAMILY_STEPS
    cfg = dataclasses.replace(full, n_layers=n_layers, remat=remat)
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    cfg = launch_train.device_model(cfg, dev)
    tag = f"{sharded_family_key(arch, moe_impl)} ({n_layers} of {full.n_layers} layers)"
    batch_at = launch_train.batch_source(cfg, B, S)
    batches = [{k: torch.from_numpy(x).to(dev) for k, x in batch_at(i).items()}
               for i in range(steps)]
    opt = adamw(linear_warmup_cosine(3e-4, 10, steps))   # launch.train's defaults
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    k2_out = {"unsharded": [], "sharded": []}   # each K2 forward's (y, final state)

    def keeping(path):
        def keep(*a, **kw):
            out = real_k2(*a, **kw)
            k2_out[path].append([t.detach().clone() for t in out[:2]])
            return out
        return patched(k2, "rwkv6_scan_cuda", keep)

    def policy(path):
        """The sharded path's strategy and activation policy; none for the other."""
        return contextlib.nullcontext() if path == "unsharded" else _sharded_policy(shd, mesh)

    def state_and_batches(path):
        state = make_train_state(gen(), cfg, opt, dev)
        if path == "unsharded":
            return state, batches
        return shd.shard_train_state(state, mesh, cfg), [shd.shard_batch(b, mesh) for b in batches]

    # the first step's loss and gradients, unsharded then sharded, one state at a time
    real_k2, first = k2.rwkv6_scan_cuda, {}
    for path in ("unsharded", "sharded"):
        with policy(path), keeping(path):
            state, sb = state_and_batches(path)
            loss, grads = first_step_grads(torch, forward_train, state.params, sb[0], cfg)
            first[path] = (loss, {n: g.full_tensor() if hasattr(g, "full_tensor") else g
                                  for n, g in grads.items()})
        del state, sb, grads
        gc.collect()
        torch.cuda.empty_cache()
    ref_loss, ref_grads = first["unsharded"]
    loss, grads = first["sharded"]
    rel = {n: normwise(ref_grads[n], g) for n, g in grads.items()}
    del first, grads, ref_grads
    worst = max(rel, key=rel.get)
    grad_bitwise = max(rel.values()) == 0 and loss == ref_loss
    how = "bit for bit" if grad_bitwise else \
        f"max abs err over max(1, max |g|) {rel[worst]!r} ({worst}; median over the {len(rel)} " \
        f"parameters {statistics.median(rel.values())!r})"
    log(f"[sharded] {tag} first-step gradients, sharded vs the unsharded kernel path: {how}; "
        f"loss {loss!r} vs {ref_loss!r}" +
        (f" (limit {SHARDED_GRAD_TOL[arch]})" if arch in SHARDED_GRAD_TOL else ""))
    k2_bitwise = None
    if cfg.family == "ssm":
        outs = k2_out.values()
        assert all(len(o) == n_layers for o in outs), {p: len(o) for p, o in k2_out.items()}
        k2_bitwise = all(torch.equal(a, b) for u, s in zip(*outs) for a, b in zip(u, s))
        log(f"[sharded] {tag} the first step's {n_layers} K2 forwards' outputs (y, final "
            f"state), sharded vs unsharded: {'bit for bit' if k2_bitwise else 'differ'}")
        assert grad_bitwise or k2_bitwise, f"{arch} sharded: K2's outputs differ"
    else:
        assert rel[worst] <= SHARDED_GRAD_TOL[arch], f"{arch} sharded first-step gradient {worst}"
    del k2_out

    # the steps, sharded then unsharded, each from seed 0's weights
    runs = {}
    for path in ("sharded", "unsharded"):
        with policy(path):
            state, sb = state_and_batches(path)
            step = make_train_step(cfg, opt)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            for name in KERNELS:
                getattr(ops, name).launches = 0
            losses, step_s = [], []
            for b in sb:
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
            launches = {name: getattr(ops, name).launches for name in KERNELS}
            peak = torch.cuda.max_memory_allocated()
            expect = expected_train_launches(cfg, steps)
            log(f"[sharded] {tag} {path}: kernel launches on the main path: {launches} ({steps} "
                f"steps; remat {cfg.remat}; expected {expect})")
            assert launches == expect, f"{arch} {path} train: expected {expect} launches"
            assert all(math.isfinite(x) for x in losses)
            held = {"state": state}
            del state

            def one_step():
                held["state"], _ = step(held["state"], sb[0])

            one_step()                                            # warm-up
            traced = trace(f"{tag} {path} train step (warm)", one_step, card, ops)
            del held, sb, step
        gc.collect()
        torch.cuda.empty_cache()
        runs[path] = {"launches": launches, "losses": losses, "step_s": step_s,
                      "steady": min(step_s[1:]), "peak": peak, "trace": traced}
    sh, un = runs["sharded"], runs["unsharded"]
    loss_err = [abs(p - k) / max(1.0, abs(k)) for p, k in zip(sh["losses"], un["losses"])]
    how = "bit for bit" if max(loss_err) == 0 else f"differences over max(1, |loss|) {loss_err}"
    log(f"[sharded] {tag} losses {sh['losses']} vs unsharded {un['losses']}: {how} (limit "
        f"{SHARDED_LOSS_TOL[arch]})")
    assert max(loss_err) <= SHARDED_LOSS_TOL[arch], f"{arch} sharded losses differ: {loss_err}"
    idle = {p: r["trace"] and r["trace"]["idle_share"] for p, r in runs.items()}
    nccl = sh["trace"] and sh["trace"]["nccl"]
    ratio = sh["steady"] / un["steady"]
    log(f"[time] {tag} sharded train step B={B} S={S} fp32, mesh (1,1): first "
        f"{sh['step_s'][0]!r} s, steady (min of the other {steps - 1}) {sh['steady']!r} s (steps "
        f"{sh['step_s']}) vs unsharded steady {un['steady']!r} s (steps {un['step_s']}; "
        f"{ratio!r}x); peak device memory {sh['peak'] / 2**20:.1f} MiB vs unsharded "
        f"{un['peak'] / 2**20:.1f} MiB; idle share of a warm step {idle['sharded']!r} vs "
        f"unsharded {idle['unsharded']!r}; NCCL kernels in the warm step's trace: "
        f"{nccl[0] if nccl else 'not measured'} launches {card}")
    return {"launches": sh["launches"], "steady_step_s": sh["steady"],
            "unsharded_steady_step_s": un["steady"], "ratio": ratio,
            "first_step_s": sh["step_s"][0], "peak_bytes": sh["peak"],
            "unsharded_peak_bytes": un["peak"], "idle_share": idle["sharded"],
            "unsharded_idle_share": idle["unsharded"], "nccl_kernels": nccl,
            "grad_rel_err": rel[worst], "grad_bitwise": grad_bitwise,
            "k2_outputs_bitwise": k2_bitwise, "loss_rel_err": max(loss_err)}


@contextlib.contextmanager
def _sharded_policy(shd, mesh):
    """Phase 3h's ``fsdp_tp`` strategy and activation policy on ``mesh``."""
    with shd.sharding_strategy(SHARDED_STRATEGY), shd.activation_policy(mesh):
        yield


# Phase 3f: the audio family trained through ``launch.train`` at full width
# and full depth, fp32, TRAIN_R_STEPS steps: hubert-xlarge (48 layers, d
# 1280, 16 heads of 80, d_ff 5120, 504 units; 945,758,720 parameters, 26.5
# GB with their gradients and AdamW's state at 28 B a parameter), B x S
# frames a step of conv-feature stubs (``synthetic_batch``, seeded with the
# step), its encoder bidirectional: 48 K1 forwards and 48 K1 backwards a
# step, hd 80.  Kernel path against the plain path (``attn_impl="naive"``)
# on the same weights and batches, as phase 3c holds recurrentgemma-9b: the
# first step's gradient of every parameter, max |plain - kernel| over
# max(1, max |kernel|), each step's loss on the plain path's own trajectory,
# |plain - kernel| over max(1, |kernel|), and one ``forward_encode`` of the
# first batch, its logits' max |plain - kernel| over max(1, max |kernel|).
# Each limit is about 10x the largest reading on an H100: the first-step
# gradients 2.40e-7 (the embedding table; the frontend's 9.0e-9), the losses
# 7.36e-8, the logits 6.82e-6: 2.5e-6, 1e-6 and 7e-5.
TRAIN_AUDIO = "hubert-xlarge"
TRAIN_AUDIO_GRAD_TOL, TRAIN_AUDIO_LOSS_TOL, ENCODE_TOL = 2.5e-6, 1e-6, 7e-5


def run_train_audio(card, torch, ops, dev) -> dict:
    """Phase 3f: train ``TRAIN_AUDIO`` at full width and depth through
    ``launch.train`` with every launch count set to 0 just before and read
    just after; time it and trace one warm step; hold its first step's
    gradients, its losses and one ``forward_encode`` against the plain
    path."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward_encode, forward_train, init_params
    from repro_torch.train import TrainState, make_train_step

    cfg = get_config(TRAIN_AUDIO)
    run = train_traced(card, torch, ops, dev, cfg, TRAIN_AUDIO)
    cfg, batches, opt, kernel_losses = run["cfg"], run["batches"], run["opt"], run["losses"]
    assert cfg.encoder_only and cfg.hd == 80 and cfg.n_layers == 48
    assert run["launches"]["flash_attention"] == run["launches"]["flash_attention_bwd"] == \
        cfg.n_layers * TRAIN_R_STEPS

    plain = dataclasses.replace(cfg, attn_impl="naive")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    with torch.no_grad():
        enc = {tag: forward_encode(params, {"features": batches[0]["features"]}, c)
               for tag, c in (("kernel", cfg), ("plain", plain))}
    assert enc["kernel"].shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(enc["kernel"]).all())
    enc_err = normwise(enc["plain"], enc["kernel"])
    log(f"[train] {TRAIN_AUDIO} forward_encode of the first batch, kernel path vs plain path: "
        f"logits' max abs err over max(1, max |kernel|) {enc_err!r} (limit {ENCODE_TOL})")
    assert enc_err <= ENCODE_TOL, f"{TRAIN_AUDIO} forward_encode: {enc_err} > {ENCODE_TOL}"
    del enc

    first = {tag: first_step_grads(torch, forward_train, params, batches[0], c)
             for tag, c in (("kernel", cfg), ("plain", plain))}
    rel = {n: normwise(first["plain"][1][n], g) for n, g in first["kernel"][1].items()}
    worst = max(rel, key=rel.get)
    grad_err, median = rel[worst], statistics.median(rel.values())
    assert float(first["kernel"][1]["frontend.proj.weight"].abs().max()) > 0
    log(f"[train] {TRAIN_AUDIO} first-step gradients, kernel path vs plain path, max abs err "
        f"over max(1, max |g|): {grad_err!r} ({worst}; median over the {len(rel)} parameters "
        f"{median!r}; the frontend's {rel['frontend.proj.weight']!r}); loss "
        f"{first['kernel'][0]!r} vs {first['plain'][0]!r} (limit {TRAIN_AUDIO_GRAD_TOL})")
    assert grad_err <= TRAIN_AUDIO_GRAD_TOL, \
        f"{TRAIN_AUDIO} first-step gradient {worst}: {grad_err} > {TRAIN_AUDIO_GRAD_TOL}"
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
    log(f"[train] {TRAIN_AUDIO} losses, kernel path {kernel_losses}, plain path {plain_losses}; "
        f"differences over max(1, |loss|) {loss_err} (limit {TRAIN_AUDIO_LOSS_TOL})")
    assert max(loss_err) <= TRAIN_AUDIO_LOSS_TOL, f"{TRAIN_AUDIO} losses differ: {loss_err}"
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run["launches"], **run["figures"], "grad_rel_err": grad_err,
            "loss_rel_err": max(loss_err), "encode_rel_err": enc_err}


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


# The vmap phase (3g): phase 3b's sweep through ``repro_torch.launch.tune``
# with ``--executor vmap`` and VMAP_SWEEP_LANES samples: its trials are the
# lanes of one ``torch.func.vmap`` step (momentum SGD over lr and
# weight_decay, ``build_vmap_executor``), K1's forward and backward each
# launched once a layer for all lanes.  In the second step of an iteration
# a lane holds two states (the executor's input and the first step's
# output; p and m, 1.08 GB each) beside its step's peak over its state:
# 9,128 MiB through ``loss_and_grads`` or autograd, 16,097 MiB through
# ``torch.func.grad``, which keeps a graph of the backward (on an H100 80GB
# HBM3 at 700 W).  So 6 lanes peak at ~67 GiB; 7 ran out of the card's
# 79.18 GiB in the second step, 8 in the first; 4 fitted under
# ``torch.func.grad``.  Every trial must end
# TERMINATED, K1's launches must
# be 30 each way a stacked step (a step of all lanes), and the device memory
# in use must come back within SWEEP_MEM_SLACK.  Then, on a stacked state of
# the lanes with different weights (seeds 0-5) at different steps of the
# bank (i = 0-5), so that a lane mixed up with another shows, and the
# sweep's own lr and weight_decay: each lane's first-step loss and
# gradients against the plain path (``attn_impl="naive"``) under the same
# vmap, within the train phase's limits, and each lane's loss against that
# lane stepped alone through the unvmapped ``step_fn``, within the train
# phase's loss limit (``vmap_lane_checks``, which phase 3k runs too).
VMAP_SWEEP_LANES = 6     # the CLI's default is 8
VMAP_SWEEP_ARGS = with_flags(SWEEP_ARGS, executor="vmap", num_samples=VMAP_SWEEP_LANES)
# The plain path's lanes in one vmap: its S x S attention scores for all
# lanes do not fit beside the stacked state on an 80 GB card.
VMAP_PLAIN_LANES = 2
VMAP_TIMED_STEPS = 3
# One lane's step three ways (``lane_step_peaks``): its gradients through
# ``loss_and_grads`` (a pull-back without a graph of the backward), through
# ``torch.func.grad_and_value`` (its backward with ``create_graph=True``)
# and through autograd's backward of ``forward_train``; the turns' order.
LANE_PEAK_WAYS = ("loss_and_grads", "grad_and_value", "autograd")
LANE_PEAK_TURNS = LANE_PEAK_WAYS + LANE_PEAK_WAYS[::-1]
# loss_and_grads' peak must be at most this share of grad_and_value's.
LANE_PEAK_SHARE = 2 / 3


# The vmap phase of the other token families (3k): phase 3g's sweep through
# ``repro_torch.launch.tune --executor vmap`` for rwkv6-1.6b, recurrentgemma-9b
# and granite-moe-3b-a800m at full width (d_model, heads, head size, experts,
# vocab), K2, K3 and K4 forward and backward each launched once a layer for
# all lanes beside K1 in the hybrid's local attention and the MoE's
# attention.  ``build_vmap_executor`` trains each config's remat: rwkv6's and
# granite's have none, so a lane keeps every layer's activations for its
# backward; recurrentgemma-9b's has it, so a lane keeps its repeat's input
# and runs the repeat again for its gradients (``loss_and_grads``).  A lane
# of momentum SGD holds about 20 B a parameter at its update (p, m, the
# gradients, the new p and m).  Each arch's cut, (lanes, layers, batch),
# with its reckoning on an 80 GB card (made without remat):
# - rwkv6-1.6b (24 layers, 55.5 M parameters a layer, 268 M in its
#   embedding and head): 4 lanes of 3 layers, B=8: 435 M parameters, 35 GB
#   of lanes at the update; the backward holds the lanes' activations (~1.5
#   GB a layer and ~4 GB of logits and their gradient a lane), and at 4
#   layers it ran out of the card (on an H100 80GB HBM3 at 700 W, 75.9 GiB
#   allocated when the embedding's batched gradient, 2 GiB, was asked for).
# - recurrentgemma-9b (38 layers; 1.05 B parameters in its 256,000 x 4,096
#   embedding, 219 M a layer): 2 lanes of one repeat (3 layers: 2 RG-LRU, 1
#   local attention), B=2: 1.71 B parameters, 68 GB of lanes at the update,
#   which leaves ~10 GB for two lanes' activations; at B=8 one lane's fp32
#   logits alone are 4.2 GB, and 4 lanes' state 136 GB.
# - granite-moe-3b-a800m (32 layers, 101 M parameters a layer): 4 lanes of 3
#   layers, B=8: 378 M parameters, 30 GB of lanes at the update; the
#   einsum dispatch keeps ~1.4 GB a layer for the backward under autograd.
# Every trial must end TERMINATED and the device memory in use come back
# within SWEEP_MEM_SLACK.  The sweep keeps no checkpoints (the executor's
# ``checkpoint_freq`` set to 0): a lane's snapshot is 3.0-13.6 GB here, and
# phase 3g spilled 1.08 GB ones at ~2 s a GB; 3g measures their share.  Then
# lanes of different weights (seeds) and batches: each lane's first-step
# loss and gradients against the plain path (``attn_impl="naive"``,
# ``kernel_impl="jnp"``) under the same vmap, VMAP_PLAIN_LANES at a time,
# within phases 3c's and 3d's limits (rwkv6 on the parameters the plain fp32
# path resolves against float64, as phase 3c holds it; granite with the
# plain path's routing teacher-forced to the kernel path's, each flip a
# near-tie), and each lane's loss against the lane stepped alone through
# the unvmapped ``step_fn`` within phase 3g's loss limit.
VMAP_FAMILIES = (("rwkv6-1.6b", 4, 3, 8), ("recurrentgemma-9b", 2, 3, 2),
                 ("granite-moe-3b-a800m", 4, 3, 8))
VMAP_FAMILY_ITERS = 2
# Each family's peak over the stacked steps (MiB) when the lanes' gradients
# came through ``torch.func.grad`` (its backward kept a graph of itself) and
# recurrentgemma-9b's lanes ran without remat, read on an H100 80GB HBM3 at
# 700 W: printed beside this run's.
VMAP_FAMILY_GRAD_PEAKS = {"rwkv6-1.6b": 68162.3, "recurrentgemma-9b": 68099.1,
                          "granite-moe-3b-a800m": 59828.2}
# The lane checks' limits: the train phases' (3, 3c, 3d); rwkv6's gradients
# are held against float64 instead (``check_grads_vs_f64``).
VMAP_GRAD_TOL = {TRAIN_ARCH: TRAIN_GRAD_TOL,
                 "recurrentgemma-9b": TRAIN_R_GRAD_TOL["recurrentgemma-9b"],
                 "granite-moe-3b-a800m": TRAIN_MOE_GRAD_TOL}
VMAP_LOSS_TOL = {TRAIN_ARCH: TRAIN_LOSS_TOL, **TRAIN_R_LOSS_TOL,
                 "granite-moe-3b-a800m": TRAIN_MOE_LOSS_TOL}


def vmap_sweep(card: str, torch, ops, argv, tag: str, n_lanes: int, n_layers=None,
               checkpoints: bool = True):
    """``launch.tune.main(argv)`` with ``--executor vmap`` and a log
    directory under a temp directory: every launch count set to 0 just
    before and read just after, the stacked steps (synchronised) and the
    lane saves timed; with ``n_layers`` the arch's depth cut to that many
    layers, without ``checkpoints`` the executor's ``checkpoint_freq`` 0.
    Every trial must end TERMINATED, the sweep run ``n_lanes`` lanes and
    launch each kernel as ``expected_train_launches`` says, and the device
    memory in use come back within SWEEP_MEM_SLACK.  Returns (the lanes'
    config, the parsed arguments, the trials' configs, the figures)."""
    import os
    import tempfile

    from repro_torch.launch import tune

    record = {"steps": [], "saves": [], "lanes": None}
    build, real_config = tune.build_vmap_executor, tune.get_config

    def timed_build(c, a):
        """The launcher's executor, its stacked steps (synchronised) and its
        checkpoints timed."""
        ex = build(c, a)
        if not checkpoints:
            ex.checkpoint_freq = 0
        vstep, save = ex._vstep, ex.save_checkpoint
        record["lanes"] = ex.n_lanes

        def timed_vstep(*xs):
            t0 = time.perf_counter()
            out = vstep(*xs)
            torch.cuda.synchronize()
            record["steps"].append(time.perf_counter() - t0)
            return out

        def timed_save(trial):
            t0 = time.perf_counter()
            out = save(trial)
            record["saves"].append(time.perf_counter() - t0)
            return out

        ex._vstep, ex.save_checkpoint = timed_vstep, timed_save
        return ex

    def config(arch):
        cfg = real_config(arch)
        return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, patched(tune, "build_vmap_executor", timed_build), \
            patched(tune, "get_config", config):
        args = tune.parser().parse_args(argv)
        cfg = tune.sweep_model(args)   # the lanes' config, its remat too
        for name in KERNELS:
            getattr(ops, name).launches = 0
        t0 = time.perf_counter()
        analysis = tune.main([*argv, "--log-dir", os.path.join(tmp, "vmap")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(ops, name).launches for name in KERNELS}
        spilled = sum(f.stat().st_size for f in Path(tmp).rglob("*.pkl"))
    peak = torch.cuda.max_memory_allocated()
    trials = analysis.trials
    calls = len(record["steps"])
    steps = calls * args.steps_per_iter
    finished = sum(t.status.value == "TERMINATED" for t in trials)
    ckpt_s, step_s = sum(record["saves"]), sum(record["steps"])
    log(f"[vmap] {tag} lane-stacked ASHA sweep ({' '.join(argv)}"
        f"{'' if checkpoints else '; no checkpoints'}): {finished} of {len(trials)} trials "
        f"finished in {wall!r} s wall, {finished * 3600 / wall!r} trials/hour {card}")
    for t in trials:
        log(f"[vmap]   {t.trial_id} {t.status.value}: {t.training_iteration} iterations, losses "
            f"{[r.metrics['loss'] for r in t.results]}" + (f"; error {t.error}" if t.error else ""))
    log(f"[vmap] {tag}: {record['lanes']} lanes, {calls} stacked calls of {args.steps_per_iter} "
        f"steps: {record['steps']} s; {steps} stacked steps in {step_s!r} s ({step_s / wall!r} "
        f"of the wall time) {card}")
    if checkpoints:
        log(f"[vmap] {tag} checkpoints: {len(record['saves'])} lane saves (host copies, the store "
            f"and its spill) in {ckpt_s!r} s, {ckpt_s / wall!r} of the wall time; "
            f"{spilled / 1e9:.3f} GB in the spill directory at the sweep's end {card}")
    expect = expected_train_launches(cfg, steps)
    log(f"[vmap] {tag} kernel launches on the vmap sweep's path: {launches} ({steps} stacked "
        f"steps; expected {expect})")
    assert finished == len(trials) == n_lanes, f"{tag}: every trial must end TERMINATED"
    assert record["lanes"] == n_lanes, f"{tag}: the sweep ran {record['lanes']} lanes"
    assert launches == expect, f"{tag} vmap sweep: expected {expect} launches"
    configs = [t.config for t in trials]
    del analysis, trials, t
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    log(f"[vmap] {tag} device memory: peak {peak / 2**20:.1f} MiB; allocated before the sweep "
        f"{before / 2**20:.1f} MiB, after {after / 2**20:.1f} MiB {card}")
    assert abs(after - before) <= SWEEP_MEM_SLACK, "the vmap executor still holds device memory"
    fig = {"launches": launches, "wall_s": wall, "trials_per_hour": finished * 3600 / wall,
           "stacked_calls_s": record["steps"], "peak_bytes": peak}
    if checkpoints:
        fig["ckpt_share"] = ckpt_s / wall
    return cfg, args, configs, fig


def lanes_of(torch, t):
    """The tensor under ``torch.func``'s wrappers, its lane axis first: a
    value computed inside one ``vmap`` (of ``grad``), taken out of it."""
    ft = torch._C._functorch
    while ft.is_functorch_wrapped_tensor(t):
        if ft.is_batchedtensor(t):
            t = ft.get_unwrapped(t).movedim(ft.maybe_get_bdim(t), 0)
        else:
            t = ft.get_unwrapped(t)
    return t


class LaneRoutingCheck(RoutingCheck):
    """``RoutingCheck`` for lanes under ``torch.func.vmap``.  ``record``
    keeps each router call's experts for every lane, taken out of the
    transform (lanes first).  ``forced`` returns the experts handed to it in
    ``forcing``, the kernel path's passed into the plain path's vmap as an
    input, so that they are batched as its own values are; it keeps the
    plain path's experts and probabilities, and ``settle`` then finds the
    decisions that differ, as ``forced`` does, with the lanes' rows side by
    side."""

    def __init__(self, torch, moe_mod):
        super().__init__(torch, moe_mod)
        self.lanes, self.plain, self.forcing = [], [], None

    def record(self, logits, moe, kernel_impl="jnp"):
        out = self.real(logits, moe, kernel_impl)
        self.lanes.append(lanes_of(self.torch, out[1]))
        return out

    def forced(self, logits, moe, kernel_impl="jnp"):
        _, idx, probs = self.real(logits, moe, "jnp")
        kidx = self.forcing[len(self.plain) % len(self.forcing)]
        self.plain.append((lanes_of(self.torch, idx), lanes_of(self.torch, probs.detach())))
        w = probs.gather(-1, kidx.long())
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), kidx, probs

    def settle(self) -> None:
        calls = len(self.lanes)
        parts = len(self.plain) // calls
        assert parts * calls == len(self.plain), (calls, len(self.plain))
        for c in range(calls):
            idx, probs = (self.torch.cat([self.plain[j * calls + c][i] for j in range(parts)])
                          for i in (0, 1))
            kidx = self.lanes[c].flatten(0, 1)
            self.kernel_idx.append(kidx)
            self.compare(idx.flatten(0, 1), kidx, probs.flatten(0, 1))


def vmap_lane_checks(card: str, torch, ops, dev, cfg, args, configs, tag: str) -> dict:
    """The lanes of phases 3g and 3k: weights of seeds 0..n-1, lane i's
    first batch i of the bank, the sweep's hyperparameters.  Each lane's
    first-step loss and gradients against the plain path under the same
    vmap (VMAP_GRAD_TOL, VMAP_LOSS_TOL; the ssm family's gradients against
    float64, the moe family's routing teacher-forced), each lane's loss of
    the stacked step against the lane stepped alone (TRAIN_LOSS_TOL), the
    stacked step timed beside the lanes stepped alone, and a trace of
    one."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import tune
    from repro_torch.models import forward_train, init_params
    from repro_torch.models import moe as moe_mod

    spec = tune.build_vmap_executor(cfg, args).spec
    hypers = {k: torch.tensor([float(c[k]) for c in configs], dtype=torch.float32, device=dev)
              for k in spec.hyper_names}
    n, batch, arch = len(configs), args.batch, cfg.arch_id
    lanes = [spec.init_fn(seed, {}) for seed in range(n)]
    state = {part: {k: torch.stack([s[part][k] for s in lanes]) for k in lanes[0][part]}
             for part in ("p", "m")}
    state["i"] = torch.arange(n, dtype=torch.int32, device=dev)
    del lanes
    data = SyntheticLMDataset(DataConfig(global_batch=batch, seq_len=args.seq_len,
                                         vocab_size=cfg.vocab_size))
    drawn = [data.batch_at(i) for i in range(n)]     # lane i's first batch: i % 8 of the bank
    batches = {k: torch.stack([torch.from_numpy(b[k]) for b in drawn]).to(dev)
               for k in drawn[0]}
    plain = dataclasses.replace(cfg, attn_impl="naive", kernel_impl="jnp")
    routing = LaneRoutingCheck(torch, moe_mod) if cfg.family == "moe" else None

    def lane_grads(c, lo, hi, forcing=None):
        """({name: gradients of lanes lo..hi-1 on the host}, their losses,
        the launches) of one vmapped ``loss_and_grads`` of ``c``."""
        module = tune.TrainForward(c)

        def one(p, b, forced):
            if routing is not None:
                routing.forcing = forced
            return tune.loss_and_grads(module, p, b)

        for name in KERNELS:
            getattr(ops, name).launches = 0
        g, (loss, _) = torch.func.vmap(one, in_dims=(0, 0, None if forcing is None else 0))(
            {k: x[lo:hi] for k, x in state["p"].items()},
            {k: x[lo:hi] for k, x in batches.items()}, forcing)
        torch.cuda.synchronize()
        return ({k: x.cpu() for k, x in g.items()}, loss.tolist(),
                {name: getattr(ops, name).launches for name in KERNELS})

    with contextlib.ExitStack() as stack:
        if routing is not None:
            stack.enter_context(patched(moe_mod, "_route", routing.record))
        kernel_g, k_loss, k_launches = lane_grads(cfg, 0, n)
    assert k_launches == expected_train_launches(cfg, 1), k_launches
    parts = []
    for lo in range(0, n, VMAP_PLAIN_LANES):
        hi = min(lo + VMAP_PLAIN_LANES, n)
        with contextlib.ExitStack() as stack:
            forcing = None
            if routing is not None:
                stack.enter_context(patched(moe_mod, "_route", routing.forced))
                forcing = [k[lo:hi] for k in routing.lanes]
            parts.append(lane_grads(plain, lo, hi, forcing))
    assert all(not any(part[2].values()) for part in parts), "the plain path launched a kernel"
    plain_g = {k: torch.cat([part[0][k] for part in parts]) for k in kernel_g}
    p_loss = [x for part in parts for x in part[1]]
    del parts
    loss_err = max(abs(a - b) / max(1.0, abs(a)) for a, b in zip(k_loss, p_loss))
    out = {"loss_rel_err": loss_err}
    if routing is not None:
        routing.settle()
        out["routing_flips"] = routing.report(f"[vmap] {tag} first step",
                                              train_call(cfg.n_layers, remat=cfg.remat))
    rel = {(name, lane): normwise(plain_g[name][lane], g[lane])
           for name, g in kernel_g.items() for lane in range(n)}
    worst = max(rel, key=rel.get)
    log(f"[vmap] {tag} first-step gradients of {n} lanes (seeds 0-{n - 1}, batches 0-{n - 1}), "
        f"kernel path (all lanes in one vmap: each kernel once a layer) vs plain path (under "
        f"vmap, {VMAP_PLAIN_LANES} lanes at a time), max abs err over max(1, max |g|): "
        f"{rel[worst]!r} ({worst[0]}, lane {worst[1]}; median "
        f"{statistics.median(rel.values())!r}); losses {k_loss} vs {p_loss}, differences over "
        f"max(1, |loss|) up to {loss_err!r} (limits {VMAP_GRAD_TOL.get(arch, 'against float64')}, "
        f"{VMAP_LOSS_TOL[arch]})")
    assert loss_err <= VMAP_LOSS_TOL[arch], f"{arch} vmap losses differ: {k_loss} vs {p_loss}"
    if cfg.family == "ssm":
        # held against float64 on the plain path, lane by lane, as phase 3c holds it
        f64 = []
        for lane in range(n):
            params = init_params(torch.Generator(device=dev).manual_seed(lane), cfg, dev)
            b = {k: x[lane] for k, x in batches.items()}
            _, g64, _ = first_step_grads_f64(torch, forward_train, params, b, plain)
            del params
            errs = {path: {} for path in ("kernel", "plain")}
            for name, exact in g64.items():
                scale = float(exact.abs().max()) or 1.0
                for path, gs in (("kernel", kernel_g), ("plain", plain_g)):
                    errs[path][name] = float((gs[name][lane].to(exact) - exact).abs().max()) / scale
            del g64
            f64.append(check_grads_vs_f64(errs, f"vmap {tag} lane {lane}"))
        out["f64"] = f64
    else:
        assert rel[worst] <= VMAP_GRAD_TOL[arch], f"{arch} vmap first-step gradient {worst}"
        out["grad_rel_err"] = rel[worst]
    del kernel_g, plain_g
    gc.collect()
    torch.cuda.empty_cache()

    # each lane of the stacked step against the lane stepped alone
    vstep = torch.func.vmap(spec.step_fn)
    for name in KERNELS:
        getattr(ops, name).launches = 0
    stacked_loss = vstep(state, hypers)[1]["loss"].tolist()
    assert {name: getattr(ops, name).launches for name in KERNELS} == \
        expected_train_launches(cfg, 1), "the stacked step launched a kernel more than once a layer"
    alone, alone_s = [], []
    for lane in range(n):
        one = {part: {k: x[lane] for k, x in state[part].items()} for part in ("p", "m")}
        one["i"] = state["i"][lane]
        t0 = time.perf_counter()
        alone.append(float(spec.step_fn(one, {k: h[lane] for k, h in hypers.items()})[1]["loss"]))
        alone_s.append(time.perf_counter() - t0)   # float() synchronised
        del one
    gaps = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(stacked_loss, alone)]
    log(f"[vmap] {tag} each lane's loss, stacked {stacked_loss} vs stepped alone {alone}: "
        f"differences over max(1, |loss|) {gaps} (tol {TRAIN_LOSS_TOL})")
    assert max(gaps) <= TRAIN_LOSS_TOL, f"{arch}: a lane of the stacked step differs: {gaps}"

    held = {"state": state}
    del state

    def one_step():
        held["state"], _ = vstep(held["state"], hypers)

    one_step()                                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(VMAP_TIMED_STEPS):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_peak = torch.cuda.max_memory_allocated()
    step, lane_s = min(times), min(alone_s[1:] or alone_s)
    tokens = n * batch * args.seq_len / step
    log(f"[time] {tag} vmap stacked step, {n} lanes x B={batch} S={args.seq_len} fp32: {step!r} "
        f"s (min of {times}), {tokens!r} tokens/s over all lanes; a lane stepped alone "
        f"{lane_s!r} s (min of {alone_s[1:] or alone_s}) x {n} = {n * lane_s!r} s; peak device "
        f"memory over the stacked steps {step_peak / 2**20:.1f} MiB {card}")
    traced = trace(f"{tag} vmap stacked step, {n} lanes (warm)", one_step, card, ops)
    del held
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "lane_loss_gap": max(gaps), "stacked_step_s": step, "lane_step_s": lane_s,
            "tokens_per_s": tokens, "step_peak_bytes": step_peak,
            "trace_busy_ms": traced and traced["busy"],
            "idle_share": traced and traced["idle_share"]}


def lane_step_peaks(card: str, torch, dev, cfg, args) -> dict:
    """One lane of phase 3g's stacked step (seed 0's weights, batch 0 of the
    bank, lr 0.01 and weight_decay 0.1), through ``step_fn`` unvmapped with
    its gradients taken each of LANE_PEAK_WAYS, in the turns of
    LANE_PEAK_TURNS: the peak device memory of each step over what was in
    use before it (the lane's state and the bank).  The three ways' losses
    must agree within TRAIN_LOSS_TOL, and ``loss_and_grads``' peak be at
    most LANE_PEAK_SHARE of ``grad_and_value``'s.  Returns {way: the least
    of its peaks in bytes}.  (What holds ``loss_and_grads``' peak, which
    keeps the sweep from more lanes: ``chip_probe.py --lane-memory``.)"""
    from repro_torch.launch import tune

    spec = tune.build_vmap_executor(cfg, args).spec
    state = spec.init_fn(0, {})
    hypers = {"lr": torch.tensor(0.01, device=dev), "weight_decay": torch.tensor(0.1, device=dev)}

    def grad_and_value(module, params, batch):
        return torch.func.grad_and_value(
            lambda p: torch.func.functional_call(module, p, (batch,)), has_aux=True)(params)

    def autograd(module, params, batch):
        p = {n: t.detach().requires_grad_() for n, t in params.items()}
        loss, metrics = torch.func.functional_call(module, p, (batch,))
        grads = torch.autograd.grad(loss, list(p.values()))
        return dict(zip(p, grads)), (loss.detach(), {k: v.detach() for k, v in metrics.items()})

    ways = {"loss_and_grads": tune.loss_and_grads, "grad_and_value": grad_and_value,
            "autograd": autograd}
    peaks, losses = {way: [] for way in ways}, {}
    for way in LANE_PEAK_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with patched(tune, "loss_and_grads", ways[way]):
            new, metrics = spec.step_fn(state, hypers)
            losses[way] = float(metrics["loss"])
        peaks[way].append(torch.cuda.max_memory_allocated() - before)
        del new, metrics
    least = {way: min(p) for way, p in peaks.items()}
    log(f"[vmap] {TRAIN_ARCH} one lane's step (B={args.batch} S={args.seq_len}, step_fn "
        f"unvmapped), peak device memory over the lane's state, in turns {LANE_PEAK_TURNS}: "
        + "; ".join(f"{way} {[f'{b / 2**20:.1f}' for b in p]} MiB" for way, p in peaks.items())
        + f"; losses {losses} {card}")
    gaps = [abs(x - losses["autograd"]) / max(1.0, abs(x)) for x in losses.values()]
    assert max(gaps) <= TRAIN_LOSS_TOL, f"one lane's step: the ways' losses differ: {losses}"
    assert least["loss_and_grads"] <= LANE_PEAK_SHARE * least["grad_and_value"], \
        f"loss_and_grads holds {least['loss_and_grads']} B, " \
        f"grad_and_value {least['grad_and_value']} B"
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return least


def run_vmap_sweep(card: str, torch, ops, dev, sweep: dict, train: dict) -> dict:
    """Phase 3g: the lane-stacked sweep of TRAIN_ARCH (``vmap_sweep``),
    beside phase 3b's serial one, then ``vmap_lane_checks``; the stacked
    step beside as many train-phase steps; then ``lane_step_peaks``."""
    cfg, args, configs, fig = vmap_sweep(card, torch, ops, VMAP_SWEEP_ARGS, TRAIN_ARCH,
                                         VMAP_SWEEP_LANES)
    log(f"[vmap] {TRAIN_ARCH}: {fig['trials_per_hour']!r} trials/hour; 3b's serial executor "
        f"in this run: {sweep['trials_per_hour']!r} {card}")
    lanes = vmap_lane_checks(card, torch, ops, dev, cfg, args, configs, TRAIN_ARCH)
    n = len(configs)
    log(f"[time] {TRAIN_ARCH} vmap stacked step {lanes['stacked_step_s']!r} s; the train phase's "
        f"step {train['steady_step_s']!r} s x {n} = {n * train['steady_step_s']!r} s {card}")
    peaks = lane_step_peaks(card, torch, dev, cfg, args)
    return {**fig, **lanes, "lane_step_peak_bytes": peaks}


def run_vmap_family(card: str, torch, ops, dev, arch: str, n_lanes: int, n_layers: int,
                    batch: int) -> dict:
    """Phase 3k for one arch: its lane-stacked sweep through ``launch.tune``
    at full width, its depth cut to ``n_layers``, ``n_lanes`` lanes of
    ``batch`` x S tokens, no checkpoints (``vmap_sweep``); then
    ``vmap_lane_checks``."""
    from repro_torch.configs import get_config

    tag = f"{arch} ({n_layers} of {get_config(arch).n_layers} layers, {n_lanes} lanes, B={batch})"
    argv = ("--arch", arch, "--scheduler", "asha", "--num-samples", str(n_lanes),
            "--max-iters", str(VMAP_FAMILY_ITERS), "--batch", str(batch), "--seq-len", str(S),
            "--steps-per-iter", "1", "--executor", "vmap", "--total-devices", "8",
            "--devices-per-trial", "2", "--seed", "0", "--device", dev.type)
    cfg, args, configs, fig = vmap_sweep(card, torch, ops, argv, tag, n_lanes, n_layers,
                                         checkpoints=False)
    lanes = vmap_lane_checks(card, torch, ops, dev, cfg, args, configs, tag)
    log(f"[vmap] {tag} peak over the stacked steps {lanes['step_peak_bytes'] / 2**20:.1f} MiB "
        f"{card}; through torch.func.grad, remat off: {VMAP_FAMILY_GRAD_PEAKS[arch]} MiB "
        f"(an H100 80GB HBM3 at 700 W)")
    return {**fig, "lanes": n_lanes, "layers": n_layers, "batch": batch, **lanes}


def run_path(arch: str, card: str, torch, ops, serve, prefill, decode_step, get_config,
             leaves):
    """Serve ``arch`` at full width with every launch count set to 0 just
    before and read just after; hold it against the plain path; time it and
    trace it.  A VLM's prompt is its image prefix and S text tokens, and
    its positions count the prefix.  Returns the launch counts."""
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
    P = res.prefix
    assert P == (cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else 0)
    with patched(moe_mod, "_route", routing.forced) if routing else contextlib.nullcontext():
        logits, caches = prefill(res.params, res.inputs, plain, P + S + NEW)
        close("prefill_logits", logits, res.prefill_logits)
        for i in range(NEW - 1):
            logits, caches = decode_step(res.params, caches, res.tokens[:, i], P + S + i, plain)
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

    params, prompts, inputs, kcfg = res.params, res.prompts, res.inputs, res.cfg
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, inputs, kcfg, P + S + NEW)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    prompt = f"{B}x{S}" if not P else f"{B}x({P} patches + {S} tokens)"
    log(f"[time] {arch} prefill {prompt} in serve (first call): {res.prefill_s!r} s {card}")
    log(f"[time] {arch} prefill {prompt} warm, median of 3: {statistics.median(pre)!r} s "
        f"(runs {pre}) {card}")
    log(f"[time] {arch} decode {NEW - 1} steps x batch {B}: {res.decode_s!r} s, "
        f"{B * (NEW - 1) / res.decode_s!r} tokens/s {card}")

    def run_decode(caches, first):
        tok = prompts[:, -1]
        for i in range(TRACE_DECODE_STEPS):
            logits, caches = decode_step(params, caches, tok, first + i, kcfg)
            tok = logits.argmax(-1)

    _, caches = prefill(params, inputs, kcfg, P + S + NEW)
    trace(f"{arch} prefill (warm)",
          lambda: prefill(params, inputs, kcfg, P + S + NEW), card, ops)
    run_decode(caches, P + S)                               # warm-up
    trace(f"{arch} decode x{TRACE_DECODE_STEPS} (warm)",
          lambda: run_decode(caches, P + S + TRACE_DECODE_STEPS), card, ops)
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
# case of the same shape), causal.  With S=512 recurrentgemma's window of
# 2048 masks nothing beyond causal, so SDPA with is_causal computes the same
# function; hubert-xlarge's encoder attends both ways (SDPA with
# is_causal=False, both bounds over all S^2 pairs).
ATTN_SHAPES = (
    ("smollm", (8, 512, 512, 9, 3, 64), None, 100, True),
    ("granite-moe", (8, 512, 512, 24, 8, 64), None, 109, True),
    ("recurrentgemma local_attn", (8, 512, 512, 16, 1, 256), 2048, 107, True),
    ("hubert-xlarge", (8, 512, 512, 16, 16, 80), None, 119, False),
    # phase 3g's stacked step: VMAP_LANES lanes of smollm folded into B
    (f"smollm, {VMAP_LANES} lanes folded", (VMAP_LANES * 8, 512, 512, 9, 3, 64), None, 700,
     True),
    # phase 3j's train step: smollm-135m under dryrun_config, bf16 in the model
    ("smollm dry-run config S=4096", (8, 4096, 4096, 9, 3, 64), None, 126, True),
)


def sdpa_call(torch, q, k, v, causal):
    """PyTorch's ``scaled_dot_product_attention`` on K1's inputs, kv heads
    expanded beforehand (not in the call)."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)


def sdpa_kernels(torch, dev) -> dict:
    """{label: the kernels ``scaled_dot_product_attention`` launches at each
    of K1's timed shapes, on ``time_attention``'s inputs: (name, launches
    kept of 10, device ms a launch)}.  Read early, beside K4's and K2's
    profiler readings: late in a full run the first session of this
    measurement came back empty at every shape on an H100 (at
    hubert-xlarge's three times in a row, which failed the run), while the
    same sessions in a fresh process came back whole."""
    out = {}
    for label, shape, _, seed, causal in ATTN_SHAPES:
        q, k, v, _, _ = attention_inputs(torch, dev, seed, *shape, torch.float32)
        found = device_kernels(torch, f"scaled_dot_product_attention {label}",
                               sdpa_call(torch, q, k, v, causal))
        out[label] = [(name, n, ms / n) for name, n, ms in found]
    return out


def time_attention(torch, dev, ops, ref, card, label, shape, window, seed, causal,
                   lib_kernels) -> dict:
    """K1 at one serving shape: fp32 kernel and plain version interleaved,
    the bf16 kernel, PyTorch's ``scaled_dot_product_attention`` on the same
    fp32 and bf16 inputs (kv heads expanded beforehand, not timed) beside
    the kernels it launched in fp32 (``lib_kernels``, from
    ``sdpa_kernels``), and both bounds."""
    q, k, v, qp, kp = attention_inputs(torch, dev, seed, *shape, torch.float32)
    sdpa = sdpa_call(torch, q, k, v, causal)
    plain = lambda: ref.flash_attention_ref(q, k, v, qp, kp, causal=causal, window=window)
    lib_err = max_err(sdpa().transpose(1, 2), plain())
    kms, pms, runs = time_pair(
        lambda: ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window), plain, 20)
    library_ms = time_ms(sdpa)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    bf16_ms = time_ms(lambda: ops.flash_attention(qb, kb, vb, qp, kp, causal=causal,
                                                  window=window))
    library_bf16_ms = time_ms(sdpa_call(torch, qb, kb, vb, causal))
    bound = attention_bound(q, k, v, qp, kp, causal=causal, window=window)
    bound_bf16 = attention_bound(qb, kb, vb, qp, kp, causal=causal, window=window)
    B, S, _, H, K, hd = shape
    where = f"{label} B={B} S={S} H={H} K={K} hd={hd}" + (f" window {window}" if window else "") \
        + ("" if causal else " bidirectional")
    log(f"[time] flash_attention kernel fp32 {where}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] flash_attention kernel bf16 {where}: {bf16_ms!r} ms {card}")
    log(f"[time] flash_attention plain version fp32 {where}: {pms!r} ms {card}")
    log(f"[time] torch scaled_dot_product_attention fp32 {where} (kv heads expanded "
        f"beforehand, is_causal={causal}; max_abs_err vs plain {lib_err!r}): {library_ms!r} ms "
        f"{card}; its kernels (name, launches the profiler kept of 10, device ms a launch): "
        f"{lib_kernels}; bf16 {library_bf16_ms!r} ms {card}")
    log(f"[time] flash_attention bounds {where}: fp32 {bound[0]!r} ms by {bound[1]} on the "
        f"CUDA cores, {bound[4]!r} ms by {bound[5]} as 3xTF32 on the tensor cores; bf16 "
        f"{bound_bf16[4]!r} ms by {bound_bf16[5]} on the tensor cores (the function's; K1's "
        f"hi + lo P V floor 1.5x its operations) ({bound[2]:.4g} flop, {bound[3]:.4g} bytes "
        f"fp32) {card}")
    return {"ms": kms, "bf16_ms": bf16_ms, "plain_ms": pms, "library_ms": library_ms,
            "library_bf16_ms": library_bf16_ms,
            "library_kernels": [name for name, _, _ in lib_kernels], "bound": bound[:4],
            "bound_ms": bound[0], "tensor_core_bound_ms": bound[4],
            "bf16_tensor_core_bound_ms": bound_bf16[4]}


def time_attention_bwd(torch, dev, ops, ref, card, label, shape, window, seed,
                       causal) -> dict:
    """K1's backward at one of K1's shapes: the fp32 kernel and its plain
    version interleaved, the bf16 kernel, the backward of PyTorch's
    ``scaled_dot_product_attention`` on the same fp32 and bf16 inputs (kv
    heads expanded beforehand, not timed) and the kernels it launched in
    fp32, and both bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B_, S_, _, H, K, hd = shape
    q, k, v, qp, kp = attention_inputs(torch, dev, seed, *shape, torch.float32)
    mask = {"causal": causal, "window": window}
    out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, return_lse=True, **mask)
    dout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(seed + 150),
                       device=dev)
    kernel = lambda: ops.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout, **mask)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, qp, kp, out, lse, dout, **mask)
    kms, pms, runs = time_pair(kernel, plain, 10)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    outb, lseb = fa.flash_attention_cuda(qb, kb, vb, qp, kp, return_lse=True, **mask)
    doutb = dout.to(torch.bfloat16)
    bf16_ms = time_ms(lambda: ops.flash_attention_bwd(qb, kb, vb, qp, kp, outb, lseb, doutb,
                                                      **mask))
    G = H // K
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = dout.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    gq, gk, gv = sdpa_bwd()
    regroup = lambda g: g.transpose(1, 2).reshape(B_, S_, K, G, hd).sum(3)   # expanded heads summed
    lib_err = max(normwise(a, b) for a, b in zip(
        (gq.transpose(1, 2), regroup(gk), regroup(gv)), plain()))
    library_ms = time_ms(sdpa_bwd)
    qtb, ktb, vtb = (x.detach().to(torch.bfloat16).requires_grad_() for x in (qt, kt, vt))
    otb = F.scaled_dot_product_attention(qtb, ktb, vtb, is_causal=causal)
    dotb = dot.to(torch.bfloat16)
    library_bf16_ms = time_ms(
        lambda: torch.autograd.grad(otb, (qtb, ktb, vtb), dotb, retain_graph=True))
    del qtb, ktb, vtb, otb, dotb
    lib_kernels = [(name, n, ms / n) for name, n, ms in
                   device_kernels(torch, f"scaled_dot_product_attention backward {label}", sdpa_bwd)
                   or []]
    bound = attention_bwd_bound(q, k, v, qp, kp, **mask)
    bound_bf16 = attention_bwd_bound(qb, kb, vb, qp, kp, **mask)
    where = f"{label} B={B_} S={S_} H={H} K={K} hd={hd}" + (f" window {window}" if window else "") \
        + ("" if causal else " bidirectional")
    log(f"[time] flash_attention_bwd kernel fp32 {where}: {kms!r} ms {card} (runs {runs})")
    log(f"[time] flash_attention_bwd kernel bf16 {where}: {bf16_ms!r} ms {card}")
    log(f"[time] flash_attention_bwd plain version fp32 {where}: {pms!r} ms {card}")
    log(f"[time] torch scaled_dot_product_attention backward fp32 {where} (kv heads expanded "
        f"beforehand, is_causal={causal}; max normwise err vs plain {lib_err!r}): "
        f"{library_ms!r} ms {card}; its "
        f"kernels (name, launches the profiler kept of 10, device ms a launch): {lib_kernels}; "
        f"bf16 {library_bf16_ms!r} ms {card}")
    log(f"[time] flash_attention_bwd bounds {where}: fp32 {bound[0]!r} ms by {bound[1]} on the "
        f"CUDA cores, {bound[4]!r} ms by {bound[5]} as 3xTF32 on the tensor cores; bf16 "
        f"{bound_bf16[4]!r} ms by {bound_bf16[5]} on the tensor cores ({bound[2]:.4g} flop, "
        f"{bound[3]:.4g} bytes fp32) {card}")
    return {"ms": kms, "bf16_ms": bf16_ms, "plain_ms": pms, "library_ms": library_ms,
            "library_bf16_ms": library_bf16_ms,
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


def time_router(torch, dev, ops, ref, router, card, label, shape, seed) -> dict:
    """K4 at one shape: its device time a launch in turns with the plain
    version's a call and with its own asked for the row statistics
    (profiler; a few microseconds of work, which CUDA events around
    back-to-back calls would read as the host's time), the unfused PyTorch
    chain's, each one's time a call paced by the host (``paced_ms``), and
    the bound."""
    T, E, k = shape
    logits = router_logits(torch, dev, T, E, seed)
    kernel, plain = (lambda: ops.moe_router(logits, k)), (lambda: ref.moe_router_ref(logits, k))
    stats = lambda: router.moe_router_cuda(logits, k, return_stats=True)
    chain = lambda: topk_chain(torch, logits, k)
    runs = {}
    for turn in ("plain", "kernel", "stats", "stats", "kernel", "plain"):
        runs.setdefault(turn, []).append(
            device_ms(torch, f"moe_router {label}", kernel, "moe_router_kernel")
            if turn == "kernel" else
            device_ms(torch, f"moe_router with statistics {label}", stats, "moe_router_kernel")
            if turn == "stats" else device_ms(torch, f"moe_router plain {label}", plain))
    kms, sms = (min((x for x in runs[t] if x is not None), default=None)
                for t in ("kernel", "stats"))
    pms = min(runs["plain"])
    chain_ms = device_ms(torch, f"softmax-topk chain {label}", chain)
    host = {"kernel": paced_ms(torch, kernel), "plain": paced_ms(torch, plain),
            "chain": paced_ms(torch, chain)}
    bound = moe_router_bound(logits, k)
    where = f"{label} T={T} E={E} k={k}"
    log(f"[time] moe_router kernel fp32 {where}: {kms!r} ms device time a launch, bound "
        f"{bound[0]!r} ms by {bound[1]} {card} (runs {runs})")
    log(f"[time] moe_router kernel with its row statistics fp32 {where}: {sms!r} ms device time "
        f"a launch {card}")
    log(f"[time] moe_router plain version fp32 {where}: {pms!r} ms device time a call {card}")
    log(f"[time] softmax -> topk -> renormalise, PyTorch calls unfused (not used by the "
        f"port), fp32 {where}: {chain_ms!r} ms device time a call {card}")
    log(f"[time] moe_router per call, paced by the host (perf_counter over {HOST_CALLS} "
        f"back-to-back calls), fp32 {where}: kernel wrapper {host['kernel']!r} ms, plain "
        f"version {host['plain']!r} ms, unfused PyTorch calls {host['chain']!r} ms {card}")
    return {"ms": kms, "stats_ms": sms, "plain_ms": pms, "chain_ms": chain_ms,
            "host_ms": host["kernel"],
            "plain_host_ms": host["plain"], "chain_host_ms": host["chain"],
            "bound": bound, "bound_ms": bound[0]}


# K4's backward's timed shapes: label, (T, E, k); the logits of phase 2's
# case of the same shape (seed 400 + position there).
ROUTER_BWD_SHAPES = (
    ("granite-moe train", (4096, 40, 8), 400),
    ("deepseek-moe train", (4096, 64, 6), 402),
)


# Lanes a row in K4's backward for E experts (``lanes_per_row`` in
# ``csrc/moe_router_bwd.cu``): the fewest of 4, 8, 16 and 32 that hold the
# row at most 8 experts a lane.
def router_bwd_lanes(E: int) -> int:
    return next(g for g in (4, 8, 16, 32) if 8 * g >= E)


def time_router_bwd(torch, dev, ops, ref, router, card, label, shape, seed, floor, sass,
                    ptxas) -> dict:
    """K4's backward at one training shape, on the kernel forward's outputs
    and row statistics and a seeded weight gradient: its device time a
    launch in turns with the plain version's a call (profiler), each one's
    time a call paced by the host (``paced_ms``), and the bound; printed
    beside the launch floor (``launch_floor``) and the fp32 instantiation's
    SASS counts (``sass``) and ptxas registers and spills (``ptxas``).  No
    single PyTorch call computes this gradient."""
    T, E, k = shape
    logits = router_logits(torch, dev, T, E, seed)
    dw = router_cotangent(torch, dev, seed + 50, T, k)
    w, idx, stats = router.moe_router_cuda(logits, k, return_stats=True)
    kernel = lambda: ops.moe_router_bwd(logits, w, idx, dw, stats)
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
    lanes = router_bwd_lanes(E)
    code = sass.get(("float32", lanes))
    regs = [c for fn, c in ptxas.items() if f"moe_router_bwd_kernelIfLi{lanes}E" in fn]
    fill = floor["fill_device_ms"]
    log(f"[time] moe_router_bwd kernel fp32 {where}: {kms!r} ms device time a launch, bound "
        f"{bound[0]!r} ms by {bound[1]} ({bound[2]:.4g} flop, {bound[3]:.4g} bytes), launch "
        f"floor (one-element fill) {fill!r} ms"
        + (f", {kms / fill!r}x the floor" if kms and fill else "")
        + f"; {lanes} lanes a row, SASS {code}, ptxas {regs} {card} (runs {runs})")
    log(f"[time] moe_router_bwd plain version fp32 {where}: {pms!r} ms device time a call {card}")
    log(f"[time] moe_router_bwd per call, paced by the host (perf_counter over {HOST_CALLS} "
        f"back-to-back calls), fp32 {where}: kernel wrapper {host['kernel']!r} ms, plain "
        f"version {host['plain']!r} ms {card}")
    return {"ms": kms, "plain_ms": pms, "host_ms": host["kernel"],
            "plain_host_ms": host["plain"], "bound": bound, "bound_ms": bound[0],
            "lanes_per_row": lanes, "sass": code, "ptxas": regs[0] if regs else None}


# Phase 3i: the trainable's roofline profile (``profile_roofline=True``).
# JAX's ``hlo_costs`` of the compiled smollm-135m AdamW step at B x S counts
# this many dot FLOPs; the port's count of the same step on the meta device
# must be the same number (a count, not a speed).
PROFILE_DOT_FLOPS = 3_739_842_772_992
PROFILE_ITERS = 2
PROFILE_MEM_SLACK = 64 * 2**20


def run_profile(card: str, torch, ops, dev) -> dict:
    """Phase 3i: ``TRAIN_ARCH``'s trial with ``profile_roofline=True`` and
    the same trial without it, on the card, ``PROFILE_ITERS`` iterations of
    ``TRAIN_STEPS`` steps each; every launch count set to 0 just before the
    profiled trial and read just after.  The counting pass is timed, and its
    launches and the card's memory read around it.  Returns the profile and
    the readings."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.train import device_model
    from repro_torch.train.trainable import ModelTrainable, make_model_trainable

    cfg = device_model(get_config(TRAIN_ARCH), dev)
    cls = make_model_trainable(cfg, batch=B, seq_len=S, steps_per_iter=TRAIN_STEPS,
                               total_steps=PROFILE_ITERS * TRAIN_STEPS, device="cuda")
    real, count = ModelTrainable._roofline_costs, {}

    def counted(self):
        torch.cuda.synchronize()
        before = {name: getattr(ops, name).launches for name in KERNELS}
        mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        costs = real(self)
        count["wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        count["launches"] = {name: getattr(ops, name).launches - before[name]
                             for name in KERNELS}
        count["memory_delta"] = torch.cuda.memory_allocated() - mem
        count["costs"] = costs
        return costs

    for name in KERNELS:
        getattr(ops, name).launches = 0
    with patched(ModelTrainable, "_roofline_costs", counted):
        trial = cls({"profile_roofline": True})
        results = [trial.step() for _ in range(PROFILE_ITERS)]
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    prof = results[0]["_profile"]
    log(f"[profile] {TRAIN_ARCH} B={B} S={S}, {TRAIN_STEPS} steps an iteration, "
        f"profile_roofline=True: _profile {json.dumps(prof, sort_keys=True)} {card}")
    assert "costs" in count, f"the trial made no roofline count: {prof.get('roofline_error')}"
    costs = count["costs"]
    log(f"[profile] counting pass (a replica on the meta device, kernel-free config): "
        f"{count['wall_s']!r} s wall; costs {json.dumps(costs, sort_keys=True)}; kernel "
        f"launches in it {count['launches']}; card memory after it minus before "
        f"{count['memory_delta']} bytes")
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[profile] launch.mesh.HW.HBM_BYTES {HW.HBM_BYTES} vs this card's total_memory "
        f"{total} (equal: {HW.HBM_BYTES == total}) {card}")

    plain = cls({"profile_roofline": False})
    plain_results = [plain.step() for _ in range(PROFILE_ITERS)]
    losses = [r["loss"] for r in results]
    plain_losses = [r["loss"] for r in plain_results]
    same = all(torch.equal(a, b) for a, b in zip(trial.state.params.parameters(),
                                                 plain.state.params.parameters()))
    log(f"[profile] losses with the flag {losses}, without {plain_losses}; final parameters "
        f"bit for bit: {same}")
    expect = expected_train_launches(cfg, PROFILE_ITERS * TRAIN_STEPS)
    log(f"[profile] kernel launches of the profiled trial: {launches} ({PROFILE_ITERS * TRAIN_STEPS} "
        f"steps)")
    terms = {key: prof[f"roofline_{key}_s"] for key in ("compute", "memory", "collective")}
    assert costs["dot_flops"] == PROFILE_DOT_FLOPS, \
        f"dot FLOPs {costs['dot_flops']!r}, JAX's hlo_costs {PROFILE_DOT_FLOPS}"
    assert prof["roofline_compute_s"] == round(costs["dot_flops"] / HW.PEAK_FLOPS_BF16, 6)
    assert prof["dominant"] in terms and prof["predicted_step_s"] > 0, prof
    assert terms["compute"] > 0 and terms["memory"] > 0 and terms["collective"] == 0, terms
    assert prof["achieved_vs_predicted"] > 0 and prof["temp_bytes"] > 0, prof
    assert losses == plain_losses and same, "profile_roofline changed the training"
    assert launches == expect, f"expected {expect} launches"
    assert not any(count["launches"].values()), f"the count launched {count['launches']}"
    assert abs(count["memory_delta"]) <= PROFILE_MEM_SLACK, count["memory_delta"]
    del trial, plain
    return {"launches": launches, "profile": prof, "count_wall_s": count["wall_s"],
            "dot_flops": costs["dot_flops"], "traffic_bytes": costs["traffic_bytes"],
            "count_memory_delta": count["memory_delta"], "losses": losses,
            "total_memory": total}


# Phase 3j: the dry-run (``repro_torch.launch.dryrun``) on the card's machine.
# Each record's dot FLOPs of one rank: JAX's count of the record (jax 0.9.0,
# ``repro.launch.dryrun.lower_one`` on 256 or 512 CPU host devices) less the
# difference that ``tests/_torch_full_width.py`` names and counts (the
# function named beside it), where one is named.  Counts, not speeds; the
# tests hold the CPU's torch to the same numbers: (arch, mesh, shape) -> FLOPs.
DRYRUN_FLOPS = {("smollm-135m", "pod16x16", "train_4k"): 87_451_439_726_592,
                ("smollm-135m", "pod16x16", "prefill_32k"): 149_303_807_705_088,
                ("smollm-135m", "pod16x16", "decode_32k"): 18_253_873_152,
                # less qo_whole_on_two_pods
                ("smollm-135m", "pods2x16x16", "train_4k"):
                    45_560_308_432_896 - 1_834_588_569_600,
                # less wkv_products
                ("rwkv6-1.6b", "pod16x16", "train_4k"): 47_211_488_477_184 - 51_740_934_144,
                # less moe_down_and_combine_whole
                ("granite-moe-3b-a800m", "pod16x16", "train_4k"):
                    416_092_249_915_392 - 139_156_940_390_400,
                ("recurrentgemma-9b", "pod16x16", "train_4k"): 308_756_608_974_848,
                ("deepseek-moe-16b", "pod16x16", "decode_32k"): 9_003_073_536}
# The runs, all at once: name -> (the CLI's arguments, its summary line)
DRYRUN_RUNS = {
    "single": (["--arch", "smollm-135m", "--mesh", "single"],
               "3 counted, 1 skipped (documented), 0 errors"),
    "multi": (["--arch", "smollm-135m", "--shape", "train_4k", "--mesh", "multi"],
              "1 counted, 0 skipped (documented), 0 errors"),
    # the kernel-free scan and router on each rank's shards (torch 2.11's
    # DTensor refuses the chunked scan's einsums and the plain router's sort)
    "rwkv6": (["--arch", "rwkv6-1.6b", "--shape", "train_4k", "--mesh", "single"],
              "1 counted, 0 skipped (documented), 0 errors"),
    "granite": (["--arch", "granite-moe-3b-a800m", "--shape", "train_4k", "--mesh", "single"],
                "1 counted, 0 skipped (documented), 0 errors"),
    # the w_x gradient pinned to its split (torch 2.13 once ran it whole over model)
    "recurrentgemma": (["--arch", "recurrentgemma-9b", "--shape", "train_4k", "--mesh",
                        "single"], "1 counted, 0 skipped (documented), 0 errors"),
    # the expert products' d_model split over the data axes (2.11 once counted 7.42x JAX's)
    "deepseek": (["--arch", "deepseek-moe-16b", "--shape", "decode_32k", "--mesh", "single"],
                 "1 counted, 0 skipped (documented), 0 errors")}
# The record's config on one card: smollm-135m under dryrun_config, B x S
DRYRUN_B, DRYRUN_S, DRYRUN_STEPS = 8, 4096, 3
DRYRUN_ONE_RANK_FLOPS = 73_405_286_055_936   # lower_one's count of it on a (1,1) mesh
DRYRUN_LOSS_TOL = 2e-2


def start_dryrun_cli() -> dict:
    """Phase 3j (a), started: ``python -m repro_torch.launch.dryrun`` for
    smollm-135m on the single-pod mesh (every shape) and for its train_4k
    on the multi-pod mesh, and for the other records of ``DRYRUN_RUNS`` on
    the single-pod mesh, as subprocesses all at once, each a fake process
    group of 256 or 512 ranks on the meta device, with no card visible to
    them (``CUDA_VISIBLE_DEVICES`` empty: a count that touched the card
    would fail).  They run on the host while the phases after them use the
    card (rwkv6's count takes minutes of host time); ``finish_dryrun_cli``
    collects them."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = Path(tempfile.mkdtemp(prefix="dryrun-"))
    procs = {}
    for name, (args, _) in DRYRUN_RUNS.items():
        # their output to files: nothing reads a pipe while the card's phases run
        with open(out / f"{name}.out", "w") as stdout, open(out / f"{name}.err", "w") as stderr:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
                 str(out / name)], stdout=stdout, stderr=stderr, env=env, cwd=ROOT)
    return {"procs": procs, "out": out, "t0": time.perf_counter()}


def finish_dryrun_cli(card: str, started: dict) -> dict:
    """Phase 3j (a), collected: each run's summary and the seconds from the
    common start to its end; each record's dot FLOPs against
    ``DRYRUN_FLOPS``."""
    import shutil
    runs, procs, t0 = DRYRUN_RUNS, started["procs"], started["t0"]
    with ThreadPoolExecutor(len(procs)) as pool:
        def finish(name):
            procs[name].wait(timeout=900)
            return time.perf_counter() - t0
        ends = dict(zip(procs, pool.map(finish, procs)))
    wall, out = time.perf_counter() - t0, started["out"]
    records = {name: json.loads(path.read_text()) for name, (args, _) in runs.items()
               for path in [out / name / f"dryrun_{args[args.index('--mesh') + 1]}.json"]
               if path.exists()}
    done = {name: (((out / f"{name}.out").read_text(), (out / f"{name}.err").read_text()), took)
            for name, took in ends.items()}
    shutil.rmtree(out, ignore_errors=True)
    for name, ((stdout, stderr), took) in done.items():
        summary = [ln for ln in stdout.splitlines() if ln.startswith("[dryrun] ") and "counted" in ln]
        log(f"[dryrun] {' '.join(runs[name][0])}: rc {procs[name].returncode}, "
            f"{summary[-1] if summary else stdout[-400:]!r}, done by {took!r} s")
        assert procs[name].returncode == 0, stderr[-3000:]
        assert summary and summary[-1] == f"[dryrun] {runs[name][1]}", summary
    counted = {}
    for name, recs in records.items():
        for r in recs:
            if r["status"] != "counted":
                log(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: {r['status']} ({r.get('reason')})")
                continue
            counted[(r["arch"], r["mesh"], r["shape"])] = r
            log(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']} ({r['chips']} ranks, rank 0): "
                f"dot_flops {r['device_flops']!r}, bytes {r['device_bytes']!r}, collectives "
                f"{r['collectives_by_kind']}, arg/temp/output {r['arg_bytes']}/{r['temp_bytes']}/"
                f"{r['output_bytes']}; roofline compute {r['compute_s'] * 1e3:.3f} ms memory "
                f"{r['memory_s'] * 1e3:.3f} ms collective {r['collective_s'] * 1e3:.3f} ms -> "
                f"{r['dominant']}-bound, useful-flops {r['useful_flops_ratio']:.4f}, "
                f"hbm/dev {r['hbm_per_device_gib']:.2f} GiB; t_count_s {r['t_count_s']}")
    log(f"[dryrun] the {len(runs)} runs {wall!r} s wall (at once on the host, no card visible to "
        f"them, beside phases 4, 5, 3i, the one-card config and the examples) {card}")
    assert set(counted) == set(DRYRUN_FLOPS), sorted(counted)
    for key, flops in DRYRUN_FLOPS.items():
        assert counted[key]["device_flops"] == flops, (key, counted[key]["device_flops"], flops)
    return {"wall_s": wall, "t_count_s": {" ".join(k): r["t_count_s"] for k, r in counted.items()},
            "device_flops": {" ".join(k): r["device_flops"] for k, r in counted.items()},
            "seconds": ends}


# The port's examples, each run on the card as a user runs it (no
# arguments: the scripts' own sizes, ``--device`` cuda), all four at once.
EXAMPLES = ("tune_transformer_torch.py", "vmap_sweep_torch.py", "serve_batch_torch.py",
            "pbt_population_torch.py")


def run_examples(card: str) -> dict:
    """The examples (``EXAMPLES``) as subprocesses started together, each
    with two host threads; every one must exit 0.  Each one's seconds from
    the common start to its exit, and the wall time of all four."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / name)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    env=env, cwd=ROOT)
             for name in EXAMPLES}
    with ThreadPoolExecutor(len(procs)) as pool:
        def finish(name):
            out = procs[name].communicate(timeout=600)
            return out, time.perf_counter() - t0
        done = dict(zip(procs, pool.map(finish, procs)))
    wall = time.perf_counter() - t0
    for name, ((stdout, stderr), took) in done.items():
        tail = stdout.strip().splitlines()[-1:] or ["(no output)"]
        log(f"[examples] {name}: rc {procs[name].returncode}, {took!r} s (the four at once); "
            f"its last line {tail[0]!r} {card}")
        assert procs[name].returncode == 0, f"{name}: {stderr[-3000:]}"
    log(f"[examples] {len(procs)} examples {wall!r} s wall {card}")
    return {"wall_s": wall, "seconds": {name: took for name, (_, took) in done.items()}}


def run_dryrun_config(card: str, torch, ops, dev) -> dict:
    """Phase 3j (b): the record's config on one card.  ``lower_one`` counts
    smollm-135m under ``dryrun_config`` at B x S on a (1,1) mesh of a fake
    group of one rank (destroyed before the steps); then ``DRYRUN_STEPS``
    AdamW steps of that config on the card, twice, from the same weights and
    batches: the kernel-free path that was counted, and ``attn_impl="pallas"``
    (K1's forward and backward in bf16 at hd 64), every launch count set to 0
    just before each and read just after.  Each path's peak memory beside the
    record's ``arg_bytes + temp_bytes`` and its steady step beside
    ``step_time_s``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import kernel_free
    from repro_torch.launch.shapes import ShapeSpec, dryrun_config
    from repro_torch.launch.train import batch_source
    from repro_torch.train import adamw, linear_warmup_cosine, make_train_state, make_train_step

    shape = ShapeSpec("train_4k", "train", DRYRUN_S, DRYRUN_B)
    with dryrun.fake_group(1):
        rec = dryrun.lower_one(TRAIN_ARCH, shape, make_mesh((1, 1), ("data", "model")),
                               "one-card", verbose=False)
    import torch.distributed as dist
    assert not dist.is_initialized()
    log(f"[dryrun] {TRAIN_ARCH} dryrun_config B={DRYRUN_B} S={DRYRUN_S} on a (1,1) mesh: "
        f"dot_flops {rec['device_flops']!r}, arg/temp/output {rec['arg_bytes']}/"
        f"{rec['temp_bytes']}/{rec['output_bytes']} bytes, step_time_s {rec['step_time_s']!r} "
        f"({rec['dominant']}-bound), t_count_s {rec['t_count_s']}")
    assert rec["device_flops"] == DRYRUN_ONE_RANK_FLOPS, rec["device_flops"]

    free = kernel_free(dryrun_config(get_config(TRAIN_ARCH)))
    paths = {"kernel-free": free, "K1": dataclasses.replace(free, attn_impl="pallas")}
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                batch_source(free, DRYRUN_B, DRYRUN_S)(i).items()} for i in range(DRYRUN_STEPS)]
    out = {}
    for tag, cfg in paths.items():
        opt = adamw(linear_warmup_cosine(3e-4, 100, 10_000),
                    moment_dtype=getattr(torch, cfg.opt_moment_dtype))
        state = make_train_state(torch.Generator(device=dev).manual_seed(0), cfg, opt, dev)
        step = make_train_step(cfg, opt, microbatch=cfg.train_microbatch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for name in KERNELS:
            getattr(ops, name).launches = 0
        losses, times = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {name: getattr(ops, name).launches for name in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        steady = min(times[1:])
        predicted = rec["arg_bytes"] + rec["temp_bytes"]
        log(f"[dryrun] {tag} path, {DRYRUN_STEPS} steps: losses {losses}, step times {times}, "
            f"launches {launches}; peak memory {peak} bytes vs the record's arg+temp {predicted} "
            f"(ratio {peak / predicted:.4f}); steady step {steady!r} s vs step_time_s "
            f"{rec['step_time_s']!r} (ratio {steady / rec['step_time_s']:.3f}) {card}")
        assert all(math.isfinite(x) for x in losses), losses
        out[tag] = {"losses": losses, "step_s": times, "peak_bytes": peak,
                    "peak_over_record": peak / predicted,
                    "steady_over_predicted": steady / rec["step_time_s"], "launches": launches}
        del state, step, opt
    expect = expected_train_launches(paths["K1"], DRYRUN_STEPS)
    assert not any(out["kernel-free"]["launches"].values()), out["kernel-free"]["launches"]
    assert out["K1"]["launches"] == expect, (out["K1"]["launches"], expect)
    rel = abs(out["K1"]["losses"][0] - out["kernel-free"]["losses"][0]) / \
        abs(out["kernel-free"]["losses"][0])
    log(f"[dryrun] first-step losses: kernel-free {out['kernel-free']['losses'][0]!r}, K1 "
        f"{out['K1']['losses'][0]!r}, relative gap {rel!r} (limit {DRYRUN_LOSS_TOL})")
    assert rel <= DRYRUN_LOSS_TOL, rel
    return {"record": {k: rec[k] for k in ("device_flops", "arg_bytes", "temp_bytes",
                                           "output_bytes", "step_time_s", "t_count_s")},
            "paths": {tag: {k: v for k, v in o.items() if k != "launches"}
                      for tag, o in out.items()},
            "first_loss_gap": rel, "launches": out["K1"]["launches"]}


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

    t_start = time.perf_counter()

    def phase_done(name: str) -> None:
        log(f"[phase] {name} done at {time.perf_counter() - t_start:.1f} s")

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
    k1_info = infos[KERNELS.index("flash_attention")]
    report_k1_build(torch, fa, _build._nvcc(), k1_info.path, k1_info.log, card)
    k1b_info = infos[KERNELS.index("flash_attention_bwd")]
    report_k1_bwd_build(torch, fa, _build._nvcc(), k1b_info.path, k1b_info.log, card)
    k4_sass = router_sass(_build._nvcc(), infos[KERNELS.index("moe_router")].path)
    for (dtype, vpl, *extra), c in k4_sass.items():
        log(f"[build] moe_router {dtype}, {vpl} values a lane"
            f"{', writing its statistics' if extra else ''}, SASS: {c}")
    assert k4_sass and all(c["REDUX"] > 0 for c in k4_sass.values()), "K4 runs no redux.sync"
    k4b_info = infos[KERNELS.index("moe_router_bwd")]
    k4b_ptxas = ptxas_kernels(k4b_info.log)
    for fn, c in k4b_ptxas.items():
        log(f"[build] moe_router_bwd ptxas {fn}: {c}")
    k4b_sass = router_sass(_build._nvcc(), k4b_info.path, "moe_router_bwd_kernel")
    for (dtype, lanes), c in k4b_sass.items():
        log(f"[build] moe_router_bwd {dtype}, {lanes} lanes a row, SASS: {c}")
    assert k4b_sass and all(c["REDUX"] == 0 and c["SHFL"] <= k4.MAX_TOP_K
                            for c in k4b_sass.values()), "K4's backward reduces across lanes"

    # -- 2. kernels against their plain versions, on the card --------------------------------
    errs = {"flash_attention": check_flash_attention(torch, dev, ops, ref),
            "flash_attention_bwd": check_flash_attention_bwd(torch, dev, ops, ref),
            "rwkv6_scan": check_rwkv6(torch, dev, ops, ref),
            "rwkv6_scan_bwd": check_rwkv6_bwd(torch, dev, ops, ref, rw),
            "rglru_scan": check_rglru(torch, dev, ops, ref),
            "rglru_scan_bwd": check_rglru_bwd(torch, dev, ops, ref),
            "moe_router": check_moe_router(torch, dev, ops, ref, k4),
            "moe_router_bwd": check_moe_router_bwd(torch, dev, ops, ref, k4)}
    k1_vmap = check_flash_attention_vmap(torch, dev, ops, ref, card)
    scans_vmap = check_scans_router_vmap(torch, dev, ops, card)
    # K4's few microseconds a launch and K2's two kernels' device times are
    # read from the profiler here, early: late in a long run, sessions have
    # kept some records and dropped others.
    floor = launch_floor(torch, dev, card)
    router = {label: time_router(torch, dev, ops, ref, k4, card, label, shape, 400 + i)
              for i, (label, shape) in enumerate(ROUTER_SHAPES)}
    r0 = router[ROUTER_SHAPES[0][0]]
    sdpa_lib = sdpa_kernels(torch, dev)
    router_bwd = {label: time_router_bwd(torch, dev, ops, ref, k4, card, label, shape, seed,
                                         floor, k4b_sass, k4b_ptxas)
                  for label, shape, seed in ROUTER_BWD_SHAPES}
    rb0 = router_bwd[ROUTER_BWD_SHAPES[0][0]]
    k2_info = infos[KERNELS.index("rwkv6_scan")]
    k2_passes = report_k2_build(torch, ops, rw, _build._nvcc(), k2_info.path, k2_info.log, card)
    k2b_info = infos[KERNELS.index("rwkv6_scan_bwd")]
    k2_bwd_passes, k2_bwd_sass = report_k2_bwd_build(torch, ops, rw, _build._nvcc(),
                                                     k2b_info.path, k2b_info.log, card)

    phase_done("1 and 2")

    # -- 3. train smollm-135m at full width --------------------------------------------------------
    train = run_train(card, torch, ops, dev)
    per_path = {f"{TRAIN_ARCH} train": train["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3")

    # -- 3h. the same step on DTensor: a world of one rank, a (1,1) mesh -------------------------
    sharded = run_train_sharded(card, torch, ops, dev, train)
    per_path[f"{TRAIN_ARCH} sharded train"] = sharded["launches"]
    for key, fam in sharded["families"].items():
        per_path[f"{key} sharded train"] = fam["launches"]
    phase_done("3h")

    # -- 3b. an ASHA sweep of it through launch.tune, and one trial in a worker process ------
    sweep = run_sweep(card, torch, ops)
    per_path[f"{TRAIN_ARCH} sweep"] = sweep["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3b")

    # -- 3e. the same sweep on the cluster tier, then a worker killed and restored -------------
    cluster = run_cluster(card, torch, sweep)
    per_path[f"{TRAIN_ARCH} cluster sweep"] = cluster["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3e")

    # -- 3g. the sweep as lanes of one vmapped step ---------------------------------------------
    vmap_sweep = run_vmap_sweep(card, torch, ops, dev, sweep, train)
    per_path[f"{TRAIN_ARCH} vmap sweep"] = vmap_sweep["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3g")

    # -- 3k. the ssm, hybrid and moe families' sweeps as lanes of one vmapped step --------------
    vmap_families = {}
    for arch, lanes, layers, batch in VMAP_FAMILIES:
        vmap_families[arch] = run_vmap_family(card, torch, ops, dev, arch, lanes, layers, batch)
        per_path[f"{arch} vmap sweep"] = vmap_families[arch]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    phase_done("3k")

    # -- 3c. train rwkv6-1.6b and a cut recurrentgemma-9b through the scan kernels -------------
    train_r = {}
    for arch, n_layers in TRAIN_R:
        train_r[arch] = run_train_recurrent(card, torch, ops, dev, arch, n_layers)
        per_path[f"{arch} train"] = train_r[arch]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        phase_done(f"3c {arch}")

    # -- 3d. train granite-moe-3b-a800m through K4's forward and backward ------------------------
    train_moe = run_train_moe(card, torch, ops, dev)
    per_path[f"{TRAIN_MOE} train"] = train_moe["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3d")

    # -- 3f. train hubert-xlarge at full width and depth through K1 at hd 80 ---------------------
    train_audio = run_train_audio(card, torch, ops, dev)
    per_path[f"{TRAIN_AUDIO} train"] = train_audio["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("3f")

    # -- 3j's dry-run CLI starts here, on the host (no card visible to it), and runs beside
    # phases 4, 5, 3i, 3j's one-card config and 3l, which use the card; collected after 3l
    dry_started = start_dryrun_cli()

    # -- 4 and 5. serve each model at full width, then its times -----------------------------------
    for arch in ARCHS:
        per_path[arch] = run_path(arch, card, torch, ops, serve, prefill, decode_step,
                                  get_config, leaves)
        gc.collect()
        torch.cuda.empty_cache()
        phase_done(f"4 {arch}")

    # -- 5. kernel times at the serving and training shapes -----------------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    times = {}
    attn = {label: time_attention(torch, dev, ops, ref, card, label, shape, window, seed, causal,
                                  sdpa_lib[label])
            for label, shape, window, seed, causal in ATTN_SHAPES}
    k1 = attn[ATTN_SHAPES[0][0]]
    times["flash_attention"] = (k1["ms"], k1["plain_ms"], k1["bound"], k1["library_ms"])
    attn_bwd = {label: time_attention_bwd(torch, dev, ops, ref, card, label, shape, window,
                                          seed + 400, causal)
                for label, shape, window, seed, causal in ATTN_SHAPES}
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

    phase_done("5")

    # -- 3i. the trainable's roofline profile, after every phase that needs whole profiler sessions
    gc.collect()
    torch.cuda.empty_cache()
    profile = run_profile(card, torch, ops, dev)
    per_path[f"{TRAIN_ARCH} profiled trial"] = profile["launches"]
    phase_done("3i")

    # -- 3j. the record's config on the card, and 3l. the port's examples there; then the
    # dry-run CLI's records ------------------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    dry_cfg = run_dryrun_config(card, torch, ops, dev)
    per_path[f"{TRAIN_ARCH} dry-run config"] = dry_cfg["launches"]
    phase_done("3j's one-card config")
    gc.collect()
    torch.cuda.empty_cache()
    examples = run_examples(card)
    phase_done("3l")
    dry_cli = finish_dryrun_cli(card, dry_started)
    phase_done("3j")

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
    for name, key, field in (
            ("rwkv6_scan_bwd", "rwkv6-1.6b", "sharded_train_step"),
            ("rglru_scan_bwd", "recurrentgemma-9b", "sharded_train_step"),
            ("moe_router_bwd", "granite-moe-3b-a800m", "sharded_train_step"),
            ("moe_router_bwd", "granite-moe-3b-a800m scatter", "sharded_scatter_train_step")):
        kernels[KERNELS.index(name)][field] = {
            k: v for k, v in sharded["families"][key].items() if k != "launches"}
    for name, arch in (("rwkv6_scan", "rwkv6-1.6b"), ("rglru_scan", "recurrentgemma-9b"),
                       ("moe_router", "granite-moe-3b-a800m")):
        kernels[KERNELS.index(name)]["vmap"] = {
            case: t for case, t in scans_vmap.items() if case.startswith(name)}
        kernels[KERNELS.index(f"{name}_bwd")]["vmap_sweep"] = {
            k: v for k, v in vmap_families[arch].items() if k != "launches"}
    kernels[KERNELS.index("flash_attention")].update(
        shapes={label: {key: val for key, val in r.items() if key != "bound"}
                for label, r in attn.items()},
        vmap=k1_vmap)
    kernels[KERNELS.index("flash_attention_bwd")].update(
        bf16_ms=k1b["bf16_ms"], bf16_tensor_core_bound_ms=k1b["bf16_tensor_core_bound_ms"],
        library_kernels=k1b["library_kernels"],
        shapes={label: {key: val for key, val in r.items() if key != "bound"}
                for label, r in attn_bwd.items()},
        train_step={key: val for key, val in train.items() if key not in ("launches", "losses")},
        sharded_train_step={key: val for key, val in sharded.items()
                            if key not in ("launches", "families")},
        audio_train_step={key: val for key, val in train_audio.items() if key != "launches"},
        sweep={key: val for key, val in sweep.items() if key not in ("launches", "losses")},
        cluster_sweep={key: val for key, val in cluster.items() if key != "launches"},
        vmap_sweep={key: val for key, val in vmap_sweep.items() if key != "launches"},
        profiled_trial={key: val for key, val in profile.items() if key != "launches"},
        dryrun={"cli": dry_cli, "one_card": {k: v for k, v in dry_cfg.items() if k != "launches"}},
        examples=examples)
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
