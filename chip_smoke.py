#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with its traceback and a
non-zero exit:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
   build the CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
   and print ptxas' report.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and a few edge cases, with stated tolerances.
3. serve: ``repro_torch.launch.serve`` on smollm-135m at full width
   (batch 8, prompt 512, 32 new tokens, greedy).  The launch counts are set
   to 0 just before and read just after; then the same tokens are
   teacher-forced through the plain path (``attn_impl="naive"``) and the
   prefill logits, every layer's cache and every decode step's logits must
   agree.
4. times: each kernel, its plain version and the PyTorch library call
   (CUDA events), and prefill / decode times, each printed with the card;
   then ``torch.profiler`` traces one warm prefill and 8 warm decode steps
   and prints, for each, wall time, the device's busy and idle share, and
   the kernels that took the most device time.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet, dense, at the full 700 W: CUDA-core fp32 and HBM rates.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the tolerances of tests/test_kernels.py
# Serve check, kernel path vs plain path: 30 layers of fp32 sums taken in
# another order (blocked online softmax vs one einsum and softmax).  Runs on
# an H100 read at most 1.17e-5 (caches), 4.8e-6 (prefill logits) and 2.6e-6
# (decode logits); 1e-4 leaves about 10x room over the largest.
SERVE_RTOL = SERVE_ATOL = 1e-4
TRACE_DECODE_STEPS, TRACE_TOP = 8, 10


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


def trace(name: str, fn, card: str) -> None:
    """Run ``fn`` once under ``torch.profiler``; print wall time, the device's
    busy time and idle share, and the kernels with the most device time.
    Busy time sums the traced kernels (one stream, so they do not overlap);
    a trace with no device time fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    assert busy_us > 0, f"{name}: the trace holds no device time"
    log(f"[trace] {name}: wall {wall_us / 1e3!r} ms, device busy {busy_us / 1e3!r} ms, "
        f"idle share {1 - busy_us / wall_us!r}, {sum(e.count for e in kernels)} kernel "
        f"launches {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TRACE_TOP]:
        log(f"[trace]   {e.self_device_time_total / 1e3:10.4f} ms  {e.count:5d}x  "
            f"{e.self_device_time_total / busy_us:6.1%}  {e.key[:90]}")


def attention_inputs(torch, dev, seed, B, Sq, Sk, H, K, hd, dtype, q0=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    q0 = Sk - Sq if q0 is None else q0
    qp = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    return q, k, v, qp, kp


def attention_bound(q, k, v, qp, kp, causal=True, window=None):
    """Least time for the function on this card: operations (4*hd per allowed
    (query, key) pair, counted from these positions) over the fp32 CUDA-core
    peak, or bytes (each input read once, the output written once) over HBM."""
    d = qp[:, :, None] - kp[:, None, :]
    ok = kp[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    H, hd = q.shape[2], q.shape[3]
    flops = 4.0 * hd * H * int(ok.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, qp, kp)) \
        + q.numel() * q.element_size()
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, prefill

    # -- 1. device -----------------------------------------------------------------
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
    info = _build.build("flash_attention")
    log(f"[build] flash_attention: {info.seconds:.2f}s{' (cached)' if info.cached else ''} "
        f"-> {info.path.name}")
    for line in info.log.splitlines():
        log(f"[build]   {line}")

    # -- 2. kernels against their plain versions, on the card --------------------------
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
        ("gemma-2b hd256 MQA", (2, 256, 256, 8, 1, 256), f32, {}, None),
        ("gemma-2b hd256 MQA bf16", (2, 256, 256, 8, 1, 256), bf16, {}, None),
    ]
    main_err = None
    for i, (name, shape, dtype, kw, edit) in enumerate(cases):
        q, k, v, qp, kp = attention_inputs(torch, dev, 100 + i, *shape, dtype)
        if edit == "holes":
            qp += 300
            kp[:, 96:200] = -1
        if edit == "masked_row":
            qp[1, 7] = -1
        out = ops.flash_attention(q, k, v, qp, kp, causal=True, **kw)
        torch.cuda.synchronize()
        exp = ref.flash_attention_ref(q, k, v, qp, kp, causal=True, **kw)
        assert out.shape == exp.shape and out.dtype == exp.dtype, name
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite output"
        err = float((out.float() - exp.float()).abs().max())
        atol = ATOL[str(dtype).split(".")[1]]
        log(f"[kernel] flash_attention {name} {shape} {dtype}: max_abs_err {err!r} "
            f"(atol {atol})")
        assert err <= atol, f"{name}: max_abs_err {err} > {atol}"
        if edit == "masked_row":
            assert int(torch.count_nonzero(out[1, 7])) == 0, "fully masked row is not 0"
        if i == 0:
            main_err = err

    # -- 3. serve smollm-135m at full width -------------------------------------------
    B, S, NEW = 8, 512, 32
    cfg = get_config("smollm-135m")
    ops.flash_attention.launches = 0
    res = serve.main(["--arch", "smollm-135m", "--batch", str(B), "--prompt-len", str(S),
                      "--new-tokens", str(NEW), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"flash_attention": ops.flash_attention.launches}
    log(f"[serve] kernel launches on the main path: {launches}")
    assert launches["flash_attention"] == cfg.n_layers, \
        f"expected {cfg.n_layers} flash_attention launches (one per layer, one prefill)"
    assert res.prefill_logits.shape == (B, cfg.vocab_size)
    assert res.tokens.shape == (B, NEW) and len(res.step_logits) == NEW - 1
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert all(bool(torch.isfinite(x).all()) for x in res.step_logits)

    plain = dataclasses.replace(res.cfg, attn_impl="naive")
    logits, caches = prefill(res.params, {"tokens": res.prompts}, plain, S + NEW)
    errs = {"prefill_logits": float((logits - res.prefill_logits).abs().max())}
    torch.testing.assert_close(logits, res.prefill_logits, rtol=SERVE_RTOL, atol=SERVE_ATOL)
    step_err = 0.0
    for i in range(NEW - 1):
        logits, caches = decode_step(res.params, caches, res.tokens[:, i], S + i, plain)
        torch.testing.assert_close(logits, res.step_logits[i], rtol=SERVE_RTOL, atol=SERVE_ATOL)
        step_err = max(step_err, float((logits - res.step_logits[i]).abs().max()))
    errs["decode_logits"] = step_err
    cache_err = 0.0
    for pseg, kseg in zip(caches, res.caches):
        for pst, kst in zip(pseg, kseg):
            assert torch.equal(pst["kpos"], kst["kpos"])
            for leaf in ("k", "v"):
                torch.testing.assert_close(pst[leaf], kst[leaf], rtol=SERVE_RTOL, atol=SERVE_ATOL)
                cache_err = max(cache_err, float((pst[leaf] - kst[leaf]).abs().max()))
    errs["caches"] = cache_err
    log(f"[serve] kernel path vs plain path, max abs err: {errs} "
        f"(rtol {SERVE_RTOL}, atol {SERVE_ATOL})")
    log(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # -- 4. times ---------------------------------------------------------------------
    import torch.nn.functional as F
    q, k, v, qp, kp = attention_inputs(torch, dev, 100, 8, 512, 512, 9, 3, 64, f32)
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in
                  (q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    lib_err = float((F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).transpose(1, 2)
                     - ref.flash_attention_ref(q, k, v, qp, kp)).abs().max())
    timings = {}
    for turn in ("plain", "kernel", "kernel", "plain"):   # interleaved on one card
        fn = (lambda: ops.flash_attention(q, k, v, qp, kp)) if turn == "kernel" \
            else (lambda: ref.flash_attention_ref(q, k, v, qp, kp))
        timings.setdefault(turn, []).append(time_ms(fn))
    kernel_ms, plain_ms = min(timings["kernel"]), min(timings["plain"])
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by, flops, nbytes = attention_bound(q, k, v, qp, kp)
    qb, kb, vb = (x.to(bf16) for x in (q, k, v))
    kernel_bf16_ms = time_ms(lambda: ops.flash_attention(qb, kb, vb, qp, kp))
    shape = "B=8 S=512 H=9 K=3 hd=64 causal"
    log(f"[time] flash_attention kernel fp32 {shape}: {kernel_ms!r} ms {card} "
        f"(runs {timings['kernel']})")
    log(f"[time] flash_attention kernel bf16 {shape}: {kernel_bf16_ms!r} ms {card}")
    log(f"[time] flash_attention plain version fp32 {shape}: {plain_ms!r} ms {card} "
        f"(runs {timings['plain']})")
    log(f"[time] torch scaled_dot_product_attention fp32 {shape} (kv heads expanded "
        f"beforehand; max_abs_err vs plain {lib_err!r}): {library_ms!r} ms {card}")
    log(f"[time] flash_attention bound fp32 {shape}: {bound_ms!r} ms by {bound_by} "
        f"({flops:.4g} flop, {nbytes:.4g} bytes; H100 SXM peaks at 700 W) {card}")

    params, prompts = res.params, res.prompts
    kernel_cfg = res.cfg
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompts}, kernel_cfg, S + NEW)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    log(f"[time] prefill {B}x{S} in serve (first call): {res.prefill_s!r} s {card}")
    log(f"[time] prefill {B}x{S} warm, median of 3: {statistics.median(pre)!r} s "
        f"(runs {pre}) {card}")
    log(f"[time] decode {NEW - 1} steps x batch {B}: {res.decode_s!r} s, "
        f"{B * (NEW - 1) / res.decode_s!r} tokens/s {card}")

    def run_decode(caches, first):
        tok = prompts[:, -1]
        for i in range(TRACE_DECODE_STEPS):
            logits, caches = decode_step(params, caches, tok, first + i, kernel_cfg)
            tok = logits.argmax(-1)

    _, caches = prefill(params, {"tokens": prompts}, kernel_cfg, S + NEW)
    trace("prefill (warm)", lambda: prefill(params, {"tokens": prompts}, kernel_cfg, S + NEW),
          card)
    run_decode(caches, S)                                   # warm-up
    trace(f"decode x{TRACE_DECODE_STEPS} (warm)",
          lambda: run_decode(caches, S + TRACE_DECODE_STEPS), card)

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": launches["flash_attention"], "max_abs_err": main_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
