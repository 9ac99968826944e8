"""The port's flash attention against the JAX package's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs its plain
version; it is held against the JAX Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and against ``repro.kernels.ref``, on the
cases of ``TestFlashAttention``.  The CUDA kernel itself is held against the
plain version by the ``gpu`` tests, which skip without a card.
"""
import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import moe_router as prouter
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rglru_scan as prg
from repro_torch.kernels import rwkv6_scan as prw

# Tolerances of tests/test_kernels.py.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, Sq, Sk, H, K, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))


def _positions(B, Sq, Sk, q0=None, k0=0):
    q0 = Sk - Sq if q0 is None else q0
    qp = np.broadcast_to(np.arange(q0, q0 + Sq, dtype=np.int32)[None], (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(k0, k0 + Sk, dtype=np.int32)[None], (B, Sk)).copy()
    return qp, kp


def _run_all(arrays, qp, kp, dtype="float32", block=64, **kw):
    """(port, JAX Pallas interpret, JAX ref) outputs as float32 numpy."""
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in arrays)
    pq, pk, pv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    port = pops.flash_attention(pq, pk, pv, torch.from_numpy(qp), torch.from_numpy(kp), **kw)
    jax_k = jops.flash_attention(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp),
                                 block_q=block, block_k=block, **kw)
    jax_r = jref.flash_attention_ref(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp), **kw)
    assert port.dtype == pq.dtype and tuple(port.shape) == arrays[0].shape
    return (port.float().numpy(), np.asarray(jax_k, np.float32),
            np.asarray(jax_r, np.float32))


def _check(outs, atol):
    port, jax_k, jax_r = outs
    np.testing.assert_allclose(port, jax_r, atol=atol)
    np.testing.assert_allclose(port, jax_k, atol=atol)


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd", [
    (1, 64, 64, 1, 1, 32),       # minimal MHA
    (2, 128, 128, 4, 2, 64),     # GQA
    (2, 96, 160, 4, 1, 64),      # MQA, odd sizes
    (1, 256, 256, 8, 8, 32),     # full heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shape_dtype_sweep(B, Sq, Sk, H, K, hd, dtype):
    qp, kp = _positions(B, Sq, Sk)
    _check(_run_all(_inputs(0, B, Sq, Sk, H, K, hd), qp, kp, dtype, causal=True),
           ATOL[dtype])


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None),
    (True, 32, None), (True, None, 20.0), (True, 16, 20.0),
])
def test_mask_variants(causal, window, softcap):
    B, S, H, K, hd = 2, 128, 2, 2, 32
    qp, kp = _positions(B, S, S)
    _check(_run_all(_inputs(1, B, S, S, H, K, hd), qp, kp, causal=causal,
                    window=window, softcap=softcap), ATOL["float32"])


def test_ring_cache_invalid_slots_masked():
    """k_pos == -1 slots (unfilled ring entries) contribute nothing."""
    B, Sq, Sk, H, hd = 1, 64, 128, 2, 32
    q, k, v = _inputs(2, B, Sq, Sk, H, H, hd)
    qp, kp = _positions(B, Sq, Sk, q0=100, k0=36)
    holes = kp.copy()
    holes[:, 64:] = -1
    port, jax_k, _ = _run_all((q, k, v), qp, holes, causal=True)
    expect = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k[:, :64]), jnp.asarray(v[:, :64]),
        jnp.asarray(qp), jnp.asarray(kp[:, :64]), causal=True))
    np.testing.assert_allclose(port, expect, atol=2e-5)
    np.testing.assert_allclose(port, jax_k, atol=2e-5)


def test_decode_single_query():
    B, Sk, H, K, hd = 4, 128, 4, 2, 64
    qp = np.full((B, 1), Sk - 1, np.int32)
    _, kp = _positions(B, 1, Sk)
    _check(_run_all(_inputs(3, B, 1, Sk, H, K, hd), qp, kp, block=128, causal=True),
           ATOL["float32"])


@pytest.mark.parametrize("seed", range(6))
def test_odd_sizes(seed):
    """The fuzz of tests/test_kernels.py, on fixed draws."""
    B, K, Sq = (int(x) for x in np.random.default_rng(seed).integers((1, 1, 8), (4, 5, 81)))
    H, hd, Sk = K * 2, 16, 96
    qp, kp = _positions(B, Sq, Sk)
    port, jax_k, jax_r = _run_all(_inputs(seed, B, Sq, Sk, H, K, hd), qp, kp, block=32)
    np.testing.assert_allclose(port, jax_r, atol=3e-5)
    np.testing.assert_allclose(port, jax_k, atol=3e-5)


def test_fully_masked_row_is_zero():
    """The port's contract is ref.py's 0 for a row that may see no key.  The
    TPU kernel returns the mean of the masked values there (it masks with
    -1e30): a known difference of the TPU kernel, off the serving path."""
    B, S, H, hd = 1, 64, 2, 64
    q, k, v = _inputs(4, B, S, S, H, H, hd)
    qp, kp = _positions(B, S, S)
    qp[0, 5] = -3                               # before every key: nothing to see
    port, jax_k, jax_r = _run_all((q, k, v), qp, kp, causal=True)
    np.testing.assert_array_equal(port[0, 5], 0.0)
    np.testing.assert_array_equal(jax_r[0, 5], 0.0)
    rows = np.arange(S) != 5
    np.testing.assert_allclose(port[:, rows], jax_r[:, rows], atol=2e-5)
    np.testing.assert_allclose(jax_k[0, 5], v[0].mean(0), atol=2e-5)


def test_cpu_dispatches_to_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 64, 64, 2, 1, 64))
    qp, kp = (torch.from_numpy(a) for a in _positions(1, 64, 64))
    before = pops.flash_attention.launches
    out = pops.flash_attention(q, k, v, qp, kp, causal=True, window=8)
    assert pops.flash_attention.launches == before
    torch.testing.assert_close(out, pref.flash_attention_ref(q, k, v, qp, kp, True, 8),
                               rtol=0, atol=0)


def test_non_cpu_tensor_never_runs_the_plain_version():
    """A tensor off the CPU goes to the kernel, which refuses what is not on
    the card: here a meta tensor, as no card is needed to show it."""
    q, k, v = (torch.empty(s, device="meta") for s in
               ((1, 64, 2, 64), (1, 64, 1, 64), (1, 64, 1, 64)))
    qp = kp = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    before = pops.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.flash_attention(q, k, v, qp, kp)
    assert pops.flash_attention.launches == before


def test_tile_config_refuses_what_has_no_kernel():
    for dtype, hd in ((torch.float16, 64), (torch.float32, 96)):
        with pytest.raises(ValueError, match="no kernel"):
            pfa.tile_config(dtype, hd)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 8, 8, 1, 1, 64))
    qp, kp = (torch.from_numpy(a) for a in _positions(1, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pfa.flash_attention_cuda(q, k, v, qp, kp)


# -- the backward: its plain version against jax.grad ------------------------------------
# The JAX Pallas kernel has no VJP (JAX trains through the jnp attention), so
# the port's flash_attention_bwd_ref, written out by the formula from the
# forward's log-sum-exp, is held against jax.grad of repro's
# flash_attention_ref: normwise, max |port - jax| over max(1, max |jax|), at
# the kernel tolerances of tests/test_kernels.py.
BWD_CASES = {  # (B, Sq, Sk, H, K, hd), kwargs, edit
    "GQA": ((2, 40, 40, 4, 2, 32), {}, None),
    "MHA hd 64": ((1, 64, 64, 2, 2, 64), {}, None),
    "window + softcap": ((2, 48, 48, 4, 2, 32), {"window": 9, "softcap": 5.0}, None),
    "empty key slots": ((2, 16, 48, 4, 2, 32), {}, "holes"),
    "fully masked rows": ((2, 32, 32, 4, 1, 32), {}, "masked_rows"),
    "ragged Sq < Sk, MQA": ((2, 24, 56, 4, 1, 32), {}, None),
    "not causal": ((1, 20, 36, 2, 1, 32), {"causal": False}, None),
}


def _bwd_inputs(name):
    shape, kw, edit = BWD_CASES[name]
    B, Sq, Sk, H, K, hd = shape
    q, k, v = _inputs(11, B, Sq, Sk, H, K, hd)
    qp, kp = _positions(B, Sq, Sk)
    if edit == "holes":
        kp[:, 10:30] = -1
    if edit == "masked_rows":
        qp[0, 3] = qp[1, 30] = -1
    dout = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    return (q, k, v), qp, kp, dout, kw


@pytest.mark.parametrize("name", list(BWD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_jax_grad(name, dtype):
    arrays, qp, kp, dout, kw = _bwd_inputs(name)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in arrays)
    jdo = jnp.asarray(dout).astype(jd)
    f = lambda q, k, v: jnp.sum(jref.flash_attention_ref(
        q, k, v, jnp.asarray(qp), jnp.asarray(kp), **kw).astype(jnp.float32)
        * jdo.astype(jnp.float32))
    expect = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    q, k, v = (torch.from_numpy(a).to(td) for a in arrays)
    qpt, kpt = torch.from_numpy(qp), torch.from_numpy(kp)
    out, lse = pref.flash_attention_ref(q, k, v, qpt, kpt, return_lse=True, **kw)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    got = pref.flash_attention_bwd_ref(q, k, v, qpt, kpt, out, lse,
                                       torch.from_numpy(dout).to(td), **kw)
    for g, e, t in zip(got, expect, (q, k, v)):
        assert g.dtype == td and g.shape == t.shape
        e = np.asarray(e, np.float32)
        err = np.abs(g.float().numpy() - e).max() / max(1.0, np.abs(e).max())
        assert err <= ATOL[dtype], err
    if name == "fully masked rows":
        assert float(lse[0, :, 3].min()) == float("inf") and not got[0][0, 3].any()


def test_bwd_on_cpu_runs_the_plain_version_without_counting():
    arrays, qp, kp, dout, kw = _bwd_inputs("GQA")
    q, k, v = (torch.from_numpy(a) for a in arrays)
    qpt, kpt, do = torch.from_numpy(qp), torch.from_numpy(kp), torch.from_numpy(dout)
    out, lse = pref.flash_attention_ref(q, k, v, qpt, kpt, return_lse=True)
    before = pops.flash_attention_bwd.launches
    got = pops.flash_attention_bwd(q, k, v, qpt, kpt, out, lse, do)
    assert pops.flash_attention_bwd.launches == before
    for a, b in zip(got, pref.flash_attention_bwd_ref(q, k, v, qpt, kpt, out, lse, do)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # autograd of the plain forward, which ops.flash_attention runs on the CPU
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    pops.flash_attention(qa, ka, va, qpt, kpt).backward(do)
    for a, b in zip((qa.grad, ka.grad, va.grad), got):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def _meta(*shapes, grad=False):
    return [torch.empty(s, device="meta", requires_grad=grad) for s in shapes]


def test_grad_path_off_the_cpu_never_runs_the_plain_version():
    """A tensor off the CPU that needs a gradient goes through
    FlashAttentionFn, whose kernel refuses what is not on the card."""
    q, k, v = _meta((1, 64, 2, 64), (1, 64, 1, 64), (1, 64, 1, 64), grad=True)
    qp = kp = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    before = pops.flash_attention.launches, pops.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.flash_attention(q, k, v, qp, kp)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.flash_attention_bwd(q, k, v, qp, kp, q, torch.empty((1, 2, 64), device="meta"), q)
    assert (pops.flash_attention.launches, pops.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("name", ["moe_router"])
def test_kernels_without_a_backward_refuse_a_gradient_off_the_cpu(name):
    """The router's gradient path off the CPU never runs the plain version:
    a tensor that needs a gradient goes through MoERouterFn, whose kernel
    refuses what is not on the card; so does the backward's wrapper, given
    the forward's row statistics or not (without them it names them: they
    are never recomputed), and without a gradient (or under no_grad) the
    forward's, asked for its statistics or not.  No counter moves."""
    def call(grad):
        return pops.moe_router(*_meta((4, 8), grad=grad), 2)
    before = pops.moe_router.launches, pops.moe_router_bwd.launches
    with mock.patch.object(prouter.MoERouterFn, "apply",
                           wraps=prouter.MoERouterFn.apply) as fn:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call(grad=True)
        assert fn.call_count == 1
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call(grad=False)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors only"):
            call(grad=True)
        assert fn.call_count == 1
    logits, w, dw = _meta((4, 8), (4, 2), (4, 2))
    idx = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    stats = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.moe_router_bwd(logits, w, idx, dw, stats)
    with pytest.raises(ValueError, match="row statistics"):
        pops.moe_router_bwd(logits, w, idx, dw)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        prouter.moe_router_cuda(logits, 2, return_stats=True)
    assert (pops.moe_router.launches, pops.moe_router_bwd.launches) == before


@pytest.mark.parametrize("name", ["rwkv6_scan", "rglru_scan"])
def test_scan_grad_path_off_the_cpu_never_runs_the_plain_version(name):
    """A tensor off the CPU that needs a gradient goes through the scan's
    autograd Function (RWKV6ScanFn, RGLRUScanFn), whose kernel refuses what
    is not on the card; so does the backward's wrapper, and without a
    gradient the forward's.  No counter moves."""
    def call(grad):
        if name == "rwkv6_scan":
            r, k, v, logw = _meta(*[(1, 8, 2, 64)] * 4, grad=grad)
            u, s0 = _meta((2, 64), (1, 2, 64, 64))
            return pops.rwkv6_scan(r, k, v, logw, u, s0)
        a, b = _meta((1, 8, 16), (1, 8, 16), grad=grad)
        return pops.rglru_scan(a, b)

    def backward():
        if name == "rwkv6_scan":
            r, k, v, logw, dy = _meta(*[(1, 8, 2, 64)] * 5)
            u, s0, states = _meta((2, 64), (1, 2, 64, 64), (1, 2, 0, 64, 64))
            return pops.rwkv6_scan_bwd(r, k, v, logw, u, s0, states, dy)
        a, h, dh = _meta(*[(1, 8, 16)] * 3)
        return pops.rglru_scan_bwd(a, None, h, dh)
    fns = {"rwkv6_scan": pref.rwkv6_scan_ref, "rglru_scan": pref.rglru_scan_ref}
    counters = (getattr(pops, name), getattr(pops, f"{name}_bwd"))
    before = [c.launches for c in counters]
    entered = []
    fn_class = {"rwkv6_scan": prw.RWKV6ScanFn, "rglru_scan": prg.RGLRUScanFn}[name]
    real_forward = fn_class.forward

    def spy(ctx, *args):
        entered.append(name)
        return real_forward(ctx, *args)
    with mock.patch.object(fn_class, "forward", staticmethod(spy)), \
            mock.patch.object(pref, fns[name].__name__, side_effect=AssertionError("plain")):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call(grad=True)
        assert entered == [name]
        with pytest.raises(ValueError, match="CUDA tensors only"):
            backward()
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call(grad=False)
    assert entered == [name]
    assert [c.launches for c in counters] == before


def test_bwd_tile_config_refuses_what_has_no_kernel():
    for dtype, hd in ((torch.float16, 64), (torch.float32, 32)):
        with pytest.raises(ValueError, match="no kernel"):
            pfa.bwd_tile_config(dtype, hd)


# -- the build hash ------------------------------------------------------------------------

def test_build_hash_covers_the_headers_a_source_includes(tmp_path):
    """A library is keyed on its source and every csrc/ file it includes
    (through other headers too), so an edited header can never be served
    from a stale library; a file it does not include changes nothing."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    base = _build.source_digest(tmp_path / "k.cu")
    assert len(base) == 16 and base == _build.source_digest(tmp_path / "k.cu")
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert _build.source_digest(tmp_path / "k.cu") == base
    (tmp_path / "b.cuh").write_text("int b2;\n")
    changed = _build.source_digest(tmp_path / "k.cu")
    assert changed != base
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint y;\n')
    assert _build.source_digest(tmp_path / "k.cu") not in (base, changed)


def test_every_kernel_source_has_its_own_hash():
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert names == ["flash_attention", "flash_attention_bwd", "moe_router", "moe_router_bwd",
                     "rglru_scan", "rglru_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd"]
    assert len({_build.source_digest(_build.CSRC_DIR / f"{n}.cu") for n in names}) == 8


def test_threads_that_reach_a_kernel_together_build_it_once(tmp_path, monkeypatch):
    """The concurrent executor's trials reach a kernel first in several
    threads of one process at once: one compile, and every thread gets the
    library.  The stub compiler logs each call and writes its ``-o`` file
    slowly, so threads that were not held back would overlap."""
    import sys
    import threading

    from repro_torch.kernels import _build
    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\n"
                    "import sys, time\n"
                    f"open({str(calls)!r}, 'a').write('x')\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "time.sleep(0.3)\n"
                    "open(out, 'w').write('lib')\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    results, errors = [], []
    start = threading.Barrier(4)

    def reach():
        start.wait()
        try:
            results.append(_build.build("rglru_scan"))
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=reach) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert calls.read_text() == "x"
    assert len({r.path for r in results}) == 1 and sum(not r.cached for r in results) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [results[0].path.name, results[0].path.with_suffix(".log").name])


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("window,holes", [(None, False), (4, False), (None, True)])
def test_chip_smoke_bound_counts_only_allowed_pairs(window, holes):
    """The bound that chip_smoke.py reports counts 4*hd flops per (query, key)
    pair the mask allows and each input read once, the output written once;
    the tensor-core bound takes K1's 3 TF32 products for fp32 and the
    function's own operations for bf16."""
    smoke = _load_chip_smoke()
    B, S, H, K, hd = 2, 16, 3, 1, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, B, S, S, H, K, hd))
    qp, kp = (torch.from_numpy(a) for a in _positions(B, S, S))
    if holes:
        kp[:, 3:7] = -1
    pairs = sum(1 for i in range(S) for j in range(S)
                if j <= i and (window is None or i - j < window) and not (holes and 3 <= j < 7))
    ms, by, flops, nbytes, tc_ms, tc_by = smoke.attention_bound(q, k, v, qp, kp, window=window)
    assert flops == 4 * hd * H * B * pairs
    assert nbytes == 4 * (2 * q.numel() + k.numel() + v.numel() + qp.numel() + kp.numel())
    assert ms == pytest.approx(1e3 * max(flops / smoke.PEAK_FP32_FLOPS,
                                         nbytes / smoke.PEAK_HBM_BYTES))
    assert by == ("operations" if flops / smoke.PEAK_FP32_FLOPS >= nbytes / smoke.PEAK_HBM_BYTES
                  else "bytes")
    t_ops, t_bytes = 3 * flops / smoke.PEAK_TF32_FLOPS, nbytes / smoke.PEAK_HBM_BYTES
    assert tc_ms == pytest.approx(1e3 * max(t_ops, t_bytes))
    assert tc_by == ("operations" if t_ops >= t_bytes else "bytes")
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    _, _, flops_b, nbytes_b, tc_b, _ = smoke.attention_bound(qb, kb, vb, qp, kp, window=window)
    assert flops_b == flops
    assert nbytes_b == 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (qp.numel() + kp.numel())
    assert tc_b == pytest.approx(1e3 * max(flops / smoke.PEAK_BF16_FLOPS,
                                           nbytes_b / smoke.PEAK_HBM_BYTES))


@pytest.mark.parametrize("holes", [False, True])
def test_chip_smoke_bounds_count_every_pair_without_a_causal_mask(holes):
    """Bidirectional attention (hubert-xlarge's encoder): both bounds count
    every (query, key) pair of a key in use, S^2 a head when none is empty."""
    smoke = _load_chip_smoke()
    B, S, H, K, hd = 2, 16, 3, 1, 80
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, B, S, S, H, K, hd))
    qp, kp = (torch.from_numpy(a) for a in _positions(B, S, S))
    if holes:
        kp[:, 3:7] = -1
    pairs = S * (S - 4 if holes else S)
    assert smoke.allowed_pairs(qp, kp, causal=False) == B * pairs
    fwd = smoke.attention_bound(q, k, v, qp, kp, causal=False)
    bwd = smoke.attention_bwd_bound(q, k, v, qp, kp, causal=False)
    assert (fwd[2], bwd[2]) == (4 * hd * H * B * pairs, 10 * hd * H * B * pairs)
    assert smoke.attention_bound(q, k, v, qp, kp)[2] < fwd[2]


def test_chip_smoke_device_time_survives_dropped_profiler_records():
    """Late in a long run torch.profiler keeps only some kernel records;
    chip_smoke's per-call device time averages over the launches it kept."""
    smoke = _load_chip_smoke()
    calls = 10
    kept = [("router_kernel", 7, 7 * 0.005),            # 1 launch a call, 3 records lost
            ("sort_kernel", 17, 17 * 0.002),            # 2 launches a call, 3 lost
            ("softmax_kernel", 10, 10 * 0.001)]         # 1 launch a call, none lost
    assert smoke.per_call_ms(kept, calls, "router") == pytest.approx(0.005)
    assert smoke.per_call_ms(kept, calls) == pytest.approx(0.005 + 2 * 0.002 + 0.001)


@pytest.mark.parametrize("lost", [0, 5])
def test_chip_smoke_trace_marks_dropped_records_as_bounds(lost):
    """A trace's launches of this repo's kernels are held against the
    wrapper calls made under it (K2 launches two kernels a call); where the
    profiler kept fewer, busy time and idle share are printed as bounds."""
    smoke = _load_chip_smoke()
    records = [("(anonymous namespace)::rwkv6_scan_states_kernel<float>(Params)", 24, 400.0),
               ("(anonymous namespace)::rwkv6_scan_outputs_kernel<float>(Params)", 24 - lost,
                600.0),
               ("ampere_sgemm_128x64_nn", 200, 9000.0)]
    calls = {"flash_attention": 0, "rwkv6_scan": 24, "rglru_scan": 0, "moe_router": 0}
    t = smoke.trace_summary(records, 20000.0, calls)
    assert t["busy_us"] == 10000.0 and t["idle_share"] == pytest.approx(0.5)
    assert t["kept"]["rwkv6_scan"] == 48 - lost and t["expected"]["rwkv6_scan"] == 48
    assert t["expected"]["flash_attention"] == 0 and t["dropped"] == bool(lost)
    line = smoke.trace_head("rwkv6 prefill (warm)", 20000.0, records, calls, "[H100, 700 W]")
    assert f"'rwkv6_scan': '{48 - lost} of 48'" in line and "flash_attention" not in line
    assert ("device busy at least 10.0 ms, idle share at most 0.5" in line) == bool(lost)
    assert ("device busy 10.0 ms, idle share 0.5," in line) == (not lost)
    assert line.endswith("[H100, 700 W]") and ("dropped" in line) == bool(lost)


def test_chip_smoke_tells_the_backward_from_the_forward():
    """K1's forward and backward kernels share a prefix; each record counts
    for its own wrapper (the backward launches two kernels a call)."""
    smoke = _load_chip_smoke()
    records = [("(anonymous namespace)::flash_attention_fwd_kernel<float, 64>(Params)", 30, 9.0),
               ("(anonymous namespace)::flash_attention_bwd_dq_kernel<float, 64>(Params)", 30, 7.0),
               ("(anonymous namespace)::flash_attention_bwd_dkdv_kernel<float, 64>(Params)", 29,
                12.0)]
    t = smoke.trace_summary(records, 100.0, {"flash_attention": 30, "flash_attention_bwd": 30})
    assert t["kept"] == {"flash_attention": 30, "flash_attention_bwd": 59}
    assert t["expected"] == {"flash_attention": 30, "flash_attention_bwd": 60} and t["dropped"]


@pytest.mark.parametrize("outcomes,retried", [
    (["whole"], 0), (["empty", "whole"], 1), (["partial", "empty", "whole"], 2),
    (["empty", "empty", "empty"], "fails"), (["partial", "partial", "partial"], "unmeasured"),
    (["empty", "partial", "empty"], "unmeasured"),
])
def test_chip_smoke_profiles_an_empty_or_partial_session_again(outcomes, retried, capsys):
    """A session with no kernel record, or with fewer records of this repo's
    kernels than the launches made under it, is profiled again, up to three
    times in all, and its reading is never returned.  The run fails when all
    three come back empty; when none came back whole the measurement is
    reported as not measured."""
    smoke = _load_chip_smoke()
    smoke.PROFILER.update(sessions=0, retried=0, unmeasured=0)
    calls = {"flash_attention": 2, "rwkv6_scan": 0}
    fwd = "flash_attention_fwd_kernel<float, 64>"
    made = {"whole": [(fwd, 2, 5.0), ("gemm", 4, 1.0)], "partial": [(fwd, 1, 2.5)], "empty": []}
    it = iter(outcomes)
    attempt = lambda: (made[next(it)], 50.0, calls)
    if retried == "fails":
        with pytest.raises(AssertionError, match="3 profiler sessions came back empty"):
            smoke.profiled("K1 fp32", attempt)
        assert smoke.PROFILER == {"sessions": 3, "retried": 2, "unmeasured": 0}
        return
    got = smoke.profiled("K1 fp32", attempt)
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[profiler] K1 fp32")]
    if retried == "unmeasured":
        assert got is None
        assert smoke.PROFILER == {"sessions": 3, "retried": 2, "unmeasured": 1}
        assert lines[-1].endswith("not measured")
        return
    records, wall, got_calls = got
    assert records == made["whole"] and wall == 50.0 and got_calls == calls
    assert smoke.PROFILER == {"sessions": retried + 1, "retried": retried, "unmeasured": 0}
    assert len(lines) == retried and all("profiling it again" in x for x in lines)


def test_chip_smoke_backward_bound_counts_only_allowed_pairs():
    """The backward's bound: 10*hd flops per allowed pair; q, k, v, out, dO,
    the LSE and positions read once, dq, dk, dv written once."""
    smoke = _load_chip_smoke()
    B, S, H, K, hd = 2, 16, 3, 1, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, B, S, S, H, K, hd))
    qp, kp = (torch.from_numpy(a) for a in _positions(B, S, S))
    kp[:, 3:7] = -1
    pairs = sum(1 for i in range(S) for j in range(S) if j <= i and not 3 <= j < 7)
    ms, by, flops, nbytes, tc_ms, tc_by = smoke.attention_bwd_bound(q, k, v, qp, kp)
    assert flops == 10 * hd * H * B * pairs
    assert nbytes == 4 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel() + B * H * S) \
        + 4 * (qp.numel() + kp.numel())
    assert ms == pytest.approx(1e3 * max(flops / smoke.PEAK_FP32_FLOPS,
                                         nbytes / smoke.PEAK_HBM_BYTES))
    assert tc_ms == pytest.approx(1e3 * max(3 * flops / smoke.PEAK_TF32_FLOPS,
                                            nbytes / smoke.PEAK_HBM_BYTES))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    _, _, flops_b, _, tc_b, _ = smoke.attention_bwd_bound(qb, kb, vb, qp, kp)
    assert flops_b == flops and tc_b < tc_ms


def test_chip_smoke_reads_ptxas_registers_and_spills():
    smoke = _load_chip_smoke()
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124rwkv6_scan_states_kernelIfEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124rwkv6_scan_states_kernelIfEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125rwkv6_scan_outputs_kernelI13__nv_bfloat16EEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125rwkv6_scan_outputs_kernelI13__nv_bfloat16EEvNS_6ParamsE
    40 bytes stack frame, 52 bytes spill stores, 76 bytes spill loads
ptxas info    : Used 85 registers, used 1 barriers, 420 bytes cmem[0]
"""
    out = smoke.ptxas_kernels(log)
    assert out == {
        "_ZN12_GLOBAL__N_124rwkv6_scan_states_kernelIfEEvNS_6ParamsE":
            {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 56},
        "_ZN12_GLOBAL__N_125rwkv6_scan_outputs_kernelI13__nv_bfloat16EEvNS_6ParamsE":
            {"stack": 40, "spill_stores": 52, "spill_loads": 76, "registers": 85}}


def test_chip_smoke_counts_sass_loops():
    """Loops are closed by a branch back to an earlier address; each is
    counted with its exponentials and shared loads."""
    smoke = _load_chip_smoke()
    sass = """
        Function : _ZN12_GLOBAL__N_125rwkv6_scan_outputs_kernelIfEEvNS_6ParamsE
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0010*/                   LDS R4, [R1] ;
        /*0020*/                   MUFU.EX2 R5, R4 ;
        /*0030*/                   FFMA R6, R5, R4, R6 ;
        /*0040*/               @P1 BRA 0x10 ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   LDS.128 R8, [R1+0x10] ;
        /*0070*/              @!P0 BRA `(.L_x_3) ;
        /*0080*/                   BRA 0x0 ;
        /*0090*/                   EXIT ;
        Function : other_kernel
        /*0000*/                   EXIT ;
"""
    out = smoke.parse_sass(sass)
    k = out["_ZN12_GLOBAL__N_125rwkv6_scan_outputs_kernelIfEEvNS_6ParamsE"]
    assert k[1] == (0x10, "LDS", None) and k[4] == (0x40, "BRA", 0x10)
    assert k[6] == (0x60, "LDS.128", None) and k[7] == (0x70, "BRA", None)
    assert smoke.sass_loops(k) == ((10, 1, 2), [(4, 1, 1), (9, 1, 2)])
    assert out["other_kernel"] == [(0, "EXIT", None)]
    assert smoke.sass_loops(out["other_kernel"]) == ((1, 0, 0), [])


# -- the kernel's arithmetic, emulated on the CPU -----------------------------------
# The CUDA kernel runs both products on the tensor cores.  fp32: each operand
# x is split into big = tf32(x) and small = tf32(x - big), rounded as
# cvt.rna.tf32 rounds (to nearest, ties away from zero, to 10 mantissa bits),
# and a product is small*big + big*small + big*big accumulated in fp32.
# bf16: S = Q K^T from exact bf16 products in fp32; P (fp32) is split into
# bf16 hi + lo and O += lo V + hi V.  The online softmax runs over key tiles
# with the kernel's -inf / m_use rules.  Matrix sums are taken in another
# order than the tensor cores take them, which is rounding of fp32 sums.


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add 0x1000 to the fp32 bit pattern, clear the low 13 bits."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _split_tf32(x):
    big = _rna_tf32(x)
    return big, _rna_tf32(x - big)


def _tc_product(a, b, scheme):
    """a @ b on the tensor cores: 'split' (3xTF32), 'tf32' (one TF32
    product, no split) or 'bf16' (exact bf16 products, fp32 sums)."""
    if scheme == "split":
        (ab, as_), (bb, bs) = _split_tf32(a), _split_tf32(b)
        return as_ @ bb + ab @ bs + ab @ bb
    if scheme == "tf32":
        return _rna_tf32(a) @ _rna_tf32(b)
    return a @ b


def _emulate_kernel(q, k, v, qp, kp, causal=True, window=None, softcap=None,
                    scheme="split", block_k=32):
    """The kernel's arithmetic in fp32 on the CPU, tile by tile; inputs as
    the kernel takes them (fp32 for 'split'/'tf32', bf16 for 'bf16')."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)                                # (B,H,Sq,hd)
    kh = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)    # (B,H,Sk,hd)
    vh = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    m = torch.full((B, H, Sq, 1), -torch.inf)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, k.shape[1], block_k):
        ks, vs = kh[:, :, k0:k0 + block_k], vh[:, :, k0:k0 + block_k]
        kpt = kp[:, k0:k0 + block_k]
        s = _tc_product(qh, ks.transpose(-1, -2), scheme) * np.float32(1 / np.sqrt(hd))
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        d = qp[:, :, None] - kpt[:, None, :]
        ok = (kpt[:, None, :] >= 0) & ((d >= 0) if causal else True)
        if window is not None:
            ok = ok & (d < window)
        s = s.masked_fill(~ok[:, None], -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)          # no key seen yet
        alpha = torch.exp(m - m_use)                                  # 0 while m is -inf
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        if scheme == "bf16":
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            pv = lo @ vs + hi @ vs
        else:
            pv = _tc_product(p, vs, scheme)
        o = o * alpha + pv
        m = m_new
    out = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def test_rna_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                                   # tf32 ulp at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 3.0, 0.0], dtype=torch.float32)
    expect = [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 3.0, 0.0]
    assert _rna_tf32(x).tolist() == expect
    big, small = _split_tf32(torch.from_numpy(
        np.random.default_rng(0).standard_normal(4096).astype(np.float32)))
    assert torch.all(_rna_tf32(big) == big) and torch.all(_rna_tf32(small) == small)


def test_3xtf32_split_keeps_fp32_products():
    """One TF32 product loses about 2^-11 of each operand; the split drops
    only small*small, about 2^-22."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((64, 256), (256, 64)))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err_split = float((_tc_product(a, b, "split").double() - exact).abs().max()) / scale
    err_tf32 = float((_tc_product(a, b, "tf32").double() - exact).abs().max()) / scale
    err_fp32 = float(((a @ b).double() - exact).abs().max()) / scale
    assert err_split < 4 * err_fp32 + 2.0 ** -22
    assert err_tf32 > 100 * err_split


_EMULATION_CASES = {  # name: (B, Sq, Sk, H, K, hd), kwargs, edit
    "causal hd64 GQA": ((2, 96, 96, 4, 2, 64), {}, None),
    "window+softcap hd64": ((2, 80, 80, 2, 2, 64), {"window": 24, "softcap": 20.0}, None),
    "ring holes": ((1, 40, 96, 2, 1, 64), {}, "holes"),
    "chunked offset queries": ((2, 40, 100, 4, 2, 64), {}, "offset"),
    "causal hd256 MQA": ((1, 70, 70, 4, 1, 256), {}, None),
    "non-causal hd128": ((1, 50, 60, 2, 1, 128), {"causal": False}, None),
    # hubert-xlarge's head size (d_model 1280 over 16 heads), off the tiles
    "causal hd80": ((2, 70, 70, 4, 2, 80), {}, None),
    "bidirectional hd80": ((2, 45, 77, 4, 4, 80), {"causal": False}, None),
}


def _emulation_inputs(name, dtype):
    shape, kw, edit = _EMULATION_CASES[name]
    B, Sq, Sk, H, K, hd = shape
    arrays = _inputs(11, B, Sq, Sk, H, K, hd)
    qp, kp = _positions(B, Sq, Sk, q0=Sk - Sq - 25 if edit == "offset" else None)
    if edit == "holes":
        kp[:, 20:50] = -1
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return (q, k, v, torch.from_numpy(qp), torch.from_numpy(kp)), dict(kw)


@pytest.mark.parametrize("name", list(_EMULATION_CASES))
def test_emulated_3xtf32_kernel_meets_fp32_atol(name):
    """The fp32 kernel's scheme against both plain versions at ATOL 2e-5."""
    args, kw = _emulation_inputs(name, torch.float32)
    causal = kw.pop("causal", True)
    emu = _emulate_kernel(*args, causal=causal, **kw)
    exp = pref.flash_attention_ref(*args, causal=causal, **kw)
    jexp = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a.numpy()) for a in args),
                                               causal=causal, **kw))
    np.testing.assert_allclose(emu.numpy(), exp.numpy(), rtol=0, atol=ATOL["float32"])
    np.testing.assert_allclose(emu.numpy(), jexp, rtol=0, atol=ATOL["float32"])


@pytest.mark.parametrize("name", list(_EMULATION_CASES))
def test_emulated_bf16_kernel_meets_bf16_atol(name):
    """bf16: exact products for S, P split into bf16 hi + lo for P V."""
    args, kw = _emulation_inputs(name, torch.bfloat16)
    causal = kw.pop("causal", True)
    emu = _emulate_kernel(*args, causal=causal, scheme="bf16", **kw)
    exp = pref.flash_attention_ref(*args, causal=causal, **kw)
    torch.testing.assert_close(emu.float(), exp.float(), rtol=0, atol=ATOL["bfloat16"])


@pytest.mark.parametrize("name", ["causal hd64 GQA", "causal hd256 MQA"])
def test_single_tf32_product_misses_fp32_atol(name):
    """Why the split exists: one TF32 product per matmul is off by far more
    than the fp32 tolerance, where the 3xTF32 scheme meets it."""
    args, kw = _emulation_inputs(name, torch.float32)
    exp = pref.flash_attention_ref(*args, **kw)
    err_tf32 = float((_emulate_kernel(*args, scheme="tf32", **kw) - exp).abs().max())
    err_split = float((_emulate_kernel(*args, **kw) - exp).abs().max())
    assert err_tf32 > 10 * ATOL["float32"]
    assert err_split <= ATOL["float32"]


def test_emulated_fully_masked_row_is_zero():
    args, kw = _emulation_inputs("causal hd64 GQA", torch.float32)
    q, k, v, qp, kp = args
    qp[1, 9] = -4                                    # before every key
    out = _emulate_kernel(q, k, v, qp, kp)
    assert torch.count_nonzero(out[1, 9]) == 0
    torch.testing.assert_close(out, pref.flash_attention_ref(q, k, v, qp, kp),
                               rtol=0, atol=ATOL["float32"])


# -- the backward kernels' arithmetic, emulated on the CPU ---------------------------
# Both backward kernels run their five products on the tensor cores.  The
# dq kernel streams key tiles of one product (32 keys, 16 at fp32 hd 256):
# S = Q K^T and dP = dO V^T, then dQ += dS K, each tile's share summed apart
# and then added.  The dkdv kernel streams
# each query tile of each query head of a kv head: S^T = K Q^T and
# dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q, each share summed apart
# and then added; a tile's chunks of 32 rows have warps of their own, whose
# sums are added at the end.  fp32: every product 3xTF32.  bf16: S and dP exact bf16
# products with fp32 sums; P and dS split into bf16 hi + lo against the
# bf16 dO, Q and K.  The dkdv kernel's streamed tiles hold 64 rows of up
# to 256 bytes, 32 of up to 512 (fp32 hd 80's 320) and 16 of 1 KB
# (Cfg::BS), its products 32 rows.  The limits are the card's: normwise 1e-5
# fp32 and 1.5e-2 bf16 (BWD_TOL).

_BWD_EMULATION_CASES = {**_EMULATION_CASES, "MQA G=16 hd64": ((1, 48, 64, 16, 1, 64), {}, None)}


def _bwd_tile(hd, dtype):
    row_bytes = hd * (4 if dtype == torch.float32 else 2)
    return 64 if row_bytes <= 256 else 32 if row_bytes <= 512 else 16


def _emulate_bwd(q, k, v, qp, kp, out, lse, dout, causal=True, window=None, softcap=None,
                 scheme="split"):
    """The backward kernels' arithmetic in fp32 on the CPU, tile by tile, with
    their order of sums; scheme 'split' (3xTF32), 'tf32' (one TF32 product
    a matmul) or 'bf16' (inputs bf16).  Returns (dq, dk, dv) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, tile = H // K, _bwd_tile(hd, q.dtype)
    scale = np.float32(1 / np.sqrt(hd))
    d = qp[:, :, None] - kp[:, None, :]
    ok = (kp[:, None, :] >= 0) & ((d >= 0) if causal else torch.ones_like(d, dtype=torch.bool))
    if window is not None:
        ok = ok & (d < window)
    ok = ok[:, None]                                                   # (B,1,Sq,Sk)
    qg, dog = (a.float().permute(0, 2, 1, 3).reshape(B, K, G, Sq, hd) for a in (q, dout))
    kk, vk = (a.float().permute(0, 2, 1, 3) for a in (k, v))            # (B,K,Sk,hd)
    L = lse.reshape(B, K, G, Sq)
    D = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B, K, G, Sq)

    def prod(a, b):           # a product of two inputs
        return a @ b if scheme == "bf16" else _tc_product(a, b, scheme)

    def prod_left(pm, b):     # P or dS (fp32) times an input
        if scheme != "bf16":
            return _tc_product(pm, b, scheme)
        hi = pm.to(torch.bfloat16).float()
        return (pm - hi).to(torch.bfloat16).float() @ b + hi @ b

    def probs_grads(s, dp, allowed, lse_, D_):
        x = s * scale
        if softcap:
            th = torch.tanh(x / softcap)
            x = th * softcap
        p = torch.where(allowed, torch.exp(x - lse_), 0.0)
        ds = p * (dp - D_)
        if softcap:
            ds = ds * (1 - th * th)
        return p, ds * scale

    # the dq kernel: key tiles of one product each
    chunk = min(32, tile)
    dq = torch.zeros((B, K, G, Sq, hd))
    for k0 in range(0, Sk, chunk):
        ks, vs = (a[:, :, None, k0:k0 + chunk] for a in (kk, vk))
        s, dp = prod(qg, ks.transpose(-1, -2)), prod(dog, vs.transpose(-1, -2))
        _, ds = probs_grads(s, dp, ok[:, :, None, :, k0:k0 + chunk], L[..., None], D[..., None])
        dq = dq + prod_left(ds, ks)
    # the dkdv kernel: query tiles of each head, in the kernel's order; each
    # product (chunk) of a tile has its own warps, whose sums are added at the end
    dk, dv = (torch.zeros((tile // chunk, B, K, Sk, hd)) for _ in range(2))
    for q0 in range(0, Sq, tile):
        for g in range(G):
            for c in range(tile // chunk):
                rows = slice(q0 + c * chunk, min(q0 + (c + 1) * chunk, Sq))
                qs, dos = qg[:, :, g, rows], dog[:, :, g, rows]
                st, dpt = prod(kk, qs.transpose(-1, -2)), prod(vk, dos.transpose(-1, -2))
                pt, dst = probs_grads(st, dpt, ok[:, :, rows].transpose(-1, -2),
                                      L[:, :, g, None, rows], D[:, :, g, None, rows])
                dv[c] = dv[c] + prod_left(pt, dos)
                dk[c] = dk[c] + prod_left(dst, qs)
    dk, dv = dk.sum(0), dv.sum(0)
    dq = dq.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)
    return tuple(a.to(q.dtype) for a in (dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)))


def _bwd_emulation_case(name, dtype):
    """Inputs of one case, the plain forward's output and LSE, dO, kwargs."""
    shape, kw, edit = _BWD_EMULATION_CASES[name]
    B, Sq, Sk, H, K, hd = shape
    qp, kp = _positions(B, Sq, Sk, q0=Sk - Sq - 25 if edit == "offset" else None)
    if edit == "holes":
        kp[:, 20:50] = -1
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(11, B, Sq, Sk, H, K, hd))
    qp, kp = torch.from_numpy(qp), torch.from_numpy(kp)
    out, lse = pref.flash_attention_ref(q, k, v, qp, kp, return_lse=True, **kw)
    dout = torch.from_numpy(np.random.default_rng(12).standard_normal(q.shape).astype(
        np.float32)).to(dtype)
    return (q, k, v, qp, kp, out, lse, dout), kw


def _jax_grads(q, k, v, qp, kp, dout, **kw):
    """jax.grad of repro's flash_attention_ref against dout, on the same values."""
    jd = jnp.float32 if q.dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jd) for a in (q, k, v))
    jdo = jnp.asarray(dout.float().numpy())
    f = lambda q_, k_, v_: jnp.sum(jref.flash_attention_ref(
        q_, k_, v_, jnp.asarray(qp.numpy()), jnp.asarray(kp.numpy()), **kw).astype(jnp.float32)
        * jdo)
    return [np.array(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)]


@pytest.mark.parametrize("name", list(_BWD_EMULATION_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_backward_meets_the_card_limits(name, dtype):
    """fp32 as 3xTF32, bf16 with P and dS split: within BWD_TOL of the
    plain backward and of jax.grad of the JAX reference."""
    args, kw = _bwd_emulation_case(name, getattr(torch, dtype))
    emu = _emulate_bwd(*args, scheme="split" if dtype == "float32" else "bf16", **kw)
    q, k, v, qp, kp, out, lse, dout = args
    exp = pref.flash_attention_bwd_ref(*args, **kw)
    jexp = _jax_grads(q, k, v, qp, kp, dout, **kw)
    for g, e, je, t in zip(emu, exp, jexp, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _normwise_t(g, e) <= BWD_TOL[dtype]
        assert _normwise_t(g, torch.from_numpy(je)) <= BWD_TOL[dtype]


@pytest.mark.parametrize("name", ["causal hd64 GQA", "MQA G=16 hd64"])
def test_single_tf32_product_backward_misses_the_fp32_limit(name):
    """Why the backward splits too: one TF32 product a matmul is off by far
    more than BWD_TOL in fp32, where the 3xTF32 scheme meets it."""
    args, kw = _bwd_emulation_case(name, torch.float32)
    exp = pref.flash_attention_bwd_ref(*args, **kw)
    err_tf32 = max(_normwise_t(a, b) for a, b in zip(_emulate_bwd(*args, scheme="tf32", **kw), exp))
    err_split = max(_normwise_t(a, b) for a, b in zip(_emulate_bwd(*args, **kw), exp))
    assert err_tf32 > 10 * BWD_TOL["float32"]
    assert err_split <= BWD_TOL["float32"]


def test_emulated_backward_of_a_fully_masked_row_is_zero():
    args, kw = _bwd_emulation_case("causal hd64 GQA", torch.float32)
    q, k, v, qp, kp, _, _, dout = args
    qp[1, 9] = -4                                    # before every key
    out, lse = pref.flash_attention_ref(q, k, v, qp, kp, return_lse=True)
    dq, dk, dv = _emulate_bwd(q, k, v, qp, kp, out, lse, dout)
    assert torch.isinf(lse[1, :, 9]).all() and torch.count_nonzero(dq[1, 9]) == 0
    for g, e in zip((dq, dk, dv), pref.flash_attention_bwd_ref(q, k, v, qp, kp, out, lse, dout)):
        assert _normwise_t(g, e) <= BWD_TOL["float32"]


# -- on the card -------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,window,softcap", [
    (8, 512, 512, 9, 3, 64, None, None),     # smollm prefill
    (2, 96, 160, 4, 1, 64, None, None),      # odd lengths, MQA
    (2, 200, 200, 4, 2, 128, 48, 30.0),      # window + softcap
    (2, 130, 130, 8, 1, 256, None, None),    # gemma-2b widths, MQA
    (8, 512, 512, 16, 16, 80, None, None),   # hubert-xlarge widths (causal here)
    (2, 77, 130, 4, 2, 80, None, None),      # hd 80, ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(cuda_device, B, Sq, Sk, H, K, hd,
                                              window, softcap, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
               for a in _inputs(7, B, Sq, Sk, H, K, hd))
    qp, kp = (torch.from_numpy(a).to(cuda_device) for a in _positions(B, Sq, Sk))
    before = pops.flash_attention.launches
    out = pops.flash_attention(q, k, v, qp, kp, causal=True, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert pops.flash_attention.launches == before + 1
    exp = pref.flash_attention_ref(q, k, v, qp, kp, True, window, softcap)
    torch.testing.assert_close(out.float(), exp.float(), rtol=0, atol=ATOL[dtype])


@pytest.mark.gpu
def test_kernel_ring_holes_and_masked_row_on_card(cuda_device):
    B, Sq, Sk, H, hd = 2, 64, 192, 4, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _inputs(8, B, Sq, Sk, H, H, hd))
    qp, kp = (torch.from_numpy(a).to(cuda_device) for a in _positions(B, Sq, Sk, q0=150))
    kp[:, 70:140] = -1
    qp[1, 3] = -1
    out = pops.flash_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, pref.flash_attention_ref(q, k, v, qp, kp),
                               rtol=0, atol=ATOL["float32"])
    assert torch.count_nonzero(out[1, 3]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,q0,H,K,hd,window", [
    (77, 77, None, 4, 2, 64, None),     # lengths off the 64-row block and the key tile
    (96, 300, 150, 4, 2, 64, None),     # chunked prefill: queries at 150..245, keys past them
    (33, 200, 120, 8, 1, 256, 64),      # hd 256: one short block, window, offset
    (130, 170, None, 4, 2, 128, None),  # hd 128, ragged
    (130, 170, None, 8, 1, 256, None),  # hd 256, ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tile_edges_on_card(cuda_device, Sq, Sk, q0, H, K, hd, window, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
               for a in _inputs(9, 2, Sq, Sk, H, K, hd))
    qp, kp = (torch.from_numpy(a).to(cuda_device) for a in _positions(2, Sq, Sk, q0=q0))
    out = pops.flash_attention(q, k, v, qp, kp, causal=True, window=window)
    torch.cuda.synchronize()
    exp = pref.flash_attention_ref(q, k, v, qp, kp, True, window)
    torch.testing.assert_close(out.float(), exp.float(), rtol=0, atol=ATOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_unaligned_view_on_card(cuda_device, dtype):
    """q a view 1 element into a wider tensor: neither its pointer nor its
    strides are 16-byte multiples, so the tiles are filled by plain copies."""
    B, S, H, K, hd = 2, 100, 4, 2, 64
    wide, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
                  for a in _inputs(10, B, S, S, H, K, hd + 1))
    q, k, v = wide[..., 1:], k[..., :hd].contiguous(), v[..., :hd].contiguous()
    qp, kp = (torch.from_numpy(a).to(cuda_device) for a in _positions(B, S, S))
    out = pops.flash_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), pref.flash_attention_ref(q, k, v, qp, kp).float(),
                               rtol=0, atol=ATOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("hd", pfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_config_fits_the_card(cuda_device, dtype, hd):
    cfg = pfa.tile_config(getattr(torch, dtype), hd)
    assert cfg["block_keys"] in (16, 32, 64)
    assert 0 < cfg["smem_bytes"] <= 232448 and cfg["blocks_per_sm"] >= 1


# Backward on the card, against its plain version: normwise, max |kernel -
# plain| over max(1, max |plain|).  The two take fp32 sums in other orders
# (and the forward's 3xTF32 scores feed the kernel's LSE): on an H100 at
# most 3.0e-6 in fp32 and 3.1e-3 in bf16 (about one bf16 ulp of a
# gradient), so 1e-5 and 1.5e-2.  FlashAttentionFn against autograd of the
# plain forward adds the forward's difference: at most 2.5e-6 and 4.0e-3,
# so 2e-5 and 3.5e-2.
BWD_TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}
FN_TOL = {"float32": 2e-5, "bfloat16": 3.5e-2}


def _normwise_t(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,window,softcap,edit", [
    (8, 512, 512, 9, 3, 64, None, None, None),       # smollm train
    (2, 200, 200, 4, 2, 128, 48, 30.0, None),        # window + softcap
    (2, 130, 170, 8, 1, 256, None, None, None),      # hd 256 MQA, ragged
    (2, 77, 77, 4, 2, 64, None, None, None),         # tile edges
    (2, 64, 256, 4, 2, 64, None, None, "holes"),     # empty key slots
    (2, 128, 128, 9, 3, 64, None, None, "masked"),   # a fully masked row
    (2, 100, 100, 4, 2, 64, None, None, "unaligned"),  # q a view off 16 bytes
    (8, 512, 512, 16, 16, 80, None, None, "bidirectional"),  # hubert-xlarge train
    (2, 77, 130, 4, 2, 80, None, None, None),        # hd 80, ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_plain_version_on_card(cuda_device, B, Sq, Sk, H, K, hd, window,
                                                softcap, edit, dtype):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, td) for a in _inputs(13, B, Sq, Sk, H, K, hd))
    qp, kp = (torch.from_numpy(a).to(cuda_device) for a in _positions(B, Sq, Sk))
    if edit == "holes":
        qp += 300
        kp[:, 96:200] = -1
    if edit == "masked":
        qp[1, 7] = -1
    if edit == "unaligned":
        q = torch.nn.functional.pad(q, (1, 0))[..., 1:]
    kw = dict(causal=edit != "bidirectional", window=window, softcap=softcap)
    out, lse = pfa.flash_attention_cuda(q, k, v, qp, kp, return_lse=True, **kw)
    assert torch.equal(out, pfa.flash_attention_cuda(q, k, v, qp, kp, **kw))
    _, lse_ref = pref.flash_attention_ref(q, k, v, qp, kp, return_lse=True, **kw)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(finite, torch.isfinite(lse))
    torch.testing.assert_close(lse[finite], lse_ref[finite], rtol=0, atol=1e-4)
    dout = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(5),
                       device=cuda_device).to(td)
    before = pops.flash_attention_bwd.launches
    got = pops.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout, **kw)
    again = pops.flash_attention_bwd(q, k, v, qp, kp, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert pops.flash_attention_bwd.launches == before + 2
    exp = pref.flash_attention_bwd_ref(q, k, v, qp, kp, out, lse, dout, **kw)
    for g, g2, e in zip(got, again, exp):
        assert g.dtype == td and g.shape == e.shape and torch.equal(g, g2)   # deterministic
        assert _normwise_t(g, e) <= BWD_TOL[dtype]
    if edit == "masked":
        assert not got[0][1, 7].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fn_matches_autograd_of_plain_on_card(cuda_device, dtype):
    """ops.flash_attention on CUDA tensors that need a gradient goes through
    FlashAttentionFn: one forward and one backward launch, counted apart."""
    td = getattr(torch, dtype)
    B, S, H, K, hd = 8, 512, 9, 3, 64
    arrays = _inputs(14, B, S, S, H, K, hd)
    qp, kp = (torch.from_numpy(a).to(cuda_device) for a in _positions(B, S, S))
    dout = torch.from_numpy(np.random.default_rng(15).standard_normal((B, S, H, hd)).astype(
        np.float32)).to(cuda_device)
    q, k, v = (torch.from_numpy(a).to(cuda_device, td).requires_grad_() for a in arrays)
    before = pops.flash_attention.launches, pops.flash_attention_bwd.launches
    out = pops.flash_attention(q, k, v, qp, kp)
    assert out.grad_fn is not None
    out.backward(dout.to(td))
    torch.cuda.synchronize()
    assert (pops.flash_attention.launches, pops.flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    qr, kr, vr = (torch.from_numpy(a).to(cuda_device).requires_grad_() for a in arrays)
    pref.flash_attention_ref(qr, kr, vr, qp, kp).backward(dout)
    for a, b in ((q, qr), (k, kr), (v, vr)):
        assert _normwise_t(a.grad, b.grad) <= FN_TOL[dtype]
    with torch.no_grad():
        pops.flash_attention(q, k, v, qp, kp)    # no gradient needed: the plain forward kernel
    assert pops.flash_attention_bwd.launches == before[1] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("hd", pfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_tile_config_fits_the_card(cuda_device, dtype, hd):
    cfg = pfa.bwd_tile_config(getattr(torch, dtype), hd)
    # 16 rows a warp, hd/64 warps of four sharing them (one at hd 80)
    assert cfg["block_rows"] == 64 // (hd // 64 if hd % 64 == 0 else 1)
    for kernel in ("dq", "dkdv"):
        k = cfg[kernel]
        assert k["tile_rows"] in (16, 32, 64) and k["threads"] in (128, 256)
        assert 0 < k["smem_bytes"] <= 232448 and k["blocks_per_sm"] >= 1
    assert cfg["dq"]["blocks_per_sm"] >= 2
