"""The port's RWKV-6 and RG-LRU scans against the JAX package's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.rwkv6_scan`` / ``rglru_scan`` run
their plain versions; they are held against the JAX Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and against
``repro.kernels.ref``, on the cases of ``TestRWKV6Scan`` and
``TestRGLRUScan``.  The CUDA kernels themselves are held against the plain
versions by the ``gpu`` tests, which skip without a card.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rglru_scan as prg
from repro_torch.kernels import rwkv6_scan as prw

# Tolerances of tests/test_kernels.py: 1e-4 for the fp32 WKV scan (chunked
# sums in another order than the sequential one), 5e-2 with bf16 r/k/v,
# 1e-5 for the RG-LRU recurrence (one multiply-add per step).
RWKV_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
RGLRU_ATOL = 1e-5


def _rwkv_inputs(seed, B, S, H, N):
    """The draws of TestRWKV6Scan._inputs, made with numpy."""
    rng = np.random.default_rng(seed)
    n = lambda shape, scale: (rng.standard_normal(shape) * scale).astype(np.float32)
    r, k, v = n((B, S, H, N), 0.5), n((B, S, H, N), 0.5), n((B, S, H, N), 0.5)
    logw = -np.exp(n((B, S, H, N), 0.5) - 2.0)
    return r, k, v, logw, n((H, N), 0.3), n((B, H, N, N), 0.2)


def _rglru_inputs(seed, B, S, R):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, R))))
    b = rng.standard_normal((B, S, R)) * 0.3
    h0 = rng.standard_normal((B, R)) * 0.2
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


def _rwkv_all(arrays, chunk, dtype="float32"):
    """(port, JAX Pallas interpret, JAX ref) as float32 numpy pairs (y, state)."""
    r, k, v, logw, u, s0 = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jr, jk, jv = (jnp.asarray(a).astype(jd) for a in (r, k, v))
    jw, ju, js = (jnp.asarray(a) for a in (logw, u, s0))
    pr, pk, pv = (torch.from_numpy(a).to(td) for a in (r, k, v))
    py, ps = pops.rwkv6_scan(pr, pk, pv, torch.from_numpy(logw), torch.from_numpy(u),
                             torch.from_numpy(s0), chunk=chunk)
    assert py.dtype == td and ps.dtype == torch.float32
    outs = [(py.float().numpy(), ps.numpy())]
    for y, s in (jops.rwkv6_scan(jr, jk, jv, jw, ju, js, chunk=chunk),
                 jref.rwkv6_scan_ref(jr, jk, jv, jw, ju, js)):
        outs.append((np.asarray(y, np.float32), np.asarray(s)))
    return outs


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 32, 1, 8, 8), (2, 50, 3, 16, 16), (2, 64, 2, 32, 32),
    (1, 100, 2, 16, 64),
])
def test_rwkv6_shape_sweep(B, S, H, N, chunk):
    port, jax_k, jax_r = _rwkv_all(_rwkv_inputs(0, B, S, H, N), chunk)
    for other in (jax_k, jax_r):
        np.testing.assert_allclose(port[0], other[0], atol=RWKV_ATOL["float32"])
        np.testing.assert_allclose(port[1], other[1], atol=RWKV_ATOL["float32"])


def test_rwkv6_bfloat16_inputs():
    port, jax_k, jax_r = _rwkv_all(_rwkv_inputs(1, 2, 32, 2, 16), 16, "bfloat16")
    for other in (jax_k, jax_r):
        np.testing.assert_allclose(port[0], other[0], atol=RWKV_ATOL["bfloat16"])
        np.testing.assert_allclose(port[1], other[1], atol=RWKV_ATOL["bfloat16"])


def test_rwkv6_state_chaining():
    """Two halves with the carried state == one run (the plain version)."""
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _rwkv_inputs(2, 1, 64, 2, 8))
    y_full, s_full = pops.rwkv6_scan(r, k, v, logw, u, s0, chunk=16)
    y1, s_mid = pops.rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], logw[:, :32], u, s0, chunk=16)
    y2, s_end = pops.rwkv6_scan(r[:, 32:], k[:, 32:], v[:, 32:], logw[:, 32:], u, s_mid,
                                chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=1e-4)


# -- K2's two-kernel split, emulated on the CPU ---------------------------------------

def _two_pass_emulation(r, k, v, logw, u, s0, chunk):
    """K2's two CUDA kernels in plain PyTorch, fp32, in chunks of min(chunk, S)
    rows.  Pass 1 (the states kernel) carries the state through the chunks
    in order and keeps the state entering each; pass 2 (the outputs kernel)
    then computes every chunk's y at once from the state entering it.  The
    rows past S in the last chunk read r = k = v = 0 and logw = 0."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    nc = -(-S // L)
    rc, kc, vc, wc = (torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, nc * L - S))
                      .reshape(B, nc, L, H, N).permute(0, 3, 1, 2, 4)      # (B,H,nc,L,N)
                      for a in (r, k, v, logw))
    cum = wc.cumsum(3)
    cum_excl = cum - wc
    last = cum[:, :, :, -1]                                                  # (B,H,nc,N)
    k_dec = kc * torch.exp(last[:, :, :, None] - cum)
    entering, state = [], s0.float()
    for c in range(nc):                                                      # pass 1
        entering.append(state)
        state = (torch.exp(last[:, :, c])[..., None] * state
                 + k_dec[:, :, c].transpose(-1, -2) @ vc[:, :, c])
    entering = torch.stack(entering, 2)                                      # (B,H,nc,N,N)
    below = torch.tril(torch.ones((L, L), dtype=torch.bool), diagonal=-1)    # pass 2
    ratio = (cum_excl[..., :, None, :] - cum[..., None, :, :]).masked_fill(
        ~below[..., None], float("-inf"))
    A = (rc[..., :, None, :] * kc[..., None, :, :] * torch.exp(ratio)).sum(-1)
    A = A + torch.diag_embed((rc * u.float()[None, :, None, None, :] * kc).sum(-1))
    y = A @ vc + (rc * torch.exp(cum_excl)) @ entering
    return y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, N)[:, :S].to(r.dtype), state


@pytest.mark.parametrize("B,S,H,N,chunk,dtype,zero_state", [
    (2, 50, 3, 16, 16, "float32", False),     # ragged last chunk
    (1, 33, 2, 16, 16, "float32", False),     # one row in the last chunk
    (2, 20, 2, 16, 32, "float32", False),     # one chunk shorter than L
    (2, 64, 2, 32, 32, "float32", False),     # chunks of 32
    (1, 96, 2, 16, 32, "float32", True),      # zero initial state, 3 chunks
    (2, 50, 2, 16, 16, "bfloat16", False),    # bf16 r/k/v, ragged
])
def test_two_pass_split_matches_jax(B, S, H, N, chunk, dtype, zero_state):
    """The chunk-state pass and the output pass, computed apart, give the JAX
    Pallas kernel's (interpret mode) and the JAX sequential reference's y
    and final state."""
    r, k, v, logw, u, s0 = _rwkv_inputs(11, B, S, H, N)
    if zero_state:
        s0 = np.zeros_like(s0)
    td = getattr(torch, dtype)
    y, s = _two_pass_emulation(*(torch.from_numpy(a).to(td) for a in (r, k, v)),
                               *(torch.from_numpy(a) for a in (logw, u, s0)), chunk)
    assert y.dtype == td and s.dtype == torch.float32
    jr, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (r, k, v))
    jw, ju, js = (jnp.asarray(a) for a in (logw, u, s0))
    for y_j, s_j in (jops.rwkv6_scan(jr, jk, jv, jw, ju, js, chunk=chunk),
                     jref.rwkv6_scan_ref(jr, jk, jv, jw, ju, js)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j, np.float32),
                                   atol=RWKV_ATOL[dtype])
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=RWKV_ATOL[dtype])


@pytest.mark.parametrize("B,S,R", [(1, 32, 16), (3, 77, 40), (2, 128, 64)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_shape_sweep(B, S, R, with_h0):
    a, b, h0 = _rglru_inputs(3, B, S, R)
    h0 = h0 if with_h0 else None
    port = pops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           None if h0 is None else torch.from_numpy(h0))
    assert port.dtype == torch.float32 and tuple(port.shape) == (B, S, R)
    jh0 = None if h0 is None else jnp.asarray(h0)
    for other in (jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, chunk_t=32, block_r=16),
                  jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)):
        np.testing.assert_allclose(port.numpy(), np.asarray(other), atol=RGLRU_ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_rglru_odd_sizes(seed):
    """The fuzz of tests/test_kernels.py, on fixed draws."""
    B, S, R = (int(x) for x in np.random.default_rng(seed).integers((1, 5, 4), (4, 61, 25)))
    a, b, _ = _rglru_inputs(seed, B, S, R)
    port = pops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(port.numpy(), np.asarray(jref.rglru_scan_ref(
        jnp.asarray(a), jnp.asarray(b))), atol=RGLRU_ATOL)


# -- dispatch ------------------------------------------------------------------------

def test_cpu_dispatches_to_plain_versions_without_counting():
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _rwkv_inputs(4, 1, 20, 2, 16))
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(4, 2, 20, 8))
    before = (pops.rwkv6_scan.launches, pops.rglru_scan.launches)
    y, s = pops.rwkv6_scan(r, k, v, logw, u, s0)
    h = pops.rglru_scan(a, b, h0)
    assert (pops.rwkv6_scan.launches, pops.rglru_scan.launches) == before
    y_ref, s_ref = pref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0)
    torch.testing.assert_close(h, pref.rglru_scan_ref(a, b, h0), rtol=0, atol=0)


def test_non_cpu_tensors_never_run_the_plain_versions():
    """A tensor off the CPU goes to the kernel, which refuses what is not on
    the card: here meta tensors, as no card is needed to show it."""
    m = lambda *shape: torch.empty(shape, device="meta")
    before = (pops.rwkv6_scan.launches, pops.rglru_scan.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.rwkv6_scan(m(1, 8, 2, 64), m(1, 8, 2, 64), m(1, 8, 2, 64), m(1, 8, 2, 64),
                        m(2, 64), m(1, 2, 64, 64))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pops.rglru_scan(m(1, 8, 16), m(1, 8, 16))
    assert (pops.rwkv6_scan.launches, pops.rglru_scan.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _rwkv_inputs(5, 1, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        prw.rwkv6_scan_cuda(r, k, v, logw, u, s0)
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(5, 1, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        prg.rglru_scan_cuda(a, b, h0)


# -- the bounds chip_smoke.py reports ----------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("S,chunk", [(64, 32), (50, 32), (20, 32)])
def test_chip_smoke_rwkv6_bound(S, chunk):
    """Bytes: each input read once, y and the state written once.  Operations:
    the chunked algorithm's, counted chunk by chunk over the rows it holds."""
    smoke = _smoke()
    B, H, N = 2, 3, 16
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(6, B, S, H, N)]
    ms, by, flops, nbytes = smoke.rwkv6_bound(*ts, chunk=chunk)
    L = min(chunk, S)
    per_chunk = 0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n - 1) // 2
        per_chunk += (2 * n * N                       # running sums
                      + 5 * N * pairs + 3 * N * n     # A below and on the diagonal
                      + 5 * n * N                     # r and k rescaled
                      + 2 * N * (pairs + n)           # A @ V
                      + 2 * n * N * N + n * N         # + (r e^c) @ S
                      + 2 * n * N * N + 2 * N * N + N)  # state update
    assert flops == B * H * per_chunk
    r = ts[0]
    assert nbytes == 4 * (5 * r.numel() + H * N + 2 * B * H * N * N)
    assert ms == pytest.approx(1e3 * max(flops / smoke.PEAK_FP32_FLOPS,
                                         nbytes / smoke.PEAK_HBM_BYTES))
    assert by == ("operations" if flops / smoke.PEAK_FP32_FLOPS >= nbytes / smoke.PEAK_HBM_BYTES
                  else "bytes")


@pytest.mark.parametrize("S,chunk", [(512, 32), (50, 32), (20, 32)])
def test_chip_smoke_rwkv6_design_floor(S, chunk):
    """K2's design floor: the states kernel reads k, v, logw and the initial
    state and writes the workspace and the final state; the outputs kernel
    reads r, k, v, logw, u, the initial state and the workspace, writes y."""
    smoke = _smoke()
    B, H, N = 1, 2, 16
    ts = [torch.from_numpy(a) for a in _rwkv_inputs(6, B, S, H, N)]
    ms, nbytes = smoke.rwkv6_design_floor(*ts, chunk=chunk)
    x, st, ws = 4 * B * S * H * N, 4 * B * H * N * N, 4 * B * H * N * N * (-(-S // chunk) - 1)
    assert nbytes == (3 * x + st + ws + st) + (4 * x + 4 * H * N + st + ws + x)
    assert ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


def test_k2_kernel_names_match_the_trace_filter():
    """chip_smoke finds K2's kernels by the prefix ``rwkv6_scan_`` and counts
    two launches a call: one kernel of each of ``PASSES`` in the source."""
    src = (Path(prw.__file__).parent / "csrc" / "rwkv6_scan.cu").read_text()
    for name in prw.PASSES:
        assert f"rwkv6_scan_{name}_kernel" in src
    assert _smoke().KERNELS_PER_CALL["rwkv6_scan"] == len(prw.PASSES) == 2


@pytest.mark.parametrize("with_h0", [True, False])
def test_chip_smoke_rglru_bound(with_h0):
    smoke = _smoke()
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(7, 2, 30, 24))
    ms, by, flops, nbytes = smoke.rglru_bound(a, b, h0 if with_h0 else None)
    assert flops == 2 * a.numel()
    assert nbytes == 4 * (3 * a.numel() + (h0.numel() if with_h0 else 0))
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / smoke.PEAK_HBM_BYTES)


# -- on the card -------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,N,chunk", [
    (8, 512, 32, 64, 32),     # rwkv6-1.6b prefill
    (2, 50, 3, 64, 32),       # ragged last chunk
    (2, 20, 2, 64, 32),       # one chunk shorter than L
    (1, 33, 4, 64, 16),       # one row in the last chunk
    (1, 2051, 2, 64, 32),     # B*H = 2: the chunks are all the parallelism
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_kernel_matches_plain_version_on_card(cuda_device, B, S, H, N, chunk, dtype):
    r, k, v, logw, u, s0 = (torch.from_numpy(a).to(cuda_device)
                            for a in _rwkv_inputs(8, B, S, H, N))
    r, k, v = (t.to(getattr(torch, dtype)) for t in (r, k, v))
    before = pops.rwkv6_scan.launches
    y, s = pops.rwkv6_scan(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert pops.rwkv6_scan.launches == before + 1
    y_ref, s_ref = pref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    assert y.dtype == r.dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=0, atol=RWKV_ATOL[dtype])
    torch.testing.assert_close(s, s_ref, rtol=0, atol=RWKV_ATOL[dtype])


@pytest.mark.gpu
def test_rwkv6_kernel_state_chaining_on_card(cuda_device):
    r, k, v, logw, u, s0 = (torch.from_numpy(a).to(cuda_device)
                            for a in _rwkv_inputs(9, 2, 96, 4, 64))
    y_full, s_full = pops.rwkv6_scan(r, k, v, logw, u, s0)
    y1, s_mid = pops.rwkv6_scan(r[:, :40], k[:, :40], v[:, :40], logw[:, :40], u, s0)
    y2, s_end = pops.rwkv6_scan(r[:, 40:], k[:, 40:], v[:, 40:], logw[:, 40:], u, s_mid)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,R", [(8, 512, 4096), (3, 77, 40), (2, 5, 300)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_kernel_matches_plain_version_on_card(cuda_device, B, S, R, with_h0):
    a, b, h0 = (torch.from_numpy(x).to(cuda_device) for x in _rglru_inputs(10, B, S, R))
    h0 = h0 if with_h0 else None
    before = pops.rglru_scan.launches
    h = pops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert pops.rglru_scan.launches == before + 1
    torch.testing.assert_close(h, pref.rglru_scan_ref(a, b, h0), rtol=0, atol=RGLRU_ATOL)
