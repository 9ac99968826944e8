"""The port's flash attention against the JAX package's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs its plain
version; it is held against the JAX Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and against ``repro.kernels.ref``, on the
cases of ``TestFlashAttention``.  The CUDA kernel itself is held against the
plain version by the ``gpu`` tests, which skip without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

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


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 8, 8, 1, 1, 64))
    qp, kp = (torch.from_numpy(a) for a in _positions(1, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pfa.flash_attention_cuda(q, k, v, qp, kp)


@pytest.mark.parametrize("window,holes", [(None, False), (4, False), (None, True)])
def test_chip_smoke_bound_counts_only_allowed_pairs(window, holes):
    """The bound that chip_smoke.py reports counts 4*hd flops per (query, key)
    pair the mask allows and each input read once, the output written once."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B, S, H, K, hd = 2, 16, 3, 1, 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, B, S, S, H, K, hd))
    qp, kp = (torch.from_numpy(a) for a in _positions(B, S, S))
    if holes:
        kp[:, 3:7] = -1
    pairs = sum(1 for i in range(S) for j in range(S)
                if j <= i and (window is None or i - j < window) and not (holes and 3 <= j < 7))
    ms, by, flops, nbytes = smoke.attention_bound(q, k, v, qp, kp, window=window)
    assert flops == 4 * hd * H * B * pairs
    assert nbytes == 4 * (2 * q.numel() + k.numel() + v.numel() + qp.numel() + kp.numel())
    assert ms == pytest.approx(1e3 * max(flops / smoke.PEAK_FP32_FLOPS,
                                         nbytes / smoke.PEAK_HBM_BYTES))
    assert by == ("operations" if flops / smoke.PEAK_FP32_FLOPS >= nbytes / smoke.PEAK_HBM_BYTES
                  else "bytes")


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
