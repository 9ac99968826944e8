"""The port's vmap executor and K1 under ``torch.func``, on the CPU.

``repro_torch.core.vmap_executor`` runs the two contracts of
``tests/test_system.py``'s ``VmapExecutor`` tests with torch step functions,
keeps a lane's state bit for bit through pause and restore and through PBT's
``restart_trial_with_config``, and runs the stacked step of
``launch.tune.build_vmap_executor`` against JAX's: the JAX package's
``init_fn`` draws each lane's weights, ``models/convert.py`` carries them
across, and 3 stacked steps through ``jax.vmap`` and ``torch.func.vmap`` must
agree lane by lane.  Each lane of the stacked step must equal that lane
stepped alone.  ``FlashAttentionFn`` and ``FlashAttentionBwdFn`` under
``vmap(grad)`` must equal ``vmap(grad)`` of the plain attention, their
``vmap`` rules calling each pass once at the folded shape; on the card
(``gpu``) the kernels under ``vmap`` must equal lane-by-lane calls bit for
bit.
"""
import argparse
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.tune as jtune
from repro.configs import get_config as jax_get_config

from repro_torch.configs import get_config
from repro_torch.core import (ASHAScheduler, CheckpointManager, FIFOScheduler, ObjectStore,
                              PopulationBasedTraining, Trial, TrialRunner)
from repro_torch.core.vmap_executor import VectorTrainableSpec, VmapExecutor
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.launch import tune as ptune
from repro_torch.models import convert

ARCH = "smollm-135m"
# Two layers of fp32 sums taken in another order than XLA's, carried over 3
# momentum-SGD steps: the kernel tolerance of tests/test_kernels.py.
JAX_TOL = 2e-5
# A lane stepped alone runs unbatched GEMMs where the stacked step runs
# batched ones: only the order of fp32 sums differs.
LANE_TOL = 1e-6
LANES = 3
LRS, WDS = (0.01, 0.03, 0.1), (0.0, 0.05, 0.1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the executor's contracts (tests/test_system.py's, on the port) ----------------------

def test_vmap_executor_matches_serial_semantics():
    def init_fn(seed, hypers):
        return {"x": torch.tensor(1.0)}

    def step_fn(state, hypers):
        x = state["x"] * (1.0 - hypers["lr"])
        return {"x": x}, {"loss": x}

    spec = VectorTrainableSpec(init_fn, step_fn, ("lr",))
    ex = VmapExecutor(spec, CheckpointManager(ObjectStore()), n_lanes=4)
    runner = TrialRunner(FIFOScheduler(metric="loss", mode="min"), ex,
                         stopping_criteria={"training_iteration": 5})
    lrs = [0.1, 0.2, 0.3, 0.4]
    for lr in lrs:
        runner.add_trial(Trial({"lr": lr}, stopping_criteria={"training_iteration": 5}))
    trials = runner.run()
    for t, lr in zip(trials, lrs):
        np.testing.assert_allclose(t.last_result.value("loss"), (1 - lr) ** 5, rtol=1e-5)
    assert all(t.training_iteration == 5 for t in trials)


def test_vmap_executor_with_asha_early_stops():
    def init_fn(seed, hypers):
        return {"x": torch.tensor(1.0)}

    def step_fn(state, hypers):
        x = state["x"] * 0.9
        return {"x": x}, {"loss": x + hypers["q"]}

    spec = VectorTrainableSpec(init_fn, step_fn, ("q",))
    ex = VmapExecutor(spec, CheckpointManager(ObjectStore()), n_lanes=8)
    sched = ASHAScheduler(metric="loss", mode="min", max_t=16, grace_period=2,
                          reduction_factor=2)
    runner = TrialRunner(sched, ex, stopping_criteria={"training_iteration": 16})
    for q in np.linspace(0, 2, 8):
        runner.add_trial(Trial({"q": float(q)}, stopping_criteria={"training_iteration": 16}))
    trials = runner.run()
    assert sum(t.training_iteration for t in trials) < 8 * 16, "ASHA must early-stop lanes"
    assert min(trials, key=lambda t: t.config["q"]).training_iteration == 16


# -- lane state through pause, restore and PBT's clone -------------------------------------

def _noisy_spec():
    """A state whose every element differs by seed and step, fp32 and bf16."""
    def init_fn(seed, hypers):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(5, 3, generator=g),
                "h": {"b": torch.randn(4, generator=g).to(torch.bfloat16)},
                "i": torch.zeros((), dtype=torch.int32)}

    def step_fn(state, hypers):
        w = state["w"] * (1.0 - hypers["lr"]) + torch.sin(state["w"]) * 1e-3
        b = (state["h"]["b"].float() * 0.5 + hypers["lr"]).to(torch.bfloat16)
        return ({"w": w, "h": {"b": b}, "i": state["i"] + 1},
                {"loss": w.square().sum() + b.float().sum()})

    return VectorTrainableSpec(init_fn, step_fn, ("lr",))


def _lane(ex, trial):
    return torch.utils._pytree.tree_map(lambda x: x.clone(),
                                        ex._lane_state(ex._lane_of(trial)))


def _assert_same(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_pause_and_restore_keep_a_lane_bit_for_bit():
    ex = VmapExecutor(_noisy_spec(), CheckpointManager(ObjectStore()), n_lanes=2,
                      checkpoint_freq=0)
    a, b = Trial({"lr": 0.1, "init_seed": 1}), Trial({"lr": 0.3, "init_seed": 2})
    for t in (a, b):
        assert ex.start_trial(t)
    for _ in range(3):
        ex.get_next_result()
        while ex._pending_events:
            ex.get_next_result()
    before = _lane(ex, a)
    ex.pause_trial(a)
    assert a.status.value == "PAUSED" and ex._lane_of(a) is None
    ex.get_next_result()                     # the freed lane steps on, its trial does not
    while ex._pending_events:
        ex.get_next_result()
    assert ex.start_trial(a, a.checkpoint)
    _assert_same(_lane(ex, a), before)
    assert ex._iterations[ex._lane_of(a)] == 3


def test_pbt_clone_copies_the_donors_lane_bit_for_bit():
    ex = VmapExecutor(_noisy_spec(), CheckpointManager(ObjectStore()), n_lanes=2,
                      checkpoint_freq=1)
    donor, taker = Trial({"lr": 0.05, "init_seed": 3}), Trial({"lr": 0.2, "init_seed": 4})
    for t in (donor, taker):
        assert ex.start_trial(t)
    for _ in range(2):
        ex.get_next_result()
        while ex._pending_events:
            ex.get_next_result()
    donor_state = _lane(ex, donor)
    ex.restart_trial_with_config(taker, donor.checkpoint, {"lr": 0.07, "init_seed": 4})
    _assert_same(_lane(ex, taker), donor_state)
    lane = ex._lane_of(taker)
    assert ex._hypers["lr"][lane] == 0.07 and ex._iterations[lane] == 2
    assert taker.config["lr"] == 0.07
    # the donor's snapshot is a host copy: stepping on does not move it
    ckpt = donor.checkpoint
    ex.get_next_result()
    assert donor.checkpoint is not ckpt
    _assert_same(ex._restore(ckpt)["state"], donor_state)


def test_pbt_runs_on_the_vmap_executor():
    ex = VmapExecutor(_noisy_spec(), CheckpointManager(ObjectStore()), n_lanes=4)
    pbt = PopulationBasedTraining(metric="loss", mode="min", perturbation_interval=2,
                                  hyperparam_mutations={"lr": [0.01, 0.05, 0.2]}, seed=0)
    runner = TrialRunner(pbt, ex, stopping_criteria={"training_iteration": 6})
    for i, lr in enumerate((0.01, 0.05, 0.1, 0.2)):
        runner.add_trial(Trial({"lr": lr, "init_seed": i},
                               stopping_criteria={"training_iteration": 6}))
    with mock.patch.object(ex, "restart_trial_with_config",
                           wraps=ex.restart_trial_with_config) as exploit:
        trials = runner.run()
    assert exploit.called, "PBT never exploited"
    assert [t.status.value for t in trials] == ["TERMINATED"] * 4
    assert all(t.training_iteration == 6 for t in trials)


# -- build_vmap_executor against JAX's -----------------------------------------------------

def _args(**kw):
    base = dict(batch=2, seq_len=16, steps_per_iter=1, num_samples=LANES, total_devices=16,
                device="cpu", log_dir=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.fixture(scope="module")
def specs():
    jcfg, pcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jex = jtune.build_vmap_executor(jcfg, _args())
    pex = ptune.build_vmap_executor(pcfg, _args())
    assert pex.n_lanes == jex.n_lanes == LANES
    return jex.spec, pex.spec, pcfg


def _port_params(tree, cfg):
    """A JAX parameter tree as the port's {name: tensor} (convert.py)."""
    module = ptune.TrainForward(cfg)
    sd = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, tree), module)
    return {n: torch.tensor(np.asarray(sd[n], np.float32)) for n, _ in module.named_parameters()}


def _stacked_lanes(jspec, cfg):
    """Three lanes of different weights (seeds 0-2) at different steps of the
    bank (i = 0, 3, 5), in both packages."""
    steps = (0, 3, 5)
    jstates = [dict(jspec.init_fn(s, {}), i=jnp.asarray(i, jnp.int32))
               for s, i in enumerate(steps)]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jstates)
    p = [_port_params(s["p"], cfg) for s in jstates]
    pstack = {"p": {n: torch.stack([q[n] for q in p]) for n in p[0]},
              "m": {n: torch.zeros(LANES, *t.shape) for n, t in p[0].items()},
              "i": torch.tensor(steps, dtype=torch.int32)}
    return jstack, pstack


def test_stacked_step_matches_jax(specs):
    jspec, pspec, cfg = specs
    jstack, pstack = _stacked_lanes(jspec, cfg)
    jh = {"lr": jnp.asarray(LRS, jnp.float32), "weight_decay": jnp.asarray(WDS, jnp.float32)}
    ph = {"lr": torch.tensor(LRS), "weight_decay": torch.tensor(WDS)}
    jstep, pstep = jax.jit(jax.vmap(jspec.step_fn)), torch.func.vmap(pspec.step_fn)
    for _ in range(3):
        jstack, jm = jstep(jstack, jh)
        pstack, pm = pstep(pstack, ph)
        np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]), rtol=0,
                                   atol=JAX_TOL)
    assert pstack["i"].tolist() == np.asarray(jstack["i"]).tolist() == [3, 6, 8]
    for lane in range(LANES):
        want = _port_params(jax.tree_util.tree_map(lambda x: x[lane], jstack["p"]), cfg)
        for name, w in want.items():
            got = pstack["p"][name][lane]
            err = float((got - w).abs().max())
            assert err <= JAX_TOL, f"lane {lane} {name}: {err}"


def test_each_lane_of_the_stacked_step_is_the_lane_stepped_alone(specs):
    jspec, pspec, cfg = specs
    _, pstack = _stacked_lanes(jspec, cfg)
    ph = {"lr": torch.tensor(LRS), "weight_decay": torch.tensor(WDS)}
    new, metrics = torch.func.vmap(pspec.step_fn)(pstack, ph)
    for lane in range(LANES):
        state = torch.utils._pytree.tree_map(lambda x: x[lane], pstack)
        alone, m = pspec.step_fn(state, {k: v[lane] for k, v in ph.items()})
        torch.testing.assert_close(metrics["loss"][lane], m["loss"], rtol=0, atol=LANE_TOL)
        for name, w in alone["p"].items():
            torch.testing.assert_close(new["p"][name][lane], w, rtol=0, atol=LANE_TOL)
        assert int(new["i"][lane]) == int(alone["i"])


def test_vmap_executor_spills_to_the_log_dir(tmp_path):
    ex = ptune.build_vmap_executor(get_config(ARCH).reduced(), _args(log_dir=str(tmp_path)))
    assert ex.ckpt.store.spill_dir == str(tmp_path / "vmap-spill")
    assert ptune.build_vmap_executor(get_config(ARCH).reduced(),
                                     _args()).ckpt.store.spill_dir is None


# -- K1's Functions under torch.func -------------------------------------------------------

ATTN_CASES = {  # (N, B, Sq, Sk, H, K, hd), kwargs, positions batched
    "GQA, positions unbatched": ((3, 2, 24, 40, 4, 2, 32), {}, False),
    "MQA, positions batched": ((2, 2, 16, 16, 4, 1, 32), {}, True),
    "window + softcap": ((3, 1, 32, 32, 2, 2, 64), {"window": 7, "softcap": 5.0}, False),
    "not causal, batched": ((2, 2, 12, 20, 2, 1, 32), {"causal": False}, True),
}


def _attn_inputs(name, hd=None):
    """A case's inputs; ``hd`` replaces its head size (the card's kernels
    take 64, 80, 128 and 256)."""
    (N, B, Sq, Sk, H, K, case_hd), kw, batched = ATTN_CASES[name]
    hd = hd or case_hd
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    q = torch.randn(N, B, Sq, H, hd, generator=g)
    k, v = (torch.randn(N, B, Sk, K, hd, generator=g) for _ in range(2))
    dout = torch.randn(N, B, Sq, H, hd, generator=g)
    qp = torch.arange(Sk - Sq, Sk, dtype=torch.int32)[None].expand(B, Sq)
    kp = torch.arange(Sk, dtype=torch.int32)[None].expand(B, Sk)
    if batched:   # each lane's queries and keys at their own offsets
        qp = torch.stack([qp + 2 * n for n in range(N)])
        kp = torch.stack([kp + n for n in range(N)])
    return (q, k, v, dout, qp, kp), {"causal": True, **kw}, batched


def _vmap_grads(attn, inputs, kw, batched):
    q, k, v, dout, qp, kp = inputs

    def loss(q, k, v, qp, kp, dout):
        return (attn(q, k, v, qp, kp, kw) * dout).sum()

    dims = (0, 0, 0, 0 if batched else None, 0 if batched else None, 0)
    return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)), in_dims=dims)(
        q, k, v, qp, kp, dout)


def _fn(q, k, v, qp, kp, kw):
    return pfa.FlashAttentionFn.apply(q, k, v, qp, kp, kw["causal"], kw.get("window"),
                                      kw.get("softcap"))[0]


def _plain(q, k, v, qp, kp, kw):
    return pref.flash_attention_ref(q, k, v, qp, kp, **kw)


@pytest.mark.parametrize("name", ATTN_CASES)
def test_flash_attention_functions_under_vmap_grad_match_the_plain_version(name):
    inputs, kw, batched = _attn_inputs(name)
    calls = []
    real_fwd, real_bwd = pops._flash_attention_lse, pops.flash_attention_bwd

    def fwd(*a, **k):
        calls.append(("fwd", tuple(a[0].shape)))
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls.append(("bwd", tuple(a[0].shape)))
        return real_bwd(*a, **k)

    with mock.patch.object(pops, "_flash_attention_lse", fwd), \
            mock.patch.object(pops, "flash_attention_bwd", bwd):
        got = _vmap_grads(_fn, inputs, kw, batched)
    want = _vmap_grads(_plain, inputs, kw, batched)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    q = inputs[0]
    folded = (q.shape[0] * q.shape[1], *q.shape[2:])
    assert calls == [("fwd", folded), ("bwd", folded)], "one call each, all lanes folded"


@pytest.mark.parametrize("name", ["GQA, positions unbatched", "MQA, positions batched"])
def test_flash_attention_forward_under_vmap_matches_the_plain_version(name):
    (q, k, v, _, qp, kp), kw, batched = _attn_inputs(name)
    dims = (0, 0, 0, 0 if batched else None, 0 if batched else None)
    got = torch.func.vmap(lambda *a: _fn(*a, kw), in_dims=dims)(q, k, v, qp, kp)
    want = torch.func.vmap(lambda *a: _plain(*a, kw), in_dims=dims)(q, k, v, qp, kp)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_flash_attention_bwd_function_under_vmap_matches_the_plain_backward():
    (q, k, v, dout, qp, kp), kw, _ = _attn_inputs("window + softcap")
    mask = (kw["causal"], kw["window"], kw["softcap"])

    def bwd(q, k, v, dout):
        out, lse = pfa.FlashAttentionFn.apply(q, k, v, qp, kp, *mask)
        return pfa.FlashAttentionBwdFn.apply(q, k, v, qp, kp, out, lse, dout, *mask)

    def plain(q, k, v, dout):
        out, lse = pref.flash_attention_ref(q, k, v, qp, kp, *mask, return_lse=True)
        return pref.flash_attention_bwd_ref(q, k, v, qp, kp, out, lse, dout, *mask)

    got, want = torch.func.vmap(bwd)(q, k, v, dout), torch.func.vmap(plain)(q, k, v, dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_double_backward_through_flash_attention_raises():
    (q, k, v, _, qp, kp), kw, _ = _attn_inputs("GQA, positions unbatched")
    q0 = q[0].clone().requires_grad_()
    out = _fn(q0, k[0], v[0], qp, kp, kw)
    (g,) = torch.autograd.grad(out.square().sum(), q0, create_graph=True)
    with pytest.raises(RuntimeError, match="no backward of its own"):
        g.sum().backward()


def test_the_scan_and_router_kernels_refuse_a_wrapped_tensor_off_the_cpu():
    """Without a vmap rule a wrapped tensor would reach a ctypes launch; the
    wrappers refuse it first (a meta tensor stands in for the card)."""
    x = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(NotImplementedError, match="vmap rules of the scan and router"):
        torch.func.vmap(lambda a: pops.rglru_scan(a, a))(x)
    with pytest.raises(NotImplementedError, match="moe_router has no vmap rule"):
        torch.func.vmap(lambda a: pops.moe_router(a, 2))(x)


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_kernels_under_vmap_are_the_lane_by_lane_calls_bit_for_bit(cuda_device, name, dtype):
    inputs, kw, batched = _attn_inputs(name, hd=64)
    q, k, v, dout, qp, kp = (x.to(cuda_device) for x in inputs)
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))

    def attn(q, k, v, qp, kp, kw):
        return pops.flash_attention(q, k, v, qp, kp, **kw)

    f0, b0 = pops.flash_attention.launches, pops.flash_attention_bwd.launches
    got = _vmap_grads(attn, (q, k, v, dout, qp, kp), kw, batched)
    dims = (0, 0, 0, 0 if batched else None, 0 if batched else None)
    out = torch.func.vmap(lambda *a: attn(*a, kw), in_dims=dims)(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert (pops.flash_attention.launches - f0, pops.flash_attention_bwd.launches - b0) == (2, 1)
    for n in range(q.shape[0]):
        lane = [x[n] for x in (q, k, v)]
        lp = (qp[n], kp[n]) if batched else (qp, kp)
        o, lse = pfa.flash_attention_cuda(*lane, *lp, return_lse=True, **kw)
        assert torch.equal(out[n], o)
        grads = pfa.flash_attention_bwd_cuda(*lane, *lp, o, lse, dout[n], **kw)
        for a, b in zip(got, grads):
            assert torch.equal(a[n], b)
