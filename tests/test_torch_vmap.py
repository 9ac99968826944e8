"""The port's vmap executor and the kernels under ``torch.func``, on the CPU.

``repro_torch.core.vmap_executor`` runs the two contracts of
``tests/test_system.py``'s ``VmapExecutor`` tests with torch step functions,
keeps a lane's state bit for bit through pause and restore and through PBT's
``restart_trial_with_config``, and runs the stacked step of
``launch.tune.build_vmap_executor`` against JAX's for every token family
(smollm-135m, rwkv6-1.6b, recurrentgemma-9b, granite-moe-3b-a800m, and
smollm-135m, recurrentgemma-9b and granite-moe-3b-a800m with remat, which JAX
runs under ``jax.checkpoint`` and the port a repeat at a time through
``loss_and_grads``' chain of stages): the JAX package's ``init_fn`` draws each lane's weights,
``models/convert.py`` carries them across, and 3 stacked steps through
``jax.vmap`` and ``torch.func.vmap`` must agree lane by lane.  Each lane of
the stacked step must equal that lane stepped alone; with remat the port's
stacked step must equal itself without, each repeat run twice a step, and
the lanes' backward must run with grad mode off (no graph of the backward).  Each kernel's
Function and its backward's (``FlashAttentionFn``/``FlashAttentionBwdFn``,
``RWKV6ScanFn``/``RWKV6ScanBwdFn``, ``RGLRUScanFn``/``RGLRUScanBwdFn``,
``MoERouterFn``/``MoERouterBwdFn``) under ``vmap(grad)`` must equal
``vmap(grad)`` of the plain version, their ``vmap`` rules calling each pass
once at the folded shape; K2's lanes keep their own ``u`` and ``du``, and
its workspace of chunk states reaches the backward in its forward's folded
layout.  The MoE dispatch's one-hots are comparisons that ``vmap`` takes.
On the card (``gpu``) the kernels under ``vmap`` must equal lane-by-lane
calls bit for bit.
"""
import argparse
import dataclasses
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
from repro_torch.kernels import moe_router as prouter
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import rglru_scan as prg
from repro_torch.kernels import rwkv6_scan as prw
from repro_torch.launch import tune as ptune
from repro_torch.models import convert
from repro_torch.models import moe as pmoe

ARCH = "smollm-135m"
# The stacked step's configs: id -> (arch, remat).  With remat JAX's lanes
# run ``jax.checkpoint`` on each repeat, and the port's ``loss_and_grads``
# runs each repeat again for its gradients; granite's carries the MoE aux
# loss through the chain of stages.
VMAP_ARCHS = {"smollm-135m": (ARCH, False), "smollm-135m remat": (ARCH, True),
              "rwkv6-1.6b": ("rwkv6-1.6b", False),
              "recurrentgemma-9b": ("recurrentgemma-9b", False),
              "recurrentgemma-9b remat": ("recurrentgemma-9b", True),
              "granite-moe-3b-a800m": ("granite-moe-3b-a800m", False),
              "granite-moe-3b-a800m remat": ("granite-moe-3b-a800m", True)}
TOKEN_FAMILIES = (ARCH, "rwkv6-1.6b", "recurrentgemma-9b", "granite-moe-3b-a800m")
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


@pytest.fixture(scope="module", params=list(VMAP_ARCHS))
def specs(request):
    arch, remat = VMAP_ARCHS[request.param]
    jcfg, pcfg = (dataclasses.replace(get(arch).reduced(), remat=remat)
                  for get in (jax_get_config, get_config))
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


# -- the lanes' gradients: remat a repeat at a time, no graph of the backward ----------------

def _stacked_port_lanes(spec):
    """Three lanes of the port's own ``init_fn`` (seeds 0-2) at steps 0, 3, 5."""
    lanes = [spec.init_fn(seed, {}) for seed in range(LANES)]
    state = {part: {k: torch.stack([s[part][k] for s in lanes]) for k in lanes[0][part]}
             for part in ("p", "m")}
    state["i"] = torch.tensor((0, 3, 5), dtype=torch.int32)
    return state


@pytest.mark.parametrize("arch", TOKEN_FAMILIES)
def test_the_stacked_step_with_remat_is_the_step_without(arch):
    """The same weights and batches through ``loss_and_grads`` with and
    without remat: equal within LANE_TOL; each repeat runs twice a step
    with remat (its forward without autograd, again under ``vjp``) and
    once without."""
    from repro_torch.models import segment_specs
    from repro_torch.models import transformer as ptransformer

    base = get_config(arch).reduced()
    n_repeats = sum(n for _, n in segment_specs(base))
    ph = {"lr": torch.tensor(LRS), "weight_decay": torch.tensor(WDS)}
    out = {}
    for remat in (False, True):
        spec = ptune.build_vmap_executor(dataclasses.replace(base, remat=remat), _args()).spec
        state = _stacked_port_lanes(spec)
        with mock.patch.object(ptransformer, "_apply_repeat",
                               wraps=ptransformer._apply_repeat) as repeat:
            out[remat] = torch.func.vmap(spec.step_fn)(state, ph)
        assert repeat.call_count == (2 if remat else 1) * n_repeats, (remat, repeat.call_count)
    (plain, plain_m), (remat, remat_m) = out[False], out[True]
    torch.testing.assert_close(remat_m["loss"], plain_m["loss"], rtol=0, atol=LANE_TOL)
    assert list(remat["p"]) == list(plain["p"])
    for part in ("p", "m"):
        for name, w in plain[part].items():
            torch.testing.assert_close(remat[part][name], w, rtol=0, atol=LANE_TOL)


class _GradModeProbe(torch.autograd.Function):
    """The identity, recording ``torch.is_grad_enabled()`` in its backward."""
    seen = []
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        _GradModeProbe.seen.append(torch.is_grad_enabled())
        return g


class _ProbeModule(torch.nn.Module):
    """A module ``loss_and_grads`` takes: one weight, one probed op."""

    def __init__(self):
        super().__init__()
        self.cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=False)
        self.w = torch.nn.Parameter(torch.ones(3))

    def forward(self, batch):
        loss = (_GradModeProbe.apply(self.w * batch["x"]) ** 2).sum()
        return loss, {"loss": loss}


def test_the_lanes_backward_runs_without_a_graph():
    """``torch.func.grad`` runs its backward with ``create_graph=True``
    (grad mode on, a graph of the backward kept until the last gradient);
    ``loss_and_grads`` must pull back without one, with and without remat."""
    module, x = _ProbeModule(), torch.tensor([1.0, 2.0, 3.0])
    _GradModeProbe.seen.clear()
    grads, (loss, _) = ptune.loss_and_grads(module, {"w": torch.ones(3)}, {"x": x})
    assert _GradModeProbe.seen == [False]
    torch.testing.assert_close(grads["w"], 2 * x * x, rtol=0, atol=0)
    assert float(loss) == 14.0

    from repro_torch.models import transformer as ptransformer
    real = ptransformer._apply_repeat

    def probed(blocks, cfg, types, x, *rest):
        return real(blocks, cfg, types, _GradModeProbe.apply(x), *rest)

    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=True)
    spec = ptune.build_vmap_executor(cfg, _args()).spec
    state = _stacked_port_lanes(spec)
    _GradModeProbe.seen.clear()
    with mock.patch.object(ptransformer, "_apply_repeat", probed):
        torch.func.vmap(spec.step_fn)(state, {"lr": torch.tensor(LRS),
                                              "weight_decay": torch.tensor(WDS)})
    assert _GradModeProbe.seen == [False] * cfg.n_layers


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


# -- K2's, K3's and K4's Functions under torch.func -----------------------------------------

RWKV_CASES = {  # (N, B, S, H, chunk), state one a lane, u one a lane, final state used
    "own state and u, final state used": ((3, 2, 12, 2, 4), True, True, True),
    "one state for every lane, y only": ((2, 1, 9, 3, 4), False, True, False),
    "one u for every lane": ((3, 2, 8, 2, 8), True, False, True),
}
RGLRU_CASES = {  # (N, B, S, R), h0: None, "lane" (one a lane) or "shared" (one for every lane)
    "h0 None": ((3, 2, 10, 16), None),
    "h0 one a lane": ((2, 3, 7, 8), "lane"),
    "h0 for every lane": ((3, 1, 9, 16), "shared"),
}
ROUTER_CASES = {  # (N, *rows, E), top_k
    "(G, S, E) rows": ((3, 2, 8, 6), 2),
    "(T, E) rows": ((2, 12, 5), 3),
}
HEAD = 64   # the card's K2 takes this head size only


def _rwkv_inputs(name, device="cpu", dtype=torch.float32):
    """A case's r, k, v, logw, u, state, dy, ds (ds None when the final
    state is not used) and the in_dims of (r, k, v, logw, u, state)."""
    (N, B, S, H, _), own_state, own_u, final = RWKV_CASES[name]
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    n = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale
    r, k, v = (n(N, B, S, H, HEAD, scale=0.5) for _ in range(3))
    logw = -torch.exp(n(N, B, S, H, HEAD, scale=0.5) - 2.0)
    u = n(N, H, HEAD, scale=0.3) if own_u else n(H, HEAD, scale=0.3)
    state = n(N, B, H, HEAD, HEAD, scale=0.2) if own_state else n(B, H, HEAD, HEAD, scale=0.2)
    dy, ds = n(N, B, S, H, HEAD), (n(N, B, H, HEAD, HEAD) if final else None)
    xs = [x if x is None else x.to(device) for x in (r, k, v, logw, u, state, dy, ds)]
    xs[:3] = [x.to(dtype) for x in xs[:3]]
    return xs, (0, 0, 0, 0, 0 if own_u else None, 0 if own_state else None)


def _rwkv_grads(scan, name, xs, dims):
    """vmap(grad) of sum(y * dy) (+ sum(final state * ds)) with respect to
    r, k, v, logw, u and the state."""
    chunk = RWKV_CASES[name][0][4]

    def loss(r, k, v, logw, u, st, dy, ds):
        y, s_out = scan(r, k, v, logw, u, st, chunk)
        out = (y.float() * dy.float()).sum()
        return out if ds is None else out + (s_out * ds).sum()

    return torch.func.vmap(torch.func.grad(loss, argnums=tuple(range(6))),
                           in_dims=(*dims, 0, None if xs[7] is None else 0))(*xs)


def _rwkv_fn(r, k, v, logw, u, st, chunk):
    return prw.RWKV6ScanFn.apply(r, k, v, logw, u, st, chunk)[:2]


def _rwkv_plain(r, k, v, logw, u, st, chunk):
    return pref.rwkv6_scan_ref(r, k, v, logw, u, st)


def _recorded(*names):
    """A mock of each plain version in ``names`` (``ref``'s) that records
    the shape of its first argument; returns (the patches, the calls)."""
    calls = []

    def spy(name):
        real = getattr(pref, name)

        def call(*a, **kw):
            calls.append((name, tuple(a[0].shape)))
            return real(*a, **kw)
        return mock.patch.object(pref, name, call)

    return [spy(n) for n in names], calls


@pytest.mark.parametrize("name", RWKV_CASES)
def test_rwkv6_functions_under_vmap_grad_match_the_plain_version(name):
    """Each pass called once, the lanes folded into the heads: (B, S, N*H,
    head); the gradients those of vmap(grad) of the plain scan."""
    xs, dims = _rwkv_inputs(name)
    patches, calls = _recorded("rwkv6_scan_ref", "rwkv6_scan_bwd_ref")
    with patches[0], patches[1]:
        got = _rwkv_grads(_rwkv_fn, name, xs, dims)
    want = _rwkv_grads(_rwkv_plain, name, xs, dims)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    N, B, S, H, _ = RWKV_CASES[name][0]
    folded = (B, S, N * H, HEAD)
    # the plain backward is autograd of the plain forward, which it runs again inside
    assert calls == [("rwkv6_scan_ref", folded), ("rwkv6_scan_bwd_ref", folded),
                     ("rwkv6_scan_ref", folded)]


def test_each_lane_of_rwkv6_keeps_its_own_u_and_du():
    """u is one per head for every batch row and du sums over the batch:
    folded into the heads, every lane's du is the one it takes alone, and
    the lanes' du differ (folded into the batch they would all be lane 0's
    u, and one sum)."""
    name = "own state and u, final state used"
    xs, dims = _rwkv_inputs(name)
    du = _rwkv_grads(_rwkv_fn, name, xs, dims)[4]
    chunk = RWKV_CASES[name][0][4]
    for lane in range(du.shape[0]):
        r, k, v, logw, u, st, dy, ds = (x[lane] for x in xs)

        def loss(u):
            y, s_out = _rwkv_fn(r, k, v, logw, u, st, chunk)
            return (y * dy).sum() + (s_out * ds).sum()

        torch.testing.assert_close(du[lane], torch.func.grad(loss)(u), rtol=0, atol=1e-5)
        if lane:
            assert float((du[lane] - du[0]).abs().max()) > 1e-2, "the lanes share one du"


def _chunk_states(r, k, v, logw, u, state, chunk):
    """The state entering each chunk after the first, (B, H, nc - 1, N, N),
    as the card's forward keeps it: the plain scan run to each chunk's
    start."""
    S = r.shape[1]
    L = min(chunk, S)
    states = [pref.rwkv6_scan_ref(r[:, :c], k[:, :c], v[:, :c], logw[:, :c], u, state)[1]
              for c in range(L, S, L)]
    return torch.stack(states, dim=2)


def test_the_rwkv6_workspace_reaches_the_backward_in_its_forwards_layout():
    """On the card ``RWKV6ScanFn`` keeps its folded call's workspace of
    chunk states (B, N*H, nc-1, head, head), hands it out with the lanes
    split from the heads, and the backward's rule folds it back.  With
    stand-ins for the card's forward (the plain scan, and the chunk states
    made from the folded inputs) and backward (which makes them again from
    its own folded inputs), the backward gets for every folded head the
    states its forward made, once, and the gradients are the plain
    version's."""
    name = "own state and u, final state used"
    xs, dims = _rwkv_inputs(name)
    seen = []

    def forward(r, k, v, logw, u, state, chunk):
        return (*pref.rwkv6_scan_ref(r, k, v, logw, u, state),
                _chunk_states(r, k, v, logw, u, state, chunk))

    def backward(r, k, v, logw, u, state, states, dy, ds_out=None, chunk=32):
        assert torch.equal(states, _chunk_states(r, k, v, logw, u, state, chunk))
        seen.append(tuple(states.shape))
        return pref.rwkv6_scan_bwd_ref(r, k, v, logw, u, state, dy, ds_out)

    with mock.patch.object(pops, "_rwkv6_scan", forward), \
            mock.patch.object(pops, "rwkv6_scan_bwd", backward):
        got = _rwkv_grads(_rwkv_fn, name, xs, dims)
    want = _rwkv_grads(_rwkv_plain, name, xs, dims)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    N, B, S, H, chunk = RWKV_CASES[name][0]
    assert seen == [(B, N * H, -(-S // chunk) - 1, HEAD, HEAD)]


def _rglru_inputs(name, device="cpu"):
    """A case's a, b, h0 (or None), dh and the in_dims of (a, b, h0)."""
    (N, B, S, R), h0_kind = RGLRU_CASES[name]
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    a = torch.sigmoid(torch.randn(N, B, S, R, generator=g))
    b, dh = (torch.randn(N, B, S, R, generator=g) for _ in range(2))
    h0 = {None: None, "lane": torch.randn(N, B, R, generator=g),
          "shared": torch.randn(B, R, generator=g)}[h0_kind]
    xs = [x if x is None else x.to(device) for x in (a, b, h0, dh)]
    return xs, (0, 0, 0 if h0_kind == "lane" else None)


def _rglru_grads(scan, xs, dims):
    """vmap(grad) of sum(h * dh) with respect to a, b and h0 (if any)."""
    argnums = (0, 1) if xs[2] is None else (0, 1, 2)
    return torch.func.vmap(torch.func.grad(lambda a, b, h0, dh: (scan(a, b, h0) * dh).sum(),
                                           argnums=argnums), in_dims=(*dims, 0))(*xs)


@pytest.mark.parametrize("name", RGLRU_CASES)
def test_rglru_functions_under_vmap_grad_match_the_plain_version(name):
    """Each pass called once, the lanes folded into the batch (an h0 for
    every lane expanded, None kept None); the gradients those of vmap(grad)
    of the plain scan."""
    xs, dims = _rglru_inputs(name)
    patches, calls = _recorded("rglru_scan_ref", "rglru_scan_bwd_ref")
    with patches[0], patches[1]:
        got = _rglru_grads(prg.RGLRUScanFn.apply, xs, dims)
    want = _rglru_grads(pref.rglru_scan_ref, xs, dims)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    N, B, S, R = RGLRU_CASES[name][0]
    assert calls == [("rglru_scan_ref", (N * B, S, R)), ("rglru_scan_bwd_ref", (N * B, S, R))]


def _router_inputs(name, device="cpu", dtype=torch.float32):
    (N, *rows, E), top_k = ROUTER_CASES[name]
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    logits = torch.randn(N, *rows, E, generator=g) * 2.0
    dw = torch.randn(N, *rows, top_k, generator=g)
    return logits.to(device, dtype), dw.to(device), top_k


def _router_grads(route, logits, dw):
    return torch.func.vmap(torch.func.grad(lambda x, d: (route(x)[0] * d).sum()))(logits, dw)


@pytest.mark.parametrize("name", ROUTER_CASES)
def test_moe_router_functions_under_vmap_grad_match_the_plain_version(name):
    """Each pass called once, the lanes first as one more row axis; the
    weights, experts and dlogits those of the plain router under vmap."""
    logits, dw, top_k = _router_inputs(name)
    patches, calls = _recorded("moe_router_ref", "moe_router_bwd_ref")
    with patches[0], patches[1]:
        got = _router_grads(lambda x: prouter.MoERouterFn.apply(x, top_k), logits, dw)
    assert calls == [("moe_router_ref", tuple(logits.shape)),
                     ("moe_router_bwd_ref", tuple(logits.shape))]
    want = _router_grads(lambda x: pref.moe_router_ref(x, top_k), logits, dw)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    w, idx, stats = torch.func.vmap(lambda x: prouter.MoERouterFn.apply(x, top_k),
                                    out_dims=(0, 0, None))(logits)
    pw, pidx = torch.func.vmap(lambda x: pref.moe_router_ref(x, top_k))(logits)
    assert stats is None and torch.equal(idx, pidx)
    torch.testing.assert_close(w, pw, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["rwkv6_scan", "rglru_scan", "moe_router"])
def test_double_backward_through_the_scans_and_router_raises(name):
    if name == "rwkv6_scan":
        xs, _ = _rwkv_inputs("own state and u, final state used")
        x = xs[0][0].clone().requires_grad_()
        out = _rwkv_fn(x, *(t[0] for t in xs[1:6]), 4)[0]
    elif name == "rglru_scan":
        (a, b, _, _), _ = _rglru_inputs("h0 None")
        x = a[0].clone().requires_grad_()
        out = prg.RGLRUScanFn.apply(x, b[0], None)
    else:
        logits, _, top_k = _router_inputs("(G, S, E) rows")
        x = logits[0].clone().requires_grad_()
        out = prouter.MoERouterFn.apply(x, top_k)[0]
    (g,) = torch.autograd.grad(out.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="no backward of its own"):
        g.sum().backward()


# -- the MoE dispatch under vmap -------------------------------------------------------------

def _one_hot_dispatch(top_w, top_idx, moe, S):
    """``moe._dispatch_tensors`` as it was built on ``F.one_hot`` (which
    reads its indices' maximum with ``.item()``, refused under vmap)."""
    E, C = moe.n_experts, pmoe._capacity(S, moe)
    onehot = torch.nn.functional.one_hot(top_idx.long(), E).float()
    flat = onehot.reshape(onehot.shape[0], -1, E)
    pos = (torch.cumsum(flat.transpose(1, 2), dim=-1).transpose(1, 2) - flat).reshape(onehot.shape)
    in_cap = (pos < C).float() * onehot
    slot = (pos.long()[..., None] == torch.arange(C)).float()
    disp_k = in_cap[..., None] * slot
    return disp_k.sum(2), (disp_k * top_w[..., None, None]).sum(2)


def test_moe_dispatch_is_the_one_hot_versions_and_runs_under_vmap():
    """The dispatch and combine tensors equal the ``F.one_hot`` version's on
    the same experts (tokens past capacity dropped), and under ``vmap`` each
    lane's are its own call's."""
    # 8 experts, top 2, capacity 2 of 16 tokens: most choices past capacity
    moe = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced().moe, n_experts=8,
                              top_k=2, capacity_factor=0.5)
    N, G, S = 3, 2, 16
    g = torch.Generator().manual_seed(5)
    lanes = [pref.moe_router_ref(torch.randn(G, S, moe.n_experts, generator=g) * 2.0,
                                 moe.top_k) for _ in range(N)]
    top_w, top_idx = (torch.stack(xs) for xs in zip(*lanes))
    for n in range(N):
        got = pmoe._dispatch_tensors(top_w[n], top_idx[n], moe, S)
        for a, b in zip(got, _one_hot_dispatch(top_w[n], top_idx[n], moe, S)):
            assert torch.equal(a, b)
        assert 0 < float(got[0].sum()) < G * S * moe.top_k, "no choice kept, or none dropped"
    vmapped = torch.func.vmap(lambda w, i: pmoe._dispatch_tensors(w, i, moe, S))(top_w, top_idx)
    for n in range(N):
        for a, b in zip(vmapped, pmoe._dispatch_tensors(top_w[n], top_idx[n], moe, S)):
            assert torch.equal(a[n], b)


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


def _lane_inputs(xs, dims, n):
    """Lane ``n``'s inputs of a case: a shared (unbatched) input as it is."""
    return [x if x is None or d is None else x[n] for x, d in zip(xs, dims)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(RWKV_CASES))
def test_rwkv6_under_vmap_is_the_lane_by_lane_calls_bit_for_bit(cuda_device, name, dtype):
    xs, dims = _rwkv_inputs(name, cuda_device, dtype)
    chunk = RWKV_CASES[name][0][4]
    f0, b0 = pops.rwkv6_scan.launches, pops.rwkv6_scan_bwd.launches
    got = _rwkv_grads(pops.rwkv6_scan, name, xs, dims)
    y, s_out = torch.func.vmap(lambda *a: pops.rwkv6_scan(*a, chunk), in_dims=dims)(*xs[:6])
    torch.cuda.synchronize()
    assert (pops.rwkv6_scan.launches - f0, pops.rwkv6_scan_bwd.launches - b0) == (2, 1)
    for n in range(xs[0].shape[0]):
        r, k, v, logw, u, st = _lane_inputs(xs[:6], dims, n)
        y1, s1, ws = prw.rwkv6_scan_cuda(r, k, v, logw, u, st, chunk=chunk, return_states=True)
        assert torch.equal(y[n], y1) and torch.equal(s_out[n], s1)
        ds = None if xs[7] is None else xs[7][n]
        lane = prw.rwkv6_scan_bwd_cuda(r, k, v, logw, u, st, ws, xs[6][n], ds, chunk=chunk)
        for a, b in zip(got, lane):
            assert torch.equal(a[n], b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(RGLRU_CASES))
def test_rglru_under_vmap_is_the_lane_by_lane_calls_bit_for_bit(cuda_device, name):
    xs, dims = _rglru_inputs(name, cuda_device)
    f0, b0 = pops.rglru_scan.launches, pops.rglru_scan_bwd.launches
    got = _rglru_grads(pops.rglru_scan, xs, dims)
    h = torch.func.vmap(pops.rglru_scan, in_dims=dims)(*xs[:3])
    torch.cuda.synchronize()
    assert (pops.rglru_scan.launches - f0, pops.rglru_scan_bwd.launches - b0) == (2, 1)
    for n in range(xs[0].shape[0]):
        a, b, h0 = _lane_inputs(xs[:3], dims, n)
        h1 = prg.rglru_scan_cuda(a, b, h0)
        assert torch.equal(h[n], h1)
        for x, y in zip(got, prg.rglru_scan_bwd_cuda(a, h0, h1, xs[3][n])):
            assert torch.equal(x[n], y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ROUTER_CASES))
def test_moe_router_under_vmap_is_the_lane_by_lane_calls_bit_for_bit(cuda_device, name, dtype):
    logits, dw, top_k = _router_inputs(name, cuda_device, dtype)
    f0, b0 = pops.moe_router.launches, pops.moe_router_bwd.launches
    got = _router_grads(lambda x: pops.moe_router(x, top_k), logits, dw)
    w, idx = torch.func.vmap(lambda x: pops.moe_router(x, top_k))(logits)
    torch.cuda.synchronize()
    assert (pops.moe_router.launches - f0, pops.moe_router_bwd.launches - b0) == (2, 1)
    for n in range(logits.shape[0]):
        w1, idx1, stats = prouter.moe_router_cuda(logits[n], top_k, return_stats=True)
        assert torch.equal(w[n], w1) and torch.equal(idx[n], idx1)
        assert torch.equal(got[n], prouter.moe_router_bwd_cuda(logits[n], w1, idx1, dw[n], stats))
