"""The port's training slice against the JAX package's, on the CPU.

JAX initialises the weights of ``smollm-135m.reduced()``;
``repro_torch.models.convert`` carries them into the port, and carries JAX's
gradient trees onto the port's parameter names the same way (the map is
linear, transposes are exact).  Both packages see the same numpy batches.
Held against JAX: ``cross_entropy``, ``forward_train``'s loss and every
gradient (with and without remat), a 20-step loss trajectory through
``make_train_step`` (with and without microbatches), ``adamw``, ``sgd``, the
schedules and clipping.  Then the ``ModelTrainable`` contract (save /
restore / reset_config, snapshots that do not move with the trial, bf16
through the checkpoint codec) and the ``launch.train`` command line.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.train as jtrain
from repro.configs import get_config as jax_get_config
from repro.core.checkpoint import tree_from_bytes, tree_to_bytes
from repro.data.pipeline import DataConfig, SyntheticLMDataset

from repro_torch import train as ptrain
from repro_torch.configs import get_config
from repro_torch.models import convert, cross_entropy, forward_train
from repro_torch.train.trainable import ModelTrainable, make_model_trainable

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m"

# Two layers of fp32 sums taken in another order than XLA's.  Normwise
# errors (max |port - jax| over max(1, max |jax|)) read on these cases:
# loss 3.0e-7, gradients 2.3e-7 (remat changes nothing): 2e-5, the kernel
# tolerance of tests/test_kernels.py.
TOL = 2e-5
# 20 AdamW steps at lr 3e-3 carry the first steps' rounding along; the
# largest loss difference read is 3.8e-6 (microbatches 2.4e-6), the largest
# relative grad-norm difference 4.1e-6: 1e-4.
TRAJ_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes: two intra-op threads are enough, and the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _normwise(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(1.0, np.abs(ref).max()))


def _setup(remat=False, **over):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), remat=remat, **over)
    pcfg = dataclasses.replace(get_config(ARCH).reduced(), remat=remat, **over)
    jparams = jm.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, pcfg, jparams, convert.from_jax(tree, pcfg, "cpu")


def _batch(cfg, B=4, S=32, step=0, mask=False):
    b = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S,
                                      vocab_size=cfg.vocab_size, seed=2)).batch_at(step)
    if mask:
        b["loss_mask"] = (np.random.default_rng(step).random((B, S)) < 0.7).astype(np.float32)
    return b


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- loss --------------------------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_jax(with_mask):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 17, 50)).astype(np.float32) * 3
    logits[..., 40:] = -1e30                     # padded vocab rows, as lm_logits masks them
    logits[0, 0, :2] = 9.0                       # a tie: both take the first maximum
    labels = rng.integers(0, 40, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.5).astype(np.float32) if with_mask else None
    jl, ja = jm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask))
    pl, pa = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert pl.dtype == pa.dtype == torch.float32
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    assert float(pa) == float(ja)


def test_cross_entropy_with_an_empty_mask_is_zero():
    logits, labels = torch.randn(2, 5, 8), torch.zeros(2, 5, dtype=torch.int32)
    loss, acc = cross_entropy(logits, labels, torch.zeros(2, 5))
    assert float(loss) == 0.0 and float(acc) == 0.0


# -- forward_train and its gradients ----------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_forward_train_loss_and_every_gradient_match_jax(remat, with_mask):
    jcfg, pcfg, jparams, model = _setup(remat)
    batch = _batch(jcfg, mask=with_mask)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.forward_train(p, _jax(batch), jcfg), has_aux=True)(jparams)
    loss, met = forward_train(model, _port(batch), pcfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    expect = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), model)
    assert sorted(expect) == sorted(names)
    assert _normwise(float(loss.detach()), float(jloss)) <= TOL
    assert float(met["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=1e-6)
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    errs = {n: _normwise(g.numpy(), expect[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


def test_remat_gives_the_same_gradients():
    _, pcfg, _, model = _setup(False)
    batch = _port(_batch(pcfg))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        loss, _ = forward_train(model, batch, cfg)
        out.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_chunked_attention_gradients_match_naive():
    """The chunked attention rematerialises each chunk in the backward."""
    _, pcfg, _, model = _setup(False)
    batch = _port(_batch(pcfg, S=40))
    grads = []
    for impl in ("naive", "chunked"):
        cfg = dataclasses.replace(pcfg, attn_impl=impl, attn_chunk=16)
        loss, _ = forward_train(model, batch, cfg)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -- the train step -------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [0, 2])
def test_20_step_trajectory_matches_jax(microbatch):
    jcfg, pcfg, jparams, model = _setup()
    jopt = jtrain.adamw(jtrain.linear_warmup_cosine(3e-3, 5, 20))
    popt = ptrain.adamw(ptrain.linear_warmup_cosine(3e-3, 5, 20))
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    pstate = ptrain.TrainState(model, popt.init(dict(model.named_parameters())), 0)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt, microbatch=microbatch))
    pstep = ptrain.make_train_step(pcfg, popt, microbatch=microbatch)
    jl, pl, jn, pn = [], [], [], []
    for i in range(20):
        b = _batch(jcfg, step=i)
        jstate, jm_ = jstep(jstate, _jax(b))
        pstate, pm = pstep(pstate, _port(b))
        jl.append(float(jm_["loss"]))
        pl.append(float(pm["loss"]))
        jn.append(float(jm_["grad_norm"]))
        pn.append(float(pm["grad_norm"]))
        assert float(pm["total_loss"]) == pytest.approx(float(jm_["total_loss"]), abs=TRAJ_TOL)
    assert pstate.step == 20 and pstate.opt_state["step"] == 20
    np.testing.assert_allclose(pl, jl, rtol=0, atol=TRAJ_TOL)
    np.testing.assert_allclose(pn, jn, rtol=TRAJ_TOL)
    assert pl[-1] < pl[0]


def test_eval_step_matches_forward_train():
    _, pcfg, _, model = _setup()
    batch = _port(_batch(pcfg))
    met = ptrain.make_eval_step(pcfg)(model, batch)
    loss, _ = forward_train(model, batch, pcfg)
    assert float(met["loss"]) == float(loss.detach()) and not met["loss"].requires_grad


# -- optimizers, schedules, clipping ---------------------------------------------------

def _trees(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(m.linear_warmup_cosine(1e-2, 2, 6)),
    "adamw clip 0.5, no decay": lambda m: m.adamw(0.05, weight_decay=0.0, grad_clip=0.5),
    "adamw no clip": lambda m: m.adamw(m.cosine_schedule(1e-2, 4), grad_clip=None),
    "sgd": lambda m: m.sgd(0.1),
    "sgd nesterov, decay, clip": lambda m: m.sgd(m.linear_warmup_cosine(0.1, 2, 6), nesterov=True,
                                                 weight_decay=0.01, grad_clip=1.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    jopt, popt = OPTIMIZERS[name](jtrain), OPTIMIZERS[name](ptrain)
    params = _trees(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(6):
        grads = _trees(10 + step, scale=3.0)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        out, ps = popt.update({k: torch.from_numpy(v) for k, v in grads.items()}, ps, pp)
        assert out is pp                                   # updated in place
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=2e-6, atol=1e-7)
    assert ps["step"] == int(js["step"]) == 6


def test_adamw_bf16_moments_match_jax():
    jopt = jtrain.adamw(1e-2, moment_dtype=jnp.bfloat16)
    popt = ptrain.adamw(1e-2, moment_dtype=torch.bfloat16)
    params = _trees(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(3):
        g = _trees(20 + step)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        _, ps = popt.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
    for k in params:
        assert ps["m"][k].dtype == torch.bfloat16
        np.testing.assert_allclose(ps["m"][k].float().numpy(),
                                   np.asarray(js["m"][k], np.float32), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)), ("cosine_schedule", (1e-3, 50)),
    ("cosine_schedule", (1e-3, 50, 0.0)), ("linear_warmup_cosine", (1e-3, 10, 100)),
    ("linear_warmup_cosine", (2e-3, 0, 7, 0.3)),
])
def test_schedules_match_jax(name, args):
    js, ps = getattr(jtrain, name)(*args), getattr(ptrain, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
        a = float(js(jnp.asarray(step, jnp.int32)))
        b = float(ps(torch.tensor(step, dtype=torch.int32)))
        assert b == pytest.approx(a, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _trees(3, scale=2.0)
    jt, jn = jtrain.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    pt, pn = ptrain.clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()},
                                        max_norm)
    assert float(pn) == pytest.approx(float(jn), rel=1e-6)
    assert float(ptrain.global_norm(pt)) == pytest.approx(min(max_norm, float(jn)), rel=1e-5)
    for k in tree:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]), rtol=1e-6)


def test_clip_floor_keeps_zero_gradients_finite():
    zeros = {"a": torch.zeros(3)}
    clipped, norm = ptrain.clip_by_global_norm(zeros, 1.0)
    assert float(norm) == 0.0 and bool(torch.isfinite(clipped["a"]).all())


# -- ModelTrainable ----------------------------------------------------------------------

def _trainable(**over):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **over)
    return make_model_trainable(cfg, batch=2, seq_len=16, steps_per_iter=2, device="cpu")


def _params(t):
    return {n: p.detach().clone() for n, p in t.state.params.named_parameters()}


def test_trainable_step_reports_metrics_and_a_profile_once():
    t = _trainable()({"lr": 1e-3})
    assert isinstance(t, ModelTrainable)
    r1, r2 = t.train(), t.train()
    assert {"loss", "accuracy", "grad_norm", "step", "steps_per_s"} <= set(r1)
    assert r1["step"] == 2 and r2["step"] == 4 and t.state.step == 4
    prof = r1["_profile"]
    assert prof["param_count"] == 1312000 and prof["batch"] == 2 and prof["seq_len"] == 16
    assert prof["first_step_s"] > 0 and prof["steady_step_s"] > 0 and prof["compile_s"] >= 0
    assert "_profile" not in r2


def test_save_is_a_host_copy_that_does_not_move_with_the_trial():
    """Hazard (a): parameters are updated in place, so a snapshot that shared
    them would advance with the live trial."""
    t = _trainable()({"lr": 1e-2})
    t.train()
    snap = t.save()
    before = {k: v.copy() for k, v in snap["state"]["params"].items()}
    t.train()
    for k, v in snap["state"]["params"].items():
        assert isinstance(v, np.ndarray) and np.array_equal(v, before[k])
    assert not all(np.array_equal(before[k], p.numpy()) for k, p in _params(t).items())


def test_restore_resumes_the_same_trajectory():
    t = _trainable()({"lr": 1e-2})
    t.train()
    snap = tree_from_bytes(tree_to_bytes(t.save()))   # the process executor's path
    expect = t.train()
    u = _trainable()({"lr": 1e-2, "init_seed": 5})
    u.restore(snap)
    assert u._global_step == 2 and u.state.step == 2 and u.state.opt_state["step"] == 2
    got = u.train()
    assert got["loss"] == pytest.approx(expect["loss"], abs=1e-6) and got["step"] == 4
    for (n, a), b in zip(_params(t).items(), _params(u).values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)


def test_bf16_snapshot_round_trips_through_the_checkpoint_codec():
    """Hazard (b): numpy has no bfloat16; the snapshot carries its bits."""
    t = _trainable(param_dtype="bfloat16", activation_dtype="bfloat16")({"lr": 1e-2})
    t.train()
    data = tree_to_bytes(t.save())
    u = _trainable(param_dtype="bfloat16", activation_dtype="bfloat16")({"lr": 1e-2,
                                                                         "init_seed": 9})
    u.restore(tree_from_bytes(data))
    for (n, a), b in zip(_params(t).items(), _params(u).values()):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), n
    for k in ("m", "v"):
        for n, m in t.state.opt_state[k].items():
            assert torch.equal(m, u.state.opt_state[k][n])


def test_restore_reinits_moments_of_another_optimizer():
    t = _trainable()({"lr": 1e-2, "optimizer": "sgd"})
    t.train()
    u = _trainable()({"lr": 1e-2})                  # adamw
    u.restore(t.save())
    assert set(u.state.opt_state) == {"step", "m", "v"}
    assert all(float(m.abs().max()) == 0.0 for m in u.state.opt_state["m"].values())
    for (n, a), b in zip(_params(t).items(), _params(u).values()):
        assert torch.equal(a, b), n


def test_reset_config_keeps_params_and_restarts_the_optimizer():
    t = _trainable()({"lr": 1e-2})
    t.train()
    kept = _params(t)
    assert t.reset_config({"lr": 5e-3, "optimizer": "sgd", "profile": False})
    assert t.config["lr"] == 5e-3 and set(t.state.opt_state) == {"step", "mom"}
    assert t.state.step == 2 and t.state.opt_state["step"] == 0
    for (n, a), b in zip(kept.items(), _params(t).values()):
        assert torch.equal(a, b), n
    r = t.train()
    assert "_profile" not in r and np.isfinite(r["loss"])


# -- the command line ----------------------------------------------------------------------

def test_launch_train_finishes_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq-len", "16"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[train] smollm-135m: 1,312,000 params on cpu" in out.stdout
    assert "[train] done: final loss" in out.stdout


def test_launch_train_refuses_the_card_without_one(monkeypatch):
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
