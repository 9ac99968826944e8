"""The port's serving path against the JAX package, on the CPU.

JAX initialises the weights; ``repro_torch.models.convert`` carries them into
the port; both prefill the same numpy prompts and decode greedily.  Four
reduced dense configs cover GQA (smollm), MQA + GeGLU + embedding scale
(gemma), q/k/v bias (qwen) and the sliding-window ring cache with a prompt
longer than the window (h2o-danube).  Two more cover the SSM family (rwkv6,
chunks of 16 so that the 24-token prompt ends in a ragged chunk) and the
hybrid (RG-LRU blocks and local attention over a ring cache shorter than the
prompt).  Two cover the MoE family: granite (16 experts, top 8) and deepseek
(8 experts, top 6, two shared experts), reduced so that top-k makes a choice
and capacity drops tokens.
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
from repro.configs import get_config as jax_get_config
from repro.train.serve_step import generate as jax_generate

from repro_torch.configs import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.data import synthetic_batch
from repro_torch.models import convert, decode_step, forward_train, init_params, prefill
from repro_torch.models.transformer import leaves
from repro_torch.train.serve_step import generate

ROOT = Path(__file__).resolve().parents[1]

# Two layers' worth of fp32 sums taken in another order than XLA's.  The
# largest cache or state error read over these cases is 3.7e-5, on rwkv6's
# WKV state (|wkv| up to 31); k/v and the other leaves stay under 7.2e-6.
TOL = 1e-4

CASES = {
    "smollm-135m": {},
    "gemma-2b": {},
    "qwen1.5-110b": {},
    "h2o-danube-1.8b": {"sliding_window": 16},
    "rwkv6-1.6b": {"rwkv_chunk": 16},
    "recurrentgemma-9b": {"sliding_window": 16},
    "granite-moe-3b-a800m": {},
    "deepseek-moe-16b": {},
}
REDUCED = {"granite-moe-3b-a800m": {"n_experts": 16}, "deepseek-moe-16b": {"n_experts": 8}}
MOE = list(REDUCED)
PROMPT_LEN, NEW = 24, 8


def _configs(arch):
    red = REDUCED.get(arch, {})
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(**red), **CASES[arch])
    pcfg = dataclasses.replace(get_config(arch).reduced(**red), **CASES[arch])
    return jcfg, pcfg


def _setup(arch):
    jcfg, pcfg = _configs(arch)
    jparams = jm.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, PROMPT_LEN), np.int32)
    return jcfg, pcfg, jparams, convert.from_jax(tree, pcfg, "cpu"), prompts


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("arch", list(CASES))
def test_prefill_and_decode_match_jax(arch, impl):
    """Prefill logits, every cache and state leaf, and two decode steps'
    logits.  ``pallas`` also sets ``kernel_impl``: the port then runs its
    kernel entries (flash attention, the RWKV-6 and RG-LRU scans, the MoE
    router), which are the plain versions on the CPU; ``auto`` runs the
    plain attention and ``kernel_impl="jnp"``."""
    jcfg, pcfg, jparams, model, prompts = _setup(arch)
    pcfg = dataclasses.replace(pcfg, attn_impl=impl,
                               kernel_impl="pallas" if impl == "pallas" else "jnp")
    max_len = PROMPT_LEN + NEW
    jlogits, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(prompts)}, jcfg, max_len)
    plogits, pcaches = prefill(model, {"tokens": torch.from_numpy(prompts)}, pcfg, max_len)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=TOL)

    def check_caches():
        assert len(pcaches) == len(jcaches)
        for pseg, jseg in zip(pcaches, jcaches):
            for pst, jst in zip(pseg, jseg):
                pleaves, jleaves = list(leaves(pst)), list(leaves(jst))
                assert [p for p, _ in pleaves] == [p for p, _ in jleaves]
                assert [p for p, _ in pleaves] in (
                    [("k",), ("kpos",), ("v",)], [("conv",), ("h",)],
                    [("cm", "prev"), ("tm", "prev"), ("tm", "wkv")])
                for (path, p), (_, j) in zip(pleaves, jleaves):
                    if path == ("kpos",):
                        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
                    else:
                        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=TOL,
                                                   err_msg="/".join(path))
    check_caches()
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for i in range(2):
        pos = PROMPT_LEN + i
        jlogits, jcaches = jm.decode_step(jparams, jcaches, jnp.asarray(tok),
                                          jnp.asarray(pos, jnp.int32), jcfg)
        plogits, pcaches = decode_step(model, pcaches, torch.from_numpy(tok), pos, pcfg)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=TOL)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    check_caches()


def test_the_calls_config_picks_the_attention_path(monkeypatch):
    """Weights built under one config run whichever attention the config of
    the call names: the kernel entry once per layer for a pallas prefill, and
    never for a naive prefill or for decode (one query)."""
    from repro_torch.kernels import ops as pops
    calls = []
    real = pops.flash_attention
    monkeypatch.setattr(pops, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pcfg = _configs("smollm-135m")
    model = init_params(torch.Generator().manual_seed(0),
                        dataclasses.replace(pcfg, attn_impl="pallas"), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    for impl, expect in (("naive", 0), ("pallas", pcfg.n_layers)):
        calls.clear()
        _, caches = prefill(model, {"tokens": tokens}, dataclasses.replace(pcfg, attn_impl=impl), 9)
        assert len(calls) == expect, impl
    calls.clear()
    decode_step(model, caches, tokens[:, 0], 8, dataclasses.replace(pcfg, attn_impl="pallas"))
    assert calls == []


@pytest.mark.parametrize("arch,scan,kinds", [
    ("rwkv6-1.6b", "rwkv6_scan", {"rwkv6"}), ("recurrentgemma-9b", "rglru_scan", {"rglru"})])
def test_the_calls_config_picks_the_scan_path(monkeypatch, arch, scan, kinds):
    """The ``kernel_impl`` counterpart: the scan entry runs once per rwkv6 or
    rglru layer in a pallas prefill, and never in a jnp prefill or in decode
    (one token, the single step)."""
    from repro_torch.kernels import ops as pops
    calls = []
    real = getattr(pops, scan)
    monkeypatch.setattr(pops, scan, lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pcfg = _configs(arch)
    n_layers = sum(t in kinds for t in pcfg.pattern_for_layers())
    assert n_layers >= 2
    model = init_params(torch.Generator().manual_seed(0),
                        dataclasses.replace(pcfg, kernel_impl="pallas"), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    for impl, expect in (("jnp", 0), ("pallas", n_layers)):
        calls.clear()
        _, caches = prefill(model, {"tokens": tokens},
                            dataclasses.replace(pcfg, kernel_impl=impl), 9)
        assert len(calls) == expect, impl
    calls.clear()
    decode_step(model, caches, tokens[:, 0], 8, dataclasses.replace(pcfg, kernel_impl="pallas"))
    assert calls == []


@pytest.mark.parametrize("arch", MOE)
def test_the_calls_config_picks_the_router_path(monkeypatch, arch):
    """The router entry runs once per MoE layer in a pallas prefill and in
    every pallas decode step (routing has no single-token variant), and
    never under ``kernel_impl="jnp"``."""
    from repro_torch.kernels import ops as pops
    calls = []
    real = pops.moe_router
    monkeypatch.setattr(pops, "moe_router", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pcfg = _configs(arch)
    model = init_params(torch.Generator().manual_seed(0), pcfg, "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    for impl in ("jnp", "pallas"):
        cfg = dataclasses.replace(pcfg, kernel_impl=impl)
        calls.clear()
        _, caches = prefill(model, {"tokens": tokens}, cfg, 10)
        decode_step(model, caches, tokens[:, 0], 8, cfg)
        assert len(calls) == (2 * pcfg.n_layers if impl == "pallas" else 0), impl


@pytest.mark.parametrize("arch", list(CASES))
def test_greedy_generate_tokens_identical(arch):
    jcfg, pcfg, jparams, model, prompts = _setup(arch)
    jtok = jax_generate(jparams, jcfg, jnp.asarray(prompts), NEW)
    ptok = generate(model, pcfg, torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b", *MOE])
def test_greedy_generate_tokens_identical_through_kernel_entries(arch):
    """As above, with ``kernel_impl`` and ``attn_impl`` set to ``pallas``: the
    port's prefill goes through its kernel entries (the plain versions on the
    CPU), JAX's through its Pallas kernels in interpret mode."""
    jcfg, pcfg, jparams, model, prompts = _setup(arch)
    jcfg, pcfg = (dataclasses.replace(c, attn_impl="pallas", kernel_impl="pallas")
                  for c in (jcfg, pcfg))
    jtok = jax_generate(jparams, jcfg, jnp.asarray(prompts), NEW)
    ptok = generate(model, pcfg, torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))


def test_convert_raises_on_missing_or_extra_leaf():
    jcfg, pcfg = _configs("qwen1.5-110b")
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(0), jcfg))
    convert.from_jax(tree, pcfg, "cpu")   # the full tree loads
    missing = jax.tree_util.tree_map(lambda x: x, tree)
    del missing["stack"][0]["blocks"][0]["attn"]["bq"]
    with pytest.raises(KeyError, match="wq.bias"):
        convert.from_jax(missing, pcfg, "cpu")
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["final_norm"]["bias"] = np.zeros_like(extra["final_norm"]["scale"])
    with pytest.raises(KeyError, match="final_norm.bias"):
        convert.from_jax(extra, pcfg, "cpu")
    wrong = jax.tree_util.tree_map(lambda x: x, tree)
    wrong["embed"]["tok"] = wrong["embed"]["tok"][:, :8]
    with pytest.raises(ValueError, match="embed.tok"):
        convert.from_jax(wrong, pcfg, "cpu")


@pytest.mark.parametrize("arch", list(CASES))
def test_own_init_matches_jax_paths_shapes_and_scales(arch):
    """The port's own init: same leaves and shapes as JAX's tree (through
    convert's naming), each leaf's std within 10%, constants equal."""
    jcfg, pcfg = _configs(arch)
    pmodel = init_params(torch.Generator().manual_seed(0), pcfg, "cpu")
    jstate = convert.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(0), jcfg)), pmodel)
    pstate = pmodel.state_dict()
    assert sorted(pstate) == sorted(jstate)
    for name, t in pstate.items():
        p, j = t.float().numpy(), np.asarray(jstate[name], np.float32)
        assert p.shape == j.shape, name
        if j.std() == 0:
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            assert abs(p.std() / j.std() - 1) < 0.1, (name, p.std(), j.std())


def test_serve_cli_runs_on_cpu(capsys):
    res = port_serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "16", "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["smollm-135m:", "prefill", "decode", "sample"]
    assert all(ln.startswith("[serve] ") for ln in lines)
    assert tuple(res.tokens.shape) == (2, 4) and len(res.step_logits) == 3


def test_serve_cli_matches_jax_param_count(capsys):
    port_serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                     "--batch", "1", "--prompt-len", "8", "--new-tokens", "2"])
    first = capsys.readouterr().out.splitlines()[0]
    jcfg = jax_get_config("gemma-2b").reduced()
    n = jm.param_count(jm.init_params(jax.random.key(0), jcfg))
    assert first == f"[serve] gemma-2b: {n:,} params"


@pytest.mark.parametrize("arch", ["hubert-xlarge", "paligemma-3b"])
def test_frontend_families_initialise_and_run(arch):
    """The audio and vision frontends: the port's own init carries the
    projection, and a forward over frames, or an image prefix and text,
    gives a finite loss."""
    cfg = get_config(arch).reduced()
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tuple(model.frontend.proj.weight.shape) == (cfg.d_model, cfg.frontend_dim)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, 2, 16).items()}
    loss, _ = forward_train(model, batch, cfg)
    assert bool(torch.isfinite(loss))


def test_serve_cli_refuses_encoder_only_hubert():
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only: no decode"):
        port_serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])


def _serve_cli_on_cpu(capsys, arch):
    """The CLI at reduced size through the kernel entries (plain versions on
    the CPU): its four lines, and finite logits of the expected shapes."""
    res = port_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "20", "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == [f"{arch}:", "prefill", "decode", "sample"]
    assert res.cfg.kernel_impl == res.cfg.attn_impl == "pallas"
    assert tuple(res.tokens.shape) == (2, 4) and len(res.step_logits) == 3
    assert all(bool(torch.isfinite(x).all()) for x in [res.prefill_logits, *res.step_logits])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_serve_cli_runs_recurrent_families_on_cpu(capsys, arch):
    _serve_cli_on_cpu(capsys, arch)


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_runs_moe_family_on_cpu(capsys, arch):
    _serve_cli_on_cpu(capsys, arch)


def test_serve_draws_weights_with_a_generator_on_its_device(monkeypatch):
    """The weights are drawn by a generator on the serving device (on the
    card, not on the host), so the CPU run draws on the CPU."""
    devices = []
    real = port_serve.init_params
    monkeypatch.setattr(port_serve, "init_params",
                        lambda gen, cfg, dev: devices.append(gen.device) or real(gen, cfg, dev))
    port_serve.serve(get_config("smollm-135m").reduced(), 1, 8, 2, device="cpu")
    assert devices == [torch.device("cpu")]


def test_cuda_without_card_raises():
    """No path quietly runs on the CPU when the card was asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--arch", "smollm-135m", "--reduced", "--batch", "1",
                         "--prompt-len", "8", "--new-tokens", "2"])
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), cfg)
    jcfg = jax_get_config("smollm-135m").reduced()
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(0), jcfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax(tree, cfg)


def test_serve_cli_as_module_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-135m",
         "--reduced", "--device", "cpu", "--batch", "1", "--prompt-len", "8",
         "--new-tokens", "3"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("[serve] ") == 4
