"""The port's modality frontends against the JAX package's, on the CPU.

hubert-xlarge (``audio_stub``: conv-feature frames through a projection,
encoder-only, bidirectional attention at head size 80 in full) and
paligemma-3b (``vision_stub``: patch embeddings through a projector,
prepended to the text) at reduced size.  JAX initialises the weights;
``repro_torch.models.convert`` carries them, the frontend's projection
included, into the port and JAX's gradient trees onto the port's names.
Both packages see the same numpy inputs.  Held against JAX: the input
embedding, ``forward_train`` (loss, accuracy and every first-step gradient,
under the plain attention and the kernel entries), ``forward_encode``,
paligemma's ``prefill`` and decode after its image prefix, the launchers'
batches; then the launchers' command lines, and K1's plain version at
hubert's head size against the JAX Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JSyntheticLMDataset
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.model import _embed_inputs as jax_embed_inputs

from repro_torch.configs import get_config
from repro_torch.kernels import ops as pops
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import (convert, decode_step, forward_encode, forward_train,
                                init_params, prefill)
from repro_torch.models.model import _embed_inputs
from repro_torch.models.transformer import leaves

FRONTENDS = ["hubert-xlarge", "paligemma-3b"]
# Two layers of fp32 sums taken in another order than XLA's, as in
# tests/test_torch_train.py: normwise errors (max |port - jax| over
# max(1, max |jax|)) read on these cases at most 4.0e-7 (gradients:
# paligemma's embedding), 8.5e-7 (paligemma's prefill and decode logits and
# caches) and 1.3e-6 (smollm's forward_encode logits); the input embedding
# is exact.  2e-5, the kernel tolerance of tests/test_kernels.py.
TOL = 2e-5
B, S = 2, 24          # for paligemma S counts the image prefix (8 patches reduced)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _normwise(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(1.0, np.abs(ref).max()))


def _setup(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    pcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jparams = jm.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, pcfg, jparams, tree, convert.from_jax(tree, pcfg, "cpu")


def _batch(cfg, seed=3):
    return jax_synthetic_batch(cfg, B, S, seed=seed)


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- weights -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_convert_carries_the_frontend_projection(arch):
    """JAX's (frontend_dim, d_model) projection lands transposed in the
    port's ``nn.Linear``, exactly; every other leaf is consumed too."""
    _, pcfg, _, tree, model = _setup(arch)
    w = model.frontend.proj.weight
    assert tuple(w.shape) == (pcfg.d_model, pcfg.frontend_dim)
    np.testing.assert_array_equal(w.detach().numpy(), tree["frontend"]["proj"].T)
    assert "frontend.proj.weight" in dict(model.named_parameters())


@pytest.mark.parametrize("arch", FRONTENDS)
def test_own_init_draws_the_frontend_as_jax_does(arch):
    """The port's own init: JAX's leaves and shapes (through convert's
    naming), the projection's std 1/sqrt(frontend_dim) within 10%."""
    jcfg, pcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    model = init_params(torch.Generator().manual_seed(0), pcfg, "cpu")
    jstate = convert.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(0), jcfg)), model)
    pstate = model.state_dict()
    assert sorted(pstate) == sorted(jstate)
    assert all(tuple(pstate[n].shape) == np.shape(jstate[n]) for n in pstate)
    std = float(pstate["frontend.proj.weight"].std())
    assert abs(std * np.sqrt(pcfg.frontend_dim) - 1) < 0.1


def test_a_config_without_a_frontend_has_none():
    model = init_params(torch.Generator().manual_seed(0), get_config("smollm-135m").reduced(),
                        "cpu")
    assert model.frontend is None
    assert not any(n.startswith("frontend") for n, _ in model.named_parameters())


# -- the input embedding and the training forward ------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS + ["gemma-2b"])
def test_embed_inputs_matches_jax(arch):
    """Projected frames, projected patches before the (scaled) token
    embeddings, or the token embeddings alone."""
    jcfg, pcfg, jparams, _, model = _setup(arch)
    batch = _batch(jcfg)
    got = _embed_inputs(model, _port(batch), pcfg)
    exp = np.asarray(jax_embed_inputs(jparams, _jax(batch), jcfg))
    assert tuple(got.shape) == exp.shape == (B, S, pcfg.d_model)
    assert _normwise(got.detach().numpy(), exp) <= TOL


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_train_loss_accuracy_and_every_gradient_match_jax(arch, impl):
    """``pallas`` runs the port's kernel entry for attention (its plain
    version on the CPU: bidirectional at head size 80 for hubert);
    paligemma's loss covers only the text after its image prefix."""
    jcfg, pcfg, jparams, _, model = _setup(arch)
    pcfg = dataclasses.replace(pcfg, attn_impl=impl)
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.forward_train(p, _jax(batch), jcfg), has_aux=True)(jparams)
    loss, met = forward_train(model, _port(batch), pcfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    expect = convert.to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), model)
    assert sorted(expect) == sorted(names)
    assert _normwise(float(loss.detach()), float(jloss)) <= TOL
    assert float(met["accuracy"]) == pytest.approx(float(jmet["accuracy"]), abs=1e-6)
    errs = {n: _normwise(g.numpy(), expect[n]) for n, g in zip(names, grads)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])
    assert float(np.abs(expect["frontend.proj.weight"]).max()) > 0


def test_vlm_loss_covers_only_the_text():
    """Labels as long as the text, not the prefix; a label under the image
    prefix could not be scored."""
    jcfg, pcfg, _, _, model = _setup("paligemma-3b")
    batch = _batch(jcfg)
    assert batch["labels"].shape == (B, S - pcfg.n_prefix_embeds)
    loss, _ = forward_train(model, _port(batch), pcfg)
    assert torch.isfinite(loss)
    wrong = dict(batch, labels=np.zeros((B, S), np.int32))
    with pytest.raises(RuntimeError):
        forward_train(model, _port(wrong), pcfg)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "smollm-135m"])
def test_forward_encode_matches_jax(arch):
    """The whole-sequence forward's full logits: hubert's encoder, and a
    dense decoder (causal), as tests/test_models.py uses it."""
    jcfg, pcfg, jparams, _, model = _setup(arch)
    batch = _batch(jcfg)
    if arch == "smollm-135m":
        batch = {"tokens": batch["tokens"]}
    with torch.no_grad():
        got = forward_encode(model, _port(batch), dataclasses.replace(pcfg, attn_impl="pallas"))
    exp = np.asarray(jm.forward_encode(jparams, _jax(batch), jcfg))
    assert tuple(got.shape) == exp.shape == (B, S, pcfg.vocab_size)
    assert _normwise(got.numpy(), exp) <= TOL


def test_hubert_attends_both_ways():
    """Encoder-only: a frame's logits move when a later frame changes."""
    _, pcfg, _, _, model = _setup("hubert-xlarge")
    feats = torch.from_numpy(_batch(pcfg)["features"])
    with torch.no_grad():
        a = forward_encode(model, {"features": feats}, pcfg)
        later = feats.clone()
        later[:, -1] += 1.0
        b = forward_encode(model, {"features": later}, pcfg)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


# -- serving with an image prefix --------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_paligemma_prefill_and_decode_match_jax(impl):
    """Prefill over (patches, tokens), its logits and every cache leaf,
    then two decode steps at positions that count the prefix."""
    jcfg, pcfg, jparams, _, model = _setup("paligemma-3b")
    pcfg = dataclasses.replace(pcfg, attn_impl=impl)
    P, T, new = jcfg.n_prefix_embeds, 12, 4
    rng = np.random.default_rng(5)
    batch = {"patch_embeds": rng.standard_normal((B, P, jcfg.frontend_dim)).astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)}
    max_len = P + T + new
    jlogits, jcaches = jm.prefill(jparams, _jax(batch), jcfg, max_len)
    plogits, pcaches = prefill(model, _port(batch), pcfg, max_len)

    def check():
        assert _normwise(plogits.numpy(), np.asarray(jlogits)) <= TOL
        for pseg, jseg in zip(pcaches, jcaches):
            for pst, jst in zip(pseg, jseg):
                pl, jl = list(leaves(pst)), list(leaves(jst))
                assert [p for p, _ in pl] == [p for p, _ in jl] == [("k",), ("kpos",), ("v",)]
                for (path, p), (_, j) in zip(pl, jl):
                    if path == ("kpos",):
                        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
                    else:
                        assert _normwise(p.numpy(), np.asarray(j)) <= TOL, path
    check()
    assert int(pcaches[0][0]["kpos"][0].max()) == P + T - 1
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for i in range(2):
        pos = P + T + i
        jlogits, jcaches = jm.decode_step(jparams, jcaches, jnp.asarray(tok),
                                          jnp.asarray(pos, jnp.int32), jcfg)
        plogits, pcaches = decode_step(model, pcaches, torch.from_numpy(tok), pos, pcfg)
        check()
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)


# -- the launchers -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS + ["smollm-135m"])
def test_train_batches_are_jax_launchers(arch):
    """``launch.train`` draws each step's batch as JAX's does: frames or an
    image prefix and text from ``synthetic_batch`` seeded with the step, or
    the synthetic LM stream."""
    jcfg, pcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    source = port_train.batch_source(pcfg, B, S)
    for i in (0, 3):
        if jcfg.frontend is None:
            exp = JSyntheticLMDataset(JDataConfig(global_batch=B, seq_len=S,
                                                  vocab_size=jcfg.vocab_size)).batch_at(i)
        else:
            exp = jax_synthetic_batch(jcfg, B, S, seed=i)
        got = source(i)
        assert sorted(got) == sorted(exp)
        for k in exp:
            assert got[k].dtype == exp[k].dtype
            np.testing.assert_array_equal(got[k], exp[k])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_cli_runs_frontends_on_cpu(capsys, arch):
    res = port_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq-len", "32", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"[train] {arch}: " in out and "[train] done" in out
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert res.state.step == 3
    assert float(res.state.params.frontend.proj.weight.detach().abs().max()) > 0


def test_serve_cli_serves_paligemma_after_its_image_prefix(capsys):
    res = port_serve.main(["--arch", "paligemma-3b", "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "12", "--new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["paligemma-3b:", "prefill", "decode", "sample"]
    P = res.cfg.n_prefix_embeds
    assert lines[1].startswith(f"[serve] prefill 2x({P}+12):")
    assert res.prefix == P and tuple(res.inputs["patch_embeds"].shape) == (2, P, 64)
    # the prefix is synthetic_batch's, seed 1
    exp = jax_synthetic_batch(jax_get_config("paligemma-3b").reduced(), 2, P + 12, seed=1)
    np.testing.assert_array_equal(res.inputs["patch_embeds"].numpy(), exp["patch_embeds"])
    assert tuple(res.tokens.shape) == (2, 4) and len(res.step_logits) == 3
    assert all(bool(torch.isfinite(x).all()) for x in [res.prefill_logits, *res.step_logits])
    # the caches hold the prefix, the text and the three decoded tokens
    assert int(res.caches[0][0]["kpos"][0].max()) == P + 12 + 2



# -- K1 at hubert's head size ------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_version_at_head_size_80_matches_jax(causal):
    """The port's plain version at hd 80 (hubert-xlarge: d_model 1280 over
    16 heads) against the JAX Pallas kernel in interpret mode and JAX's
    reference, with ragged lengths off the 64-row blocks."""
    rng = np.random.default_rng(17)
    Bq, Sq, Sk, H, K, hd = 2, 70, 100, 4, 2, 80
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((Bq, Sq, H, hd), (Bq, Sk, K, hd), (Bq, Sk, K, hd))]
    qp = np.broadcast_to(np.arange(Sk - Sq, Sk, dtype=np.int32)[None], (Bq, Sq)).copy()
    kp = np.broadcast_to(np.arange(Sk, dtype=np.int32)[None], (Bq, Sk)).copy()
    port = pops.flash_attention(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(qp),
                                torch.from_numpy(kp), causal=causal)
    jargs = [jnp.asarray(a) for a in (*arrays, qp, kp)]
    jax_k = np.asarray(jops.flash_attention(*jargs, causal=causal, block_q=64, block_k=64))
    jax_r = np.asarray(jref.flash_attention_ref(*jargs, causal=causal))
    assert tuple(port.shape) == (Bq, Sq, H, hd)
    np.testing.assert_allclose(port.numpy(), jax_r, rtol=0, atol=TOL)
    np.testing.assert_allclose(port.numpy(), jax_k, rtol=0, atol=TOL)
