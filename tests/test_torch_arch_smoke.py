"""Per-architecture smoke tests of the port, the analogue of
tests/test_arch_smoke.py: every assigned arch's config matches the JAX
package's, and its REDUCED variant initialises, runs one forward and one
optimizer step, and (where it decodes) a prefill and a decode step on the
CPU, with outputs of the expected shapes and no NaNs."""
import dataclasses

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs

from repro_torch.configs import get_config, list_archs
from repro_torch.data import synthetic_batch
from repro_torch.models import decode_step, forward_train, init_params, param_count, prefill
from repro_torch.train import adamw, make_train_state, make_train_step

ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_registry_complete():
    assert sorted(ARCHS) == sorted(jax_list_archs()) == sorted([
        "deepseek-moe-16b", "gemma-2b", "granite-moe-3b-a800m",
        "h2o-danube-1.8b", "hubert-xlarge", "paligemma-3b", "qwen1.5-110b",
        "recurrentgemma-9b", "rwkv6-1.6b", "smollm-135m"])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_reduced_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())
    assert get_config(arch).source


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_smoke_forward_and_train_step(arch):
    """Reduced variant (<=2-ish layers, d_model<=512, <=4 experts): one
    forward + one optimizer step; asserts shapes and finiteness."""
    cfg = get_config(arch).reduced()
    assert cfg.d_model <= 512 and cfg.n_layers <= max(2, len(cfg.block_pattern or ()))
    if cfg.moe:
        assert cfg.moe.n_experts <= 4

    B, S = 2, 32
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert param_count(params) > 0
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, B, S).items()}
    loss, metrics = forward_train(params, batch, cfg)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    assert torch.isfinite(metrics["accuracy"])

    opt = adamw(1e-3)
    state = make_train_state(torch.Generator().manual_seed(0), cfg, opt, "cpu")
    step = make_train_step(cfg, opt)
    state, m = step(state, batch)
    assert int(state.step) == 1
    assert torch.isfinite(m["total_loss"]), f"{arch}: train step NaN"
    assert torch.isfinite(m["grad_norm"]) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_config(a).supports_decode])
def test_reduced_smoke_decode(arch):
    """Prefill + one decode step for every decode-capable arch; a VLM's
    prompt is its image prefix and its tokens, and the decode position
    counts the prefix."""
    cfg = get_config(arch).reduced()
    B, S = 2, 16
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    if cfg.frontend == "vision_stub":
        batch = {"patch_embeds": torch.zeros((B, cfg.n_prefix_embeds, cfg.frontend_dim)),
                 "tokens": torch.ones((B, S), dtype=torch.int32)}
    else:
        batch = {"tokens": torch.ones((B, S), dtype=torch.int32)}
    total = S + cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else S
    logits, caches = prefill(params, batch, cfg, max_len=total + 4)
    assert logits.shape == (B, cfg.vocab_size)
    tok = logits.argmax(-1).to(torch.int32)
    logits2, caches = decode_step(params, caches, tok, total, cfg)
    assert logits2.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits2).all(), f"{arch}: decode NaN"


def test_encoder_only_has_no_decode():
    assert not get_config("hubert-xlarge").supports_decode
    assert get_config("hubert-xlarge").hd == 80


def test_long_context_support_flags():
    assert get_config("rwkv6-1.6b").supports_long_context
    assert get_config("recurrentgemma-9b").supports_long_context
    assert get_config("h2o-danube-1.8b").supports_long_context
    assert not get_config("gemma-2b").supports_long_context
    assert not get_config("qwen1.5-110b").supports_long_context


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_param_count_matches_jax(arch):
    """The port's tree holds as many weights as JAX's, frontends included."""
    from repro.models import init_params as jax_init_params
    from repro.models import param_count as jax_param_count
    cfg = get_config(arch).reduced()
    port = param_count(init_params(None, cfg, "meta"))
    assert port == jax_param_count(jax.eval_shape(
        lambda: jax_init_params(jax.random.key(0), jax_get_config(arch).reduced())))
