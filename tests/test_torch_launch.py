"""``repro_torch.launch.shapes`` and ``launch.dryrun.active_param_count``
against the JAX package's, on the CPU.

JAX's ``tests/test_launch.py`` contracts run on the port (its hardware
constants are a TPU's; the port's ``HW`` is held in
``test_torch_roofline.py``); then, for all 10 archs x 4 shapes at full
width, ``skip_reason`` and ``input_specs`` (shapes and dtypes, every cache
leaf included) against JAX's, and ``active_param_count`` against JAX's for
all ten archs.  Nothing here starts a process group.
"""
import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.shapes as jshapes
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.dryrun import active_param_count
from repro_torch.launch.shapes import (SHAPES, applicable, dryrun_config, input_specs,
                                       skip_reason)
from repro_torch.models import init_params, param_count
from repro_torch.models.transformer import leaves

COMBOS = [(a, s) for a in list_archs() for s in SHAPES]


def jax_launch_module(name: str):
    """``repro.launch.<name>``, imported with this process's JAX devices:
    importing JAX's dryrun or perf appends a 512-host-device flag to
    ``XLA_FLAGS`` for a JAX not yet started; the backend is started first
    and the variable put back, so that neither this process nor a child
    sees the flag."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


class TestShapes:
    def test_assigned_shapes_exact(self):
        assert (SHAPES["train_4k"].seq_len, SHAPES["train_4k"].global_batch) == (4096, 256)
        assert (SHAPES["prefill_32k"].seq_len, SHAPES["prefill_32k"].global_batch) == (32768, 32)
        assert (SHAPES["decode_32k"].seq_len, SHAPES["decode_32k"].global_batch) == (32768, 128)
        assert (SHAPES["long_500k"].seq_len, SHAPES["long_500k"].global_batch) == (524288, 1)

    def test_shapes_are_jaxs(self):
        assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
            {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}

    def test_applicability_matrix(self):
        """10x4 = 40 pairs: 32 applicable + 8 documented skips."""
        n_app = n_skip = 0
        for arch in list_archs():
            cfg = get_config(arch)
            for shape in SHAPES.values():
                if applicable(cfg, shape):
                    n_app += 1
                else:
                    n_skip += 1
                    assert skip_reason(cfg, shape)
        assert (n_app, n_skip) == (32, 8)

    def test_encoder_skips_decode(self):
        cfg = get_config("hubert-xlarge")
        assert not applicable(cfg, SHAPES["decode_32k"])
        assert not applicable(cfg, SHAPES["long_500k"])
        assert applicable(cfg, SHAPES["prefill_32k"])

    def test_long_context_only_subquadratic(self):
        runs = {a for a in list_archs() if applicable(get_config(a), SHAPES["long_500k"])}
        assert runs == {"rwkv6-1.6b", "recurrentgemma-9b", "h2o-danube-1.8b"}

    @pytest.mark.parametrize("arch,shape", COMBOS)
    def test_skip_reason_is_jaxs(self, arch, shape):
        assert skip_reason(get_config(arch), SHAPES[shape]) == \
            jshapes.skip_reason(jax_get_config(arch), jshapes.SHAPES[shape])


class TestInputSpecs:
    def test_train_structs_lm(self):
        cfg = dryrun_config(get_config("smollm-135m"))
        specs = input_specs(cfg, SHAPES["train_4k"])
        assert specs["batch"]["tokens"].shape == (256, 4096)
        assert specs["batch"]["labels"].dtype == torch.int32
        assert specs["batch"]["tokens"].device.type == "meta"

    def test_train_structs_vlm(self):
        cfg = dryrun_config(get_config("paligemma-3b"))
        specs = input_specs(cfg, SHAPES["train_4k"])
        assert specs["batch"]["patch_embeds"].shape == (256, 256, 1152)
        assert specs["batch"]["tokens"].shape == (256, 4096 - 256)

    def test_train_structs_audio(self):
        cfg = dryrun_config(get_config("hubert-xlarge"))
        specs = input_specs(cfg, SHAPES["train_4k"])
        assert specs["batch"]["features"].shape == (256, 4096, 512)

    def test_decode_structs_have_caches(self):
        cfg = dryrun_config(get_config("gemma-2b"))
        specs = input_specs(cfg, SHAPES["decode_32k"])
        assert specs["tokens"].shape == (128,)
        assert specs["pos"] == 0        # a Python int, as the port's decode_step takes it
        assert [t for _, t in _cache_leaves(specs["caches"])]

    def test_window_cache_capped(self):
        """SWA caches are O(window), not O(seq): the long_500k enabler."""
        cfg = dryrun_config(get_config("h2o-danube-1.8b"))
        specs = input_specs(cfg, SHAPES["long_500k"])
        k_shapes = [tuple(t.shape) for path, t in _cache_leaves(specs["caches"])
                    if path[-1] == "k"]
        assert k_shapes and all(s[2] == cfg.sliding_window for s in k_shapes)

    def test_rwkv_state_o1(self):
        cfg = dryrun_config(get_config("rwkv6-1.6b"))
        specs = input_specs(cfg, SHAPES["long_500k"])
        total = sum(t.numel() for _, t in _cache_leaves(specs["caches"]))
        # O(1) in seq: state bytes independent of the 524288 context
        assert total < 50e6

    def test_dryrun_config_is_bf16_remat(self):
        cfg = dryrun_config(get_config("smollm-135m"))
        assert cfg.param_dtype == "bfloat16" and cfg.remat and cfg.attn_impl == "auto"


def _cache_leaves(caches):
    """(path, tensor) of every cache leaf: segment, block, then the keys."""
    for si, seg in enumerate(caches):
        for bi, block in enumerate(seg):
            for path, t in leaves(block):
                yield (str(si), str(bi)) + path, t


def _jax_cache_leaves(caches):
    for path, leaf in jax.tree_util.tree_leaves_with_path(caches):
        yield tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf


def _meta(spec):
    return (tuple(spec.shape), str(spec.dtype).replace("torch.", ""))


def _jax(spec):
    return (tuple(spec.shape), str(np.dtype(spec.dtype)))


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_are_jaxs(arch, shape):
    """Shapes and dtypes of every input, cache leaves included, at full
    width; a decode step's ``pos`` is a Python int where JAX's is an int32
    scalar struct."""
    cfg, jcfg = dryrun_config(get_config(arch)), jshapes.dryrun_config(jax_get_config(arch))
    spec, ref = SHAPES[shape], jshapes.SHAPES[shape]
    if skip_reason(cfg, spec):
        assert jshapes.skip_reason(jcfg, ref) == skip_reason(cfg, spec)
        return
    port, jax_specs = input_specs(cfg, spec), jshapes.input_specs(jcfg, ref)
    assert set(port) == set(jax_specs)
    if spec.kind in ("train", "prefill"):
        assert {k: _meta(v) for k, v in port["batch"].items()} == \
            {k: _jax(v) for k, v in jax_specs["batch"].items()}
        return
    assert _meta(port["tokens"]) == _jax(jax_specs["tokens"])
    assert isinstance(port["pos"], int) and jax_specs["pos"].shape == ()
    assert {p: _meta(t) for p, t in _cache_leaves(port["caches"])} == \
        {p: _jax(t) for p, t in _jax_cache_leaves(jax_specs["caches"])}


class TestActiveParams:
    def test_dense_equals_total(self):
        cfg = get_config("smollm-135m").reduced()
        assert active_param_count(cfg) == param_count(init_params(None, cfg, "meta"))

    def test_moe_counts_topk_fraction(self):
        base = get_config("deepseek-moe-16b").reduced()
        # reduced() clamps to 4 experts top-4 (frac 1): widen to top-1 of 4
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, top_k=1))
        total = param_count(init_params(None, cfg, "meta"))
        active = active_param_count(cfg)
        assert active < total
        frac = cfg.moe.top_k / cfg.moe.n_experts
        assert total * frac <= active  # non-expert params keep it above frac

    @pytest.mark.parametrize("arch", list_archs())
    def test_active_param_count_is_jaxs_at_full_width(self, arch):
        jdryrun = jax_launch_module("dryrun")
        assert active_param_count(get_config(arch)) == \
            jdryrun.active_param_count(jax_get_config(arch))
