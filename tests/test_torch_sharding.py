"""The port's sharding engine (``repro_torch.dist.sharding``) against JAX's.

For all ten reduced archs, on five stand-in meshes ((1,1), (4,2), (2,4),
(8,1) and ("pod","data","model") (2,2,2)) and under both strategies, the
port's spec of every parameter must equal ``repro.dist.sharding.spec_for``
of the JAX leaf it holds, entry for entry, through the layout map: the
repeat axis of a stacked leaf dropped, an ``nn.Linear`` weight's entries
reversed.  Leaves are paired as ``models/convert.py`` pairs them.  The same
for the optimizer moments (``train_state_specs``), batches and decode
caches (JAX's ``kpos`` and layer-collision cases among them), the
divisibility drop and the head-aware refusals.  Then ``make_shardings``'
placements and ``constrain`` with and without a policy.  The stand-in
meshes are plain objects with ``axis_names`` and ``shape``, as
``tests/test_dist_extra.py``'s ``MockMesh``: specs need no devices.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

import repro.models as jm
import repro.train as jtrain
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.dist import sharding as J
from repro.models import transformer as JT

from repro_torch.configs import get_config
from repro_torch.dist import sharding as T
from repro_torch.models import convert, init_params
from repro_torch.models import transformer as PT
from repro_torch.train import TrainState, adamw


class MockMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {"(1,1)": MockMesh(data=1, model=1), "(4,2)": MockMesh(data=4, model=2),
          "(2,4)": MockMesh(data=2, model=4), "(8,1)": MockMesh(data=8, model=1),
          "pod(2,2,2)": MockMesh(pod=2, data=2, model=2)}
STRATEGIES = ("fsdp_tp", "dp_only")
ARCHS = list_archs()
_CACHE = {}


def _arch(arch):
    """(JAX config, port config, JAX train state's shapes, port state on the
    meta device), built once a module."""
    if arch not in _CACHE:
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        jstate = jax.eval_shape(lambda: jtrain.make_train_state(jax.random.key(0), jcfg,
                                                                jtrain.adamw(1e-3)))
        model = init_params(None, cfg, "meta")
        pstate = TrainState(model, adamw(1e-3).init(dict(model.named_parameters())), 0)
        _CACHE[arch] = jcfg, cfg, jstate, pstate
    return _CACHE[arch]


def _leaves(tree):
    return {tuple(J._path_keys(p)): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _through_layout(jspec, stacked, transposed):
    spec = tuple(jspec)[1:] if stacked else tuple(jspec)
    return spec[::-1] if transposed else spec


def _matched(model):
    """(port name, JAX path, JAX shape, stacked, transposed) of every
    parameter, each pairing checked against ``convert``'s forward map."""
    linears = {n for n, m in model.named_modules() if isinstance(m, nn.Linear)}
    out = []
    for name, (path, shape, stacked, transposed) in convert.jax_layout(model).items():
        if stacked:
            _, si, _, bi, *rest = path
            forward = ("stack", si, bi, name.split(".")[3], *rest)
        else:
            forward = path
        assert convert._port_leaf(forward, np.zeros(0), linears)[0] == name
        out.append((name, path, shape, stacked, transposed))
    return out


@pytest.fixture(autouse=True)
def _no_strategy_leak():
    yield
    assert T._state == {"strategy": "fsdp_tp", "act_mesh": None, "seq_parallel": False}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_match_jax_through_the_layout(arch, strategy):
    jcfg, cfg, jstate, pstate = _arch(arch)
    jparams = _leaves(jstate.params)
    matched = _matched(pstate.params)
    assert {path for _, path, *_ in matched} == set(jparams)   # every leaf, no other
    for mesh_name, mesh in MESHES.items():
        with J.sharding_strategy(strategy), T.sharding_strategy(strategy):
            port = T.param_specs(pstate.params, mesh, cfg)
            port_state = T.train_state_specs(pstate, mesh, cfg)
            jspecs = J.train_state_specs(jstate, mesh, jcfg)
            jleaf_specs = {path: J.spec_for(path, shape, mesh, jcfg)
                           for _, path, shape, *_ in matched}
        jmoments = {key: _leaves(jspecs.opt_state[key]) for key in ("m", "v")}
        for name, path, shape, stacked, transposed in matched:
            assert tuple(jparams[path].shape) == shape, name
            want = _through_layout(jleaf_specs[path], stacked, transposed)
            assert tuple(port[name]) == want, (mesh_name, name)
            assert port_state.params[name] == port[name]
            for key in ("m", "v"):
                jm_ = _through_layout(jmoments[key][path], stacked, transposed)
                assert tuple(port_state.opt_state[key][name]) == jm_, (mesh_name, key, name)
        assert port_state.opt_state["step"] == tuple(jspecs.opt_state["step"]) == ()
        assert port_state.step == tuple(jspecs.step) == ()


def _batch(cfg, B, S=16):
    if cfg.frontend == "audio_stub":
        return {"features": np.zeros((B, S, cfg.frontend_dim), np.float32),
                "labels": np.zeros((B, S), np.int32)}
    b = {"tokens": np.zeros((B, S), np.int32), "labels": np.zeros((B, S), np.int32)}
    if cfg.frontend == "vision_stub":
        b["patch_embeds"] = np.zeros((B, cfg.n_prefix_embeds, cfg.frontend_dim), np.float32)
    return b


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, strategy):
    jcfg, cfg, _, _ = _arch(arch)
    for B in (8, 6, 2, 1):
        batch = _batch(cfg, B)
        jcaches = _leaves(jax.eval_shape(lambda: JT.init_caches(jcfg, B, 16)))
        pcaches = PT.init_caches(cfg, B, 16, "meta")
        pleaves = dict(PT.leaves({str(i): {str(j): b for j, b in enumerate(seg)}
                                  for i, seg in enumerate(pcaches)}))
        assert set(pleaves) == set(jcaches)
        for mesh_name, mesh in MESHES.items():
            with J.sharding_strategy(strategy), T.sharding_strategy(strategy):
                jb, pb = J.batch_specs(batch, mesh), T.batch_specs(batch, mesh)
                jc = _leaves(J.cache_specs(jax.eval_shape(lambda: JT.init_caches(jcfg, B, 16)),
                                           mesh, global_batch=B))
                pc = T.cache_specs(pcaches, mesh, global_batch=B)
            assert {k: tuple(v) for k, v in pb.items()} == \
                {k: tuple(v) for k, v in jb.items()}, (mesh_name, B)
            pc_leaves = dict(PT.leaves({str(i): {str(j): b for j, b in enumerate(seg)}
                                        for i, seg in enumerate(pc)}))
            for path, jspec in jc.items():
                assert tuple(pc_leaves[path]) == tuple(jspec), (mesh_name, B, path)


TINY = dict(arch_id="t", family="dense", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
            d_ff=128, vocab_size=64)


@pytest.mark.parametrize("case", ["kv batch sharded", "indivisible batch", "dp_only",
                                  "layer collision", "kpos collision"])
def test_cache_cases_of_jax(case):
    """``tests/test_dist_extra.py``'s cache cases, on both engines."""
    mesh = MockMesh(data=4, model=2)
    n_layers, B, strategy = {"kv batch sharded": (2, 8, "fsdp_tp"),
                             "indivisible batch": (2, 2, "fsdp_tp"),
                             "dp_only": (2, 8, "dp_only"),
                             "layer collision": (4, 4, "fsdp_tp"),
                             "kpos collision": (4, 4, "fsdp_tp")}[case]
    jcfg = jm.ModelConfig(**{**TINY, "n_layers": n_layers}).validate()
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **{**TINY, "n_layers": n_layers})
    if case == "kpos collision":   # a position ring whose capacity collides with the batch
        jcaches = pcaches = {"kpos": np.zeros((4, 4), np.int32)}
    else:
        jcaches = JT.init_caches(jcfg, batch=B, max_len=16)
        pcaches = PT.init_caches(cfg, B, 16, "meta")
    with J.sharding_strategy(strategy), T.sharding_strategy(strategy):
        jspecs = J.cache_specs(jcaches, mesh, global_batch=B)
        pspecs = T.cache_specs(pcaches, mesh, global_batch=B)
    if case == "kpos collision":
        assert tuple(pspecs["kpos"]) == tuple(jspecs["kpos"]) == (None, None)
        return
    want = {"kv batch sharded": (None, "data", None, None, None),
            "indivisible batch": (None,) * 5,
            "dp_only": (None, ("data", "model"), None, None, None),
            "layer collision": (None, "data", None, None, None)}[case]
    for leaf in ("k", "v"):
        assert tuple(pspecs[0][0][leaf]) == tuple(jspecs[0][0][leaf]) == want
    assert tuple(pspecs[0][0]["kpos"]) == tuple(jspecs[0][0]["kpos"]) == (None, None)


BIG = MockMesh(data=16, model=16)
GQA_9_3 = dict(arch_id="t", family="dense", n_layers=2, d_model=576, n_heads=9,
               n_kv_heads=3, d_ff=1536, vocab_size=1024)
GQA_64_8 = dict(arch_id="t", family="dense", n_layers=2, d_model=8192, n_heads=64,
                n_kv_heads=8, d_ff=1024, vocab_size=1024)


@pytest.mark.parametrize("case", [
    ("mlp weight on (1,1)", ["stack", "blocks", "mlp", "w_gate"], (4, 64, 128), "(1,1)", None,
     (None, "data", "model")),
    ("norm replicated", ["norm1", "scale"], (64,), "(1,1)", None, (None,)),
    ("experts", ["stack", "moe", "experts", "w_gate"], (2, 8, 64, 32), "(1,1)", None,
     (None, "model", "data", None)),
    ("divisibility drop: 504-row vocab", ["embed", "tok"], (504, 1280), "big", None,
     (None, "data")),
    ("divisibility drop: each dim alone", ["mlp", "w_up"], (50, 40), "(4,2)", None,
     (None, "model")),
    ("head-aware: kv 3 heads on model 16", ["stack", "attn", "wk"], (576, 192), "big",
     GQA_9_3, ("data", None)),
    ("head-aware: q 9 heads on model 16", ["stack", "attn", "wq"], (576, 576), "big",
     GQA_9_3, ("data", None)),
    ("head-aware: o 9 heads on model 16", ["stack", "attn", "wo"], (576, 576), "big",
     GQA_9_3, (None, "data")),
    ("head-aware: q 64 heads on model 16", ["attn", "wq"], (8192, 8192), "big", GQA_64_8,
     ("data", "model")),
    ("head-aware: kv 8 heads on model 16", ["attn", "wk"], (8192, 1024), "big", GQA_64_8,
     ("data", None)),
], ids=lambda c: c[0])
def test_divisibility_drop_and_head_aware_refusals(case):
    _, path, shape, mesh_name, cfg_kw, want = case
    mesh = BIG if mesh_name == "big" else MESHES[mesh_name]
    jcfg = jm.ModelConfig(**cfg_kw) if cfg_kw else None
    pcfg = dataclasses.replace(get_config("smollm-135m"), **cfg_kw) if cfg_kw else None
    assert tuple(T.spec_for(path, shape, mesh, pcfg)) == tuple(J.spec_for(
        [type("K", (), {"key": k})() for k in path], shape, mesh, jcfg)) == want
    if cfg_kw:
        name = path[-1]
        assert T._head_aware_rules(name, path, pcfg, mesh) == \
            J._head_aware_rules(name, path, jcfg, mesh)


def test_make_shardings_gives_placements_in_mesh_order():
    mesh = MESHES["pod(2,2,2)"]
    assert T.make_shardings(T.P(("pod", "data"), "model", None), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert T.make_shardings({"w": T.P("model", "data")}, MESHES["(4,2)"]) == \
        {"w": (Shard(1), Shard(0))}
    assert T.make_shardings(T.P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not in the mesh's order"):
        T.make_shardings(T.P(("data", "pod")), mesh)
    _, cfg, _, pstate = _arch("smollm-135m")
    sh = T.make_shardings(T.train_state_specs(pstate, MESHES["(4,2)"], cfg), MESHES["(4,2)"])
    assert isinstance(sh, TrainState) and sh.step == (Replicate(), Replicate())
    assert sh.params["embed.tok"] == (Shard(1), Shard(0))   # ("tp", "fsdp") on (V, D)
    assert sh.opt_state["m"]["embed.tok"] == sh.params["embed.tok"]


def test_constrain_is_the_identity_without_a_policy_and_refuses_a_plain_tensor_under_one():
    x = torch.ones(8, 4, 16)
    assert T.constrain(x) is x
    with T.activation_policy(MESHES["(4,2)"], seq_parallel=True):
        with pytest.raises(TypeError, match="needs a DTensor"):
            T.constrain(x)
    assert T.constrain(x) is x
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        with T.sharding_strategy("zero3"):
            pass
