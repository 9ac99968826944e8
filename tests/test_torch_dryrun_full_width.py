"""smollm-135m's records at full width on the single-pod mesh (16, 16):
the port's rank 0 (``repro_torch.launch.dryrun.lower_one`` under a fake
group of 256 ranks) against JAX's ``lower_one`` on 256 host devices, for
train_4k, prefill_32k and decode_32k.  Their dot FLOPs are equal but for
the products named and counted in ``DIFFERENCES``.

smollm's 9 heads do not divide ``model``'s 16 ranks, so the head-aware rules
keep the attention weights off ``model`` in both packages.  XLA's
partitioner then still splits the q and o projections over ``model`` (36
of their 576 features a rank, across head boundaries); the port runs them
whole on every ``model`` rank.  In a decode step, whose 8 tokens a data rank
do not split 16 ways, XLA also splits the k and v projections' contraction
over ``model``; the port's ``spread_product`` splits only rows.

Every test leaves no process group behind.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, dryrun_config

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
ARCH, SHAPE_NAMES = "smollm-135m", ("train_4k", "prefill_32k", "decode_32k")
DATA = MODEL = 16               # pod16x16's axes
DEADLINE_S = 240                # the port's three counts (about 45 s on one CPU core)

JAX_SCRIPT = """
import json, sys
sys.path.insert(0, {src!r})
import repro.launch.dryrun as jd        # appends the 512-device flag before JAX starts
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import SHAPES
mesh = make_production_mesh(multi_pod=False)
print(json.dumps({{name: jd.lower_one({arch!r}, SHAPES[name], mesh, "pod16x16", verbose=False)
                  for name in {names!r}}}, default=str))
"""


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


def tokens_a_rank(shape) -> int:
    """The tokens of one data rank: a decode step's one a sequence."""
    per = shape.global_batch // DATA
    return per if shape.kind == "decode" else per * shape.seq_len


def whole_over_model(cfg, tokens: int, products: int, features: int) -> int:
    """JAX's count minus the port's for ``products`` products a layer of
    (tokens, d_model) by (d_model, features) that XLA splits over
    ``model`` and the port runs whole on every ``model`` rank."""
    return -(products * cfg.n_layers * 2 * tokens * cfg.d_model * features
             * (MODEL - 1) // MODEL)


def qo_projections(cfg, shape) -> int:
    """wq and wo: under remat a train step runs each forward twice and
    backward twice (the input's and the weight's products); a prefill or
    a decode step runs each once."""
    products = 2 * (4 if shape.kind == "train" else 1)
    return whole_over_model(cfg, tokens_a_rank(shape), products, cfg.n_heads * cfg.hd)


def kv_contraction(cfg, shape) -> int:
    """wk and wv in a decode step: XLA splits their d_model contraction."""
    return whole_over_model(cfg, tokens_a_rank(shape), 2, cfg.kv_heads * cfg.hd)


# shape -> JAX's count minus the port's, per rank
DIFFERENCES = {
    "train_4k": qo_projections,
    "prefill_32k": qo_projections,
    "decode_32k": lambda cfg, shape: qo_projections(cfg, shape) + kv_contraction(cfg, shape),
}


@pytest.fixture(scope="module")
def records():
    """(port record, JAX record) of each shape; JAX's subprocess compiles
    while the port counts."""
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(src=str(ROOT / "src"), arch=ARCH,
                                                 names=list(SHAPE_NAMES))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
    port = {}
    try:
        deadline = time.monotonic() + DEADLINE_S
        with dryrun.fake_group(DATA * MODEL):
            mesh = make_production_mesh(multi_pod=False)
            for name in SHAPE_NAMES:
                port[name] = dryrun.lower_one(ARCH, SHAPES[name], mesh, "pod16x16",
                                              verbose=False)
                assert time.monotonic() < deadline, f"the port's counts passed {DEADLINE_S} s"
    finally:
        out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return {name: (port[name], ref[name]) for name in SHAPE_NAMES}


def test_the_heads_do_not_divide_model():
    cfg = get_config(ARCH)
    assert cfg.n_heads % MODEL and cfg.kv_heads % MODEL


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_full_width_dot_flops_match_jaxs_but_the_named_products(records, name):
    port, ref = records[name]
    assert port["status"] == "counted" and ref["status"] == "compiled"
    cfg = dryrun_config(get_config(ARCH))
    differ = DIFFERENCES[name](cfg, SHAPES[name])
    assert port["device_flops"] == ref["device_flops"] - differ, \
        (port["device_flops"], ref["device_flops"], differ)
    assert port["chips"] == ref["chips"] == DATA * MODEL
    assert port["n_tokens"] == ref["n_tokens"]
    assert port["model_flops_total"] == ref["model_flops_total"]
