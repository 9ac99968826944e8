"""``repro_torch.launch.dryrun`` and ``launch.perf`` against the JAX
package's, on the CPU.

- ``step_costs`` on DTensors counts one rank's work: a matmul on a (16, 16)
  fake mesh counts the rank's local product, its arguments' local bytes,
  and the same numbers on a repeated count and in a fresh process (DTensor's
  sharding-propagation run on global shapes is counted nothing).
- Per-device parity: ``lower_one`` of the reduced configs on a (2, 4) mesh
  of a fake process group, for every arch's train step and the prefill and
  decode of each family, under ``dp_only`` and on a (2, 2, 2) pod mesh,
  against JAX's ``lower_one`` on 8 of its 512 host devices (one
  subprocess, ``get_config`` made ``.reduced()`` there as here), and
  granite-moe's three with the sort/scatter dispatch (``MOE_IMPL``): the
  dot FLOPs of one rank equal one device's, but for the products named and
  counted in ``DIFFERENCES``.
- The record's keys are JAX's, with the listed renames; the CLI at full
  width; ``perf.PAIRS`` is JAX's and builds every variant's config.

Every test leaves no process group behind (``no_group_left``).
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config, list_archs
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import step_costs
from repro_torch.launch.shapes import SHAPES, ShapeSpec, dryrun_config

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
AXES2, AXES3 = ("data", "model"), ("pod", "data", "model")


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
    assert not dist.is_initialized(), "a test left a process group behind"


# -- fault 1: a sharded step is counted for one rank -------------------------------------

MATMUL = """
import json, sys
sys.path.insert(0, {src!r})
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import step_costs
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.configs import get_config
with fake_group(256):
    mesh = make_mesh((16, 16), ("data", "model"))
    x = distribute_tensor(torch.empty(64, 64, device="meta"), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(64, 128, device="meta"), mesh, [Replicate(), Shard(1)])
    matmul = step_costs(lambda a, b: a @ b, x, w)
dryrun.get_config = lambda arch: get_config(arch).reduced()
with fake_group(8):
    rec = dryrun.lower_one("smollm-135m", ShapeSpec("train", "train", 64, 8),
                           make_mesh((2, 4), ("data", "model")), "m", verbose=False)
print(json.dumps([matmul, rec]))
"""

COUNTED = ("device_flops", "device_bytes", "collective_bytes", "collectives_by_kind",
           "arg_bytes", "temp_bytes", "output_bytes")


def matmul_costs():
    with dryrun.fake_group(256):
        mesh = make_mesh((16, 16), AXES2)
        x = distribute_tensor(torch.empty(64, 64, device="meta"), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(64, 128, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        return [step_costs(lambda a, b: a @ b, x, w) for _ in range(2)]


def test_a_sharded_matmul_counts_the_ranks_product_alone():
    """(64, 64) @ (64, 128) with the rows over ``data`` and the columns
    over ``model``: rank 0 multiplies (4, 64) @ (64, 8), 4,096 FLOPs, where
    the global product is 1,048,576; its arguments are 1 KiB + 2 KiB of
    fp32 shards and its result 128 bytes."""
    first, again = matmul_costs()
    assert first["dot_flops"] == 2 * 4 * 64 * 8 == 4096
    assert first["arg_bytes"] == (4 * 64 + 64 * 8) * 4
    assert first["output_bytes"] == first["temp_bytes"] == 4 * 8 * 4
    assert first["collective_bytes"] == 0
    assert again == first


@pytest.fixture(scope="module")
def twice(tmp_path_factory):
    """The reduced smollm-135m train step on a (2, 4) mesh counted twice in
    this process, and the matmul and the step counted in a fresh one."""
    fresh = subprocess.Popen([sys.executable, "-c", MATMUL.format(src=str(ROOT / "src"))],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
    real = dryrun.get_config
    dryrun.get_config = lambda arch: real(arch).reduced()
    try:
        with dryrun.fake_group(8):
            mesh = make_mesh((2, 4), AXES2)
            recs = [dryrun.lower_one("smollm-135m", ShapeSpec("train", "train", 64, 8), mesh,
                                     "m", verbose=False) for _ in range(2)]
    finally:
        dryrun.get_config = real
        out, err = fresh.communicate(timeout=180)
    assert fresh.returncode == 0, err[-2000:]
    return recs, json.loads(out.strip().splitlines()[-1])


@pytest.mark.timeout(180)
def test_a_fresh_process_counts_the_same(twice):
    """The first count in a process misses DTensor's propagation cache:
    DTensor runs each op once on global-shape fake tensors and computes
    shard sizes; none of that is counted."""
    recs, (matmul, rec) = twice
    assert matmul == matmul_costs()[0]
    assert {k: rec[k] for k in COUNTED} == {k: recs[0][k] for k in COUNTED}


def test_a_step_counted_twice_gives_the_same_numbers(twice):
    recs, _ = twice
    assert {k: recs[0][k] for k in COUNTED} == {k: recs[1][k] for k in COUNTED}
    assert recs[0]["device_flops"] == 654_311_424      # the unsharded step's / 8, exactly


# -- per-device parity with JAX's lower_one ---------------------------------------------

JAX_SCRIPT = """
import json, sys
sys.path.insert(0, {src!r})
import repro.launch.dryrun as jd        # appends the 512-device flag before JAX starts
import jax
from repro.launch.shapes import ShapeSpec
import dataclasses
real = jd.get_config
jd.get_config = lambda arch: real(arch).reduced()
out = {{}}
for key, arch, kind, B, mesh_shape, axes, strategy, impl in json.loads(sys.argv[1]):
    n = 1
    for s in mesh_shape:
        n *= s
    mesh = jax.make_mesh(tuple(mesh_shape), tuple(axes), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    overrides = impl and {{"moe": dataclasses.replace(real(arch).reduced().moe, impl=impl)}}
    rec = jd.lower_one(arch, ShapeSpec(kind, kind, {S}, B), mesh, "m", verbose=False,
                       strategy=strategy, cfg_overrides=overrides)
    out[key] = rec
print(json.dumps(out, default=str))
"""

S = 64
RANKS = 8
DEADLINE_S = 300    # the port's counts of every case (about 50 s on one CPU core)


def _train_batch(arch):
    """8 sequences a microbatch: each rank's share of a microbatch stays a
    whole sequence or more (DTensor's einsum refuses a batch of one a rank
    when the heads are split too)."""
    return 8 * max(1, get_config(arch).train_microbatch)


CASES = ([(f"{a}/train", a, "train", _train_batch(a), (2, 4), AXES2, "fsdp_tp")
          for a in list_archs()]
         + [(f"{a}/{kind}", a, kind, 8, (2, 4), AXES2, "fsdp_tp")
            for a in ("smollm-135m", "granite-moe-3b-a800m", "rwkv6-1.6b",
                      "recurrentgemma-9b", "paligemma-3b", "hubert-xlarge")
            for kind in ("prefill", "decode")
            if not (a == "hubert-xlarge" and kind == "decode")]
         + [("smollm-135m/train dp_only", "smollm-135m", "train", 8, (2, 4), AXES2, "dp_only"),
            ("smollm-135m/train (2,2,2)", "smollm-135m", "train", 8, (2, 2, 2), AXES3,
             "fsdp_tp")]
         + [(f"granite-moe-3b-a800m/{kind} scatter", "granite-moe-3b-a800m", kind, 8, (2, 4),
             AXES2, "fsdp_tp") for kind in ("train", "prefill", "decode")])
# case -> the MoE dispatch it counts, where not the config's (einsum)
MOE_IMPL = {c[0]: "scatter" for c in CASES if c[0].endswith(" scatter")}


def kv_weight_grads(cfg, B):
    """XLA splits the k/v projections' weight gradients four ways (the
    tokens over ``data``, the two kv heads' features over two of the four
    ``model`` ranks), the port eight ways: one product of 2·B·S·D·K·hd/8
    more a weight and layer in JAX's count."""
    return cfg.n_layers * 2 * (2 * B * S * cfg.d_model * cfg.kv_heads * cfg.hd) // RANKS


def frontend_projection(cfg, B):
    """XLA runs the audio frontend's projection (frontend_dim -> d_model)
    split over ``data`` only; the port splits its output over ``model``
    too.  Its forward product: 1/2 a rank in JAX, 1/8 in the port."""
    whole = 2 * B * S * cfg.frontend_dim * cfg.d_model
    return whole // 2 - whole // RANKS


def prefix_head(cfg, B):
    """``test_torch_roofline.py``'s difference, per rank: JAX computes the
    LM head on the image prefix's P positions and drops their logits
    (``logits[:, P:]``); the port drops the positions first.  Forward and
    two backward products."""
    return 3 * 2 * B * cfg.n_prefix_embeds * cfg.d_model * cfg.vocab_size // RANKS


def wkv_products(cfg, B, train=True):
    """``test_torch_roofline.py``'s differences in the chunked WKV scan, per
    rank, under remat: JAX's intra-chunk A is a dot (the port forms it elementwise), counted in
    the forward, the remat forward and two backward products; the last
    chunk's state-update products and the product into the zero initial
    state, which XLA's transposed scan computes and autograd skips; less
    the one more backward product of the port's three-operand ``bht``
    einsum.  A prefill has the forward A product alone."""
    H, N = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    L = min(cfg.rwkv_chunk, S)
    C, n = -(-S // L), cfg.n_layers
    intra = 2 * B * H * L * L * N
    if not train:
        return C * n * intra // RANKS
    state = 2 * B * H * N * N * L
    diag = 2 * B * L * H * N
    return (4 * C * n * intra + 3 * n * state - C * n * diag) // RANKS


def router_products(cfg, B):
    """JAX's walker counts no product of the fp32 router in the train step
    (XLA fuses that dot); the port counts its forward, its remat forward and
    its two backward products, over a rank's tokens (B·S/8, split over both
    axes), in every MoE layer and microbatch."""
    mb = max(1, cfg.train_microbatch)
    tokens = B // mb * S // RANKS
    return -mb * cfg.n_layers * 4 * 2 * tokens * cfg.d_model * cfg.moe.n_experts


def accumulated_dispatch(cfg, B):
    """In a step that accumulates microbatches, JAX's count has one product
    fewer of the dispatch and combine einsums' backward (2·T·E·C·D/8, T a
    microbatch's tokens) in each MoE layer and microbatch than the port's
    three; with one microbatch (granite) the two agree."""
    mb = max(1, cfg.train_microbatch)
    T = B // mb * S
    g = cfg.moe.group_size
    C = max(1, math.ceil(g * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor))
    return -mb * cfg.n_layers * 2 * T * cfg.moe.n_experts * C * cfg.d_model // RANKS


def scatter_decode_experts(cfg, B):
    """In a decode step's sort/scatter dispatch XLA splits the three expert
    products over ``data`` as well (B tokens make one group, which ``data``
    cannot split); the port runs each rank's experts (those of its
    ``model`` rank: ``local_moe_scatter`` splits the groups and the
    experts) on the whole group, on both ``data`` ranks.  JAX's count has
    half of them, in every MoE layer."""
    moe = cfg.moe
    G = max(1, B // moe.group_size)
    C = max(1, math.ceil(moe.group_size * moe.top_k / moe.n_experts * moe.capacity_factor))
    whole = 3 * 2 * G * (moe.n_experts // 4) * C * cfg.d_model * moe.d_expert
    return -cfg.n_layers * (whole - whole // 2)


# case -> JAX's count minus the port's, per rank (absent: none)
DIFFERENCES = {
    "smollm-135m/train": kv_weight_grads,
    "hubert-xlarge/train": frontend_projection,
    "hubert-xlarge/prefill": frontend_projection,
    "paligemma-3b/train": prefix_head,
    "rwkv6-1.6b/train": wkv_products,
    "rwkv6-1.6b/prefill": lambda cfg, B: wkv_products(cfg, B, train=False),
    "granite-moe-3b-a800m/train": router_products,
    "deepseek-moe-16b/train": lambda cfg, B: (router_products(cfg, B)
                                              + accumulated_dispatch(cfg, B)),
    "granite-moe-3b-a800m/decode scatter": scatter_decode_experts,
}


@pytest.fixture(scope="module")
def records():
    """(port record, JAX record) of every case; JAX's subprocess runs while
    the port counts."""
    combos = [[key, a, kind, B, list(shape), list(axes), strategy, MOE_IMPL.get(key)]
              for key, a, kind, B, shape, axes, strategy in CASES]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(src=str(ROOT / "src"), S=S),
         json.dumps(combos)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=ENV)
    real = dryrun.get_config
    dryrun.get_config = lambda arch: real(arch).reduced()
    port = {}
    try:
        deadline = time.monotonic() + DEADLINE_S
        for key, a, kind, B, shape, axes, strategy in CASES:
            impl = MOE_IMPL.get(key)
            overrides = impl and {"moe": dataclasses.replace(real(a).reduced().moe, impl=impl)}
            with dryrun.fake_group(math.prod(shape)):
                mesh = make_mesh(shape, axes)
                port[key] = dryrun.lower_one(a, ShapeSpec(kind, kind, S, B), mesh, "m",
                                             verbose=False, strategy=strategy,
                                             cfg_overrides=overrides)
            assert time.monotonic() < deadline, f"the port's counts passed {DEADLINE_S} s at {key}"
    finally:
        dryrun.get_config = real
        out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return {key: (port[key], ref[key]) for key in port}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_per_device_dot_flops_match_jaxs(records, case):
    port, ref = records[case]
    assert port["status"] == "counted" and ref["status"] == "compiled"
    _, arch, kind, B, *_ = next(c for c in CASES if c[0] == case)
    cfg = dryrun_config(get_config(arch).reduced())
    if case in MOE_IMPL:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=MOE_IMPL[case]))
    differ = DIFFERENCES.get(case, lambda cfg, B: 0)(cfg, B)
    assert port["device_flops"] == pytest.approx(ref["device_flops"] - differ, rel=1e-9), \
        (port["device_flops"], ref["device_flops"], port["device_flops"] / ref["device_flops"])
    assert port["chips"] == ref["chips"] == RANKS
    assert port["n_tokens"] == ref["n_tokens"]
    assert port["model_flops_total"] == ref["model_flops_total"]


def test_every_rank_counts_a_share_of_the_unsharded_step():
    """No case counts more than the one-device step would: the (1, 1)
    count of smollm's step is 8 times its (2, 4) one."""
    real = dryrun.get_config
    dryrun.get_config = lambda arch: real(arch).reduced()
    try:
        with dryrun.fake_group(1):
            one = dryrun.lower_one("smollm-135m", ShapeSpec("t", "train", S, 8),
                                   make_mesh((1, 1), AXES2), "m", verbose=False)
    finally:
        dryrun.get_config = real
    assert one["device_flops"] == RANKS * 654_311_424


# -- mesh dims of one rank --------------------------------------------------------------

def _activation_and_linear(mesh, placements):
    x = distribute_tensor(torch.empty(8, 4, 16, device="meta"), mesh, [Replicate()] * mesh.ndim)
    lin = torch.nn.Linear(16, 32, device="meta")
    lin.weight = torch.nn.Parameter(distribute_tensor(lin.weight, mesh, placements))
    lin.bias = torch.nn.Parameter(distribute_tensor(lin.bias, mesh, [Replicate()] * mesh.ndim))
    return x, lin


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_the_pins_and_gathers_skip_mesh_dims_of_one_rank(shape):
    """On a (1, 1) mesh every placement holds the same values, so
    ``constrain``, ``pin_grad`` and ``gathered`` hand back what they were
    given and dispatch no redistribution; on (2, 4) they still pin the
    activation and gather the FSDP-split weight over ``data``."""
    with dryrun.fake_group(math.prod(shape)):
        mesh = make_mesh(shape, AXES2)
        x, lin = _activation_and_linear(mesh, [Shard(0), Shard(1)])
        w = lin.weight
        with shd.activation_policy(mesh):
            pinned = shd.constrain(x)
            with shd.gathered(lin):
                used = lin.weight
        assert lin.weight is w
        if shape == (1, 1):
            assert pinned is x and shd.pin_grad(x) is x and used is w
        else:
            assert pinned is not x and shd.pin_grad(x) is not x
            assert tuple(used.placements) == (Replicate(), Shard(1))


# -- the record and the CLI ---------------------------------------------------------------

# JAX's key -> the port's, where they differ
RENAMES = {"t_compile_s": "t_count_s"}


def test_record_keys_are_jaxs_with_the_listed_renames(records):
    port, ref = records["smollm-135m/train"]
    assert {RENAMES.get(k, k) for k in ref} == set(port)
    assert (port["status"], ref["status"]) == ("counted", "compiled")
    assert port["ca_flops_raw"] == port["ca_bytes_raw"] == 0


def test_no_compile_places_and_counts_nothing(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch).reduced())
    with dryrun.fake_group(8):
        rec = dryrun.lower_one("smollm-135m", ShapeSpec("t", "train", S, 8),
                               make_mesh((2, 4), AXES2), "m", verbose=False, compile_=False)
    assert rec["status"] == "lowered" and "device_flops" not in rec
    assert set(rec) == {"arch", "shape", "mesh", "chips", "status", "t_lower_s", "variant"}


def test_a_skip_is_documented():
    with dryrun.fake_group(8):
        rec = dryrun.lower_one("hubert-xlarge", SHAPES["decode_32k"],
                               make_mesh((2, 4), AXES2), "m", verbose=False)
    assert rec["status"] == "skipped" and "encoder-only" in rec["reason"]


def test_the_fake_group_refuses_a_second_group():
    with dryrun.fake_group(2):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_group(2):
                pass


@pytest.mark.timeout(300)
def test_cli_counts_smollm_decode_at_full_width(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
         "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=ENV, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[dryrun] 1 counted, 0 skipped (documented), 0 errors" in proc.stdout
    (rec,) = json.loads((tmp_path / "dryrun_single.json").read_text())
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("counted", "pod16x16", 256)
    assert rec["n_tokens"] == 128 and rec["device_flops"] > 0 and rec["arg_bytes"] > 0
    # the whole step's dot FLOPs are at least 2·N·D of the model; a rank's share is
    # at least that over the ranks and below the whole
    assert rec["model_flops_total"] / 256 <= rec["device_flops"] < rec["model_flops_total"]


# -- perf ---------------------------------------------------------------------------------

def _plain(v):
    return {k: (dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x)
            for k, x in v.items()}


def test_perf_pairs_are_jaxs():
    jperf = jax_launch_module("perf")
    assert list(perf.PAIRS) == list(jperf.PAIRS)
    for pair in perf.PAIRS:
        port = [{k: (_plain(x) if k == "cfg_overrides" else x) for k, x in v.items()}
                for v in perf.PAIRS[pair]]
        ref = [{k: (_plain(x) if k == "cfg_overrides" else x) for k, x in v.items()}
               for v in jperf.PAIRS[pair]]
        assert port == ref, pair


@pytest.mark.parametrize("pair", list(perf.PAIRS))
def test_perf_pairs_build_every_variants_config(pair):
    for v in perf.PAIRS[pair]:
        cfg = dryrun_config(get_config(v["arch"]))
        cfg = dataclasses.replace(cfg, **v.get("cfg_overrides", {}))
        assert v["shape"] in SHAPES and v.get("strategy", "fsdp_tp") in ("fsdp_tp", "dp_only")
        cfg.validate()
