"""Shared by the ``test_torch_dryrun_full_width*.py`` files (not collected):
the full-width dry-run records of both packages on the production meshes
(single-pod (16, 16), two-pod (2, 16, 16)), and the products where the
port's count of one rank differs from JAX's, each named and counted.

``records`` runs JAX's ``lower_one`` in a subprocess on 256 or 512 host
devices while this process counts the port's rank 0 (``repro_torch.launch.
dryrun.lower_one`` under a fake group of as many ranks), and returns both
records of every (arch, shape).  Every ``DIFFERENCES`` (pod16x16) and
``TWO_POD_DIFFERENCES`` entry is JAX's count minus the port's, as an
integer, of one rank: port == JAX - difference exactly.

long_500k is held by none: at global batch 1 JAX's walker reads 0 dot
FLOPs for recurrentgemma-9b's decode step.  XLA's CPU compiler puts each
product of the one token (a vector by a matrix) inside a loop fusion
(``kind=kLoop, calls=%fused_computation...``), and ``repro.launch.
roofline.hlo_costs`` follows ``to_apply``, ``body``, ``condition`` and
``branch_computations`` but not a fusion's ``calls``: it counts none of
them, so JAX's count is no reference there.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, dryrun_config

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
DATA = MODEL = 16               # pod16x16's axes
RANKS = DATA * MODEL
MESHES = {"pod16x16": (False, RANKS), "pods2x16x16": (True, 2 * RANKS)}   # -> multi_pod, ranks

JAX_SCRIPT = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
import repro.launch.dryrun as jd        # appends the 512-device flag before JAX starts
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import SHAPES
real, out = jd.get_config, {{}}
mesh = make_production_mesh(multi_pod={multi_pod!r})
for a, s in {cases!r}:
    fields = {overrides!r}.get(f"{{a}}/{{s}}", {{}})
    jd.get_config = lambda arch: dataclasses.replace(real(arch), **fields)
    out[f"{{a}}/{{s}}"] = jd.lower_one(a, SHAPES[s], mesh, {mesh!r}, verbose=False)
print(json.dumps(out, default=str))
"""


def records(cases, overrides=None, deadline_s=240, mesh="pod16x16"):
    """{"arch/shape": (port record, JAX record)} of each (arch, shape) of
    ``cases`` on ``mesh`` (a name of ``MESHES``), the config replaced by the
    fields of its ``overrides`` entry ("arch/shape" -> fields) in both
    packages; JAX's subprocess compiles while the port counts, and the
    port's counts must end within ``deadline_s``."""
    overrides, (multi_pod, ranks) = overrides or {}, MESHES[mesh]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(src=str(ROOT / "src"), cases=list(cases),
                                                 overrides=overrides, multi_pod=multi_pod,
                                                 mesh=mesh)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
    real, port = dryrun.get_config, {}
    try:
        deadline = time.monotonic() + deadline_s
        with dryrun.fake_group(ranks):
            device_mesh = make_production_mesh(multi_pod=multi_pod)
            for arch, shape in cases:
                key = f"{arch}/{shape}"
                dryrun.get_config = lambda a: dataclasses.replace(real(a), **overrides.get(key, {}))
                port[key] = dryrun.lower_one(arch, SHAPES[shape], device_mesh, mesh,
                                             verbose=False)
                assert time.monotonic() < deadline, f"the port's counts passed {deadline_s} s at {key}"
    finally:
        dryrun.get_config = real
        out, err = jax_proc.communicate(timeout=900)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    return {key: (port[key], ref[key]) for key in port}


def config(arch, shape_name, overrides=None):
    """The config that both packages' ``lower_one`` counted for the case."""
    fields = (overrides or {}).get(f"{arch}/{shape_name}", {})
    return dataclasses.replace(dryrun_config(get_config(arch)), **fields)


def check(records, arch, shape_name, overrides=None, mesh="pod16x16"):
    """The contract of a held record: both counted, port == JAX - the named
    difference exactly (``difference``), the same chips, tokens and model
    FLOPs.  Returns the port's record."""
    port, ref = records[f"{arch}/{shape_name}"]
    differ = difference(arch, shape_name, config(arch, shape_name, overrides), mesh)
    assert port["status"] == "counted" and ref["status"] == "compiled"
    assert port["device_flops"] == ref["device_flops"] - differ, \
        (port["device_flops"], ref["device_flops"], differ)
    assert port["chips"] == ref["chips"] == MESHES[mesh][1]
    assert port["n_tokens"] == ref["n_tokens"]
    assert port["model_flops_total"] == ref["model_flops_total"]
    return port


# -- the shares of one rank ---------------------------------------------------------------

def data_ranks(mesh) -> int:
    """The data-parallel ranks of ``mesh``: the pods times ``data``."""
    return MESHES[mesh][1] // MODEL


def tokens_a_rank(shape, data=DATA) -> int:
    """The tokens of one data rank: a decode step's one a sequence."""
    per = shape.global_batch // data
    return per if shape.kind == "decode" else per * shape.seq_len


def _capacity(cfg) -> int:
    moe = cfg.moe
    return max(1, math.ceil(moe.group_size * moe.top_k / moe.n_experts * moe.capacity_factor))


# -- the named differences: JAX's count minus the port's, one rank ----------------------
# Each takes the config, the shape and the data-parallel ranks (16 on one
# pod, 32 on two).

def kv_heads_over_part_of_model(cfg, shape, data=DATA) -> int:
    """h2o-danube-1.8b's wk and wv (d_model -> 8 kv heads of 80): XLA
    splits each of these products over 8 of the 16 ``model`` ranks, a
    head a pair of ranks.  A DTensor ``Shard`` splits a tensor dim over a
    whole mesh dim, so DTensor cannot place a split over part of one: the
    port splits them over all 16 (the rows in a prefill and a train step,
    the features in a decode step: ``dist.sharding.spread_linear``), and
    JAX's count has each twice the port's.  Two products a layer; under
    remat a train step runs each forward twice and its input's and
    weight's gradients once."""
    products = 2 * (4 if shape.kind == "train" else 1)
    whole = 2 * tokens_a_rank(shape, data) * cfg.d_model * cfg.kv_heads * cfg.hd
    return products * cfg.n_layers * (whole // cfg.kv_heads - whole // MODEL)


def moe_down_and_combine_whole(cfg, shape, data=DATA) -> int:
    """granite-moe-3b-a800m's experts (E = 40) do not divide ``model``'s 16
    ranks, so ``model`` is idle in its MoE layers.  XLA then splits w_gate's
    and w_up's products over it (their d_model fan-in) but runs w_down's
    product (``egcf,efd->egcd``) and the combine (``gsec,egcd->gsd``) whole
    on every ``model`` rank, the same work 16 times; the port splits the
    groups over the idle axis (``spread_over_idle``) for all of them.  No
    op is refused here: XLA's split is placeable, but it is the same
    product 16 times, so the port keeps its 1/16 (the same values).  A
    prefill runs each once; a train step under remat runs w_down's forward
    twice and its input's gradient, and the combine's forward and both its
    operands' gradients (one microbatch)."""
    moe, T = cfg.moe, tokens_a_rank(shape, data)
    C, E = _capacity(cfg), moe.n_experts
    down = 2 * E * (T // moe.group_size) * C * moe.d_expert * cfg.d_model
    combine = 2 * T * E * C * cfg.d_model
    products = 3 if shape.kind == "train" else 1
    return products * cfg.n_layers * (down + combine) * (MODEL - 1) // MODEL


def decode_dispatch_over_model(cfg, shape, data=DATA) -> int:
    """In granite-moe-3b-a800m's decode step the B tokens make one group
    (padded to ``group_size``), which the data axes split by tokens; its
    experts do not divide ``model``.  XLA splits the dispatch einsum
    (``gsec,gsd->egcd``) over both axes, d_model over ``model``, and the
    expert products by d_model over ``model`` alone; the port splits the
    expert products by their slots over the data axes (the same share) and
    so runs the dispatch with d_model whole on every ``model`` rank (split
    over ``model`` as well, the expert products would split 256 ways where
    XLA's split 16).  JAX's count has 1/16 of the port's dispatch."""
    moe = cfg.moe
    dispatch = 2 * (moe.group_size // data) * moe.n_experts * _capacity(cfg) * cfg.d_model
    return -cfg.n_layers * dispatch * (MODEL - 1) // MODEL


def accumulated_dispatch(cfg, shape, data=DATA) -> int:
    """``tests/test_torch_dryrun.py``'s difference at full width: in a step
    that accumulates microbatches (deepseek-moe-16b's 2), JAX's count has
    one product fewer of the dispatch and combine einsums' backward
    (2·T·E·C·D over all ranks, T a microbatch's tokens) in each MoE layer
    and microbatch than the port's three (autograd differentiates both
    operands of each einsum; XLA's transpose drops the one that the
    accumulation's loop body does not need)."""
    mb = max(1, cfg.train_microbatch)
    T = shape.global_batch // mb * shape.seq_len
    return (-mb * cfg.n_layers * 2 * T * cfg.moe.n_experts * _capacity(cfg) * cfg.d_model
            // (data * MODEL))


def wkv_products(cfg, shape, data=DATA) -> int:
    """``tests/test_torch_dryrun.py``'s differences in the chunked WKV scan
    at full width, per rank, under remat: JAX's intra-chunk A is a dot (the
    port forms it elementwise: a sum over N of products, as the kernel
    does), counted in the forward, the remat forward and two backward
    products; the last chunk's state-update products and the product into
    the zero initial state, which XLA's transposed scan computes and
    autograd skips; less the one more backward product of the port's
    three-operand ``bht`` einsum.  A prefill has the forward A product
    alone."""
    B, S = shape.global_batch, shape.seq_len
    H, N = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    L = min(cfg.rwkv_chunk, S)
    C, n, ranks = -(-S // L), cfg.n_layers, data * MODEL
    intra = 2 * B * H * L * L * N
    if shape.kind != "train":
        return C * n * intra // ranks
    state = 2 * B * H * N * N * L
    diag = 2 * B * L * H * N
    return (4 * C * n * intra + 3 * n * state - C * n * diag) // ranks


def frontend_projection(cfg, shape, data=DATA) -> int:
    """hubert-xlarge's audio frontend projection (frontend_dim -> d_model,
    before the first layer, so not under remat): on one pod XLA runs its
    forward split over the data axes only, whole on every ``model`` rank;
    the port splits its output over ``model`` too (on two pods XLA splits
    it as the port does)."""
    whole = 2 * tokens_a_rank(shape, data) * cfg.frontend_dim * cfg.d_model
    return whole * (MODEL - 1) // MODEL


def prefix_head(cfg, shape, data=DATA) -> int:
    """``tests/test_torch_roofline.py``'s difference at full width: JAX
    computes paligemma-3b's LM head on the image prefix's P positions and
    drops their logits (``logits[:, P:]``); the port drops the positions
    first.  The forward and two backward products, the vocab split over
    ``model``."""
    tokens = shape.global_batch // data * cfg.n_prefix_embeds
    return 3 * 2 * tokens * cfg.d_model * (cfg.padded_vocab or cfg.vocab_size) // MODEL


def qo_whole_on_two_pods(cfg, shape, data=2 * DATA) -> int:
    """On the two-pod mesh (2, 16, 16), where the heads do not divide
    ``model`` (smollm-135m's 9, gemma-2b's and paligemma-3b's 8), XLA runs
    one of the q and o projections (d_model -> heads × hd) whole on every
    ``model`` rank in the forward, the remat forward and its input's
    gradient (its weight's gradient split), where on one pod it splits
    both; the port splits both over ``model`` on either mesh
    (``spread_linear``)."""
    whole = 2 * tokens_a_rank(shape, data) * cfg.d_model * cfg.n_heads * cfg.hd
    return 3 * cfg.n_layers * whole * (MODEL - 1) // MODEL


def head_whole_on_two_pods(cfg, shape, data=2 * DATA) -> int:
    """granite-moe-3b-a800m's tied LM head (vocab 49,155, which does not
    divide ``model``): on the two-pod mesh XLA runs its forward whole on
    every ``model`` rank, where on one pod it splits it; the port splits
    it over ``model`` on either mesh (``spread_linear``)."""
    whole = 2 * tokens_a_rank(shape, data) * cfg.d_model * (cfg.padded_vocab or cfg.vocab_size)
    return whole * (MODEL - 1) // MODEL


def down_grad_whole_on_two_pods(cfg, shape, data=2 * DATA) -> int:
    """On the two-pod mesh XLA runs one more of granite-moe-3b-a800m's
    w_down products (``egcf,efd->egcd``) whole on every ``model`` rank
    than ``moe_down_and_combine_whole`` counts: w_down's weight gradient,
    which it splits on one pod."""
    moe = cfg.moe
    down = (2 * moe.n_experts * (tokens_a_rank(shape, data) // moe.group_size) * _capacity(cfg)
            * moe.d_expert * cfg.d_model)
    return cfg.n_layers * down * (MODEL - 1) // MODEL


def none(cfg, shape, data=DATA) -> int:
    """Equal counts."""
    return 0


def both(*named):
    """The sum of the named differences ``named``."""
    def total(cfg, shape, data=DATA) -> int:
        return sum(f(cfg, shape, data) for f in named)
    total.__name__ = " + ".join(f.__name__ for f in named)
    return total


# (arch, shape) -> JAX's count minus the port's, one rank of pod16x16 (absent: equal)
DIFFERENCES = {
    ("h2o-danube-1.8b", "decode_32k"): kv_heads_over_part_of_model,
    ("h2o-danube-1.8b", "prefill_32k"): kv_heads_over_part_of_model,
    ("h2o-danube-1.8b", "train_4k"): kv_heads_over_part_of_model,
    ("granite-moe-3b-a800m", "decode_32k"): decode_dispatch_over_model,
    ("granite-moe-3b-a800m", "prefill_32k"): moe_down_and_combine_whole,
    ("granite-moe-3b-a800m", "train_4k"): moe_down_and_combine_whole,
    ("deepseek-moe-16b", "train_4k"): accumulated_dispatch,
    ("rwkv6-1.6b", "prefill_32k"): wkv_products,
    ("rwkv6-1.6b", "train_4k"): wkv_products,
    ("hubert-xlarge", "prefill_32k"): frontend_projection,
    ("hubert-xlarge", "train_4k"): frontend_projection,
    ("paligemma-3b", "train_4k"): prefix_head,
}


# the same on pods2x16x16, for the train_4k records of the one-time table
# (smollm-135m's is held by a test)
TWO_POD_DIFFERENCES = {
    ("smollm-135m", "train_4k"): qo_whole_on_two_pods,
    ("gemma-2b", "train_4k"): qo_whole_on_two_pods,
    ("paligemma-3b", "train_4k"): both(qo_whole_on_two_pods, prefix_head),
    ("h2o-danube-1.8b", "train_4k"): kv_heads_over_part_of_model,
    ("deepseek-moe-16b", "train_4k"): accumulated_dispatch,
    ("rwkv6-1.6b", "train_4k"): wkv_products,
    ("granite-moe-3b-a800m", "train_4k"): both(moe_down_and_combine_whole, qo_whole_on_two_pods,
                                               head_whole_on_two_pods,
                                               down_grad_whole_on_two_pods),
}


def difference(arch, shape_name, cfg, mesh="pod16x16") -> int:
    table = DIFFERENCES if mesh == "pod16x16" else TWO_POD_DIFFERENCES
    return table.get((arch, shape_name), none)(cfg, SHAPES[shape_name], data_ranks(mesh))
