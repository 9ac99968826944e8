"""``repro_torch.launch.roofline`` and ``launch.mesh`` against the JAX
package's, on the CPU.

The counterpart of ``tests/test_roofline.py``: ``step_costs`` on programs
whose costs are known (a matmul, a loop of layers, its gradient, its
gradient under per-layer checkpointing, a batched einsum), its traffic rule
on tensors of known bytes (a view adds nothing, an in-place op adds the
tensor it writes, an argument counts once), a collective counted on 2 gloo
ranks, and ``model_flops`` and ``RooflineReport`` against JAX's on the same
inputs.  Then the step of every one of the ten archs' reduced configs:
``step_costs``' dot FLOPs of one AdamW train step on the meta device against
``hlo_costs`` of JAX's compiled step, equal but for two archs whose
differing products are named and counted below.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import _torch_sharded_worker as worker
import repro.launch.roofline as jroof
import repro.train as jtrain
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import HW as JHW
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import HW, make_mesh, make_production_mesh
from repro_torch.launch.roofline import RooflineReport, analyze, model_flops, step_costs
from repro_torch.launch.train import batch_source
from repro_torch.models import init_params
from repro_torch.train import TrainState, adamw, make_train_step

F32 = 4


def meta(*shape, requires_grad=False):
    return torch.empty(shape, device="meta", requires_grad=requires_grad)


def layers(ws, x):
    """A Python loop of layers, JAX's scanned ``tanh(x @ w)``."""
    for w in ws:
        x = torch.tanh(x @ w)
    return x.sum()


def remat_layers(ws, x):
    for w in ws:
        x = checkpoint(lambda x, w: torch.tanh(x @ w), x, w, use_reentrant=False)
    return x.sum()


def grads(f):
    """The gradient of ``f`` with respect to every weight and the input:
    XLA's transposed scan computes the input's cotangent in every
    iteration, so autograd must be asked for the first layer's too."""
    def g(ws, x):
        return torch.autograd.grad(f(ws, x), [*ws, x])
    return g


def weights(L, N):
    return [torch.randn(N, N, requires_grad=True) for _ in range(L)]


class TestDotFlops:
    def test_plain_matmul(self):
        costs = step_costs(lambda a, b: a @ b, meta(64, 128), meta(128, 32))
        assert costs["dot_flops"] == 2 * 64 * 128 * 32

    def test_loop_is_L_times_one_layer(self):
        N, L = 128, 7
        one = step_costs(layers, [meta(N, N)], meta(N, N))["dot_flops"]
        costs = step_costs(layers, [meta(N, N) for _ in range(L)], meta(N, N))
        assert one == 2 * N**3 and costs["dot_flops"] == L * one

    def test_grad_is_3x(self):
        N, L = 64, 5
        x = torch.randn(N, N, requires_grad=True)
        costs = step_costs(grads(layers), weights(L, N), x)
        assert costs["dot_flops"] == 6 * N**3 * L

    def test_remat_is_4x(self):
        N, L = 64, 5
        x = torch.randn(N, N, requires_grad=True)
        costs = step_costs(grads(remat_layers), weights(L, N), x)
        assert costs["dot_flops"] == 8 * N**3 * L

    def test_batched_einsum(self):
        costs = step_costs(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                           meta(4, 32, 16), meta(4, 16, 8))
        assert costs["dot_flops"] == 2 * 4 * 32 * 16 * 8

    def test_addmm_and_baddbmm_count_their_product_only(self):
        costs = step_costs(lambda c, a, b: torch.addmm(c, a, b) + torch.baddbmm(
            c[None], a[None], b[None]).sum(0), meta(64, 32), meta(64, 128), meta(128, 32))
        assert costs["dot_flops"] == 2 * (2 * 64 * 128 * 32)

    def test_a_convolution_is_not_a_dot(self):
        costs = step_costs(torch.nn.functional.conv1d, meta(2, 4, 16), meta(8, 4, 3))
        assert costs["dot_flops"] == 0


class TestTraffic:
    X = (16, 8)     # 512 bytes in fp32

    @pytest.mark.parametrize("op", [
        lambda x: x.view(8, 16), lambda x: x.reshape(128), lambda x: x[None].expand(3, 16, 8),
        lambda x: torch.ops.aten._unsafe_view(x, (8, 16)), lambda x: x.t(),
        lambda x: x.detach(), lambda x: x[2:5], lambda x: x.as_strided((4, 4), (8, 1)),
        lambda x: torch.ops.aten.alias(x)],
        ids=["view", "reshape", "expand", "_unsafe_view", "t", "detach", "slice",
             "as_strided", "alias"])
    def test_a_view_or_alias_adds_nothing(self, op):
        costs = step_costs(op, meta(*self.X))
        assert costs["traffic_bytes"] == costs["arg_bytes"] == 16 * 8 * F32
        assert costs["temp_bytes"] == 0

    def test_an_out_of_place_op_adds_its_result(self):
        costs = step_costs(lambda x, y: x * y, meta(*self.X), meta(*self.X))
        assert costs["arg_bytes"] == 2 * 512 and costs["traffic_bytes"] == 3 * 512
        assert costs["temp_bytes"] == costs["output_bytes"] == 512

    def test_an_in_place_op_adds_the_tensor_it_writes(self):
        costs = step_costs(lambda x, y: x[:8].add_(y), meta(*self.X), meta(8, 8))
        assert costs["arg_bytes"] == 512 + 256
        assert costs["traffic_bytes"] == 512 + 256 + 256    # the half of x it writes
        assert costs["temp_bytes"] == 0

    def test_arguments_count_once(self):
        x = meta(*self.X)
        lin = torch.nn.Linear(8, 8, bias=False, device="meta")
        costs = step_costs(lambda a, b, m, n: a + b, x, x, {"m": lin, "again": lin.weight},
                           n=lin)
        assert costs["arg_bytes"] == 512 + 8 * 8 * F32
        assert costs["traffic_bytes"] == costs["arg_bytes"] + 512

    def test_temp_bytes_is_the_peak_of_what_the_step_holds(self):
        def f(x):
            a = x * 2          # 512 live
            b = a * 3          # 1024 live
            del a              # 512
            return (b * 4).sum()    # b, b * 4 and the sum live at once: the peak

        costs = step_costs(f, meta(*self.X))
        assert costs["temp_bytes"] == 2 * 512 + F32
        assert costs["output_bytes"] == F32


RANKS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each of 2 gloo ranks' ``roofline_checks`` (no training setup)."""
    try:
        got = worker.spawn_ranks(tmp_path_factory.mktemp("roofline"), None, None, None,
                                 deadline_s=180, setups=(), world=RANKS)
    except RuntimeError as e:
        pytest.fail(str(e))
    return {rank: results["roofline"] for rank, results in got.items()}


def test_all_gather_counts_its_result_bytes(ranks):
    """One ``all_gather_into_tensor`` of (3, 5) fp32 on each of 2 ranks: its
    (6, 5) result, 120 bytes, under ``all-gather``; collective bytes are no
    traffic, and ``wait_tensor`` aliases its input."""
    result = RANKS * np.prod(worker.ROOFLINE_SHAPE) * F32
    for rank, got in ranks.items():
        costs = got["costs"]
        assert costs["coll:all-gather"] == costs["collective_bytes"] == result
        assert costs["traffic_bytes"] == costs["arg_bytes"] == np.prod(worker.ROOFLINE_SHAPE) * F32
        assert costs["dot_flops"] == 0
        assert got["gathered"] == [[0.0] * 5] * 3 + [[1.0] * 5] * 3
        rep = analyze("a", "s", "m", RANKS, costs, 1, 1, "train")
        assert rep.collectives_by_kind == {"all-gather": result}
        assert rep.collective_s == result / HW.ICI_BW


def test_meshes_are_device_meshes_over_the_group_ranks(ranks):
    for rank, got in ranks.items():
        assert got["mesh"] == ((2, 1), ("data", "model"), [[0], [1]])
        assert got["single"] == "a (16, 16) mesh needs 256 ranks; the process group has 2"
        assert got["multi"] == "a (2, 16, 16) mesh needs 512 ranks; the process group has 2"
        assert "needs 4 ranks" in got["too wide"]


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_production_mesh()


# -- model_flops and RooflineReport against JAX's -------------------------------------

def test_hw_is_the_h100_sxm_and_keeps_jax_names():
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert HW.CHIPS_PER_POD == JHW.CHIPS_PER_POD == 256
    assert 80 * 10**9 < HW.HBM_BYTES < 80 * 2**30
    assert {k for k in vars(JHW) if k.isupper()} == {k for k in vars(HW) if k.isupper()}


@pytest.mark.parametrize("n,d,kind", [(1000, 50, "train"), (1000, 50, "decode"),
                                      (134_515_008, 4096, "train")])
def test_model_flops_is_jaxs(n, d, kind):
    assert model_flops(n, d, kind) == jroof.model_flops(n, d, kind)


REPORTS = {
    "memory": dict(device_flops=1e12, device_bytes=1e11, collective_bytes=1e9),
    "compute": dict(device_flops=1e15, device_bytes=1e9, collective_bytes=0.0),
    "collective": dict(device_flops=1e12, device_bytes=1e9, collective_bytes=1e11),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_report_is_jaxs_with_the_h100s_constants(case):
    base = dict(arch="a", shape="s", mesh="m", chips=256, collectives_by_kind={},
                ca_flops_raw=0, ca_bytes_raw=0, arg_bytes=2**30, temp_bytes=2**30,
                output_bytes=0, model_flops_total=2.56e14, n_tokens=1000, **REPORTS[case])
    port, ref = RooflineReport(**base), jroof.RooflineReport(**base)
    assert port.dominant == ref.dominant == case
    assert port.useful_flops_ratio == ref.useful_flops_ratio
    assert port.hbm_per_device_gib == ref.hbm_per_device_gib == 2.0
    assert port.compute_s == pytest.approx(
        ref.compute_s * JHW.PEAK_FLOPS_BF16 / HW.PEAK_FLOPS_BF16, rel=1e-12)
    assert port.memory_s == pytest.approx(ref.memory_s * JHW.HBM_BW / HW.HBM_BW, rel=1e-12)
    assert port.collective_s == pytest.approx(
        ref.collective_s * JHW.ICI_BW / HW.ICI_BW, rel=1e-12)
    assert port.step_time_s == max(port.compute_s, port.memory_s, port.collective_s)
    assert port.to_dict().keys() == ref.to_dict().keys()


def test_analyze_reads_step_costs():
    costs = {"dot_flops": 2e12, "traffic_bytes": 3e10, "collective_bytes": 5e8,
             "coll:all-reduce": 3e8, "coll:all-gather": 2e8, "arg_bytes": 7.0}
    rep = analyze("smollm-135m", "trial", "local", 1, costs, n_params_active=100,
                  n_tokens=10, kind="train", arg_bytes=1, temp_bytes=2, output_bytes=3)
    assert (rep.device_flops, rep.device_bytes, rep.collective_bytes) == (2e12, 3e10, 5e8)
    assert rep.collectives_by_kind == {"all-reduce": 300_000_000, "all-gather": 200_000_000}
    assert (rep.ca_flops_raw, rep.ca_bytes_raw) == (0.0, 0.0)
    assert (rep.arg_bytes, rep.temp_bytes, rep.output_bytes) == (1, 2, 3)
    assert rep.model_flops_total == 6.0 * 100 * 10 and rep.dominant == "memory"


# -- one train step of each arch against JAX's compiled step -----------------------------

B, S = 2, 64


def jax_dot_flops(arch: str) -> float:
    cfg = jax_get_config(arch).reduced()
    opt = jtrain.adamw(3e-4)
    state = jax.eval_shape(lambda: jtrain.make_train_state(jax.random.key(0), cfg, opt))
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batch_source(get_config(arch).reduced(), B, S)(0).items()}
    compiled = jax.jit(jtrain.make_train_step(cfg, opt)).lower(state, batch).compile()
    return jroof.hlo_costs(compiled.as_text())["dot_flops"]


def port_costs(cfg) -> dict:
    params = init_params(None, cfg, "meta")
    opt = adamw(3e-4)
    state = TrainState(params, opt.init(dict(params.named_parameters())), 0)
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
             for k, v in batch_source(cfg, B, S)(0).items()}
    return step_costs(make_train_step(cfg, opt), state, batch)


def paligemma_products(cfg) -> int:
    """JAX computes the LM head on every position and drops the image
    prefix's logits (``logits[:, P:]``); the port drops the P positions
    before the final norm and head.  The same loss, with the head's forward
    product and its two backward products over B x P positions fewer."""
    return 3 * 2 * B * cfg.n_prefix_embeds * cfg.d_model * cfg.vocab_size


def rwkv6_products(cfg) -> int:
    """Three differences, all in the chunked WKV scan (``models/rwkv6.py::
    _wkv_chunked``), over C chunks of L steps in each of the n layers:

    - JAX's ``einsum("bthn,bshn,btshn->bhts")`` for the intra-chunk A is a
      dot, its forward and two transposed products counted; the port forms
      the same sums as ``(r * k * exp(ratio)).sum(-1)``, elementwise work
      that no matmul runs, so no dot is counted for it;
    - XLA's transposed scan computes every chunk's cotangents alike;
      autograd skips the products whose result nothing reads: the last
      chunk's state update (its ``bthn,bthm->bhnm`` einsum's two backward
      products: the final state is no output of the train step) and the
      first chunk's product into the zero initial state (``bthn,bhnm->
      bthm``'s cotangent of S0);
    - the port's ``einsum("bthn,hn,bthn->bht")`` runs as one bmm after a
      multiply, whose backward is two products where XLA's is one.
    """
    H, N = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    L = min(cfg.rwkv_chunk, S)
    C, n = -(-S // L), cfg.n_layers
    intra = 2 * B * H * L * L * N          # one A product of one chunk
    state = 2 * B * H * N * N * L          # one state product of one chunk
    diag = 2 * B * L * H * N
    return 3 * C * n * intra + 3 * n * state - C * n * diag


# arch -> the products JAX counts and the port does not (None: none); the
# ratios of the two counts read 0.987513 (paligemma) and 0.981581 (rwkv6)
DIFFERENCES = {"paligemma-3b": paligemma_products, "rwkv6-1.6b": rwkv6_products}


@pytest.mark.parametrize("arch", list_archs())
def test_step_dot_flops_match_jaxs_hlo_walk(arch):
    cfg = get_config(arch).reduced()
    port = port_costs(cfg)["dot_flops"]
    ref = jax_dot_flops(arch)
    differ = DIFFERENCES.get(arch, lambda cfg: 0)(cfg)
    assert port == pytest.approx(ref - differ, rel=1e-9), (port, ref, port / ref)


def test_the_counted_path_is_kernel_free():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              attn_impl="pallas", kernel_impl="pallas")
    free = roof.kernel_free(cfg)
    assert (free.attn_impl, free.kernel_impl) == ("auto", "jnp")
    assert roof.kernel_free(dataclasses.replace(cfg, attn_impl="chunked")).attn_impl == "chunked"
