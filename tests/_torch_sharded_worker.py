"""The port's sharded train step on 8 gloo ranks of the CPU.

    OMP_NUM_THREADS=1 PYTHONPATH=src python tests/_torch_sharded_worker.py [ARCH] \
        [--moe-impl scatter]

trains a reduced config (``reduced_config``: smollm-135m by default, with
remat and ``attn_impl="pallas"``, so that K1's wrapper runs on each rank's
shards, its plain version on the CPU; rwkv6-1.6b, recurrentgemma-9b and
granite-moe-3b-a800m with ``kernel_impl="pallas"`` too, so that K2, K3 and
K4 run there as well; ``--moe-impl scatter`` gives granite the sort/scatter
dispatch) for 5 AdamW steps from weights drawn by the port (seed 0) on a
(1,1) mesh, then on (4,2) under ``fsdp_tp`` and under ``dp_only``, and
prints each setup's losses, its largest relative gap from the (1,1) run's
and the local shapes each kernel's wrapper saw; then the (4,2) ``fsdp_tp``
prefill's (and for the moe family the decode step's) largest normwise gap
from the (1,1) run's, which must be within ``SERVE_TOL``.
``test_torch_multidevice.py`` and ``test_torch_multidevice_{ssm,hybrid,
moe,moe_scatter}.py`` run the same ranks on JAX's weights.

Imports ``torch`` and ``repro_torch`` only: each rank is a process started
with ``spawn``, which imports this module, never the test file (that imports
``jax``).  ``run`` joins a gloo process group through a file store, builds
each setup's mesh from a device-mode ``SlicePool`` over the group's ranks,
and trains the same weights on the same batches under that setup,
keeping the first step's gradients; asked to (``spawn_ranks``' ``serve``,
as ``test_torch_multidevice_{ssm,hybrid,moe}.py`` ask), it also prefills
(and for the moe family decodes one step) on the (1,1) and the (4,2)
``fsdp_tp`` meshes.  Then every rank runs the mesh, refusal and roofline
checks; ``test_torch_roofline.py`` spawns 2 ranks with no setup
for the last.
"""
from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
WORLD, STEPS, B, S = 8, 5, 8, 64
SETUPS = [("(1,1)", (1, 1), "fsdp_tp"), ("(4,2) fsdp_tp", (4, 2), "fsdp_tp"),
          ("(4,2) dp_only", (4, 2), "dp_only")]
# The setups that also prefill (and for the moe family decode one step), and
# the prompt: the first PROMPT tokens of the first batch, caches of MAX_LEN.
SERVE_SETUPS, PROMPT, MAX_LEN = ("(1,1)", "(4,2) fsdp_tp"), 32, 40
# The kernel wrappers each rank records the calls of.
WRAPPERS = ("flash_attention", "rwkv6_scan", "rglru_scan", "moe_router")
# Each arch's reduced config: the token families run their kernels' wrappers
# (plain versions on the CPU); granite-moe-3b-a800m keeps 16 of its 40
# experts, so that its top 8 make a choice, as tests/test_torch_serve.py
# reduces it.
ARCHS = {"smollm-135m": {}, "rwkv6-1.6b": {}, "recurrentgemma-9b": {},
         "granite-moe-3b-a800m": {"n_experts": 16}}
ROOFLINE_SHAPE = (3, 5)     # each rank's tensor in ``roofline_checks``' all-gather
SERVE_TOL = 1e-4            # the served setups against (1,1), normwise (test_torch_serve.py's)


def _placements(t) -> tuple:
    return tuple(t.placements)


@contextlib.contextmanager
def recorded(calls: dict):
    """Each wrapper of ``WRAPPERS`` in ``kernels.ops`` replaced, inside the
    block, by one that adds (the type and shape of its first argument) to
    ``calls[name]`` and calls it."""
    from repro_torch.kernels import ops
    real = {name: getattr(ops, name) for name in WRAPPERS}

    def recording(name):
        def call(x, *args, **kwargs):
            calls.setdefault(name, set()).add((type(x).__name__, tuple(x.shape)))
            return real[name](x, *args, **kwargs)
        return call

    for name in WRAPPERS:
        setattr(ops, name, recording(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


def _loaded(cfg, weights):
    from repro_torch.models import init_params
    model = init_params(None, cfg, "meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()}, strict=True,
                          assign=True)
    return model


def replicas(params, mesh) -> Tuple[list, list]:
    """(the parameters replicated over some mesh dim of more than one rank,
    those whose local values differ between the ranks of such a dim): each
    such dim's ranks all-gather their local values."""
    checked, bad = [], []
    for name, p in params.named_parameters():
        local = p.to_local().detach().contiguous()
        for i, pl in enumerate(p.placements):
            if mesh.shape[i] == 1 or not pl.is_replicate():
                continue
            got = [torch.empty_like(local) for _ in range(mesh.shape[i])]
            dist.all_gather(got, local, group=mesh.get_group(i))
            checked.append(name)
            if any(not torch.equal(g, got[0]) for g in got):
                bad.append(name)
                break
    return sorted(set(checked)), bad


def train_setup(cfg, weights, batches, mesh, strategy: str, serve: bool = False) -> dict:
    """AdamW steps of ``cfg`` from ``weights`` (a state dict of numpy
    arrays in the port's names and layouts) on ``mesh`` under
    ``strategy``, one a batch, through ``make_train_step``: the losses, the
    first step's gradients as the optimizer took them (full values, numpy,
    on the mesh's first rank), every parameter and moment whose
    placements after the steps differ from ``make_shardings``', the
    parameters replicated over a mesh dim of more than one rank and those of
    them whose replicas differ after the steps, the parameters sharded
    on some mesh dim, and the types and shapes that each kernel wrapper was
    called on.  With ``serve``, also a prefill of the first batch's prompt
    from ``weights`` (and for the moe family one greedy decode step): its
    logits and caches (full values) and the wrappers' calls there."""
    from repro_torch.dist import sharding as S
    from repro_torch.train import Optimizer, TrainState, adamw, make_train_step

    base, grads = adamw(1e-3), {}

    def update(g, opt_state, params):
        """AdamW's update; the first step's gradients (placed as their
        parameters by ``make_train_step``) kept as full values."""
        if not grads:
            grads.update((n, S.full_value(t).numpy().copy()) for n, t in g.items())
        return base.update(g, opt_state, params)

    opt = Optimizer(init=base.init, update=update)
    model = _loaded(cfg, weights)
    state = TrainState(model, opt.init(dict(model.named_parameters())), 0)
    calls, out, t0 = {}, {}, time.perf_counter()
    first = mesh.get_rank() == mesh.mesh.flatten()[0].item()
    with S.sharding_strategy(strategy), S.activation_policy(mesh):
        with recorded(calls):
            want = S.make_shardings(S.train_state_specs(state, mesh, cfg), mesh)
            state = S.shard_train_state(state, mesh, cfg)
            step = make_train_step(cfg, opt)
            losses = []
            for b in batches:
                b = S.shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
        if serve:
            serve_calls = {}
            with recorded(serve_calls):
                out["serve"] = serve_setup(cfg, weights, batches[0], mesh, first)
            out["serve_calls"] = {name: sorted(c) for name, c in serve_calls.items()}
    out["seconds"] = time.perf_counter() - t0
    wrong = [n for n, p in state.params.named_parameters()
             if _placements(p) != want.params[n]]
    for key in ("m", "v"):
        wrong += [f"{key}:{n}" for n, t in state.opt_state[key].items()
                  if _placements(t) != want.opt_state[key][n]]
    replicated, unequal = replicas(state.params, mesh)
    return {**out, "losses": losses, "misplaced": wrong, "replicated": replicated,
            "unequal_replicas": unequal,
            "grads": grads if first else None,
            "calls": {name: sorted(c) for name, c in calls.items()},
            "sharded": sorted(n for n, pl in want.params.items()
                              if any(not p.is_replicate() for p in pl))}


def serve_setup(cfg, weights, batch, mesh, first: bool) -> dict:
    """Under the active strategy and policy: ``prefill`` of ``batch``'s
    first PROMPT tokens from ``weights`` placed by ``shard_params`` (its
    caches placed by ``policy_caches``), then for the moe family one
    ``decode_step`` of the greedy next tokens.  Full values (numpy, on the
    mesh's first rank): the prefill's logits and cache leaves, the decode
    step's logits and cache leaves."""
    from repro_torch.dist import sharding as S
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.transformer import leaves

    def full(logits, caches) -> dict:
        got = {"logits": S.full_value(logits)}
        for si, seg in enumerate(caches):
            for bi, tree in enumerate(seg):
                got.update((".".join((str(si), str(bi)) + path), S.full_value(t))
                           for path, t in leaves(tree))
        # copies: a replicated DTensor's full value is its local tensor, which
        # the decode step writes into
        return {k: v.numpy().copy() for k, v in got.items()} if first else None

    params = S.shard_params(_loaded(cfg, weights), mesh, cfg)
    tokens = torch.from_numpy(batch["tokens"][:, :PROMPT])
    logits, caches = prefill(params, S.shard_batch({"tokens": tokens}, mesh), cfg, MAX_LEN)
    out = {"prefill": full(logits, caches)}
    if cfg.family == "moe":
        nxt = S.full_value(logits).argmax(-1)
        logits, caches = decode_step(params, caches, S.shard_batch({"tokens": nxt}, mesh)["tokens"],
                                     PROMPT, cfg)
        out["decode"] = full(logits, caches)
    return out


def mesh_checks(world: int) -> dict:
    """A device-mode slice of the second half of the ranks as a mesh, and
    the refusals: a slice past the group, a virtual slice smaller than it."""
    from repro_torch.dist import MeshSlice, SlicePool
    pool = SlicePool(devices=[torch.device("cpu")] * world)
    pool.acquire(world // 2)
    mesh = pool.acquire(world // 2).make_mesh(AXES)
    out = {"ranks": mesh.mesh.tolist(), "shape": tuple(mesh.shape),
           "names": tuple(mesh.mesh_dim_names),
           "coordinate": None if mesh.get_coordinate() is None else tuple(mesh.get_coordinate())}
    for name, sl in (("past the group", MeshSlice(world - 2, 4, (torch.device("cpu"),) * 4)),
                     ("virtual", MeshSlice(0, world // 2))):
        try:
            sl.make_mesh(AXES)
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def refusals(world: int) -> dict:
    """On a virtual slice of the whole group (a 1-D mesh): what each kernel
    wrapper says to a DTensor, and ``constrain`` to a plain tensor under a
    policy.  {case: (exception type, message)}, or None where none was
    raised."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.dist import SlicePool
    from repro_torch.dist import sharding as S
    from repro_torch.kernels import ops
    mesh = SlicePool(n_virtual=world).acquire(world).make_mesh(("data",))
    x = distribute_tensor(torch.ones(world, 16, 2, 64), mesh, [Shard(0)])
    pos = torch.zeros(world, 16, dtype=torch.int32)
    cases = {"flash_attention": lambda: ops.flash_attention(x, x, x, pos, pos),
             "rwkv6_scan": lambda: ops.rwkv6_scan(x, x, x, x, x, x),
             "rglru_scan": lambda: ops.rglru_scan(x, x),
             "moe_router": lambda: ops.moe_router(x, 2)}

    def constrain_plain():
        with S.activation_policy(mesh):
            S.constrain(torch.ones(world, 4))

    cases["constrain"] = constrain_plain
    out = {"mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names))}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (NotImplementedError, TypeError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def roofline_checks(world: int) -> dict:
    """``launch/roofline.py``'s collective count and ``launch/mesh.py``'s
    meshes: one ``_c10d_functional.all_gather_into_tensor`` (the op DTensor
    issues) of a ``ROOFLINE_SHAPE`` tensor and its ``wait_tensor`` under
    ``step_costs``, a mesh over the group's ranks from ``make_mesh``, and
    what ``make_production_mesh`` (256 and 512 ranks) and a mesh twice the
    group's size say."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.launch.roofline import step_costs

    gathered = {}

    def gather(t):
        c10d = torch.ops._c10d_functional
        out = c10d.all_gather_into_tensor(t, world, dist.group.WORLD.group_name)
        gathered["out"] = c10d.wait_tensor(out)
        return gathered["out"]

    costs = step_costs(gather, torch.full(ROOFLINE_SHAPE, float(dist.get_rank())))
    mesh = make_mesh((world, 1), ("data", "model"))
    out = {"costs": costs, "gathered": gathered["out"].tolist(),
           "mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh.mesh.tolist())}
    for name, make in (("single", make_production_mesh),
                       ("multi", lambda: make_production_mesh(multi_pod=True)),
                       ("too wide", lambda: make_mesh((2 * world,), ("data",)))):
        try:
            make()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def run(rank: int, world: int, store: str, inputs: str, out) -> None:
    """One rank: every setup whose mesh holds this rank (those of
    SERVE_SETUPS serving too, when asked), then, when asked, the mesh,
    refusal and roofline checks.  ``inputs`` is a pickle of (cfg, weights,
    batches, setups, serve, checks), read here so that starting a rank
    sends nothing large down its pipe.  Puts (rank, results) or (rank, a
    traceback) on ``out``."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        from repro_torch.dist import SlicePool
        with open(inputs, "rb") as f:
            cfg, weights, batches, setups, serve, checks = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            pool = SlicePool(devices=[torch.device("cpu")] * world)
            results = {}
            for name, shape, strategy in setups:
                sl = pool.acquire(math.prod(shape))
                mesh = sl.make_mesh(AXES, shape)
                if mesh.get_coordinate() is not None:
                    results[name] = train_setup(cfg, weights, batches, mesh, strategy,
                                                serve=serve and name in SERVE_SETUPS)
                pool.release(sl)
            if checks:
                results["mesh"] = mesh_checks(world)
                results["refusals"] = refusals(world)
                results["roofline"] = roofline_checks(world)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, results))
    except BaseException:
        out.put((rank, traceback.format_exc()))
        raise


def spawn_ranks(tmp: Path, cfg, weights, batches, deadline_s: float, setups=SETUPS,
                world: int = WORLD, serve: bool = False, checks: bool = True,
                meanwhile: Optional[Callable[[], None]] = None) -> dict:
    """Start ``world`` ranks (``spawn``, one thread each) on ``setups``
    (with ``serve``, those of SERVE_SETUPS serving too), then ``checks``;
    call ``meanwhile()`` while they run; return {rank: results}.  Raises
    RuntimeError with the first rank's traceback, or at the deadline.  No
    rank outlives this."""
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((cfg, weights, batches, tuple(setups), serve, checks), f)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=run, daemon=True,
                         args=(r, world, str(tmp / "store"), str(inputs), out))
             for r in range(world)]
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"       # read by each rank as it starts
    try:
        for p in procs:
            p.start()
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    results, deadline = {}, time.monotonic() + deadline_s
    try:
        if meanwhile is not None:
            meanwhile()
        while len(results) < world:
            try:
                rank, got = out.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(results))} gave "
                                   f"no result within {deadline_s} s") from None
            if isinstance(got, str):
                raise RuntimeError(f"rank {rank} failed:\n{got}")
            results[rank] = got
        for p in procs:
            p.join(timeout=30)
        if any(p.is_alive() for p in procs):
            raise RuntimeError("a rank did not exit")
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def batches_for(cfg) -> list:
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    data = SyntheticLMDataset(DataConfig(global_batch=B, seq_len=S,
                                         vocab_size=cfg.vocab_size, noise=0.05))
    return [data.batch_at(i) for i in range(STEPS)]


def with_moe_impl(cfg, moe_impl: Optional[str]):
    """``cfg`` with its MoE dispatch ``moe_impl`` (``"einsum"`` or
    ``"scatter"``); as it is for None.  JAX's configs take it alike."""
    import dataclasses
    if moe_impl is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))


def reduced_config(arch: str = "smollm-135m", moe_impl: Optional[str] = None):
    """``arch``'s reduced config (``ARCHS``) on the kernels' wrappers:
    smollm-135m with remat and ``attn_impl="pallas"``; the others with
    ``kernel_impl="pallas"`` as well, their remat as reduced; an MoE
    config with the dispatch ``moe_impl`` where one is given."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = with_moe_impl(get_config(arch).reduced(**ARCHS[arch]), moe_impl)
    if arch == "smollm-135m":
        return dataclasses.replace(cfg, remat=True, attn_impl="pallas")
    return dataclasses.replace(cfg, attn_impl="pallas", kernel_impl="pallas")


def serve_gap(got: dict, ref: dict) -> Tuple[str, float]:
    """(the leaf, its largest normwise gap max |got - ref| over max(1,
    max |ref|)) of a served setup's full values against the (1,1) run's."""
    import numpy as np
    errs = {k: float(np.abs(v - ref[k]).max() / max(1.0, np.abs(ref[k]).max()))
            for k, v in got.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def main(argv=None) -> None:
    import argparse

    from repro_torch.models import init_params
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--moe-impl", choices=("einsum", "scatter"), default=None,
                    help="the MoE dispatch of granite-moe-3b-a800m (default: its config's)")
    args = ap.parse_args(argv)
    arch = args.arch
    if args.moe_impl and arch != "granite-moe-3b-a800m":
        ap.error("--moe-impl takes the moe family (granite-moe-3b-a800m)")
    cfg = reduced_config(arch, args.moe_impl)
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    weights = {k: v.numpy() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        results = spawn_ranks(Path(tmp), cfg, weights, batches_for(cfg), deadline_s=600,
                              serve=True)
    ref = results[0]["(1,1)"]["losses"]
    for name, shape, strategy in SETUPS:
        got = results[0][name]
        gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref))
        local = {k: [shape for _, shape in c] for k, c in got["calls"].items()}
        print(f"{arch} {name:14s} losses {[round(x, 6) for x in got['losses']]}  largest "
              f"relative gap from (1,1) {gap:.3g}; {len(got['sharded'])} parameters with a "
              f"Shard placement; the wrappers' local first arguments {local}; "
              f"{got['seconds']:.1f} s")
    print(f"roofline checks: step_costs of one all-gather {results[0]['roofline']['costs']}")
    served = results[0]["(1,1)"]["serve"]
    for name in SERVE_SETUPS[1:]:
        for kind, got in results[0][name]["serve"].items():
            leaf, gap = serve_gap(got, served[kind])
            print(f"{arch} {name} {kind}: largest normwise gap from (1,1) {gap:.3g} ({leaf}; "
                  f"limit {SERVE_TOL})")
            if gap > SERVE_TOL:
                raise SystemExit(f"{name} {kind} differs from (1,1) by {gap:.3g}")


if __name__ == "__main__":
    main()
