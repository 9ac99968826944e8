"""The port's sharded train step on 8 gloo ranks of the CPU.

    OMP_NUM_THREADS=1 PYTHONPATH=src python tests/_torch_sharded_worker.py

trains the reduced smollm-135m (remat, ``attn_impl="pallas"``: K1's wrapper
on each rank's shards, its plain version on the CPU) for 5 AdamW steps
from weights drawn by the port (seed 0) on a (1,1) mesh, then on (4,2)
under ``fsdp_tp`` and under ``dp_only``, and prints each setup's losses and
its largest relative gap from the (1,1) run's.  ``test_torch_multidevice.py``
runs the same ranks on JAX's weights.

Imports ``torch`` and ``repro_torch`` only: each rank is a process started
with ``spawn``, which imports this module, never the test file (that imports
``jax``).  ``run`` joins a gloo process group through a file store, builds
each setup's mesh from a device-mode ``SlicePool`` over the group's ranks,
and trains the same weights on the same batches under that setup.  Then
every rank runs the mesh, refusal and roofline checks;
``test_torch_roofline.py`` spawns 2 ranks with no setup for the last.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

AXES = ("data", "model")
WORLD, STEPS, B, S = 8, 5, 8, 64
SETUPS = [("(1,1)", (1, 1), "fsdp_tp"), ("(4,2) fsdp_tp", (4, 2), "fsdp_tp"),
          ("(4,2) dp_only", (4, 2), "dp_only")]
ROOFLINE_SHAPE = (3, 5)     # each rank's tensor in ``roofline_checks``' all-gather


def _placements(t) -> tuple:
    return tuple(t.placements)


def train_setup(cfg, weights, batches, mesh, strategy: str) -> dict:
    """AdamW steps of ``cfg`` from ``weights`` (a state dict of numpy
    arrays in the port's names and layouts) on ``mesh``
    under ``strategy``, one a batch, through ``make_train_step``: the
    losses, every parameter and moment whose placements after the steps
    differ from ``make_shardings``', the parameters sharded on some mesh
    dim, and the shapes and types that K1's wrapper was called on."""
    from repro_torch.dist import sharding as S
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import TrainState, adamw, make_train_step

    opt = adamw(1e-3)
    model = init_params(None, cfg, "meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in weights.items()}, strict=True,
                          assign=True)
    state = TrainState(model, opt.init(dict(model.named_parameters())), 0)
    seen = set()
    wrapper = ops.flash_attention

    def recording(q, *args, **kwargs):
        seen.add((type(q).__name__, tuple(q.shape)))
        return wrapper(q, *args, **kwargs)

    ops.flash_attention = recording
    try:
        with S.sharding_strategy(strategy), S.activation_policy(mesh):
            want = S.make_shardings(S.train_state_specs(state, mesh, cfg), mesh)
            state = S.shard_train_state(state, mesh, cfg)
            step = make_train_step(cfg, opt)
            losses = []
            for b in batches:
                b = S.shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
    finally:
        ops.flash_attention = wrapper
    wrong = [n for n, p in state.params.named_parameters()
             if _placements(p) != want.params[n]]
    for key in ("m", "v"):
        wrong += [f"{key}:{n}" for n, t in state.opt_state[key].items()
                  if _placements(t) != want.opt_state[key][n]]
    return {"losses": losses, "misplaced": wrong, "attention_calls": sorted(seen),
            "sharded": sorted(n for n, pl in want.params.items()
                              if any(not p.is_replicate() for p in pl))}


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
    """One rank: every setup whose mesh holds this rank, then the mesh,
    refusal and roofline checks.  ``inputs`` is a pickle of (cfg, weights, batches, setups),
    read here so that starting a rank sends nothing large down its pipe.
    Puts (rank, results) or (rank, a traceback) on ``out``."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        from repro_torch.dist import SlicePool
        with open(inputs, "rb") as f:
            cfg, weights, batches, setups = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            pool = SlicePool(devices=[torch.device("cpu")] * world)
            results = {}
            for name, shape, strategy in setups:
                sl = pool.acquire(math.prod(shape))
                mesh = sl.make_mesh(AXES, shape)
                if mesh.get_coordinate() is not None:
                    results[name] = train_setup(cfg, weights, batches, mesh, strategy)
                pool.release(sl)
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
                world: int = WORLD) -> dict:
    """Start ``world`` ranks (``spawn``, one thread each) on ``setups``;
    return {rank: results}.  Raises RuntimeError with the first rank's
    traceback, or at the deadline.  No rank outlives this."""
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((cfg, weights, batches, tuple(setups)), f)
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


def reduced_config():
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smollm-135m").reduced(), remat=True,
                               attn_impl="pallas")


def main() -> None:
    from repro_torch.models import init_params
    cfg = reduced_config()
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    weights = {k: v.numpy() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        results = spawn_ranks(Path(tmp), cfg, weights, batches_for(cfg), deadline_s=600)
    ref = results[0]["(1,1)"]["losses"]
    for name, shape, strategy in SETUPS:
        losses = results[0][name]["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        print(f"{name:14s} losses {[round(x, 6) for x in losses]}  largest relative gap "
              f"from (1,1) {gap:.3g}; {len(results[0][name]['sharded'])} parameters with a Shard placement, "
              f"K1 on local q {results[0][name]['attention_calls'][0][1]}")
    print(f"roofline checks: step_costs of one all-gather {results[0]['roofline']['costs']}")


if __name__ == "__main__":
    main()
