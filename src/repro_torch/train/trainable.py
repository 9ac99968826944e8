"""ModelTrainable — the bridge between the model zoo and the Tune core.

Counterpart of ``repro.train.trainable``.  One Tune *trial* = one
ModelTrainable: a train step over a model config with trial hyperparameters
(lr, warmup, weight decay, optimizer choice, microbatch, ...) pulled from
``config``, on ``config["device"]`` (default ``cuda``).  Implements the
narrow-waist contract: step / save / restore / reset_config.

Two differences from JAX, both in ``save``.  JAX's arrays are immutable, so
its snapshot may share them; the port's parameters are updated in place, so
``save`` returns copies on the host, and a stored snapshot (a PBT donor, a
paused HyperBand trial) never moves with the live trial.  And the snapshot
holds numpy arrays, which ``core/checkpoint.py``'s codec takes; numpy has no
bfloat16, so a bf16 tensor is stored as its raw 16-bit pattern
(``{"bfloat16": uint16 array}``) and ``restore`` turns it back.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.api import Trainable
from ..data.pipeline import DataConfig, SyntheticLMDataset
from ..models import LM, ModelConfig, init_params, param_count
from .optimizer import adamw, linear_warmup_cosine, sgd
from .train_step import TrainState, make_train_state, make_train_step

__all__ = ["ModelTrainable", "make_model_trainable", "model_trainable_factory"]

_BF16 = "bfloat16"


def _build_optimizer(hp: Dict[str, Any], total_steps: int):
    name = hp.get("optimizer", "adamw")
    lr = float(hp.get("lr", 3e-4))
    schedule = linear_warmup_cosine(lr, int(hp.get("warmup", 10)), total_steps)
    if name == "adamw":
        return adamw(schedule,
                     b1=float(hp.get("b1", 0.9)),
                     b2=float(hp.get("b2", 0.95)),
                     weight_decay=float(hp.get("weight_decay", 0.1)),
                     grad_clip=hp.get("grad_clip", 1.0))
    if name == "sgd":
        return sgd(schedule, momentum=float(hp.get("momentum", 0.9)),
                   weight_decay=float(hp.get("weight_decay", 0.0)),
                   grad_clip=hp.get("grad_clip", None))
    raise ValueError(f"unknown optimizer {name!r}")


def _to_host(tree):
    """A copy of a nest of dicts of tensors as numpy arrays (bf16 as its
    bits); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return {_BF16: t.view(torch.int16).numpy().view(np.uint16)}
        return t.numpy()
    return tree


def _to_device(tree, device):
    """``_to_host``'s inverse, onto ``device``."""
    if isinstance(tree, dict):
        if set(tree) == {_BF16}:
            bits = np.ascontiguousarray(tree[_BF16]).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()).to(device)
    return tree


class ModelTrainable(Trainable):
    """config keys: model_cfg (ModelConfig), lr/warmup/optimizer/... (hypers),
    batch/seq_len/steps_per_iter/total_steps/data_seed (workload), device.

    Hardware profile: after every (re)build the first reported result
    carries a one-shot ``_profile`` entry in its metrics: the first step's
    time against the steady state's (each synchronised with the device),
    on the card the device memory in use and its peak (torch's CUDA memory
    statistics), and with ``profile_roofline=True`` an achieved-vs-predicted
    roofline tag from ``launch/roofline.py``, counted on a replica of the
    trial on the meta device (``_roofline_costs``).  Disable with
    ``profile=False``."""

    def setup(self, config: Dict[str, Any]) -> None:
        self.model_cfg: ModelConfig = config["model_cfg"]
        self.device = resolve_device(config.get("device", "cuda"))
        self.batch = int(config.get("batch", 8))
        self.seq_len = int(config.get("seq_len", 128))
        self.steps_per_iter = int(config.get("steps_per_iter", 5))
        self.total_steps = int(config.get("total_steps", 1000))
        self._data = SyntheticLMDataset(DataConfig(
            global_batch=self.batch, seq_len=self.seq_len,
            vocab_size=self.model_cfg.vocab_size,
            seed=int(config.get("data_seed", 0))))
        self._global_step = 0
        self._build(config)

    def _build(self, hp: Dict[str, Any], params: Optional[LM] = None) -> None:
        """Optimizer and step under ``hp``; a fresh model from ``init_seed``
        unless ``params`` are kept, and a fresh optimizer state."""
        self._opt = _build_optimizer(hp, self.total_steps)
        self._microbatch = int(hp.get("microbatch", 0))
        self._step_fn = make_train_step(self.model_cfg, self._opt, microbatch=self._microbatch)
        if params is None:
            seed = int(hp.get("init_seed", 0))
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.state = make_train_state(gen, self.model_cfg, self._opt, self.device)
        else:
            self.state = TrainState(params, self._opt.init(dict(params.named_parameters())),
                                    self.state.step)
        self._pending_profile = bool(hp.get("profile", True))
        self._profile_roofline = bool(hp.get("profile_roofline"))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- narrow-waist contract ---------------------------------------------------
    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        step_times = [] if self._pending_profile else None
        for _ in range(self.steps_per_iter):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self._data.batch_at(self._global_step).items()}
            if step_times is None:
                self.state, metrics = self._step_fn(self.state, batch)
            else:
                # Profiled iteration only: synchronous per-step timing.
                self._sync()
                p0 = time.perf_counter()
                self.state, metrics = self._step_fn(self.state, batch)
                self._sync()
                step_times.append(time.perf_counter() - p0)
            self._global_step += 1
        out = {
            "loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "grad_norm": float(metrics["grad_norm"]),
            "step": self._global_step,
            "steps_per_s": self.steps_per_iter / max(time.time() - t0, 1e-9),
        }
        if step_times:
            self._pending_profile = False
            out["_profile"] = self._make_profile(step_times)
        return out

    def _make_profile(self, step_times) -> Dict[str, Any]:
        first = step_times[0]
        steady = min(step_times[1:]) if len(step_times) > 1 else first
        prof: Dict[str, Any] = {
            "first_step_s": round(first, 6),
            "steady_step_s": round(steady, 6),
            # no compile step: the first step's extra time (kernel builds,
            # allocator warm-up) stands where JAX's compile time stands
            "compile_s": round(max(0.0, first - steady), 6),
            "param_count": int(param_count(self.state.params)),
            "batch": self.batch,
            "seq_len": self.seq_len,
        }
        if self.device.type == "cuda":
            prof["device_bytes_in_use"] = int(torch.cuda.memory_allocated(self.device))
            prof["device_peak_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        if self._profile_roofline:
            try:
                from ..launch.roofline import analyze
                costs = self._roofline_costs()
                for key in ("arg_bytes", "temp_bytes", "output_bytes"):
                    prof[key] = int(costs[key])
                rep = analyze(
                    arch=self.model_cfg.arch_id, shape_name="trial",
                    mesh_name="local", chips=1, costs=costs,
                    n_params_active=int(param_count(self.state.params)),
                    n_tokens=self.batch * self.seq_len, kind="train",
                    arg_bytes=prof["arg_bytes"], temp_bytes=prof["temp_bytes"],
                    output_bytes=prof["output_bytes"])
                prof["predicted_step_s"] = round(rep.step_time_s, 6)
                prof["dominant"] = rep.dominant
                prof["roofline_compute_s"] = round(rep.compute_s, 6)
                prof["roofline_memory_s"] = round(rep.memory_s, 6)
                prof["roofline_collective_s"] = round(rep.collective_s, 6)
                if rep.step_time_s > 0:
                    prof["achieved_vs_predicted"] = round(
                        steady / rep.step_time_s, 4)
            except Exception as e:  # best-effort decoration, never a crash
                prof["roofline_error"] = f"{type(e).__name__}: {e}"
        return prof

    def _roofline_costs(self) -> Dict[str, float]:
        """``step_costs`` of one step of this trial: its config without
        kernels (``kernel_free``), a model on the meta device, the trial's
        optimizer's state, a meta batch of the trial's shapes and dtypes and
        its microbatching.  The live state, its random generators and the
        device are not touched, and no kernel is launched."""
        from ..launch.roofline import kernel_free, step_costs
        cfg = kernel_free(self.model_cfg)
        params = init_params(None, cfg, "meta")
        state = TrainState(params, self._opt.init(dict(params.named_parameters())),
                           self.state.step)
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
                 for k, v in self._data.batch_at(0).items()}
        return step_costs(make_train_step(cfg, self._opt, self._microbatch), state, batch)

    def save(self) -> Any:
        st = self.state
        return {
            "state": {"params": _to_host(dict(st.params.named_parameters())),
                      "opt_state": _to_host(st.opt_state), "step": st.step},
            "global_step": self._global_step,
        }

    def restore(self, snapshot: Any) -> None:
        st = snapshot["state"]
        params = self.state.params
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(_to_device(st["params"][name], self.device))
        opt_state = _to_device(st["opt_state"], self.device)
        # A PBT mutation may have switched optimizer family: if the donor's
        # opt_state does not match this trainable's optimizer, re-init it
        # (params are what cloning is about; moments restart harmlessly).
        if set(opt_state) != set(self.state.opt_state):
            opt_state = self._opt.init(dict(params.named_parameters()))
        self.state = TrainState(params, opt_state, int(st["step"]))
        self._global_step = int(snapshot["global_step"])

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """PBT mutation: rebuild optimizer/step under new hypers, keep params."""
        self.config = dict(new_config)
        self._build(new_config, params=self.state.params)
        return True


def make_model_trainable(model_cfg: ModelConfig, **workload) -> type:
    """Bind a model config (and workload sizes) into a Trainable subclass."""
    defaults = dict(workload)

    class Bound(ModelTrainable):
        def setup(self, config: Dict[str, Any]) -> None:
            merged = {**defaults, "model_cfg": model_cfg, **config}
            super().setup(merged)

    Bound.__name__ = f"ModelTrainable[{model_cfg.arch_id}]"
    return Bound


def model_trainable_factory(model_cfg: ModelConfig, **workload):
    """Spawn-safe recipe for ``make_model_trainable`` — process workers rebuild
    the bound class in the child by re-importing this module and calling
    ``make_model_trainable(model_cfg, **workload)`` there (the class returned
    by ``make_model_trainable`` itself is function-local, so it cannot be
    pickled across a spawn boundary).  ``model_cfg`` and the workload kwargs,
    ``device`` among them, ride along as pickled plain data."""
    from ..core.workers import TrainableFactory

    return TrainableFactory(
        # this package's module: the original's target names the JAX one
        target="repro_torch.train.trainable:make_model_trainable",
        kwargs={"model_cfg": model_cfg, **workload},
        call=True,
    )
