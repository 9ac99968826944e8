"""VmapExecutor — beyond-paper: model selection as a single SPMD program.

Ray Tune runs each trial as its own actor/process; on an accelerator that
wastes the device whenever trials are shape-homogeneous (identical
model/batch, different scalar hyperparameters — the common case for
lr/momentum/wd sweeps).  Here N live trials are STACKED: parameters and
optimizer states become (N, ...) tensors and one ``torch.func.vmap``-over-
hyperparameters step advances every trial at once, each kernel launched once
for all lanes.

Scheduling semantics are preserved exactly: each tick yields one Result per
live lane into the runner's event queue; PAUSE/STOP mask a lane out (its state
slot is retained for checkpoint/restore); PBT clone copies lane i's slice onto
lane j.  Lanes are compacted lazily: a stopped lane is recycled for the next
PENDING trial, and the stacked step runs over all N lanes, live or not.

Contract: the user supplies a ``VectorTrainableSpec`` —
    init_fn(seed, hypers)        -> state (nested dicts of tensors; one trial)
    step_fn(state, hypers)       -> (new state, metrics dict of scalar tensors)
    hyper_names: the scalar hyperparameter names vmap maps over.

``step_fn`` must return new tensors and never update its state in place: the
executor owns the stacked state and writes a lane's slice into it only when
a trial starts, resumes or is cloned.  Hyperparameters reach ``step_fn`` as
fp32 tensors on the state's device.  Checkpoints hold host numpy copies (bf16
as its raw bits), as ``ModelTrainable``'s do, so a stored snapshot never moves
with the live lane.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..train.trainable import _to_device, _to_host
from .checkpoint import CheckpointManager
from .executor import TrialExecutor
from .resources import ResourceAccountant
from .trial import Checkpoint, Result, Trial, TrialStatus

__all__ = ["VectorTrainableSpec", "VmapExecutor"]


@dataclasses.dataclass(frozen=True)
class VectorTrainableSpec:
    init_fn: Callable[[int, Dict[str, float]], Any]
    step_fn: Callable[[Any, Dict[str, torch.Tensor]], Tuple[Any, Dict[str, torch.Tensor]]]
    hyper_names: Tuple[str, ...]
    steps_per_iter: int = 1


class VmapExecutor(TrialExecutor):
    def __init__(
        self,
        spec: VectorTrainableSpec,
        checkpoint_manager: CheckpointManager,
        n_lanes: int = 8,
        total_cpu: float = 64.0,
        total_devices: int = 256,
        checkpoint_freq: int = 1,
    ):
        self.spec = spec
        self.ckpt = checkpoint_manager
        self.n_lanes = n_lanes
        self.accountant = ResourceAccountant(total_cpu, total_devices)
        self.checkpoint_freq = checkpoint_freq

        self._lane_trial: List[Optional[Trial]] = [None] * n_lanes
        self._iterations: List[int] = [0] * n_lanes
        self._stacked: Any = None          # (N, ...) state
        self._hypers: Dict[str, np.ndarray] = {
            name: np.zeros(n_lanes, np.float64) for name in spec.hyper_names}
        self._pending_events: deque = deque()

        def one_step(state, hypers):
            for _ in range(spec.steps_per_iter):
                state, metrics = spec.step_fn(state, hypers)
            return state, metrics

        self._vstep = torch.func.vmap(one_step)

    # -- helpers -----------------------------------------------------------------
    def _free_lane(self) -> Optional[int]:
        for i, t in enumerate(self._lane_trial):
            if t is None:
                return i
        return None

    def _lane_of(self, trial: Trial) -> Optional[int]:
        for i, t in enumerate(self._lane_trial):
            if t is not None and t.trial_id == trial.trial_id:
                return i
        return None

    def _device(self) -> torch.device:
        return pytree.tree_leaves(self._stacked)[0].device

    def _lane_state(self, lane: int) -> Any:
        return pytree.tree_map(lambda x: x[lane], self._stacked)

    def _set_lane_state(self, lane: int, state: Any) -> None:
        """Copy ``state`` into the lane's slice of the executor's own stacked
        tensors; ``state`` itself is never written."""
        with torch.no_grad():
            pytree.tree_map(lambda full, s: full[lane].copy_(s), self._stacked, state)

    def _restore(self, checkpoint: Checkpoint) -> Dict[str, Any]:
        """The snapshot of ``checkpoint``; its state stays on the host until
        ``_set_lane_state`` copies it into a lane."""
        snap = self.ckpt.restore(checkpoint)
        return {"state": _to_device(snap["state"], "cpu"), "iteration": snap["iteration"]}

    def _hyper_dict(self, trial: Trial) -> Dict[str, float]:
        return {k: float(trial.config[k]) for k in self.spec.hyper_names}

    # -- TrialExecutor interface ---------------------------------------------------
    def has_resources(self, trial: Trial) -> bool:
        return self._free_lane() is not None and self.accountant.has_room(trial.resources)

    def has_running(self) -> bool:
        return any(t is not None for t in self._lane_trial)

    def start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None) -> bool:
        lane = self._free_lane()
        if lane is None:
            return False
        self.accountant.acquire(trial.resources)
        hypers = self._hyper_dict(trial)
        seed = int(trial.config.get("init_seed", 0))
        if checkpoint is not None:
            snap = self._restore(checkpoint)
            state = snap["state"]
            self._iterations[lane] = snap["iteration"]
        else:
            state = self.spec.init_fn(seed, hypers)
            self._iterations[lane] = 0
        if self._stacked is None:
            # the spec's own state places the stack, not a snapshot's host copy
            first = state if checkpoint is None else self.spec.init_fn(seed, hypers)
            self._stacked = pytree.tree_map(
                lambda x: torch.stack([x] * self.n_lanes), first)
            if checkpoint is not None:
                self._set_lane_state(lane, state)
        else:
            self._set_lane_state(lane, state)
        for k, v in hypers.items():
            self._hypers[k][lane] = v
        self._lane_trial[lane] = trial
        trial.set_status(TrialStatus.RUNNING)
        return True

    def save_checkpoint(self, trial: Trial) -> Checkpoint:
        lane = self._lane_of(trial)
        snap = {"state": _to_host(self._lane_state(lane)),
                "iteration": self._iterations[lane]}
        ckpt = self.ckpt.save(trial.trial_id, self._iterations[lane], snap)
        trial.checkpoint = ckpt
        return ckpt

    def pause_trial(self, trial: Trial) -> None:
        lane = self._lane_of(trial)
        if lane is not None:
            self.save_checkpoint(trial)
            self._lane_trial[lane] = None
            self.accountant.release(trial.resources)
        trial.set_status(TrialStatus.PAUSED)

    def stop_trial(self, trial: Trial, error: Optional[str] = None) -> None:
        lane = self._lane_of(trial)
        if lane is not None:
            self._lane_trial[lane] = None
            self.accountant.release(trial.resources)
        if error:
            trial.error = error
            trial.set_status(TrialStatus.ERROR)
        else:
            trial.set_status(TrialStatus.TERMINATED)

    def requeue_trial(self, trial: Trial) -> None:
        lane = self._lane_of(trial)
        if lane is not None:
            self._lane_trial[lane] = None
            self.accountant.release(trial.resources)
        trial.set_status(
            TrialStatus.PAUSED if trial.checkpoint is not None else TrialStatus.PENDING)

    def restart_trial_with_config(self, trial, checkpoint, new_config) -> None:
        """PBT exploit: load donor snapshot into this trial's lane with the
        mutated hypers — an O(1) lane-slice copy, no process churn."""
        trial.config = dict(new_config)
        lane = self._lane_of(trial)
        snap = self._restore(checkpoint)
        if lane is None:
            self.start_trial(trial)
            lane = self._lane_of(trial)
        self._set_lane_state(lane, snap["state"])
        self._iterations[lane] = snap["iteration"]
        for k in self.spec.hyper_names:
            self._hypers[k][lane] = float(new_config[k])

    def get_next_result(self) -> Optional[Tuple[Trial, Any]]:
        if self._pending_events:
            return self._pending_events.popleft()
        live = [i for i, t in enumerate(self._lane_trial) if t is not None]
        if not live:
            return None
        dev = self._device()
        hypers = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for k, v in self._hypers.items()}
        try:
            self._stacked, metrics = self._vstep(self._stacked, hypers)
        except Exception as e:  # noqa: BLE001
            trial = self._lane_trial[live[0]]
            return trial, e
        metrics_np = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        for lane in live:
            trial = self._lane_trial[lane]
            self._iterations[lane] += 1
            result = Result(
                trial_id=trial.trial_id,
                training_iteration=self._iterations[lane],
                metrics={k: float(v[lane]) for k, v in metrics_np.items()},
            )
            if self.checkpoint_freq and self._iterations[lane] % self.checkpoint_freq == 0:
                self.save_checkpoint(trial)
            self._pending_events.append((trial, result))
        return self._pending_events.popleft()

    def shutdown(self) -> None:
        for i, t in enumerate(self._lane_trial):
            if t is not None:
                self.accountant.release(t.resources)
            self._lane_trial[i] = None
        self._stacked = None    # the lanes' device memory goes with the sweep
