"""Trial, Result and Checkpoint — the paper's §3 vocabulary.

A *trial* is a single training run with a fixed initial hyperparameter
configuration; an *experiment* is a collection of trials supervised by a trial
scheduler.  Trials carry:

- ``config``     — the hyperparameter map handed to the trainable,
- ``status``     — PENDING / RUNNING / PAUSED / TERMINATED / ERROR,
- ``resources``  — the slice request (see resources.py),
- a result history (intermediate results are first-class: schedulers make
  early-stopping / cloning / mutation decisions from them),
- the latest checkpoint reference (fault tolerance is checkpoint-based; trial
  metadata itself lives in memory, per the paper §4.2).
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .clock import get_default_clock
from .resources import Resources

__all__ = ["Trial", "TrialStatus", "Result", "Checkpoint"]

_trial_counter = itertools.count()


class TrialStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def is_finished(self) -> bool:
        return self in (TrialStatus.TERMINATED, TrialStatus.ERROR)


@dataclass
class Result:
    """One intermediate (or final) report from a trial.

    ``metrics`` carries whatever the user reported (``tune.report(...)``).
    ``training_iteration`` is maintained by the framework and is the canonical
    resource/rung axis for HyperBand/ASHA/median-stopping.
    """

    trial_id: str
    training_iteration: int
    metrics: Dict[str, Any]
    # Executors stamp results from their injected Clock; the default factory
    # covers Results built outside an executor (tests, ad-hoc tooling).
    timestamp: float = field(default_factory=lambda: get_default_clock().time())
    done: bool = False

    def value(self, metric: str) -> float:
        if metric == "training_iteration":
            return float(self.training_iteration)
        v = self.metrics[metric]
        return float(v)


@dataclass
class Checkpoint:
    """A reference to saved trial state (object-store key or disk path).

    ``pinned`` marks a checkpoint a scheduler has staged for later use (e.g. a
    PBT donor awaiting exploit): the CheckpointManager's ``keep_last`` rotation
    keeps both the store entry and the disk mirror alive while it is set.
    """

    trial_id: str
    training_iteration: int
    store_key: Optional[str] = None
    path: Optional[str] = None
    pinned: bool = False

    @property
    def location(self) -> str:
        return self.store_key or self.path or "<empty>"


class Trial:
    def __init__(
        self,
        config: Dict[str, Any],
        trainable_name: str = "trainable",
        resources: Optional[Resources] = None,
        stopping_criteria: Optional[Dict[str, float]] = None,
        tag: str = "",
        trial_id: Optional[str] = None,
    ):
        self.trial_id = trial_id or f"{trainable_name}_{next(_trial_counter):05d}"
        self.trainable_name = trainable_name
        self.config = dict(config)
        self.resources = resources or Resources()
        self.stopping_criteria = dict(stopping_criteria or {})
        self.tag = tag
        self._status = TrialStatus.PENDING
        # Status-transition hook (runner's indexed ready-queue).  Installed by
        # TrialRunner.add_trial; every assignment to ``status`` notifies it, so
        # the index can never drift from the attribute.  Dropped on pickle
        # (__getstate__) — it closes over the runner.
        self._status_listener = None
        self.results: List[Result] = []
        self.checkpoint: Optional[Checkpoint] = None
        self.error: Optional[str] = None
        # Hardware profile published by the trainable (repro_torch.obs, DESIGN.md
        # §9): compile/steady step-time split, device-memory bytes, roofline
        # tag.  None until the first profiled result arrives.
        self.profile: Optional[Dict[str, Any]] = None
        self.num_failures = 0  # restarts consumed against the runner's max_failures
        self.start_time: Optional[float] = None
        # bookkeeping for schedulers (e.g. PBT perturbation history)
        self.scheduler_state: Dict[str, Any] = {}
        # Durable resume (DESIGN.md §12): virtual-clock phase target.  A
        # restored trial's worker sleeps the clock to this point before its
        # first step, so post-resume results land at the same virtual
        # timestamps — and hence in the same cross-trial order — as in the
        # uninterrupted run.  Consumed (reset to None) by the executor on the
        # trial's first post-resume step.
        self.resume_phase_t: Optional[float] = None

    # -- status ----------------------------------------------------------------
    @property
    def status(self) -> TrialStatus:
        return self._status

    @status.setter
    def status(self, value: TrialStatus) -> None:
        old = self._status
        self._status = value
        if self._status_listener is not None and old is not value:
            self._status_listener(self, old, value)

    def __getstate__(self) -> Dict[str, Any]:
        # The listener is a bound method of the owning runner — unpicklable
        # and wrong to resurrect (a resumed run re-attaches via add_trial).
        state = self.__dict__.copy()
        state["_status_listener"] = None
        return state

    # -- result bookkeeping ---------------------------------------------------
    @property
    def last_result(self) -> Optional[Result]:
        return self.results[-1] if self.results else None

    @property
    def training_iteration(self) -> int:
        return self.results[-1].training_iteration if self.results else 0

    def record_result(self, result: Result) -> None:
        self.results.append(result)

    def best_value(self, metric: str, mode: str = "max") -> Optional[float]:
        vals = [r.value(metric) for r in self.results if metric in r.metrics]
        if not vals:
            return None
        return max(vals) if mode == "max" else min(vals)

    def should_stop(self, result: Result) -> bool:
        """Check user-provided stopping criteria (e.g. max iterations, target acc)."""
        for metric, bound in self.stopping_criteria.items():
            if metric == "training_iteration":
                if result.training_iteration >= bound:
                    return True
            elif metric in result.metrics and result.value(metric) >= bound:
                return True
        return False

    def set_status(self, status: TrialStatus) -> None:
        if self.status.is_finished() and status == TrialStatus.RUNNING:
            raise RuntimeError(f"cannot restart finished trial {self.trial_id}")
        if status == TrialStatus.RUNNING and self.start_time is None:
            # Trials are constructed by user code long before an executor
            # exists, so they read the module-default clock rather than an
            # injected one — use_clock(...) places them on virtual time.
            self.start_time = get_default_clock().time()
        self.status = status

    def __repr__(self) -> str:
        return (
            f"Trial({self.trial_id}, {self.status.value}, iter={self.training_iteration}"
            + (f", tag={self.tag}" if self.tag else "")
            + ")"
        )
