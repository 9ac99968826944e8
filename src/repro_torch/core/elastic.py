"""Elastic resource control plane — checkpoint-boundary slice resize and
bounded result lookahead (DESIGN.md §6).

The SlicePool decouples trials from devices, but through PR 3 a trial's slice
was fixed for its whole life: capacity freed by early-stopped trials sat idle
while big survivors stayed small — exactly the utilization gap ASHA-style
aggressive early stopping creates.  This module closes it with a small
control plane layered *on top of* the executors, never inside them:

- ``ResourceBroker`` rides the runner's event loop.  At every checkpoint
  boundary — the moment a trial's worker is parked waiting for the
  scheduler's CONTINUE — it asks a ``ResizePolicy`` whether the trial's
  ``MeshSlice`` should grow or shrink, and drives the executor's resize
  protocol (SAVE → swap slice in the pool → rebuild mesh + re-shard →
  RESTORE onto the new sub-mesh).  A failed rebuild rolls back to the exact
  old device range; the trial never observes a torn state.
- The same broker issues **lookahead credits**: how many un-consumed results
  a worker may run ahead of the scheduler.  ``k > 1`` removes a control-plane
  round-trip (a pipe RTT, for process workers) from every step of a
  throughput-bound sweep.  Exactness is preserved automatically: the broker
  consults ``Scheduler.decision_interval()`` and clamps credits to 1 whenever
  the scheduler can stop/pause/perturb trials (ASHA, HyperBand, PBT,
  MedianStopping); only pure run-to-completion schedulers (FIFO, interval 0)
  get the full requested lookahead.

Policies are deliberately dumb and pluggable — they see the runner, the pool
stats (``utilization``/``largest_free_block``/``fragments``) and the trial's
current slice, and return a target size or None.  All actual mutation stays
on the runner thread inside the executor, so the threading contracts of
DESIGN.md §4/§5 are untouched.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, TYPE_CHECKING

from .clock import Clock, get_default_clock
from .events import EventType, TrialEvent
from .trial import Trial, TrialStatus

if TYPE_CHECKING:  # pragma: no cover
    from .runner import TrialRunner

__all__ = ["ResizePolicy", "GreedyFill", "FairShare", "ResourceBroker",
           "resolve_policy"]


class ResizePolicy:
    """Decides a trial's target slice size at a checkpoint boundary.

    ``propose`` is called on the runner thread for a RUNNING trial whose
    worker is parked (idle at the resume gate), with the live pool and the
    trial's currently held slice.  Return the desired device count, or None
    to leave the trial alone.  Feasibility should be checked with
    ``pool.can_resize`` — proposing the impossible just burns a
    RESIZE_FAILED event.
    """

    name = "policy"

    def propose(self, runner: "TrialRunner", trial: Trial,
                pool: Any, sl: Any) -> Optional[int]:
        raise NotImplementedError


class GreedyFill(ResizePolicy):
    """Survivors absorb freed devices: double a RUNNING trial's slice while
    the pool can host the growth.

    Growth is gated on a scheduler survival signal: a trial must have
    advanced past the scheduler's grace period (ASHA/median ``grace_period``;
    1 otherwise) before it is considered a survivor worth feeding — capacity
    freed at the first rung cut should flow to trials that outlived the cut,
    not to whichever straggler reported first.  One doubling per checkpoint
    boundary keeps the absorb gradual and the rebuild cost amortized.
    """

    name = "greedy"

    def __init__(self, factor: int = 2, max_devices: Optional[int] = None):
        if factor < 2:
            raise ValueError("growth factor must be >= 2")
        self.factor = factor
        self.max_devices = max_devices

    def propose(self, runner, trial, pool, sl):
        survived_t = int(getattr(runner.scheduler, "grace_period", 1) or 1)
        if trial.training_iteration < survived_t:
            return None
        cap = min(self.max_devices or pool.n_total, pool.n_total)
        target = sl.size * self.factor
        if target > cap or not pool.can_resize(sl, target):
            return None
        return target


class FairShare(ResizePolicy):
    """Rebalance the pool equally across RUNNING trials.

    Target = ``n_total // n_running`` rounded down to a power of two (mesh
    shapes and sharding divisibility like powers of two), floored at
    ``min_devices``.  Shrinks oversized trials as eagerly as it grows
    undersized ones, so a late-arriving PENDING trial can be placed at the
    next boundary instead of waiting for a survivor to finish.
    """

    name = "fair"

    def __init__(self, min_devices: int = 1, round_pow2: bool = True):
        self.min_devices = max(1, int(min_devices))
        self.round_pow2 = round_pow2

    def propose(self, runner, trial, pool, sl):
        running = sum(1 for t in runner.trials if t.status == TrialStatus.RUNNING)
        # Trials waiting for capacity count toward the denominator: the fair
        # share must leave room for them to actually launch.
        waiting = sum(1 for t in runner.trials
                      if t.status in (TrialStatus.PENDING, TrialStatus.PAUSED))
        share = pool.n_total // max(1, running + waiting)
        if self.round_pow2 and share >= 1:
            p = 1
            while p * 2 <= share:
                p *= 2
            share = p
        share = max(self.min_devices, share)
        if share == sl.size:
            return None
        if share > sl.size and not pool.can_resize(sl, share):
            return None
        return share


_POLICIES: Dict[str, type] = {"greedy": GreedyFill, "fair": FairShare}


def resolve_policy(spec: Any) -> Optional[ResizePolicy]:
    """``None``/``"off"`` -> None; a ResizePolicy instance passes through; a
    name ("greedy"/"fair") builds the default-configured policy."""
    if spec is None or spec == "off":
        return None
    if isinstance(spec, ResizePolicy):
        return spec
    try:
        return _POLICIES[spec]()
    except KeyError:
        raise ValueError(
            f"unknown elastic policy {spec!r}; pass 'off', 'greedy', 'fair', "
            f"or a ResizePolicy instance") from None


class ResourceBroker:
    """The elastic control plane: one per TrialRunner, driven on its thread.

    ``bind`` installs the effective lookahead on the executor (computed from
    the scheduler's declared decision granularity), ``observe`` watches the
    event stream for bookkeeping, and ``before_resume`` is the checkpoint
    boundary hook — the runner calls it right before re-opening a trial's
    resume gate, which is the only moment a RUNNING trial's worker is
    guaranteed parked and resizable.
    """

    def __init__(self, policy: Optional[ResizePolicy] = None,
                 lookahead: int = 1, clock: Optional[Clock] = None):
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        self.policy = policy
        self.lookahead = int(lookahead)
        self.clock = clock  # None = adopt the executor's clock at bind()
        self.effective_lookahead = 1
        self.decision_interval = 1
        self.n_resized = 0
        self.n_resize_failed = 0
        self.n_events = 0
        self._runner: Optional["TrialRunner"] = None
        self._announced: set = set()  # trial_ids whose credit grant was logged

    # -- wiring ---------------------------------------------------------------------
    def bind(self, runner: "TrialRunner") -> None:
        self._runner = runner
        if self.clock is None:
            # The broker's CREDITS/RESIZED events go straight to the loggers
            # (never through a bus that would stamp them), so they must share
            # the executor's time axis to sort against bus events.
            self.clock = getattr(runner.executor, "clock", None) or get_default_clock()
        self.decision_interval = int(runner.scheduler.decision_interval())
        # Exactness rule: any scheduler that can stop/pause/perturb (nonzero
        # interval) gets k=1, so every decision is made on a parked worker and
        # elastic runs reproduce the serial tier's decisions exactly.  Pure
        # run-to-completion schedulers get the full requested lookahead.
        self.effective_lookahead = (self.lookahead
                                    if self.decision_interval == 0 else 1)
        runner.executor.set_lookahead(self.effective_lookahead)

    # -- event-loop hooks -------------------------------------------------------------
    def observe(self, runner: "TrialRunner", event: TrialEvent) -> None:
        """Extension point: every bus event flows through here before the
        runner acts on it, so a stateful broker/policy subclass can track
        e.g. stop rates or per-trial progress.  The base broker only counts
        events for ``debug_string``."""
        self.n_events += 1

    def before_resume(self, runner: "TrialRunner", trial: Trial) -> None:
        """Checkpoint-boundary hook: the scheduler said CONTINUE and the
        trial's worker is parked.  Announce the credit grant once, then let
        the policy propose a resize."""
        if (trial.trial_id not in self._announced
                and (self.lookahead != 1 or self.effective_lookahead != 1)):
            self._announced.add(trial.trial_id)
            runner.logger.on_event(trial, TrialEvent(
                EventType.CREDITS, trial.trial_id,
                info={"requested": self.lookahead,
                      "granted": self.effective_lookahead,
                      "decision_interval": self.decision_interval},
                timestamp=self.clock.time()))
        if self.policy is None:
            return
        ex = runner.executor
        # Per-trial pool when the executor places across hosts (cluster tier);
        # the shared pool otherwise.  Rebalancing stays within one failure
        # domain — slices never span hosts.
        pool_fn = getattr(ex, "_pool_for", None)
        pool = (pool_fn(trial) if callable(pool_fn)
                else getattr(ex, "slice_pool", None))
        if pool is None or not ex.trial_idle(trial):
            return
        sl = ex.held_slice(trial.trial_id)
        if sl is None:
            return
        target = self.policy.propose(runner, trial, pool, sl)
        if target is None or target == sl.size:
            return
        from_devices = sl.size
        tracer = runner.obs.tracer
        if tracer.enabled:
            with tracer.span("resize", trial.trial_id, cat="elastic",
                             from_devices=from_devices, to_devices=target,
                             policy=self.policy.name) as sp:
                ok = ex.resize_trial(trial, target)
                sp.arg("ok", ok)
        else:
            ok = ex.resize_trial(trial, target)
        m = runner.obs.metrics
        info = {"from_devices": from_devices, "to_devices": target,
                "policy": self.policy.name,
                "utilization": round(pool.utilization(), 3),
                "holes": pool.fragments(),
                "largest_free_block": pool.largest_free_block()}
        if ok:
            self.n_resized += 1
            if m is not None:
                m.counter("trials.resized").inc()
            runner.logger.on_event(trial, TrialEvent(
                EventType.RESIZED, trial.trial_id, info=info,
                timestamp=self.clock.time()))
        else:
            self.n_resize_failed += 1
            if m is not None:
                m.counter("trials.resize_failed").inc()
            runner.logger.on_event(trial, TrialEvent(
                EventType.RESIZE_FAILED, trial.trial_id, info=info,
                timestamp=self.clock.time()))

    def debug_string(self) -> str:
        return (f"ResourceBroker(policy={self.policy.name if self.policy else 'off'}, "
                f"lookahead={self.effective_lookahead}/{self.lookahead}, "
                f"resized={self.n_resized}, failed={self.n_resize_failed}, "
                f"events={self.n_events})")
