"""HyperBand — original synchronous formulation (Li et al. 2016; Table 1: 215 LoC).

Brackets s = s_max..0 with n(s) = ceil((s_max+1)/(s+1) * eta^s) trials starting
at r(s) = R * eta^-s resource.  Within a bracket, successive-halving rounds are
*synchronous*: every live trial must reach the round's milestone (we PAUSE those
that arrive early — this exercises checkpoint/pause/resume through the narrow
interface), then the top 1/eta continue and the rest are stopped.

This is exactly the pause-capable behaviour the paper argues systems treating a
trial as an atomic unit (Spearmint/HyperOpt/TuPAQ) cannot express (§2).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..trial import Result, Trial, TrialStatus
from .base import SchedulerDecision, TrialScheduler

__all__ = ["HyperBandScheduler"]


class _SyncBracket:
    def __init__(self, s: int, s_max: int, R: int, eta: int):
        self.eta = eta
        self.capacity = int(math.ceil((s_max + 1) / (s + 1) * eta**s))
        self.r0 = max(1, int(R * eta**-s))
        self.R = R
        self.round = 0
        self.trials: List[Trial] = []          # live (not yet cut) members
        self.arrived: Dict[str, float] = {}    # trial_id -> score at current milestone
        self.finished = False

    @property
    def milestone(self) -> int:
        return min(self.R, self.r0 * self.eta**self.round)

    @property
    def full(self) -> bool:
        return len(self.trials) >= self.capacity

    def add(self, trial: Trial) -> None:
        self.trials.append(trial)

    def record(self, trial: Trial, score: float) -> None:
        self.arrived[trial.trial_id] = score

    def ready_to_cut(self) -> bool:
        # Cut when every live member (incl. not-yet-started PENDING members,
        # which haven't arrived) has recorded at the milestone.  Capacity need
        # not be reached: an underfull bracket (fewer trials than n(s)) would
        # otherwise wait forever for members that will never be added.
        live = [t for t in self.trials if not t.status.is_finished()]
        return bool(live) and all(t.trial_id in self.arrived for t in live)

    def cut(self) -> Dict[str, bool]:
        """Perform one halving round. Returns trial_id -> keep?"""
        live = [t for t in self.trials if not t.status.is_finished()]
        n_keep = max(1, int(len(live) / self.eta))
        ranked = sorted(live, key=lambda t: self.arrived[t.trial_id], reverse=True)
        keep = {t.trial_id: (i < n_keep) for i, t in enumerate(ranked)}
        self.trials = [t for t in ranked if keep[t.trial_id]]
        self.arrived.clear()
        self.round += 1
        if self.milestone >= self.R and self.round > 0 and len(self.trials) <= 1:
            pass  # final round: survivors run to R then terminate via max_t
        return keep

    def state_dict(self) -> Dict[str, Any]:
        # Trials are serialized by id: load_state_dict takes an id->Trial
        # resolver because live Trial objects don't survive a JSON round-trip.
        return {"eta": self.eta, "capacity": self.capacity, "r0": self.r0,
                "R": self.R, "round": self.round,
                "trial_ids": [t.trial_id for t in self.trials],
                "arrived": dict(self.arrived), "finished": self.finished}

    def load_state_dict(self, state: Dict[str, Any],
                        trials: Optional[Dict[str, Trial]] = None) -> None:
        self.round = int(state["round"])
        self.arrived = {str(k): float(v) for k, v in state["arrived"].items()}
        self.finished = bool(state["finished"])
        if trials is not None:
            self.trials = [trials[tid] for tid in state["trial_ids"]
                           if tid in trials]


class HyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        max_t: int = 81,
        eta: int = 3,
    ):
        super().__init__(metric=metric, mode=mode)
        self.max_t = max_t
        self.eta = eta
        self.s_max = int(math.log(max_t) / math.log(eta))
        self._brackets: List[_SyncBracket] = []
        self._trial_bracket: Dict[str, _SyncBracket] = {}
        self._next_s = self.s_max
        self._promote: List[str] = []  # trial_ids cleared to resume after a cut
        self.n_stopped = 0

    def decision_interval(self) -> int:
        # Synchronous halving pauses trials at bracket milestones; any result
        # may be the milestone arrival, so exact mode needs lookahead 1.
        return 1

    # -- bracket assignment -----------------------------------------------------
    def _open_bracket(self) -> _SyncBracket:
        b = _SyncBracket(self._next_s, self.s_max, self.max_t, self.eta)
        self._brackets.append(b)
        self._next_s = self._next_s - 1 if self._next_s > 0 else self.s_max
        return b

    def on_trial_add(self, runner, trial: Trial) -> None:
        bracket = next((b for b in self._brackets if not b.full), None) or self._open_bracket()
        bracket.add(trial)
        self._trial_bracket[trial.trial_id] = bracket

    def holds_trial(self, trial_id: str) -> bool:
        # A milestone-waiter (recorded in its bracket's ``arrived``) must stay
        # PAUSED until the synchronous cut fires — relaunching it early (e.g.
        # from the durable-resume queue) would let it run past the milestone
        # before the bracket decides who survives.
        bracket = self._trial_bracket.get(trial_id)
        return bracket is not None and trial_id in bracket.arrived

    # -- result handling ----------------------------------------------------------
    def _cut_records(self, bracket: _SyncBracket, keep: Dict[str, bool],
                     arrived: Dict[str, float], milestone: int,
                     rnd: int) -> Dict[str, Dict[str, Any]]:
        """Per-trial provenance for one halving round (DESIGN.md §10).

        Returns trial_id -> inputs dict: rank within the round's ranking,
        score, and the score of the last kept trial (the effective cut line).
        """
        ranked = sorted(keep, key=lambda tid: arrived.get(tid, float("-inf")),
                        reverse=True)
        n_keep = sum(1 for v in keep.values() if v)
        cut_score = (arrived.get(ranked[n_keep - 1], float("-inf"))
                     if n_keep else float("-inf"))
        b_idx = self._brackets.index(bracket)
        return {tid: {"milestone": milestone, "round": rnd, "bracket": b_idx,
                      "rank": i, "n_keep": n_keep, "n_live": len(ranked),
                      "score": arrived.get(tid), "cut_score": cut_score}
                for i, tid in enumerate(ranked)}

    def on_result(self, runner, trial: Trial, result: Result) -> SchedulerDecision:
        if result.training_iteration >= self.max_t:
            self._record_decision(trial.trial_id, SchedulerDecision.STOP,
                                  iteration=result.training_iteration,
                                  reason="max_t", max_t=self.max_t)
            return SchedulerDecision.STOP
        bracket = self._trial_bracket[trial.trial_id]
        if result.training_iteration < bracket.milestone:
            return SchedulerDecision.CONTINUE

        bracket.record(trial, self._score(result.value(self.metric)))
        if not bracket.ready_to_cut():
            # Wait (paused, checkpointed) for bracket peers to reach the milestone.
            live = [t for t in bracket.trials if not t.status.is_finished()]
            self._record_decision(
                trial.trial_id, SchedulerDecision.PAUSE,
                iteration=result.training_iteration, reason="milestone_wait",
                milestone=bracket.milestone, round=bracket.round,
                bracket=self._brackets.index(bracket),
                n_arrived=len(bracket.arrived), n_live=len(live))
            return SchedulerDecision.PAUSE

        arrived = dict(bracket.arrived)
        milestone, rnd = bracket.milestone, bracket.round
        keep = bracket.cut()
        records = self._cut_records(bracket, keep, arrived, milestone, rnd)
        my_decision = SchedulerDecision.PAUSE
        for t in runner.trials:
            verdict = keep.get(t.trial_id)
            if verdict is None:
                continue
            if t.trial_id == trial.trial_id:
                my_decision = (
                    SchedulerDecision.CONTINUE if verdict else SchedulerDecision.STOP
                )
                self._record_decision(t.trial_id, my_decision,
                                      iteration=result.training_iteration,
                                      reason="cut", **records[t.trial_id])
                if not verdict:
                    self.n_stopped += 1
            elif verdict:
                self._record_decision(t.trial_id, "PROMOTE", reason="cut",
                                      **records[t.trial_id])
                self._promote.append(t.trial_id)
            else:
                if t.status == TrialStatus.PAUSED:
                    self._record_decision(t.trial_id, SchedulerDecision.STOP,
                                          reason="cut", **records[t.trial_id])
                    runner.stop_trial(t)
                    self.n_stopped += 1
        return my_decision

    def on_trial_error(self, runner, trial: Trial) -> None:
        bracket = self._trial_bracket.get(trial.trial_id)
        if not bracket:
            return
        bracket.arrived.pop(trial.trial_id, None)
        bracket.trials = [t for t in bracket.trials if t.trial_id != trial.trial_id]
        # The error may have been the peer everyone was waiting on — re-check.
        if bracket.ready_to_cut():
            arrived = dict(bracket.arrived)
            milestone, rnd = bracket.milestone, bracket.round
            keep = bracket.cut()
            records = self._cut_records(bracket, keep, arrived, milestone, rnd)
            for t in runner.trials:
                verdict = keep.get(t.trial_id)
                if verdict is None:
                    continue
                if verdict:
                    self._record_decision(t.trial_id, "PROMOTE",
                                          reason="cut_after_error",
                                          **records[t.trial_id])
                    self._promote.append(t.trial_id)
                elif t.status == TrialStatus.PAUSED:
                    self._record_decision(t.trial_id, SchedulerDecision.STOP,
                                          reason="cut_after_error",
                                          **records[t.trial_id])
                    runner.stop_trial(t)
                    self.n_stopped += 1

    def state_dict(self) -> Dict[str, Any]:
        return {
            "brackets": [b.state_dict() for b in self._brackets],
            "trial_bracket": {tid: self._brackets.index(b)
                              for tid, b in self._trial_bracket.items()},
            "next_s": self._next_s,
            "promote": list(self._promote),
            "n_stopped": self.n_stopped,
        }

    def load_state_dict(self, state: Dict[str, Any],
                        trials: Optional[Dict[str, Trial]] = None) -> None:
        # Rebuild bracket shells in recorded order, then restore their state.
        self._brackets = []
        self._next_s = self.s_max
        for bs in state["brackets"]:
            b = self._open_bracket()
            b.load_state_dict(bs, trials=trials)
        self._trial_bracket = {str(tid): self._brackets[int(i)]
                               for tid, i in state["trial_bracket"].items()}
        self._next_s = int(state["next_s"])
        self._promote = [str(t) for t in state["promote"]]
        self.n_stopped = int(state["n_stopped"])

    # -- trial selection ----------------------------------------------------------
    def choose_trial_to_run(self, runner) -> Optional[Trial]:
        # 1. resume survivors of a cut
        while self._promote:
            tid = self._promote[0]
            t = runner.get_trial(tid)
            if t is None or t.status != TrialStatus.PAUSED:
                self._promote.pop(0)  # already resumed or finished
                continue
            if runner.has_resources(t):
                return t
            break  # keep queued until resources free up
        # 2. new pending trials
        t = runner.next_ready(TrialStatus.PENDING)
        if t is not None:
            return t
        # 3. crash-requeued members (max_failures retry): PAUSED *without* a
        # recorded milestone arrival is not waiting on a cut — it died and was
        # re-queued by the runner, and nothing else will ever relaunch it.
        # (Milestone-paused members ARE in bracket.arrived; cut survivors ride
        # the _promote queue above.)
        def _crash_requeued(t: Trial) -> bool:
            bracket = self._trial_bracket.get(t.trial_id)
            return bracket is not None and t.trial_id not in bracket.arrived
        # NOT generic paused trials — paused bracket members wait for the cut.
        return runner.next_ready(TrialStatus.PAUSED, fit=_crash_requeued)

    def debug_string(self) -> str:
        lines = [f"HyperBand: eta={self.eta} R={self.max_t} ({self.n_stopped} stopped)"]
        for i, b in enumerate(self._brackets):
            lines.append(
                f"  bracket {i}: cap={b.capacity} round={b.round} "
                f"milestone={b.milestone} live={len(b.trials)}"
            )
        return "\n".join(lines)
