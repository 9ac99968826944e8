"""Trial scheduler API — the paper's §4.2 primary interface.

    class TrialScheduler:
        def on_result(self, trial, result): ...
        def choose_trial_to_run(self): ...

Event-based: the runner calls ``choose_trial_to_run`` when resources free up,
and ``on_result`` for every intermediate result; the scheduler returns a flag —
CONTINUE, PAUSE (checkpoint + yield resources), STOP, or RESTART_WITH_CONFIG
(restore from a checkpoint with an updated hyperparameter map — the paper's
"restart a trial with an updated hyperparameter configuration", used by PBT).
"""
from __future__ import annotations

import enum
from collections import deque
from typing import Any, Dict, List, Optional, TYPE_CHECKING

from ..trial import Result, Trial, TrialStatus

if TYPE_CHECKING:  # pragma: no cover
    from ..runner import TrialRunner

__all__ = ["SchedulerDecision", "TrialScheduler"]


class SchedulerDecision(str, enum.Enum):
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"
    RESTART_WITH_CONFIG = "RESTART_WITH_CONFIG"  # new config staged on the trial


class TrialScheduler:
    """Base scheduler. Subclasses override on_result / choose_trial_to_run."""

    def __init__(self, metric: str = "loss", mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        # Decision provenance (DESIGN.md §10): every non-trivial verdict is
        # recorded with the inputs that produced it.  The runner drains this
        # after each on_result/on_trial_error call; the maxlen is a backstop
        # so an undrained scheduler (unit tests, direct use) stays bounded.
        self._decision_log: "deque[Dict[str, Any]]" = deque(maxlen=4096)
        self._last_explain: Optional[Dict[str, Any]] = None

    # score such that HIGHER is always better internally
    def _score(self, value: float) -> float:
        return value if self.mode == "max" else -value

    # -- decision provenance (DESIGN.md §10) ------------------------------------
    def _record_decision(self, trial_id: str, verdict: "SchedulerDecision",
                         iteration: Optional[int] = None,
                         **inputs: Any) -> Dict[str, Any]:
        """Record a verdict plus the inputs that produced it.

        Called by subclasses at each decision point; the record lands in
        ``explain_last()`` and in the drain queue the runner journals from.
        """
        rec: Dict[str, Any] = {
            "trial_id": trial_id,
            "verdict": verdict.value if isinstance(verdict, SchedulerDecision) else str(verdict),
            "iteration": iteration,
            "inputs": inputs,
        }
        self._last_explain = rec
        self._decision_log.append(rec)
        return rec

    def explain_last(self) -> Optional[Dict[str, Any]]:
        """The most recent decision record (verdict + inputs), or None."""
        return self._last_explain

    def pop_decisions(self) -> List[Dict[str, Any]]:
        """Drain all recorded-but-unjournaled decision records, in order."""
        if not self._decision_log:
            return []
        out = list(self._decision_log)
        self._decision_log.clear()
        return out

    # -- durable state (DESIGN.md §10) ------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of decision-relevant mutable state.

        The base scheduler (and FIFO) is stateless beyond construction args,
        so the base snapshot is empty; subclasses extend it.  ``metric`` /
        ``mode`` are constructor config, not state — resume reconstructs the
        scheduler then loads this dict.
        """
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore from a ``state_dict()`` snapshot.  Base: nothing to do."""

    def decision_interval(self) -> int:
        """Decision granularity: how many results may elapse between decisions
        that can stop, pause, or perturb a trial.

        ``0`` means *never* — the scheduler runs every trial to its stopping
        condition (FIFO), so workers may run unbounded result lookahead
        without changing any decision.  ``n >= 1`` means the scheduler may act
        on any result (1) or on every n-th result per trial; the elastic
        tier's ``ResourceBroker`` preserves exactness by clamping lookahead
        credits to 1 whenever the interval is nonzero (DESIGN.md §6).
        Conservative default: 1.
        """
        return 1

    def holds_trial(self, trial_id: str) -> bool:
        """True when the scheduler is deliberately holding this PAUSED trial
        (e.g. a HyperBand milestone-waiter awaiting its bracket cut) and the
        runner must not relaunch it on its own.

        Durable resume uses this to keep restored milestone-waiters parked
        until the scheduler's own promote path fires (DESIGN.md §12).  Base:
        nothing is ever held.
        """
        return False

    # -- lifecycle events -------------------------------------------------------
    def on_trial_add(self, runner: "TrialRunner", trial: Trial) -> None:
        pass

    def on_trial_error(self, runner: "TrialRunner", trial: Trial) -> None:
        pass

    def on_result(self, runner: "TrialRunner", trial: Trial, result: Result) -> SchedulerDecision:
        """Called for every intermediate result. Default: run to completion."""
        return SchedulerDecision.CONTINUE

    def on_trial_complete(self, runner: "TrialRunner", trial: Trial) -> None:
        pass

    def choose_trial_to_run(self, runner: "TrialRunner") -> Optional[Trial]:
        """Pick the next trial to (re)launch given free resources.

        Default policy: oldest-queued PENDING trial, then oldest-queued PAUSED
        trial, via the runner's status/shape index (one ``has_resources``
        probe per resource shape instead of an O(n) scan — DESIGN.md §9).
        """
        trial = runner.next_ready(TrialStatus.PENDING)
        if trial is not None:
            return trial
        return runner.next_ready(TrialStatus.PAUSED)

    def debug_string(self) -> str:
        return type(self).__name__
