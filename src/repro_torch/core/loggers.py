"""Result loggers — the paper's "monitoring and visualization of trial progress".

Console progress table (periodic, like Tune's reporter), per-trial CSV, and an
experiment-level JSONL event log (the TensorBoard-integration analogue: any
external tool can tail the JSONL).
"""
from __future__ import annotations

import csv
import json
import os
import sys
from typing import Any, Dict, List, Optional, TextIO

from .clock import Clock, get_default_clock
from .trial import Result, Trial

__all__ = ["Logger", "ConsoleLogger", "CSVLogger", "JSONLLogger",
           "CompositeLogger", "LiveReporter"]


class Logger:
    def on_result(self, trial: Trial, result: Result) -> None:
        pass

    def on_event(self, trial: Trial, event: Any) -> None:
        """Non-result TrialEvents (CHECKPOINTED / HEARTBEAT_MISSED / RESTARTED)."""

    def on_trial_complete(self, trial: Trial) -> None:
        pass

    def on_experiment_end(self, trials: List[Trial]) -> None:
        pass

    def close(self) -> None:
        pass


class ConsoleLogger(Logger):
    def __init__(self, interval_s: float = 5.0, stream: Optional[TextIO] = None,
                 verbose: bool = True, clock: Optional[Clock] = None,
                 obs: Optional[Any] = None):
        self.interval_s = interval_s
        self.stream = stream or sys.stdout
        self.verbose = verbose
        self.clock = clock or get_default_clock()
        self.obs = obs  # repro_torch.obs.Observability; enables the status table
        self._last = 0.0
        self._n_results = 0
        self._pending: Optional[tuple] = None  # last throttled (trial_id, result)

    def _emit(self, trial_id: str, result: Result) -> None:
        metrics = ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in list(result.metrics.items())[:4]
        )
        print(f"[tune] {trial_id} iter={result.training_iteration} {metrics}",
              file=self.stream)

    def on_result(self, trial: Trial, result: Result) -> None:
        self._n_results += 1
        if not self.verbose:
            return
        # Flush throttling reads the injected clock, so a virtual-time run
        # prints on virtual seconds (and tests can drive the throttle
        # deterministically) instead of real-time wall gaps.
        now = self.clock.time()
        if now - self._last >= self.interval_s:
            self._last = now
            self._pending = None
            self._emit(trial.trial_id, result)
        else:
            # Throttled: remember it so a final flush() can still report the
            # run's last status instead of silently dropping it.
            self._pending = (trial.trial_id, result)

    def flush(self) -> None:
        """Emit the last throttled result (and the metrics status table when
        an Observability bundle is attached) even inside the throttle window.
        The runner calls this at experiment end — the final status of a run
        must never be lost to the throttle."""
        if not self.verbose:
            return
        if self._pending is not None:
            trial_id, result = self._pending
            self._pending = None
            self._last = self.clock.time()
            self._emit(trial_id, result)
        if self.obs is not None and self.obs.metrics is not None:
            for line in self.status_table().splitlines():
                print(line, file=self.stream)

    def status_table(self) -> str:
        """Compact control-plane status table from the attached metrics
        registry (DESIGN.md §8).  Empty string when no registry is attached."""
        if self.obs is None or self.obs.metrics is None:
            return ""
        snap = self.obs.metrics.snapshot()

        def c(name: str) -> Any:
            v = snap.get(name, 0)
            return v if not isinstance(v, dict) else v.get("count", 0)

        def mean_us(name: str) -> str:
            v = snap.get(name)
            if not isinstance(v, dict) or not v.get("count"):
                return "-"
            return f"{v['mean']:.1f}us"

        return "\n".join([
            "[tune] --- control-plane status ---",
            f"[tune] events: results={c('events.result')} "
            f"errors={c('events.error')} restarts={c('trials.restarts')} "
            f"kills={c('events.killed')} resizes={c('trials.resized')}",
            f"[tune] bus: published={c('bus.published')} depth={c('bus.depth')} "
            f"fanin={mean_us('bus.fanin_us')}",
            f"[tune] sched: choose={mean_us('sched.choose_us')} "
            f"decision={mean_us('sched.decision_us')}",
            f"[tune] pool: util={snap.get('pool.utilization', 0)} "
            f"fragments={snap.get('pool.fragments', 0)} "
            f"acquire={mean_us('pool.acquire_us')}",
            f"[tune] ckpt: saves={c('ckpt.save_us')} "
            f"save={mean_us('ckpt.save_us')} "
            f"restore={mean_us('ckpt.restore_us')}",
        ])

    def on_event(self, trial: Trial, event: Any) -> None:
        if not self.verbose:
            return
        kind = getattr(event, "type", None)
        kind = getattr(kind, "value", str(kind))
        if kind == "HEARTBEAT_MISSED":
            print(f"[tune] WARNING {trial.trial_id} straggling: no progress for "
                  f"{event.info.get('stalled_s', '?')}s", file=self.stream)
        elif kind == "KILLED":
            print(f"[tune] WARNING {trial.trial_id} straggler killed "
                  f"(pid={event.info.get('pid', '?')}, stalled "
                  f"{event.info.get('stalled_s', '?')}s > deadline "
                  f"{event.info.get('deadline_s', '?')}s); slice reclaimed",
                  file=self.stream)
        elif kind == "RESTARTED":
            where = ("last checkpoint" if event.checkpoint is not None else "scratch")
            print(f"[tune] {trial.trial_id} failed "
                  f"({event.info.get('num_failures', '?')}/"
                  f"{event.info.get('max_failures', '?')}); restarting from {where}",
                  file=self.stream)
        elif kind == "RESIZED":
            info = event.info
            print(f"[tune] {trial.trial_id} slice resized "
                  f"{info.get('from_devices', '?')} -> {info.get('to_devices', '?')} "
                  f"devices ({info.get('policy', '?')}; pool "
                  f"{info.get('utilization', 0) * 100:.0f}% used, "
                  f"{info.get('holes', '?')} holes)", file=self.stream)
        elif kind == "RESIZE_FAILED":
            info = event.info
            print(f"[tune] WARNING {trial.trial_id} resize "
                  f"{info.get('from_devices', '?')} -> {info.get('to_devices', '?')} "
                  f"failed; trial falls back to its old slice "
                  f"(largest free block {info.get('largest_free_block', '?')})",
                  file=self.stream)
        elif kind == "CREDITS":
            info = event.info
            print(f"[tune] {trial.trial_id} lookahead credits: "
                  f"{info.get('granted', '?')} granted "
                  f"(requested {info.get('requested', '?')}, scheduler decision "
                  f"interval {info.get('decision_interval', '?')})",
                  file=self.stream)

    def on_experiment_end(self, trials: List[Trial]) -> None:
        self.flush()  # always surface the run's final status (satellite fix)
        if not self.verbose:
            return
        from .trial import TrialStatus

        by_status: Dict[str, int] = {}
        for t in trials:
            by_status[t.status.value] = by_status.get(t.status.value, 0) + 1
        print(f"[tune] experiment done: {len(trials)} trials, "
              f"{self._n_results} results, status={by_status}", file=self.stream)


class LiveReporter(Logger):
    """The paper's live trial table (§"monitoring of trial progress").

    Renders a status table of every trial — status / iteration / last and
    best metric / slice devices / restarts — re-drawn at most once per
    ``interval_s`` on the injected clock, plus one unthrottled final render
    at experiment end.  Everything printed is a pure function of trial state
    and virtual timestamps, so a VirtualClock run renders byte-identically
    across repeats (DESIGN.md §9); rendering cost is bounded by ``max_rows``
    (in-flight trials take precedence, finished ones fill the remainder).
    """

    def __init__(self, metric: Optional[str] = None, interval_s: float = 5.0,
                 stream: Optional[TextIO] = None, clock: Optional[Clock] = None,
                 max_rows: int = 24):
        self.metric = metric
        self.interval_s = interval_s
        self.stream = stream or sys.stdout
        self.clock = clock or get_default_clock()
        self.max_rows = max_rows
        self._trials: Dict[str, Trial] = {}
        self._last = None  # None = never rendered (first result renders)
        self._dirty = False

    # -- tracking ---------------------------------------------------------------
    def _track(self, trial: Trial) -> None:
        self._trials[trial.trial_id] = trial
        self._dirty = True

    def on_result(self, trial: Trial, result: Result) -> None:
        self._track(trial)
        self._maybe_render()

    def on_event(self, trial: Trial, event: Any) -> None:
        self._track(trial)
        self._maybe_render()

    def on_trial_complete(self, trial: Trial) -> None:
        self._track(trial)
        self._maybe_render()

    def on_experiment_end(self, trials: List[Trial]) -> None:
        for t in trials:
            self._trials[t.trial_id] = t
        self.render(final=True)

    def _maybe_render(self) -> None:
        now = self.clock.time()
        if self._last is not None and now - self._last < self.interval_s:
            return
        self._last = now
        self.render()

    # -- rendering ---------------------------------------------------------------
    def _metric_name(self) -> Optional[str]:
        if self.metric is not None:
            return self.metric
        for t in self._trials.values():
            if t.last_result is not None and t.last_result.metrics:
                return next(iter(t.last_result.metrics))
        return None

    def _row(self, t: Trial, metric: Optional[str]) -> List[str]:
        last = best = "-"
        if metric is not None and t.last_result is not None \
                and metric in t.last_result.metrics:
            last = f"{t.last_result.value(metric):.4g}"
            bv = t.best_value(metric, "min")  # display-only; both shown
            hv = t.best_value(metric, "max")
            best = f"{bv:.4g}/{hv:.4g}" if bv != hv else f"{bv:.4g}"
        prof = ""
        if t.profile:
            prof = str(t.profile.get("dominant", ""))
        return [
            t.trial_id, t.status.value, str(t.training_iteration),
            last, best, str(t.resources.devices), str(t.num_failures), prof,
        ]

    def render(self, final: bool = False) -> None:
        if not self._dirty and not final:
            return
        self._dirty = False
        metric = self._metric_name()
        by_status: Dict[str, int] = {}
        for t in self._trials.values():
            by_status[t.status.value] = by_status.get(t.status.value, 0) + 1
        counts = " ".join(f"{k}:{v}" for k, v in sorted(by_status.items()))
        head = ["trial", "status", "iter",
                metric or "metric", "best(min/max)", "dev", "fails", "profile"]
        # In-flight trials first (the table is about progress), then finished
        # ones, both in id order; cap at max_rows so 10^4-trial sweeps stay
        # renderable.
        live = sorted((t for t in self._trials.values()
                       if not t.status.is_finished()), key=lambda t: t.trial_id)
        done = sorted((t for t in self._trials.values()
                       if t.status.is_finished()), key=lambda t: t.trial_id)
        shown = (live + done)[: self.max_rows]
        rows = [self._row(t, metric) for t in shown]
        widths = [max(len(head[i]), *(len(r[i]) for r in rows)) if rows
                  else len(head[i]) for i in range(len(head))]
        out = [f"== trials: {len(self._trials)} ({counts}) =="]
        out.append("  ".join(h.ljust(widths[i]) for i, h in enumerate(head)))
        for r in rows:
            out.append("  ".join(c.ljust(widths[i]) for i, c in enumerate(r)))
        hidden = len(self._trials) - len(shown)
        if hidden > 0:
            out.append(f".. {hidden} more trial(s) not shown")
        print("\n".join(out), file=self.stream)


class CSVLogger(Logger):
    def __init__(self, dir: str):
        self.dir = dir
        self._writers: Dict[str, tuple] = {}

    def on_result(self, trial: Trial, result: Result) -> None:
        if trial.trial_id not in self._writers:
            os.makedirs(self.dir, exist_ok=True)
            f = open(os.path.join(self.dir, f"{trial.trial_id}.csv"), "w", newline="")
            fields = ["training_iteration", "timestamp"] + sorted(result.metrics)
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            self._writers[trial.trial_id] = (f, w)
        f, w = self._writers[trial.trial_id]
        row = {"training_iteration": result.training_iteration, "timestamp": result.timestamp}
        row.update({k: v for k, v in result.metrics.items()})
        w.writerow(row)
        f.flush()  # a crashed run must not lose the tail of the metrics log

    def close(self) -> None:
        for f, _ in self._writers.values():
            f.close()
        self._writers.clear()


class JSONLLogger(Logger):
    """Experiment-level JSONL event log.

    The stream opens with a ``run_header`` record carrying the schema version,
    a run id, the clock type, and the executor tier, so a detached reader can
    interpret the stream without the producing process.  Readers must stay
    unknown-field (and unknown-record) tolerant: filter on ``event`` and
    ignore keys you don't know — that is what keeps pre-header readers of the
    v1 stream working against v2 files, and v2 readers working against v3
    (which adds ``decision`` records and the ``decisions`` capability flag).
    """

    SCHEMA_VERSION = 3

    def __init__(self, path: str, clock: Optional[Clock] = None,
                 run_id: Optional[str] = None, executor: Optional[str] = None,
                 decisions: bool = True, resumed: bool = False,
                 initial_records: int = 0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.clock = clock or get_default_clock()
        t0 = self.clock.time()
        self.run_id = run_id or f"run-{int(t0)}-{os.getpid()}"
        # ``n_records`` counts data records (the run_header excluded): it is
        # the watermark the SearchStateSnapshotter stamps into snapshots so
        # resume knows exactly which journal prefix the saved search state
        # has already been fed.  A resumed run appends to the existing
        # journal and starts the counter at the surviving record count.
        self.n_records = int(initial_records)
        self.f = open(path, "a" if resumed else "w")
        header = {
            "event": "run_header",
            "schema_version": self.SCHEMA_VERSION,
            "run_id": self.run_id,
            "clock": type(self.clock).__name__,
            "executor": executor,
            "decisions": bool(decisions),
            "t": t0,
        }
        if resumed:
            # Readers keep the first header and skip later ones, so a
            # resumed journal parses as one continuous run.
            header["resumed"] = True
        self.f.write(json.dumps(header) + "\n")
        self.f.flush()

    def on_result(self, trial: Trial, result: Result) -> None:
        self.n_records += 1
        self.f.write(json.dumps({
            "event": "result",
            "trial_id": trial.trial_id,
            "iteration": result.training_iteration,
            "config": {k: v for k, v in trial.config.items()
                       if isinstance(v, (int, float, str, bool, type(None)))},
            "metrics": {k: v for k, v in result.metrics.items()
                        if isinstance(v, (int, float, str, bool, type(None)))},
            "t": result.timestamp,
        }) + "\n")
        self.f.flush()  # a crashed run must not lose the tail of the event log

    def on_event(self, trial: Trial, event: Any) -> None:
        kind = getattr(event, "type", None)
        # Events that never crossed a bus (runner-side RESTARTED, the
        # broker's CREDITS/RESIZED records) arrive unstamped: fall back to
        # this logger's clock so the JSONL time axis stays consistent.
        ts = getattr(event, "timestamp", None)
        if ts is None:
            ts = self.clock.time()
        self.n_records += 1
        self.f.write(json.dumps({
            "event": getattr(kind, "value", str(kind)).lower(),
            "trial_id": trial.trial_id,
            "seq": getattr(event, "seq", -1),
            "info": getattr(event, "info", {}),
            "t": ts,
        }) + "\n")
        self.f.flush()

    def on_trial_complete(self, trial: Trial) -> None:
        self.n_records += 1
        self.f.write(json.dumps({
            "event": "complete", "trial_id": trial.trial_id,
            "status": trial.status.value, "iterations": trial.training_iteration,
        }) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


class CompositeLogger(Logger):
    def __init__(self, loggers: List[Logger]):
        self.loggers = loggers

    def on_result(self, trial, result):
        for lg in self.loggers:
            lg.on_result(trial, result)

    def on_event(self, trial, event):
        for lg in self.loggers:
            lg.on_event(trial, event)

    def on_trial_complete(self, trial):
        for lg in self.loggers:
            lg.on_trial_complete(trial)

    def on_experiment_end(self, trials):
        for lg in self.loggers:
            lg.on_experiment_end(trials)

    def close(self):
        for lg in self.loggers:
            lg.close()
