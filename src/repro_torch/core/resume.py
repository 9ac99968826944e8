"""Durable resume (DESIGN.md §12): rebuild a killed sweep from its artifacts.

A run that journals to ``events.jsonl`` leaves three durable sources behind
when its controller dies:

1. the **journal** — every result / decision / lifecycle event, flushed per
   record (the torn final line of a kill -9 is repaired here);
2. the **search-state snapshot** (``search_state.json``) — scheduler +
   searcher ``state_dict()`` stamped with a *watermark*: the exact count of
   journal records whose effects the snapshot already contains;
3. the per-trial **checkpoint mirrors** (``ckpt/<trial_id>/iter_N.ckpt``).

``prepare_resume`` reconciles the three into a :class:`ResumePlan`:

- journal records ``[0..W)`` (below the watermark) are *bookkept only* —
  trial result histories, statuses, configs, iteration frontiers — because
  the snapshot already reflects them;
- the tail ``[W..end)`` is *replayed through* the scheduler/searcher
  (``on_result`` / ``on_trial_add`` / ``on_trial_complete`` / ``suggest``)
  against a shim runner, so rung counts, bracket membership, populations
  and RNG streams advance exactly as they did in the original process;
- finally each non-terminal trial is matched to its newest *valid* disk
  mirror at-or-below its journal frontier: mirror found → PAUSED with a
  checkpoint (plus a **result fence** so re-executed, already-journaled
  iterations are not journaled twice), no mirror → PENDING from scratch.

Virtual-time phase: each restored trial carries ``resume_phase_t`` — the
journal timestamp of its restore point — so its worker re-enters the
virtual timeline exactly where the original left it and post-resume
results arrive in the same cross-trial order as an uninterrupted run
(the bit-identical-continuation contract; limits documented in §12).

With no usable snapshot the plan falls back to a **cold replay**: a fresh
scheduler is fed ``on_trial_add`` for the initial trials in generation
order and the *entire* journal becomes the tail.
"""
from __future__ import annotations

import inspect
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ..obs.analysis import parse_journal_lines
from ..obs.flightrec import load_search_state
from .checkpoint import load_pytree
from .resources import Resources
from .schedulers.base import SchedulerDecision, TrialScheduler
from .search.basic import Searcher
from .trial import Checkpoint, Result, Trial, TrialStatus

__all__ = ["ResumePlan", "prepare_resume", "repair_journal"]

_TERMINAL = (TrialStatus.TERMINATED, TrialStatus.ERROR)


def repair_journal(path: str) -> int:
    """Truncate the torn tail a kill -9 may leave mid-write.

    JSONLLogger flushes one complete line per record, so the only possible
    damage is a final line without a newline terminator.  Returns the number
    of bytes dropped (0 for a clean journal)."""
    with open(path, "rb+") as f:
        data = f.read()
        if not data or data.endswith(b"\n"):
            return 0
        cut = data.rfind(b"\n") + 1
        f.truncate(cut)
        return len(data) - cut


@dataclass
class ResumePlan:
    """Everything ``TrialRunner.apply_resume_plan`` needs to continue a run."""

    trials: List[Trial] = field(default_factory=list)
    # trial_id -> last already-journaled result iteration of the current
    # lineage: the resumed worker's re-executed results at-or-below this are
    # dropped (runner result fence).
    result_fences: Dict[str, int] = field(default_factory=dict)
    # trial_id -> {event kind -> iteration bound} for non-result events
    # (CHECKPOINTED) the original run already journaled.
    event_fences: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # Restored-trial relaunch order (phase-ascending): drained ahead of the
    # scheduler's own choose loop.
    resume_order: List[str] = field(default_factory=list)
    next_suggest_index: int = 0
    # Count of surviving journal records: the resumed JSONLLogger continues
    # its watermark from here.
    n_journal_records: int = 0
    used_snapshot: bool = False
    warnings: List[str] = field(default_factory=list)

    def summary(self) -> str:
        n_term = sum(1 for t in self.trials if t.status in _TERMINAL)
        n_paused = sum(1 for t in self.trials if t.status == TrialStatus.PAUSED)
        n_pending = len(self.trials) - n_term - n_paused
        return (f"resume: {len(self.trials)} trials "
                f"({n_term} finished, {n_paused} from checkpoint, "
                f"{n_pending} from scratch), "
                f"{self.n_journal_records} journal records, "
                f"{'snapshot' if self.used_snapshot else 'cold'} replay")


def _safe_id(trial_id: str) -> str:
    return trial_id.replace("/", "_")


def _mirror_path(ckpt_dir: Optional[str], trial_id: str, iteration: int
                 ) -> Optional[str]:
    if not ckpt_dir:
        return None
    return os.path.join(ckpt_dir, _safe_id(trial_id), f"iter_{iteration}.ckpt")


def _valid_mirror(path: Optional[str]) -> bool:
    """A mirror counts only if it loads: CRC + msgpack decode, so a file torn
    by the crash (or half-rotated) falls through to an older one."""
    if not path or not os.path.exists(path):
        return False
    try:
        load_pytree(path)
    except Exception:
        return False
    return True


def _latest_valid_mirror(ckpt_dir: Optional[str], trial_id: str,
                         frontier: int) -> Tuple[int, Optional[str]]:
    """Newest loadable mirror at-or-below the journal frontier, else (0, None).

    Mirrors above the frontier are skipped even when valid: after a PBT
    rewind they can belong to an abandoned lineage, and a checkpoint saved
    just before the kill whose *result* never reached the journal must be
    re-earned — the journal is the source of truth, so that iteration re-runs
    (its duplicate CHECKPOINTED event is fenced, its result is fresh)."""
    if not ckpt_dir or frontier <= 0:
        return 0, None
    d = os.path.join(ckpt_dir, _safe_id(trial_id))
    if not os.path.isdir(d):
        return 0, None
    iters: List[int] = []
    for fn in os.listdir(d):
        m = re.fullmatch(r"iter_(\d+)\.ckpt", fn)
        if m:
            iters.append(int(m.group(1)))
    for k in sorted(iters, reverse=True):
        if k <= frontier:
            path = os.path.join(d, f"iter_{k}.ckpt")
            if _valid_mirror(path):
                return k, path
    return 0, None


class _ReplayRunner:
    """The narrow slice of TrialRunner the scheduler hooks touch during
    replay: ``trials`` / ``get_trial`` for population scans, ``stop_trial``
    for peer stops (HyperBand cuts).  ``has_resources`` answers False so a
    scheduler probing capacity mid-replay stays passive."""

    def __init__(self, replay: "_Replay"):
        self._replay = replay

    @property
    def trials(self) -> List[Trial]:
        return self._replay.trial_list

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        return self._replay.trial_map.get(trial_id)

    def stop_trial(self, trial: Trial) -> None:
        self._replay.shim_stop(trial)

    def has_resources(self, trial: Trial) -> bool:
        return False

    def next_ready(self, status: TrialStatus, fit: Any = None) -> Optional[Trial]:
        return None


class _Replay:
    """Two-phase journal replay + three-source reconciliation."""

    def __init__(self, scheduler: TrialScheduler, searcher: Optional[Searcher],
                 trainable_name: str, default_resources: Optional[Resources],
                 stopping_criteria: Optional[Dict[str, float]],
                 checkpoint_dir: Optional[str]):
        self.scheduler = scheduler
        self.searcher = searcher
        self.trainable_name = trainable_name
        self.default_resources = default_resources or Resources()
        self.stopping_criteria = dict(stopping_criteria or {})
        self.checkpoint_dir = checkpoint_dir
        self.shim = _ReplayRunner(self)
        self.trial_map: Dict[str, Trial] = {}
        self.trial_list: List[Trial] = []
        # -- journal-derived bookkeeping, all keyed by trial_id ---------------
        self.frontier: Dict[str, int] = {}       # current-lineage result frontier
        # iteration -> journal t of the result that (last) produced it; rewinds
        # (RESTARTED / exploit) stamp their own t at the rewind iteration, so
        # result_t[restore_k] is always the virtual time the current lineage
        # occupied state k — exactly the phase a restored worker must re-enter.
        self.result_t: Dict[str, Dict[int, float]] = {}
        self.ckpt_seen: Dict[str, int] = {}      # last journaled CHECKPOINTED iter
        self.pending_exploit: Dict[str, Dict[str, Any]] = {}
        self.completed_fed: Set[str] = set()
        self.active: Set[str] = set()            # produced at least one record
        self.max_sugg = -1
        self.warnings: List[str] = []
        self._sugg_pat = re.compile(
            rf"^{re.escape(trainable_name)}_sugg_(\d+)$")

    # -- trial identity -----------------------------------------------------------
    def seed_base_trials(self, base_trials: List[Trial]) -> None:
        """Fresh shells from the identity source (regenerated configs or the
        legacy pkl): id + config + resources survive, everything transient
        (results, status, checkpoints) is rebuilt from the journal."""
        for bt in base_trials:
            if bt.trial_id in self.trial_map:
                continue
            t = Trial(config=dict(bt.config),
                      trainable_name=self.trainable_name,
                      resources=bt.resources,
                      stopping_criteria=bt.stopping_criteria or self.stopping_criteria,
                      tag=bt.tag, trial_id=bt.trial_id)
            self.trial_map[t.trial_id] = t
            self.trial_list.append(t)

    def ensure(self, trial_id: str,
               config: Optional[Dict[str, Any]] = None) -> Trial:
        t = self.trial_map.get(trial_id)
        if t is None:
            t = Trial(config=dict(config or {}),
                      trainable_name=self.trainable_name,
                      resources=self.default_resources,
                      stopping_criteria=self.stopping_criteria,
                      trial_id=trial_id)
            self.trial_map[trial_id] = t
            self.trial_list.append(t)
        elif config and not t.config:
            t.config = dict(config)
        return t

    # -- searcher plumbing --------------------------------------------------------
    def observe(self, trial: Trial, final: bool) -> None:
        if self.searcher is None or trial.last_result is None:
            return
        metric = self.searcher.metric
        if metric in trial.last_result.metrics:
            self.searcher.observe(trial.trial_id, trial.config,
                                  trial.last_result.value(metric), final)

    def shim_stop(self, trial: Trial) -> None:
        """Replay analogue of TrialRunner.stop_trial."""
        if trial.trial_id in self.completed_fed:
            return
        if trial.status not in _TERMINAL:
            trial.status = TrialStatus.TERMINATED
        self.completed_fed.add(trial.trial_id)
        self.scheduler.on_trial_complete(self.shim, trial)
        self.observe(trial, final=True)

    def _drain(self) -> None:
        # Replay-regenerated decision records were journaled by the original
        # run already — discard them so the deque stays bounded and nothing
        # downstream re-journals them.
        self.scheduler.pop_decisions()

    # -- record handlers ----------------------------------------------------------
    def _rewind(self, tid: str, iteration: int, t: float) -> None:
        """A RESTARTED retry or an exploit rewound the trial to ``iteration``
        at journal time ``t``: the current lineage restarts there."""
        self.frontier[tid] = iteration
        self.result_t.setdefault(tid, {})[iteration] = float(t)
        self.ckpt_seen[tid] = min(self.ckpt_seen.get(tid, iteration), iteration)

    def _on_result(self, rec: Dict[str, Any], feed: bool,
                   records: List[Dict[str, Any]], i: int) -> None:
        tid = rec["trial_id"]
        cfg = rec.get("config")
        trial = self.ensure(tid, cfg if isinstance(cfg, dict) else None)
        if isinstance(cfg, dict) and cfg:
            # result records carry the *effective* config (post-exploit
            # mutations included) — the overlay keeps restored configs exact
            trial.config = dict(cfg)
        it = int(rec.get("iteration", 0))
        t = float(rec.get("t", 0.0))
        res = Result(tid, it, dict(rec.get("metrics") or {}), timestamp=t)
        trial.record_result(res)
        if trial.status not in _TERMINAL:
            trial.status = TrialStatus.RUNNING
        self.frontier[tid] = it
        self.result_t.setdefault(tid, {})[it] = t
        self.active.add(tid)
        self.pending_exploit.pop(tid, None)
        if not feed:
            return

        # Peek the contiguous decision records this result produced (the
        # journal writes them immediately after it): they tell us executor
        # state the replay cannot otherwise know.
        runner_stop = False
        exploit_t = t
        j = i + 1
        while j < len(records) and records[j].get("event") == "decision" \
                and (records[j].get("info") or {}).get("source") != "searcher":
            info = records[j].get("info") or {}
            if records[j].get("trial_id") == tid:
                v, src = info.get("verdict"), info.get("source")
                inp = info.get("inputs") or {}
                if src == "runner" and v == "STOP":
                    # The runner stopped it (stopping criterion / done) before
                    # the scheduler ever saw this result: don't feed it.
                    runner_stop = True
                elif src == "scheduler" and v == "RESTART_WITH_CONFIG":
                    # Force the donor's checkpoint so PBT's draw re-takes the
                    # exploit branch with the journaled donor iteration.
                    donor = self.ensure(str(inp.get("donor")))
                    d_it = int(inp.get("donor_iteration", 0))
                    donor.checkpoint = Checkpoint(
                        trial_id=donor.trial_id, training_iteration=d_it,
                        path=_mirror_path(self.checkpoint_dir,
                                          donor.trial_id, d_it))
                    exploit_t = float(records[j].get("t", t))
                elif v == "EXPLOIT_SKIPPED":
                    if not inp.get("donor_is_self") \
                            and not inp.get("donor_has_checkpoint"):
                        d = self.trial_map.get(str(inp.get("donor")))
                        if d is not None:
                            d.checkpoint = None
            j += 1

        if runner_stop:
            self.shim_stop(trial)
            self._drain()
            return
        verdict = self.scheduler.on_result(self.shim, trial, res)
        self._drain()
        self.observe(trial, final=False)
        self._apply_verdict(trial, verdict, exploit_t)

    def _apply_verdict(self, trial: Trial, verdict: SchedulerDecision,
                       exploit_t: float) -> None:
        tid = trial.trial_id
        if verdict == SchedulerDecision.PAUSE:
            if trial.status not in _TERMINAL:
                trial.status = TrialStatus.PAUSED
        elif verdict == SchedulerDecision.STOP:
            self.shim_stop(trial)
            self._drain()
        elif verdict == SchedulerDecision.RESTART_WITH_CONFIG:
            ckpt = trial.scheduler_state.pop("restore_from", None)
            new_config = trial.scheduler_state.pop("new_config", None)
            trial.scheduler_state.pop("cloned_from", None)
            if ckpt is None:
                return
            ckpt.pinned = False
            if isinstance(new_config, dict):
                trial.config = dict(new_config)
            self.pending_exploit[tid] = {
                "donor": ckpt.trial_id,
                "donor_iteration": int(ckpt.training_iteration),
                "new_config": dict(new_config or {})}
            self._rewind(tid, int(ckpt.training_iteration), exploit_t)
            if trial.status not in _TERMINAL:
                trial.status = TrialStatus.RUNNING

    def _on_decision(self, rec: Dict[str, Any], feed: bool) -> None:
        tid = rec.get("trial_id") or ""
        info = rec.get("info") or {}
        src, v = info.get("source"), info.get("verdict")
        inp = info.get("inputs") or {}
        t = float(rec.get("t", 0.0))
        if src == "searcher":
            m = self._sugg_pat.match(tid)
            if m:
                self.max_sugg = max(self.max_sugg, int(m.group(1)))
            trial = self.ensure(tid)
            if feed and self.searcher is not None:
                # Re-invoking suggest replays the searcher's RNG/grid advance
                # and regenerates the identical config.
                cfg = self.searcher.suggest(tid)
                if cfg is not None:
                    trial.config = dict(cfg)
                elif not trial.config:
                    self.warnings.append(
                        f"searcher exhausted re-suggesting {tid}; its config "
                        f"falls back to journal result records")
                self.scheduler.on_trial_add(self.shim, trial)
                self._drain()
            return
        if v == "PROMOTE":
            # A synchronous-cut survivor relaunches at the *cut* time, not at
            # its own milestone arrival: shift the restore phase forward.
            # (Both replay modes: the feed re-fills the scheduler's promote
            # queue, but the phase stamp is pure resume bookkeeping.)
            k = self.frontier.get(tid)
            if k is not None:
                self.result_t.setdefault(tid, {})[k] = t
            if feed:
                return
        if feed:
            # Tail decisions' state effects were produced by the feeds
            # themselves; applying the record too would double them.
            return
        trial = self.ensure(tid)
        if v == "PAUSE":
            if trial.status not in _TERMINAL:
                trial.status = TrialStatus.PAUSED
        elif v == "STOP":
            if trial.status not in _TERMINAL:
                trial.status = TrialStatus.TERMINATED
        elif v == "RESTART_WITH_CONFIG":
            new_config = inp.get("new_config")
            if isinstance(new_config, dict):
                trial.config = dict(new_config)
            d_it = int(inp.get("donor_iteration", 0))
            self.pending_exploit[tid] = {
                "donor": str(inp.get("donor")), "donor_iteration": d_it,
                "new_config": dict(new_config or {})}
            self._rewind(tid, d_it, t)
            if trial.status not in _TERMINAL:
                trial.status = TrialStatus.RUNNING

    def _on_complete(self, rec: Dict[str, Any], feed: bool) -> None:
        tid = rec["trial_id"]
        trial = self.ensure(tid)
        try:
            status = TrialStatus(rec.get("status"))
        except ValueError:
            status = TrialStatus.TERMINATED
        self.active.add(tid)
        if feed and tid not in self.completed_fed:
            trial.status = status
            if status == TrialStatus.ERROR:
                # The runner's error path feeds on_trial_error (never
                # on_trial_complete — _finalize_error skips it).
                self.scheduler.on_trial_error(self.shim, trial)
            else:
                self.scheduler.on_trial_complete(self.shim, trial)
            self._drain()
            self.observe(trial, final=True)
            self.completed_fed.add(tid)
        else:
            trial.status = status

    def _on_restarted(self, rec: Dict[str, Any]) -> None:
        tid = rec["trial_id"]
        trial = self.ensure(tid)
        info = rec.get("info") or {}
        self.active.add(tid)
        if info.get("num_failures") is not None:
            trial.num_failures = int(info["num_failures"])
        c = info.get("checkpoint_iteration")
        if c is None:
            return  # pre-§12 journal: frontier keeps its last result value
        c = int(c)
        self._rewind(tid, c, float(rec.get("t", 0.0)))
        if trial.status not in _TERMINAL:
            trial.status = (TrialStatus.PAUSED if c > 0 else TrialStatus.PENDING)

    # -- main loop ---------------------------------------------------------------
    def replay(self, records: List[Dict[str, Any]], watermark: int) -> None:
        for i, rec in enumerate(records):
            kind = rec.get("event")
            tid = rec.get("trial_id")
            if not isinstance(tid, str):
                continue
            feed = i >= watermark
            if kind == "result":
                self._on_result(rec, feed, records, i)
            elif kind == "decision":
                self._on_decision(rec, feed)
            elif kind == "complete":
                self._on_complete(rec, feed)
            elif kind == "restarted":
                self._on_restarted(rec)
            elif kind == "checkpointed":
                self.active.add(tid)
                it = (rec.get("info") or {}).get("iteration")
                if it is not None:
                    self.ckpt_seen[tid] = int(it)
            elif kind == "profile":
                self.ensure(tid).profile = rec.get("info") or {}
        self._drain()

    # -- reconciliation -----------------------------------------------------------
    def reconcile(self) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]],
                                 List[str]]:
        """Match every non-terminal trial to its best recovery source.

        Returns (result_fences, event_fences, resume_order)."""
        result_fences: Dict[str, int] = {}
        event_fences: Dict[str, Dict[str, int]] = {}
        entries: List[Tuple[float, int, str]] = []
        for idx, trial in enumerate(self.trial_list):
            tid = trial.trial_id
            if trial.status in _TERMINAL:
                # A finished trial keeps its last checkpoint in the live run
                # — a later PBT exploit may pick it as donor.  Rebuild that
                # reference from its newest surviving mirror.
                bound = max(self.frontier.get(tid, 0),
                            self.ckpt_seen.get(tid, 0))
                k, path = _latest_valid_mirror(self.checkpoint_dir, tid, bound)
                if path is not None:
                    trial.checkpoint = Checkpoint(
                        trial_id=tid, training_iteration=k, path=path)
                continue
            trial.scheduler_state.pop("restore_from", None)
            trial.scheduler_state.pop("new_config", None)
            trial.scheduler_state.pop("cloned_from", None)
            f = self.frontier.get(tid, 0)
            pe = self.pending_exploit.get(tid)
            if pe is not None:
                # Exploit staged but no post-exploit result journaled: restore
                # the donor's mirror under the mutated config — equivalent to
                # the restart_trial_with_config the crash pre-empted.
                donor, d_it = pe["donor"], pe["donor_iteration"]
                path = _mirror_path(self.checkpoint_dir, donor, d_it)
                if _valid_mirror(path):
                    trial.checkpoint = Checkpoint(
                        trial_id=donor, training_iteration=d_it, path=path)
                    trial.status = TrialStatus.PAUSED
                else:
                    self.warnings.append(
                        f"{tid}: exploit donor mirror {donor}@{d_it} missing "
                        f"or invalid; restarting from scratch (value-exact "
                        f"for iteration-determined trainables, timing is not)")
                    trial.checkpoint = None
                    trial.status = TrialStatus.PENDING
                if d_it > 0:
                    result_fences[tid] = d_it
                phase = self.result_t.get(tid, {}).get(d_it)
                trial.resume_phase_t = phase
                entries.append((phase if phase is not None else float("inf"),
                                idx, tid))
                continue
            if tid not in self.active and not trial.results:
                # Never started: a plain PENDING trial the scheduler launches
                # through its own choose loop, after restored ones re-fill.
                trial.status = TrialStatus.PENDING
                continue
            k, path = _latest_valid_mirror(self.checkpoint_dir, tid, f)
            if path is not None:
                trial.checkpoint = Checkpoint(
                    trial_id=tid, training_iteration=k, path=path)
                trial.status = TrialStatus.PAUSED
            else:
                if f > 0:
                    self.warnings.append(
                        f"{tid}: no valid checkpoint mirror at or below "
                        f"iteration {f}; restarting from scratch")
                trial.checkpoint = None
                trial.status = TrialStatus.PENDING
                k = 0
            if f > 0:
                result_fences[tid] = f
            cs = self.ckpt_seen.get(tid, 0)
            if cs > k:
                event_fences[tid] = {"checkpointed": cs}
            phase = self.result_t.get(tid, {}).get(k)
            trial.resume_phase_t = phase
            entries.append((phase if phase is not None else float("inf"),
                            idx, tid))
        entries.sort()
        return result_fences, event_fences, [tid for _, _, tid in entries]


def prepare_resume(
    journal_path: str,
    search_state_path: Optional[str],
    scheduler: TrialScheduler,
    searcher: Optional[Searcher] = None,
    base_trials: Optional[List[Trial]] = None,
    checkpoint_dir: Optional[str] = None,
    trainable_name: str = "trainable",
    default_resources: Optional[Resources] = None,
    stopping_criteria: Optional[Dict[str, float]] = None,
) -> ResumePlan:
    """Rebuild a killed run's full state into a :class:`ResumePlan`.

    ``scheduler`` (and ``searcher``, when given) must be **freshly
    constructed** with the original run's arguments: their mutable state is
    installed here — from the watermarked snapshot when one is usable, else
    by cold-replaying the whole journal through them.

    ``base_trials`` is the identity source for the run's *initial* trial
    set — same ids, same configs, same generation order as the original
    process (regenerated from the space, or loaded from the legacy pkl).
    Trials the searcher suggested mid-run are reconstructed from the journal
    itself.  Only identity fields are read; transient state is rebuilt.
    """
    repair_journal(journal_path)
    with open(journal_path, "r") as f:
        header, records, skipped = parse_journal_lines(f)

    replay = _Replay(scheduler, searcher, trainable_name, default_resources,
                     stopping_criteria, checkpoint_dir)
    replay.seed_base_trials(list(base_trials or []))

    # -- snapshot: how much of the journal is already folded in? -----------------
    state = load_search_state(search_state_path) if search_state_path else None
    watermark = 0
    used_snapshot = False
    searcher_state: Optional[Dict[str, Any]] = None
    if state is not None:
        w = state.get("journal_records")
        sch = state.get("scheduler") or {}
        if (isinstance(w, int) and 0 <= w <= len(records)
                and sch.get("type") == type(scheduler).__name__):
            watermark, used_snapshot = w, True
            se = state.get("searcher") or {}
            if searcher is not None and se.get("type") == type(searcher).__name__:
                searcher_state = se.get("state")
        else:
            replay.warnings.append(
                "search_state.json unusable (missing watermark or "
                "scheduler type mismatch); cold-replaying the full journal")

    if used_snapshot:
        # Shells for every trial the snapshot may reference (HyperBand
        # serializes bracket members by id and resolves them on load).
        for rec in records[:watermark]:
            tid = rec.get("trial_id")
            if isinstance(tid, str):
                cfg = rec.get("config") if rec.get("event") == "result" else None
                replay.ensure(tid, cfg if isinstance(cfg, dict) else None)
        try:
            sched_state = (state.get("scheduler") or {}).get("state") or {}
            if "trials" in inspect.signature(scheduler.load_state_dict).parameters:
                scheduler.load_state_dict(sched_state, trials=replay.trial_map)
            else:
                scheduler.load_state_dict(sched_state)
        except Exception as e:
            replay.warnings.append(
                f"scheduler snapshot failed to load ({e!r}); "
                f"cold-replaying the full journal")
            watermark, used_snapshot = 0, False
    if used_snapshot and searcher_state is not None:
        try:
            searcher.load_state_dict(searcher_state)
            # Suggested-but-resultless trials have no config in the journal
            # yet; TPE/GP snapshots carry it in their pending map.
            for tid, cfg in (searcher_state.get("pending") or {}).items():
                if isinstance(cfg, dict):
                    replay.ensure(str(tid), cfg)
        except Exception as e:
            replay.warnings.append(f"searcher snapshot failed to load ({e!r}); "
                                   f"searcher continues from its fresh state")

    if not used_snapshot:
        # Cold replay: re-register the initial trials in generation order so
        # per-add scheduler state (ASHA's bracket draws, HyperBand membership)
        # rebuilds exactly; suggested trials re-add at their journal records.
        for trial in replay.trial_list:
            if not replay._sugg_pat.match(trial.trial_id):
                scheduler.on_trial_add(replay.shim, trial)
        replay._drain()

    replay.replay(records, watermark)
    result_fences, event_fences, resume_order = replay.reconcile()

    return ResumePlan(
        trials=replay.trial_list,
        result_fences=result_fences,
        event_fences=event_fences,
        resume_order=resume_order,
        next_suggest_index=replay.max_sugg + 1,
        n_journal_records=len(records),
        used_snapshot=used_snapshot,
        warnings=replay.warnings,
    )
