"""ExperimentAnalysis over the JSONL journal (DESIGN.md §9).

``repro_torch.core.experiment.ExperimentAnalysis`` answers queries from live Trial
objects; this module answers the same questions from the *journal* — the
``events.jsonl`` stream a run leaves behind — so a detached process (report
generator, dashboard, a later resume) can reconstruct per-trial time series
and the scheduler's decision history without the producing process.

Parsing contract (mirrors JSONLLogger):

- A v2 stream opens with a ``run_header`` record; v1 streams have none.
  Readers filter on the ``event`` key and ignore unknown keys/records, so
  both parse through one code path.
- A crashed producer may leave a truncated final line — unparseable lines
  are skipped, never raised on.  Every record the producer flushed before
  dying is recovered (JSONLLogger flushes per line).

Determinism contract: ``summary()``/``summary_json()`` fold only journal
fields that are deterministic under a VirtualClock run (virtual timestamps
included; ``run_id`` and hardware-profile wall timings excluded), serialized
with sorted keys and fixed separators — two identical-token scenario runs
produce byte-identical summaries (asserted in tests/test_analysis_report.py).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["TrialRecord", "ExperimentAnalysis", "DECISION_EVENTS",
           "format_decision", "parse_journal_lines"]


def parse_journal_lines(lines: Iterable[str]
                        ) -> Tuple[Optional[Dict[str, Any]],
                                   List[Dict[str, Any]], int]:
    """Tolerant ordered parse of a JSONL journal: ``(header, records, skipped)``.

    The one journal-reading code path (parsing contract in the module
    docstring), shared by ``ExperimentAnalysis.from_lines`` and durable
    resume (``repro_torch.core.resume``), which needs the records *in stream
    order* rather than folded per trial.  ``header`` is the first
    ``run_header`` (None on a v1 stream); later headers — a resumed run
    appends one per resume (DESIGN.md §12) — are dropped without counting
    as skipped.  ``records`` holds every other parseable dict in order;
    ``skipped`` counts unparseable/non-dict lines (the torn tail of a
    crashed producer)."""
    header: Optional[Dict[str, Any]] = None
    records: List[Dict[str, Any]] = []
    skipped = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except (ValueError, TypeError):
            skipped += 1  # truncated tail of a crashed run, or junk
            continue
        if not isinstance(obj, dict):
            skipped += 1
            continue
        if obj.get("event") == "run_header":
            if header is None:
                header = obj
            continue
        records.append(obj)
    return header, records, skipped

# The scheduler/fault decision kinds reconstructed into per-trial timelines
# (lowercased on the wire by JSONLLogger.on_event).  "decision" is the typed
# provenance record (schema v3, DESIGN.md §10): a scheduler/searcher/runner
# verdict carrying the inputs that produced it.
DECISION_EVENTS = ("restarted", "resized", "resize_failed", "credits",
                  "killed", "heartbeat_missed", "decision")


def format_decision(info: Dict[str, Any]) -> str:
    """One-line human rendering of a DECISION record's ``info`` payload.

    Shared by the explain CLI and the HTML report's provenance table, so
    both surfaces answer "why?" with the same words.  Deterministic: pure
    function of the record, %.6g for floats.
    """
    def _f(v: Any) -> str:
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)

    verdict = info.get("verdict", "?")
    by = info.get("by", info.get("source", "?"))
    inputs = info.get("inputs") or {}
    reason = inputs.get("reason")
    if reason == "stopping_criterion":
        detail = (f"{inputs.get('criterion')} reached its bound "
                  f"({_f(inputs.get('value'))} >= {_f(inputs.get('bound'))})")
    elif reason == "result_done":
        detail = "trainable reported done"
    elif reason == "max_t":
        detail = f"reached max_t={_f(inputs.get('max_t'))}"
    elif reason == "rung":
        detail = (f"rung@{_f(inputs.get('milestone'))} score "
                  f"{_f(inputs.get('score'))} vs cutoff "
                  f"{_f(inputs.get('cutoff'))} "
                  f"(n={_f(inputs.get('n_rung'))}, rf={_f(inputs.get('rf'))})")
    elif reason == "milestone_wait":
        detail = (f"waiting at milestone {_f(inputs.get('milestone'))} "
                  f"round {_f(inputs.get('round'))} "
                  f"({_f(inputs.get('n_arrived'))}/{_f(inputs.get('n_live'))} "
                  f"arrived)")
    elif reason in ("cut", "cut_after_error"):
        detail = (f"halving cut@{_f(inputs.get('milestone'))} rank "
                  f"{_f(inputs.get('rank'))}/{_f(inputs.get('n_live'))} "
                  f"(keep {_f(inputs.get('n_keep'))}, score "
                  f"{_f(inputs.get('score'))} vs cut "
                  f"{_f(inputs.get('cut_score'))})")
    elif reason == "median":
        detail = (f"best-so-far {_f(inputs.get('best_so_far'))} vs median "
                  f"{_f(inputs.get('median'))} of {_f(inputs.get('n_others'))} "
                  f"trials at step {_f(inputs.get('step'))}")
    elif reason == "exploit":
        detail = (f"exploit donor {inputs.get('donor')} "
                  f"(donor score {_f(inputs.get('donor_score'))} vs mine "
                  f"{_f(inputs.get('my_score'))}, bottom "
                  f"{_f(inputs.get('n_bottom'))}/{_f(inputs.get('population'))})")
    elif "strategy" in inputs:
        extras = {k: v for k, v in sorted(inputs.items()) if k != "strategy"}
        kv = " ".join(f"{k}={_f(v)}" for k, v in extras.items())
        detail = f"suggested via {inputs['strategy']}" + (f" ({kv})" if kv else "")
    else:
        kv = " ".join(f"{k}={_f(v)}" for k, v in sorted(inputs.items()))
        detail = kv or "(no inputs recorded)"
    return f"{verdict} by {by}: {detail}"

_NUMERIC = (int, float)


@dataclass
class TrialRecord:
    """Everything the journal says about one trial."""

    trial_id: str
    config: Dict[str, Any] = field(default_factory=dict)
    status: Optional[str] = None          # terminal status, None = never completed
    iterations: int = 0
    # metric name -> [(t, training_iteration, value)] in journal order
    series: Dict[str, List[Tuple[float, int, float]]] = field(default_factory=dict)
    # full non-result event timeline: [(t, seq, kind, info)] in journal order
    events: List[Tuple[float, int, str, Dict[str, Any]]] = field(default_factory=list)
    profile: Optional[Dict[str, Any]] = None
    n_results: int = 0

    @property
    def completed(self) -> bool:
        return self.status is not None

    def count(self, kind: str) -> int:
        return sum(1 for _, _, k, _ in self.events if k == kind)

    def last_value(self, metric: str) -> Optional[float]:
        pts = self.series.get(metric)
        return pts[-1][2] if pts else None

    def best_value(self, metric: str, mode: str = "max") -> Optional[float]:
        pts = self.series.get(metric)
        if not pts:
            return None
        vals = [v for _, _, v in pts]
        return max(vals) if mode == "max" else min(vals)

    def decision_timeline(self) -> List[Dict[str, Any]]:
        """RESTARTED/RESIZED/CREDITS/KILLED/... fault events merged with the
        typed DECISION provenance records (schema v3), in journal order."""
        return [
            {"t": t, "seq": seq, "kind": kind, "info": info}
            for t, seq, kind, info in self.events if kind in DECISION_EVENTS
        ]

    def decisions(self) -> List[Dict[str, Any]]:
        """Just the typed DECISION records (verdict + inputs), in order."""
        return [
            {"t": t, "seq": seq, "info": info}
            for t, seq, kind, info in self.events if kind == "decision"
        ]


class ExperimentAnalysis:
    """Queryable view over one journal (see module docstring)."""

    def __init__(self, records: Dict[str, TrialRecord],
                 header: Optional[Dict[str, Any]] = None,
                 n_skipped_lines: int = 0):
        self.records = records
        self.header = header            # None on a v1 (header-less) stream
        self.n_skipped_lines = n_skipped_lines

    # -- construction -----------------------------------------------------------
    @classmethod
    def from_journal(cls, path: str) -> "ExperimentAnalysis":
        with open(path, "r") as f:
            return cls.from_lines(f)

    @classmethod
    def from_lines(cls, lines: Iterable[str]) -> "ExperimentAnalysis":
        records: Dict[str, TrialRecord] = {}
        header, stream, skipped = parse_journal_lines(lines)

        def rec(trial_id: str) -> TrialRecord:
            r = records.get(trial_id)
            if r is None:
                r = records[trial_id] = TrialRecord(trial_id)
            return r

        for obj in stream:
            kind = obj.get("event")
            trial_id = obj.get("trial_id")
            if not isinstance(trial_id, str):
                continue  # unknown record shape: tolerated, not indexed
            r = rec(trial_id)
            if kind == "result":
                r.n_results += 1
                it = obj.get("iteration", 0)
                if isinstance(it, _NUMERIC):
                    r.iterations = max(r.iterations, int(it))
                cfg = obj.get("config")
                if isinstance(cfg, dict) and not r.config:
                    r.config = cfg
                t = obj.get("t", 0.0)
                metrics = obj.get("metrics")
                if isinstance(metrics, dict):
                    for m, v in metrics.items():
                        if isinstance(v, _NUMERIC) and not isinstance(v, bool):
                            r.series.setdefault(m, []).append(
                                (float(t), int(it), float(v)))
            elif kind == "complete":
                r.status = obj.get("status")
                it = obj.get("iterations", 0)
                if isinstance(it, _NUMERIC):
                    r.iterations = max(r.iterations, int(it))
            elif kind == "profile":
                r.profile = obj.get("info") or {}
            elif isinstance(kind, str):
                r.events.append((
                    float(obj.get("t", 0.0)), int(obj.get("seq", -1)),
                    kind, obj.get("info") or {}))
        return cls(records, header=header, n_skipped_lines=skipped)

    # -- queries ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def trial_ids(self) -> List[str]:
        return sorted(self.records)

    def get(self, trial_id: str) -> Optional[TrialRecord]:
        return self.records.get(trial_id)

    def best_trial(self, metric: str, mode: str = "max") -> Optional[TrialRecord]:
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        best, best_v = None, None
        for tid in sorted(self.records):  # deterministic tie-break
            v = self.records[tid].best_value(metric, mode)
            if v is None:
                continue
            if best_v is None or (v > best_v if mode == "max" else v < best_v):
                best, best_v = self.records[tid], v
        return best

    def dataframe(self, metric: Optional[str] = None) -> Dict[str, List[Any]]:
        """Column-oriented trial table (a dict of equal-length lists — the
        zero-dependency stand-in for a pandas DataFrame)."""
        cols: Dict[str, List[Any]] = {
            "trial_id": [], "status": [], "iterations": [], "n_results": [],
            "restarts": [], "resizes": [], "kills": [],
        }
        if metric is not None:
            cols[f"last_{metric}"] = []
            cols[f"best_{metric}"] = []
        for tid in sorted(self.records):
            r = self.records[tid]
            cols["trial_id"].append(tid)
            cols["status"].append(r.status)
            cols["iterations"].append(r.iterations)
            cols["n_results"].append(r.n_results)
            cols["restarts"].append(r.count("restarted"))
            cols["resizes"].append(r.count("resized"))
            cols["kills"].append(r.count("killed"))
            if metric is not None:
                cols[f"last_{metric}"].append(r.last_value(metric))
                cols[f"best_{metric}"].append(r.best_value(metric, "max"))
        return cols

    def decision_timeline(self, trial_id: str) -> List[Dict[str, Any]]:
        r = self.records.get(trial_id)
        return r.decision_timeline() if r is not None else []

    def decisions(self, trial_id: str) -> List[Dict[str, Any]]:
        r = self.records.get(trial_id)
        return r.decisions() if r is not None else []

    def status_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self.records.values():
            key = r.status or "(in flight)"
            counts[key] = counts.get(key, 0) + 1
        return dict(sorted(counts.items()))

    # -- cross-run diff ---------------------------------------------------------
    def diff(self, other: "ExperimentAnalysis",
             metric: Optional[str] = None) -> Dict[str, Any]:
        """Compare two journals trial-by-trial.  Runs produced with the same
        scenario ``token`` (repro.testing) share trial ids, so the alignment
        is exact; for ad-hoc runs only the id intersection is compared."""
        mine, theirs = set(self.records), set(other.records)
        changed: Dict[str, Dict[str, Any]] = {}
        for tid in sorted(mine & theirs):
            a, b = self.records[tid], other.records[tid]
            delta: Dict[str, Any] = {}
            if a.status != b.status:
                delta["status"] = [a.status, b.status]
            if a.iterations != b.iterations:
                delta["iterations"] = [a.iterations, b.iterations]
            for kind in ("restarted", "resized", "killed"):
                ca, cb = a.count(kind), b.count(kind)
                if ca != cb:
                    delta[kind] = [ca, cb]
            if metric is not None:
                va, vb = a.best_value(metric), b.best_value(metric)
                if va != vb:
                    delta[f"best_{metric}"] = [va, vb]
            if delta:
                changed[tid] = delta
        return {
            "only_in_self": sorted(mine - theirs),
            "only_in_other": sorted(theirs - mine),
            "changed": changed,
            "n_common": len(mine & theirs),
        }

    # -- canonical summary -------------------------------------------------------
    def summary(self, metric: Optional[str] = None,
                mode: str = "max") -> Dict[str, Any]:
        """Deterministic run digest: everything here is a pure function of
        the journal's deterministic fields (see module docstring), so two
        identical VirtualClock runs summarize byte-identically."""
        out: Dict[str, Any] = {
            "schema_version": (self.header or {}).get("schema_version"),
            "clock": (self.header or {}).get("clock"),
            "executor": (self.header or {}).get("executor"),
            "n_trials": len(self.records),
            "status_counts": self.status_counts(),
            "total_iterations": sum(r.iterations for r in self.records.values()),
            "total_results": sum(r.n_results for r in self.records.values()),
            "events": self._event_totals(),
            "skipped_lines": self.n_skipped_lines,
        }
        if metric is not None:
            best = self.best_trial(metric, mode)
            out["best"] = None if best is None else {
                "trial_id": best.trial_id,
                "config": best.config,
                "value": best.best_value(metric, mode),
                "iterations": best.iterations,
            }
        return out

    def summary_json(self, metric: Optional[str] = None,
                     mode: str = "max") -> str:
        return json.dumps(self.summary(metric, mode), sort_keys=True,
                          separators=(",", ":"))

    def _event_totals(self) -> Dict[str, int]:
        totals: Dict[str, int] = {}
        for r in self.records.values():
            for _, _, kind, _ in r.events:
                totals[kind] = totals.get(kind, 0) + 1
        return dict(sorted(totals.items()))
