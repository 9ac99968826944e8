"""Explain scheduler/searcher verdicts from the decision journal (DESIGN.md §10).

    PYTHONPATH=src python -m repro_torch.launch.explain runs/demo --trial my_trial_00003
    PYTHONPATH=src python -m repro_torch.launch.explain --journal runs/demo/events.jsonl
    PYTHONPATH=src python -m repro_torch.launch.explain --bundle flightrec/run-x-00-sigterm.json

Answers "why did trial X stop / pause / get perturbed?" from DECISION records
alone — either from the JSONL journal (schema v3) or from a flight-recorder
forensic bundle dumped at crash time.  Output is deterministic (virtual
timestamps, %.6g floats, sorted trials), so two identical-token VirtualClock
runs explain byte-identically — the same comparability contract as traces,
summaries, and bundles.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..obs.analysis import ExperimentAnalysis, format_decision


def _fmt_t(t: Any) -> str:
    if isinstance(t, float):
        return f"{t:.6g}"
    return str(t)


def _lines_for_trial(trial_id: str, status: Optional[str],
                     iterations: Optional[Any],
                     decisions: List[Dict[str, Any]]) -> List[str]:
    head = f"trial {trial_id}"
    meta = []
    if status is not None:
        meta.append(str(status))
    if iterations is not None:
        meta.append(f"{iterations} iterations")
    if meta:
        head += ": " + ", ".join(meta)
    out = [head]
    if not decisions:
        out.append("  no decision records (pre-v3 journal, or decisions=False)")
        return out
    for d in decisions:
        out.append(f"  [t={_fmt_t(d.get('t'))}] "
                   f"{format_decision(d.get('info') or {})}")
    fate = next((d for d in reversed(decisions)
                 if (d.get("info") or {}).get("verdict") != "SUGGEST"), None)
    if fate is not None:
        out.append(f"  fate: {format_decision(fate.get('info') or {})}")
    return out


def _from_journal(path: str, trial_id: Optional[str]) -> List[str]:
    an = ExperimentAnalysis.from_journal(path)
    if trial_id is not None:
        r = an.get(trial_id)
        if r is None:
            return [f"trial {trial_id}: not in journal"]
        return _lines_for_trial(trial_id, r.status, r.iterations,
                                r.decisions())
    out: List[str] = []
    for tid in an.trial_ids():
        r = an.get(tid)
        decs = r.decisions()
        if decs:
            out += _lines_for_trial(tid, r.status, r.iterations, decs)
    return out or ["no decision records in journal"]


def _from_bundle(path: str, trial_id: Optional[str]) -> List[str]:
    with open(path) as f:
        bundle = json.load(f)
    by_trial: Dict[str, List[Dict[str, Any]]] = {}
    for row in bundle.get("decisions") or []:
        tid = row.get("trial_id")
        if isinstance(tid, str):
            by_trial.setdefault(tid, []).append(row)
    table = {r.get("trial_id"): r for r in bundle.get("trials") or []}
    out = [f"bundle {bundle.get('run_id')}: reason={bundle.get('reason')} "
           f"t={_fmt_t(bundle.get('t_virtual'))}"]
    tids = [trial_id] if trial_id is not None else sorted(by_trial)
    for tid in tids:
        decs = by_trial.get(tid)
        tr = table.get(tid) or {}
        if decs is None and trial_id is not None:
            out.append(f"trial {tid}: no decision records in bundle "
                       f"(ring holds the last "
                       f"{len(bundle.get('decisions') or [])})")
            continue
        out += _lines_for_trial(tid, tr.get("status"), tr.get("iteration"),
                                decs or [])
    if trial_id is None and not by_trial:
        out.append("no decision records in bundle")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_dir", nargs="?", default=None,
                    help="run directory: uses events.jsonl found inside")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="JSONL event journal (overrides log_dir discovery)")
    ap.add_argument("--bundle", default=None, metavar="PATH",
                    help="flight-recorder forensic bundle JSON (answers from "
                         "the crash dump instead of the journal)")
    ap.add_argument("--trial", default=None, metavar="ID",
                    help="explain one trial (default: all trials that have "
                         "decision records)")
    args = ap.parse_args(argv)

    journal = args.journal
    if args.log_dir and journal is None and args.bundle is None:
        p = os.path.join(args.log_dir, "events.jsonl")
        journal = p if os.path.exists(p) else None
    if args.bundle is not None:
        lines = _from_bundle(args.bundle, args.trial)
    elif journal is not None:
        lines = _from_journal(journal, args.trial)
    else:
        ap.error("no source: pass --journal PATH, --bundle PATH, or a "
                 "log_dir containing events.jsonl")
        return 2  # unreachable; ap.error raises SystemExit
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
