"""Static HTML run report from a run's observability artifacts (DESIGN.md §9).

    PYTHONPATH=src python -m repro_torch.launch.report runs/demo
    PYTHONPATH=src python -m repro_torch.launch.report --journal runs/demo/events.jsonl \
        --trace trace.json --metrics runs/demo/metrics.jsonl \
        --metric loss --mode min --out report.html

Positional form: point it at a ``--log-dir`` from a previous run and it picks
up ``events.jsonl`` / ``metrics.jsonl`` / ``trace.json`` if present, writing
``report.html`` next to them.  The report is one self-contained HTML file —
inline CSS + inline SVG, no scripts, no external fetches — rendered by
``repro_torch.obs.report.build_report`` from the JSONL journal (v2 with run_header
or header-less v1, truncated tails tolerated), the Chrome trace (lifecycle
gantt + restart markers), and the metrics snapshot stream.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..obs.analysis import ExperimentAnalysis
from ..obs.report import build_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_dir", nargs="?", default=None,
                    help="run directory: uses events.jsonl / metrics.jsonl / "
                         "trace.json found inside, writes report.html there")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="JSONL event journal (overrides log_dir discovery)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome trace-event JSON for the lifecycle gantt")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="metrics snapshot JSONL stream")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="output HTML path (default: <log_dir>/report.html "
                         "or report.html beside the journal)")
    ap.add_argument("--metric", default=None,
                    help="metric for curves/best-config ranking (default: "
                         "first metric in the journal)")
    ap.add_argument("--mode", default="min", choices=["min", "max"])
    ap.add_argument("--title", default="repro run report")
    args = ap.parse_args(argv)

    journal, trace, metrics, out = (args.journal, args.trace, args.metrics,
                                    args.out)
    if args.log_dir:
        def find(name):
            p = os.path.join(args.log_dir, name)
            return p if os.path.exists(p) else None
        journal = journal or find("events.jsonl")
        trace = trace or find("trace.json")
        metrics = metrics or find("metrics.jsonl")
        out = out or os.path.join(args.log_dir, "report.html")
    if journal is None:
        ap.error("no journal: pass --journal PATH or a log_dir containing "
                 "events.jsonl")
    out = out or os.path.join(os.path.dirname(journal) or ".", "report.html")

    analysis = ExperimentAnalysis.from_journal(journal)
    html = build_report(analysis=analysis, trace_path=trace,
                        metrics_path=metrics, metric=args.metric,
                        mode=args.mode, title=args.title)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(html)
    summary = analysis.summary(metric=args.metric, mode=args.mode)
    print(f"[report] {len(analysis)} trials "
          f"({summary['total_results']} results, "
          f"{summary['total_iterations']} iterations) -> {out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
