"""Static self-contained HTML run report (DESIGN.md §9).

``build_report`` renders one experiment's artifacts — the JSONL journal
(required), the Chrome trace (optional) and the metrics JSONL stream
(optional) — into a single HTML string with inline CSS and inline SVG: no
scripts, no external fetches, nothing but the file.  ``launch/report.py``
is the CLI wrapper that writes it next to the trace.

Sections: run summary + status tiles, best-config table, per-trial metric
curves (best trial highlighted, the rest recessive), trial-lifecycle gantt
reconstructed from the trace's ``thread_name`` metadata + ``trial`` spans
(restart markers from the ``restart`` fault instants), and the control-plane
metrics snapshot (counter table + latency-histogram mean bars).

Determinism contract: the output is a pure function of the input files —
no generation timestamps, all iteration orders sorted, all floats formatted
through one ``%.6g`` path — so two identical VirtualClock runs produce
byte-identical report bodies (asserted in tests/test_analysis_report.py).

Palette: the dataviz reference instance (validated for both modes) — series
slots 1-2, status colors paired with text labels, text in ink tokens only.
"""
from __future__ import annotations

import html
import json
from typing import Any, Dict, List, Optional, Tuple

from .analysis import ExperimentAnalysis

__all__ = ["build_report"]

_MAX_CURVES = 64       # polylines in the metric chart
_MAX_GANTT_ROWS = 64   # trial rows in the lifecycle gantt
_MAX_CONFIG_ROWS = 10  # best-config table

_CSS = """
:root { color-scheme: light; }
body {
  margin: 2rem auto; max-width: 62rem; padding: 0 1rem;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: #f9f9f7; color: #0b0b0b;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b; --text-secondary: #52514e;
  --text-muted: #898781; --grid: #e1e0d9; --baseline: #c3c2b7;
  --series-1: #2a78d6; --series-2: #eb6834; --series-rest: #9ec5f4;
  --status-critical: #d03b3b; --status-good: #0ca30c;
  --border: rgba(11,11,11,0.10);
}
@media (prefers-color-scheme: dark) {
  :root { color-scheme: dark; }
  body {
    background: #0d0d0d; color: #ffffff;
    --surface-1: #1a1a19; --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --text-muted: #898781; --grid: #2c2c2a; --baseline: #383835;
    --series-1: #3987e5; --series-2: #d95926; --series-rest: #184f95;
    --status-critical: #d03b3b; --status-good: #0ca30c;
    --border: rgba(255,255,255,0.10);
  }
}
h1 { font-size: 1.4rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
.card { background: var(--surface-1); border: 1px solid var(--border);
        border-radius: 8px; padding: 1rem; margin: 0.75rem 0; }
.tiles { display: flex; flex-wrap: wrap; gap: 0.75rem; }
.tile { background: var(--surface-1); border: 1px solid var(--border);
        border-radius: 8px; padding: 0.6rem 1rem; min-width: 7rem; }
.tile .label { font-size: 0.75rem; color: var(--text-secondary); }
.tile .value { font-size: 1.5rem; font-weight: 600; }
table { border-collapse: collapse; width: 100%; font-size: 0.85rem; }
th { text-align: left; color: var(--text-secondary); font-weight: 600; }
th, td { padding: 0.3rem 0.6rem; border-bottom: 1px solid var(--grid); }
td.num, th.num { text-align: right; font-variant-numeric: tabular-nums; }
.note { color: var(--text-muted); font-size: 0.8rem; }
svg text { font-family: system-ui, -apple-system, "Segoe UI", sans-serif; }
.legend { display: flex; gap: 1.25rem; font-size: 0.8rem;
          color: var(--text-secondary); margin: 0.25rem 0 0.5rem; }
.legend .key { display: inline-block; width: 14px; height: 3px;
               border-radius: 2px; vertical-align: middle;
               margin-right: 0.4rem; }
"""


def _esc(v: Any) -> str:
    return html.escape(str(v), quote=True)


def _fmt(v: Any) -> str:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return _esc(v)
    if isinstance(v, int):
        return f"{v:,}"
    return f"{v:.6g}"


def _nice_ticks(lo: float, hi: float, n: int = 4) -> List[float]:
    """Clean tick values covering [lo, hi] — deterministic, no float drift
    surprises (everything renders through %.6g anyway)."""
    if hi <= lo:
        return [lo]
    span = hi - lo
    import math
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    first = math.ceil(lo / step) * step
    ticks, t = [], first
    while t <= hi + 1e-12 * span:
        ticks.append(round(t, 10))
        t += step
    return ticks or [lo]


# -- metric curves ---------------------------------------------------------------
def _metric_chart(analysis: ExperimentAnalysis, metric: str, mode: str) -> str:
    series: List[Tuple[str, List[Tuple[int, float]]]] = []
    for tid in sorted(analysis.records):
        pts = analysis.records[tid].series.get(metric)
        if pts:
            series.append((tid, [(it, v) for _, it, v in pts]))
    if not series:
        return "<p class='note'>no numeric series for this metric in the journal</p>"
    best = analysis.best_trial(metric, mode)
    best_id = best.trial_id if best is not None else None
    shown = series[:_MAX_CURVES]
    if best_id is not None and best_id not in {t for t, _ in shown}:
        shown = shown[:-1] + [(best_id, [
            (it, v) for _, it, v in analysis.records[best_id].series[metric]])]

    w, h, ml, mr, mt, mb = 640, 240, 52, 110, 12, 28
    xs = [p[0] for _, pts in shown for p in pts]
    ys = [p[1] for _, pts in shown for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y1 = y0 + 1 or 1

    def X(x: float) -> float:
        return ml + (x - x0) / (x1 - x0) * (w - ml - mr)

    def Y(y: float) -> float:
        return h - mb - (y - y0) / (y1 - y0) * (h - mt - mb)

    out = [f"<svg viewBox='0 0 {w} {h}' width='{w}' height='{h}' "
           f"role='img' aria-label='{_esc(metric)} per trial'>"]
    for ty in _nice_ticks(y0, y1):
        out.append(f"<line x1='{ml}' y1='{Y(ty):.1f}' x2='{w - mr}' "
                   f"y2='{Y(ty):.1f}' stroke='var(--grid)' stroke-width='1'/>")
        out.append(f"<text x='{ml - 6}' y='{Y(ty) + 3:.1f}' text-anchor='end' "
                   f"font-size='10' fill='var(--text-muted)'>{_fmt(ty)}</text>")
    for tx in _nice_ticks(x0, x1):
        out.append(f"<text x='{X(tx):.1f}' y='{h - mb + 14}' text-anchor='middle' "
                   f"font-size='10' fill='var(--text-muted)'>{_fmt(tx)}</text>")
    out.append(f"<line x1='{ml}' y1='{h - mb}' x2='{w - mr}' y2='{h - mb}' "
               f"stroke='var(--baseline)' stroke-width='1'/>")
    best_svg = ""
    for tid, pts in shown:
        d = " ".join(f"{X(x):.1f},{Y(y):.1f}" for x, y in pts)
        label = _esc(tid)
        if tid == best_id:
            # Best trial on top of the recessive rest, end-dot + direct label.
            ex, ey = X(pts[-1][0]), Y(pts[-1][1])
            best_svg = (
                f"<polyline points='{d}' fill='none' stroke='var(--series-1)' "
                f"stroke-width='2' stroke-linejoin='round' "
                f"stroke-linecap='round'><title>{label}</title></polyline>"
                f"<circle cx='{ex:.1f}' cy='{ey:.1f}' r='4' "
                f"fill='var(--series-1)' stroke='var(--surface-1)' "
                f"stroke-width='2'/>"
                f"<text x='{ex + 8:.1f}' y='{ey + 3:.1f}' font-size='10' "
                f"fill='var(--text-secondary)'>{label}</text>")
        else:
            out.append(f"<polyline points='{d}' fill='none' "
                       f"stroke='var(--series-rest)' stroke-width='1.5' "
                       f"stroke-linejoin='round'><title>{label}</title>"
                       f"</polyline>")
    out.append(best_svg)
    out.append("</svg>")
    note = ""
    if len(series) > len(shown):
        note = (f"<p class='note'>showing {len(shown)} of {len(series)} "
                f"trial curves (cap {_MAX_CURVES}); the rest are in the "
                f"table below</p>")
    legend = (
        "<div class='legend'>"
        "<span><span class='key' style='background:var(--series-1)'></span>"
        f"best trial ({_esc(best_id) if best_id else 'n/a'})</span>"
        "<span><span class='key' style='background:var(--series-rest)'></span>"
        "other trials</span></div>")
    return legend + "".join(out) + note


# -- lifecycle gantt (from the Chrome trace) --------------------------------------
def _load_trace(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        obj = json.load(f)
    evs = obj.get("traceEvents", obj) if isinstance(obj, dict) else obj
    return evs if isinstance(evs, list) else []


def _gantt_chart(trace_events: List[Dict[str, Any]]) -> str:
    # tid -> row label from thread_name metadata (trial ids; tid 0 = control).
    names: Dict[int, str] = {}
    for e in trace_events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[e.get("tid", -1)] = e.get("args", {}).get("name", "")
    spans = [e for e in trace_events
             if e.get("ph") == "X" and e.get("name") == "trial"]
    restarts = [e for e in trace_events
                if e.get("ph") == "X" and e.get("name") == "restart"]
    if not spans:
        return ("<p class='note'>no trial lifecycle spans in the trace "
                "(was the run traced?)</p>")
    rows = sorted({names.get(e.get("tid"), str(e.get("tid"))) for e in spans})
    shown_rows = rows[:_MAX_GANTT_ROWS]
    row_of = {r: i for i, r in enumerate(shown_rows)}
    t1 = max(e["ts"] + e.get("dur", 0) for e in spans) or 1

    rh, gap, ml, mr, mt, mb = 12, 4, 150, 16, 8, 22
    w = 640
    h = mt + mb + len(shown_rows) * (rh + gap)
    plot_w = w - ml - mr

    def X(ts: float) -> float:
        return ml + ts / t1 * plot_w

    out = [f"<svg viewBox='0 0 {w} {h}' width='{w}' height='{h}' role='img' "
           f"aria-label='trial lifecycle gantt'>"]
    for tx in _nice_ticks(0, t1 / 1e6):
        out.append(f"<line x1='{X(tx * 1e6):.1f}' y1='{mt}' "
                   f"x2='{X(tx * 1e6):.1f}' y2='{h - mb}' "
                   f"stroke='var(--grid)' stroke-width='1'/>")
        out.append(f"<text x='{X(tx * 1e6):.1f}' y='{h - 6}' "
                   f"text-anchor='middle' font-size='10' "
                   f"fill='var(--text-muted)'>{_fmt(tx)}s</text>")
    for e in sorted(spans, key=lambda e: (e.get("tid", 0), e["ts"])):
        label = names.get(e.get("tid"), str(e.get("tid")))
        if label not in row_of:
            continue
        y = mt + row_of[label] * (rh + gap)
        x, bw = X(e["ts"]), max(2.0, e.get("dur", 0) / t1 * plot_w)
        dur_s = e.get("dur", 0) / 1e6
        status = e.get("args", {}).get("status", "")
        out.append(
            f"<rect x='{x:.1f}' y='{y}' width='{bw:.1f}' height='{rh}' "
            f"rx='2' fill='var(--series-1)'>"
            f"<title>{_esc(label)}: {_fmt(dur_s)}s"
            f"{' → ' + _esc(status) if status else ''}</title></rect>")
    for e in restarts:
        label = names.get(e.get("tid"), str(e.get("tid")))
        if label not in row_of:
            continue
        y = mt + row_of[label] * (rh + gap)
        out.append(
            f"<rect x='{X(e['ts']) - 1:.1f}' y='{y - 2}' width='2' "
            f"height='{rh + 4}' fill='var(--status-critical)'>"
            f"<title>restart: {_esc(label)}</title></rect>")
    for label, i in row_of.items():
        y = mt + i * (rh + gap) + rh - 2
        out.append(f"<text x='{ml - 6}' y='{y}' text-anchor='end' "
                   f"font-size='9' fill='var(--text-secondary)'>"
                   f"{_esc(label)}</text>")
    out.append("</svg>")
    note = ""
    if len(rows) > len(shown_rows):
        note = (f"<p class='note'>showing {len(shown_rows)} of {len(rows)} "
                f"trial rows (cap {_MAX_GANTT_ROWS})</p>")
    legend = (
        "<div class='legend'>"
        "<span><span class='key' style='background:var(--series-1)'></span>"
        "lifecycle span (launch → stop/pause)</span>"
        "<span><span class='key' "
        "style='background:var(--status-critical);width:3px;height:12px'>"
        "</span>restart (fault boundary)</span></div>")
    return legend + "".join(out) + note


# -- metrics snapshot -------------------------------------------------------------
def _last_metrics_snapshot(path: str) -> Optional[Dict[str, Any]]:
    last = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue  # truncated tail
            if isinstance(obj, dict) and "metrics" in obj:
                last = obj
    return last


def _metrics_section(snap: Dict[str, Any]) -> str:
    metrics: Dict[str, Any] = snap.get("metrics", {})
    scalars = {k: v for k, v in sorted(metrics.items())
               if not isinstance(v, dict)}
    hists = {k: v for k, v in sorted(metrics.items())
             if isinstance(v, dict) and v.get("count")}
    out = []
    if hists:
        # Horizontal mean-latency bars: one hue, magnitude only.
        w, rh, gap, ml = 640, 14, 6, 170
        h = (rh + gap) * len(hists) + 24
        vmax = max(v["mean"] for v in hists.values()) or 1
        out.append(f"<svg viewBox='0 0 {w} {h}' width='{w}' height='{h}' "
                   f"role='img' aria-label='histogram means'>")
        for i, (name, v) in enumerate(hists.items()):
            y = i * (rh + gap)
            bw = max(2.0, v["mean"] / vmax * (w - ml - 120))
            out.append(f"<text x='{ml - 6}' y='{y + rh - 3}' text-anchor='end' "
                       f"font-size='10' fill='var(--text-secondary)'>"
                       f"{_esc(name)}</text>")
            out.append(f"<rect x='{ml}' y='{y}' width='{bw:.1f}' "
                       f"height='{rh}' rx='2' fill='var(--series-1)'>"
                       f"<title>{_esc(name)}: mean {_fmt(v['mean'])} "
                       f"(n={v['count']})</title></rect>")
            out.append(f"<text x='{ml + bw + 6:.1f}' y='{y + rh - 3}' "
                       f"font-size='10' fill='var(--text-secondary)'>"
                       f"{_fmt(v['mean'])} (n={_fmt(v['count'])})</text>")
        out.append("</svg>")
        out.append("<p class='note'>mean per histogram instrument "
                   "(µs for *_us, bytes/seconds otherwise), from the final "
                   "metrics snapshot</p>")
    if scalars:
        out.append("<table><tr><th>counter / gauge</th>"
                   "<th class='num'>value</th></tr>")
        for k, v in scalars.items():
            out.append(f"<tr><td>{_esc(k)}</td>"
                       f"<td class='num'>{_fmt(v)}</td></tr>")
        out.append("</table>")
    return "".join(out) or "<p class='note'>metrics stream is empty</p>"


# -- trial/fault tables -----------------------------------------------------------
def _best_table(analysis: ExperimentAnalysis, metric: str, mode: str) -> str:
    ranked = []
    for tid in sorted(analysis.records):
        v = analysis.records[tid].best_value(metric, mode)
        if v is not None:
            ranked.append((v, tid))
    ranked.sort(key=lambda p: (-p[0], p[1]) if mode == "max" else p)
    if not ranked:
        return "<p class='note'>no trials reported this metric</p>"
    keys = sorted({k for _, tid in ranked[:_MAX_CONFIG_ROWS]
                   for k in analysis.records[tid].config})
    out = ["<table><tr><th>#</th><th>trial</th>",
           f"<th class='num'>best {_esc(metric)}</th><th class='num'>iters</th>",
           f"<th class='num'>restarts</th>"]
    out += [f"<th class='num'>{_esc(k)}</th>" for k in keys]
    out.append("</tr>")
    for rank, (v, tid) in enumerate(ranked[:_MAX_CONFIG_ROWS], 1):
        r = analysis.records[tid]
        out.append(f"<tr><td>{rank}</td><td>{_esc(tid)}</td>"
                   f"<td class='num'>{_fmt(v)}</td>"
                   f"<td class='num'>{_fmt(r.iterations)}</td>"
                   f"<td class='num'>{_fmt(r.count('restarted'))}</td>")
        out += [f"<td class='num'>{_fmt(r.config.get(k, ''))}</td>"
                for k in keys]
        out.append("</tr>")
    out.append("</table>")
    if len(ranked) > _MAX_CONFIG_ROWS:
        out.append(f"<p class='note'>top {_MAX_CONFIG_ROWS} of "
                   f"{len(ranked)} ranked trials</p>")
    return "".join(out)


def _fault_table(analysis: ExperimentAnalysis) -> str:
    rows = []
    for tid in sorted(analysis.records):
        r = analysis.records[tid]
        n_restart, n_resize, n_kill = (r.count("restarted"),
                                       r.count("resized"), r.count("killed"))
        if n_restart or n_resize or n_kill or r.status == "ERROR":
            rows.append((tid, r, n_restart, n_resize, n_kill))
    if not rows:
        return "<p class='note'>clean run: no restarts, resizes, or kills</p>"
    out = ["<table><tr><th>trial</th><th>status</th>"
           "<th class='num'>restarts</th><th class='num'>resizes</th>"
           "<th class='num'>kills</th><th>decision timeline</th></tr>"]
    for tid, r, n_restart, n_resize, n_kill in rows[:_MAX_GANTT_ROWS]:
        timeline = "; ".join(
            f"{d['kind']}@{_fmt(d['t'])}" for d in r.decision_timeline()[:8])
        out.append(
            f"<tr><td>{_esc(tid)}</td><td>{_esc(r.status or 'in flight')}</td>"
            f"<td class='num'>{n_restart}</td><td class='num'>{n_resize}</td>"
            f"<td class='num'>{n_kill}</td><td>{_esc(timeline)}</td></tr>")
    out.append("</table>")
    if len(rows) > _MAX_GANTT_ROWS:
        out.append(f"<p class='note'>first {_MAX_GANTT_ROWS} of {len(rows)} "
                   f"trials with fault/decision activity</p>")
    return "".join(out)


def _provenance_table(analysis: ExperimentAnalysis) -> str:
    """Decision provenance (DESIGN.md §10): per-trial terminal verdicts with
    the inputs that produced them, rendered via ``format_decision`` so the
    report answers "why?" with the same words as the explain CLI."""
    from .analysis import format_decision
    rows = []
    n_total = 0
    for tid in sorted(analysis.records):
        decs = analysis.records[tid].decisions()
        if not decs:
            continue
        n_total += len(decs)
        # The last non-SUGGEST decision is the trial's fate; fall back to
        # the suggestion record for trials that ran to completion untouched.
        fate = next((d for d in reversed(decs)
                     if d["info"].get("verdict") != "SUGGEST"), decs[-1])
        rows.append((tid, len(decs), fate))
    if not rows:
        return ""
    out = ["<h2>Decision provenance</h2><div class='card'>",
           "<table><tr><th>trial</th><th class='num'>decisions</th>"
           "<th class='num'>t</th><th>last verdict (why)</th></tr>"]
    for tid, n, fate in rows[:_MAX_GANTT_ROWS]:
        out.append(f"<tr><td>{_esc(tid)}</td><td class='num'>{n}</td>"
                   f"<td class='num'>{_fmt(fate['t'])}</td>"
                   f"<td>{_esc(format_decision(fate['info']))}</td></tr>")
    out.append("</table>")
    if len(rows) > _MAX_GANTT_ROWS:
        out.append(f"<p class='note'>first {_MAX_GANTT_ROWS} of {len(rows)} "
                   f"trials with decision records</p>")
    out.append(f"<p class='note'>{n_total} DECISION records across "
               f"{len(rows)} trials (schema v3 journal)</p></div>")
    return "".join(out)


def _profile_table(analysis: ExperimentAnalysis) -> str:
    rows = [(tid, analysis.records[tid].profile)
            for tid in sorted(analysis.records)
            if analysis.records[tid].profile]
    if not rows:
        return ""
    cols = ["compile_s", "steady_step_s", "predicted_step_s", "dominant",
            "arg_bytes", "temp_bytes"]
    out = ["<h2>Hardware profiles</h2><div class='card'>",
           "<table><tr><th>trial</th>"]
    out += [f"<th class='num'>{_esc(c)}</th>" for c in cols]
    out.append("</tr>")
    for tid, prof in rows[:_MAX_GANTT_ROWS]:
        out.append(f"<tr><td>{_esc(tid)}</td>")
        out += [f"<td class='num'>{_fmt(prof.get(c, '-'))}</td>" for c in cols]
        out.append("</tr>")
    out.append("</table>")
    out.append("<p class='note'>step-time split is wall-clock (first step = "
               "compile + execute); roofline prediction from "
               "launch/roofline.py when profiling was enabled</p></div>")
    return "".join(out)


# -- entry point ------------------------------------------------------------------
def build_report(journal_path: Optional[str] = None,
                 analysis: Optional[ExperimentAnalysis] = None,
                 trace_path: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 metric: Optional[str] = None,
                 mode: str = "max",
                 title: str = "repro run report") -> str:
    """Render the report; pass a journal path or a pre-built analysis."""
    if analysis is None:
        if journal_path is None:
            raise ValueError("build_report needs journal_path or analysis")
        analysis = ExperimentAnalysis.from_journal(journal_path)
    if metric is None:
        # Deterministic default: the lexicographically-first metric any
        # trial reported.
        metric = next(iter(sorted(
            {m for r in analysis.records.values() for m in r.series})), None)

    header = analysis.header or {}
    tiles = [("trials", len(analysis.records)),
             ("results", sum(r.n_results for r in analysis.records.values())),
             ("iterations",
              sum(r.iterations for r in analysis.records.values()))]
    tiles += sorted(analysis.status_counts().items())
    tile_html = "".join(
        f"<div class='tile'><div class='label'>{_esc(k)}</div>"
        f"<div class='value'>{_fmt(v)}</div></div>" for k, v in tiles)

    head_rows = "".join(
        f"<tr><td>{_esc(k)}</td><td>{_esc(header.get(k, '-'))}</td></tr>"
        for k in ("schema_version", "clock", "executor"))

    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head><body>",
        f"<h1>{_esc(title)}</h1>",
        f"<div class='tiles'>{tile_html}</div>",
        "<h2>Run</h2><div class='card'><table>",
        head_rows,
        f"<tr><td>skipped journal lines</td>"
        f"<td>{analysis.n_skipped_lines}</td></tr>",
        "</table></div>",
    ]
    if metric is not None:
        parts.append(f"<h2>Best configurations — {_esc(metric)} "
                     f"({_esc(mode)})</h2><div class='card'>")
        parts.append(_best_table(analysis, metric, mode))
        parts.append("</div>")
        parts.append(f"<h2>{_esc(metric)} per trial</h2><div class='card'>")
        parts.append(_metric_chart(analysis, metric, mode))
        parts.append("</div>")
    if trace_path:
        parts.append("<h2>Trial lifecycle (from trace)</h2><div class='card'>")
        try:
            parts.append(_gantt_chart(_load_trace(trace_path)))
        except (OSError, ValueError) as e:
            parts.append(f"<p class='note'>trace unreadable: {_esc(e)}</p>")
        parts.append("</div>")
    parts.append("<h2>Faults &amp; scheduler decisions</h2><div class='card'>")
    parts.append(_fault_table(analysis))
    parts.append("</div>")
    parts.append(_provenance_table(analysis))
    parts.append(_profile_table(analysis))
    if metrics_path:
        parts.append("<h2>Control-plane metrics</h2><div class='card'>")
        try:
            snap = _last_metrics_snapshot(metrics_path)
            parts.append(_metrics_section(snap) if snap else
                         "<p class='note'>metrics stream is empty</p>")
        except OSError as e:
            parts.append(f"<p class='note'>metrics unreadable: {_esc(e)}</p>")
        parts.append("</div>")
    parts.append("</body></html>\n")
    return "".join(parts)
