"""Invariant checkers over a finished ScenarioResult.

Each checker raises AssertionError with a scenario-sized diagnostic; the
fault-matrix tests call ``check_all``.  Three families:

- resource safety   — the SlicePool and the ResourceAccountant drained back
                      to empty (no leaked slice, no leaked accounting),
- event-log health  — per-trial result streams are strictly increasing and
                      gapless, restart/error/straggler counts reconcile with
                      the faults the scenario scripted,
- decision fidelity — a concurrent run on a capacity-1 pool reproduces the
                      serial executor's statuses/results/decisions exactly
                      (``check_serial_equivalence`` runs both and compares).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

from ..core.events import EventType
from ..core.trial import TrialStatus
from .scenarios import Scenario, ScenarioResult, run_scenario

__all__ = ["check_no_slice_leaks", "check_event_log", "check_fault_accounting",
           "check_decision_provenance", "check_all", "check_serial_equivalence"]


def check_no_slice_leaks(result: ScenarioResult) -> None:
    """Every slice and every accounted resource returned to the pool(s) —
    the shared pool on in-host tiers, every host's own pool on the cluster
    tier (an evicted host's pool must drain too: its trials were killed and
    released, not abandoned)."""
    name = result.scenario.name
    pools = ([("", result.pool)] if result.pool is not None else
             [(f"host {h}: ", host.pool)
              for h, host in sorted(
                  getattr(result.executor, "hosts", {}).items())])
    for tag, pool in pools:
        assert pool.n_free == pool.n_total, (
            f"{name}: {tag}slice leak — {pool.n_total - pool.n_free} "
            f"devices still held after the run ({pool!r})")
        assert pool.fragments() == 0, (
            f"{name}: {tag}free list failed to coalesce ({pool!r})")
    acct = result.executor.accountant
    assert acct.available.devices == acct.total.devices, (
        f"{result.scenario.name}: accountant leak — "
        f"{acct.total.devices - acct.available.devices} devices still booked")
    assert not result.executor.has_running(), (
        f"{result.scenario.name}: executor still has live workers")


def check_event_log(result: ScenarioResult, gapless: bool = True) -> None:
    """Per-trial streams are strictly increasing (gapless too, unless the
    scheduler clones — a PBT exploit legitimately jumps a trial forward to
    its donor's iteration) and every trial reached a terminal state; all
    timestamps sit on the virtual axis."""
    for t in result.trials:
        iters = [r.training_iteration for r in t.results]
        assert iters == sorted(set(iters)), (
            f"{t.trial_id}: result stream not strictly increasing: {iters}")
        if t.status == TrialStatus.TERMINATED:
            assert iters, f"{t.trial_id}: terminated with no results"
            if gapless:
                assert iters == list(range(1, len(iters) + 1)), (
                    f"{t.trial_id}: terminated with a gapped stream: {iters}")
        else:
            assert t.status == TrialStatus.ERROR, (
                f"{t.trial_id}: non-terminal status {t.status} after run")
            assert t.error, f"{t.trial_id}: ERROR status with no error"
    virtual_end = result.clock.time()
    for r in result.recorder.results:
        assert r.timestamp <= virtual_end, (
            f"result stamped past the virtual clock: {r.timestamp} > {virtual_end}")
    restarted = result.recorder.of(EventType.RESTARTED)
    assert len(restarted) == result.runner.n_restarts, (
        f"{result.scenario.name}: {result.runner.n_restarts} restarts but "
        f"{len(restarted)} RESTARTED events (lost or duplicated)")


def check_fault_accounting(result: ScenarioResult, strict: bool = True) -> None:
    """Reconcile observed restarts/errors/heartbeats with the scripted
    faults.  ``strict`` (run-to-completion scheduling) demands equality; an
    early-stopping scheduler may cancel a trial before its fault fires, so
    non-strict demands the observation never *exceeds* the script."""
    sc = result.scenario
    expected_restarts = sc.expected_crashes - sc.expected_fatal
    if strict:
        assert result.runner.n_restarts == expected_restarts, (
            f"{sc.name}: scripted {expected_restarts} absorbable crashes, "
            f"observed {result.runner.n_restarts} restarts")
        assert result.runner.n_errors == sc.expected_fatal, (
            f"{sc.name}: scripted {sc.expected_fatal} fatal trials, "
            f"observed {result.runner.n_errors} errors")
    else:
        assert result.runner.n_restarts <= expected_restarts, (
            f"{sc.name}: more restarts ({result.runner.n_restarts}) than "
            f"scripted crashes ({expected_restarts})")
        assert result.runner.n_errors <= sc.expected_fatal, (
            f"{sc.name}: more errors ({result.runner.n_errors}) than "
            f"scripted fatal trials ({sc.expected_fatal})")
    if sc.expected_stragglers:
        straggling = {e.trial_id
                      for e in result.recorder.of(EventType.HEARTBEAT_MISSED)}
        scripted = {t.trial_id
                    for t, cfg in zip(result.trials, sc.configs)
                    if cfg.get("straggle_at")}
        assert straggling <= scripted, (
            f"{sc.name}: heartbeat warnings for trials that never straggled: "
            f"{sorted(straggling - scripted)[:5]}")
        if strict:
            missing = scripted - straggling
            assert not missing, (
                f"{sc.name}: {len(missing)} scripted stragglers never "
                f"produced HEARTBEAT_MISSED: {sorted(missing)[:5]}")


def check_decision_provenance(result: ScenarioResult) -> None:
    """Every stopped/perturbed trial left a DECISION record whose inputs
    reconcile with the journaled metric stream (DESIGN.md §10).

    Runner stopping-criterion verdicts must reconcile *exactly* (the journaled
    value IS the stream's value — FIFO-exact); ASHA rung and HyperBand cut
    verdicts reconcile as *bounds* (score below cutoff / rank past the keep
    line), because the cutoff is a function of scheduler-internal rung state
    the journal only witnesses through the record itself.  PBT exploits must
    name a real donor whose journaled score beats the victim's."""
    sched = result.runner.scheduler
    metric = getattr(sched, "metric", "loss")
    mode = getattr(sched, "mode", "min")
    name = result.scenario.name
    trial_ids = {t.trial_id for t in result.trials}
    by_trial: Dict[str, List[Dict[str, Any]]] = {}
    for e in result.recorder.of(EventType.DECISION):
        by_trial.setdefault(e.trial_id, []).append(e.info)
        assert e.trial_id in trial_ids, (
            f"{name}: DECISION record for unknown trial {e.trial_id}")

    for t in result.trials:
        decs = by_trial.get(t.trial_id, [])
        stream = {r.training_iteration: r.metrics for r in t.results}
        if t.status == TrialStatus.TERMINATED:
            stops = [d for d in decs if d.get("verdict") == "STOP"]
            assert stops, (
                f"{name}: {t.trial_id} TERMINATED with no STOP decision "
                f"(verdicts seen: {[d.get('verdict') for d in decs]})")
            inputs = stops[-1].get("inputs") or {}
            it = stops[-1].get("iteration")
            reason = inputs.get("reason")
            if reason == "stopping_criterion":
                crit, bound, value = (inputs["criterion"], inputs["bound"],
                                      inputs["value"])
                assert value >= bound, (
                    f"{name}: {t.trial_id} stopped on {crit} with "
                    f"value {value} below bound {bound}")
                if crit == "training_iteration" and stream:
                    assert value == max(stream), (
                        f"{name}: {t.trial_id} stop record says "
                        f"{crit}={value} but stream ends at {max(stream)}")
                elif stream and it in stream and crit in stream[it]:
                    assert abs(value - stream[it][crit]) < 1e-12, (
                        f"{name}: {t.trial_id} stop record {crit}={value} "
                        f"!= journaled {stream[it][crit]} at iter {it}")
            elif reason == "rung":           # ASHA — bound + stream reconcile
                assert inputs["score"] < inputs["cutoff"], (
                    f"{name}: {t.trial_id} ASHA-stopped with score "
                    f"{inputs['score']} >= cutoff {inputs['cutoff']}")
                if it in stream and metric in stream[it]:
                    expected = (stream[it][metric] if mode == "max"
                                else -stream[it][metric])
                    assert abs(inputs["score"] - expected) < 1e-9, (
                        f"{name}: {t.trial_id} rung score {inputs['score']} "
                        f"!= journaled {expected} at iter {it}")
            elif reason in ("cut", "cut_after_error"):   # HyperBand — bounds
                assert inputs["rank"] >= inputs["n_keep"], (
                    f"{name}: {t.trial_id} cut at rank {inputs['rank']} "
                    f"inside the keep line {inputs['n_keep']}")
                assert inputs["score"] <= inputs["cut_score"] + 1e-12, (
                    f"{name}: {t.trial_id} cut with score {inputs['score']} "
                    f"above cut_score {inputs['cut_score']}")
            elif reason == "median":
                assert inputs["best_so_far"] < inputs["median"], (
                    f"{name}: {t.trial_id} median-stopped with best "
                    f"{inputs['best_so_far']} >= median {inputs['median']}")
            elif reason == "max_t":
                assert it is None or it >= inputs["max_t"], (
                    f"{name}: {t.trial_id} max_t-stopped at iter {it} "
                    f"< max_t {inputs['max_t']}")
        for d in decs:                        # PBT perturbations, any status
            if d.get("verdict") != "RESTART_WITH_CONFIG":
                continue
            inputs = d.get("inputs") or {}
            donor = inputs.get("donor")
            assert donor in trial_ids and donor != t.trial_id, (
                f"{name}: {t.trial_id} exploit names donor {donor!r} that "
                f"is not another trial in this run")
            if (inputs.get("donor_score") is not None
                    and inputs.get("my_score") is not None):
                assert inputs["donor_score"] >= inputs["my_score"], (
                    f"{name}: {t.trial_id} exploited a donor scoring "
                    f"{inputs['donor_score']} below its own "
                    f"{inputs['my_score']}")


def check_all(result: ScenarioResult, strict: bool = True,
              gapless: bool = True) -> None:
    check_no_slice_leaks(result)
    check_event_log(result, gapless=gapless)
    check_fault_accounting(result, strict=strict)
    check_decision_provenance(result)


def check_serial_equivalence(
    scenario: Scenario,
    scheduler_factory: Callable[[], Any],
    lookahead: int = 1,
) -> Dict[str, ScenarioResult]:
    """Run the scenario twice on a capacity-1 pool — concurrent (virtual
    worker threads, heartbeat monitor on) vs the serial reference tier — and
    demand identical statuses, result streams and losses per trial.  With one
    device both tiers execute trials one at a time, so any divergence is a
    real decision-fidelity bug, not an interleaving artifact."""
    results = {}
    for tier in ("serial", "concurrent"):
        results[tier] = run_scenario(
            scenario, scheduler_factory, executor=tier, pool_devices=1,
            lookahead=lookahead if tier == "concurrent" else 1)
    ref, got = results["serial"], results["concurrent"]
    assert len(ref.trials) == len(got.trials)
    for mine, theirs in zip(got.trials, ref.trials):
        assert mine.status == theirs.status, (
            f"{mine.trial_id}: {mine.status} (concurrent) != "
            f"{theirs.status} (serial); error={mine.error}")
        mine_iters = [r.training_iteration for r in mine.results]
        theirs_iters = [r.training_iteration for r in theirs.results]
        assert mine_iters == theirs_iters, (
            f"{mine.trial_id}: result streams diverge: "
            f"{mine_iters} != {theirs_iters}")
        for a, b in zip(mine.results, theirs.results):
            assert abs(a.metrics["loss"] - b.metrics["loss"]) < 1e-12, (
                f"{mine.trial_id}@{a.training_iteration}: loss diverges")
    return results
