"""repro_torch.testing — deterministic virtual-time simulation harness (DESIGN.md §7).

The platform the test suite itself runs on: a ``SimTrainable`` whose device
work and faults are scripted virtual-time sleeps, scenario generators for the
failure classes the execution tiers exist to survive (crash storms, straggler
cascades, elastic resize churn), and invariant checkers that audit a finished
run for slice leaks, event-log gaps and scheduler-decision fidelity.  Paired
with ``repro_torch.core.clock.VirtualClock``, minute-scale failure timelines run in
milliseconds — which is what makes thousand-trial fault matrices affordable
in CI (tests/test_scenarios.py).
"""
from ..core.clock import Clock, VirtualClock, WallClock, use_clock
from .invariants import (check_all, check_decision_provenance,
                         check_event_log, check_fault_accounting,
                         check_no_slice_leaks, check_serial_equivalence)
from .scenarios import (RecordingLogger, Scenario, ScenarioResult,
                        crash_storm, resize_churn, run_scenario,
                        straggler_cascade)
from .sim import SimKilled, SimTrainable, reset_faults

__all__ = [
    "Clock", "WallClock", "VirtualClock", "use_clock",
    "SimTrainable", "SimKilled", "reset_faults",
    "Scenario", "ScenarioResult", "RecordingLogger",
    "crash_storm", "straggler_cascade", "resize_churn", "run_scenario",
    "check_all", "check_no_slice_leaks", "check_event_log",
    "check_fault_accounting", "check_decision_provenance",
    "check_serial_equivalence",
]
