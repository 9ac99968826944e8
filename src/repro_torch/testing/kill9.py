"""kill9 — subprocess harness for true-SIGKILL durable-resume testing.

``tests/test_resume_kill9.py`` needs a controller that actually dies the way
the tentpole claims to survive: no atexit hooks, no finally blocks, no flushed
buffers — ``os.kill(os.getpid(), SIGKILL)``.  That cannot be done in-process
(it would take pytest down with it), so this module is a ``python -m``
entrypoint the test drives as a child process:

    python -m repro_torch.testing.kill9 --log-dir D --scheduler asha --kill-after 40
    python -m repro_torch.testing.kill9 --log-dir D --scheduler asha --resume

The first invocation runs a small sweep under a ``VirtualClock`` and SIGKILLs
itself after the Nth completed trainable step (counted in a module global —
under the virtual clock, step completions are totally ordered by their
scripted durations, so the kill lands at a reproducible point in the sweep).
The second invocation resumes from the journal / search-state snapshot /
checkpoint mirrors that survived on disk.  Without ``--kill-after`` the sweep
runs to completion and writes ``final.json`` (trial table + summary) into the
log dir; the test compares that file — and the decision records in
``events.jsonl`` — between a clean child and a killed-then-resumed child.

The sweep itself is ``SimTrainable`` with per-trial step durations derived
from the grid index, exactly the recipe the in-process equivalence tests use;
what this tier adds is that the interruption is a real SIGKILL arriving
mid-write rather than a cooperative ``runner.step()`` cutoff.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import threading

from ..core.clock import VirtualClock, set_default_clock
from ..core.experiment import run_experiments
from ..core.resources import Resources
from ..core.schedulers.asha import AsyncHyperBandScheduler
from ..core.schedulers.hyperband import HyperBandScheduler
from ..core.schedulers.pbt import PopulationBasedTraining
from ..core.search.space import grid_search
from .sim import SimTrainable

__all__ = ["Kill9Trainable", "main"]

N_TRIALS = 6
STOP_ITERATION = 8
_LRS = [0.001 * (i + 1) for i in range(N_TRIALS)]
_STEP_S = [0.5, 0.7, 0.9, 1.1, 1.3, 1.7]

# Module globals, not config: the kill budget belongs to the *process* (one
# controller incarnation), not to any trial — a resumed run must not inherit
# the original run's trigger.
_KILL_AFTER = 0
_STEPS_DONE = 0
_COUNT_LOCK = threading.Lock()


class Kill9Trainable(SimTrainable):
    """SimTrainable whose grid index fixes its identity and step duration,
    and which SIGKILLs the whole process after the Nth global step."""

    def setup(self, config):
        super().setup(config)
        i = _LRS.index(self.lr)
        self.sim_id = f"k9-{i}"
        self.config.setdefault("step_s", _STEP_S[i])
        self.config.setdefault("jitter_s", 0.25)

    def step(self):
        global _STEPS_DONE
        out = super().step()
        if _KILL_AFTER > 0:
            with _COUNT_LOCK:
                _STEPS_DONE += 1
                fire = _STEPS_DONE >= _KILL_AFTER
            if fire:
                os.kill(os.getpid(), signal.SIGKILL)
        return out


def build_scheduler(kind: str):
    if kind == "asha":
        return AsyncHyperBandScheduler(metric="loss", mode="min",
                                       max_t=STOP_ITERATION, grace_period=1,
                                       reduction_factor=3)
    if kind == "hyperband":
        return HyperBandScheduler(metric="loss", mode="min",
                                  max_t=STOP_ITERATION + 1, eta=3)
    if kind == "pbt":
        return PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=3,
            hyperparam_mutations={"lr": [0.001, 0.004, 0.008, 0.02]}, seed=7)
    raise SystemExit(f"unknown scheduler {kind!r}")


def main(argv=None) -> int:
    global _KILL_AFTER
    ap = argparse.ArgumentParser(prog="python -m repro_torch.testing.kill9")
    ap.add_argument("--log-dir", required=True)
    ap.add_argument("--scheduler", choices=("asha", "hyperband", "pbt"),
                    default="asha")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="SIGKILL the process after this many completed "
                         "trainable steps (0 = run to completion)")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    _KILL_AFTER = args.kill_after
    clock = VirtualClock()
    set_default_clock(clock)

    space = {"lr": grid_search(_LRS), "sim_token": "kill9"}
    analysis = run_experiments(
        Kill9Trainable,
        space,
        scheduler=build_scheduler(args.scheduler),
        stop={"training_iteration": STOP_ITERATION},
        resources_per_trial=Resources(cpu=1, devices=1),
        total_devices=N_TRIALS,
        executor="concurrent",
        clock=clock,
        log_dir=args.log_dir,
        search_state_interval=3.0,
        resume=args.resume,
    )

    from ..obs.analysis import ExperimentAnalysis as JournalAnalysis
    table = sorted(
        [t.trial_id, t.status.value, t.training_iteration,
         round(t.best_value("loss", "min") or -1.0, 9)]
        for t in analysis.trials)
    journal = JournalAnalysis.from_journal(
        os.path.join(args.log_dir, "events.jsonl"))
    final = {"table": table,
             "summary": journal.summary_json(metric="loss", mode="min")}
    with open(os.path.join(args.log_dir, "final.json"), "w") as f:
        json.dump(final, f, indent=1, sort_keys=True)
    print(json.dumps(final["table"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
