"""SimWorkerTrainable — scripted faults inside *real* worker processes.

``testing.sim.SimTrainable`` scripts faults for the in-host tiers, where a
module-level registry survives rebuilds because everything shares one
interpreter.  Across a spawn boundary that registry is reborn empty, so this
variant persists fault firings as marker files under ``config["fault_dir"]``
— the same trick as tests/_worker_trainables.py, generalized to the scenario
DSL's fault vocabulary so the 3000-trial matrix generators drive the process
and cluster tiers too:

- ``crash_at=k`` / ``crash_count=c`` — raise at iteration ``k`` for the
  first ``c`` incarnations (max_failures absorbs or surfaces them),
- ``kill_at=k`` — ``os._exit(13)`` at iteration ``k``: the process dies for
  real, which only this tier can express (the in-host analogue raises),
- ``straggle_at=k`` / ``straggle_wall_s`` — iteration ``k`` sleeps *real*
  seconds.  Children keep wall time; the controller's heartbeat/straggler
  deadline arithmetic reads the injected clock (the PR 5 virtual-deadline
  contract), so a test can fast-forward a five-minute deadline in real
  milliseconds while the child is genuinely stuck.

Loss is the same lr-separable ``(lr-0.01)^2 + 1/n`` every scheduler in the
matrix can rank, and ``save``/``restore`` carry ``n`` so restarts resume
instead of resetting.
"""
from __future__ import annotations

import errno
import os
import time

from ..core.api import Trainable

__all__ = ["SimWorkerTrainable"]


def _fire(fault_dir: str, sim_id: str, site: str, limit: int) -> bool:
    """True (and durably consume one firing) while ``site`` has fired fewer
    than ``limit`` times.  O_CREAT|O_EXCL marker files make each firing
    atomic even when a killed worker's successor races a stale sibling."""
    if limit <= 0 or not fault_dir:
        return False
    for k in range(limit):
        path = os.path.join(fault_dir, f"{sim_id}.{site}.{k}")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError as e:
            if e.errno == errno.EEXIST:
                continue  # this firing already happened (prior incarnation)
            raise
        os.close(fd)
        return True
    return False


class SimWorkerTrainable(Trainable):
    """Config keys: ``sim_id`` (fault key; required for any fault),
    ``fault_dir`` (marker directory; required for any fault), ``lr``,
    ``step_wall_s`` (real seconds of "device work" per step, default 0),
    ``crash_at``/``crash_count``, ``kill_at``,
    ``straggle_at``/``straggle_wall_s`` (default 3 real seconds)."""

    def setup(self, config):
        self.n = 0
        self.lr = float(config.get("lr", 0.01))
        self.sim_id = str(config.get("sim_id", "sim"))
        self.fault_dir = str(config.get("fault_dir", ""))

    def step(self):
        self.n += 1
        straggle_at = int(self.config.get("straggle_at", 0))
        if straggle_at and self.n == straggle_at and _fire(
                self.fault_dir, self.sim_id, "straggle", 1):
            time.sleep(float(self.config.get("straggle_wall_s", 3.0)))
        else:
            wall = float(self.config.get("step_wall_s", 0.0))
            if wall > 0:
                time.sleep(wall)
        crash_at = int(self.config.get("crash_at", 0))
        if crash_at and self.n == crash_at and _fire(
                self.fault_dir, self.sim_id, "crash",
                int(self.config.get("crash_count", 1))):
            self.n -= 1  # the step never completed
            raise RuntimeError(
                f"injected crash: {self.sim_id} at iteration {crash_at}")
        kill_at = int(self.config.get("kill_at", 0))
        if kill_at and self.n == kill_at and _fire(
                self.fault_dir, self.sim_id, "kill", 1):
            os._exit(13)  # a real process death, not an exception
        return {"loss": (self.lr - 0.01) ** 2 + 1.0 / self.n, "n": self.n}

    def save(self):
        return {"n": self.n}

    def restore(self, state):
        self.n = state["n"]

    def reset_config(self, new_config):
        self.lr = float(new_config.get("lr", self.lr))
        self.config = dict(new_config)
        return True
