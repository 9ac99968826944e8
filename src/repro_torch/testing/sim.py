"""SimTrainable — a scripted surrogate trainable for virtual-time testing.

The paper's claim is that the narrow Trainable waist makes schedulers and
fault handling testable; this is the trainable that cashes the claim in.  Its
"device work" is a ``clock.sleep`` of a scripted duration, so under a
``VirtualClock`` a thousand-trial sweep with minute-scale heartbeat timeouts
runs in real milliseconds — and its faults are scripted too:

- ``crash_at=k`` — ``step`` raises at iteration ``k`` (``crash_count``
  incarnations in a row; the runner's max_failures machinery absorbs or
  surfaces them),
- ``straggle_at=k`` / ``straggle_s`` — iteration ``k`` takes ``straggle_s``
  instead of its scripted duration (drives HEARTBEAT_MISSED),
- ``kill_at=k`` — raises ``SimKilled`` at iteration ``k``, the in-host
  analogue of an externally SIGKILLed worker (same ERROR → retry path).

Fault state must survive rebuilds (a crashed trial is reconstructed from its
checkpoint), so firings are counted in a module-level registry keyed by
``(sim_token, sim_id, site)`` — ``sim_token`` isolates runs from each other,
exactly like the marker files of tests/_worker_trainables.py but in-process.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, Tuple

from ..core.api import Trainable
from ..core.clock import get_default_clock

__all__ = ["SimKilled", "SimTrainable", "reset_faults"]


class SimKilled(RuntimeError):
    """Injected external-kill fault (OOM-killer / preemption analogue)."""


_FAULTS: Dict[Tuple[str, str, str], int] = {}
_FAULTS_LOCK = threading.Lock()


def reset_faults(token: str = None) -> None:
    """Forget fault firings (all, or one run's ``sim_token``)."""
    with _FAULTS_LOCK:
        if token is None:
            _FAULTS.clear()
        else:
            for key in [k for k in _FAULTS if k[0] == token]:
                del _FAULTS[key]


def _fire(token: str, sim_id: str, site: str, limit: int) -> bool:
    """True (and consume one firing) while ``site`` has fired < limit times."""
    if limit <= 0:
        return False
    with _FAULTS_LOCK:
        key = (token, sim_id, site)
        n = _FAULTS.get(key, 0)
        if n >= limit:
            return False
        _FAULTS[key] = n + 1
        return True


def _scripted_jitter(sim_id: str, n: int, scale: float) -> float:
    """Deterministic per-(trial, step) duration wobble.  crc32, not hash():
    builtin hash is salted per interpreter, which would change wake ordering
    between a run and its serial-equivalence reference."""
    if scale <= 0:
        return 0.0
    return scale * (zlib.crc32(f"{sim_id}:{n}".encode()) % 997) / 997.0


class SimTrainable(Trainable):
    """Config keys (all optional unless noted):

    - ``sim_id`` — stable unique tag (REQUIRED for any fault key)
    - ``sim_token`` — run nonce isolating the fault registry between runs
    - ``lr`` — drives the lr-separable loss ``(lr-0.01)^2 + 1/n`` every
      scheduler in the matrix can rank
    - ``step_s`` — base virtual seconds per step (default 1.0)
    - ``durations`` — explicit per-step duration list (overrides step_s while
      it lasts)
    - ``jitter_s`` — deterministic duration wobble amplitude (keeps wake
      times distinct so virtual wake order is well-defined)
    - ``crash_at`` / ``crash_count`` — raise at that iteration, that many
      incarnations in a row (default count 1)
    - ``kill_at`` — raise SimKilled at that iteration (once)
    - ``straggle_at`` / ``straggle_s`` — that iteration sleeps straggle_s
      (default 120 virtual seconds) instead of its scripted duration
    """

    def setup(self, config):
        self.n = 0
        self.lr = float(config.get("lr", 0.01))
        self.sim_id = str(config.get("sim_id", "sim"))
        self.token = str(config.get("sim_token", ""))

    # -- scripted timing ---------------------------------------------------------------
    def _duration(self, n: int) -> float:
        straggle_at = int(self.config.get("straggle_at", 0))
        if straggle_at and n == straggle_at and _fire(
                self.token, self.sim_id, "straggle", 1):
            return float(self.config.get("straggle_s", 120.0))
        durations = self.config.get("durations")
        if durations and n <= len(durations):
            base = float(durations[n - 1])
        else:
            base = float(self.config.get("step_s", 1.0))
        return base + _scripted_jitter(
            self.sim_id, n, float(self.config.get("jitter_s", 0.0)))

    def step(self):
        self.n += 1
        get_default_clock().sleep(self._duration(self.n))
        crash_at = int(self.config.get("crash_at", 0))
        if crash_at and self.n == crash_at and _fire(
                self.token, self.sim_id, "crash",
                int(self.config.get("crash_count", 1))):
            self.n -= 1  # the step never completed
            raise RuntimeError(
                f"injected crash: {self.sim_id} at iteration {crash_at}")
        kill_at = int(self.config.get("kill_at", 0))
        if kill_at and self.n == kill_at and _fire(
                self.token, self.sim_id, "kill", 1):
            self.n -= 1
            raise SimKilled(
                f"injected external kill: {self.sim_id} at iteration {kill_at}")
        sl = self.config.get("_slice")
        return {"loss": (self.lr - 0.01) ** 2 + 1.0 / self.n, "n": self.n,
                "devices": sl.size if sl is not None else 0}

    def save(self):
        return {"n": self.n}

    def restore(self, state):
        self.n = state["n"]

    def reset_config(self, new_config):
        # PBT exploit support: mutate lr in place.
        self.lr = float(new_config.get("lr", self.lr))
        self.config = dict(new_config)
        return True
