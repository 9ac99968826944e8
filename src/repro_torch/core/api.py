"""User-facing API — the paper's two development interfaces (§4.1, Figure 2).

Class-based (Figure 2b): subclass ``Trainable`` and implement ``step`` (one unit
of training; return a metrics dict), ``save`` (return a state pytree) and
``restore`` (accept that pytree).  Tune schedulers call these to incrementally
train, snapshot, clone and mutate trials.

Function-based cooperative API (Figure 2a): write an ordinary training loop
taking a ``tune`` handle; call ``tune.report(**metrics)`` per unit, consult
``tune.should_checkpoint()`` and hand state to ``tune.record_checkpoint(state)``.
Internally (exactly as the paper notes) we insert an adapter that presents the
cooperative function as a class-based Trainable: the function runs on a worker
thread, ``report`` blocks until the runner requests the next unit.

The port's copy of ``repro.core.api`` (which loads no JAX), kept here so that
the port never imports the JAX package.
"""
from __future__ import annotations

import queue
import threading
import traceback
from collections import deque
from typing import Any, Callable, Dict, Optional

__all__ = ["Trainable", "FunctionHandle", "FunctionTrainable", "wrap_function"]


class Trainable:
    """Class-based trainable (direct control)."""

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)
        self.iteration = 0
        self.setup(self.config)

    # -- user hooks ------------------------------------------------------------
    def setup(self, config: Dict[str, Any]) -> None:  # optional
        pass

    def step(self) -> Dict[str, Any]:
        """Run one unit of training and return a metrics dict."""
        raise NotImplementedError

    def save(self) -> Any:
        """Return a checkpointable pytree of the full training state."""
        raise NotImplementedError

    def restore(self, state: Any) -> None:
        raise NotImplementedError

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """In-place hyperparameter mutation (PBT). Return False if unsupported —
        the executor will then tear down and rebuild the trainable."""
        return False

    def cleanup(self) -> None:  # optional
        pass

    # -- framework-driven ------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        metrics = self.step()
        if not isinstance(metrics, dict):
            raise TypeError(f"step() must return a dict, got {type(metrics)}")
        self.iteration += 1
        return metrics


class _StopToken:
    pass


class FunctionHandle:
    """The ``tune`` handle passed into function-based trainables."""

    def __init__(self, params: Dict[str, Any]):
        self.params = dict(params)
        self._result_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._control_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._checkpoint_requested = False
        self._recorded_checkpoint: Any = None
        self._stopped = False

    # -- called from user code (worker thread) ---------------------------------
    def report(self, **metrics: Any) -> None:
        """Report intermediate results; blocks until the runner wants more."""
        self._result_q.put(("result", metrics))
        cmd = self._control_q.get()
        if isinstance(cmd, _StopToken):
            self._stopped = True
            raise StopIteration("trial stopped by scheduler")

    def should_checkpoint(self) -> bool:
        return self._checkpoint_requested

    def record_checkpoint(self, state: Any) -> None:
        self._recorded_checkpoint = state
        self._checkpoint_requested = False


class FunctionTrainable(Trainable):
    """Adapter presenting a cooperative function as a class-based Trainable.

    The function runs on a daemon thread; each ``train()`` lets it advance to
    its next ``report`` call.  ``save`` asks the function (via
    ``should_checkpoint``) to record state at its next report boundary.
    """

    _fn: Callable[[FunctionHandle], None]  # set by wrap_function subclassing

    def setup(self, config: Dict[str, Any]) -> None:
        self.handle = FunctionHandle(config)
        self._done = False
        self._error: Optional[str] = None
        self._thread = threading.Thread(target=self._entry, daemon=True)
        self._started = False
        self._pending_metrics: deque = deque()

    def _entry(self) -> None:
        try:
            type(self)._fn(self.handle)
            self.handle._result_q.put(("done", {}))
        except StopIteration:
            self.handle._result_q.put(("done", {}))
        except BaseException:  # noqa: BLE001 — report trial error upward
            self._error = traceback.format_exc()
            self.handle._result_q.put(("error", self._error))

    def step(self) -> Dict[str, Any]:
        # A save() may have advanced the function to reach a checkpoint
        # boundary; the result it reported then is owed to the caller first.
        if self._pending_metrics:
            return self._pending_metrics.popleft()
        return self._advance()

    def _advance(self) -> Dict[str, Any]:
        """Let the function run to its next report; return those metrics."""
        if self._done:
            raise RuntimeError("function trainable already finished")
        if not self._started:
            self._thread.start()
            self._started = True
        else:
            self.handle._control_q.put("continue")
        kind, payload = self.handle._result_q.get()
        if kind == "error":
            raise RuntimeError(f"trial function raised:\n{payload}")
        if kind == "done":
            self._done = True
            return {"done": True}
        return dict(payload)

    def save(self) -> Any:
        if self.handle._recorded_checkpoint is None:
            # Ask the function to checkpoint at its next report boundary; the
            # metrics reported there are queued so the next step() yields them
            # instead of silently dropping a reported result.
            self.handle._checkpoint_requested = True
            self._pending_metrics.append(self._advance())
            if self.handle._recorded_checkpoint is None:
                raise RuntimeError(
                    "function trainable did not record_checkpoint() when asked; "
                    "call tune.record_checkpoint(state) when tune.should_checkpoint()"
                )
        state = self.handle._recorded_checkpoint
        self.handle._recorded_checkpoint = None  # consume: next save re-asks
        return state

    def restore(self, state: Any) -> None:
        raise NotImplementedError(
            "function trainables restore by re-running from config; use the "
            "class-based API for schedulers that pause/clone (HyperBand, PBT)"
        )

    def cleanup(self) -> None:
        if self._started and not self._done and self._thread.is_alive():
            self.handle._control_q.put(_StopToken())
            self._thread.join(timeout=5.0)


def wrap_function(fn: Callable[[FunctionHandle], None]) -> type:
    """Make a FunctionTrainable subclass from a cooperative training function."""
    return type(f"Function[{getattr(fn, '__name__', 'fn')}]",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})
