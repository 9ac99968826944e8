"""Spawn-safe toy trainables for the port's control-plane tests.

The arithmetic of ``Counter`` and ``LrCounter`` is that of
``tests/_worker_trainables.py``, on the port's ``Trainable``, so the same
sweep in both packages gives the same result stream.  Imports only
``repro_torch`` and numpy: a worker process that builds one of these loads
nothing of the JAX package.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.api import Trainable

__all__ = ["Counter", "LrCounter", "make_probed_model_trainable"]


class Counter(Trainable):
    """Deterministic arithmetic: loss = 1/n, state = n."""

    def setup(self, config):
        self.n = 0
        self.inc = int(config.get("inc", 1))

    def step(self):
        self.n += self.inc
        return {"loss": 1.0 / self.n, "n": self.n}

    def save(self):
        return {"n": self.n}

    def restore(self, state):
        self.n = state["n"]

    def reset_config(self, new_config):
        self.inc = int(new_config.get("inc", self.inc))
        return True


class LrCounter(Trainable):
    """lr-separable loss (drives every scheduler)."""

    def setup(self, config):
        self.n = 0
        self.lr = float(config.get("lr", 0.01))

    def step(self):
        self.n += 1
        return {"loss": (self.lr - 0.01) ** 2 + 1.0 / self.n}

    def save(self):
        # a numpy leaf, as the port's ModelTrainable snapshots hold
        return {"n": np.asarray(self.n)}

    def restore(self, state):
        self.n = int(state["n"])

    def reset_config(self, new_config):
        self.lr = float(new_config.get("lr", self.lr))
        self.config = dict(new_config)
        return True


def foreign_modules() -> str:
    """The loaded modules of ``jax*`` or of the JAX package, comma-joined."""
    return ",".join(sorted(m for m in sys.modules
                           if m.split(".")[0] == "repro" or m.startswith("jax")))


def make_probed_model_trainable(model_cfg, **workload):
    """``model_trainable_factory``'s class, rebuilt here in the worker, whose
    results also carry the worker's ``foreign_modules()``."""
    from repro_torch.train.trainable import model_trainable_factory

    base = model_trainable_factory(model_cfg, **workload).resolve()

    class Probed(base):
        def step(self):
            out = super().step()
            out["foreign_modules"] = foreign_modules()
            out["trainable_class"] = base.__name__
            return out

    return Probed
