import os

# Tests see the real single-CPU device world (the 512-device override belongs
# ONLY to launch/dryrun.py). Keep allocations small and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest


def pytest_configure(config):
    # pytest-timeout is optional (requirements-dev.txt); register the marker
    # so collection stays warning-free when the plugin is absent.
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test timeout (pytest-timeout)")
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.key(0)
