import os
import sys

# tests see the default single CPU device (the dry-run, and ONLY the
# dry-run, forces 512 placeholder devices in its own process)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (deselect with `-m 'not slow'`)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def seed():
    """Canonical scalar seed; override per-test to reseed ``rng``."""
    return 0


@pytest.fixture
def rng(seed):
    return np.random.default_rng(seed)
