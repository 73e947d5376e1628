import os
import sys

# Tests must see exactly ONE device (the dry-run sets its own flag in a
# subprocess); make sure a stray env var doesn't leak in.
os.environ.pop("XLA_FLAGS", None)

# The property tests use `hypothesis` (see requirements-dev.txt).  In
# hermetic environments without it, fall back to the deterministic stub so
# the suites still run instead of failing collection.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips with a reason elsewhere",
    )
