import importlib.util
import os
import sys

# Tests run single-device CPU (the dry-run sets its own 512-device flags in a
# separate process).  A couple of multi-device tests spawn subprocesses.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# The container has no `hypothesis`; fall back to the deterministic shim in
# tests/_hypothesis_fallback.py so the property-based modules still collect
# and run.  Real hypothesis, when installed (e.g. in CI), always wins.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _spec = importlib.util.spec_from_file_location(
        "hypothesis",
        os.path.join(os.path.dirname(__file__), "_hypothesis_fallback.py"))
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; needs an NVIDIA GPU and skips "
        "without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
