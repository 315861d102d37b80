"""Test harness config: by default everything runs on a virtual 8-device
CPU mesh.

Multi-device hardware is not available in CI, so sharding paths are
validated on XLA's host platform with 8 virtual devices (the strategy
SURVEY.md §4 prescribes); the Pallas GPU kernel runs in interpreter mode.
Tests marked ``gpu`` need the card: run ``JAX_PLATFORMS=cuda pytest -m gpu``
on a GPU machine; elsewhere they skip.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips elsewhere)")
    config.addinivalue_line("markers", "slow: long-running test")


def pytest_collection_modifyitems(items):
    """Run the heaviest-compile modules first.

    XLA:CPU's backend_compile crashes inside LLVM once a single process
    has accumulated ~300 tests' worth of JIT'd executables (SIGSEGV; with
    the persistent cache enabled it was a SIGSEGV deserializing the same
    program — see stringwars_tpu/__init__.py). Every big segmentation
    program compiles fine in a fresh process; whichever lands around test
    ~300 of the full run is the victim. Two defenses: front the heavy
    modules, and drop compiled executables every 100 tests
    (pytest_runtest_teardown below)."""
    heavy = ("test_tr29_dual", "test_segment_fuzz", "test_segment", "test_sentence", "test_linebreak")
    front = [it for it in items if any(h in it.nodeid for h in heavy)]
    rest = [it for it in items if not any(h in it.nodeid for h in heavy)]
    items[:] = front + rest


_TESTS_SINCE_CLEAR = [0]


def pytest_runtest_teardown(item, nextitem):
    """Release accumulated compiled executables every 100 tests (the
    crash-after-~300-compiles defense; costs a few recompiles of shared
    helpers, saves the LLVM JIT arena)."""
    _TESTS_SINCE_CLEAR[0] += 1
    if _TESTS_SINCE_CLEAR[0] >= 100:
        _TESTS_SINCE_CLEAR[0] = 0
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda on the card)")
    return devices[0]
