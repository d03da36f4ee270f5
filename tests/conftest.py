"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on ONE device;
only launch/dryrun.py (and the subprocess-based SPMD tests) use the
512/8-device placeholder worlds."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

#: Per-test wall-clock budget (seconds).  A wedged test — e.g. a fault
#: test spinning on a retry loop — fails loudly instead of hanging CI.
#: SIGALRM-based because the container has no pytest-timeout plugin;
#: override with REPRO_TEST_TIMEOUT (0 disables).
TEST_TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "600"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; the test skips itself when none is present",
    )


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    # hookwrapper (not wrapper=True) style for pytest>=7.4 compatibility
    if TEST_TIMEOUT_S <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def on_timeout(signum, frame):
        raise TimeoutError(
            f"test exceeded the global {TEST_TIMEOUT_S}s timeout "
            "(REPRO_TEST_TIMEOUT to override)"
        )

    prev = signal.signal(signal.SIGALRM, on_timeout)
    signal.alarm(TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def run_spmd_subprocess(code: str, devices: int = 8, timeout: int = 300):
    """Run a snippet in a fresh interpreter with a forced device count
    (jax pins the device world at first init, so SPMD tests need their
    own process)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"SPMD subprocess failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
        )
    return proc.stdout
