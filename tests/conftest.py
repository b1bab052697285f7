import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "mesh_matrix: parity tests parametrized over tests/meshes.py — "
        "CI runs `-m mesh_matrix` with REPRO_TEST_MESHES=dm so the "
        "data×model job skips everything the worker-only job covers")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips inside the test where none is present")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def run_multidevice(code: str, n_devices: int = 8, timeout: int = 560) -> str:
    """Run a python snippet in a subprocess with n host devices.

    The main test process keeps the real single device (per the repo
    policy); shard_map/distribution tests get their own interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"multidevice snippet failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout
