"""Test harness: run everything on a virtual 8-device CPU mesh.

This substitutes for the reference's "mpirun -n 8 on one box" style of
multi-process testing (SURVEY.md §4): sharding correctness is validated on
fake CPU devices. Tests marked ``gpu`` need the card and skip here; run them
on a GPU machine with ``python chip_smoke.py`` (its last phase runs them).
"""

import os

# XLA_FLAGS is read at (lazy) backend initialization — safe to set here.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from topotpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: XLA compiles dominate suite wall time.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    # chip_smoke.py runs the gpu-marked tests in its own GPU process; every
    # other run is the CPU suite on 8 virtual devices
    if jax.default_backend() == "cpu":
        assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]
