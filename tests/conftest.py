"""Test configuration: force an 8-device virtual CPU platform.

Multi-chip sharding logic is validated on a virtual CPU mesh
(``xla_force_host_platform_device_count=8``) so tests run anywhere; the
GPU path is exercised by ``chip_smoke.py`` and ``bench.py``.
This must run before the first ``import jax`` anywhere in the test session.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax  # noqa: E402

# Persistent compilation cache: the suite is compile-bound on CPU.
from stratum_dsp_tpu.compile_cache import cache_dir  # noqa: E402

jax.config.update("jax_compilation_cache_dir", cache_dir("cpu"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xD5B)
