"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerator hardware by forcing the host
platform and splitting it into 8 XLA devices (SURVEY.md §4's "fake backend"
strategy)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Persistent XLA compile cache keeps repeated test runs fast.
_repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_repo_root, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

# The config API wins over the env vars above if applied before first
# device use (e.g. when something imported jax before this file ran).
import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass
# Likewise for the compile cache: the config API always applies.
try:
    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
except Exception:
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)
