"""Test config: force an 8-device virtual CPU platform before jax imports.

Mirrors the reference's strategy of testing cluster behavior without a
cluster (submitit cluster="debug", controllable_agent/test_executor.py:21-24):
here an 8-device CPU mesh stands in for a TPU slice.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: first-compile on this host is slow; cache
# makes repeat test runs cheap.
import jax

jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (skips without a card)")
