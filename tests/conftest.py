"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding logic is validated on fake CPU devices (the jax analog of
the reference's chex.fake_pmap_and_jit debug path at
acme/jax/muzero/builder.py:265-266); real-TPU behavior is exercised by
bench.py and the driver's graft entry checks.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
  os.environ["XLA_FLAGS"] = (
      flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "gpu: needs a CUDA card; the test skips where there is none")
