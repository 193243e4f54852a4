"""Test configuration.

Tests run on the CPU with a virtual 8-device mesh (for sharding tests)
and float64 enabled, so numerical checks can use tight tolerances. A
JAX_PLATFORMS setting in the environment is honoured instead (e.g.
JAX_PLATFORMS=cuda,cpu to run the tests marked `gpu` on a card); the
card's main path is proven by chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
