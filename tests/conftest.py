"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU whatever the machine holds: their results then
do not depend on an accelerator, and the parallel test workers do not
each reserve most of a GPU's memory. Multi-device sharding paths run on
8 virtual CPU devices. Tests that need the card (marker ``gpu``) run the
program in a child process of their own.
"""

import os

# Must be set before jax import / backend init; assign, don't setdefault,
# so that an environment naming another platform cannot override it.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# A site configuration can change the platform after import; pin via config.
jax.config.update("jax_platforms", "cpu")

# Enable f64 so the *f64 arithmetic variants are exercised with real double
# precision (with x64 off they compute in f32 — see decoder.factory).
jax.config.update("jax_enable_x64", True)
