"""Test configuration: force an 8-device virtual CPU mesh.

XLA_FLAGS --xla_force_host_platform_device_count=8 must be in the env before
the CPU backend initializes, and jax.config.update("jax_platforms", "cpu")
pins the platform even where the environment names an accelerator. Tests
therefore run on the CPU (leaving any card free for chip_smoke.py and the
bench), and the driver's virtual multi-device validation matches.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
