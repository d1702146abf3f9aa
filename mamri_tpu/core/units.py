"""Joint-angle <-> motor-step conversion.

Parity with the reference (Mamri/Mamri.py:1621-1644):
  steps  = int(angle_rad * steps_per_rev / (2*pi))   # Python int() => truncation toward zero
  angle  = steps * (2*pi / steps_per_rev)
All six MAMRI joints use steps_per_rev = 3332.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def angles_to_steps(angles_rad, steps_per_rev):
    """(..., J) radians -> (..., J) int32 motor steps (truncation toward zero)."""
    angles_rad = jnp.asarray(angles_rad)
    spr = jnp.asarray(steps_per_rev, dtype=angles_rad.dtype)
    raw = angles_rad * (spr / (2.0 * jnp.pi))
    return jnp.trunc(raw).astype(jnp.int32)


def steps_to_angles(steps, steps_per_rev, dtype=jnp.float32):
    """(..., J) motor steps -> (..., J) radians."""
    steps = jnp.asarray(steps).astype(dtype)
    spr = jnp.asarray(steps_per_rev, dtype=dtype)
    return steps * ((2.0 * jnp.pi) / spr)


def angles_to_steps_host(angles_rad, steps_per_rev) -> np.ndarray:
    """Host-numpy twin of `angles_to_steps` (bit-identical f32 op order).

    The hardware executor converts angles<->steps every 150 ms control tick;
    the jnp version is an eager device op, which a per-tick host path should
    not dispatch. Tested bit-equal in tests/test_units.py."""
    angles = np.asarray(angles_rad, dtype=np.float32)
    spr = np.asarray(steps_per_rev, dtype=np.float32)
    raw = angles * (spr / np.float32(2.0 * np.pi))
    return np.trunc(raw).astype(np.int32)


def steps_to_angles_host(steps, steps_per_rev, dtype=np.float32) -> np.ndarray:
    """Host-numpy twin of `steps_to_angles` (bit-identical f32 op order)."""
    steps = np.asarray(steps).astype(dtype)
    spr = np.asarray(steps_per_rev, dtype=dtype)
    return steps * (dtype(2.0 * np.pi) / spr)
