"""Pure-jnp homogeneous-transform algebra.

The reference drives all of its geometry through vtkMatrix4x4/vtkTransform
(e.g. Mamri/Mamri.py:1486-1505, :1760-1769). Here the same math is expressed as
pure functions over (..., 4, 4) jnp arrays so it is jit/vmap/grad-compatible
and runs on the accelerator inside the fused programs.

Axis conventions (anatomical axes of the scanner frame; parity with the
reference's `_get_rotation_transform`, Mamri/Mamri.py:1760-1769):
  IS (inferior-superior)  -> rotation about +Z by +theta
  PA (posterior-anterior) -> rotation about +Y by -theta
  LR (left-right)         -> rotation about +X by +theta
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Geometry matmuls MUST run at full float32 precision: on an NVIDIA H100 an
# f32 matmul may run in TF32 (10-bit mantissa, ~3 decimal digits), which
# rounds millimeter-scale coordinates by tenths of a millimeter and silently
# breaks sub-mm parity. Every homogeneous-transform product that runs on the
# device goes through `matmul` / `apply` below with Precision.HIGHEST.
_HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b):
    """Precision-pinned matrix product for (..., 4, 4) homogeneous transforms."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def chain(*ms):
    """Left-to-right product of homogeneous transforms at full precision."""
    out = ms[0]
    for m in ms[1:]:
        out = matmul(out, m)
    return out

# Integer articulation-axis codes (static metadata on the robot model).
AXIS_NONE = 0  # fixed link (no articulation, e.g. Baseplate / translational Needle)
AXIS_IS = 1
AXIS_PA = 2
AXIS_LR = 3

AXIS_CODE_BY_NAME = {None: AXIS_NONE, "IS": AXIS_IS, "PA": AXIS_PA, "LR": AXIS_LR}


def _embed_rot(r):
    """Embed a (..., 3, 3) rotation into a (..., 4, 4) homogeneous matrix."""
    batch = r.shape[:-2]
    m = jnp.zeros(batch + (4, 4), dtype=r.dtype)
    m = m.at[..., :3, :3].set(r)
    m = m.at[..., 3, 3].set(1.0)
    return m


def rot_x(theta):
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    r = jnp.stack(
        [
            jnp.stack([o, z, z], axis=-1),
            jnp.stack([z, c, -s], axis=-1),
            jnp.stack([z, s, c], axis=-1),
        ],
        axis=-2,
    )
    return _embed_rot(r)


def rot_y(theta):
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    r = jnp.stack(
        [
            jnp.stack([c, z, s], axis=-1),
            jnp.stack([z, o, z], axis=-1),
            jnp.stack([-s, z, c], axis=-1),
        ],
        axis=-2,
    )
    return _embed_rot(r)


def rot_z(theta):
    theta = jnp.asarray(theta)
    c, s = jnp.cos(theta), jnp.sin(theta)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    r = jnp.stack(
        [
            jnp.stack([c, -s, z], axis=-1),
            jnp.stack([s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )
    return _embed_rot(r)


def translate(v):
    """(..., 3) translation vector -> (..., 4, 4) homogeneous matrix."""
    v = jnp.asarray(v)
    batch = v.shape[:-1]
    m = jnp.broadcast_to(jnp.eye(4, dtype=v.dtype), batch + (4, 4))
    return m.at[..., :3, 3].set(v)


def identity(dtype=jnp.float32):
    return jnp.eye(4, dtype=dtype)


def articulation_matrix(axis_code: int, theta):
    """Joint articulation transform for a *static* axis code.

    Mirrors the reference's axis-convention corrections
    (Mamri/Mamri.py:1760-1769): IS -> RotZ(+theta), PA -> RotY(-theta),
    LR -> RotX(+theta); fixed/translational links get identity.
    `axis_code` must be a Python int so the branch resolves at trace time.
    """
    if axis_code == AXIS_IS:
        return rot_z(theta)
    if axis_code == AXIS_PA:
        return rot_y(-theta)
    if axis_code == AXIS_LR:
        return rot_x(theta)
    theta = jnp.asarray(theta)
    return jnp.broadcast_to(jnp.eye(4, dtype=theta.dtype), theta.shape + (4, 4))


def apply(matrix, points):
    """Apply a (..., 4, 4) homogeneous transform to (..., N, 3) points."""
    points = jnp.asarray(points)
    rotated = jnp.einsum("...ij,...nj->...ni", matrix[..., :3, :3], points, precision=_HIGHEST)
    return rotated + matrix[..., None, :3, 3]


def angle_about_axis(matrix, axis_code: int):
    """Recover the joint angle from an articulation matrix (inverse of
    `articulation_matrix`). Counterpart of the reference's angle read-back
    from scene transforms (Mamri/Mamri.py:1816-1834)."""
    if axis_code == AXIS_IS:
        return jnp.arctan2(matrix[..., 1, 0], matrix[..., 0, 0])
    if axis_code == AXIS_PA:
        # rot_y(-theta): m[0,2] = -sin(-theta)... = sin(theta)? derive:
        # rot_y(phi)[0,2] = sin(phi), [2,2] = cos(phi); phi = -theta
        return -jnp.arctan2(matrix[..., 0, 2], matrix[..., 2, 2])
    if axis_code == AXIS_LR:
        return jnp.arctan2(matrix[..., 2, 1], matrix[..., 1, 1])
    return jnp.zeros(matrix.shape[:-2], dtype=matrix.dtype)
