"""Voxel-grid collision checking between the robot and the patient body.

The reference runs vtkCollisionDetectionFilter (triangle-exact, C++) per robot
part per configuration, sequentially (Mamri/Mamri.py:1555-1575, :976-982).
Accelerator redesign: the body segmentation IS already a voxel grid — robot
part surfaces become point clouds (utils/stl.py), a configuration check is
"transform points by FK, sample the occupancy grid", and a whole 101-sample
trajectory is one vmapped tensor op. Conservative in the safety-critical
direction: any sampled robot point inside a body voxel flags a collision.

For gradient-based trajectory IK, `config_penetration` returns a smooth
penetration depth from a chamfer inside-distance field — unlike the
reference's constant 1e4 residual wall (zero gradient), this pushes the
optimizer OUT of contact.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from mamri_tpu.core.robot import RobotModel, fk_all_links
from mamri_tpu.core import transforms

_PARTS_TO_CHECK = ("Joint1", "Joint2", "Joint3", "Joint4", "Joint5", "Joint6")


class CollisionWorld(NamedTuple):
    occupancy: jnp.ndarray  # (nx, ny, nz) f32 in {0, 1} — DILATED by
    # `dilation_vox` shells: the boolean contact test errs colliding, never
    # free (SURVEY §7: the safety-critical direction must be conservative;
    # surface point clouds sample the part at finite density, and without a
    # margin a thin body wall could pass between sample points). The default
    # 2-shell margin (~4 mm at 2 mm spacing) is the smallest that yields ZERO
    # false-free over 1000 random configs vs a triangle-dense oracle on the
    # reference's own collision hulls (tests/test_collision_conservative.py),
    # and sits inside the reference's 5 mm default safety distance
    inside_depth: jnp.ndarray  # (nx, ny, nz) f32 mm, 0 outside the body
    spacing: jnp.ndarray  # (3,)
    origin: jnp.ndarray  # (3,) LPS
    dilation_vox: int = 2


def build_collision_world(
    body_mask, spacing, origin, depth_iters: int = 6, dilation_vox: int = 2
) -> CollisionWorld:
    """Build occupancy + chamfer inside-depth from a body mask.

    The boolean-contact occupancy is dilated by `dilation_vox` 26-neighbor
    shells (conservatism margin, validated against a triangle-dense oracle in
    tests/test_collision_conservative.py); `inside_depth` approximates
    distance-to-surface inside the UNdilated body via iterated 6-neighbor
    min-plus propagation (capped at `depth_iters` voxel shells — the IK
    penalty only needs gradients near the surface).
    """
    occ_raw = jnp.asarray(body_mask)
    occ_b = occ_raw
    for _ in range(int(dilation_vox)):
        grown = occ_b
        for axis in (0, 1, 2):
            n = grown.shape[axis]
            idx = lax.broadcasted_iota(jnp.int32, grown.shape, axis)
            # zero-filled shifts: a body clipped at the grid border must not
            # wrap around to the opposite plane
            r1 = jnp.logical_and(jnp.roll(grown, 1, axis=axis), idx >= 1)
            r2 = jnp.logical_and(jnp.roll(grown, -1, axis=axis), idx < n - 1)
            grown = jnp.logical_or(grown, jnp.logical_or(r1, r2))
        occ_b = grown
    occ = occ_b.astype(jnp.float32)
    spacing = jnp.asarray(spacing, dtype=jnp.float32)
    origin = jnp.asarray(origin, dtype=jnp.float32)

    inside = occ_raw.astype(jnp.float32)
    big = jnp.float32(1e6)
    depth = jnp.where(inside > 0, big, 0.0)

    def chamfer_step(d, _):
        best = d
        for axis, step in ((0, spacing[0]), (1, spacing[1]), (2, spacing[2])):
            for shift in (1, -1):
                nb = jnp.roll(d, shift, axis=axis) + step
                # roll wraparound: treat border as outside (0 + step), safe
                best = jnp.minimum(best, nb)
        return jnp.where(inside > 0, best, 0.0), None

    depth, _ = lax.scan(chamfer_step, depth, None, length=depth_iters)
    max_depth = float(depth_iters) * jnp.max(spacing)
    depth = jnp.minimum(depth, max_depth)
    return CollisionWorld(
        occupancy=occ,
        inside_depth=depth,
        spacing=spacing,
        origin=origin,
        dilation_vox=int(dilation_vox),
    )


def _ras_to_index(points_ras, spacing, origin):
    lps = points_ras * jnp.asarray([-1.0, -1.0, 1.0], dtype=points_ras.dtype)
    return (lps - origin) / spacing


def sample_grid(grid, idx):
    """Trilinear sampling of a 3-D grid at fractional indices (N, 3).
    Out-of-bounds samples read as 0 (no body there)."""
    nx, ny, nz = grid.shape
    shape = jnp.asarray([nx, ny, nz], dtype=idx.dtype)
    in_bounds = jnp.all(jnp.logical_and(idx >= 0.0, idx <= shape - 1.0), axis=-1)
    idxc = jnp.clip(idx, 0.0, shape - 1.0)
    i0 = jnp.floor(idxc).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, jnp.asarray([nx - 1, ny - 1, nz - 1]))
    f = idxc - i0.astype(idx.dtype)

    def g(ii, jj, kk):
        return grid[ii, jj, kk]

    c000 = g(i0[:, 0], i0[:, 1], i0[:, 2])
    c100 = g(i1[:, 0], i0[:, 1], i0[:, 2])
    c010 = g(i0[:, 0], i1[:, 1], i0[:, 2])
    c110 = g(i1[:, 0], i1[:, 1], i0[:, 2])
    c001 = g(i0[:, 0], i0[:, 1], i1[:, 2])
    c101 = g(i1[:, 0], i0[:, 1], i1[:, 2])
    c011 = g(i0[:, 0], i1[:, 1], i1[:, 2])
    c111 = g(i1[:, 0], i1[:, 1], i1[:, 2])
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return (c0 * (1 - fz) + c1 * fz) * in_bounds


def _transformed_part_points(model: RobotModel, part_points, part_link_idx: Sequence[int], angles, base_tf):
    """FK-place all part point clouds: (n_parts, P, 3) world RAS points."""
    tfs = fk_all_links(model, angles, base_tf)
    part_tfs = jnp.stack([tfs[i] for i in part_link_idx])  # (n_parts, 4, 4)
    return transforms.apply(part_tfs, part_points)


def config_collides(model: RobotModel, part_points, part_link_idx, angles, base_tf, world: CollisionWorld, occ_threshold: float = 0.5):
    """Boolean any-contact test for one joint configuration.

    Mirrors `_check_collision` (Mamri.py:1555-1575): only the articulated
    parts Joint1..Joint6 participate (callers pass those part clouds).
    """
    pts = _transformed_part_points(model, part_points, part_link_idx, angles, base_tf)
    idx = _ras_to_index(pts.reshape(-1, 3), world.spacing, world.origin)
    occ = sample_grid(world.occupancy, idx)
    return jnp.any(occ > occ_threshold)


def config_penetration(model: RobotModel, part_points, part_link_idx, angles, base_tf, world: CollisionWorld):
    """Smooth total penetration (mm) of the arm into the body — differentiable
    collision cost for trajectory IK."""
    pts = _transformed_part_points(model, part_points, part_link_idx, angles, base_tf)
    idx = _ras_to_index(pts.reshape(-1, 3), world.spacing, world.origin)
    depth = sample_grid(world.inside_depth, idx)
    return jnp.sum(depth) / pts.shape[1]  # normalize by points-per-part
