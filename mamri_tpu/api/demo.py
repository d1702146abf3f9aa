"""Self-contained demo scenes: the full workflow with zero input data.

The reference needs a real MR scan in the Slicer scene before any button
works; for evaluation, CI, and first contact this module builds the
canonical synthetic scene instead — the robot upright on the bed (mount
convention: local +Z along world +Y), petroleum-jelly-style fiducial
spheres rendered at the FK marker positions of a known pose, and an
ellipsoid body phantom. The same scene (and pose) backs `__graft_entry__`,
the bench's scene 0 and `chip_smoke.py`, so `python -m mamri_tpu demo`
exercises exactly the measured path.

`bench_scenes` / `bench_volume` / `add_speckle` build the bench's four
scenes on one shared grid, its large anisotropic acquisition shape and its
noisy-scan variant.
"""

from __future__ import annotations

import numpy as np

DEMO_ANGLES = (0.3, -0.7, 0.5, 0.2, -0.4, 0.6)
DEMO_BODY_CENTER_RAS = (-60.0, -40.0, 130.0)
DEMO_BODY_RADII_MM = (45.0, 55.0, 65.0)
MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")


def demo_base_tf(yaw: float) -> np.ndarray:
    """Robot mount on the bed: translate @ rot_x(-pi/2) @ rot_z(yaw), as a
    precision-pinned product (an f32 dot may otherwise run in TF32)."""
    import jax.numpy as jnp

    from mamri_tpu.core import transforms as T

    return np.asarray(
        T.chain(
            T.translate(jnp.array([-60.0, -120.0, 0.0])),
            T.rot_x(jnp.float32(-np.pi / 2)),
            T.rot_z(jnp.float32(yaw)),
        )
    )


def marker_points(engine, angles, base) -> np.ndarray:
    """(12, 3) world RAS fiducial centres of the four marker links."""
    import jax.numpy as jnp

    from mamri_tpu.core.robot import marker_world_positions

    return np.concatenate(
        [
            np.asarray(
                marker_world_positions(engine.model, jnp.asarray(angles), ln, jnp.asarray(base))
            )
            for ln in MARKER_LINKS
        ]
    )


def build_demo_scene(engine, spacing: float = 3.0, angles=None, yaw: float = 0.15):
    """-> (volume, true_angles, base_tf, target_ras).

    `spacing` trades fidelity for speed (3 mm default; larger for smoke
    runs). The grid is auto-fit to the FK marker bounding box + body
    phantom, so markers always render inside the volume. `target_ras` is a
    biopsy-style point inside the body phantom for entry-search/planning
    demos."""
    from mamri_tpu.perception.volume import synthetic_volume

    true_angles = np.asarray(
        DEMO_ANGLES if angles is None else angles, dtype=np.float32
    )
    base = demo_base_tf(yaw)
    pts = marker_points(engine, true_angles, base)
    body_center = np.asarray(DEMO_BODY_CENTER_RAS)
    lo = np.minimum(pts.min(0) - 40, body_center - 70)
    hi = np.maximum(pts.max(0) + 40, body_center + 70)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    sp = np.array([spacing] * 3, dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (lps_hi - lps_lo) / sp)
    volume = synthetic_volume(
        shape=shape,
        spacing=sp,
        origin=lps_lo,
        fiducials_ras=pts,
        fiducial_radius_mm=5.0,
        body_center_ras=list(body_center),
        body_radii_mm=list(DEMO_BODY_RADII_MM),
    )
    target_ras = (body_center + np.array([0.0, 0.0, -15.0])).astype(np.float32)
    return volume, true_angles, base, target_ras


def bench_scenes(engine, size: int):
    """The bench's 4 scenes on one shared cubic grid of `size`^3 voxels.

    Returns (scenes, spacing, origin, body_center): scenes are
    (true_angles, base_tf, marker_pts) for the canonical demo pose plus 3
    random in-bounds poses/base yaws (seeded), and the grid is the union
    bounding box of all their markers and the body phantom, so one compiled
    program serves every scene."""
    rng = np.random.default_rng(23)
    limits = np.asarray(engine.model.limits_rad)
    lo_lim, hi_lim = limits[:, 0], limits[:, 1]
    scenes = [(np.asarray(DEMO_ANGLES, dtype=np.float32), demo_base_tf(0.15))]
    for _ in range(3):
        frac = 0.25 + 0.5 * rng.random(6)
        angles = (lo_lim + frac * (hi_lim - lo_lim)).astype(np.float32)
        if abs(angles[4]) < 0.3:  # keep J5 off the wrist singularity
            angles[4] = np.float32(0.3 if angles[4] >= 0 else -0.3)
        scenes.append((angles, demo_base_tf(float(rng.uniform(-0.4, 0.4)))))
    scenes = [(a, b, marker_points(engine, a, b)) for a, b in scenes]

    body_center = np.asarray(DEMO_BODY_CENTER_RAS)
    all_pts = np.concatenate([s[2] for s in scenes])
    lo = np.minimum(all_pts.min(0) - 40, body_center - 75)
    hi = np.maximum(all_pts.max(0) + 40, body_center + 75)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    spacing = np.full(3, float((lps_hi - lps_lo).max()) / size, dtype=np.float32)
    return scenes, spacing, lps_lo, body_center


def bench_volume(marker_pts, shape, spacing, origin, body_center):
    """Render one bench scene (4 mm fiducials, the bench's body phantom)."""
    from mamri_tpu.perception.volume import synthetic_volume

    return synthetic_volume(
        shape=tuple(shape),
        spacing=spacing,
        origin=origin,
        fiducials_ras=marker_pts,
        fiducial_radius_mm=4.0,
        body_center_ras=body_center,
        body_radii_mm=[45.0, 55.0, 65.0],
    )


def add_speckle(data, n_speckle: int = 1500, seed: int = 5) -> np.ndarray:
    """The bench's noisy-scan variant: `n_speckle` single-voxel bright
    speckles away from existing structures (each its own component) plus
    sub-threshold gaussian noise. The ITK reference has no component cap,
    so certificates must hold without truncation."""
    rng = np.random.default_rng(seed)
    noisy = np.array(data, dtype=np.float32, copy=True)
    size = min(noisy.shape)
    idx = rng.integers(2, size - 2, size=(n_speckle, 3))
    bright = noisy > 60.0
    for i, j, k in idx:
        if not bright[i - 2 : i + 3, j - 2 : j + 3, k - 2 : k + 3].any():
            noisy[i, j, k] = 100.0
    return noisy + rng.normal(0.0, 5.0, noisy.shape).astype(np.float32)
