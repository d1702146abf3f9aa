"""Geometry products that run on the device are pinned to full f32
precision (an f32 dot may otherwise run in TF32, ~3 decimal digits): each
is checked against the same product in float64 numpy."""

import numpy as np
import pytest

from mamri_tpu.api import MamriEngine
from mamri_tpu.api.demo import demo_base_tf
from mamri_tpu.core.robot import fk_all_links_host

# f32 keeps ~1e-5 mm at these coordinates (hundreds of mm); TF32 ~0.1 mm
TOL_MM = 1e-3


@pytest.fixture(scope="module")
def engine():
    return MamriEngine()


def _rot_x(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1.0]])


def _rot_z(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])


@pytest.mark.parametrize("yaw", [-0.4, 0.15, 0.4])
def test_demo_base_transform_matches_float64(yaw):
    t = np.eye(4)
    t[:3, 3] = [-60.0, -120.0, 0.0]
    want = t @ _rot_x(np.float32(-np.pi / 2)) @ _rot_z(np.float32(yaw))
    np.testing.assert_allclose(demo_base_tf(yaw), want, atol=1e-6)


def test_trajectory_tip_path_matches_float64(engine):
    rng = np.random.default_rng(4)
    lim = np.asarray(engine.model.limits_rad)
    path = (lim[:, 0] + rng.random((5, 6)) * (lim[:, 1] - lim[:, 0])).astype(np.float32)
    base = demo_base_tf(0.15)
    engine.trajectory_path = path
    engine.baseplate_tf = base
    try:
        _, polylines = engine._scene_objects(include_body=False)
    finally:
        engine.trajectory_path = None
        engine.baseplate_tf = None
    tips = dict(polylines)["TrajectoryTipPath"]
    needle = engine.model.link_index("Needle")
    tip_local = np.asarray(engine.model.needle_tip, np.float64)
    for a, got in zip(path, tips):
        tf = fk_all_links_host(engine.model, a.astype(np.float64), base.astype(np.float64))[needle]
        want = tf[:3, :3] @ tip_local + tf[:3, 3]
        assert np.abs(np.asarray(got, np.float64) - want).max() < TOL_MM


def test_orthonormal_basis_near_world_up():
    """The 0.99-parallel test is a dot on the device: a needle direction
    just inside and just outside the threshold picks the right up vector."""
    import jax.numpy as jnp

    from mamri_tpu.planning.trajectory import _orthonormal_basis

    for tilt, expect_alt in ((0.1, True), (0.2, False)):  # cos(0.1)=0.995, cos(0.2)=0.980
        x = np.array([np.sin(tilt), 0.0, np.cos(tilt)])
        y, z = (np.asarray(v, np.float64) for v in _orthonormal_basis(jnp.asarray(x, jnp.float32)))
        up = np.array([0.0, 1.0, 0.0]) if expect_alt else np.array([0.0, 0.0, 1.0])
        want_y = np.cross(up, x)
        want_y /= np.linalg.norm(want_y)
        np.testing.assert_allclose(y, want_y, atol=1e-6)
        np.testing.assert_allclose(z, np.cross(x, want_y), atol=1e-6)
