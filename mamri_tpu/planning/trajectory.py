"""Trajectory goal IK: reach the needle standoff pose, collision-aware.

Parity with `planTrajectory` (Mamri/Mamri.py:882-939):
  * target frame: x_axis = normalize(target - entry); needle tip standoff =
    entry - safety_distance * x_axis (:900-901); y/z from world-up with the
    0.99-parallel fallback (:906-910).
  * bounded least squares from {current pose, zero pose}; the winner is the
    lowest final *position* error among converged runs (:929-933).
  * collision handling: the reference returns [1e4]*6 inside collision
    (:1541-1542) — a zero-gradient wall. Here the residual gets a smooth
    penetration-depth term instead, and reference-equivalent selection is
    restored afterwards by masking colliding solutions out of the argmin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mamri_tpu.core import transforms as T
from mamri_tpu.core.robot import RobotModel
from mamri_tpu.ik.lm import least_squares_lm
from mamri_tpu.ik.residuals import trajectory_pose_residual
from mamri_tpu.planning.collision import CollisionWorld, config_collides, config_penetration
from mamri_tpu.planning.geometry import ArmGeometry

COLLISION_PENALTY_WEIGHT = 20.0  # mm of penetration -> residual units

# Success gate on the winner's tip position error. The reference accepts any
# scipy-TRF run whose `result.success` is set (Mamri/Mamri.py:931) — but TRF
# reports success at ANY stationary point, so an out-of-workspace target can
# "succeed" tens of mm away from the goal. The fixed-iteration LM here has no
# convergence status, so the gate is explicit instead: reachable targets
# converge sub-mm (see tests/test_planning.py), while out-of-reach local
# minima sit tens of mm off; any cut in [1, 50] separates the two regimes.
# 10 mm = 2x the pipeline's DISTANCE_TOLERANCE (5 mm, Mamri.py:813) keeps a
# wide margin on both sides. Override via `success_threshold_mm`.
SUCCESS_POSITION_ERROR_MM = 10.0


class TrajectoryIKResult(NamedTuple):
    angles: jnp.ndarray  # (J,)
    position_error_mm: jnp.ndarray  # ()
    orientation_error: jnp.ndarray  # () |50*(tx-(-fx))|
    collides: jnp.ndarray  # () bool — boolean check at the solution
    success: jnp.ndarray  # () bool — converged, collision-free
    target_tf: jnp.ndarray  # (4, 4) the needle target frame solved for


def _orthonormal_basis(x_axis):
    """(y, z) completing `x_axis` to a right-handed frame, with the
    reference's world-up choice and 0.99-parallel fallback (Mamri.py:906-910).
    Shared by the goal-frame builder and the analytic seed generator so the
    degeneracy threshold can never drift between them."""
    up = jnp.asarray([0.0, 0.0, 1.0], dtype=x_axis.dtype)
    alt = jnp.asarray([0.0, 1.0, 0.0], dtype=x_axis.dtype)
    up = jnp.where(jnp.abs(T.matmul(x_axis, up)) > 0.99, alt, up)
    y_axis = jnp.cross(up, x_axis)
    y_axis = y_axis / jnp.maximum(jnp.linalg.norm(y_axis), 1e-9)
    z_axis = jnp.cross(x_axis, y_axis)
    return y_axis, z_axis


def needle_target_frame(target_ras, entry_ras, safety_distance_mm):
    """Build the needle goal frame from target/entry markers (Mamri.py:895-911)."""
    target_ras = jnp.asarray(target_ras, dtype=jnp.float32)
    entry_ras = jnp.asarray(entry_ras, dtype=jnp.float32)
    direction = target_ras - entry_ras
    x_axis = direction / jnp.maximum(jnp.linalg.norm(direction), 1e-9)
    tip = entry_ras - safety_distance_mm * x_axis
    y_axis, z_axis = _orthonormal_basis(x_axis)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, 0].set(x_axis).at[:3, 1].set(y_axis).at[:3, 2].set(z_axis).at[:3, 3].set(tip)
    return m


def analytic_trajectory_seeds(model: RobotModel, target_tf, base_tf, n_roll: int = 4):
    """(8*n_roll, J) closed-form joint-angle candidates reaching the needle
    goal frame.

    The trajectory objective constrains only the needle tip position and
    direction (5 DOF; `trajectory_pose_residual`): the roll about the needle
    axis is free. The Needle link is a pure translation child of Joint6, so
    the needle direction is Joint6's -x axis; for each of `n_roll` sampled
    rolls this builds the implied Joint6 world frame and takes all eight
    closed-form IK branches (ik/analytic.py) — 8*n_roll seeds whose LM polish
    is a short descent, not a search (vs the reference's 2-guess scipy-TRF
    budget, Mamri/Mamri.py:928-931)."""
    from mamri_tpu.ik.analytic import analytic_ik_seeds

    target_tf = jnp.asarray(target_tf)
    dtype = target_tf.dtype
    needle_off = model.fixed_offsets[model.link_index("Needle")][:3, 3]
    x6 = -target_tf[:3, 0]  # needle direction = -x of the Joint6/Needle frame
    tip = target_tf[:3, 3]
    y0, z0 = _orthonormal_basis(x6)
    rolls = (2.0 * jnp.pi / n_roll) * jnp.arange(n_roll, dtype=dtype)

    def seeds_for_roll(roll):
        c, s = jnp.cos(roll), jnp.sin(roll)
        y6 = c * y0 + s * z0
        z6 = -s * y0 + c * z0
        r = jnp.stack([x6, y6, z6], axis=1)
        frame = jnp.eye(4, dtype=dtype)
        frame = frame.at[:3, :3].set(r).at[:3, 3].set(tip - T.matmul(r, needle_off))
        return analytic_ik_seeds(model, frame, base_tf)

    return jax.vmap(seeds_for_roll)(rolls).reshape(-1, model.num_joints)


def solve_trajectory_ik(
    model: RobotModel,
    geometry: ArmGeometry,
    target_ras,
    entry_ras,
    safety_distance_mm,
    base_tf,
    world: Optional[CollisionWorld],
    current_angles=None,
    num_iters: Optional[int] = None,
    num_random_restarts: Optional[int] = None,
    restart_seed: int = 0,
    success_threshold_mm: float = SUCCESS_POSITION_ERROR_MM,
    analytic_seeds: Optional[bool] = None,
    seed_top_k: int = 4,
) -> TrajectoryIKResult:
    """`analytic_seeds=None` auto-enables closed-form seeding on the MAMRI
    chain geometry: 32 analytic branch candidates are scored by residual cost
    and the best `seed_top_k` join {current, zeros} for a short LM polish
    (num_iters 32, no random restarts) — less than a quarter of the
    unseeded path's LM work (8 guesses x 100 iters) at equal-or-better
    success. `analytic_seeds=False` restores the unseeded
    {current, zeros, 6 random} x 100-iter search.

    `num_random_restarts=0` is the documented strict-reference-emulation
    flag (the reference polishes exactly {current, zeros},
    Mamri.py:921-933), so it ALSO disables the auto analytic seeding and
    keeps the 100-iter budget unless those are overridden explicitly —
    otherwise the emulation knob would silently select different IK
    branches than the reference search."""
    from mamri_tpu.ik.analytic import chain_is_analytic

    nj = model.num_joints
    dtype = model.limits_rad.dtype
    if analytic_seeds is None:
        analytic_seeds = chain_is_analytic(model) and num_random_restarts != 0
    if num_iters is None:
        num_iters = 32 if analytic_seeds else 100
    if num_random_restarts is None:
        num_random_restarts = 0 if analytic_seeds else 6
    if current_angles is None:
        current_angles = jnp.zeros(nj, dtype=dtype)
    target_tf = needle_target_frame(target_ras, entry_ras, safety_distance_mm)

    def residual(x):
        base = trajectory_pose_residual(model, x, base_tf, target_tf)
        if world is None:
            return base
        pen = config_penetration(model, geometry.part_points, geometry.part_link_idx, x, base_tf, world)
        return jnp.concatenate([base, jnp.array([COLLISION_PENALTY_WEIGHT]) * pen[None]])

    lower = model.limits_rad[:, 0]
    upper = model.limits_rad[:, 1]
    guesses = [jnp.stack([jnp.asarray(current_angles, dtype=dtype), jnp.zeros(nj, dtype=dtype)])]
    if analytic_seeds:
        cand = analytic_trajectory_seeds(model, target_tf, base_tf)
        cand = jnp.clip(cand, lower[None, :], upper[None, :])
        costs = jax.vmap(lambda x: jnp.sum(residual(x) ** 2))(cand)
        _, top = jax.lax.top_k(-costs, min(seed_top_k, cand.shape[0]))
        guesses.append(cand[top])
    if num_random_restarts > 0:
        key = jax.random.PRNGKey(restart_seed)
        guesses.append(
            jax.random.uniform(key, (num_random_restarts, nj), minval=lower * 0.8, maxval=upper * 0.8)
        )
    guesses = jnp.concatenate(guesses)

    results = jax.vmap(lambda g: least_squares_lm(residual, g, lower, upper, num_iters=num_iters))(guesses)

    def eval_solution(x):
        pose_res = trajectory_pose_residual(model, x, base_tf, target_tf)
        pos_err = jnp.linalg.norm(pose_res[:3])
        orient_err = jnp.linalg.norm(pose_res[3:6])
        if world is None:
            coll = jnp.bool_(False)
        else:
            coll = config_collides(model, geometry.part_points, geometry.part_link_idx, x, base_tf, world)
        return pos_err, orient_err, coll

    pos_errs, orient_errs, colls = jax.vmap(eval_solution)(results.x)
    # reference semantics: colliding solutions carry a huge final error
    # ([1e4]*6 residual), so the argmin effectively selects collision-free
    score = jnp.where(colls, jnp.float32(1e8), pos_errs)
    best = jnp.argmin(score)
    return TrajectoryIKResult(
        angles=results.x[best],
        position_error_mm=pos_errs[best],
        orientation_error=orient_errs[best],
        collides=colls[best],
        success=jnp.logical_and(
            jnp.logical_not(colls[best]), pos_errs[best] < success_threshold_mm
        ),
        target_tf=target_tf,
    )
