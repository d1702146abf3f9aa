"""SciPy-TRF oracle: the REFERENCE solver run on THIS framework's residuals.

SURVEY.md §7 requires "verify angle recovery to sub-degree vs the reference
solver on identical residuals". The reference solves its pose IK with
``scipy.optimize.least_squares(method='trf', bounds=joint limits, ftol=1e-6,
xtol=1e-6)`` from two initial guesses {current pose, zero pose}, keeping the
lower-cost solution (Mamri/Mamri.py:1425, :1430-1437); its trajectory IK uses
``ftol=xtol=1e-4, max_nfev=200`` (Mamri/Mamri.py:925-928).

This module runs exactly that solver configuration on the very residual
closures ``ik/residuals.py`` builds — the Jacobian handed to SciPy is the
same ``jax.jacfwd`` the on-device LM differentiates — so any disagreement
between this oracle and ``solve_full_chain_ik`` is attributable to the
solver, not the objective. Host-only (SciPy's TRF is compiled CPU code);
pin JAX to CPU before calling from an accelerator session (tools/ik_oracle.py
does).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from mamri_tpu.core.robot import RobotModel
from mamri_tpu.ik.residuals import full_chain_residual, trajectory_pose_residual


class TRFResult(NamedTuple):
    angles: np.ndarray  # (J,) best solution
    rmse: float  # over the 9 Joint6 errors (reference convention, Mamri.py:1445)
    cost: float  # 0.5 * |r|^2 (SciPy convention)
    best_guess: int  # which initial guess won
    nfev: int  # residual evaluations summed over guesses
    per_guess: np.ndarray  # (G, J) every converged solution (branch inspection)
    per_guess_cost: np.ndarray  # (G,)


def _jitted_pair(residual, n):
    """(fun, jac) numpy-in/numpy-out wrappers around one jitted residual."""
    import jax
    import jax.numpy as jnp

    res_j = jax.jit(residual)
    jac_j = jax.jit(jax.jacfwd(residual))

    def fun(x):
        return np.asarray(res_j(jnp.asarray(x, jnp.float32)), dtype=np.float64)

    def jac(x):
        return np.asarray(jac_j(jnp.asarray(x, jnp.float32)), dtype=np.float64)

    return fun, jac


def _run_trf(residual, guesses, lower, upper, ftol, xtol, max_nfev):
    from scipy.optimize import least_squares

    fun, jac = _jitted_pair(residual, len(lower))
    sols, costs, nfev = [], [], 0
    for g in guesses:
        x0 = np.clip(np.asarray(g, dtype=np.float64), lower, upper)
        out = least_squares(
            fun, x0, jac=jac, bounds=(lower, upper), method="trf",
            ftol=ftol, xtol=xtol, max_nfev=max_nfev,
        )
        sols.append(out.x)
        costs.append(out.cost)
        nfev += int(out.nfev)
    costs = np.asarray(costs)
    best = int(np.argmin(costs))
    return sols, costs, best, nfev


def solve_full_chain_trf(
    model: RobotModel,
    joint6_targets,
    base_tf,
    current_angles=None,
    apply_correction: bool = False,
    joint4_targets=None,
    joint4_found: bool = False,
    extra_guesses: Optional[Sequence] = None,
    ftol: float = 1e-6,
    xtol: float = 1e-6,
    max_nfev: Optional[int] = None,
) -> TRFResult:
    """Reference pose-IK solve (Mamri.py:1410-1447) on this repo's residual.

    Guesses default to the reference's {current pose, zeros}
    (Mamri.py:1425); pass ``extra_guesses`` to hand the oracle the same
    analytic seeds the LM path polishes (branch-for-branch comparison).
    """
    import jax.numpy as jnp

    nj = model.num_joints
    lower = np.asarray(model.limits_rad[:, 0], dtype=np.float64)
    upper = np.asarray(model.limits_rad[:, 1], dtype=np.float64)
    if current_angles is None:
        current_angles = np.zeros(nj)
    guesses = [np.asarray(current_angles, dtype=np.float64), np.zeros(nj)]
    if extra_guesses is not None:
        guesses += [np.asarray(g, dtype=np.float64) for g in extra_guesses]

    j6 = jnp.asarray(np.asarray(joint6_targets, dtype=np.float32))
    j4 = (
        jnp.asarray(np.asarray(joint4_targets, dtype=np.float32))
        if joint4_targets is not None
        else None
    )
    base = jnp.asarray(np.asarray(base_tf, dtype=np.float32))

    def residual(x):
        return full_chain_residual(
            model, x, base, j6, apply_correction, j4, joint4_found
        )

    sols, costs, best, nfev = _run_trf(residual, guesses, lower, upper, ftol, xtol, max_nfev)
    fun, _ = _jitted_pair(residual, nj)
    e6 = fun(sols[best])[:9]
    return TRFResult(
        angles=sols[best],
        rmse=float(np.sqrt(np.mean(e6 * e6))),
        cost=float(costs[best]),
        best_guess=best,
        nfev=nfev,
        per_guess=np.stack(sols),
        per_guess_cost=costs,
    )


def solve_trajectory_trf(
    model: RobotModel,
    target_tf,
    base_tf,
    current_angles=None,
    ftol: float = 1e-4,
    xtol: float = 1e-4,
    max_nfev: int = 200,
) -> TRFResult:
    """Reference trajectory-IK solve (Mamri.py:882-939, pose part of the
    residual only — the reference's 1e4 collision wall has zero gradient and
    is composed outside the solver here, exactly as in planning/)."""
    import jax.numpy as jnp

    nj = model.num_joints
    lower = np.asarray(model.limits_rad[:, 0], dtype=np.float64)
    upper = np.asarray(model.limits_rad[:, 1], dtype=np.float64)
    if current_angles is None:
        current_angles = np.zeros(nj)
    guesses = [np.asarray(current_angles, dtype=np.float64), np.zeros(nj)]

    target = jnp.asarray(np.asarray(target_tf, dtype=np.float32))
    base = jnp.asarray(np.asarray(base_tf, dtype=np.float32))

    def residual(x):
        return trajectory_pose_residual(model, x, base, target)

    sols, costs, best, nfev = _run_trf(residual, guesses, lower, upper, ftol, xtol, max_nfev)
    fun, _ = _jitted_pair(residual, nj)
    r = fun(sols[best])
    return TRFResult(
        angles=sols[best],
        rmse=float(np.linalg.norm(r[:3])),  # position error, mm
        cost=float(costs[best]),
        best_guess=best,
        nfev=nfev,
        per_guess=np.stack(sols),
        per_guess_cost=costs,
    )
