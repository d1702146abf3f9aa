"""Composed full-reference-pipeline oracle vs `estimate_pose` on the same bytes.

BASELINE config 2 as written is unsatisfiable (the reference ships no scan —
its Testing tree is one commented-out CMake line), so this is the stand-in:
one synthetic DICOM series is written to disk, loaded back, and pushed
through TWO independent implementations of the reference's `process()` chain
(Mamri/Mamri.py:850-880):

  oracle:  scipy.ndimage segmentation (`perception/reference_cpu`, the ITK-
           semantics golden) -> numpy combinatorial L-shape matcher ->
           numpy SVD Kabsch on the Y-flattened baseplate -> SciPy TRF IK
           (`ik/trf.py`, the reference's exact solver config)
  engine:  `MamriEngine.estimate_pose` — the fused JAX program (XLA
           segmentation + vectorized matcher + Horn Kabsch + vmapped LM)

and the final outputs (joint angles, steps, baseplate transform, TCP) must
agree. Every stage has its own parity suite already; this test proves the
COMPOSITION agrees end-to-end on identical on-disk bytes.

The matcher/corner-ordering here uses the corrected min-error rule (the
engine's default `match_mode="best"`); the reference's order-dependent
first-match behavior is separately oracle-tested in tests/test_lshape.py
with `strict_reference_order=True`.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest

from mamri_tpu.api import MamriEngine
from mamri_tpu.core import transforms as T
from mamri_tpu.core.robot import fk_all_links, marker_world_positions
from mamri_tpu.ik.trf import solve_full_chain_trf
from mamri_tpu.perception.dicom import load_dicom_series, save_dicom_series
from mamri_tpu.perception.reference_cpu import segment_reference
from mamri_tpu.perception.volume import synthetic_volume

TRUE_ANGLES = np.array([0.3, -0.7, 0.5, 0.2, -0.4, 0.6], dtype=np.float32)
MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
TOL_MM = 5.0  # DISTANCE_TOLERANCE (Mamri.py:813)


# ---------------------------------------------------------------- numpy oracle
def _order_l(points, l1, l2):
    """(corner, short-arm end, long-arm end) by minimum arm-length error."""
    l_short, l_long = sorted((float(l1), float(l2)))
    best, best_err = None, np.inf
    for i in range(3):
        c = points[i]
        others = [points[(i + 1) % 3], points[(i + 2) % 3]]
        for a, b in (others, others[::-1]):
            err = abs(np.linalg.norm(c - a) - l_short) + abs(np.linalg.norm(c - b) - l_long)
            if err < best_err:
                best_err = err
                best = np.stack([c, a, b])
    return best


def _match_triplets(centroids, arm_lengths, tol=TOL_MM):
    """Per-link min-error C(n,3) match with blob consumption (the corrected
    semantics of the reference's joint_detection, Mamri.py:1343-1363)."""
    used = set()
    out = {}
    n = len(centroids)
    for link, (l1, l2) in arm_lengths.items():
        expected = sorted([l1, l2, math.hypot(l1, l2)])
        best, best_err = None, np.inf
        for combo in itertools.combinations(range(n), 3):
            if any(c in used for c in combo):
                continue
            p = centroids[list(combo)]
            d = sorted(
                [
                    np.linalg.norm(p[0] - p[1]),
                    np.linalg.norm(p[0] - p[2]),
                    np.linalg.norm(p[1] - p[2]),
                ]
            )
            errs = [abs(a - b) for a, b in zip(d, expected)]
            if max(errs) <= tol and sum(errs) < best_err:
                best_err = sum(errs)
                best = combo
        if best is not None:
            used.update(best)
            out[link] = _order_l(centroids[list(best)], l1, l2)
    return out


def _kabsch_np(local, world):
    """Rigid SVD Kabsch local->world (vtkLandmarkTransform RigidBody)."""
    lc, wc = local.mean(0), world.mean(0)
    h = (local - lc).T @ (world - wc)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    tf = np.eye(4)
    tf[:3, :3] = r
    tf[:3, 3] = wc - r @ lc
    return tf


def _oracle_process(model, volume, current_angles):
    """The reference's process() composed from the CPU oracle stages."""
    seg = segment_reference(volume)
    arms = {ln: tuple(model.spec(ln).arm_lengths) for ln in MARKER_LINKS}
    matched = _match_triplets(np.asarray(seg.centroids_ras, dtype=np.float64), arms)
    assert set(matched) == set(MARKER_LINKS), f"oracle matched only {sorted(matched)}"

    bp = matched["Baseplate"].copy()
    bp[:, 1] = bp[:, 1].mean()  # Y-flatten (Mamri.py:1371-1373)
    bp_local = np.asarray(model.marker_local[model.link_index("Baseplate")], dtype=np.float64)
    base_tf = _kabsch_np(bp_local, bp)

    ik = solve_full_chain_trf(
        model,
        matched["Joint6"],
        base_tf,
        current_angles=current_angles,
        joint4_targets=matched["Joint4"],
        joint4_found=True,
    )
    steps = np.trunc(ik.angles * 3332.0 / (2 * np.pi)).astype(int)
    return ik, steps, base_tf


# ---------------------------------------------------------------- the test
@pytest.fixture(scope="module")
def dicom_volume(tmp_path_factory):
    """One synthetic scan, written as a DICOM series and loaded back — both
    pipelines consume these identical on-disk bytes."""
    eng = MamriEngine()
    base = np.asarray(
        T.translate(jnp.array([-60.0, -120.0, 0.0]))
        @ T.rot_x(jnp.float32(-np.pi / 2))
        @ T.rot_z(jnp.float32(0.15))
    )
    pts = np.concatenate(
        [
            np.asarray(marker_world_positions(eng.model, jnp.asarray(TRUE_ANGLES), ln, jnp.asarray(base)))
            for ln in MARKER_LINKS
        ]
    )
    body_center = np.array([-60.0, -40.0, 130.0])
    lo = np.minimum(pts.min(0) - 40, body_center - 60)
    hi = np.maximum(pts.max(0) + 40, body_center + 60)
    sp = np.full(3, 2.5, dtype=np.float32)
    lps_lo = np.array([-hi[0], -hi[1], lo[2]], dtype=np.float32)
    lps_hi = np.array([-lo[0], -lo[1], hi[2]], dtype=np.float32)
    shape = tuple(int(np.ceil(e)) for e in (lps_hi - lps_lo) / sp)
    vol = synthetic_volume(
        shape=shape,
        spacing=sp,
        origin=lps_lo,
        fiducials_ras=pts,
        fiducial_radius_mm=4.0,
        body_center_ras=body_center,
        body_radii_mm=[40.0, 50.0, 55.0],
    )
    d = tmp_path_factory.mktemp("ref_pipeline_dicom")
    save_dicom_series(str(d), vol)
    loaded = load_dicom_series(str(d))
    np.testing.assert_allclose(np.asarray(loaded.data, np.float32), vol.data, atol=0)
    return loaded, base


def test_reference_pipeline_composition_agrees(dicom_volume):
    vol, base = dicom_volume
    warm = TRUE_ANGLES + 0.1  # "current pose" guess: last known approximate pose

    eng = MamriEngine()
    eng.set_pose(warm)
    est = eng.estimate_pose(vol)
    assert est.success, est.message

    oracle_ik, oracle_steps, oracle_base = _oracle_process(eng.model, vol, warm)

    # 1. baseplate transforms agree (and match the constructed base)
    np.testing.assert_allclose(est.baseplate_tf, oracle_base, atol=1e-3)
    np.testing.assert_allclose(oracle_base, base, atol=0.5)

    # 2. joint angles agree chain-vs-chain to < 0.1 deg, steps to <= 2
    diff_deg = np.degrees(np.abs(est.angles_rad - oracle_ik.angles))
    assert np.all(diff_deg < 0.1), diff_deg
    assert np.max(np.abs(est.steps - oracle_steps)) <= 2, (est.steps, oracle_steps)

    # 3. TCP positions agree sub-0.2 mm; both sub-2 mm of the truth
    def tcp(a, b):
        return np.asarray(fk_all_links(eng.model, jnp.asarray(np.asarray(a, np.float32)), jnp.asarray(b)))[-1][:3, 3]

    tcp_engine = tcp(est.angles_rad, est.baseplate_tf)
    tcp_oracle = tcp(oracle_ik.angles, oracle_base)
    tcp_true = tcp(TRUE_ANGLES, base)
    assert np.linalg.norm(tcp_engine - tcp_oracle) < 0.2
    assert np.linalg.norm(tcp_engine - tcp_true) < 2.0
    assert np.linalg.norm(tcp_oracle - tcp_true) < 2.0

    # 4. both within the oracle-established gauge bound of the truth
    assert np.degrees(np.abs(est.angles_rad - TRUE_ANGLES)).max() < 2.5
    assert np.degrees(np.abs(oracle_ik.angles - TRUE_ANGLES)).max() < 2.5

    # 5. marker RMSE agreement (reference convention: over the 9 J6 errors)
    assert abs(est.rmse_mm - oracle_ik.rmse) < 0.05, (est.rmse_mm, oracle_ik.rmse)
