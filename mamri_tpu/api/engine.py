"""MamriEngine — the public facade of the framework.

Equivalent surface to the reference's `MamriLogic` (Mamri/Mamri.py:801-1935):
pose estimation (`process` -> `estimate_pose`), baseplate persistence, entry
point search, trajectory goal IK, heuristic path planning, pose state, unit
conversion, and the hardware stack — but the compute path is one fused,
jit-compiled program per volume shape, and batched estimation over a device
mesh is first-class (the reference has no batching at all).

Scene-graph state (MRML nodes) becomes plain arrays on this object; the
functional core stays pure.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from collections import OrderedDict
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mamri_tpu.core import transforms
from mamri_tpu.core.robot import RobotModel, fk_all_links, fk_all_links_host, load_robot_model
from mamri_tpu.core.units import (
    angles_to_steps,
    angles_to_steps_host,
    steps_to_angles_host,
)
from mamri_tpu.ik.residuals import solve_full_chain_ik
from mamri_tpu.perception.segmentation import SegmentationParams, segment_volume
from mamri_tpu.perception.volume import Volume
from mamri_tpu.planning.collision import build_collision_world
from mamri_tpu.planning.entry import EntryPointResult, find_entry_point
from mamri_tpu.planning.geometry import ArmGeometry, build_arm_geometry
from mamri_tpu.planning.heuristic import check_path_collisions, heuristic_keyframes, interpolate_path
from mamri_tpu.planning.trajectory import solve_trajectory_ik
from mamri_tpu.registration.kabsch import kabsch_rigid_transform
from mamri_tpu.registration.lshape import (
    match_l_shaped_triplets,
    match_l_shaped_triplets_global,
)
from mamri_tpu.api.types import ActionState, PoseEstimate, TrajectoryPlan
from mamri_tpu.utils.trace import Tracer

logger = logging.getLogger(__name__)

MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
DEFAULT_SAFETY_DISTANCE_MM = 5.0


class _LRUCache:
    """Bounded insertion-ordered cache for compiled executables. A long-lived
    engine ingesting heterogeneous scan shapes would otherwise accumulate one
    XLA executable per (shape, params, ...) key forever; shapes in practice
    number a handful, so a small bound evicts only truly stale programs.

    Thread-safe: a serving deployment drives one engine from several request
    threads, and an unlocked OrderedDict LRU can raise KeyError when one
    thread's eviction (`popitem`) races another's `move_to_end`. All ops hold
    an RLock; callers use `get_or_set` so lookup-or-build is one atomic step
    (the factories only CONSTRUCT `jax.jit` wrappers — lazy, no compilation —
    so holding the lock across them is cheap)."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._d: "OrderedDict" = OrderedDict()
        self._lock = threading.RLock()

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __getitem__(self, key):
        with self._lock:
            self._d.move_to_end(key)
            return self._d[key]

    def __setitem__(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def get_or_set(self, key, factory):
        """Return the cached value for `key`, building it with `factory()`
        under the lock if absent — concurrent same-key callers share ONE
        executable and a key can never vanish between test and fetch."""
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            value = factory()
            self[key] = value
            return value

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


class MamriEngine:
    def __init__(
        self,
        config_path: Optional[str] = None,
        mesh_dir: Optional[str] = None,  # kept for the exact plan validator
        seg_params: Optional[SegmentationParams] = None,
        tracer: Optional[Tracer] = None,
        ik_iters: int = 24,
        ik_restarts: int = 2,
        match_mode: str = "best",
        jit_cache_size: int = 32,
    ):
        if match_mode not in ("best", "strict", "global"):
            raise ValueError(
                f"match_mode must be 'best' (min-error greedy), 'strict' "
                f"(reference first-match greedy) or 'global' (exhaustive "
                f"assignment), got {match_mode!r}"
            )
        self.model: RobotModel = load_robot_model(config_path)
        self.geometry: ArmGeometry = build_arm_geometry(self.model, mesh_dir)
        self.mesh_dir = mesh_dir
        self._exact_parts = None  # dense hulls for validate_plan_exact, lazy
        # default: the fast certified settings — a 3-half-sweep CCL schedule
        # [yz, x, yz] plus the local-consistency convergence certificate (a
        # d=1 check pass that proves the exact fixed point at ~1/4 sweep
        # cost, so no pass is spent proving rather than propagating, and the
        # final x half-sweep convex-ish anatomy never needs is dropped) and
        # 128 candidate roots with a completeness certificate; estimate_pose
        # escalates automatically when either certificate fails, so results
        # match the conservative settings. (A scene needing more reruns at 6
        # half-sweeps via the escalation path.)
        self.seg_params = (
            seg_params
            if seg_params is not None
            else SegmentationParams(max_sweeps=2, passes=3, max_roots=128)
        )
        self.tracer = tracer or Tracer(enabled=False)
        self.ik_iters = ik_iters
        self.ik_restarts = ik_restarts
        self.match_mode = match_mode

        self._arm_lengths = [self.model.spec(ln).arm_lengths for ln in MARKER_LINKS]
        # mutable scene state (the reference keeps this in MRML nodes)
        self.current_angles = np.zeros(self.model.num_joints, dtype=np.float32)
        self.baseplate_tf: Optional[np.ndarray] = None
        self.saved_baseplate: Optional[np.ndarray] = None
        self.last_ik_error: Optional[float] = None
        self.last_segmentation = None
        self.last_volume_geom: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (spacing, origin)
        self.last_collision_world = None
        self.trajectory_path: Optional[np.ndarray] = None
        self.trajectory_keyframes: Optional[np.ndarray] = None
        self.last_estimated_steps: Optional[np.ndarray] = None
        self.hardware = None  # HardwareStack, attached on demand

        self._pipeline_cache = _LRUCache(jit_cache_size)
        self._batch_cache = _LRUCache(max(4, jit_cache_size // 2))
        # planning programs get their own cache: scan-shape churn in the
        # pipeline cache must not evict jitted plan fns out from under the
        # streaming re-plan hot path
        self._plan_cache = _LRUCache(16)

    # ------------------------------------------------------------------ compute core
    def pipeline_fn(self, seg_params: Optional[SegmentationParams] = None, seg_fn=None):
        """The fused per-volume program: segmentation -> matching -> baseplate
        -> full-chain IK. One trace, one XLA program, no host round-trips.

        `seg_fn` swaps the segmentation stage (same signature as
        `segment_volume`) — the shard_map'd sp path injects
        `segment_volume_sharded` here; everything downstream operates on the
        replicated blob stats and stays identical."""
        model = self.model
        seg_params = seg_params if seg_params is not None else self.seg_params
        seg_fn = seg_fn if seg_fn is not None else segment_volume
        arm_lengths = self._arm_lengths
        bp_local = model.marker_local[model.link_index("Baseplate")]
        ik_iters = self.ik_iters
        ik_restarts = self.ik_restarts

        match_mode = self.match_mode

        def pipeline(data, spacing, origin, saved_tf, use_saved, have_saved, apply_correction, current_angles):
            seg = seg_fn(data, spacing, origin, seg_params)
            if match_mode == "global":
                matches = match_l_shaped_triplets_global(
                    seg.centroids_ras, seg.blob_valid, arm_lengths
                )
            else:
                matches = match_l_shaped_triplets(
                    seg.centroids_ras,
                    seg.blob_valid,
                    arm_lengths,
                    strict_reference_order=(match_mode == "strict"),
                )
            bp_found = matches.found[0]

            # baseplate: Y-flatten detected markers (Mamri.py:1371-1373), Kabsch
            bp_pts = matches.points[0]
            bp_pts = bp_pts.at[:, 1].set(jnp.mean(bp_pts[:, 1]))
            detected_tf = kabsch_rigid_transform(bp_local, bp_pts)

            # priority: saved-if-requested > detected > saved fallback (Mamri.py:1382-1408)
            use_saved_now = jnp.logical_and(use_saved, have_saved)
            fallback_saved = jnp.logical_and(jnp.logical_not(bp_found), have_saved)
            base_tf = jnp.where(
                use_saved_now, saved_tf, jnp.where(bp_found, detected_tf, saved_tf)
            )
            base_ok = jnp.logical_or(use_saved_now, jnp.logical_or(bp_found, fallback_saved))
            # source code: 0=none 1=detected 2=saved 3=saved_fallback
            source = jnp.where(
                use_saved_now,
                2,
                jnp.where(bp_found, 1, jnp.where(fallback_saved, 3, 0)),
            )

            j6_found = matches.found[3]
            ik = solve_full_chain_ik(
                model,
                matches.points[3],
                base_tf,
                current_angles=current_angles,
                apply_correction=apply_correction,
                joint4_targets=matches.points[2],
                joint4_found=matches.found[2],
                num_iters=ik_iters,
                num_random_restarts=ik_restarts,
                joint2_targets=matches.points[1],
                joint2_found=matches.found[1],
            )
            steps = angles_to_steps(ik.angles, model.steps_per_rev)
            success = jnp.logical_and(base_ok, j6_found)
            return {
                "success": success,
                "angles": ik.angles,
                "steps": steps,
                "rmse": ik.rmse,
                "base_tf": base_tf,
                "base_ok": base_ok,
                "base_source": source,
                "markers_found": matches.found,
                "num_blobs": seg.num_blobs,
                "body_mask": seg.body_mask,
                "body_found": seg.body_found,
                "num_components": seg.num_components,
                "seg_converged": seg.ccl_converged,
                "roots_complete": seg.roots_complete,
                "blobs_complete": seg.blobs_complete,
                # sub-certificate: which budget failed (targeted escalation)
                "seg_count_ok": seg.count_ok,
            }

        return pipeline

    def clear_caches(self) -> None:
        """Drop all cached compiled executables (pipeline, batch, planning).
        Subsequent calls re-jit; XLA's on-disk compilation cache makes that
        cheap for previously seen shapes."""
        self._pipeline_cache.clear()
        self._batch_cache.clear()
        self._plan_cache.clear()

    def _get_pipeline(self, shape, seg_params: Optional[SegmentationParams] = None):
        params = seg_params if seg_params is not None else self.seg_params
        key = (tuple(shape), params)
        return self._pipeline_cache.get_or_set(
            key, lambda: jax.jit(self.pipeline_fn(params))
        )

    @staticmethod
    def _escalate_seg_params(
        params: SegmentationParams,
        converged: bool,
        complete: bool,
        blobs_complete: bool = True,
        count_ok: Optional[bool] = None,
    ):
        """One escalation step for an uncertified segmentation result.

        The fixed-sweep CCL certifies convergence, the root selection
        certifies completeness, and the blob band certifies that no in-band
        component was dropped; when any certificate fails the reference
        semantics (ITK: unbounded components, exact labels, cap-free blob
        list, Mamri.py:1306-1322) demand a stronger rerun, not a silent
        truncation. Each failing certificate is escalated independently (a
        maxed-out budget on one axis must not discard escalation still
        available on another). Returns None when nothing further can be done.

        With the `count_ok` sub-certificate given, root completeness is
        escalated TARGETED: a count overflow grows `max_roots` only, while a
        complete count whose blocked top_k overflowed a block switches to
        the exact flat selection (`exhaustive_roots`) only. Without it both
        grow."""
        new = params
        if not converged:
            if params.passes is not None:
                if params.passes < 512:
                    new = new._replace(passes=min(params.passes * 2, 512))
            elif params.max_sweeps < 256:
                new = new._replace(max_sweeps=min(params.max_sweeps * 2, 256))
        if not complete:
            if count_ok is not True and params.max_roots < 4096:
                new = new._replace(max_roots=min(max(params.max_roots * 8, 1024), 4096))
            if count_ok is not False and not params.exhaustive_roots:
                new = new._replace(exhaustive_roots=True)
        if not blobs_complete and params.max_blobs < 128:
            # the matchers scale to any K (C(K,3) vectorized scoring; the
            # global mode's blob sets are multi-word bitmasks), so the band
            # can grow until the scene is pathological beyond 128 fiducial-
            # sized components. The band is selected out of the root slots,
            # so it can never exceed max_roots (top_k k <= array length).
            new = new._replace(
                max_blobs=min(params.max_blobs * 2, 128, new.max_roots)
            )
        return None if new == params else new

    # ------------------------------------------------------------------ pose estimation
    def estimate_pose(
        self,
        volume: Volume,
        use_saved_baseplate: bool = False,
        apply_correction: bool = False,
        store_state: bool = True,
        keep_segmentation: bool = True,
    ) -> PoseEstimate:
        """The reference's `process()` (Mamri.py:850-880), one fused program.

        `keep_segmentation=False` skips fetching the body mask back to the
        host (streaming pose tracking doesn't re-plan every frame; the mask
        is the bulk of the per-frame transfer)."""
        saved = self.saved_baseplate if self.saved_baseplate is not None else np.eye(4, dtype=np.float32)
        args = (
            jnp.asarray(volume.data),
            jnp.asarray(volume.spacing),
            jnp.asarray(volume.origin),
            jnp.asarray(saved),
            jnp.asarray(use_saved_baseplate),
            jnp.asarray(self.saved_baseplate is not None),
            jnp.asarray(apply_correction),
            jnp.asarray(self.current_angles),
        )
        with self.tracer.span("estimate_pose"):
            params = self.seg_params
            while True:
                dev = self._get_pipeline(volume.shape, params)(*args)
                # ONE host sync per attempt: certificates + results fetch
                # together. The body mask only ships when the caller keeps
                # the segmentation, and only after certification settles.
                mask = dev.pop("body_mask")
                out = jax.device_get(dev)
                converged = bool(out["seg_converged"])
                complete = bool(out["roots_complete"])
                blobs_ok = bool(out["blobs_complete"])
                if converged and complete and blobs_ok:
                    break
                stronger = self._escalate_seg_params(
                    params, converged, complete, blobs_ok,
                    count_ok=bool(out["seg_count_ok"]),
                )
                if stronger is None:
                    logger.warning(
                        "segmentation uncertified at strongest settings "
                        "(converged=%s, roots_complete=%s, blobs_complete=%s, "
                        "num_components=%d)",
                        converged, complete, blobs_ok, int(out["num_components"]),
                    )
                    break
                logger.warning(
                    "segmentation escalation: converged=%s roots_complete=%s "
                    "blobs_complete=%s num_components=%d -> passes=%s "
                    "max_sweeps=%d max_roots=%d max_blobs=%d exhaustive=%s",
                    converged, complete, blobs_ok, int(out["num_components"]),
                    stronger.passes, stronger.max_sweeps, stronger.max_roots,
                    stronger.max_blobs, stronger.exhaustive_roots,
                )
                params = stronger
            if keep_segmentation:
                out["body_mask"] = jax.device_get(mask)
        return self._finish_estimate(out, volume, store_state, keep_segmentation)

    def estimate_pose_async(
        self,
        volume: Volume,
        use_saved_baseplate: bool = False,
        apply_correction: bool = False,
    ) -> dict:
        """Dispatch one pose estimation WITHOUT waiting for the result.

        Returns an opaque handle for `estimate_pose_collect`. Upload and
        compute of frame N overlap the host-side collection of frame N-1 —
        the streaming tracker's pipelined mode (`PoseTracker(pipelined=...)`)
        uses this to hide the H2D transfer and the result fetch behind
        device compute. IK warm-starts from `current_angles` AT DISPATCH
        TIME (one frame staler than the synchronous path)."""
        saved = self.saved_baseplate if self.saved_baseplate is not None else np.eye(4, dtype=np.float32)
        args = (
            jnp.asarray(volume.data),
            jnp.asarray(volume.spacing),
            jnp.asarray(volume.origin),
            jnp.asarray(saved),
            jnp.asarray(use_saved_baseplate),
            jnp.asarray(self.saved_baseplate is not None),
            jnp.asarray(apply_correction),
            jnp.asarray(self.current_angles),
        )
        dev = self._get_pipeline(volume.shape, self.seg_params)(*args)
        dev.pop("body_mask")  # streaming path: results only
        return {
            "dev": dev,
            "volume": volume,
            "use_saved": use_saved_baseplate,
            "correction": apply_correction,
        }

    def estimate_pose_collect(self, handle: dict, store_state: bool = True) -> PoseEstimate:
        """Fetch a dispatched estimation (one host sync). An uncertified
        segmentation falls back to the synchronous escalating path on the
        handle's stored volume (rare; certified scenes pay nothing)."""
        out = jax.device_get(handle["dev"])
        if not (
            bool(out["seg_converged"])
            and bool(out["roots_complete"])
            and bool(out["blobs_complete"])
        ):
            logger.warning("async estimation uncertified; re-running synchronously")
            return self.estimate_pose(
                handle["volume"],
                use_saved_baseplate=handle["use_saved"],
                apply_correction=handle["correction"],
                store_state=store_state,
                keep_segmentation=False,
            )
        return self._finish_estimate(out, handle["volume"], store_state, keep_segmentation=False)

    def _finish_estimate(
        self, out: dict, volume: Volume, store_state: bool, keep_segmentation: bool
    ) -> PoseEstimate:
        """Host-side tail of pose estimation: state updates + PoseEstimate
        construction from the fetched pipeline outputs."""
        markers_found = {ln: bool(f) for ln, f in zip(MARKER_LINKS, out["markers_found"])}
        source = ["none", "detected", "saved", "saved_fallback"][int(out["base_source"])]
        if store_state and keep_segmentation:
            self.last_segmentation = out
            self.last_volume_geom = (np.asarray(volume.spacing), np.asarray(volume.origin))
            self.last_collision_world = None  # rebuilt lazily from the new body
        if not bool(out["base_ok"]):
            logger.error("baseplate transform unavailable (not detected, no saved transform)")
            return PoseEstimate(
                success=False,
                markers_found=markers_found,
                num_blobs=int(out["num_blobs"]),
                message="Pose estimation failed: baseplate not detected and no saved transform.",
            )
        if store_state:
            self.baseplate_tf = np.asarray(out["base_tf"])
        if not markers_found["Joint6"]:
            logger.info("Joint6 markers not found; cannot estimate pose (Mamri.py:875)")
            return PoseEstimate(
                success=False,
                baseplate_tf=np.asarray(out["base_tf"]),
                baseplate_source=source,
                markers_found=markers_found,
                num_blobs=int(out["num_blobs"]),
                message="Joint6 markers not found.",
            )
        angles = np.asarray(out["angles"])
        if store_state:
            self.current_angles = angles.astype(np.float32)
            self.last_ik_error = float(out["rmse"])
            self.last_estimated_steps = np.asarray(out["steps"])
        return PoseEstimate(
            success=True,
            angles_rad=angles,
            steps=np.asarray(out["steps"]),
            rmse_mm=float(out["rmse"]),
            baseplate_tf=np.asarray(out["base_tf"]),
            baseplate_source=source,
            markers_found=markers_found,
            num_blobs=int(out["num_blobs"]),
        )

    def estimate_pose_batch(
        self,
        data_batch,
        spacing,
        origin,
        apply_correction: bool = False,
        donate: bool = True,
        microbatch: Optional[int] = None,
    ):
        """Batched pose estimation — vmapped fused pipeline, shardable over a
        device mesh (see mamri_tpu/parallel). Returns a dict of stacked
        per-volume outputs (host arrays once certified); no engine state is
        mutated.

        `microbatch` bounds the segmentation workspace: the jitted program
        processes the batch in `microbatch`-sized chunks via `lax.map`, so
        peak device memory is input batch + ONE chunk's segmentation
        workspace instead of the whole batch's. Must divide the batch size.

        Escalation is PER VOLUME: an uncertified segmentation re-runs only
        the failing volumes as a compacted sub-batch (padded to a power of
        two so recompiles stay bounded) at the escalated settings, and the
        results scatter back — one noisy scan costs escalated work for
        itself, not a stronger rerun of the whole batch."""
        params = self.seg_params
        data_np = np.asarray(data_batch)  # host copy: donation consumes the
        # device buffer and escalation reruns re-upload only the failing rows
        if microbatch is not None and data_np.shape[0] % microbatch:
            raise ValueError(
                f"microbatch {microbatch} must divide batch {data_np.shape[0]}"
            )
        fn = self._get_batch_pipeline(
            tuple(data_np.shape[1:]), params, donate, microbatch
        )
        out = fn(
            jnp.asarray(data_np),
            jnp.asarray(spacing),
            jnp.asarray(origin),
            jnp.asarray(apply_correction),
        )
        out.pop("body_mask", None)  # don't ship B full masks back by default
        # np.array (copy): device_get views are read-only, and the escalation
        # loop scatters sub-batch results back in place
        out = {k: np.array(v) for k, v in jax.device_get(out).items()}
        certified = out["seg_converged"] & out["roots_complete"] & out["blobs_complete"]
        while not certified.all():
            fail = np.nonzero(~certified)[0]
            stronger = self._escalate_seg_params(
                params,
                bool(out["seg_converged"][fail].all()),
                bool(out["roots_complete"][fail].all()),
                bool(out["blobs_complete"][fail].all()),
                count_ok=bool(out["seg_count_ok"][fail].all()),
            )
            if stronger is None:
                logger.warning(
                    "batched segmentation uncertified at strongest settings "
                    "for volumes %s", fail.tolist(),
                )
                break
            # compact the failing volumes; pad to the next power of two with
            # repeats of the first failure (bounded compile-shape set)
            n_pad = 1 << max(len(fail) - 1, 0).bit_length() if len(fail) > 1 else 1
            sel = np.concatenate([fail, np.full(n_pad - len(fail), fail[0], fail.dtype)])
            logger.warning(
                "batched segmentation escalation for %d/%d volumes -> "
                "passes=%s max_sweeps=%d max_roots=%d max_blobs=%d exhaustive=%s",
                len(fail), data_np.shape[0], stronger.passes, stronger.max_sweeps,
                stronger.max_roots, stronger.max_blobs, stronger.exhaustive_roots,
            )
            # escalation sub-batches are small (compacted failures): no chunking
            fn = self._get_batch_pipeline(tuple(data_np.shape[1:]), stronger, donate, None)
            sub = fn(
                jnp.asarray(data_np[sel]),
                jnp.asarray(spacing),
                jnp.asarray(origin),
                jnp.asarray(apply_correction),
            )
            sub.pop("body_mask", None)
            sub = {k: np.asarray(v) for k, v in jax.device_get(sub).items()}
            for k, v in out.items():
                v[fail] = sub[k][: len(fail)]
            certified[fail] = (
                sub["seg_converged"] & sub["roots_complete"] & sub["blobs_complete"]
            )[: len(fail)]
            params = stronger
        return out

    def _get_batch_pipeline(
        self,
        vol_shape,
        params: SegmentationParams,
        donate: bool,
        microbatch: Optional[int] = None,
    ):
        key = ("batch", vol_shape, params, donate, microbatch)

        def build():
            pipeline = self.pipeline_fn(params)

            def one(data, spacing, origin, apply_correction):
                out = pipeline(
                    data,
                    spacing,
                    origin,
                    jnp.eye(4, dtype=jnp.float32),
                    jnp.asarray(False),
                    jnp.asarray(False),
                    apply_correction,
                    jnp.zeros(self.model.num_joints, dtype=jnp.float32),
                )
                if microbatch is not None:
                    # chunked path: per-volume results only (a stacked batch
                    # of full masks would defeat the workspace bound)
                    out.pop("body_mask")
                return out

            if microbatch is None:
                batched = jax.vmap(one, in_axes=(0, None, None, None))
            else:
                def batched(data, spacing, origin, apply_correction):
                    b = data.shape[0]
                    chunks = data.reshape((b // microbatch, microbatch) + data.shape[1:])
                    out = jax.lax.map(
                        lambda d: jax.vmap(one, in_axes=(0, None, None, None))(
                            d, spacing, origin, apply_correction
                        ),
                        chunks,
                    )
                    return jax.tree.map(
                        lambda x: x.reshape((b,) + x.shape[2:]), out
                    )

            kw = {"donate_argnums": (0,)} if donate else {}
            return jax.jit(batched, **kw)

        return self._batch_cache.get_or_set(key, build)

    # ------------------------------------------------------------------ baseplate persistence
    def save_baseplate(self, path: Optional[str] = None) -> np.ndarray:
        """Persist the current baseplate transform (reference:
        `saveBaseplateTransform`, Mamri.py:1035-1043)."""
        if self.baseplate_tf is None:
            raise RuntimeError("no baseplate transform yet; run estimate_pose first")
        self.saved_baseplate = np.asarray(self.baseplate_tf).copy()
        if path is not None:
            np.savez(path, baseplate_tf=self.saved_baseplate)
        return self.saved_baseplate

    def load_baseplate(self, path: str) -> np.ndarray:
        with np.load(path) as f:
            self.saved_baseplate = np.asarray(f["baseplate_tf"], dtype=np.float32)
        return self.saved_baseplate

    # ------------------------------------------------------------------ scene state
    def set_pose(self, angles_rad) -> None:
        """`setRobotPose` (Mamri.py:1473-1484) minus the scene graph."""
        angles = np.asarray(angles_rad, dtype=np.float32).reshape(-1)
        if angles.shape[0] != self.model.num_joints:
            raise ValueError(f"expected {self.model.num_joints} angles, got {angles.shape[0]}")
        self.current_angles = angles

    def get_current_joint_angles(self) -> np.ndarray:
        return self.current_angles.copy()

    def zero_robot(self) -> None:
        self.current_angles = np.zeros_like(self.current_angles)

    def link_world_transforms(self, angles_rad=None) -> np.ndarray:
        base = self.baseplate_tf if self.baseplate_tf is not None else np.eye(4, dtype=np.float32)
        a = self.current_angles if angles_rad is None else np.asarray(angles_rad, dtype=np.float32)
        return np.asarray(fk_all_links(self.model, jnp.asarray(a), jnp.asarray(base)))

    def needle_tcp(self, angles_rad=None) -> np.ndarray:
        """World transform of the needle TCP (live-status display path,
        Mamri.py:600-618)."""
        return self.link_world_transforms(angles_rad)[self.model.link_index("Needle")]

    def export_posed_meshes(self, out_dir: str, mesh_dir: str, angles_rad=None) -> list:
        """Write the robot's visual meshes FK-posed at the current (or given)
        angles as binary STLs — the headless counterpart of the reference's
        3D scene rendering (`_build_robot_model`, Mamri.py:1449-1471).
        Returns the written paths. Missing mesh files are skipped (the
        reference skips the stripped Needle.STL the same way, Mamri.py:1454).
        """
        from mamri_tpu.utils.stl import load_stl, save_stl, transform_triangles

        os.makedirs(out_dir, exist_ok=True)
        tfs = self.link_world_transforms(angles_rad)
        written = []
        for i, spec in enumerate(self.model.specs):
            if not spec.visual_mesh:
                continue
            src = os.path.join(mesh_dir, spec.visual_mesh)
            if not os.path.exists(src):
                logger.info("skipping missing mesh %s", src)
                continue
            tris = transform_triangles(load_stl(src), tfs[i])
            dst = os.path.join(out_dir, f"{spec.name}_posed.stl")
            save_stl(dst, tris)
            written.append(dst)
        return written

    def _scene_objects(
        self,
        mesh_dir: Optional[str] = None,
        angles_rad=None,
        include_body: bool = True,
        include_trajectory: bool = True,
        target_ras=None,
        entry_ras=None,
        needle_length_mm: float = 100.0,
        needle_radius_mm: float = 1.5,
        body_surface: str = "voxel",
    ):
        """Assemble the 3-D scene as (named triangle soups, named polylines):
        FK-posed robot links (STL when `mesh_dir` is given, procedural
        capsules otherwise), a generated needle cylinder, the segmented body
        surface, the planned path as the needle-tip polyline, and the
        entry->target insertion segment (`_build_robot_model`
        Mamri/Mamri.py:1449-1471, trajectory markup :1924-1935).

        `body_surface`: "voxel" = exact exposed-face geometry (default);
        "smooth" = marching-tetrahedra mesh, visually closer to the
        reference's closed-surface representation."""
        from mamri_tpu.planning.geometry import DEFAULT_PART_RADIUS_MM, MIN_PART_LENGTH_MM
        from mamri_tpu.utils.scene import (
            capsule_mesh,
            cylinder_mesh,
            marching_tetrahedra_mesh,
            voxel_surface_mesh,
        )
        from mamri_tpu.utils.stl import load_stl, transform_triangles

        tfs = self.link_world_transforms(angles_rad)
        objects = []
        for i, spec in enumerate(self.model.specs):
            if spec.name == "Needle":
                continue  # generated cylinder below (reference's Needle.STL is stripped)
            tris = None
            if mesh_dir is not None and spec.visual_mesh:
                src = os.path.join(mesh_dir, spec.visual_mesh)
                if os.path.exists(src):
                    tris = load_stl(src)
            if tris is None:
                child = next((s for s in self.model.specs if s.parent == i), None)
                length = float(np.linalg.norm(child.offset_mm)) if child is not None else 0.0
                tris = capsule_mesh(max(length, MIN_PART_LENGTH_MM), DEFAULT_PART_RADIUS_MM)
            objects.append((spec.name, transform_triangles(tris, tfs[i])))

        # needle shaft from the config's tip/axis on the Needle link frame
        ntf = tfs[self.model.link_index("Needle")]
        tip = (ntf[:3, :3] @ np.asarray(self.model.needle_tip)) + ntf[:3, 3]
        axis = ntf[:3, :3] @ np.asarray(self.model.needle_axis)
        axis = axis / max(float(np.linalg.norm(axis)), 1e-9)
        objects.append(("Needle", cylinder_mesh(tip, tip + axis * needle_length_mm, needle_radius_mm)))

        if include_body and self.last_segmentation is not None and bool(self.last_segmentation["body_found"]):
            spacing, origin = self.last_volume_geom
            surface_fn = marching_tetrahedra_mesh if body_surface == "smooth" else voxel_surface_mesh
            objects.append(
                ("Body", surface_fn(self.last_segmentation["body_mask"], spacing, origin))
            )

        polylines = []
        if include_trajectory and self.trajectory_path is not None:
            needle_idx = self.model.link_index("Needle")
            tip_local = jnp.asarray(self.model.needle_tip)
            base = jnp.asarray(
                self.baseplate_tf if self.baseplate_tf is not None else np.eye(4, dtype=np.float32)
            )

            def tip_at(a):
                tf = fk_all_links(self.model, a, base)[needle_idx]
                return transforms.apply(tf, tip_local[None])[0]

            tips = np.asarray(jax.vmap(tip_at)(jnp.asarray(self.trajectory_path, dtype=jnp.float32)))
            polylines.append(("TrajectoryTipPath", tips))
        if target_ras is not None and entry_ras is not None:
            polylines.append(
                ("InsertionSegment", np.stack([np.asarray(entry_ras), np.asarray(target_ras)]).astype(np.float32))
            )
        return objects, polylines

    def export_scene(self, path: str, **scene_kw) -> dict:
        """Write the assembled 3-D scene (see `_scene_objects`) as one file —
        Wavefront OBJ, binary glTF when `path` ends in `.glb`, or a
        self-contained interactive WebGL viewer when it ends in `.html`
        (orbit/zoom/pan in any browser, no dependencies — the headless
        equivalent of the reference's Slicer 3-D viewport). Returns
        {object name: triangle/segment count}."""
        from mamri_tpu.utils.glb import write_glb
        from mamri_tpu.utils.html_viewer import write_html_scene
        from mamri_tpu.utils.scene import write_obj

        objects, polylines = self._scene_objects(**scene_kw)
        lower = path.lower()
        if lower.endswith(".glb"):
            writer = write_glb
        elif lower.endswith((".html", ".htm")):
            writer = write_html_scene
        else:
            writer = write_obj
        writer(path, objects, polylines)
        summary = {name: int(len(t)) for name, t in objects}
        summary.update({name: int(len(p)) for name, p in polylines})
        return summary

    def export_trajectory_html(
        self,
        path: str,
        mesh_dir: Optional[str] = None,
        target_ras=None,
        entry_ras=None,
        needle_length_mm: float = 100.0,
        needle_radius_mm: float = 1.5,
        body_surface: str = "voxel",
        interval_ms: int = 50,
    ) -> dict:
        """Write an ANIMATED interactive scene: the planned trajectory plays
        through the posed robot with a frame slider + play/pause at the
        reference's 50 ms tick (the Trajectory Simulation panel,
        Mamri/Mamri.py:287-317, in one self-contained offline HTML file).
        Link meshes are embedded once in link-local frames; per-frame rigid
        transforms come from the vmapped FK over `trajectory_path`."""
        from mamri_tpu.planning.geometry import DEFAULT_PART_RADIUS_MM, MIN_PART_LENGTH_MM
        from mamri_tpu.utils.html_viewer import write_html_scene
        from mamri_tpu.utils.scene import (
            capsule_mesh,
            cylinder_mesh,
            marching_tetrahedra_mesh,
            voxel_surface_mesh,
        )
        from mamri_tpu.utils.stl import load_stl

        if self.trajectory_path is None:
            raise RuntimeError("no trajectory planned; run plan_heuristic_path first")
        base = jnp.asarray(
            self.baseplate_tf if self.baseplate_tf is not None else np.eye(4, dtype=np.float32)
        )
        path_angles = jnp.asarray(self.trajectory_path, dtype=jnp.float32)
        tfs = np.asarray(
            jax.vmap(lambda a: fk_all_links(self.model, a, base))(path_angles)
        )  # (S, L, 4, 4)

        objects = []
        for i, spec in enumerate(self.model.specs):
            if spec.name == "Needle":
                continue
            tris = None
            if mesh_dir is not None and spec.visual_mesh:
                src = os.path.join(mesh_dir, spec.visual_mesh)
                if os.path.exists(src):
                    tris = load_stl(src)
            if tris is None:
                child = next((s for s in self.model.specs if s.parent == i), None)
                length = float(np.linalg.norm(child.offset_mm)) if child is not None else 0.0
                tris = capsule_mesh(max(length, MIN_PART_LENGTH_MM), DEFAULT_PART_RADIUS_MM)
            objects.append((spec.name, tris, i))
        # needle shaft in the Needle link's local frame
        nidx = self.model.link_index("Needle")
        tip = np.asarray(self.model.needle_tip, dtype=np.float64)
        axis = np.asarray(self.model.needle_axis, dtype=np.float64)
        axis = axis / max(float(np.linalg.norm(axis)), 1e-9)
        objects.append(
            ("Needle", cylinder_mesh(tip, tip + axis * needle_length_mm, needle_radius_mm), nidx)
        )
        if self.last_segmentation is not None and bool(self.last_segmentation["body_found"]):
            spacing, origin = self.last_volume_geom
            surface_fn = marching_tetrahedra_mesh if body_surface == "smooth" else voxel_surface_mesh
            objects.append(("Body", surface_fn(self.last_segmentation["body_mask"], spacing, origin)))

        tip_local = jnp.asarray(self.model.needle_tip)

        def tip_at(a):
            tf = fk_all_links(self.model, a, base)[nidx]
            return transforms.apply(tf, tip_local[None])[0]

        tips = np.asarray(jax.vmap(tip_at)(path_angles))
        polylines = [("TrajectoryTipPath", tips)]
        if target_ras is not None and entry_ras is not None:
            polylines.append(
                ("InsertionSegment", np.stack([np.asarray(entry_ras), np.asarray(target_ras)]).astype(np.float32))
            )
        write_html_scene(
            path, objects, polylines,
            anim={"transforms": tfs, "interval_ms": interval_ms},
            title="mamri trajectory simulation",
        )
        summary = {name: int(len(t)) for name, t, *_ in objects}
        summary["frames"] = int(tfs.shape[0])
        return summary

    def render_scene(
        self,
        path: str,
        mesh_dir: Optional[str] = None,
        angles_rad=None,
        width: int = 960,
        height: int = 720,
        azim_deg: float = 35.0,
        elev_deg: float = 22.0,
        target_ras=None,
        entry_ras=None,
        body_surface: str = "voxel",
    ) -> Tuple[int, int]:
        """Render the assembled scene to a PNG via the built-in software
        rasterizer (utils/render.py) — the headless counterpart of looking at
        the reference's Slicer 3-D viewport. Same scene contents as
        `export_scene`. Returns the (width, height) written."""
        from mamri_tpu.utils.render import rasterize, write_png

        objects, polylines = self._scene_objects(
            mesh_dir=mesh_dir,
            angles_rad=angles_rad,
            target_ras=target_ras,
            entry_ras=entry_ras,
            body_surface=body_surface,
        )
        img = rasterize(
            objects, polylines, width=width, height=height,
            azim_deg=azim_deg, elev_deg=elev_deg,
        )
        write_png(path, img)
        return (width, height)

    def target_in_base_frame(self, target_ras) -> np.ndarray:
        """Re-express a world RAS point in the robot base frame — the widget's
        target-coordinate readout (Mamri.py:752-799)."""
        if self.baseplate_tf is None:
            raise RuntimeError("robot base unknown; run estimate_pose first")
        inv = np.linalg.inv(np.asarray(self.baseplate_tf, dtype=np.float64))
        p = np.append(np.asarray(target_ras, dtype=np.float64), 1.0)
        return (inv @ p)[:3].astype(np.float32)

    def body_mask(self) -> Optional[np.ndarray]:
        """Voxel body mask from the last segmentation (the reference's
        `_get_body_polydata` access path, Mamri.py:1794-1814)."""
        if self.last_segmentation is None or not bool(self.last_segmentation["body_found"]):
            return None
        return np.asarray(self.last_segmentation["body_mask"])

    def export_segmentation(self, path: str) -> str:
        """Write the last run's body segmentation as a Slicer-loadable
        `.seg.nrrd` segmentation node — the file counterpart of the
        reference's in-scene "AutoBodySegmentation" node with its "Body"
        segment (Mamri.py:1322-1341, consumed by `_get_body_polydata`
        :1794-1814). Requires a prior estimate with a body found."""
        mask = self.body_mask()
        if mask is None:
            raise RuntimeError("no body segmentation available; run estimate_pose first")
        from mamri_tpu.perception.formats import save_seg_nrrd

        spacing, origin = self.last_volume_geom
        save_seg_nrrd(path, {"Body": mask.astype(bool)}, spacing, origin)
        return path

    def set_body_segmentation(self, source, spacing=None, origin=None, segment: str = "Body"):
        """Override the body mask used by entry search / collision checking.

        The reference's operator can EDIT the scene segmentation between
        `process()` and planning (planning always re-reads the node named
        "Body", Mamri.py:1794-1814); this is the standalone counterpart.
        `source` is a `.seg.nrrd` path (the `segment`-named segment is
        taken, or the only one) or a bool (nx, ny, nz) mask with explicit
        `spacing`/`origin`. Invalidates the cached collision world."""
        if isinstance(source, (str, os.PathLike)):
            from mamri_tpu.perception.formats import load_seg_nrrd

            segments, labelmap = load_seg_nrrd(os.fspath(source))
            if segment in segments:
                mask = segments[segment]
            elif len(segments) == 1:
                mask = next(iter(segments.values()))
            else:
                raise ValueError(
                    f"{source}: no segment named {segment!r} among {sorted(segments)}"
                )
            spacing, origin = labelmap.spacing, labelmap.origin
        else:
            if spacing is None or origin is None:
                raise ValueError("a raw mask needs explicit spacing and origin")
            mask = np.asarray(source, dtype=bool)
        if mask.ndim != 3 or not mask.any():
            raise ValueError("body mask must be a non-empty 3-D boolean volume")
        seg = dict(self.last_segmentation) if self.last_segmentation is not None else {}
        seg["body_mask"] = np.asarray(mask, dtype=bool)
        seg["body_found"] = True
        self.last_segmentation = seg
        self.last_volume_geom = (
            np.asarray(spacing, dtype=np.float32),
            np.asarray(origin, dtype=np.float32),
        )
        self.last_collision_world = None

    # ------------------------------------------------------------------ conversions
    def convert_angles_to_steps(self, angles_rad) -> np.ndarray:
        # Host twin: this runs on every executor control tick, which should
        # not dispatch to the device.
        return angles_to_steps_host(angles_rad, self.model.steps_per_rev)

    def convert_steps_to_angles(self, steps) -> np.ndarray:
        return steps_to_angles_host(steps, self.model.steps_per_rev)

    # ------------------------------------------------------------------ planning
    def _require_body_world(self):
        if self.last_collision_world is not None:
            return self.last_collision_world
        if self.last_segmentation is None or not bool(self.last_segmentation["body_found"]):
            return None
        spacing, origin = self.last_volume_geom
        with self.tracer.span("build_collision_world"):
            self.last_collision_world = build_collision_world(
                jnp.asarray(self.last_segmentation["body_mask"]), spacing, origin
            )
        return self.last_collision_world

    def find_entry_point(self, target_ras) -> EntryPointResult:
        """`findAndSetEntryPoint` (Mamri.py:987-1033) on the voxel surface."""
        if self.last_segmentation is None or not bool(self.last_segmentation["body_found"]):
            raise RuntimeError("no body segmentation available; run estimate_pose first")
        spacing, origin = self.last_volume_geom
        with self.tracer.span("find_entry_point"):
            res = find_entry_point(
                jnp.asarray(self.last_segmentation["body_mask"]), spacing, origin, jnp.asarray(target_ras)
            )
        return jax.device_get(res)

    def _get_plan_fn(self, world_shape, mode: str, n: int = 0):
        """jit-cached planning programs, keyed by collision-world shape:
        "goal" = trajectory IK; "sweep" = vmapped IK over n safety
        distances; "path" = IK + up-over-down keyframes + 25/25/50
        interpolation + whole-path collision sweep, all ONE program (the
        re-plan step of streaming runs at jitted cost instead of eager
        per-op dispatch)."""
        key = ("plan", mode, world_shape, n)  # world_shape None <=> no world

        def build():
            model, geometry = self.model, self.geometry

            def goal_fn(target, entry, safety, base_tf, current, world):
                return solve_trajectory_ik(
                    model, geometry, target, entry, safety, base_tf, world,
                    current_angles=current,
                )

            if mode == "goal":
                def fn(target, entry, safety, base_tf, start, current, world=None):
                    return goal_fn(target, entry, safety, base_tf, current, world)
            elif mode == "sweep":
                def fn(target, entry, safeties, base_tf, start, current, world=None):
                    return jax.vmap(
                        lambda d: goal_fn(target, entry, d, base_tf, current, world)
                    )(safeties)
            else:  # "path"; n = total interpolation steps (static)
                def fn(target, entry, safety, base_tf, start, current, world=None):
                    goal = goal_fn(target, entry, safety, base_tf, current, world)
                    kf = heuristic_keyframes(start, goal.angles)
                    path = interpolate_path(kf, n)
                    if world is not None:
                        flags = check_path_collisions(model, geometry, path, base_tf, world)
                    else:
                        flags = jnp.zeros(path.shape[0], dtype=bool)
                    return {"goal": goal, "keyframes": kf, "path": path, "flags": flags}

            return jax.jit(fn)

        return self._plan_cache.get_or_set(key, build)

    def _plan_args(self, target_ras, entry_ras, safety, start=None):
        if self.baseplate_tf is None:
            raise RuntimeError("robot base unknown; run estimate_pose first")
        world = self._require_body_world()
        world_shape = tuple(world.occupancy.shape) if world is not None else None
        return (
            jnp.asarray(target_ras, dtype=jnp.float32),
            jnp.asarray(entry_ras, dtype=jnp.float32),
            jnp.asarray(safety, dtype=jnp.float32),
            jnp.asarray(self.baseplate_tf),
            jnp.asarray(self.current_angles if start is None else start, dtype=jnp.float32),
            jnp.asarray(self.current_angles),
        ), world, world_shape

    def plan_trajectory(self, target_ras, entry_ras, safety_distance_mm: float = DEFAULT_SAFETY_DISTANCE_MM):
        """`planTrajectory` (Mamri.py:882-939): collision-aware goal IK."""
        args, world, wshape = self._plan_args(target_ras, entry_ras, safety_distance_mm)
        with self.tracer.span("plan_trajectory"):
            fn = self._get_plan_fn(wshape, "goal")
            res = fn(*args, world=world) if world is not None else fn(*args)
        return jax.device_get(res)

    def plan_trajectory_sweep(self, target_ras, entry_ras, safety_distances_mm):
        """Solve the trajectory goal IK for several safety distances at once
        (BASELINE config 4's sweep) — one vmapped solve instead of a loop."""
        distances = np.asarray(safety_distances_mm, dtype=np.float32)
        args, world, wshape = self._plan_args(target_ras, entry_ras, distances)
        with self.tracer.span("plan_trajectory_sweep"):
            fn = self._get_plan_fn(wshape, "sweep", n=len(distances))
            out = fn(*args, world=world) if world is not None else fn(*args)
        return jax.device_get(out)

    def plan_heuristic_path(
        self,
        target_ras,
        entry_ras,
        safety_distance_mm: float = DEFAULT_SAFETY_DISTANCE_MM,
        start_pose_steps=None,
        total_steps: int = 100,
    ) -> TrajectoryPlan:
        """`planHeuristicPath` (Mamri.py:941-985): up-over-down keyframes,
        25/25/50 interpolation, whole-path collision check — goal IK, path,
        and the collision sweep fused into ONE jitted program (cached per
        collision-world shape), with one host fetch."""
        if start_pose_steps is not None:
            start = self.convert_steps_to_angles(np.asarray(start_pose_steps))
        else:
            start = self.current_angles
            logger.warning("no estimated start pose provided; planning from current pose")
        args, world, wshape = self._plan_args(
            target_ras, entry_ras, safety_distance_mm, start=start
        )
        with self.tracer.span("plan_heuristic_path"):
            fn = self._get_plan_fn(wshape, "path", n=total_steps)
            out = jax.device_get(fn(*args, world=world) if world is not None else fn(*args))
        goal = out["goal"]
        if not bool(goal.success):
            return TrajectoryPlan(success=False, message="Could not find a valid, collision-free trajectory solution.")
        if world is None:
            logger.warning("no body segmentation for path collision checking")
        collision = bool(np.asarray(out["flags"]).any())
        plan = TrajectoryPlan(
            success=True,
            path=np.asarray(out["path"]),
            keyframes=np.asarray(out["keyframes"]),
            collision_detected=collision,
            goal_angles=np.asarray(goal.angles),
            goal_steps=self.convert_angles_to_steps(np.asarray(goal.angles)),
            position_error_mm=float(goal.position_error_mm),
        )
        if collision:
            plan.message = "Warning: the generated path results in a collision."
            logger.warning(plan.message)
        self.trajectory_path = plan.path
        self.trajectory_keyframes = plan.keyframes
        return plan

    def validate_plan_exact(self, plan=None, max_edge_mm: float = 1.0) -> dict:
        """Triangle-exact host validation of a final plan — the fidelity of
        the reference's vtkCollisionDetectionFilter check (Mamri.py:1555-1575).

        The on-device path check is conservatively voxelized (dilated
        occupancy + sparse part sampling): it never calls a colliding path
        free, but can over-reject tight-but-legal trajectories. This
        validator densifies the part hulls to sub-voxel point grids (STL
        triangles when the engine has a `mesh_dir`, dense capsules
        otherwise) and tests every path sample against the UNDILATED body
        voxels. Returns the exact per-sample contact profile plus
        `over_conservative`: True when the fast checker flagged a collision
        the exact check clears — such a plan may be re-qualified by the
        operator. Runs once per accepted plan (host numpy), not in the
        planning hot loop.
        """
        from mamri_tpu.planning.exact import build_exact_parts, validate_path_exact

        if plan is None:
            path = self.trajectory_path
        else:
            path = plan.path
        if path is None:
            raise RuntimeError("no planned path to validate; run plan_heuristic_path first")
        if self.last_segmentation is None or not bool(self.last_segmentation["body_found"]):
            raise RuntimeError("no body segmentation available; run estimate_pose first")
        if self.baseplate_tf is None:
            raise RuntimeError("robot base unknown; run estimate_pose first")
        if self._exact_parts is None or self._exact_parts.max_edge_mm != max_edge_mm:
            self._exact_parts = build_exact_parts(
                self.model, mesh_dir=self.mesh_dir, max_edge_mm=max_edge_mm
            )
        spacing, origin = self.last_volume_geom
        with self.tracer.span("validate_plan_exact"):
            out = validate_path_exact(
                self.model,
                self._exact_parts,
                np.asarray(self.last_segmentation["body_mask"]),
                spacing,
                origin,
                self.baseplate_tf,
                path,
            )
        fast_flagged = bool(plan.collision_detected) if plan is not None else None
        out["fast_checker_flagged"] = fast_flagged
        out["over_conservative"] = (
            bool(fast_flagged and out["collision_free"]) if fast_flagged is not None else None
        )
        return out

    # ------------------------------------------------------------------ state persistence
    def save_state(self, path: str) -> None:
        """Checkpoint the engine scene state (baseplate + pose + saved node)."""
        arrays = {"current_angles": self.current_angles}
        meta = {"has_baseplate": self.baseplate_tf is not None, "has_saved": self.saved_baseplate is not None}
        if self.baseplate_tf is not None:
            arrays["baseplate_tf"] = self.baseplate_tf
        if self.saved_baseplate is not None:
            arrays["saved_baseplate"] = self.saved_baseplate
        np.savez(path, **arrays)
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    def load_state(self, path: str) -> None:
        with np.load(path) as f:
            self.current_angles = np.asarray(f["current_angles"], dtype=np.float32)
            if "baseplate_tf" in f:
                self.baseplate_tf = np.asarray(f["baseplate_tf"], dtype=np.float32)
            if "saved_baseplate" in f:
                self.saved_baseplate = np.asarray(f["saved_baseplate"], dtype=np.float32)

    # ------------------------------------------------------------------ observability
    def describe_ik_solution(self, joint6_targets, joint4_targets=None, apply_correction: bool = False) -> str:
        """Per-marker predicted-vs-target report at the current pose — the
        reference's `_log_ik_solution_details` (Mamri.py:1836-1870)."""
        if self.baseplate_tf is None:
            return "no baseplate transform; run estimate_pose first"
        lines = ["--- IK Solution Details ---"]
        for name, angle in zip(self.model.articulated_names, np.rad2deg(self.current_angles)):
            lines.append(f"  - {name}: {angle:.2f} deg")
        if self.last_ik_error is not None:
            lines.append(f"RMSE: {self.last_ik_error:.4f} mm")
        tfs = self.link_world_transforms()

        def compare(link_name, targets, corrected):
            idx = self.model.link_index(link_name)
            local = np.asarray(self.model.marker_local[idx])
            if corrected:
                local = local * np.array([-1.0, -1.0, 1.0], dtype=np.float32)
            pred = np.asarray(
                transforms.apply(jnp.asarray(tfs[idx]), jnp.asarray(local))
            )
            lines.append(f"--- Comparison for {link_name} markers ---")
            for i, (p, t) in enumerate(zip(pred, np.asarray(targets))):
                err = float(np.linalg.norm(p - t))
                lines.append(
                    f"  M{i+1}: target ({t[0]:.2f}, {t[1]:.2f}, {t[2]:.2f})  "
                    f"predicted ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f})  err {err:.3f} mm"
                )

        compare("Joint6", joint6_targets, apply_correction)
        if joint4_targets is not None:
            compare("Joint4", joint4_targets, False)
        return "\n".join(lines)

    # ------------------------------------------------------------------ action gating / tables
    def available_actions(
        self,
        have_volume: bool = False,
        have_target: bool = False,
        have_entry: bool = False,
    ) -> Dict[str, ActionState]:
        """The reference's button-gating state machine, headless
        (`_checkAllButtons`, Mamri.py:650-701): one `ActionState` per
        user-facing action, with the reference's tooltip text as the reason.

        Selections the reference reads off its parameter node (input volume,
        target/entry fiducials) are not engine state here — pass what the
        caller currently holds via `have_volume`/`have_target`/`have_entry`;
        everything else (model built, trajectory planned, connections, task
        activity) is read from the engine and attached hardware."""
        model_built = self.baseplate_tf is not None
        planned = self.trajectory_path is not None
        hw = self.hardware
        mc = hw is not None and hw.controller.is_connected
        enc = hw is not None and hw.encoder.is_connected
        executing = hw is not None and hw.runner.is_active

        def state(enabled, on, off):
            return ActionState(bool(enabled), on if enabled else off)

        idle = state(not executing, "Ready.", "A robot task is executing.")
        return {
            "estimate_pose": state(
                have_volume,
                "Run fiducial detection and robot model rendering.",
                "Select an input volume.",
            ),
            "plan_trajectory": state(
                have_target and have_entry and model_built,
                "Plan a collision-aware trajectory.",
                "Needs a target point, an entry point, and a pose estimate.",
            ),
            "zero_robot": state(
                model_built,
                "Sets all robot joint angles to zero in the simulation only.",
                "Run 'Start robot pose estimation' first to build the model.",
            ),
            "playback": state(
                planned, "Scrub / play the planned trajectory.", "No trajectory planned."
            ),
            "connect_controller": idle,
            "refresh_ports": idle,
            "connect_encoder": idle,
            "execute_trajectory": state(
                mc and self.trajectory_keyframes is not None and not executing,
                "Execute the planned trajectory on hardware.",
                "Connect the motor controller, plan a trajectory, and stop any running task.",
            ),
            "stop_trajectory": state(
                executing, "Stop the running robot task.", "No robot task is executing."
            ),
            "return_to_zero": state(
                mc and not executing,
                "Home all joints to zero.",
                "Connect the motor controller and stop any running task.",
            ),
            "move_to_pose": state(
                mc and not executing and self.last_estimated_steps is not None,
                "Move the robot to the last estimated pose.",
                "Needs a connected motor controller, no running task, and a pose estimate.",
            ),
            "manual_control": state(
                mc and not executing,
                "Jog individual joints.",
                "Connect the motor controller and stop any running task.",
            ),
            "zero_hardware": state(
                mc and enc and not executing,
                "Zero the encoder and motor controller hardware.",
                "Connect both encoder and motor controller to enable.",
            ),
            "encoder_command": state(
                enc and not executing,
                "Sends a manual command to the encoder.",
                "Connect to the encoder and stop any running tasks to enable.",
            ),
        }

    def pose_table(self, pose_rad=None, title: str = "Pose") -> list:
        """Rows of the reference's pose tables (`_populatePoseTable`,
        Mamri.py:704-722): (joint, steps, degrees) per articulated joint,
        with the reference's "..." placeholders when no pose is given.
        Header row first; steps as str(int), degrees formatted %.2f."""
        names = self.model.articulated_names
        rows = [(title, "Steps", "Degrees (°)")]
        if pose_rad is None:
            rows += [(n, "...", "...") for n in names]
            return rows
        pose = np.asarray(pose_rad, dtype=np.float64)
        steps = self.convert_angles_to_steps(pose)
        rows += [
            (n, str(int(s)), f"{math.degrees(a):.2f}")
            for n, s, a in zip(names, steps, pose)
        ]
        return rows

    def playback(self, path=None, on_pose=None):
        """Trajectory playback cursor (widget simulation panel equivalent)."""
        from mamri_tpu.api.playback import TrajectoryPlayback

        p = path if path is not None else self.trajectory_path
        if p is None:
            raise RuntimeError("no trajectory planned; run plan_heuristic_path first")
        return TrajectoryPlayback(p, on_pose=on_pose or self.set_pose)

    # ------------------------------------------------------------------ hardware
    @staticmethod
    def available_serial_ports():
        from mamri_tpu.hw.transport import list_serial_ports

        return list_serial_ports()

    def attach_hardware(self, controller_transport, encoder_transport):
        """Bind the serial (or simulated) links and build the executor stack."""
        import time as _time

        from mamri_tpu.hw.devices import EncoderLink, MotorControllerLink
        from mamri_tpu.hw.executor import RobotTaskRunner
        from mamri_tpu.hw.stream import PoseStream
        from mamri_tpu.hw.sync import SyncMonitor

        controller = MotorControllerLink(controller_transport, motor_letters=self.model.motor_letters)
        encoder = EncoderLink(encoder_transport, num_joints=self.model.num_joints)
        if not controller.handshake():
            raise RuntimeError("motor controller handshake failed")
        if not encoder.handshake():
            controller.disconnect()
            raise RuntimeError("encoder handshake failed")

        stream = PoseStream()
        runner = RobotTaskRunner(
            controller,
            encoder,
            angles_to_steps=lambda a: self.convert_angles_to_steps(np.asarray(a)),
        )

        # Live execution mirror (reference: encoder -> 3-D scene each 150 ms
        # tick, Mamri.py:537; status refresh at 4 Hz, :582-648): every
        # control tick updates the engine pose AND publishes one stream
        # frame for /watch, `hw --watch`, and user subscribers.
        def pose_cb(steps):
            angles = self.convert_steps_to_angles(np.asarray(steps))
            self.set_pose(angles)
            frame = {
                "event": "pose",
                "t": _time.time(),
                "steps": [int(s) for s in np.asarray(steps)],
                "angles_deg": np.rad2deg(angles).round(3).tolist(),
            }
            st = runner.state
            if st is not None:
                frame["mode"] = st.mode
                frame["target_steps"] = [int(s) for s in st.target_steps]
                if st.keyframes is not None:
                    frame["keyframe_index"] = st.keyframe_index
                    frame["num_keyframes"] = len(st.keyframes)
            if self.baseplate_tf is not None:
                # Host-numpy FK: per-tick host paths (150 ms control tick)
                # do not dispatch to the device.
                tfs = fk_all_links_host(self.model, angles, self.baseplate_tf)
                frame["tcp_world"] = tfs[self.model.link_index("Needle")][:3, 3].round(3).tolist()
            stream.publish(frame)

        def finish_cb(state):
            stream.publish(
                {
                    "event": "task_finished",
                    "t": _time.time(),
                    "mode": state.mode,
                    "outcome": state.outcome.value,
                    "message": state.message,
                }
            )

        runner.pose_callback = pose_cb
        runner.finish_callback = finish_cb
        sync = SyncMonitor(controller, encoder)
        self.hardware = HardwareStack(
            controller=controller, encoder=encoder, runner=runner, sync=sync,
            engine=self, stream=stream,
        )
        return self.hardware


class HardwareStack:
    """The connected hardware bundle (controller + encoder + executor + sync)."""

    def __init__(self, controller, encoder, runner, sync, engine=None, stream=None):
        self.controller = controller
        self.encoder = encoder
        self.runner = runner
        self.sync = sync
        self.engine = engine
        # live pose pub/sub fed by the executor's per-tick callback
        # (attach_hardware); None only for hand-built stacks
        self.stream = stream

    def status(self) -> dict:
        """Live status snapshot — the reference's status panel (Mamri.py:582-637):
        encoder/controller/target steps, TCP world position via FK, IK RMSE."""
        encoder_steps = self.encoder.latest_position if self.encoder.is_connected else None
        controller_steps = self.controller.query_positions() if self.controller.is_connected else None
        target = None
        if self.runner.state is not None:
            target = self.runner.state.target_steps.tolist()
        out = {
            "encoder_steps": encoder_steps,
            "controller_steps": controller_steps,
            "target_steps": target,
            "task_active": self.runner.is_active,
            "ik_error_mm": self.engine.last_ik_error if self.engine else None,
            "tcp_world": None,
        }
        if self.engine is not None and controller_steps is not None and self.engine.baseplate_tf is not None:
            angles = self.engine.convert_steps_to_angles(np.asarray(controller_steps))
            tfs = fk_all_links_host(self.engine.model, angles, self.engine.baseplate_tf)
            out["tcp_world"] = tfs[self.engine.model.link_index("Needle")][:3, 3].tolist()
        return out

    def passive_status(self) -> dict:
        """Status snapshot that is safe from WATCHER threads: reads only the
        encoder's listener-thread state (lock-protected) and the runner's
        fields — never writes the serial command channel, so it cannot
        interleave with the executor's own controller traffic (the links
        are single-writer by design; `status()` is for the controlling
        thread)."""
        st = self.runner.state
        return {
            "event": "status",
            "encoder_steps": self.encoder.latest_position if self.encoder.is_connected else None,
            "task_active": self.runner.is_active,
            "target_steps": None if st is None else [int(s) for s in st.target_steps],
            "outcome": None if st is None else st.outcome.value,
        }

    def watch(self, max_frames=None, idle_timeout_s: float = 5.0):
        """Subscribe to the live pose stream and yield frames — the headless
        counterpart of the reference's per-tick scene mirror (Mamri.py:537).
        Generator closes its subscription on exit."""
        if self.stream is None:
            raise RuntimeError("this HardwareStack has no pose stream attached")
        with self.stream.subscribe() as sub:
            yield from sub.frames(max_frames=max_frames, idle_timeout_s=idle_timeout_s)

    def joint_status_table(self, st: Optional[dict] = None) -> list:
        """Rows of the reference's live joint-status table
        (`jointStatusTableWidget`, Mamri.py:744-747 headers; values from the
        status-panel update Mamri.py:582-637): per joint, encoder /
        controller / target steps, "..." where a source is unavailable.
        Pass a `status()` snapshot to reuse it (avoids a second controller
        'P' round-trip)."""
        if st is None:
            st = self.status()
        names = (
            self.engine.model.articulated_names
            if self.engine is not None
            else tuple(f"J{i + 1}" for i in range(6))
        )
        rows = [("Joint", "Encoder (steps)", "Controller (steps)", "Target (steps)")]

        def col(values, i):
            return "..." if values is None else str(int(values[i]))

        rows += [
            (n, col(st["encoder_steps"], i), col(st["controller_steps"], i), col(st["target_steps"], i))
            for i, n in enumerate(names)
        ]
        return rows

    def move_to_pose(self, steps, **kw):
        return self.runner.start("move_to_pose", target_steps=steps, **kw)

    def execute_trajectory(self, keyframes, **kw):
        return self.runner.start("trajectory", keyframes=keyframes, **kw)

    def return_to_zero(self, num_joints: int = 6, **kw):
        return self.runner.start("homing", target_steps=[0] * num_joints, **kw)

    def jog(self, joint_index: int, delta_steps: int, **kw):
        current = self.controller.query_positions()
        if current is None:
            raise RuntimeError("could not read current position for jog")
        target = list(current)
        target[joint_index] += delta_steps
        return self.runner.start("jog", target_steps=target, **kw)

    def stop(self):
        self.runner.request_stop()

    def zero_hardware(self):
        """'R' to the encoder + 'S0,...' to the controller (Mamri.py:1221-1239)."""
        if not (self.encoder.is_connected and self.controller.is_connected):
            raise RuntimeError("both encoder and controller must be connected to zero hardware")
        self.encoder.reset_counters()
        self.controller.zero_counters()

    def start_sync_loop(self, interval_s: float = 0.25):
        """Run the encoder<->controller sync monitor on a background thread —
        the reference's 250 ms sync QTimer (Mamri.py:836-838). Returns a
        stop() callable."""
        import threading

        stop = threading.Event()

        def loop():
            while not stop.is_set():
                try:
                    self.sync.step()
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception("sync step failed; continuing")
                stop.wait(interval_s)

        t = threading.Thread(target=loop, daemon=True)
        t.start()

        def stopper():
            stop.set()
            t.join(timeout=1.0)

        return stopper

    def disconnect(self):
        self.encoder.disconnect()
        self.controller.disconnect()
